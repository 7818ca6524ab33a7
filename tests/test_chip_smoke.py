"""``chip_smoke.py``'s phases at a tiny size on the CPU, and its refusal
to report success without a GPU."""

import importlib.util
import json
import pathlib

import jax
import numpy as np
import pytest

_PATH = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _f32():
    # as Optimizer users run (the suite otherwise runs with x64 on)
    return jax.enable_x64(False)


def test_phase_lml_tiny(smoke):
    with _f32():
        res = smoke.phase_lml(shapes=((100, 128, 4), (200, 256, 2)), d=4)
    assert res["ok"], res
    assert [c.get("shape") for c in res["checks"][:2]] == [[4, 128], [2, 256]]
    assert res["checks"][-1]["singular_gram_f64"] == -np.inf


def test_phase_fit_tiny(smoke):
    with _f32():
        res = smoke.phase_fit(n_obs=40, walkers=8, steps=40, d=3)
    assert res["ok"], res
    assert res["chain_finite"] and res["laplace_hessian_finite"]
    assert res["chain_shape"][1:] == [8, 5]


def test_phase_ask_tell_tiny(smoke):
    with _f32():
        res = smoke.phase_ask_tell(n_obs=30, rounds=1, batch_n=60,
                                   batch_cands=1024, batch=4, d=3,
                                   cold_until_rhat=None)
    assert res["ok"], res
    assert res["n_told"] == 32
    assert res["batch_ask"]["ok"]


def test_phase_acq_tiny(smoke):
    with _f32():
        res = smoke.phase_acq(draws=6, n_train=128, n_cand=64, n_probe=4, d=3)
    assert res["ok"], res
    assert res["ei"]["finite"] and res["pvrs"]["finite"]


def test_compile_cache_follows_env(smoke, monkeypatch, tmp_path):
    """A set ``JAX_COMPILATION_CACHE_DIR`` is used as is: nothing is
    configured in code."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert smoke.compile_cache_dir() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo(smoke, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = smoke.compile_cache_dir()
        assert path == str(_PATH.parent / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_main_refuses_without_gpu(smoke, capsys):
    assert smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok": true' not in out
    for line in out.splitlines():
        if line.startswith("{"):
            assert not json.loads(line).get("ok")
