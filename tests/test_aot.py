"""Persistent AOT executable cache (``bask_tpu.utils.aot``).

The AOT cache serializes the compiled chain executables, so a second
process loads them instead of compiling. These tests pin: exact result parity with the
normal jit path, disk round-trip (a second session loads instead of
compiling), and graceful fallback when the cache is disabled.
"""

import numpy as np
import pytest

import bask_tpu.utils.aot as aot
from bask_tpu import BayesGPR, disable_aot_cache, enable_aot_cache
from bask_tpu.ops.kernels import ConstantKernel, Matern


@pytest.fixture(autouse=True)
def _clean_cache_state():
    yield
    disable_aot_cache()


def _fit_chain(seed=5):
    rng = np.random.RandomState(0)
    X = rng.uniform(size=(10, 1))
    y = np.sin(4.0 * X[:, 0]) + 0.1 * rng.randn(10)
    gp = BayesGPR(
        kernel=ConstantKernel(1.0, (0.1, 10.0))
        * Matern(1.0, (0.05, 5.0), nu=2.5),
        random_state=seed,
    )
    gp.fit(X, y, n_burnin=3, n_desired_samples=30, progress=False)
    return np.asarray(gp.chain_)


def test_aot_chain_matches_jit_chain(tmp_path):
    ref = _fit_chain()
    enable_aot_cache(str(tmp_path))
    cached = _fit_chain()
    np.testing.assert_array_equal(ref, cached)
    # the chain executable landed on disk (CPU PJRT supports serialize)
    assert list(tmp_path.glob("*.jaxexec")), "no serialized executables"


def test_aot_cache_loads_in_fresh_session(tmp_path, monkeypatch):
    enable_aot_cache(str(tmp_path))
    ref = _fit_chain()
    n_entries = len(list(tmp_path.glob("*.jaxexec")))
    assert n_entries > 0

    # simulate a fresh process: drop the in-memory memo, count loads
    disable_aot_cache()
    enable_aot_cache(str(tmp_path))
    from jax.experimental import serialize_executable as se

    loads = []
    real = se.deserialize_and_load

    def counting(*a, **k):
        loads.append(1)
        return real(*a, **k)

    monkeypatch.setattr(se, "deserialize_and_load", counting)
    again = _fit_chain()
    np.testing.assert_array_equal(ref, again)
    assert len(loads) > 0, "fresh session should load, not recompile"
    # no new executables were written
    assert len(list(tmp_path.glob("*.jaxexec"))) == n_entries


def test_aot_disabled_is_plain_jit(tmp_path):
    disable_aot_cache()
    ref = _fit_chain()
    assert not list(tmp_path.glob("*"))
    assert np.isfinite(ref).all()


def test_aot_mesh_sharded_chain(tmp_path):
    """A mesh-sharded chain through the cache: the serialized executable
    keeps its 8-device assignment and reproduces the unsharded chain."""
    from bask_tpu.parallel.mesh import walker_mesh

    rng = np.random.RandomState(2)
    X = rng.uniform(size=(10, 1))
    y = np.sin(5.0 * X[:, 0]) + 0.1 * rng.randn(10)

    def chain(mesh, seed=11):
        gp = BayesGPR(
            kernel=ConstantKernel(1.0, (0.1, 10.0))
            * Matern(1.0, (0.05, 5.0), nu=2.5),
            random_state=seed,
        )
        gp.fit(
            X, y, n_burnin=2, n_desired_samples=20,
            n_walkers_per_thread=32, progress=False, mesh=mesh,
        )
        return np.asarray(gp.chain_)

    ref = chain(mesh=None)
    enable_aot_cache(str(tmp_path))
    mesh = walker_mesh(8)
    sharded_compiled = chain(mesh)
    np.testing.assert_allclose(sharded_compiled, ref, rtol=1e-9)
    # second session: load the sharded executable from disk
    disable_aot_cache()
    enable_aot_cache(str(tmp_path))
    sharded_loaded = chain(mesh)
    np.testing.assert_array_equal(sharded_loaded, sharded_compiled)


def test_aot_progress_path(tmp_path):
    """The chunked progress chain routes through the cache too and stays
    bit-identical to the fused chain."""
    rng = np.random.RandomState(1)
    X = rng.uniform(size=(8, 1))
    y = np.cos(3.0 * X[:, 0]) + 0.1 * rng.randn(8)

    def chain(progress):
        gp = BayesGPR(
            kernel=ConstantKernel(1.0, (0.1, 10.0))
            * Matern(1.0, (0.05, 5.0), nu=2.5),
            random_state=9,
        )
        gp.fit(X, y, n_burnin=2, n_desired_samples=20, progress=progress)
        return np.asarray(gp.chain_)

    enable_aot_cache(str(tmp_path))
    np.testing.assert_array_equal(chain(False), chain(True))


def test_aot_cache_across_processes(tmp_path):
    """TRUE cross-process proxy for a production restart: a second process with a warm cache must load every
    hot-path executable (deserialize_and_load > 0) and compile NOTHING
    (Lowered.compile == 0), reproducing the first process's chain."""
    import json
    import os
    import subprocess
    import sys

    env = dict(os.environ)
    env.pop("BASK_TPU_AOT_CACHE", None)  # worker gets the dir via argv
    worker = os.path.join(os.path.dirname(__file__), "_aot_worker.py")

    def run():
        out = subprocess.run(
            [sys.executable, worker, str(tmp_path)],
            capture_output=True,
            text=True,
            env=env,
            timeout=600,
        )
        assert out.returncode == 0, out.stderr[-2000:]
        return json.loads(out.stdout.strip().splitlines()[-1])

    first = run()
    assert first["compiles"] > 0  # cold cache: compiled and serialized
    second = run()
    assert second["loads"] > 0, second
    assert second["compiles"] == 0, second  # warm cache: load-no-compile
    assert second["checksum"] == first["checksum"]
    assert second["theta0"] == first["theta0"]
