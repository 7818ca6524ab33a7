"""The float32 paths the GPU runs, checked on the CPU against float64.

``Optimizer`` and ``BayesGPR`` users run in float32; the suite otherwise
runs with x64 on. These tests pin the f32 walker-batched LML (blocked
factorization), the pathwise batch ask at a 128-multiple bucket, the
per-draw acquisition predictions, and the branchless non-PD -> -inf
contract, and scan the package for accelerator-specific branches.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bask_tpu.models import gp as gpc
from bask_tpu.ops import kernels as bk
from bask_tpu.ops import linalg

FAMILIES = {
    "const_matern52_white": bk.ConstantKernel(1.0, (0.1, 2.0))
    * bk.Matern((0.3, 0.3, 0.3), (0.05, 2.0), nu=2.5)
    + bk.WhiteKernel(0.05, (1e-5, 1e5)),
    "const_rbf": bk.ConstantKernel(1.0, (0.1, 2.0))
    * bk.RBF((0.4, 0.2, 0.6), (0.05, 2.0)),
    "matern32": bk.Matern((0.3, 0.5, 0.2), (0.05, 2.0), nu=1.5),
    "matern12_white": bk.Matern(0.4, (0.05, 2.0), nu=0.5)
    + bk.WhiteKernel(0.1, (1e-5, 1e5)),
}


def _padded(n, n_pad, d, seed):
    rng = np.random.RandomState(seed)
    X = np.full((n_pad, d), 0.5)
    X[:n] = rng.uniform(size=(n, d))
    y = np.zeros(n_pad)
    y[:n] = rng.randn(n)
    return X, y, np.full(n_pad, 1e-2), np.arange(n_pad) < n


@pytest.mark.parametrize("warped", [False, True], ids=["shared_X", "warped_X"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_batched_lml_f32_matches_f64(family, warped):
    """The f32 blocked-factorization batch (n_pad=128 takes the fast
    path) agrees with the float64 XLA reference, walker by walker."""
    from bask_tpu.models import warping as wp

    kernel = FAMILIES[family]
    n, n_pad, d, W = 100, 128, 3, 4
    X, y, a, m = _padded(n, n_pad, d, seed=0)
    rng = np.random.RandomState(1)
    thetas = kernel.theta0[None, :] + 0.1 * rng.randn(W, kernel.n_theta)
    if warped:
        la = 0.3 * rng.randn(W, d)
        lb = 0.3 * rng.randn(W, d)
        X = np.stack([
            np.asarray(wp.warp(jnp.asarray(X), jnp.asarray(la[w]),
                               jnp.asarray(lb[w])))
            for w in range(W)
        ])
    assert linalg._use_fast_path(jnp.zeros((n_pad, n_pad), jnp.float32))
    with jax.enable_x64(False):  # as Optimizer users run
        got = np.asarray(linalg.batched_lml(
            kernel, *(jnp.asarray(v, jnp.float32) for v in (thetas, X, y, a)),
            jnp.asarray(m),
        ))
    Xw = X if warped else np.broadcast_to(X, (W,) + X.shape)
    ref = np.array([
        float(linalg.masked_lml(kernel, jnp.asarray(thetas[w]),
                                jnp.asarray(Xw[w]), jnp.asarray(y),
                                jnp.asarray(a), jnp.asarray(m)))
        for w in range(W)
    ])
    assert got.dtype == np.float32
    # f32 roundoff times the gram's condition bound n * amplitude / noise
    # (noise floor = the 1e-2 jitter; amplitudes ~1); the library
    # Cholesky at f32 shows the same error (it is the gram's, not the
    # factorization's)
    np.testing.assert_allclose(got, ref, rtol=2 * 6e-8 * n_pad / 1e-2)


def _pathwise_setup(n_warp, S=4, n=100, n_pad=128, d=3):
    kernel = FAMILIES["const_matern52_white"]
    X, y, a, m = _padded(n, n_pad, d, seed=2)
    data = gpc.make_data(
        jnp.asarray(X, jnp.float32), jnp.asarray(y, jnp.float32),
        jnp.asarray(a, jnp.float32), jnp.asarray(m),
    )
    rng = np.random.RandomState(3)
    rows = np.concatenate(
        [kernel.theta0[None, :] + 0.05 * rng.randn(S, kernel.n_theta),
         0.1 * rng.randn(S, 2 * d * bool(n_warp))], axis=1,
    )
    Xq = rng.uniform(size=(2048, d))
    return kernel, data, jnp.asarray(rows, jnp.float32), jnp.asarray(
        Xq, jnp.float32)


@pytest.mark.parametrize("n_warp", [0, 3], ids=["plain", "warped"])
def test_pathwise_topk_hyper_f32_n_pad_128(n_warp):
    """f32 at a 128-multiple bucket: the batch-ask path the GPU runs."""
    from bask_tpu.models.pathwise import pathwise_topk_hyper

    kernel, data, rows, Xq = _pathwise_setup(n_warp)
    spec = bk.match_fusable(kernel)
    idx = np.asarray(pathwise_topk_hyper(
        spec, rows, data, Xq, jax.random.PRNGKey(0), n_warp, 256, 8,
    ))
    assert idx.shape == (rows.shape[0], 8)
    assert ((idx >= 0) & (idx < Xq.shape[0])).all()
    # each draw's top-k are distinct candidates
    assert all(len(set(r.tolist())) == 8 for r in idx)


def test_optimizer_batch_ask_f32_n_pad_128():
    """Optimizer.ask(n_points=4) in f32 with n=100 (bucket 128) over a
    pathwise-sized candidate grid."""
    from bask_tpu import Optimizer

    rng = np.random.RandomState(4)
    X = rng.uniform(size=(100, 3))
    y = np.sum((X - 0.4) ** 2, axis=1) + 0.01 * rng.randn(100)
    with jax.enable_x64(False):
        opt = Optimizer(
            [(0.0, 1.0)] * 3, n_points=4096, acq_func="ei", random_state=0,
            gp_sample_kwargs={"until_rhat": None},
        )
        opt.tell(X.tolist(), y.tolist(), gp_samples=32)
        assert opt.gp._data.X.dtype == jnp.float32
        assert opt.gp._data.X.shape[0] == 128
        pts = np.asarray(opt.ask(n_points=4))
    assert pts.shape == (4, 3)
    assert np.isfinite(pts).all() and ((pts >= 0) & (pts <= 1)).all()
    assert len({tuple(p) for p in pts}) == 4


@pytest.mark.parametrize("score", ["ei", "pvrs"])
def test_per_draw_acquisition_f32_matches_f64(score):
    """Per-draw EI (marginalized predictions) and PVRS
    (variance-explained) scores: f32 against float64."""
    from bask_tpu import acquisition as acq

    kernel = FAMILIES["const_matern52_white"]
    X, y, a, m = _padded(100, 128, 3, seed=5)
    rng = np.random.RandomState(6)
    rows = kernel.theta0[None, :] + 0.05 * rng.randn(6, kernel.n_theta)
    Xc = rng.uniform(size=(64, 3))

    def scores(dt):
        data = gpc.make_data(*(jnp.asarray(v, dt) for v in (X, y, a)),
                             jnp.asarray(m))
        r, c = jnp.asarray(rows, dt), jnp.asarray(Xc, dt)
        if score == "ei":
            mu, std, _ = acq._per_draw_predictions(
                r, data, c, jax.random.PRNGKey(0), kernel=kernel, n_warp=0,
                white_idx=kernel.n_theta - 1, need_sample=False,
            )
            ei = acq.ExpectedImprovement()
            return np.asarray(jax.vmap(lambda u, s: ei(u, s))(mu, std))
        return np.asarray(jax.vmap(lambda t: acq._variance_explained_body(
            kernel, t, gpc.posterior(kernel, t, data), data, c, c[:8]
        ))(r))

    with jax.enable_x64(False):
        got = scores(jnp.float32)
    ref = scores(jnp.float64)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("fast", ["on", "off"], ids=["blocked", "xla"])
def test_non_pd_gram_gives_neg_inf(fast, monkeypatch):
    """Duplicate points with zero jitter: the f32 LML is -inf on both
    the blocked factorization and XLA's Cholesky (the branchless
    reference semantics, bask/bayesgpr.py:373-379)."""
    monkeypatch.setattr(linalg, "FAST_CHOLESKY", fast)
    kernel = bk.ConstantKernel(1.0, (0.1, 10.0)) * bk.Matern(
        (0.3,) * 3, (0.05, 5.0), nu=2.5
    )
    n_pad, n = 128, 100
    rng = np.random.RandomState(7)
    X = np.full((n_pad, 3), 0.5)
    pts = rng.uniform(size=(n // 2, 3))
    X[:n] = np.concatenate([pts, pts])
    y = np.zeros(n_pad)
    y[:n] = rng.randn(n)
    thetas = np.tile(kernel.theta0, (3, 1))
    out = np.asarray(linalg.batched_lml(
        kernel, *(jnp.asarray(v, jnp.float32)
                  for v in (thetas, X, y, np.zeros(n_pad))),
        jnp.asarray(np.arange(n_pad) < n),
    ))
    assert (out == -np.inf).all()


def test_no_accelerator_specific_branches():
    """No module imports the TPU Pallas dialect or branches on a TPU
    backend name: the package runs on the GPU and the CPU as written."""
    root = pathlib.Path(__file__).resolve().parents[1] / "bask_tpu"
    pattern = re.compile(
        r"pallas\.tpu|pallas import tpu|pltpu|default_backend\(\)\s*"
        r"(==|!=|in|not in)\s*[\(\[\"']*tpu|platform\s*==\s*[\"']tpu|"
        r"libtpu",
        re.IGNORECASE,
    )
    hits = [
        f"{p.relative_to(root.parent)}:{i}"
        for p in sorted(root.rglob("*.py"))
        for i, line in enumerate(p.read_text().splitlines(), 1)
        if pattern.search(line)
    ]
    assert hits == []
