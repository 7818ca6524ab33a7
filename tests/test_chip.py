"""Tests that need a GPU: the float32 paths as the card computes them.

Marked ``chip``: the ``_chip_only`` fixture (``conftest.py``) skips them
where JAX finds no GPU. ``python chip_smoke.py`` runs them on the card,
in its own process. On the card a float32 matmul at default precision
may run in TF32 (about three decimal digits); these tests pin that the
paths which need more ask for it.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bask_tpu.ops import kernels as bk
from bask_tpu.ops import linalg

pytestmark = pytest.mark.chip

EPS32 = 6e-8  # float32 unit roundoff


def _kernel(d, white=True):
    k = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern(
        (0.3,) * d, (0.05, 2.0), nu=2.5
    )
    return k + bk.WhiteKernel(0.05, (1e-5, 1e5)) if white else k


def _problem(n, n_pad, d, seed=0, jitter=1e-6):
    rng = np.random.RandomState(seed)
    X = np.full((n_pad, d), 0.5)
    X[:n] = rng.uniform(size=(n, d))
    y = np.zeros(n_pad)
    y[:n] = rng.randn(n)
    return X, y, np.full(n_pad, jitter), np.arange(n_pad) < n


def _f64_lml(kernel, thetas, X, y, a, m):
    return np.asarray(jax.jit(jax.vmap(
        lambda t: linalg.masked_lml(kernel, t, jnp.asarray(X), jnp.asarray(y),
                                    jnp.asarray(a), jnp.asarray(m))
    ))(jnp.asarray(thetas)))


@pytest.mark.parametrize("fast", ["on", "off"], ids=["blocked", "library"])
def test_f32_lml_on_card_matches_f64(fast, monkeypatch):
    """The f32 walker-batched LML on the card (blocked recursion with its
    default-precision Newton steps, or cuSOLVER) against float64."""
    monkeypatch.setattr(linalg, "FAST_CHOLESKY", fast)
    d, n, n_pad, W = 15, 1000, 1024, 16
    kernel = _kernel(d)
    X, y, a, m = _problem(n, n_pad, d)
    th = kernel.theta0[None, :] + 0.05 * np.random.RandomState(1).randn(
        W, kernel.n_theta)
    with jax.enable_x64(False):
        got = np.asarray(linalg.batched_lml(
            kernel, *(jnp.asarray(v, jnp.float32) for v in (th, X, y, a)),
            jnp.asarray(m)))
    ref = _f64_lml(kernel, th, X, y, a, m)
    # roundoff times the condition bound n * amplitude / noise (0.05)
    tol = 2 * EPS32 * n_pad / 0.05
    assert np.isfinite(got).all()
    assert np.max(np.abs(got - ref) / np.maximum(1.0, np.abs(ref))) <= tol


@pytest.mark.parametrize("fast", ["on", "off"], ids=["blocked", "library"])
def test_non_pd_gram_neg_inf_on_card(fast, monkeypatch):
    """Duplicate points with zero jitter and no noise term: -inf from the
    card's factorization, not a crash or a finite value."""
    monkeypatch.setattr(linalg, "FAST_CHOLESKY", fast)
    d, n, n_pad = 5, 200, 256
    kernel = _kernel(d, white=False)
    rng = np.random.RandomState(2)
    X = np.full((n_pad, d), 0.5)
    pts = rng.uniform(size=(n // 2, d))
    X[:n] = np.concatenate([pts, pts])
    y = np.zeros(n_pad)
    y[:n] = rng.randn(n)
    th = np.tile(kernel.theta0, (4, 1))
    with jax.enable_x64(False):
        out = np.asarray(linalg.batched_lml(
            kernel, *(jnp.asarray(v, jnp.float32)
                      for v in (th, X, y, np.zeros(n_pad))),
            jnp.asarray(np.arange(n_pad) < n)))
    assert (out == -np.inf).all()


def test_laplace_hessian_finite_on_card():
    """Second-order AD through the card's Cholesky (the Laplace chain
    init's Hessian) is finite in float32."""
    from bask_tpu.models import gp as gpc
    from bask_tpu.models.bayesgpr import _log_post_hessian

    d, n, n_pad = 6, 120, 128
    kernel = _kernel(d)
    X, y, a, m = _problem(n, n_pad, d, seed=3)
    with jax.enable_x64(False):
        data = gpc.make_data(*(jnp.asarray(v, jnp.float32) for v in (X, y, a)),
                             jnp.asarray(m))
        H = np.asarray(_log_post_hessian(
            data, jnp.asarray(kernel.theta0, jnp.float32), kernel=kernel,
            priors=(), n_warp=0))
    assert H.shape == (kernel.n_theta, kernel.n_theta)
    assert np.isfinite(H).all()


def test_per_draw_predictions_on_card_match_f64():
    """Per-draw predictive mean/std (cached block inverses, the EI path)
    in f32 on the card against float64 on the card."""
    from bask_tpu import acquisition as acq
    from bask_tpu.models import gp as gpc

    d, n, n_pad = 15, 500, 512
    kernel = _kernel(d)
    X, y, a, m = _problem(n, n_pad, d, seed=4)
    rows = kernel.theta0[None, :] + 0.05 * np.random.RandomState(5).randn(
        20, kernel.n_theta)
    Xc = np.random.RandomState(6).uniform(size=(256, d))

    def pred(dt):
        data = gpc.make_data(*(jnp.asarray(v, dt) for v in (X, y, a)),
                             jnp.asarray(m))
        mu, std, _ = acq._per_draw_predictions(
            jnp.asarray(rows, dt), data, jnp.asarray(Xc, dt),
            jax.random.PRNGKey(0), kernel=kernel, n_warp=0,
            white_idx=kernel.n_theta - 1, need_sample=False)
        return np.asarray(mu, np.float64), np.asarray(std, np.float64)

    with jax.enable_x64(False):
        mu32, sd32 = pred(jnp.float32)
    mu64, sd64 = pred(jnp.float64)
    # y is standardized-scale: the LML's roundoff-times-condition rule
    # bounds the absolute error of mean and std
    tol = 2 * EPS32 * n_pad / 0.05
    assert np.max(np.abs(mu32 - mu64)) <= tol
    assert np.max(np.abs(sd32 - sd64)) <= tol


def test_geometric_median_on_card_matches_f64():
    from bask_tpu.utils.median import geometric_median

    X = np.random.RandomState(7).randn(400, 15) * 3.0 + 1.0
    with jax.enable_x64(False):
        got = np.asarray(geometric_median(jnp.asarray(X, jnp.float32)))
    ref = np.asarray(geometric_median(jnp.asarray(X)))
    assert np.max(np.abs(got - ref)) <= 1e-3 * np.max(np.abs(ref))


def test_batch_ask_on_card_f32():
    """``Optimizer.ask(n_points=4)`` in float32 on the card: the pathwise
    Thompson batch over a 4096-point candidate grid."""
    from bask_tpu import Optimizer

    rng = np.random.RandomState(8)
    X = rng.uniform(size=(100, 3))
    y = np.sum((X - 0.4) ** 2, axis=1) + 0.01 * rng.randn(100)
    with jax.enable_x64(False):
        opt = Optimizer([(0.0, 1.0)] * 3, n_points=4096, acq_func="ei",
                        random_state=0, gp_sample_kwargs={"until_rhat": None})
        opt.tell(X.tolist(), y.tolist(), gp_samples=32)
        pts = np.asarray(opt.ask(n_points=4))
    assert pts.shape == (4, 3)
    assert np.isfinite(pts).all() and ((pts >= 0) & (pts <= 1)).all()
    assert len({tuple(p) for p in pts}) == 4


def test_triton_chol_base_on_card():
    """The compiled Triton-route base kernel against float64 NumPy, at
    the shapes the recursion feeds it, plus NaN on a non-PD input."""
    from bask_tpu.ops.triton_chol_base import chol_inv_base

    for B, m in ((100, 32), (7, 24), (1, 32)):
        G = np.random.RandomState(B).randn(B, m, m)
        A = G @ G.transpose(0, 2, 1) / m + np.eye(m)
        with jax.enable_x64(False):
            L, Li = chol_inv_base(jnp.asarray(A, jnp.float32))
        Lr = np.linalg.cholesky(A)
        assert np.max(np.abs(np.asarray(L) - Lr)) <= 1e-5
        assert np.max(np.abs(np.asarray(Li) - np.linalg.inv(Lr))) <= 1e-5
    A = np.eye(32, dtype=np.float32)[None].copy()
    A[0, 5, 5] = -1.0
    with jax.enable_x64(False):
        L, _ = chol_inv_base(jnp.asarray(A))
    assert np.isnan(np.asarray(L)[0, 5:, 5]).all()


def test_walker_mesh_lml_on_card():
    """The walker-sharded LML (``shard_map`` with its replication check,
    around the Triton-route base kernel) on the card's devices matches
    the unsharded batch."""
    from bask_tpu.parallel.mesh import shard_walkers, walker_mesh

    d, n, n_pad = 15, 500, 512
    kernel = _kernel(d)
    X, y, a, m = _problem(n, n_pad, d, seed=9)
    mesh = walker_mesh(len(jax.devices()))
    W = 8 * len(jax.devices())
    th = kernel.theta0[None, :] + 0.05 * np.random.RandomState(10).randn(
        W, kernel.n_theta)
    with jax.enable_x64(False):
        args = tuple(jnp.asarray(v, jnp.float32) for v in (X, y, a))
        t = jnp.asarray(th, jnp.float32)
        sh = jax.jit(lambda t: linalg.batched_lml(
            kernel, t, *args, jnp.asarray(m), mesh=mesh))(
                shard_walkers(t, mesh))
        one = linalg.batched_lml(kernel, t, *args, jnp.asarray(m))
    np.testing.assert_allclose(np.asarray(sh), np.asarray(one), rtol=1e-5)
