"""Matmul-only blocked Cholesky: exactness vs XLA/LAPACK, NaN
propagation for non-PD inputs, and LML-term equivalence."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bask_tpu.ops import fast_cholesky as fc


def _spd(rng, b, n, jitter=1e-3):
    A = rng.randn(b, n, n)
    return jnp.asarray(A @ np.swapaxes(A, -1, -2) / n + jitter * np.eye(n))


@pytest.mark.parametrize(
    "n", [32, 64, 128, 256, 384, 512, 576, 768, 832, 1024]
)
def test_block_cholesky_matches_xla(n):
    # 576/832 exercise the ragged last panel (n not a multiple of nb)
    rng = np.random.RandomState(0)
    A = _spd(rng, 3 if n <= 512 else 1, n)
    L_ref = np.asarray(jnp.linalg.cholesky(A))
    L, _ = fc.block_cholesky(A)
    np.testing.assert_allclose(np.asarray(L), L_ref, rtol=5e-5, atol=1e-8)


def test_pick_nb_policy():
    """nb=128 up to n=512, 256 beyond (each beat the other width in the
    batched LML on an H100, ``benchmarks/bench_chol_variants.py``); the
    last panel may be ragged, so every 64-multiple padding bucket
    qualifies."""
    assert fc.pick_nb(512) == 128
    assert fc.pick_nb(576) == 256
    assert fc.pick_nb(640) == 256
    assert fc.pick_nb(1024) == 256
    assert fc.pick_nb(2048) == 256


@pytest.mark.parametrize("n", [320, 576])
def test_ragged_panel_solves(n):
    """Forward/matrix solves must honor the ragged panel layout encoded
    in the cached inverse shapes."""
    rng = np.random.RandomState(3)
    A = _spd(rng, 2, n)
    L, invs = fc.block_cholesky(A)
    assert sum(iv.shape[-1] for iv in invs) == n
    Lr = np.asarray(jnp.linalg.cholesky(A))
    y = rng.randn(2, n)
    w = np.asarray(fc.block_forward_solve(L, invs, jnp.asarray(y)))
    ref = np.stack([np.linalg.solve(Lr[i], y[i]) for i in range(2)])
    np.testing.assert_allclose(w, ref, rtol=5e-5, atol=1e-7)
    Y = jnp.asarray(rng.randn(2, n, 7))
    W = np.asarray(fc.block_solve_lower_mat(L, invs, Y))
    refm = np.stack(
        [np.linalg.solve(Lr[i], np.asarray(Y)[i]) for i in range(2)]
    )
    np.testing.assert_allclose(W, refm, rtol=5e-5, atol=1e-7)
    Xu = np.asarray(fc.block_solve_upper_mat(L, invs, Y))
    refu = np.stack(
        [np.linalg.solve(Lr[i].T, np.asarray(Y)[i]) for i in range(2)]
    )
    np.testing.assert_allclose(Xu, refu, rtol=5e-5, atol=1e-7)


def test_tri_newton_inv_exact():
    rng = np.random.RandomState(1)
    L = np.tril(rng.randn(2, 96, 96)) + 3.0 * np.eye(96)
    X = np.asarray(fc.tri_newton_inv(jnp.asarray(L)))
    np.testing.assert_allclose(
        X @ L, np.broadcast_to(np.eye(96), (2, 96, 96)), atol=1e-8
    )


def test_block_forward_solve():
    rng = np.random.RandomState(2)
    A = _spd(rng, 2, 256)
    y = jnp.asarray(rng.randn(2, 256))
    L, invs = fc.block_cholesky(A)
    w = fc.block_forward_solve(L, invs, y)
    w_ref = jax.vmap(
        lambda Li, yi: jax.scipy.linalg.solve_triangular(Li, yi, lower=True)
    )(L, y)
    np.testing.assert_allclose(
        np.asarray(w), np.asarray(w_ref), rtol=5e-5, atol=1e-8
    )


def test_non_pd_produces_nan():
    n = 128
    A = jnp.asarray(-np.eye(n))[None]
    L, _ = fc.block_cholesky(A)
    assert np.isnan(np.asarray(L)).any()


def test_fast_lml_matches_slow_path():
    from bask_tpu.ops import linalg
    from bask_tpu.models import gp as gpc
    from bask_tpu.ops import kernels as bk

    rng = np.random.RandomState(3)
    n, n_pad, d = 100, 128, 3
    X = np.full((n_pad, d), 0.5)
    X[:n] = rng.uniform(size=(n, d))
    y = np.zeros(n_pad)
    y[:n] = rng.randn(n)
    mask = np.arange(n_pad) < n
    data = gpc.make_data(X, y, np.full(n_pad, 1e-6), mask)
    kernel = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern(
        (0.3, 0.3, 0.3), (0.05, 2.0), nu=2.5
    ) + bk.WhiteKernel(0.05, (1e-5, 1e5))
    theta = jnp.asarray(kernel.theta0)

    old = linalg.FAST_CHOLESKY
    try:
        linalg.FAST_CHOLESKY = "off"
        slow = float(gpc.log_marginal_likelihood(kernel, theta, data))
        linalg.FAST_CHOLESKY = "on"
        fast = float(gpc.log_marginal_likelihood(kernel, theta, data))
    finally:
        linalg.FAST_CHOLESKY = old
    np.testing.assert_allclose(fast, slow, rtol=1e-8)


def test_forward_solve_both_sweep_branches_match_xla():
    """The vector forward solve is left-looking at few panels (measured
    in-chain win) and right-looking beyond; both branches must match
    XLA's substitution. n=512/nb=128 hits the left branch (T=4),
    n=2048/nb=128 the right one (T=16)."""
    from jax.scipy.linalg import solve_triangular

    from bask_tpu.ops import fast_cholesky as fc

    rng = np.random.RandomState(0)
    for n, nb, batch in ((512, 128, (3,)), (2048, 128, ()), (832, 256, ())):
        B = rng.randn(*batch, n, n)
        A = jnp.asarray(B @ np.swapaxes(B, -1, -2) + n * np.eye(n))
        L, invs = fc.block_cholesky(A, nb=nb)
        T = len(invs)
        assert (T <= fc._FWD_LEFT_MAX_PANELS) == (n in (512, 832))
        y = jnp.asarray(rng.randn(*batch, n))
        w = np.asarray(fc.block_forward_solve(L, invs, y))
        ref = np.asarray(
            solve_triangular(L, y[..., None], lower=True)[..., 0]
        )
        np.testing.assert_allclose(w, ref, rtol=1e-9, atol=1e-10)


def test_trailing_precision_knob_parity_and_nan():
    """TRAILING_PRECISION (the measured-off escape hatch) changes only
    matmul precision: on CPU (where HIGH == HIGHEST) the factor is
    identical, and the non-PD NaN contract holds either way."""
    import jax

    from bask_tpu.ops import fast_cholesky as fc

    rng = np.random.RandomState(0)
    B = rng.randn(512, 512)
    A = jnp.asarray(B @ B.T + 512 * np.eye(512))
    L0, _ = fc.block_cholesky(A)
    prev = fc.TRAILING_PRECISION
    try:
        fc.TRAILING_PRECISION = jax.lax.Precision.HIGH
        L1, _ = fc.block_cholesky(A)
        Lb, _ = fc.block_cholesky(jnp.asarray(-np.eye(512)))
    finally:
        fc.TRAILING_PRECISION = prev
    np.testing.assert_allclose(np.asarray(L1), np.asarray(L0), rtol=1e-12)
    assert np.isnan(np.asarray(Lb)).any()


def test_block_solves_with_cached_invs_match_xla():
    """The right-looking solve sweeps (T big trailing updates; the
    left-looking form was cut after the round-4 hardware A/B) match
    XLA's substitution. The multi-panel shapes (n > nb=128/256)
    exercise the sweeps proper."""
    from jax.scipy.linalg import solve_triangular

    from bask_tpu.ops.fast_cholesky import (
        block_cholesky,
        block_solve_lower_mat,
        block_solve_upper_mat,
    )
    rng = np.random.RandomState(0)
    for n, m, batch in (
        (128, 37, ()), (256, 200, (4,)), (64, 8, ()), (512, 16, ()),
        (832, 9, ()),  # ragged last panel
    ):
        B = rng.randn(*batch, n, n)
        A = jnp.asarray(B @ np.swapaxes(B, -1, -2) + n * np.eye(n))
        L, invs = block_cholesky(A)
        invs = tuple(invs)
        Y = jnp.asarray(rng.randn(*batch, n, m))
        low = np.asarray(block_solve_lower_mat(L, invs, Y))
        ref_low = np.asarray(solve_triangular(L, Y, lower=True))
        np.testing.assert_allclose(low, ref_low, rtol=1e-9, atol=1e-10)
        up = np.asarray(block_solve_upper_mat(L, invs, Y))
        ref_up = np.asarray(
            solve_triangular(jnp.swapaxes(L, -1, -2), Y, lower=False)
        )
        np.testing.assert_allclose(up, ref_up, rtol=1e-9, atol=1e-10)


def test_posterior_and_invs_f32_predict_parity():
    """The f32 cached-inverse predict path matches the XLA substitution
    path (the f64 suite never takes it — force both here)."""
    from bask_tpu.models import gp as gpc
    from bask_tpu.ops import kernels as bk, linalg

    rng = np.random.RandomState(1)
    n_pad, n, d = 128, 100, 3
    X = np.full((n_pad, d), 0.5)
    X[:n] = rng.uniform(size=(n, d))
    y = np.zeros(n_pad)
    y[:n] = np.sin(3 * X[:n, 0])
    kernel = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern(
        (0.3,) * d, (0.05, 2.0), nu=2.5
    ) + bk.WhiteKernel(0.01, (1e-5, 1e5))
    data = gpc.make_data(
        jnp.asarray(X, dtype=jnp.float32),
        jnp.asarray(y, dtype=jnp.float32),
        jnp.full(n_pad, 1e-6, dtype=jnp.float32),
        jnp.asarray(np.arange(n_pad) < n),
    )
    theta = jnp.asarray(kernel.theta0, dtype=jnp.float32)
    Xq = jnp.asarray(rng.uniform(size=(50, d)), dtype=jnp.float32)

    prev = linalg.FAST_CHOLESKY
    try:
        linalg.FAST_CHOLESKY = "off"
        post0, invs0 = gpc.posterior_and_invs(kernel, theta, data)
        assert invs0 is None
        mu0, s0 = gpc.predict(kernel, theta, post0, data, Xq, return_std=True)
        linalg.FAST_CHOLESKY = "on"
        post1, invs1 = gpc.posterior_and_invs(kernel, theta, data)
        assert invs1 is not None
        mu1, s1 = gpc.predict(
            kernel, theta, post1, data, Xq, return_std=True, invs=invs1
        )
    finally:
        linalg.FAST_CHOLESKY = prev
    np.testing.assert_allclose(
        np.asarray(mu1), np.asarray(mu0), rtol=2e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(s1), np.asarray(s0), rtol=1e-3, atol=1e-5
    )
