"""Laplace-approximation cold-chain init (round 5).

``BayesGPR(chain_init="laplace")`` draws the cold ensemble from
``N(theta_ML, H^-1)`` (clamped eigen-spreads) instead of the
reference's 1e-2 ball (``bask/bayesgpr.py:432-434``), so DE moves see
posterior-scale, correlation-aligned difference vectors from step 0.
"""

import numpy as np
import pytest

from bask_tpu import BayesGPR
from bask_tpu.models import bayesgpr as bg
from bask_tpu.ops import kernels as bk


def _toy(n=48, d=2, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.uniform(size=(n, d))
    y = np.sin(3 * X[:, 0]) + 0.5 * X[:, 1] + 0.05 * rng.randn(n)
    return X, y


def _fitted(chain_init="laplace", seed=1, **kw):
    X, y = _toy()
    gp = BayesGPR(random_state=seed, chain_init=chain_init, **kw)
    gp.fit(X, y, n_desired_samples=40, n_burnin=2, progress=False)
    return gp


def test_hessian_matches_finite_differences():
    """_log_post_hessian == FD Hessian of the scalar log posterior."""
    import jax.numpy as jnp

    X, y = _toy(n=24)
    gp = BayesGPR(random_state=0)
    gp.fit(X, y, n_desired_samples=20, n_burnin=1, progress=False)
    priors = gp._resolve_priors(None)
    theta = np.asarray(gp._theta, dtype=float)
    H = np.asarray(
        bg._log_post_hessian(
            gp._data,
            jnp.asarray(theta, dtype=gp._dtype()),
            kernel=gp._spec,
            priors=priors,
            n_warp=0,
        )
    )
    assert H.shape == (theta.size, theta.size)

    def scalar(t):
        lml = float(
            bg._neg_lml_plain(gp._spec, jnp.asarray(t, gp._dtype()), gp._data)
        )
        pri = float(bg._eval_priors(priors, jnp.asarray(t, gp._dtype())))
        return pri - lml

    eps = 1e-4
    for i in range(theta.size):
        for j in range(i, theta.size):
            tpp = theta.copy(); tpp[i] += eps; tpp[j] += eps
            tpm = theta.copy(); tpm[i] += eps; tpm[j] -= eps
            tmp = theta.copy(); tmp[i] -= eps; tmp[j] += eps
            tmm = theta.copy(); tmm[i] -= eps; tmm[j] -= eps
            fd = (
                scalar(tpp) - scalar(tpm) - scalar(tmp) + scalar(tmm)
            ) / (4 * eps * eps)
            assert H[i, j] == pytest.approx(fd, rel=2e-3, abs=2e-3)
    # symmetric up to round-off
    assert np.allclose(H, H.T, atol=1e-6 * (1 + np.abs(H).max()))


def test_laplace_positions_are_posterior_scaled():
    """Spread sits between the clamps and beats the 1e-2 ball along at
    least one direction; all walkers start at finite log-posterior."""
    import jax.numpy as jnp

    gp = _fitted()
    priors = gp._resolve_priors(None)
    theta = np.asarray(gp._theta, dtype=float)
    pos = gp._laplace_positions(theta, 64, priors, 0)
    assert pos is not None and pos.shape == (64, theta.size)
    sd = pos.std(axis=0)
    assert sd.max() > 3e-2  # wider than the ball somewhere
    assert sd.max() < 3.0 * bg._LAPLACE_STD_MAX
    lp = np.asarray(
        bg._make_log_prob_batch(gp._spec, priors, None, 0, gp._data)(
            jnp.asarray(pos, dtype=gp._dtype())
        )
    )
    assert np.isfinite(lp).all()


def test_laplace_fit_end_to_end_and_determinism():
    gp1 = _fitted(seed=3)
    gp2 = _fitted(seed=3)
    assert np.array_equal(gp1.chain_, gp2.chain_)
    Xq = np.linspace(0, 1, 7)[:, None] * np.ones((1, 2))
    mu, std = gp1.predict(Xq, return_std=True)
    assert np.isfinite(mu).all() and np.isfinite(std).all()
    # differs from the ball-init chain (same seed)
    gpb = _fitted(chain_init="ball", seed=3)
    assert not np.array_equal(gp1.chain_, gpb.chain_)


def test_laplace_ignored_on_warm_start_and_position():
    gp = _fitted(seed=5)
    pos = np.copy(gp.pos_)
    gp.sample(n_desired_samples=40, progress=False)  # warm: from pos_
    # explicit position bypasses the init entirely
    gp.sample(position=pos, n_desired_samples=40, progress=False)


def test_laplace_warp_theta_block_no_fallback():
    """With input warping the theta block still gets curvature spreads
    (warp dims keep the ball width — betainc has no a/b derivatives in
    JAX) and the init does NOT fall back to the ball."""
    import warnings as w

    with w.catch_warnings():
        w.simplefilter("error", UserWarning)  # any fallback warning fails
        gp = _fitted(warp_inputs=True)
    assert gp.chain_.shape[1] == gp._spec.n_theta + 2 * 2
    mu = gp.predict(np.full((3, 2), 0.5))
    assert np.isfinite(mu).all()
    # direct check on the position generator: warp columns are
    # ball-width, theta block is wider somewhere
    priors = gp._resolve_priors(None)
    n_theta = gp._spec.n_theta
    theta = np.concatenate([np.asarray(gp._theta), np.zeros(4)])
    pos = gp._laplace_positions(theta, 64, priors, 2)
    assert pos is not None
    sd = pos.std(axis=0)
    assert sd[:n_theta].max() > 3e-2
    assert (sd[n_theta:] < 2e-2).all()


def test_fd_fallback_when_hvp_nonfinite(monkeypatch):
    """A non-finite Hessian makes the Laplace init decline (no
    finite-difference substitute: the second-order AD is finite on the
    CPU and on the GPU), and the fit falls through to the ball."""
    import jax.numpy as jnp

    gp = _fitted()
    priors = gp._resolve_priors(None)
    theta = np.asarray(gp._theta, dtype=float)
    assert gp._laplace_positions(theta, 64, priors, 0) is not None

    def bad_hessian(*a, **k):
        return jnp.full((theta.size, theta.size), np.nan)

    monkeypatch.setattr(bg, "_log_post_hessian", bad_hessian)
    assert gp._laplace_positions(theta, 64, priors, 0) is None
    ball = _fitted()
    assert np.isfinite(ball.chain_).all()
    assert np.isfinite(ball.log_marginal_likelihood_value_)


def test_invalid_chain_init_raises():
    with pytest.raises(ValueError, match="chain_init"):
        BayesGPR(chain_init="gaussian")
    gp = _fitted(chain_init="ball")
    gp.pos_ = None
    with pytest.raises(ValueError, match="chain_init"):
        gp.sample(chain_init="nope", n_desired_samples=10, progress=False)


def test_chain_init_checkpoint_roundtrip(tmp_path):
    from bask_tpu.utils.serialization import load_gpr, save_gpr

    gp = _fitted()
    p = tmp_path / "gp.npz"
    save_gpr(gp, p)
    gp2 = load_gpr(p)
    assert gp2.chain_init == "laplace"
