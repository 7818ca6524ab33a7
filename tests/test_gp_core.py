"""GP core parity vs sklearn GaussianProcessRegressor.

Pins LML, predictive mean/std/cov, and the masked-padding invariance: the
padded problem must produce bit-comparable results to the unpadded one
(this is what lets the BO loop keep static shapes on the device).
"""

import numpy as np
import pytest
import sklearn.gaussian_process as skgp
import sklearn.gaussian_process.kernels as skk

import jax
import jax.numpy as jnp

from bask_tpu.models import gp as gpc
from bask_tpu.ops import kernels as bk
from bask_tpu.ops.linalg import batched_lml

rng = np.random.RandomState(42)
N, D = 12, 2
X = rng.uniform(size=(N, D))
y = np.sin(3 * X[:, 0]) + 0.1 * rng.randn(N)
ALPHA = 1e-10

OURS = bk.ConstantKernel(1.2, (0.1, 2.0)) * bk.Matern(
    (0.4, 0.3), (0.1, 1.0), nu=2.5
) + bk.WhiteKernel(0.05, (1e-5, 1e5))
THEIRS = skk.ConstantKernel(1.2, (0.1, 2.0)) * skk.Matern(
    (0.4, 0.3), (0.1, 1.0), nu=2.5
) + skk.WhiteKernel(0.05, (1e-5, 1e5))


def _sk_gpr():
    m = skgp.GaussianProcessRegressor(
        kernel=THEIRS, alpha=ALPHA, optimizer=None
    )
    m.fit(X, y)
    return m


def _data(n_pad=N):
    Xp = np.full((n_pad, D), 0.5)
    yp = np.zeros(n_pad)
    Xp[:N] = X
    yp[:N] = y
    mask = np.arange(n_pad) < N
    return gpc.make_data(Xp, yp, np.full(n_pad, ALPHA), mask)


@pytest.mark.parametrize("n_pad", [N, 16, 32])
def test_lml_parity(n_pad):
    m = _sk_gpr()
    data = _data(n_pad)
    for shift in [0.0, 0.2, -0.3]:
        theta = OURS.theta0 + shift
        ours = float(gpc.log_marginal_likelihood(OURS, jnp.asarray(theta), data))
        theirs = m.log_marginal_likelihood(theta)
        np.testing.assert_allclose(ours, theirs, rtol=1e-8)


def test_batched_lml_matches_scalar():
    data = _data(16)
    thetas = jnp.asarray(OURS.theta0)[None, :] + jnp.linspace(-0.3, 0.3, 5)[:, None]
    batch = batched_lml(OURS, thetas, data.X, data.y, data.alpha_diag, data.mask)
    singles = [
        float(gpc.log_marginal_likelihood(OURS, t, data)) for t in thetas
    ]
    np.testing.assert_allclose(np.asarray(batch), singles, rtol=1e-10)


def test_lml_non_pd_is_neg_inf():
    # A kernel with huge constant and tiny noise on duplicated points is
    # numerically non-PD -> reference maps the LinAlgError to -inf
    # (bask/bayesgpr.py:373-379); we must do the same branchlessly.
    Xdup = np.zeros((8, 1))
    ydup = np.zeros(8)
    data = gpc.make_data(Xdup, ydup, np.zeros(8), np.ones(8, dtype=bool))
    k = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.RBF(1.0, (0.1, 10.0))
    lml = gpc.log_marginal_likelihood(k, jnp.asarray(k.theta0), data)
    assert not np.isfinite(float(lml))


@pytest.mark.parametrize("n_pad", [N, 32])
def test_predict_parity(n_pad):
    m = _sk_gpr()
    data = _data(n_pad)
    theta = jnp.asarray(OURS.theta0)
    post = gpc.posterior(OURS, theta, data)
    Xq = rng.uniform(size=(9, D))

    mean_sk, std_sk = m.predict(Xq, return_std=True)
    mean, std = gpc.predict(OURS, theta, post, data, Xq, return_std=True)
    np.testing.assert_allclose(np.asarray(mean), mean_sk, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(std), std_sk, rtol=1e-7, atol=1e-9)

    mean_sk, cov_sk = m.predict(Xq, return_cov=True)
    mean, cov = gpc.predict(OURS, theta, post, data, Xq, return_cov=True)
    np.testing.assert_allclose(np.asarray(cov), cov_sk, rtol=1e-6, atol=1e-9)


def test_noise_free_reduces_std():
    data = _data(16)
    theta = jnp.asarray(OURS.theta0)
    post = gpc.posterior(OURS, theta, data)
    widx = bk.white_theta_index(OURS)
    theta_nf = gpc.noise_free_theta(OURS, theta, widx)
    Xq = rng.uniform(size=(4, D))
    _, std_noisy = gpc.predict(OURS, theta, post, data, Xq, return_std=True)
    _, std_nf = gpc.predict(OURS, theta_nf, post, data, Xq, return_std=True)
    assert np.all(np.asarray(std_nf) < np.asarray(std_noisy))


def test_y_normalization():
    data = gpc.make_data(
        np.vstack([X, np.full((4, D), 0.5)]),
        np.concatenate([(y - y.mean()) / y.std(), np.zeros(4)]),
        np.full(N + 4, ALPHA),
        np.arange(N + 4) < N,
        y_mean=y.mean(),
        y_std=y.std(),
    )
    theta = jnp.asarray(OURS.theta0)
    post = gpc.posterior(OURS, theta, data)
    mean = gpc.predict_mean(OURS, theta, post, data, X)
    # Interpolates near the data in original units
    assert np.corrcoef(np.asarray(mean), y)[0, 1] > 0.9


def test_sample_y_moments():
    data = _data(16)
    theta = jnp.asarray(OURS.theta0)
    post = gpc.posterior(OURS, theta, data)
    Xq = rng.uniform(size=(6, D))
    key = jax.random.PRNGKey(0)
    S = gpc.sample_y(OURS, theta, post, data, Xq, key, n_samples=4000)
    mean, std = gpc.predict(OURS, theta, post, data, Xq, return_std=True)
    np.testing.assert_allclose(
        np.asarray(S).mean(axis=1), np.asarray(mean), atol=4 * float(np.max(std)) / np.sqrt(4000) + 2e-2
    )
    np.testing.assert_allclose(
        np.asarray(S).std(axis=1), np.asarray(std), rtol=0.15, atol=1e-3
    )
