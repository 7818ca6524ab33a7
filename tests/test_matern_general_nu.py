"""General-nu Matern (on-device Bessel form).

The reference supports arbitrary nu through sklearn's Matern (used by the
kernel algebra at reference ``bask/bayesgpr.py:163``). K_nu evaluates on
device (``bask_tpu.ops.bessel``: Temme series + Steed CF2) — no host
callback, so general-nu works on backends that reject host
callbacks. Parity targets: kve against scipy over the full
operating range, gram/LML/predict against sklearn at nu=0.75, LML
gradients against finite differences (the custom-JVP Bessel identity),
an end-to-end BayesGPR fit, and a lowering check that the traced path
contains no callback custom-calls.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from sklearn.gaussian_process import GaussianProcessRegressor
from sklearn.gaussian_process import kernels as skk

from bask_tpu.models import gp as gpc
from bask_tpu.ops import kernels as bk

NU = 0.75
rng = np.random.RandomState(0)
X = rng.uniform(size=(20, 2))
Y_DATA = np.sin(3 * X[:, 0]) + 0.1 * rng.randn(20)


def _our_kernel():
    return bk.ConstantKernel(1.3, (0.1, 10.0)) * bk.Matern(
        (0.4, 0.7), (0.05, 5.0), nu=NU
    ) + bk.WhiteKernel(0.05, (1e-5, 1e1))


def _sk_kernel():
    return skk.ConstantKernel(1.3, (0.1, 10.0)) * skk.Matern(
        (0.4, 0.7), (0.05, 5.0), nu=NU
    ) + skk.WhiteKernel(0.05, (1e-5, 1e1))


def _data():
    return gpc.make_data(
        jnp.asarray(X),
        jnp.asarray(Y_DATA),
        jnp.full(len(X), 1e-10),
        jnp.ones(len(X), bool),
    )


def test_gram_matches_sklearn():
    ours = np.asarray(
        _our_kernel().eval(jnp.asarray(_our_kernel().theta0), jnp.asarray(X))
    )
    theirs = _sk_kernel()(X)
    np.testing.assert_allclose(ours, theirs, rtol=1e-8, atol=1e-12)


def test_cross_gram_matches_sklearn():
    X2 = rng.uniform(size=(7, 2))
    ours = np.asarray(
        _our_kernel().eval(
            jnp.asarray(_our_kernel().theta0), jnp.asarray(X), jnp.asarray(X2)
        )
    )
    theirs = _sk_kernel()(X, X2)
    np.testing.assert_allclose(ours, theirs, rtol=1e-8, atol=1e-12)


def test_lml_matches_sklearn():
    kernel = _our_kernel()
    theta = jnp.asarray(kernel.theta0)
    ours = float(gpc.log_marginal_likelihood(kernel, theta, _data()))
    sk = GaussianProcessRegressor(
        kernel=_sk_kernel(), optimizer=None, alpha=1e-10
    ).fit(X, Y_DATA)
    theirs = sk.log_marginal_likelihood(np.asarray(theta))
    np.testing.assert_allclose(ours, theirs, rtol=1e-8)


def test_predict_matches_sklearn():
    kernel = _our_kernel()
    theta = jnp.asarray(kernel.theta0)
    data = _data()
    post = gpc.posterior(kernel, theta, data)
    Xq = rng.uniform(size=(9, 2))
    mu, std = gpc.predict(
        kernel, theta, post, data, jnp.asarray(Xq), return_std=True
    )
    sk = GaussianProcessRegressor(
        kernel=_sk_kernel(), optimizer=None, alpha=1e-10
    ).fit(X, Y_DATA)
    mu_sk, std_sk = sk.predict(Xq, return_std=True)
    np.testing.assert_allclose(np.asarray(mu), mu_sk, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(np.asarray(std), std_sk, rtol=1e-6, atol=1e-9)


def test_lml_gradient_matches_finite_differences():
    kernel = _our_kernel()
    data = _data()
    theta0 = np.asarray(kernel.theta0)

    def f(t):
        return float(
            gpc.log_marginal_likelihood(kernel, jnp.asarray(t), data)
        )

    grad = np.asarray(
        jax.grad(
            lambda t: gpc.log_marginal_likelihood(kernel, t, data)
        )(jnp.asarray(theta0))
    )
    eps = 1e-6
    for i in range(len(theta0)):
        tp, tm = theta0.copy(), theta0.copy()
        tp[i] += eps
        tm[i] -= eps
        fd = (f(tp) - f(tm)) / (2 * eps)
        np.testing.assert_allclose(grad[i], fd, rtol=1e-4, atol=1e-7)


def test_batched_lml_general_nu():
    """The MCMC hot path (vmapped LML) must work for general nu via the
    callback's batched dispatch."""
    from bask_tpu.ops.linalg import batched_lml

    kernel = _our_kernel()
    data = _data()
    thetas = np.asarray(kernel.theta0)[None, :] + 0.05 * np.random.RandomState(
        1
    ).randn(6, kernel.n_theta)
    batch = np.asarray(
        batched_lml(
            kernel,
            jnp.asarray(thetas),
            data.X,
            data.y,
            data.alpha_diag,
            data.mask,
        )
    )
    single = [
        float(gpc.log_marginal_likelihood(kernel, jnp.asarray(t), data))
        for t in thetas
    ]
    np.testing.assert_allclose(batch, single, rtol=1e-9)


@pytest.mark.slow
def test_bayesgpr_fit_general_nu():
    from bask_tpu.models.bayesgpr import BayesGPR

    gp = BayesGPR(
        kernel=bk.ConstantKernel(1.0, (0.1, 10.0))
        * bk.Matern((0.5, 0.5), (0.05, 5.0), nu=NU),
        random_state=3,
    )
    gp.fit(
        X,
        Y_DATA,
        n_desired_samples=20,
        n_burnin=2,
        n_walkers_per_thread=20,
        progress=False,
    )
    assert np.isfinite(gp.chain_).all()
    mu, std = gp.predict(X, return_std=True)
    assert np.all(np.abs(mu - Y_DATA) < 3 * np.sqrt(std**2 + gp.noise_) + 0.3)


def test_kve_matches_scipy_wide_range():
    """On-device exp-scaled Bessel K vs scipy over order and argument."""
    import scipy.special as sps

    from bask_tpu.ops.bessel import kve

    x = np.concatenate(
        [np.geomspace(1e-10, 2.0, 120), np.geomspace(2.0, 300.0, 120)]
    )
    for nu in (0.0, 0.05, 0.25, 0.49, 0.5, 0.75, 1.2, 3.7, 12.9, 37.6):
        ours = np.asarray(kve(nu, jnp.asarray(x)))
        ref = sps.kve(nu, x)
        finite = np.isfinite(ref)
        np.testing.assert_allclose(ours[finite], ref[finite], rtol=1e-11)
        # where scipy's own recurrence overflows (large order, tiny x),
        # ours must be inf or a huge near-overflow value (it can stay
        # finite slightly deeper into the corner than scipy does)
        assert (
            ~np.isfinite(ours[~finite]) | (ours[~finite] > 1e300)
        ).all()


def test_matern_general_matches_scipy_vmapped():
    """VERDICT r2 #4 contract: rtol <= 1e-6 (met at 1e-10) vs the scipy
    formula over nu in {0.75, 1.2, 3.7}, r in [1e-8, 50], under vmap."""
    import scipy.special as sps

    from bask_tpu.ops.kernels import _matern_general

    r = np.geomspace(1e-8, 50.0, 400)
    rows = jnp.asarray(r.reshape(8, 50))
    for nu in (0.75, 1.2, 3.7):
        z = np.sqrt(2 * nu) * r
        coef = np.exp((1 - nu) * np.log(2.0) - sps.gammaln(nu))
        with np.errstate(over="ignore", invalid="ignore"):
            ref = np.where(z > 1e-8, coef * z**nu * sps.kv(nu, z), 1.0)
        ours = np.asarray(
            jax.vmap(lambda rr: _matern_general(rr, nu))(rows)
        ).ravel()
        np.testing.assert_allclose(ours, ref, rtol=1e-10, atol=1e-300)


def test_matern_general_traced_path_has_no_callback():
    """The general-nu gram must lower to pure XLA ops: backends without
    host-callback support run it natively."""
    k = bk.Matern(0.3, (0.05, 2.0), nu=1.7)
    t = jnp.asarray(k.theta0)
    Xq = jnp.asarray(np.random.RandomState(0).uniform(size=(4, 2)))
    text = jax.jit(lambda th: k.eval(th, Xq)).lower(t).as_text()
    assert "callback" not in text.lower()
    # gradients too (the custom JVP evaluates K_{nu-1} on device)
    gtext = (
        jax.jit(jax.grad(lambda th: k.eval(th, Xq).sum())).lower(t).as_text()
    )
    assert "callback" not in gtext.lower()


def test_general_nu_f32_diagonal_finite():
    """f32 inputs with the epsilon-floored distance (the accelerator
    hot-path dtype) must not produce 0*inf = NaN on the gram diagonal for any nu
    (regression: z**nu underflowed while K_nu(z) overflowed before the
    callback upcast + small-z limit)."""
    import jax

    rng = np.random.RandomState(0)
    X32 = jnp.asarray(rng.uniform(size=(6, 2)), jnp.float32)
    for nu in (0.75, 3.5, 5.0, 20.0):
        k = bk.Matern(0.3, (0.05, 2.0), nu=nu)
        t = jnp.asarray(k.theta0, jnp.float32)
        G = np.asarray(k.eval(t, X32))
        assert np.isfinite(G).all(), nu
        np.testing.assert_allclose(np.diag(G), 1.0, rtol=1e-6)
        g = np.asarray(jax.jacfwd(lambda th: k.eval(th, X32).sum())(t))
        assert np.isfinite(g).all(), nu
