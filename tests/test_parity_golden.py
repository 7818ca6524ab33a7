"""Deterministic numerical-parity harness against reference formulas.

The reference pins exact acquisition argmaxes on a 101-point grid after a
real MCMC fit (``/root/reference/tests/test_acquisition.py:42-70``). RNG
streams differ across numpy/emcee vs JAX, but the MCMC is the *only*
RNG-dependent stage: with ``gpr.chain_`` fixed to a deterministic
hyperposterior fixture, every acquisition surface becomes a deterministic
function of (chain, data, formulas). Here each surface is pinned at
rtol=1e-5 against an independent NumPy/SciPy oracle implementing the
reference formulas verbatim (``/root/reference/bask/acquisition.py:150-339``),
and the argmax indices are pinned exactly.

Shared randomness (which draw indices, Gumbel uniforms, Thompson draws) is
extracted through the same seeds/keys the dispatcher uses, so the oracle
tests the *math* — marginalization, prediction, acquisition formulas —
not the RNG.
"""

import numpy as np
import pytest
import scipy.stats as st
from scipy.linalg import cho_solve, cholesky, solve_triangular
from scipy.optimize import brentq

import jax
import jax.numpy as jnp

from bask_tpu.acquisition import (
    LCB,
    PVRS,
    Expectation,
    ExpectedImprovement,
    MaxValueSearch,
    ThompsonSampling,
    TopTwoEI,
    VarianceReduction,
    evaluate_acquisitions,
)
from bask_tpu.models.bayesgpr import BayesGPR
from bask_tpu.ops import kernels as bk
from bask_tpu.utils.median import geometric_median

SEED = 7
N_DRAWS = 20

# The reference 4-point problem (tests/test_acquisition.py:56-57)
X_TRAIN = np.array([-2.0, -1.0, 1.0, 2.0])[:, None]
Y_TRAIN = np.array([0.0, -1.0, 1.0, 2.0])
X_GRID = np.linspace(-2.0, 2.0, num=101)[:, None]

# Deterministic hyperposterior fixture: theta = log([constant, ls, noise]).
# Centered at plausible posterior values for the 4-point problem, with a
# fixed-seed spread — NOT a sampled chain, so the surfaces are exactly
# reproducible forever.
CHAIN_CENTER = np.log([0.6, 1.0, 0.01])
CHAIN = CHAIN_CENTER + 0.10 * np.random.RandomState(42).randn(512, 3)

BASE_ALPHA = 1e-10  # BayesGPR default jitter added to the training gram


@pytest.fixture(scope="module")
def fixed_gp():
    kernel = bk.ConstantKernel(1.0, (1e-4, 1.0)) * bk.RBF(1.0, (0.5, 1.5))
    gp = BayesGPR(kernel=kernel, normalize_y=False, random_state=1)
    # tiny real fit to establish kernel_/data/posterior state, then
    # inject a deterministic chain fixture: fix chain_, and everything
    # downstream is deterministic
    gp.fit(
        X_TRAIN,
        Y_TRAIN,
        n_desired_samples=8,
        n_burnin=1,
        n_walkers_per_thread=8,
        progress=False,
    )
    gp.chain_ = CHAIN.copy()
    median = np.asarray(geometric_median(jnp.asarray(CHAIN)))
    gp.theta = median
    gp.noise_ = float(np.exp(median[2]))
    return gp


# ---------------------------------------------------------------------------
# NumPy oracle: GP prediction + the reference acquisition formulas
# ---------------------------------------------------------------------------


def np_rbf(theta, A, B):
    c, ls = np.exp(theta[0]), np.exp(theta[1])
    d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1) / ls**2
    return c * np.exp(-0.5 * d2)


def np_train_gram(theta):
    noise = np.exp(theta[2])
    K = np_rbf(theta, X_TRAIN, X_TRAIN)
    K[np.diag_indices_from(K)] += noise + BASE_ALPHA
    return K


def np_predict(theta, Xq):
    """Noise-free predictive (mu, std), mirroring the dispatcher's
    noise_set_to_zero semantics (factorization keeps the noise)."""
    K = np_train_gram(theta)
    L = cholesky(K, lower=True)
    dual = cho_solve((L, True), Y_TRAIN)
    Ks = np_rbf(theta, Xq, X_TRAIN)  # white kernel: zero cross-covariance
    mu = Ks @ dual
    v = solve_triangular(L, Ks.T, lower=True)
    var = np.maximum(np.exp(theta[0]) - np.sum(v * v, axis=0), 0.0)
    return mu, np.sqrt(var)


def draw_rows(seed, n_draws):
    """Replicate the dispatcher's chain-row selection."""
    rs = np.random.RandomState(seed)
    idx = rs.choice(len(CHAIN), replace=False, size=n_draws)
    return CHAIN[idx], rs


def _ei_f(x):
    return x * st.norm.cdf(x) + st.norm.pdf(x)


def oracle_ei(mu, std, y_opt=None):
    if y_opt is None:
        y_opt = mu.min()
    values = np.zeros_like(mu)
    mask = std > 0
    inner = (y_opt - mu[mask]) / std[mask]
    values[mask] = _ei_f(inner) * std[mask]
    return values


def oracle_ttei(mu, std):
    ei = oracle_ei(mu, std)
    values = np.zeros_like(mu)
    i_max_ei = np.argmax(ei)
    mask = std > 0
    outer = np.sqrt(std[mask] ** 2 + std[i_max_ei] ** 2)
    inner = (mu[i_max_ei] - mu[mask]) / outer
    values[mask] = outer * _ei_f(inner)
    return values


def oracle_mean(mu, std):
    return -mu


def oracle_lcb(mu, std, alpha=1.96):
    return alpha * std - mu


def oracle_mes(mu, std, u):
    """Reference MES (bask/acquisition.py:234-267) with supplied Gumbel
    uniforms ``u`` (shared with the JAX path via the same PRNG key)."""
    mean = -mu
    std = np.maximum(std, 1e-12)

    def probf(x):
        return np.exp(np.sum(st.norm.logcdf((x - mean) / std), axis=0))

    left = np.min(mean - 3 * std)
    right = np.max(mean + 5 * std)
    q1, med, q2 = [
        brentq(lambda x, val=val: probf(x) - val, left, right)
        for val in [0.25, 0.5, 0.75]
    ]
    beta = (q1 - q2) / (np.log(np.log(4.0 / 3.0)) - np.log(np.log(4.0)))
    alpha = med + beta * np.log(np.log(2.0))
    max_values = -np.log(-np.log(u)) * beta + alpha
    gamma = (max_values[None, :] - mean[:, None]) / std[:, None]
    return np.mean(
        gamma * st.norm.pdf(gamma) / (2.0 * st.norm.cdf(gamma))
        - st.norm.logcdf(gamma),
        axis=1,
    )


def oracle_variance_explained(theta, X_cand, probes):
    """Reference per-candidate augmented-Cholesky loop
    (bask/acquisition.py:289-299): total predictive variance at the
    probe points explained after adding each candidate. Run at the
    consensus theta with the noise *kept* (FullGP acquisitions run
    outside the noise_set_to_zero context)."""
    noise = np.exp(theta[2])
    covs = np.empty(len(X_cand))
    for i in range(len(X_cand)):
        X_aug = np.concatenate([X_TRAIN, [X_cand[i]]])
        K = np_rbf(theta, X_aug, X_aug)
        K[np.diag_indices_from(K)] += noise  # white kernel, all rows
        K[np.diag_indices_from(K)] += np.concatenate(
            [np.full(len(X_TRAIN), BASE_ALPHA), [0.0]]
        )
        L = cholesky(K, lower=True)
        # NB: the white kernel contributes ZERO to the cross-gram even
        # for coincident points (sklearn two-argument kernel call)
        K_trans = np_rbf(theta, probes, X_aug)
        v = cho_solve((L, True), K_trans.T)
        covs[i] = np.diag(K_trans @ v).sum()
    return covs


# ---------------------------------------------------------------------------
# Tests: every acquisition surface at rtol<=1e-5, argmax exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "acq,oracle",
    [
        (ExpectedImprovement(), oracle_ei),
        (TopTwoEI(), oracle_ttei),
        (Expectation(), oracle_mean),
        (LCB(), oracle_lcb),
    ],
)
def test_uncertainty_acquisitions_match_oracle(fixed_gp, acq, oracle):
    ours = evaluate_acquisitions(
        X_GRID,
        fixed_gp,
        acquisition_functions=(acq,),
        n_samples=N_DRAWS,
        random_state=SEED,
    )[0]
    rows, _ = draw_rows(SEED, N_DRAWS)
    expected = np.zeros(len(X_GRID))
    for theta in rows:
        mu, std = np_predict(theta, X_GRID)
        expected += oracle(mu, std) / N_DRAWS
    np.testing.assert_allclose(ours, expected, rtol=1e-5, atol=1e-10)
    assert int(np.argmax(ours)) == int(np.argmax(expected))


def test_mes_matches_oracle(fixed_gp):
    ours = evaluate_acquisitions(
        X_GRID,
        fixed_gp,
        acquisition_functions=(MaxValueSearch(),),
        n_samples=N_DRAWS,
        random_state=SEED,
    )[0]
    # replicate the dispatcher's RNG bookkeeping to extract the exact
    # Gumbel uniforms each draw consumed
    rows, rs = draw_rows(SEED, N_DRAWS)
    _ = rs.randint(0, 2**31 - 1)  # the sample_y key (unused by MES)
    acq_keys = jax.random.split(
        jax.random.PRNGKey(rs.randint(0, 2**31 - 1)), N_DRAWS
    )
    expected = np.zeros(len(X_GRID))
    for theta, k in zip(rows, acq_keys):
        mu, std = np_predict(theta, X_GRID)
        u = np.asarray(
            jax.random.uniform(
                k, (1000,), dtype=jnp.float64, minval=1e-12, maxval=1.0
            )
        )
        expected += oracle_mes(mu, std, u) / N_DRAWS
    np.testing.assert_allclose(ours, expected, rtol=1e-5, atol=1e-10)
    assert int(np.argmax(ours)) == int(np.argmax(expected))


def test_variance_reduction_matches_reference_formula(fixed_gp):
    ours = evaluate_acquisitions(
        X_GRID,
        fixed_gp,
        acquisition_functions=(VarianceReduction(),),
        n_samples=0,
        random_state=SEED,
    )[0]
    expected = oracle_variance_explained(
        np.asarray(fixed_gp.theta), X_GRID, X_GRID
    )
    np.testing.assert_allclose(ours, expected, rtol=1e-5)
    assert int(np.argmax(ours)) == int(np.argmax(expected))


def test_pvrs_matches_reference_formula(fixed_gp):
    ours = evaluate_acquisitions(
        X_GRID,
        fixed_gp,
        acquisition_functions=(PVRS(),),
        n_samples=0,
        random_state=SEED,
    )[0]
    # PVRS consumes the dispatcher RandomState for its Thompson draws;
    # replicate with a same-seed RandomState to get identical probes
    rs = np.random.RandomState(SEED)
    ts = fixed_gp.sample_y(
        X_GRID, sample_mean=True, n_samples=10, random_state=rs
    )
    probes = X_GRID[np.argmin(ts, axis=0)]
    expected = oracle_variance_explained(
        np.asarray(fixed_gp.theta), X_GRID, probes
    )
    np.testing.assert_allclose(ours, expected, rtol=1e-5)
    assert int(np.argmax(ours)) == int(np.argmax(expected))


def test_thompson_sampling_statistics(fixed_gp):
    """TS is the only irreducibly stochastic surface (per-draw function
    realizations). Pin it with a principled 5-sigma Monte-Carlo bound
    around its exact expectation -E[mu] instead of a vacuous argmax
    window: E[acq_ts] = -mean_draws(mu), Var = sum(std_i^2)/S^2."""
    S = 256
    ours = evaluate_acquisitions(
        X_GRID,
        fixed_gp,
        acquisition_functions=(ThompsonSampling(),),
        n_samples=S,
        random_state=SEED,
    )[0]
    rows, _ = draw_rows(SEED, S)
    mus, var_sum = np.zeros(len(X_GRID)), np.zeros(len(X_GRID))
    for theta in rows:
        mu, std = np_predict(theta, X_GRID)
        mus += mu / S
        var_sum += std**2
    tol = 5.0 * np.sqrt(var_sum) / S + 1e-12
    assert np.all(np.abs(ours - (-mus)) < tol), (
        np.max(np.abs(ours + mus) - tol)
    )


def test_consensus_predict_matches_oracle(fixed_gp):
    """The consensus model itself: predict(mu, std) at the geometric
    median theta against the scipy GPML oracle (noise kept)."""
    mu, std = fixed_gp.predict(X_GRID, return_std=True)
    theta = np.asarray(fixed_gp.theta)
    K = np_train_gram(theta)
    L = cholesky(K, lower=True)
    dual = cho_solve((L, True), Y_TRAIN)
    Ks = np_rbf(theta, X_GRID, X_TRAIN)
    mu_o = Ks @ dual
    v = solve_triangular(L, Ks.T, lower=True)
    var = np.maximum(
        np.exp(theta[0]) + np.exp(theta[2]) - np.sum(v * v, axis=0), 0.0
    )
    np.testing.assert_allclose(mu, mu_o, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(std, np.sqrt(var), rtol=1e-8, atol=1e-12)
