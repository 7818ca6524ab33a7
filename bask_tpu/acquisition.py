"""Acquisition functions marginalized over the hyperposterior — one fused pass.

Capability parity with the reference's ``bask/acquisition.py``: the same 8
acquisitions under the same three ABCs, plus the ``evaluate_acquisitions``
dispatcher. Design differences:

* the reference loops hyperposterior draws in Python, re-factorizing the
  kernel per draw (``bask/acquisition.py:112-141``); here all draws run in
  one jitted ``vmap`` — a single batched Cholesky for the whole
  marginalization,
* PVRS / VarianceReduction avoid the reference's per-candidate
  (n+1)x(n+1) Cholesky loop (``bask/acquisition.py:289-299,329-338``):
  the augmented factor is obtained by a rank-1 border of the *shared*
  train factor, so the whole candidate grid costs two triangular solves
  and matmuls (O(C n^2) instead of O(C n^3)),
* MaxValueSearch replaces the three brentq percentile solves
  (``bask/acquisition.py:243-252``) with fixed-iteration bisection, which
  is jit- and vmap-compatible.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .models import gp as gpc
from .models import warping as wpm
from .ops.linalg import augmented_quadform
from .utils.aot import aot_call
from .utils.stats import norm_cdf, norm_logcdf, norm_pdf

# Route supported single-acquisition tell passes through one fused
# device program ("on"); "off" forces the legacy multi-dispatch path
# (used by the parity tests pinning fused == unfused).
FUSED_ACQUISITION = "on"

__all__ = [
    "evaluate_acquisitions",
    "evaluate_acquisitions_fused",
    "Acquisition",
    "UncertaintyAcquisition",
    "SampleAcquisition",
    "FullGPAcquisition",
    "ExpectedImprovement",
    "TopTwoEI",
    "Expectation",
    "LCB",
    "MaxValueSearch",
    "ThompsonSampling",
    "VarianceReduction",
    "PVRS",
]


class Acquisition(ABC):
    @abstractmethod
    def __call__(self, *args, **kwargs):
        ...


class UncertaintyAcquisition(Acquisition, ABC):
    """Evaluated from the predictive (mu, std) of one hyperposterior draw."""

    @abstractmethod
    def __call__(self, mu, std, *args, **kwargs):
        ...


class SampleAcquisition(Acquisition, ABC):
    """Evaluated from one joint posterior function draw."""

    @abstractmethod
    def __call__(self, gp_sample, *args, **kwargs):
        ...


class FullGPAcquisition(Acquisition, ABC):
    """Needs the full GP state (consensus model)."""

    @abstractmethod
    def __call__(self, X, gp, *args, **kwargs):
        ...


def _ei_term(z):
    return z * norm_cdf(z) + norm_pdf(z)


class ExpectedImprovement(UncertaintyAcquisition):
    """EI over the current observed minimum (default: min of mu)."""

    def __call__(self, mu, std, *args, y_opt=None, **kwargs):
        if y_opt is None:
            y_opt = jnp.min(mu)
        ok = std > 0
        safe_std = jnp.where(ok, std, 1.0)
        z = (y_opt - mu) / safe_std
        return jnp.where(ok, _ei_term(z) * safe_std, 0.0)


class TopTwoEI(ExpectedImprovement):
    """EI over the point of maximal EI (top-two criterion)."""

    def __call__(self, mu, std, *args, y_opt=None, **kwargs):
        ei = super().__call__(mu, std, y_opt=y_opt)
        i_best = jnp.argmax(ei)
        ok = std > 0
        outer = jnp.sqrt(std**2 + std[i_best] ** 2)
        safe_outer = jnp.where(ok, outer, 1.0)
        z = (mu[i_best] - mu) / safe_outer
        return jnp.where(ok, safe_outer * _ei_term(z), 0.0)


class Expectation(UncertaintyAcquisition):
    """Pure exploitation: argmax of -mu."""

    def __call__(self, mu, std, *args, **kwargs):
        return -mu


class LCB(UncertaintyAcquisition):
    """Lower confidence bound; ``alpha="inf"`` reduces to pure exploration."""

    def __call__(self, mu, std, *args, alpha=1.96, **kwargs):
        if alpha == "inf":  # exact match, as in the reference
            # (bask/acquisition.py:213-216); other strings fall through
            # to the arithmetic and raise, same as upstream
            return std
        return alpha * std - mu


class MaxValueSearch(UncertaintyAcquisition):
    """Max-value entropy search (Wang & Jegelka 2017) with a Gumbel
    approximation of the optimum-value distribution."""

    def __call__(self, mu, std, *args, n_min_samples=1000, key=None, **kwargs):
        if key is None:
            # Fresh Gumbel draws per bare call, matching the reference's
            # use of the global NumPy RNG (bask/acquisition.py:254). The
            # fused/marginalized dispatchers always pass per-draw keys;
            # inside jit the trace-time seed is baked in, so traced
            # callers should pass ``key`` explicitly.
            key = jax.random.PRNGKey(int(np.random.randint(0, 2**31 - 1)))
        mean = -mu
        std = jnp.maximum(std, 1e-12)
        left = jnp.min(mean - 3.0 * std)
        right = jnp.max(mean + 5.0 * std)

        def cdf_max(x):
            return jnp.exp(jnp.sum(norm_logcdf((x - mean) / std)))

        def percentile(q):
            def body(_, lohi):
                lo, hi = lohi
                mid = 0.5 * (lo + hi)
                below = cdf_max(mid) < q
                return (
                    jnp.where(below, mid, lo),
                    jnp.where(below, hi, mid),
                )

            lo, hi = jax.lax.fori_loop(0, 72, body, (left, right))
            return 0.5 * (lo + hi)

        q1, med, q2 = percentile(0.25), percentile(0.5), percentile(0.75)
        beta = (q1 - q2) / (
            jnp.log(jnp.log(4.0 / 3.0)) - jnp.log(jnp.log(4.0))
        )
        alpha = med + beta * jnp.log(jnp.log(2.0))
        u = jax.random.uniform(
            key, (n_min_samples,), dtype=mu.dtype, minval=1e-12, maxval=1.0
        )
        max_values = -jnp.log(-jnp.log(u)) * beta + alpha

        gamma = (max_values[None, :] - mean[:, None]) / std[:, None]
        mi = (
            gamma * norm_pdf(gamma) / (2.0 * jnp.maximum(norm_cdf(gamma), 1e-16))
            - norm_logcdf(gamma)
        )
        return jnp.mean(mi, axis=1)


class ThompsonSampling(SampleAcquisition):
    """Argmax of a negated joint posterior draw."""

    def __call__(self, gp_sample, *args, **kwargs):
        return -gp_sample


def _variance_explained_body(kernel, theta, post, data, X_cand, P):
    """Total predictive variance at probe points P explained after
    augmenting the training set with each candidate (the PVRS/VR score).

    Uses the shared-factor rank-1 border; see
    :func:`bask_tpu.ops.linalg.augmented_quadform`.
    """
    from jax.scipy.linalg import solve_triangular

    mask = data.mask
    A = kernel.eval(theta, P, data.X) * mask[None, :]  # (m, n_pad)
    A_sol = solve_triangular(post.L, A.T, lower=True)  # (n_pad, m)
    k_c = kernel.eval(theta, data.X, X_cand) * mask[:, None]  # (n_pad, C)
    l_cand = solve_triangular(post.L, k_c, lower=True)
    k_cc = kernel.diag(theta, X_cand)
    d2 = jnp.maximum(k_cc - jnp.sum(l_cand * l_cand, axis=0), 1e-16)
    b = kernel.eval(theta, P, X_cand)  # (m, C)
    return augmented_quadform(post.L, l_cand, jnp.sqrt(d2), A_sol, b)


@partial(jax.jit, static_argnames=("kernel",))
def _variance_explained(theta, post, data, X_cand, P, *, kernel):
    return _variance_explained_body(kernel, theta, post, data, X_cand, P)


@partial(
    jax.jit,
    static_argnames=("kernel", "n_thompson", "white_idx", "with_thompson"),
)
def _fused_fullgp_vals(
    theta, post, data, Xw, key, *,
    kernel, n_thompson, white_idx, with_thompson,
):
    """ONE device program for the PVRS / VarianceReduction tell pass:
    (Thompson draws -> probe selection ->) variance-explained scores.

    The legacy path runs ``sample_y`` eagerly (an op-by-op dispatch
    chain) plus a separate jitted score program; this fuses the whole
    pass. Optimization barriers materialize the Thompson
    draws and probes exactly where the legacy path crosses to the host,
    so both paths produce bit-identical scores.
    """
    if with_thompson:
        theta_nf = gpc.noise_free_theta(kernel, theta, white_idx)
        ts = gpc.sample_y(kernel, theta_nf, post, data, Xw, key, n_thompson)
        ts = jax.lax.optimization_barrier(ts)
        P = Xw[jnp.argmin(ts, axis=0)]
        P = jax.lax.optimization_barrier(P)
    else:
        P = Xw
    return _variance_explained_body(kernel, theta, post, data, Xw, P)


@partial(
    jax.jit,
    static_argnames=(
        "kernel", "n_warp", "white_idx", "need_sample", "acq", "kwargs_tuple",
    ),
)
def _fused_marginal_vals(
    rows, data, X, key, acq_keys, *,
    kernel, n_warp, white_idx, need_sample, acq, kwargs_tuple,
):
    """ONE device program for a marginalized Uncertainty/Sample
    acquisition: per-draw predictions + per-draw acquisition values.
    Returns the (S, m) value matrix; the host applies the same finite
    filter / averaging as the legacy dispatcher (bit-identical)."""
    mu_s, std_s, samp_s = _per_draw_body(
        rows, data, X, key, kernel, n_warp, white_idx, need_sample
    )
    mu_s, std_s, samp_s = jax.lax.optimization_barrier(
        (mu_s, std_s, samp_s)
    )
    kw = dict(kwargs_tuple)
    if isinstance(acq, UncertaintyAcquisition):
        return jax.vmap(lambda m, s, k: acq(m, s, key=k, **kw))(
            mu_s, std_s, acq_keys
        )
    return jax.vmap(lambda s: acq(s, **kw))(samp_s)


class VarianceReduction(FullGPAcquisition):
    """Active-learning criterion: total variance explained over the whole
    candidate grid after adding each candidate."""

    def __call__(self, X, gp, *args, **kwargs):
        X = np.asarray(X)
        Xw = jnp.asarray(gp.warp(X), dtype=gp._dtype())
        theta = jnp.asarray(gp._theta, dtype=gp._dtype())
        vals = aot_call(
            _variance_explained,
            theta, gp._post, gp._post_data, Xw, Xw,
            kernel=gp._spec,
        )
        return np.asarray(vals)


class PVRS(FullGPAcquisition):
    """Predictive variance reduction search (Nguyen et al. 2017): minimize
    the summed predictive variance at Thompson-sampled minimizers."""

    def __call__(self, X, gp, *args, n_thompson=10, random_state=None, **kwargs):
        X = np.asarray(X)
        ts = gp.sample_y(
            X, sample_mean=True, n_samples=n_thompson, random_state=random_state
        )
        Xw = np.asarray(gp.warp(X))
        thompson_points = Xw[np.argmin(ts, axis=0)]
        theta = jnp.asarray(gp._theta, dtype=gp._dtype())
        vals = aot_call(
            _variance_explained,
            theta,
            gp._post,
            gp._post_data,
            jnp.asarray(Xw, dtype=gp._dtype()),
            jnp.asarray(thompson_points, dtype=gp._dtype()),
            kernel=gp._spec,
        )
        return np.asarray(vals)


# ---------------------------------------------------------------------------
# Marginalized evaluation
# ---------------------------------------------------------------------------


def _per_draw_body(rows, data, X, key, kernel, n_warp, white_idx, need_sample):
    """mu/std (and optional function draw) for each hyperposterior row.

    Returns (S, m) arrays; one batched factorization for all draws.
    """
    keys = jax.random.split(key, rows.shape[0])

    def one(x, k):
        if n_warp:
            theta_gp, la, lb = wpm.split_warp_params(x, n_warp)
            d = data._replace(X=wpm.warp(data.X, la, lb))
            Xq = wpm.warp(X, la, lb)
        else:
            theta_gp, d, Xq = x, data, X
        # plain single-Cholesky posterior: a non-PD draw yields NaNs,
        # which the dispatcher's finite filter drops (same semantics as
        # the reference skipping non-finite acquisition outputs,
        # bask/acquisition.py:140-141) — no need for the 3-rung robust
        # ladder here, it would triple the batched factorization cost.
        # On f32 the blocked factorization also hands predict cached
        # block inverses, turning the per-draw candidate solve into
        # batched matmuls.
        post, invs = gpc.posterior_and_invs(kernel, theta_gp, d)
        theta_nf = gpc.noise_free_theta(kernel, theta_gp, white_idx)
        mu, std = gpc.predict(
            kernel, theta_nf, post, d, Xq, return_std=True, invs=invs
        )
        if need_sample:
            s = gpc.sample_y(
                kernel, theta_nf, post, d, Xq, k, 1, invs=invs
            )[:, 0]
        else:
            s = mu
        return mu, std, s

    return jax.vmap(one)(rows, keys)


@partial(
    jax.jit,
    static_argnames=("kernel", "n_warp", "white_idx", "need_sample"),
)
def _per_draw_predictions(
    rows, data, X, key, *, kernel, n_warp, white_idx, need_sample
):
    return _per_draw_body(
        rows, data, X, key, kernel, n_warp, white_idx, need_sample
    )


def evaluate_acquisitions(
    X,
    gpr,
    acquisition_functions=None,
    n_samples: int = 10,
    progress: bool = False,
    random_state=None,
    **kwargs,
):
    """Evaluate acquisitions on candidate grid X, marginalized over
    ``n_samples`` hyperposterior draws.

    Same contract as the reference dispatcher
    (``bask/acquisition.py:48-147``): FullGP acquisitions use the
    consensus model once; Uncertainty/Sample acquisitions are averaged
    over draws, with non-finite draw results dropped. Returns
    (n_acqs, n_candidates).
    """
    X = np.atleast_2d(np.asarray(X, dtype=float))
    n_acqs = len(acquisition_functions)
    out = np.zeros((n_acqs, X.shape[0]))
    if isinstance(random_state, np.random.RandomState):
        rs = random_state
    else:
        rs = np.random.RandomState(random_state)

    for i, acq in enumerate(acquisition_functions):
        if isinstance(acq, FullGPAcquisition):
            vals = acq(X, gpr, random_state=rs, **kwargs)
            if np.all(np.isfinite(vals)):
                out[i] = vals

    need_unc = any(
        isinstance(a, UncertaintyAcquisition) for a in acquisition_functions
    )
    need_sample = any(
        isinstance(a, SampleAcquisition) for a in acquisition_functions
    )
    if not (need_unc or need_sample) or n_samples <= 0:
        return out

    idx = rs.choice(len(gpr.chain_), replace=False, size=n_samples)
    rows = jnp.asarray(gpr.chain_[idx], dtype=gpr._dtype())
    n_warp = gpr._X_orig.shape[1] if gpr.warp_inputs else 0
    key = jax.random.PRNGKey(rs.randint(0, 2**31 - 1))
    mu_s, std_s, samp_s = aot_call(
        _per_draw_predictions,
        rows,
        gpr._data,
        jnp.asarray(X, dtype=gpr._dtype()),
        key,
        kernel=gpr._spec,
        n_warp=n_warp,
        white_idx=gpr.white_index_,
        need_sample=need_sample,
    )

    acq_keys = jax.random.split(
        jax.random.PRNGKey(rs.randint(0, 2**31 - 1)), n_samples
    )
    kwargs_tuple = tuple(sorted(kwargs.items()))
    from .utils.progress import get_progress_bar

    pbar = get_progress_bar(progress, n_acqs)
    for i, acq in enumerate(acquisition_functions):
        try:
            if isinstance(acq, UncertaintyAcquisition):
                vals = _eval_uncertainty(
                    acq, mu_s, std_s, acq_keys, kwargs_tuple
                )
            elif isinstance(acq, SampleAcquisition):
                vals = _eval_sample(acq, samp_s, kwargs_tuple)
            else:
                continue
        except TypeError:  # unhashable kwargs -> eager fallback
            if isinstance(acq, UncertaintyAcquisition):
                vals = jax.vmap(
                    lambda m, s, k: acq(m, s, key=k, **kwargs)
                )(mu_s, std_s, acq_keys)
            else:
                vals = jax.vmap(lambda s: acq(s, **kwargs))(samp_s)
        vals = np.asarray(vals)  # (S, m)
        finite = np.all(np.isfinite(vals), axis=1)
        if finite.any():
            out[i] += vals[finite].sum(axis=0) / n_samples
        pbar.update(1)
    pbar.close()
    return out


def evaluate_acquisitions_fused(
    X,
    gpr,
    acq,
    n_samples: int = 10,
    random_state=None,
    _defer=False,
    **kwargs,
):
    """Fused single-acquisition tell pass.

    Evaluates ONE acquisition on the candidate grid in a single device
    program (per-draw predictions + acquisition values, or Thompson
    draws + variance scores for PVRS/VR), consuming the host RNG in
    exactly the same order as :func:`evaluate_acquisitions` — results
    are bit-identical to the legacy multi-dispatch path. Returns a
    (1, n_candidates) array, or ``None`` when this acquisition/config is
    not fusable (caller falls back to the legacy dispatcher).

    ``_defer=True`` (the warm-tell overlap path): instead of fetching
    the values, return ``(vals_dev, shape, postprocess)`` — the device
    output, its host shape, and the finite-filter/averaging closure.
    The caller packs ``vals_dev`` onto the deferred sample blob
    (``BayesGPR._finalize_sample``) so the whole tell crosses
    device->host in one fetch, then applies ``postprocess`` to the
    unpacked host values. Device inputs (consensus theta, chain rows)
    come from the pending sample's device handles — no host round-trip.
    """
    if FUSED_ACQUISITION != "on":
        return None
    X = np.atleast_2d(np.asarray(X, dtype=float))
    if isinstance(random_state, np.random.RandomState):
        rs = random_state
    else:
        rs = np.random.RandomState(random_state)
    out = np.zeros((1, X.shape[0]))

    if isinstance(acq, FullGPAcquisition):
        if type(acq) is PVRS:
            n_thompson = kwargs.get("n_thompson", 10)
            seed = rs.randint(0, 2**31 - 1)  # = sample_y(random_state=rs)
            with_thompson = True
        elif type(acq) is VarianceReduction:
            n_thompson, seed, with_thompson = 0, 0, False
        else:
            return None  # custom FullGP acquisition: legacy path
        dt = gpr._dtype()
        Xw = jnp.asarray(gpr.warp(X), dtype=dt)
        vals_dev = aot_call(
            _fused_fullgp_vals,
            gpr._theta_device(dt),
            gpr._post,
            gpr._post_data,
            Xw,
            jax.random.PRNGKey(seed),
            kernel=gpr._spec,
            n_thompson=int(n_thompson),
            white_idx=gpr.white_index_,
            with_thompson=with_thompson,
        )

        def post_fullgp(vals):
            if np.all(np.isfinite(vals)):
                out[0] = vals
            return out

        if _defer:
            return vals_dev, (X.shape[0],), post_fullgp
        return post_fullgp(np.asarray(vals_dev))

    if not isinstance(acq, (UncertaintyAcquisition, SampleAcquisition)):
        return None
    if n_samples <= 0:
        return out
    try:
        kwargs_tuple = tuple(sorted(kwargs.items()))
        hash(kwargs_tuple)
    except TypeError:
        return None  # unhashable kwargs: legacy eager fallback path

    dt = gpr._dtype()
    idx = rs.choice(gpr._n_chain_rows(), replace=False, size=n_samples)
    rows = gpr._chain_rows_device(idx, dt)
    n_warp = gpr._X_orig.shape[1] if gpr.warp_inputs else 0
    key = jax.random.PRNGKey(rs.randint(0, 2**31 - 1))
    acq_keys = jax.random.split(
        jax.random.PRNGKey(rs.randint(0, 2**31 - 1)), n_samples
    )
    vals_dev = aot_call(
        _fused_marginal_vals,
        rows,
        gpr._data,
        jnp.asarray(X, dtype=dt),
        key,
        acq_keys,
        kernel=gpr._spec,
        n_warp=n_warp,
        white_idx=gpr.white_index_,
        need_sample=isinstance(acq, SampleAcquisition),
        acq=acq,
        kwargs_tuple=kwargs_tuple,
    )

    def post_marginal(vals):
        finite = np.all(np.isfinite(vals), axis=1)
        if finite.any():
            out[0] += vals[finite].sum(axis=0) / n_samples
        return out

    if _defer:
        return vals_dev, (n_samples, X.shape[0]), post_marginal
    return post_marginal(np.asarray(vals_dev))


# ---------------------------------------------------------------------------
# Gradient-polished argmax (round 5; beyond-reference BO quality)
# ---------------------------------------------------------------------------
#
# The reference optimizes its acquisitions over a 500-point uniform
# random grid (bask/optimizer.py:353-376) — in 15-D that barely samples
# the space. bask-tpu's acquisitions are jnp-differentiable, so a few
# Adam steps from the top grid points refine the argmax at negligible
# device cost (the per-step work is k candidate predictions against the
# ALREADY-factorized posteriors). Supported: the pointwise
# mu/std acquisitions (EI/TTEI/mean/LCB) and PVRS/VR. Excluded: MES
# (its value at x depends on min-value samples fitted to the WHOLE
# grid) and TS (a fresh function draw per x is not a coherent surface;
# pathwise draws would fix this).


def _adam_ascent(value_fn, X0, n_steps, lr):
    """Best-tracking vmapped Adam ascent of ``value_fn`` over [0,1]^d.

    Returns ``(x_best, v_best)`` per start — never worse than the
    start's own value under the SAME program (comparisons across
    different MC draws would be biased)."""
    vg = jax.vmap(jax.value_and_grad(value_fn))

    def step(carry, t):
        x, m, v, xb, vb = carry
        val, g = vg(x)
        g = jnp.where(jnp.isfinite(g), g, 0.0)
        better = val > vb
        xb = jnp.where(better[:, None], x, xb)
        vb = jnp.maximum(jnp.where(jnp.isfinite(val), val, -jnp.inf), vb)
        m = 0.9 * m + 0.1 * g
        v2 = 0.999 * v + 0.001 * (g * g)
        mh = m / (1.0 - 0.9 ** (t + 1.0))
        vh = v2 / (1.0 - 0.999 ** (t + 1.0))
        x = jnp.clip(x + lr * mh / (jnp.sqrt(vh) + 1e-8), 0.0, 1.0)
        return (x, m, v2, xb, vb), None

    zeros = jnp.zeros_like(X0)
    neg = jnp.full((X0.shape[0],), -jnp.inf, X0.dtype)
    (x, _, _, xb, vb), _ = jax.lax.scan(
        step, (X0, zeros, zeros, X0, neg),
        jnp.arange(n_steps, dtype=X0.dtype),
    )
    val_f = jax.vmap(value_fn)(x)
    better = val_f > vb
    xb = jnp.where(better[:, None], x, xb)
    vb = jnp.maximum(jnp.where(jnp.isfinite(val_f), val_f, -jnp.inf), vb)
    return xb, vb


@partial(
    jax.jit,
    static_argnames=(
        "kernel", "n_thompson", "white_idx", "with_thompson", "has_warp",
        "n_steps", "lr",
    ),
)
def _polish_fullgp_vals(
    theta, post, data, X0, Xw_pool, la, lb, key, *,
    kernel, n_thompson, white_idx, with_thompson, has_warp, n_steps, lr,
):
    """Adam-polish the PVRS/VR score from ``X0`` (transformed space).

    The probe set is re-drawn inside this program (fresh Thompson seed
    for PVRS), so returned values are comparable only to each other —
    the caller must include the grid argmax among the starts.
    """
    if with_thompson:
        theta_nf = gpc.noise_free_theta(kernel, theta, white_idx)
        ts = gpc.sample_y(kernel, theta_nf, post, data, Xw_pool, key, n_thompson)
        P = Xw_pool[jnp.argmin(ts, axis=0)]
        P = jax.lax.optimization_barrier(P)
    else:
        P = Xw_pool

    def value(x):
        xw = wpm.warp(x[None], la, lb) if has_warp else x[None]
        return _variance_explained_body(kernel, theta, post, data, xw, P)[0]

    return _adam_ascent(value, X0, n_steps, lr)


@partial(
    jax.jit,
    static_argnames=(
        "kernel", "n_warp", "white_idx", "acq", "kwargs_tuple",
        "n_steps", "lr", "n_samples",
    ),
)
def _polish_marginal_vals(
    rows, data, X0, X_pool, *,
    kernel, n_warp, white_idx, acq, kwargs_tuple, n_steps, lr, n_samples,
):
    """Adam-polish a marginalized pointwise acquisition from ``X0``.

    The per-draw posteriors are factorized ONCE (the expensive part —
    the same batched-factorization cost as one grid pass); each ascent
    step then costs only k single-candidate predictions per draw.

    EI's ``y_opt = min(mu)`` and TTEI's best-point stats are
    grid-coupled quantities: they are FROZEN per draw from one pooled
    prediction pass over ``X_pool`` (the caller's candidate grid), so
    the ascent surface is the same surface the grid argmax saw — not a
    degenerate single-point recomputation (where min(mu) == mu(x)
    collapses EI to a pure-std ascent).
    """
    def mk(x):
        if n_warp:
            theta_gp, lax_, lbx = wpm.split_warp_params(x, n_warp)
            d_X = wpm.warp(data.X, lax_, lbx)
        else:
            theta_gp = x
            lax_ = lbx = jnp.zeros((0,), x.dtype)
            d_X = data.X
        d = data._replace(X=d_X)
        post, invs = gpc.posterior_and_invs(kernel, theta_gp, d)
        theta_nf = gpc.noise_free_theta(kernel, theta_gp, white_idx)
        return post, invs, theta_nf, lax_, lbx, d_X

    posts = jax.vmap(mk)(rows)
    posts = jax.lax.optimization_barrier(posts)
    kw = dict(kwargs_tuple)

    def _predict_at(post, invs, theta_nf, lax_, lbx, d_X, Xq):
        if n_warp:
            Xq = wpm.warp(Xq, lax_, lbx)
        return gpc.predict(
            kernel, theta_nf, post, data._replace(X=d_X), Xq,
            return_std=True, invs=invs,
        )

    # one pooled pass per draw to freeze the grid-coupled constants
    mu_pool, std_pool = jax.vmap(
        lambda *p: _predict_at(*p, X_pool)
    )(*posts)
    if isinstance(acq, (ExpectedImprovement, TopTwoEI)):
        y_opt_kw = kw.pop("y_opt", None)
        if y_opt_kw is None:
            y_opt_s = jnp.min(mu_pool, axis=1)  # (S,)
        else:
            y_opt_s = jnp.full((rows.shape[0],), y_opt_kw, X0.dtype)
    if isinstance(acq, TopTwoEI):
        def _pool_best(mu_p, std_p, yo):
            ok = std_p > 0
            safe = jnp.where(ok, std_p, 1.0)
            z = (yo - mu_p) / safe
            ei = jnp.where(ok, _ei_term(z) * safe, 0.0)
            i = jnp.argmax(ei)
            return mu_p[i], std_p[i]

        mu_b_s, std_b_s = jax.vmap(_pool_best)(mu_pool, std_pool, y_opt_s)

    def value(x):
        def per_draw(i, post, invs, theta_nf, lax_, lbx, d_X):
            mu, std = _predict_at(post, invs, theta_nf, lax_, lbx, d_X, x[None])
            mu, std = mu[0], std[0]
            if isinstance(acq, TopTwoEI):
                ok = std > 0
                outer = jnp.sqrt(std**2 + std_b_s[i] ** 2)
                safe_outer = jnp.where(ok, outer, 1.0)
                z = (mu_b_s[i] - mu) / safe_outer
                return jnp.where(ok, safe_outer * _ei_term(z), 0.0)
            if isinstance(acq, ExpectedImprovement):
                ok = std > 0
                safe = jnp.where(ok, std, 1.0)
                z = (y_opt_s[i] - mu) / safe
                return jnp.where(ok, _ei_term(z) * safe, 0.0)
            return acq(mu[None], std[None], **kw)[0]

        vals = jax.vmap(per_draw)(jnp.arange(rows.shape[0]), *posts)
        finite = jnp.isfinite(vals)
        # same normalization as the grid dispatcher: finite draws
        # summed, divided by the TOTAL draw count
        return jnp.sum(jnp.where(finite, vals, 0.0)) / n_samples

    return _adam_ascent(value, X0, n_steps, lr)


def polish_noop_reason(acq, n_samples: int = 10, **kwargs):
    """Why :func:`polish_acquisition` would return ``None`` for this
    configuration, as a human-readable string — or ``None`` when polish
    is supported. Shared with the Optimizer's one-time no-op warning so
    the stated cause is always the real gate that fired."""
    if isinstance(acq, FullGPAcquisition):
        if type(acq) in (PVRS, VarianceReduction):
            return None
        return (
            f"custom FullGPAcquisition {type(acq).__name__} has no "
            "known differentiable surface (only PVRS/VarianceReduction "
            "are polished)"
        )
    if not isinstance(acq, UncertaintyAcquisition):
        return (
            f"{type(acq).__name__} is not an Uncertainty/FullGP "
            "acquisition; no pointwise surface to ascend"
        )
    if isinstance(acq, MaxValueSearch):
        return (
            "MES couples values to grid-wide min-value samples; no "
            "pointwise surface to ascend"
        )
    if n_samples <= 0:
        return (
            "n_samples=0 hyperposterior draws requested (pass "
            "n_samples>0 to tell/run so the marginalized surface "
            "exists)"
        )
    try:
        hash(tuple(sorted(kwargs.items())))
    except TypeError:
        return "unhashable acq_func_kwargs cannot key the jitted program"
    return None


def polish_acquisition(
    X0,
    gpr,
    acq,
    n_samples: int = 10,
    random_state=None,
    n_steps: int = 20,
    lr: float = 0.05,
    X_pool=None,
    **kwargs,
):
    """Gradient-ascent refinement of acquisition argmax candidates.

    ``X0``: (k, d) starts in TRANSFORMED space (include the grid argmax
    — values are comparable only within this program's own MC draws).
    Returns ``(X_polished, values)`` as host numpy, or ``None`` when the
    acquisition/configuration has no coherent differentiable surface
    (MES, TS, custom classes, unhashable kwargs) — the caller keeps the
    grid argmax. Improves on the reference's 500-point random-grid-only
    optimization (``bask/optimizer.py:353-376``).
    """
    if polish_noop_reason(acq, n_samples=n_samples, **kwargs) is not None:
        return None
    X0 = np.atleast_2d(np.asarray(X0, dtype=float))
    if isinstance(random_state, np.random.RandomState):
        rs = random_state
    else:
        rs = np.random.RandomState(random_state)
    dt = gpr._dtype()
    n_steps = int(n_steps)

    if isinstance(acq, FullGPAcquisition):
        if type(acq) is PVRS:
            n_thompson = kwargs.get("n_thompson", 10)
            with_thompson = True
        else:
            n_thompson, with_thompson = 0, False
        has_warp = bool(gpr.warp_inputs)
        if has_warp:
            la = jnp.asarray(gpr.warp_alphas_, dtype=dt)
            lb = jnp.asarray(gpr.warp_betas_, dtype=dt)
        else:
            la = lb = jnp.zeros((0,), dtype=dt)
        # probe pool: the caller's candidate grid when given (what the
        # fused PVRS pass drew its Thompson minimizers over), else the
        # starts plus random fill — any representative pool works
        if X_pool is None:
            X_pool = np.concatenate(
                [X0, rs.uniform(size=(256, X0.shape[1]))]
            )
        Xw_pool = jnp.asarray(gpr.warp(np.asarray(X_pool)), dtype=dt)
        xb, vb = aot_call(
            _polish_fullgp_vals,
            gpr._theta_device(dt),
            gpr._post,
            gpr._post_data,
            jnp.asarray(X0, dtype=dt),
            Xw_pool,
            la,
            lb,
            jax.random.PRNGKey(rs.randint(0, 2**31 - 1)),
            kernel=gpr._spec,
            n_thompson=int(n_thompson),
            white_idx=gpr.white_index_,
            with_thompson=with_thompson,
            has_warp=has_warp,
            n_steps=n_steps,
            lr=float(lr),
        )
        return np.asarray(xb), np.asarray(vb)

    # UncertaintyAcquisition path (the gates ran in polish_noop_reason,
    # so kwargs are hashable here)
    kwargs_tuple = tuple(sorted(kwargs.items()))
    idx = rs.choice(len(gpr.chain_), replace=False, size=n_samples)
    rows = jnp.asarray(gpr.chain_[idx], dtype=dt)
    n_warp = gpr._X_orig.shape[1] if gpr.warp_inputs else 0
    # pool for the grid-coupled constants (EI's y_opt, TTEI's best):
    # the caller's grid when given, else a fresh uniform pool
    if X_pool is None:
        X_pool = rs.uniform(size=(256, X0.shape[1]))
    xb, vb = aot_call(
        _polish_marginal_vals,
        rows,
        gpr._data,
        jnp.asarray(X0, dtype=dt),
        jnp.asarray(X_pool, dtype=dt),
        kernel=gpr._spec,
        n_warp=n_warp,
        white_idx=gpr.white_index_,
        acq=acq,
        kwargs_tuple=kwargs_tuple,
        n_steps=n_steps,
        lr=float(lr),
        n_samples=int(n_samples),
    )
    return np.asarray(xb), np.asarray(vb)


@partial(jax.jit, static_argnames=("acq", "kwargs_tuple"))
def _eval_uncertainty(acq, mu_s, std_s, keys, kwargs_tuple):
    """Jitted per-draw evaluation; acq instances are static (hash by id),
    so the compile caches across BO iterations. All acquisitions swallow
    unused kwargs, so the MES ``key`` can be passed uniformly."""
    kw = dict(kwargs_tuple)
    return jax.vmap(lambda m, s, k: acq(m, s, key=k, **kw))(
        mu_s, std_s, keys
    )


@partial(jax.jit, static_argnames=("acq", "kwargs_tuple"))
def _eval_sample(acq, samp_s, kwargs_tuple):
    kw = dict(kwargs_tuple)
    return jax.vmap(lambda s: acq(s, **kw))(samp_s)
