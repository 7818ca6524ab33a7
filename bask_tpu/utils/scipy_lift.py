"""Lift frozen ``scipy.stats`` log-densities into traceable jnp code.

The reference accepts arbitrary callables as hyperparameter priors
(``/root/reference/bask/bayesgpr.py:368-372``); its tutorials build them
from ``scipy.stats``. bask-tpu runs the whole MCMC chain in one jitted
program, so a SciPy callable normally rides a ``jax.pure_callback`` host
adapter — a host round-trip per chain step, and dead on backends that
reject callbacks.

This module recognizes the directly-liftable case: the prior *is* a
frozen scipy distribution's ``logpdf``/``pdf`` bound method (or the
distribution family's, with default loc/scale), e.g.::

    priors = [halfnorm(scale=2).logpdf, norm(-1.0, 0.5).logpdf, ...]

and returns an exact jnp reimplementation of the same density, so the
chain stays fully on device. Every lift is verified numerically against
the SciPy callable at probe points (via a NumPy instantiation of the
same formula — no device execution at lift time) before being trusted;
any surprise (unknown family, parse failure, value mismatch) returns
``None`` and the caller falls back to the host-callback path. Lambdas
that *wrap* scipy calls are opaque to introspection and keep using the
callback adapter.

Support-boundary note: outside-support inputs map to ``-inf`` exactly
like scipy; *on* a closed boundary point (e.g. ``uniform`` at ``loc``,
``beta`` at 0/1 with unit shape) values may differ at that measure-zero
point — irrelevant for continuous MCMC.
"""

import math

import numpy as np
from scipy.special import betaln as _h_betaln
from scipy.special import gammaln as _h_gammaln

__all__ = ["lift_scipy_prior", "tabulate_prior"]

_SQRT2PI_LOG = 0.5 * math.log(2.0 * math.pi)


def _norm(shapes, loc, scale, xp):
    def logpdf(x):
        y = (x - loc) / scale
        return -0.5 * y * y - _SQRT2PI_LOG - math.log(scale)

    return logpdf


def _halfnorm(shapes, loc, scale, xp):
    const = 0.5 * math.log(2.0 / math.pi) - math.log(scale)

    def logpdf(x):
        y = (x - loc) / scale
        return xp.where(y >= 0, const - 0.5 * y * y, -xp.inf)

    return logpdf


def _uniform(shapes, loc, scale, xp):
    def logpdf(x):
        inside = (x >= loc) & (x <= loc + scale)
        return xp.where(inside, -math.log(scale), -xp.inf)

    return logpdf


def _expon(shapes, loc, scale, xp):
    def logpdf(x):
        y = (x - loc) / scale
        return xp.where(y >= 0, -y - math.log(scale), -xp.inf)

    return logpdf


def _gamma(shapes, loc, scale, xp):
    (a,) = shapes
    const = -float(_h_gammaln(a)) - math.log(scale)

    def logpdf(x):
        y = (x - loc) / scale
        ysafe = xp.where(y > 0, y, 1.0)
        val = (a - 1.0) * xp.log(ysafe) - ysafe + const
        return xp.where(y > 0, val, -xp.inf)

    return logpdf


def _invgamma(shapes, loc, scale, xp):
    (a,) = shapes
    const = -float(_h_gammaln(a)) - math.log(scale)

    def logpdf(x):
        y = (x - loc) / scale
        ysafe = xp.where(y > 0, y, 1.0)
        val = -(a + 1.0) * xp.log(ysafe) - 1.0 / ysafe + const
        return xp.where(y > 0, val, -xp.inf)

    return logpdf


def _lognorm(shapes, loc, scale, xp):
    (s,) = shapes
    const = -math.log(s) - _SQRT2PI_LOG - math.log(scale)

    def logpdf(x):
        y = (x - loc) / scale
        ysafe = xp.where(y > 0, y, 1.0)
        ly = xp.log(ysafe)
        val = -ly * ly / (2.0 * s * s) - ly + const
        return xp.where(y > 0, val, -xp.inf)

    return logpdf


def _beta(shapes, loc, scale, xp):
    a, b = shapes
    const = -float(_h_betaln(a, b)) - math.log(scale)

    def logpdf(x):
        y = (x - loc) / scale
        inside = (y > 0) & (y < 1)
        ysafe = xp.where(inside, y, 0.5)
        val = (
            (a - 1.0) * xp.log(ysafe)
            + (b - 1.0) * xp.log1p(-ysafe)
            + const
        )
        return xp.where(inside, val, -xp.inf)

    return logpdf


def _cauchy(shapes, loc, scale, xp):
    const = -math.log(math.pi) - math.log(scale)

    def logpdf(x):
        y = (x - loc) / scale
        return -xp.log1p(y * y) + const

    return logpdf


def _laplace(shapes, loc, scale, xp):
    const = -math.log(2.0) - math.log(scale)

    def logpdf(x):
        y = (x - loc) / scale
        return -xp.abs(y) + const

    return logpdf


def _logistic(shapes, loc, scale, xp):
    def logpdf(x):
        y = (x - loc) / scale
        ay = xp.abs(y)
        return -ay - 2.0 * xp.log1p(xp.exp(-ay)) - math.log(scale)

    return logpdf


def _t(shapes, loc, scale, xp):
    (df,) = shapes
    const = (
        float(_h_gammaln(0.5 * (df + 1.0)) - _h_gammaln(0.5 * df))
        - 0.5 * math.log(df * math.pi)
        - math.log(scale)
    )

    def logpdf(x):
        y = (x - loc) / scale
        return const - 0.5 * (df + 1.0) * xp.log1p(y * y / df)

    return logpdf


def _chi2(shapes, loc, scale, xp):
    (df,) = shapes
    const = (
        -float(_h_gammaln(0.5 * df))
        - 0.5 * df * math.log(2.0)
        - math.log(scale)
    )

    def logpdf(x):
        y = (x - loc) / scale
        ysafe = xp.where(y > 0, y, 1.0)
        val = (0.5 * df - 1.0) * xp.log(ysafe) - 0.5 * ysafe + const
        return xp.where(y > 0, val, -xp.inf)

    return logpdf


def _rayleigh(shapes, loc, scale, xp):
    def logpdf(x):
        y = (x - loc) / scale
        ysafe = xp.where(y > 0, y, 1.0)
        val = xp.log(ysafe) - 0.5 * ysafe * ysafe - math.log(scale)
        return xp.where(y > 0, val, -xp.inf)

    return logpdf


def _gumbel_r(shapes, loc, scale, xp):
    def logpdf(x):
        y = (x - loc) / scale
        return -y - xp.exp(-y) - math.log(scale)

    return logpdf


def _weibull_min(shapes, loc, scale, xp):
    (c,) = shapes
    const = math.log(c) - math.log(scale)

    def logpdf(x):
        y = (x - loc) / scale
        ysafe = xp.where(y > 0, y, 1.0)
        val = const + (c - 1.0) * xp.log(ysafe) - ysafe**c
        return xp.where(y > 0, val, -xp.inf)

    return logpdf


def _pareto(shapes, loc, scale, xp):
    (b,) = shapes
    const = math.log(b) - math.log(scale)

    def logpdf(x):
        y = (x - loc) / scale
        ysafe = xp.where(y >= 1, y, 1.0)
        val = const - (b + 1.0) * xp.log(ysafe)
        return xp.where(y >= 1, val, -xp.inf)

    return logpdf


# Verification-probe positions, as multiples of scale offset from loc.
# [loc, loc+scale] is inside the support of most families (uniform/beta
# are the tightest), so the default probes land in (loc, loc+scale).
# A family whose support does NOT cover that interval must carry its
# own multipliers — probing -inf against -inf verifies nothing (pareto's
# support only starts at loc+scale).
_DEFAULT_PROBES = (0.2, 0.5, 0.8)

# family → (builder, n_shape_params, probe multipliers)
_FAMILIES = {
    "norm": (_norm, 0, _DEFAULT_PROBES),
    "halfnorm": (_halfnorm, 0, _DEFAULT_PROBES),
    "uniform": (_uniform, 0, _DEFAULT_PROBES),
    "expon": (_expon, 0, _DEFAULT_PROBES),
    "gamma": (_gamma, 1, _DEFAULT_PROBES),
    "invgamma": (_invgamma, 1, _DEFAULT_PROBES),
    "lognorm": (_lognorm, 1, _DEFAULT_PROBES),
    "beta": (_beta, 2, _DEFAULT_PROBES),
    "cauchy": (_cauchy, 0, _DEFAULT_PROBES),
    "laplace": (_laplace, 0, _DEFAULT_PROBES),
    "logistic": (_logistic, 0, _DEFAULT_PROBES),
    "t": (_t, 1, _DEFAULT_PROBES),
    "chi2": (_chi2, 1, _DEFAULT_PROBES),
    "rayleigh": (_rayleigh, 0, _DEFAULT_PROBES),
    "gumbel_r": (_gumbel_r, 0, _DEFAULT_PROBES),
    "weibull_min": (_weibull_min, 1, _DEFAULT_PROBES),
    "pareto": (_pareto, 1, (1.2, 1.7, 2.5)),
}


# Log-densities below this are "effectively rejected" anyway (exp
# underflows long before); flooring -inf/NaN knots here keeps the
# interpolation finite while preserving MCMC rejection behavior.
_TABLE_FLOOR = -1e12


def tabulate_prior(p, lo, hi, n_knots=16385):
    """Approximate an opaque scalar log-density by on-device interpolation.

    Samples ``p`` on host over ``n_knots`` equispaced points of
    ``[lo, hi]`` and returns ``(interp, max_err)``: a traceable
    piecewise-linear interpolant (linearly extrapolated beyond the
    range using the edge segments' slopes) and the measured max
    absolute log-density error against ``p`` at segment midpoints.
    ``-inf``/NaN knots are floored to a very negative finite value so
    the interpolation stays finite (the chain still rejects there).

    This is the callback-free escape hatch for backends that reject
    host callbacks when a prior is an opaque
    callable (e.g. a lambda wrapping scipy) that cannot be lifted
    exactly. Approximate by construction — opt in via
    ``BayesGPR(host_prior_mode="interp")``.
    """
    lo, hi = float(lo), float(hi)
    if not (np.isfinite(lo) and np.isfinite(hi)):
        raise ValueError(
            f"tabulate_prior needs finite bounds, got [{lo}, {hi}] — "
            "infinite kernel bounds (e.g. fixed-less parameters) must be "
            "clamped by the caller"
        )
    if not (hi > lo) or n_knots < 3:
        raise ValueError("tabulate_prior needs hi > lo and n_knots >= 3")
    xs = np.linspace(lo, hi, n_knots)
    vec = np.vectorize(p, otypes=[np.float64])
    vals = vec(xs)
    vals = np.where(np.isnan(vals), -np.inf, vals)
    vals = np.maximum(vals, _TABLE_FLOOR)
    h = (hi - lo) / (n_knots - 1)

    # measured error at a midpoint subsample (the worst case for
    # piecewise-linear interpolation of a smooth function)
    mid_idx = np.linspace(0, n_knots - 2, min(512, n_knots - 1)).astype(int)
    mids = xs[mid_idx] + 0.5 * h
    exact = np.maximum(
        np.where(np.isnan(vec(mids)), -np.inf, vec(mids)), _TABLE_FLOOR
    )
    approx = 0.5 * (vals[mid_idx] + vals[mid_idx + 1])
    finite = np.isfinite(exact) & (exact > _TABLE_FLOOR / 2)
    max_err = float(np.max(np.abs(approx[finite] - exact[finite]))) if (
        finite.any()
    ) else 0.0

    def interp(x):
        import jax.numpy as jnp

        # table converted inside the trace (no device op at wrap time;
        # ~128 KB constant)
        table = jnp.asarray(vals, dtype=jnp.result_type(x, jnp.float32))
        t = (x - lo) / h
        i = jnp.clip(jnp.floor(t), 0, n_knots - 2).astype(jnp.int32)
        frac = t - i  # unbounded beyond the range: edge-slope extrapolation
        v0 = table[i]
        return v0 + frac * (table[i + 1] - v0)

    interp.__tabulated__ = (lo, hi, n_knots, max_err)
    return interp, max_err


def _resolve_dist(p):
    """Return ``(family, shapes, loc, scale, scipy_logpdf)`` for a
    recognized bound method, else ``None``."""
    name = getattr(p, "__name__", None)
    owner = getattr(p, "__self__", None)
    if owner is None or name not in ("logpdf", "pdf"):
        return None
    try:
        from scipy.stats._distn_infrastructure import (
            rv_continuous,
            rv_continuous_frozen,
        )
    except Exception:  # pragma: no cover - scipy always present here
        return None

    if isinstance(owner, rv_continuous_frozen):
        dist, args, kwds = owner.dist, owner.args, owner.kwds
    elif isinstance(owner, rv_continuous):
        dist, args, kwds = owner, (), {}
    else:
        return None
    family = getattr(dist, "name", None)
    if family not in _FAMILIES:
        return None
    try:
        shapes, loc, scale = dist._parse_args(*args, **kwds)
        shapes = tuple(float(s) for s in shapes)
        loc, scale = float(loc), float(scale)
    except Exception:
        return None  # array-valued params: elementwise priors are scalar
    if not (scale > 0.0 and np.isfinite(loc) and np.isfinite(scale)):
        return None
    if not all(np.isfinite(s) for s in shapes):
        return None
    # probe against the log-density regardless of whether the user
    # passed logpdf or pdf (owner.logpdf works for frozen AND unfrozen
    # owners; for unfrozen ones the defaults match the parsed args)
    return family, shapes, loc, scale, owner.logpdf


def lift_scipy_prior(p):
    """Return a jnp-traceable log-density equal to ``p``, or ``None``.

    ``p`` must be the ``logpdf`` (or ``pdf``) bound method of a frozen
    ``scipy.stats`` continuous distribution from a supported family.
    The lift is verified numerically against ``p`` at probe points
    inside the support (on host, in NumPy); on any mismatch it is
    rejected and the caller should fall back to the callback adapter.
    """
    resolved = _resolve_dist(p)
    if resolved is None:
        return None
    family, shapes, loc, scale, ref_logpdf = resolved
    builder, n_shapes, mults = _FAMILIES[family]
    if len(shapes) != n_shapes:
        return None
    try:
        logpdf_np = builder(shapes, loc, scale, np)
    except Exception:
        return None

    # Probe points inside the family's support (see _FAMILIES).
    probes = np.asarray([loc + t * scale for t in mults])
    try:
        got = np.asarray(logpdf_np(probes), dtype=np.float64)
        want = np.asarray(ref_logpdf(probes), dtype=np.float64)
    except Exception:
        return None
    if got.shape != want.shape or not np.allclose(
        got, want, rtol=1e-10, atol=1e-12
    ):
        return None

    import jax.numpy as jnp

    logpdf = builder(shapes, loc, scale, jnp)
    if p.__name__ == "pdf":
        base = logpdf

        def lifted(x):
            return jnp.exp(base(x))

    else:
        lifted = logpdf
    lifted.__wrapped_scipy__ = (family, shapes, loc, scale, p.__name__)
    return lifted
