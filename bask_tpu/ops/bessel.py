"""On-device modified Bessel K_nu for general real order.

On-device replacement for the host scipy callback behind general-nu
Matern kernels (the reference supports any nu through sklearn's Matern,
reference ``bask/utils.py:100-124``): a host callback per chain step is
slow, and some backends reject callbacks, so reference-parity general-nu
models evaluate in pure XLA ops.

Algorithm: the standard two-regime scheme for fractional-order K —
Temme's series for x <= 2 and Steed's continued fraction (CF2) for
x > 2 (Temme, J. Comput. Phys. 19 (1975) 324; the classic treatment of
Bessel functions of fractional order) — on the decomposition
nu = mu + n with |mu| <= 1/2, followed by the *stable* upward
recurrence K_{v+1} = K_{v-1} + (2v/x) K_v. The order ``nu`` is a static
Python float (it lives on the immutable kernel spec), so all
order-dependent constants fold at trace time and the recurrence unrolls;
both iterative regimes run a fixed iteration count with
convergence-frozen (branchless) updates, so the evaluation jits, vmaps,
grads and shards like any other elementwise op.

Everything is exp-scaled (``kve(v, x) = e^x K_v(x)``, scipy's ``kve``),
which stays representable over the whole Matern operating range; callers
assemble final values fully in log space. Accumulation happens in
float64 when x64 is enabled (the CPU parity path); on f32-only backends
the same code runs at f32 accuracy.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

__all__ = ["kve", "log_kve"]

_EULER_GAMMA = 0.5772156649015329
# odd-order Taylor coefficients of 1/Gamma(1+t) (A&S 6.1.34 c4/c6): the
# direct (1/G(1-mu) - 1/G(1+mu))/(2mu) formula cancels for tiny mu
_C4 = -0.04200263503409524
_C6 = -0.042197734555544306

_TEMME_ITERS = 64
_CF2_ITERS = 240


def _gam12(mu: float):
    """Temme's Gamma1/Gamma2 auxiliary functions of the fractional order.

    gam1 = [1/G(1-mu) - 1/G(1+mu)] / (2 mu),  gam2 = [...] / 2, |mu|<=1/2.
    Python scalars (mu is static).
    """
    gp = 1.0 / math.gamma(1.0 + mu)
    gm = 1.0 / math.gamma(1.0 - mu)
    if abs(mu) < 1e-2:
        gam1 = -(_EULER_GAMMA + _C4 * mu * mu + _C6 * mu**4)
    else:
        gam1 = (gm - gp) / (2.0 * mu)
    return gam1, (gm + gp) / 2.0


def _kve_temme(mu: float, x):
    """(kve_mu, kve_{mu+1}) for 0 < x <= 2, |mu| <= 1/2 (Temme series)."""
    dt = x.dtype
    gam1, gam2 = _gam12(mu)
    gamma_pl = math.gamma(1.0 + mu)
    gamma_mi = math.gamma(1.0 - mu)
    # pi*mu / sin(pi*mu), exact 1 at mu=0
    fact = 1.0 if mu == 0.0 else math.pi * mu / math.sin(math.pi * mu)

    d = -jnp.log(0.5 * x)
    e = mu * d
    # sinh(e)/e with a series switch at tiny e
    fact2 = jnp.where(
        jnp.abs(e) < 1e-4,
        1.0 + e * e / 6.0,
        jnp.sinh(e) / jnp.where(jnp.abs(e) < 1e-4, 1.0, e),
    )
    ff = fact * (gam1 * jnp.cosh(e) + gam2 * fact2 * d)
    ssum = ff
    # e^e = (x/2)^{-mu}: Temme's p0 = (1/2)(x/2)^{-mu} Gamma(1+mu),
    # q0 = (1/2)(x/2)^{+mu} Gamma(1-mu)
    ee = jnp.exp(e)
    p = 0.5 * ee * gamma_pl
    q = 0.5 / ee * gamma_mi
    c = jnp.ones_like(x)
    d2 = 0.25 * x * x
    sum1 = p
    mu2 = mu * mu
    for i in range(1, _TEMME_ITERS + 1):
        ff = (i * ff + p + q) / (i * i - mu2)
        c = c * d2 / i
        p = p / (i - mu)
        q = q / (i + mu)
        ssum = ssum + c * ff
        sum1 = sum1 + c * (p - i * ff)
    scale = jnp.exp(x).astype(dt)
    return ssum * scale, (sum1 * 2.0 / x) * scale


def _kve_cf2(mu: float, x):
    """(kve_mu, kve_{mu+1}) for x >= 2, |mu| <= 1/2 (Steed's CF2).

    Fixed iteration count with convergence-frozen updates: once
    |delta_s / s| drops below machine precision a lane stops updating,
    which both preserves the converged value and keeps the auxiliary
    q-recursion from wandering over the remaining iterations.
    """
    dt = x.dtype
    eps = 1e-16 if dt == jnp.float64 else 1e-7
    mu2 = mu * mu
    a1 = 0.25 - mu2

    b = 2.0 * (1.0 + x)
    d = 1.0 / b
    h = d
    delh = d
    q1 = jnp.zeros_like(x)
    q2 = jnp.ones_like(x)
    q = jnp.full_like(x, a1)
    c = jnp.full_like(x, a1)
    a = jnp.full_like(x, -a1)
    s = 1.0 + q * delh
    done = jnp.zeros_like(x, dtype=bool)

    def body(i, carry):
        a, b, c, d, h, delh, q, q1, q2, s, done = carry
        ii = i.astype(x.dtype)
        a_n = a - 2.0 * (ii - 1.0)
        c_n = -a_n * c / ii
        qnew = (q1 - b * q2) / a_n
        q_n = q + c_n * qnew
        b_n = b + 2.0
        d_n = 1.0 / (b_n + a_n * d)
        delh_n = (b_n * d_n - 1.0) * delh
        h_n = h + delh_n
        dels = q_n * delh_n
        s_n = s + dels
        done_n = done | (jnp.abs(dels / s_n) < eps)
        keep = lambda new, old: jnp.where(done, old, new)  # noqa: E731
        return (
            keep(a_n, a), keep(b_n, b), keep(c_n, c), keep(d_n, d),
            keep(h_n, h), keep(delh_n, delh), keep(q_n, q),
            keep(q2, q1), keep(qnew, q2), keep(s_n, s), done_n,
        )

    a, b, c, d, h, delh, q, q1, q2, s, done = jax.lax.fori_loop(
        2, _CF2_ITERS + 2, body,
        (a, b, c, d, h, delh, q, q1, q2, s, done),
    )
    h = a1 * h
    # scaled: kve_mu = sqrt(pi/(2x)) / s   (the e^{-x} is dropped)
    kmu = jnp.sqrt(math.pi / 2.0 / x) / s
    kmu1 = kmu * (mu + x + 0.5 - h) / x
    return kmu, kmu1


def kve(nu: float, x):
    """Exponentially scaled modified Bessel K: ``e^x K_nu(x)``, x > 0.

    ``nu`` is a static Python float (any real; K is even in its order).
    Accuracy ~1e-13 relative in float64 over the Matern operating range;
    overflow at (tiny x, large nu) yields inf, which callers map to the
    analytic r->0 kernel limit.
    """
    nu = abs(float(nu))
    n = int(nu + 0.5)
    mu = nu - n  # |mu| <= 1/2

    xt = jnp.minimum(x, 2.0)  # safe input for the series regime
    xc = jnp.maximum(x, 2.0)  # safe input for the CF2 regime
    kmu_t, kmu1_t = _kve_temme(mu, xt)
    kmu_c, kmu1_c = _kve_cf2(mu, xc)
    small = x <= 2.0
    kmu = jnp.where(small, kmu_t, kmu_c)
    kmu1 = jnp.where(small, kmu1_t, kmu1_c)

    # stable upward recurrence to order nu = mu + n (unrolled: n static)
    xi2 = 2.0 / x
    for i in range(1, n + 1):
        kmu, kmu1 = kmu1, (mu + i) * xi2 * kmu1 + kmu
    return kmu


def log_kve(nu: float, x):
    """log(e^x K_nu(x)); inf at the (tiny x, large nu) overflow corner."""
    return jnp.log(kve(nu, x))
