"""Geometric median (Weiszfeld) as a fixed-point ``lax.while_loop``.

The reference summarizes the MCMC hyperposterior with the geometric median
of the chain (``bask/bayesgpr.py:544``, ``bask/utils.py:21-65``, a Python
``while True`` loop). Here the iteration is branchless and jit-compatible
so the consensus theta can be computed on-device right after sampling
without a host round-trip.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from functools import partial

__all__ = ["geometric_median"]


@partial(jax.jit, static_argnames=("max_iter",))
def geometric_median(X, eps: float = 1e-5, max_iter: int = 200):
    """Point minimizing the sum of Euclidean distances to rows of X.

    Weiszfeld's algorithm with the Vardi-Zhang correction for iterates
    that coincide with a data point. Shape: (n, d) -> (d,).
    """
    X = jnp.asarray(X)
    y0 = jnp.mean(X, axis=0)

    def body(carry):
        y, _, it = carry
        d = jnp.linalg.norm(X - y[None, :], axis=1)
        nonzero = d > 0.0
        dinv = jnp.where(nonzero, 1.0 / jnp.where(nonzero, d, 1.0), 0.0)
        dinv_sum = jnp.sum(dinv)
        T = jnp.matmul(dinv, X, precision=jax.lax.Precision.HIGHEST) / dinv_sum
        num_zeros = X.shape[0] - jnp.sum(nonzero)
        # Vardi-Zhang step when y sits on >=1 data points
        R = (T - y) * dinv_sum
        r = jnp.linalg.norm(R)
        rinv = jnp.where(r > 0, num_zeros / jnp.where(r > 0, r, 1.0), 0.0)
        y_vz = (
            jnp.maximum(0.0, 1.0 - rinv) * T + jnp.minimum(1.0, rinv) * y
        )
        y1 = jnp.where(num_zeros == 0, T, y_vz)
        # all points identical to y -> stay
        y1 = jnp.where(num_zeros == X.shape[0], y, y1)
        delta = jnp.linalg.norm(y1 - y)
        return y1, delta, it + 1

    def cond(carry):
        _, delta, it = carry
        return jnp.logical_and(delta >= eps, it < max_iter)

    y, _, _ = jax.lax.while_loop(
        cond, body, (y0, jnp.asarray(jnp.inf, dtype=X.dtype), 0)
    )
    return y
