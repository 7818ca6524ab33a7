"""Pallas kernel (Triton route): batched base-case Cholesky + inverse.

The blocked matmul Cholesky (:mod:`bask_tpu.ops.fast_cholesky`) reduces
every factorization to batched matmuls plus (batch, 32, 32) base cases,
and a (W, 512, 512) factorization chains 16 of them serially. The plain
base is XLA's batched Cholesky followed by a Newton–Schulz inverse:
several launches per base. This kernel computes the factor AND its
inverse of one small matrix per program, in registers, in ``m``
fully-unrolled right-looking steps of whole-tile operations; pivot
columns and rows are extracted by masked iota reductions.

Per step ``j`` (arrays (m, m)):

    d_j   = M[j, j]
    col   = M[:, j] * rsqrt(d_j), rows < j zeroed       (L[:, j] = col)
    row   = M[j, :] * rsqrt(d_j), cols < j zeroed       (M symmetric)
    M    -= col row                                     (Schur update)
    x_row = R[j, :] * rsqrt(d_j);  X[j, :] = x_row;  R -= tril(col, -1) x_row

with ``R`` starting as the identity (forward substitution of L X = I).
Non-PD inputs give ``rsqrt(negative) = NaN``, which propagates through
every later update — the branchless "failed factorization -> -inf
log-probability" contract (reference ``bask/bayesgpr.py:373-379``).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

__all__ = ["chol_inv_base"]


def _chol_inv_kernel(a_ref, l_ref, x_ref):
    M = a_ref[...]
    m = M.shape[0]
    ri = jax.lax.broadcasted_iota(jnp.int32, (m, m), 0)
    ci = jax.lax.broadcasted_iota(jnp.int32, (m, m), 1)
    zero = jnp.zeros((m, m), M.dtype)
    L = zero
    X = zero
    R = jnp.where(ri == ci, 1.0, zero)
    for j in range(m):
        rsel = ri == j
        csel = ci == j
        dj = jnp.sum(jnp.where(rsel & csel, M, 0.0))
        inv_s = jax.lax.rsqrt(dj)  # NaN on a non-PD pivot, by design
        dcol = jnp.sum(jnp.where(csel, M, 0.0), axis=1)[:, None]
        col = jnp.where(ri >= j, dcol * inv_s, 0.0)  # (m, m), constant rows
        L = jnp.where(csel, col, L)
        xrow = jnp.sum(jnp.where(rsel, R, 0.0), axis=0)[None, :] * inv_s
        X = jnp.where(rsel, xrow, X)
        if j + 1 < m:
            drow = jnp.sum(jnp.where(rsel, M, 0.0), axis=0)[None, :]
            row = jnp.where(ci >= j, drow * inv_s, 0.0)
            M = M - col * row
            R = R - jnp.where(ri > j, col, 0.0) * xrow
    l_ref[...] = L
    x_ref[...] = X


@partial(jax.jit, static_argnames=("interpret",))
def chol_inv_base(A, interpret: bool = False):
    """(L, L^-1) of a batch of small SPD float32 matrices.

    ``A``: (..., m, m). Any leading batch shape; ``m`` is padded to a
    power of two with an identity block (Triton block shapes are powers
    of two), which leaves the leading block's factor and inverse
    unchanged. ``interpret=True`` runs the Pallas interpreter (CPU
    tests); otherwise the kernel compiles for the GPU through Triton.
    """
    batch = A.shape[:-2]
    m = A.shape[-1]
    B = math.prod(batch)
    p = pl.next_power_of_2(m)
    A2 = A.reshape(B, m, m)
    if p != m:
        eye = jnp.broadcast_to(jnp.eye(p, dtype=A.dtype), (B, p, p))
        A2 = eye.at[:, :m, :m].set(A2)
    spec = pl.BlockSpec((None, p, p), lambda b: (b, 0, 0))
    L2, X2 = pl.pallas_call(
        _chol_inv_kernel,
        grid=(B,),
        in_specs=[spec],
        out_specs=[spec, spec],
        # vma: the outputs vary over the same mesh axes as the input
        # (needed under a checking ``shard_map``)
        out_shape=[jax.ShapeDtypeStruct((B, p, p), A.dtype,
                                        vma=jax.typeof(A2).vma)] * 2,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="chol_inv_base",
    )(A2)
    out_shape = batch + (m, m)
    return (
        L2[:, :m, :m].reshape(out_shape),
        X2[:, :m, :m].reshape(out_shape),
    )
