"""Matmul-only blocked Cholesky — the MCMC hot-path factorization.

A library Cholesky runs a column-sequential loop whose latency can
dominate the walker-batched LML at small n. This module reformulates the
batched factorization as *pure batched matmuls* plus a tiny base case:

* recursive 2x2 block Cholesky:  A = [[A11, .], [A21, A22]] ->
  L11 = chol(A11), L21 = A21 L11^-T, L22 = chol(A22 - L21 L21^T),
* the factor's inverse is assembled IN the same recursion — the
  sub-inverses the off-diagonal panel already needs give the parent via
  inv([[L11,0],[L21,L22]]) = [[inv11,0],[-inv22 (L21 inv11), inv22]],
  two matmuls per level (a separate whole-block Newton–Schulz inverse
  was the serial-op-count bottleneck),
* only the small base case (<= 32) is factorized directly: on the GPU
  in float32 by one Triton-route Pallas program per step that returns
  the factor and its inverse (``triton_chol_base.py``); elsewhere by
  XLA's cholesky plus a Newton–Schulz inverse (X <- X (2I - L X): the
  residual is nilpotent, so it is EXACT after ceil(log2(m))
  iterations).

Non-PD inputs surface as NaNs in a base-case factor and propagate
through every downstream matmul, preserving the branchless
"failed factorization -> -inf log-probability" semantics the MCMC
relies on (reference behavior: ``bask/bayesgpr.py:373-379``).

``block_forward_solve`` reuses the diagonal-block inverses to apply
L^-1 to a vector with a handful of batched small matmuls instead of a
latency-bound length-n triangular solve.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax import lax


def _mm(a, b):
    """Matmul at full f32 precision (a TF32 product keeps ~3 digits,
    which destroys LML accuracy)."""
    return jnp.matmul(a, b, precision=lax.Precision.HIGHEST)

__all__ = [
    "tri_newton_inv",
    "block_cholesky",
    "block_forward_solve",
    "block_solve_lower_mat",
    "block_solve_upper_mat",
    "fast_lml_terms",
]

_BASE = 32

# There is deliberately NO triangle-split trailing update: splitting
# the symmetric Schur update tail -= P P^T into T11/T21/T22 with the
# upper half mirrored saves 25% of the matmul flops per level but needs
# an explicit transpose-mirror and a concatenate that break the single
# fat full-rectangle GEMM. Not measured on the H100.

# Trailing-update matmul precision override (None = HIGHEST, full f32).
# At n>=4096 the factorization is dominated by the trailing Schur
# products P @ P^T; a reduced precision (e.g. lax.Precision.HIGH) trades
# an order of magnitude of reconstruction error for speed — a bad trade
# next to the LML, so it stays OFF. Not measured on the H100.
TRAILING_PRECISION = None


def tri_newton_inv(L, m: int | None = None):
    """Exact inverse of a lower-triangular (..., m, m) matrix.

    Newton–Schulz ``X <- X (2I - L X)`` from the diagonal seed; exact in
    ceil(log2(m)) iterations because the residual is nilpotent.
    """
    if m is None:
        m = L.shape[-1]
    iters = max(1, math.ceil(math.log2(m)))
    eye = jnp.eye(m, dtype=L.dtype)
    d = 1.0 / jnp.diagonal(L, axis1=-2, axis2=-1)
    X = eye * d[..., :, None]
    # Newton-Schulz is self-correcting: run the early contraction steps
    # at default matmul precision (TF32 on a GPU) and only the final two
    # at full f32 precision — the last exact iterations square away the
    # reduced-precision residual (|E| ~ 1e-3 -> 1e-6 -> f32 rounding).
    for it in range(iters):
        mm = _mm if it >= iters - 2 else jnp.matmul
        X = mm(X, 2.0 * eye - mm(L, X))
    # the iteration preserves lower-triangularity up to rounding; clamp it
    return jnp.tril(X)


def _xla_base_chol_inv(A):
    """(L, L^-1) of a batch of <= _BASE-sized blocks: XLA's batched
    Cholesky, then the Newton–Schulz inverse."""
    L = jnp.linalg.cholesky(A)
    return L, tri_newton_inv(L, A.shape[-1])


def _base_chol_inv(A):
    """(L, L^-1) of a batch of <= _BASE-sized blocks.

    On the GPU, float32 bases go to the Triton-route Pallas kernel
    (:mod:`bask_tpu.ops.triton_chol_base`): one launch per base step
    instead of a library Cholesky plus several Newton–Schulz matmuls, on
    the factorization's serial critical path. Everything else (CPU,
    float64) keeps the bit-stable XLA base."""
    if A.dtype == jnp.float32 and jax.default_backend() == "gpu":
        from .triton_chol_base import chol_inv_base

        return chol_inv_base(A)
    return _xla_base_chol_inv(A)


def _chol_inv_recursive(A):
    """(L, L^-1) built together: the sub-inverses the recursion already
    needs for the off-diagonal panel assemble the parent inverse with
    TWO extra matmuls via  inv([[L11,0],[L21,L22]]) =
    [[inv11, 0], [-inv22 (L21 inv11), inv22]]  — replacing the separate
    ceil(log2 n)-iteration Newton inverse of the full block (the
    factorization's serial-op-count bottleneck)."""
    n = A.shape[-1]
    if n <= _BASE:
        return _base_chol_inv(A)
    h = n // 2
    A11 = A[..., :h, :h]
    A21 = A[..., h:, :h]
    A22 = A[..., h:, h:]
    L11, inv11 = _chol_inv_recursive(A11)
    L21 = _mm(A21, jnp.swapaxes(inv11, -1, -2))
    S = A22 - _mm(L21, jnp.swapaxes(L21, -1, -2))
    L22, inv22 = _chol_inv_recursive(S)
    zeros = jnp.zeros_like(A[..., :h, h:])
    L = jnp.concatenate(
        [
            jnp.concatenate([L11, zeros], axis=-1),
            jnp.concatenate([L21, L22], axis=-1),
        ],
        axis=-2,
    )
    inv21 = -_mm(inv22, _mm(L21, inv11))
    inv = jnp.concatenate(
        [
            jnp.concatenate([inv11, zeros], axis=-1),
            jnp.concatenate([inv21, inv22], axis=-1),
        ],
        axis=-2,
    )
    return L, inv


def pick_nb(n: int) -> int:
    """Panel width: 128 up to n=512, 256 beyond.

    At large n the fat-panel matmuls dominate, so wider panels pay;
    at small n the narrower panel keeps the serial chain short. On an
    H100 the other width was slower at both (100, 512) and (8, 4096)
    (``benchmarks/bench_chol_variants.py``, variant ``blocked-nb-alt``);
    other sizes are not swept. ``n`` need not divide evenly: the last panel is
    ragged (the recursive kernel handles any size), so every
    64-multiple padding bucket gets fat panels.
    """
    return 256 if n > 512 else 128


def _panel_sizes(n: int, nb: int):
    sizes = []
    while n > 0:
        sizes.append(min(nb, n))
        n -= sizes[-1]
    return sizes


def _offsets(sizes):
    out, lo = [], 0
    for s in sizes:
        out.append((lo, lo + s))
        lo += s
    return out


def block_cholesky(A, nb: int | None = None):
    """Lower Cholesky of (..., n, n) via matmul-rich blocking.

    Returns ``(L, diag_invs)`` where ``diag_invs`` is the list of
    inverted diagonal blocks (the last may be ragged when ``nb`` does
    not divide ``n``), reusable by :func:`block_forward_solve` and the
    matrix-RHS solves, which re-derive the panel layout from the
    inverse shapes.
    """
    n = A.shape[-1]
    if nb is None:
        nb = pick_nb(n)
    if n <= nb:
        # whole matrix in one recursion
        L, L_inv = _chol_inv_recursive(A)
        return L, [L_inv]
    M = A
    cols = []
    invs = []
    for lo, hi in _offsets(_panel_sizes(n, nb)):
        D = M[..., lo:hi, lo:hi]
        Ld, Ld_inv = _chol_inv_recursive(D)
        invs.append(Ld_inv)
        below = M[..., hi:, lo:hi]
        P = _mm(below, jnp.swapaxes(Ld_inv, -1, -2))
        col = jnp.concatenate(
            [
                jnp.zeros_like(M[..., :lo, lo:hi]),
                Ld,
                P,
            ],
            axis=-2,
        )
        cols.append(col)
        if hi < n:
            mm_t = _mm if TRAILING_PRECISION is None else (
                lambda a, b: jnp.matmul(a, b, precision=TRAILING_PRECISION)
            )
            tail = M[..., hi:, hi:] - mm_t(P, jnp.swapaxes(P, -1, -2))
            # rebuild M with the updated trailing block only (slices of
            # the old M elsewhere are never read again)
            M = M.at[..., hi:, hi:].set(tail)
    return jnp.concatenate(cols, axis=-1), invs


def _layout_from_invs(invs):
    return _offsets([iv.shape[-1] for iv in invs])


# Vector forward-solve sweep policy: left-looking at <= this many
# panels (chain-LML shapes, see block_forward_solve), right-looking
# beyond (latency argument). Not tuned on the H100.
_FWD_LEFT_MAX_PANELS = 8


def block_forward_solve(L, invs, y, nb: int | None = None):
    """w = L^-1 y using the cached diagonal-block inverses.

    ``y``: (..., n). A handful of batched (nb x nb) matmuls instead of a
    sequential length-n substitution. The panel layout is derived from
    the inverse shapes (``nb`` is accepted for API compatibility).
    """
    n = L.shape[-1]
    if len(invs) == 1 and invs[0].shape[-1] == n:
        return (_mm(invs[0], y[..., None]))[..., 0]
    spans = _layout_from_invs(invs)
    if len(spans) <= _FWD_LEFT_MAX_PANELS:
        # LEFT-looking at few panels: the handful of tiny matvecs
        # avoids the right-looking form's trailing-slice bookkeeping.
        # Right-looking keeps the many-panel regime (T(T-1)/2 tiny
        # matvecs are latency-bound there).
        ws = []
        for j, (lo, hi) in enumerate(spans):
            rhs = y[..., lo:hi]
            for k, wk in enumerate(ws):
                klo, khi = spans[k]
                rhs = rhs - (_mm(L[..., lo:hi, klo:khi], wk[..., None]))[
                    ..., 0
                ]
            ws.append((_mm(invs[j], rhs[..., None]))[..., 0])
        return jnp.concatenate(ws, axis=-1)
    r = y
    ws = []
    for j, (lo, hi) in enumerate(spans):
        wj = (_mm(invs[j], r[..., : hi - lo, None]))[..., 0]
        ws.append(wj)
        if hi < n:
            r = r[..., hi - lo :] - (
                _mm(L[..., hi:, lo:hi], wj[..., None])
            )[..., 0]
    return jnp.concatenate(ws, axis=-1)


# The matrix-RHS solves below only apply inverses block_cholesky
# already produced; computing fresh Newton block inverses per call just
# for a solve costs more than XLA's substitution.

# All solves sweep RIGHT-LOOKING: each panel's solution updates the
# whole remaining right-hand side in one large trailing matmul (T big
# matmuls) instead of subtracting every previous panel's contribution
# per step (T(T-1)/2 small latency-bound matmuls).


def block_solve_lower_mat(L, invs, Y, nb: int | None = None, precision=None):
    """W = L^-1 Y with cached diagonal-block inverses; Y is (..., n, m).

    ``precision``: optional matmul precision override for this solve
    (default full-f32 HIGHEST: the solve feeds near-cancelling
    differences).
    """
    mm = _mm if precision is None else (
        lambda a, b: jnp.matmul(a, b, precision=precision)
    )
    n = L.shape[-1]
    if len(invs) == 1 and invs[0].shape[-1] == n:
        return mm(invs[0], Y)
    spans = _layout_from_invs(invs)
    # right-looking: one trailing update per panel on a shrinking
    # tail — the trapezoid's flops in T large matmuls
    R = Y
    ws = []
    for j, (lo, hi) in enumerate(spans):
        wj = mm(invs[j], R[..., : hi - lo, :])
        ws.append(wj)
        if hi < n:
            R = R[..., hi - lo :, :] - mm(L[..., hi:, lo:hi], wj)
    return jnp.concatenate(ws, axis=-2)


def block_solve_upper_mat(L, invs, Y, nb: int | None = None):
    """X = L^-T Y with cached diagonal-block inverses; Y is (..., n, m)."""
    n = L.shape[-1]
    if len(invs) == 1 and invs[0].shape[-1] == n:
        return _mm(jnp.swapaxes(invs[0], -1, -2), Y)
    spans = _layout_from_invs(invs)
    T = len(spans)
    # bottom-up right-looking: each solved panel updates the whole
    # remaining head in one (lo, nb)@(nb, m) matmul
    R = Y
    xs = [None] * T
    for j in range(T - 1, -1, -1):
        lo, hi = spans[j]
        xj = _mm(jnp.swapaxes(invs[j], -1, -2), R[..., lo:hi, :])
        xs[j] = xj
        if lo > 0:
            R = R[..., :lo, :] - _mm(
                jnp.swapaxes(L[..., lo:hi, :lo], -1, -2), xj
            )
    return jnp.concatenate(xs, axis=-2)


def fast_lml_terms(Kp, y, nb: int | None = None):
    """(log|K|/2 as sum log diag L, |L^-1 y|^2) via the fast factorization."""
    if nb is None:
        nb = pick_nb(Kp.shape[-1])
    L, invs = block_cholesky(Kp, nb=nb)
    w = block_forward_solve(L, invs, y, nb=nb)
    logdiag = jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)
    quad = jnp.sum(w * w, axis=-1)
    return L, logdiag, quad
