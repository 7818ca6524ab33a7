"""Masked/batched GP linear algebra (GPML Algorithm 2.1).

The reference computes one Cholesky + two triangular solves per
log-marginal-likelihood call, serially per MCMC walker (reference
``bask/bayesgpr.py:374``, sklearn GPR internals). Here every primitive is
written over a *padded* training set with a boolean mask so that

* shapes stay static while the BO loop grows the data (no recompiles —
  the data is padded to a bucket size), and
* a whole walker ensemble evaluates its LMLs in one batched call
  (``vmap`` over theta), which XLA maps onto batched Cholesky kernels.

Masking scheme: rows/columns of padded points are replaced by identity
rows, and the padded entries of ``y`` are zero. The Cholesky factor is then
block-diagonal with an identity block, contributing 0 to both the
log-determinant and the quadratic form, so the masked LML equals the LML of
the unpadded problem exactly.

A failed factorization (non-PD K) produces NaNs in the factor; those are
detected branchlessly and turned into ``-inf`` LML, matching the
reference's try/except ValueError -> -inf semantics
(``bask/bayesgpr.py:373-379``).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

__all__ = [
    "masked_gram",
    "masked_cholesky",
    "masked_lml",
    "cho_solve_masked",
    "augmented_quadform",
]

_LOG2PI = math.log(2.0 * math.pi)

# The matmul-only blocked Cholesky (see fast_cholesky.py) is the default
# float32 path for large padded grams: the forward solve is a few
# batched matmuls instead of a latency-bound batched substitution.
# float64 / small problems stay on the (bit-accurate vs LAPACK) XLA
# factorization. Whether the recursion or the library Cholesky is faster
# on the GPU is not measured yet.
# Override: "on" / "off" / "auto" (auto = on for f32 when shapes allow).
FAST_CHOLESKY = "auto"


def _use_fast_path(Kp) -> bool:
    if FAST_CHOLESKY == "off":
        return False
    n = Kp.shape[-1]
    # any 64-multiple (the padding-bucket granularity): block_cholesky
    # handles a ragged last panel, so 576/832/... qualify too
    shape_ok = n >= 128 and n % 64 == 0
    if FAST_CHOLESKY == "on":
        return shape_ok
    return shape_ok and Kp.dtype == jnp.float32


def masked_gram(kernel, theta, X, alpha_diag, mask):
    """Build K + diag(alpha) with identity rows for padded entries.

    Parameters
    ----------
    kernel : Kernel spec
    theta : (n_theta,) log-space hyperparameters
    X : (n_pad, d) padded training inputs
    alpha_diag : (n_pad,) per-point jitter/noise variance
    mask : (n_pad,) bool, True for real points
    """
    K = kernel.eval(theta, X)
    m2 = jnp.outer(mask, mask)
    Kp = jnp.where(m2, K, 0.0)
    diag = jnp.where(mask, jnp.diagonal(K) + alpha_diag, 1.0)
    return Kp - jnp.diag(jnp.diagonal(Kp)) + jnp.diag(diag)


def masked_cholesky(Kp):
    """Lower Cholesky of the masked gram. NaNs signal non-PD."""
    return jnp.linalg.cholesky(Kp)


def cho_solve_masked(L, B):
    """Solve K x = B given the (masked) lower factor L."""
    w = solve_triangular(L, B, lower=True)
    return solve_triangular(L.T, w, lower=False)


def masked_lml(kernel, theta, X, y, alpha_diag, mask):
    """Log marginal likelihood of the masked problem; -inf on failure.

    ``y`` must be zero at padded entries. Returns a scalar. Uses the
    single-forward-solve form  y^T K^-1 y = |L^-1 y|^2  (one triangular
    solve instead of the two a cho_solve would need — triangular solves
    are latency-bound).
    """
    Kp = masked_gram(kernel, theta, X, alpha_diag, mask)
    n = jnp.sum(mask)
    if _use_fast_path(Kp):
        from .fast_cholesky import fast_lml_terms

        _, logdiag, quad = fast_lml_terms(Kp, y)
        lml = -0.5 * quad - logdiag - 0.5 * n * _LOG2PI
        return jnp.where(jnp.isfinite(lml), lml, -jnp.inf)
    L = masked_cholesky(Kp)
    w = solve_triangular(L, y, lower=True)
    lml = (
        -0.5 * jnp.sum(w * w)  # elementwise, not a reduced-precision dot
        - jnp.sum(jnp.where(mask, jnp.log(jnp.diagonal(L)), 0.0))
        - 0.5 * n * _LOG2PI
    )
    return jnp.where(jnp.isfinite(lml), lml, -jnp.inf)


# Device-memory budget for one walker-batch of (chunk, n_pad, n_pad)
# grams: the factorization holds roughly gram + factor + block inverses
# + panel temps alive at once (~4x the gram bytes), so 2 GB of gram
# batch keeps the working set near 8 GB. Not measured on the H100 (80
# GB); retuning it is an open item. Large-n full ensembles (e.g.
# n=4096, W=100: 6.7 GB of grams alone) exceed it and are split into
# equal walker chunks inside a lax.map — identical per-walker results
# (each walker's gram/factorization/reductions are independent),
# graceful memory instead of an OOM. The north-star shape
# (100, 512, 512) is ~100 MB and never chunks.
LML_MAX_BATCH_BYTES = 2_000_000_000


def _lml_chunk_walkers(n_pad: int, itemsize: int, W: int) -> int:
    per_walker = n_pad * n_pad * itemsize
    return max(1, min(W, int(LML_MAX_BATCH_BYTES // per_walker)))


def _lml_batch_direct(kernel, thetas, X, y, alpha_diag, mask):
    """One unchunked walker batch: vmapped masked gram + factorization."""
    if X.ndim == 3:
        return jax.vmap(
            lambda t, Xi: masked_lml(kernel, t, Xi, y, alpha_diag, mask)
        )(thetas, X)
    return jax.vmap(lambda t: masked_lml(kernel, t, X, y, alpha_diag, mask))(
        thetas
    )


def batched_lml(kernel, thetas, X, y, alpha_diag, mask, mesh=None):
    """LML for a batch of thetas: (W, n_theta) -> (W,).

    The per-walker masked grams and factorizations are vmapped, so XLA
    sees one batched gram and one batched factorization. ``X`` may be
    (n_pad, d) or per-walker (W, n_pad, d) (input warping).

    When the (W, n_pad, n_pad) gram batch would blow the memory budget
    (``LML_MAX_BATCH_BYTES``), the walker axis is processed in equal
    chunks inside a ``lax.map`` — bit-identical results, bounded memory.

    ``mesh``: optional single-axis ``jax.sharding.Mesh``. The whole
    per-walker pipeline (gram -> factorization -> LML reduction) is then
    wrapped in ``shard_map`` over the walker axis: each device factorizes
    its LOCAL walker shard, with no cross-device traffic (no
    cross-walker reductions exist), and the memory chunk budget
    naturally applies to the per-device shard. The mesh size should
    divide the walker count for even shards (``BayesGPR.sample(mesh=)`` rounds the
    ensemble to multiples of 2x the device count; shard_map tolerates
    uneven shards by padding, but even shards keep every device busy).
    """
    if mesh is not None:
        from jax.sharding import PartitionSpec as P

        ax = mesh.axis_names[0]
        xspec = P(ax, None, None) if X.ndim == 3 else P(None, None)
        fn = jax.shard_map(
            partial(_batched_lml_impl, kernel),
            mesh=mesh,
            in_specs=(P(ax, None), xspec, P(None), P(None), P(None)),
            out_specs=P(ax),
        )
        return fn(thetas, X, y, alpha_diag, mask)
    return _batched_lml_impl(kernel, thetas, X, y, alpha_diag, mask)


def _batched_lml_impl(kernel, thetas, X, y, alpha_diag, mask):
    n_pad = X.shape[-2]
    W, D = thetas.shape
    chunk = _lml_chunk_walkers(n_pad, X.dtype.itemsize, W)
    if chunk >= W:
        return _lml_batch_direct(kernel, thetas, X, y, alpha_diag, mask)

    k = -(-W // chunk)
    pad = k * chunk - W
    if pad:
        thetas = jnp.concatenate(
            [thetas, jnp.broadcast_to(thetas[:1], (pad, D))]
        )
    thetas_c = thetas.reshape(k, chunk, D)
    if X.ndim == 3:
        Xw = X
        if pad:
            Xw = jnp.concatenate(
                [Xw, jnp.broadcast_to(Xw[:1], (pad,) + Xw.shape[1:])]
            )
        Xc = Xw.reshape((k, chunk) + Xw.shape[1:])

        out = jax.lax.map(
            lambda args: _lml_batch_direct(
                kernel, args[0], args[1], y, alpha_diag, mask
            ),
            (thetas_c, Xc),
        )
    else:
        out = jax.lax.map(
            lambda t: _lml_batch_direct(kernel, t, X, y, alpha_diag, mask),
            thetas_c,
        )
    return out.reshape(-1)[:W]


def augmented_quadform(L, l_cand, d_cand, A_sol, b):
    """Batched quadratic forms against rank-1-augmented Cholesky factors.

    For each candidate ``c`` the (n+1)x(n+1) augmented kernel matrix

        K_aug(c) = [[K, k_c], [k_c^T, k_cc]]

    has lower factor [[L, 0], [l_c^T, d_c]] with ``l_c = L^{-1} k_c`` and
    ``d_c = sqrt(k_cc - |l_c|^2)``. The predictive-variance-reduction
    acquisitions (reference ``bask/acquisition.py:277-339``) need, for m
    probe points with cross-kernel rows ``[A_p, b_cp]``,

        q_cp = [A_p, b_cp] K_aug(c)^{-1} [A_p, b_cp]^T
             = |L^{-1} A_p^T|^2 + ((b_cp - l_c . (L^{-1}A^T)_p) / d_c)^2.

    The reference loops a fresh O(n^3) Cholesky per candidate; this closed
    form needs only the shared factor ``L`` and matmuls, so all candidates
    evaluate in one fused pass.

    Parameters
    ----------
    L : (n, n) lower factor of the base K
    l_cand : (n, C) = L^{-1} k(X_train, X_cand)
    d_cand : (C,) augmented pivots
    A_sol : (n, m) = L^{-1} k(X_train, P)^T for the m probe points
    b : (m, C) cross kernel k(P, X_cand)

    Returns
    -------
    (C,) summed quadratic forms  sum_p q_cp  per candidate.
    """
    base = jnp.sum(A_sol * A_sol)  # sum_p |L^{-1} A_p^T|^2
    # (m, C): b_cp - (A_sol^T l_cand)_pc — near-cancelling difference
    # then divided by d_cand: full f32 precision required (a TF32
    # product keeps ~3 digits)
    resid = b - jnp.matmul(
        A_sol.T, l_cand, precision=jax.lax.Precision.HIGHEST
    )
    extra = jnp.sum((resid / d_cand[None, :]) ** 2, axis=0)
    return base + extra
