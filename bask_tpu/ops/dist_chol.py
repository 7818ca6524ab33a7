"""Row-sharded distributed Cholesky + log-marginal-likelihood.

Walker-axis sharding (``batched_lml(mesh=)``) scales the MCMC ensemble
across devices, but every device still materializes whole (n_pad,
n_pad) grams — past n≈46k a single f32 gram alone exceeds a 16 GB
chip. This module shards ONE factorization across the mesh by block
row: each device holds an (n_loc, n) strip of the masked gram (built
locally from the replicated (n, d) inputs — the full matrix never
exists anywhere), and a blocked right-looking Cholesky sweeps panels
with two collectives per step:

* a ``psum``-broadcast of the current (nb, nb) diagonal block and y
  block (owner contributes, everyone factorizes the tiny block
  redundantly — cheaper than shipping the factor), and
* an ``all_gather`` of the (n, nb) panel for the trailing Schur update
  (each device updates only its own strip: ``n³/P`` flops per device).

The forward solve ``L⁻¹y`` is interleaved with the factorization (the
y strip is updated like an extra trailing column), so the LML needs no
separate distributed triangular solve. On a multi-GPU host the
per-step all-gather rides NVLink; comm volume is O(n²) total against
O(n³/P) compute.

Masking follows :mod:`bask_tpu.ops.linalg` exactly (identity rows for
padded points, zero-padded ``y``): padded blocks factorize to identity
and contribute nothing, so the sharded LML equals the unpadded LML.
Non-PD grams produce NaNs that propagate to a ``-inf`` LML, matching
the reference's ValueError→-inf semantics
(``/root/reference/bask/bayesgpr.py:373-379``).

The reference has no distributed execution at all (single-process
NumPy, SURVEY §2 absent-rows); this is the scaling path for n beyond
one device's memory. The default ``fori_loop`` sweep's trailing
update computes the full (n_loc, n) rectangle each step (~2× the
trapezoid flops — the price of static shapes in a loop);
``unroll=True`` switches to a statically-indexed unrolled sweep that
updates only the true trapezoid, at the cost of one HLO step copy per
panel (use for moderate n/nb).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import solve_triangular
from jax.sharding import PartitionSpec as P

__all__ = [
    "row_sharded_lml",
    "row_sharded_lml_batch",
    "row_sharded_lml_value_grad",
    "row_sharded_predict",
    "row_sharded_sample_y",
    "walker_row_sharded_lml",
    "pick_row_nb",
]

_LOG2PI = math.log(2.0 * math.pi)


def pick_row_nb(n_loc: int, nb: int = 256) -> int:
    """Largest panel width ≤ ``nb`` that divides the local row count."""
    nb = min(nb, n_loc)
    while n_loc % nb:
        nb -= 1
    return nb


def _prep_row_mesh(mesh, n: int, nb: int, fname: str):
    """Shared entry validation: (axis name, mesh size, clamped nb).

    Accepts a 1-axis (rows) or 2-axis (walkers, rows) mesh; the LAST
    axis shards the rows. On a 2-axis mesh the single-theta sweeps run
    redundantly per walker group (replicated over the first axis) —
    the layout ``BayesGPR(row_mesh=...)`` uses so consensus/predict
    sweeps share the chain's mesh without re-meshing the devices.
    """
    if len(mesh.axis_names) not in (1, 2):
        raise ValueError(f"{fname} expects a 1- or 2-axis mesh")
    ax = mesh.axis_names[-1]
    P_sz = int(mesh.shape[ax])
    if n % P_sz:
        raise ValueError(
            f"n_pad={n} must be divisible by the row-axis size {P_sz}"
        )
    return ax, P_sz, pick_row_nb(n // P_sz, nb)


def _gram_strip(kernel, theta, X, X_loc, alpha_loc, mask, mask_loc,
                rows_g, cols_g):
    """One device's (n_loc, n) strip of the masked gram.

    Identity rows for padded points, ``kernel.diag + alpha`` on the true
    diagonal — the row-sharded image of ``ops.linalg``'s masked gram.
    Kept a standalone (theta-differentiable) function so the adjoint
    gradient can forward-mode it per hyperparameter.
    """
    Ks = kernel.eval(theta, X_loc, X)  # cross form: White contributes 0
    m2 = mask_loc[:, None] & mask[None, :]
    K_loc = jnp.where(m2, Ks, 0.0)
    diag_sel = cols_g[None, :] == rows_g[:, None]
    dvals = jnp.where(
        mask_loc, kernel.diag(theta, X_loc) + alpha_loc, 1.0
    )
    return jnp.where(diag_sel, dvals[:, None], K_loc)


def _sweep_strip(theta, X, Xq, y, alpha_diag, mask, *, kernel, ax,
                 P_sz, nb, theta_diag=None, with_outer=False,
                 with_grad=False, unroll=False):
    """One device's strip of the blocked distributed sweep.

    Factorizes the row-sharded masked gram while forward-solving
    ``L⁻¹ [y, k(X, Xq)]`` in the same pass (the right-hand sides update
    like extra trailing columns; the query cross-block is built locally
    per strip, so nothing O(n·m) is ever replicated-then-sharded).
    Returns the reductions every caller needs:
    ``(quad, logdet, dot, qnorm, qouter)`` with

    * ``quad``   = |L⁻¹y|²                         (the LML quadratic)
    * ``logdet`` = Σ log diag(L)
    * ``dot``    = (L⁻¹Kq)ᵀ (L⁻¹y)  per query      (predictive means)
    * ``qnorm``  = |L⁻¹Kq|² per query              (predictive variances)

    ``Xq``: (m, d) query inputs or ``None`` (LML only). ``theta_diag``
    optionally evaluates the query cross-block with a different theta
    (noise-free prediction; White contributes 0 on cross blocks so the
    values coincide for White-only differences). ``with_outer``
    additionally accumulates ``qouter = (L⁻¹Kq)ᵀ(L⁻¹Kq)`` (m, m) for
    predictive covariances. All returned values are bit-identical
    across devices (built from psum'd blocks).

    ``with_grad`` additionally forward-solves the query-gradient
    cross-blocks ``∂k(X, x_j)/∂x_j`` as ``m·d`` extra trailing columns
    of the SAME sweep (the factor does not depend on ``Xq``, so the
    gradients of the predictive mean/variance are linear solves against
    it — no second factorization, no stored factor) and accumulates

    * ``dotg``   = (L⁻¹∂Kq)ᵀ(L⁻¹y)   per query, (m, d)  (mean grads)
    * ``qcross`` = Σ (L⁻¹Kq)·(L⁻¹∂Kq) per query, (m, d)  (var grads)

    ``unroll=True`` replaces the ``fori_loop`` with a Python-unrolled
    sweep whose panel indices are static: the block owner and its local
    offset become compile-time constants (static slicing instead of
    dynamic_slice) and — the point — the trailing Schur update touches
    only the remaining ``n − row0 − nb`` columns instead of computing
    the full (n_loc, n) rectangle and masking, halving the sweep's
    flops and its device-memory write traffic. Costs one HLO copy of the step
    per panel, so keep it for moderate step counts (n/nb ≲ 128);
    results match the loop path to float round-off.
    """
    n = X.shape[0]
    m = 0 if Xq is None else Xq.shape[0]
    n_loc = n // P_sz
    p = lax.axis_index(ax)
    r0 = p * n_loc

    # --- local strip of the masked gram (identity rows for padding) ---
    X_loc = lax.dynamic_slice_in_dim(X, r0, n_loc, 0)
    mask_loc = lax.dynamic_slice_in_dim(mask, r0, n_loc, 0)
    alpha_loc = lax.dynamic_slice_in_dim(alpha_diag, r0, n_loc, 0)
    y_loc = lax.dynamic_slice_in_dim(y, r0, n_loc, 0)
    dq = Xq.shape[1] if (m and with_grad) else 0
    if m:
        tq = theta if theta_diag is None else theta_diag
        Ksl = kernel.eval(tq, X_loc, Xq) * mask_loc[:, None]
        cols = [y_loc[:, None], Ksl]
        if with_grad:
            # (m, n_loc, d): jacobian of each query's cross column wrt
            # the query point — forward mode, d is small
            dK = jax.vmap(
                jax.jacfwd(
                    lambda x: kernel.eval(tq, X_loc, x[None, :])[:, 0]
                )
            )(Xq)
            dK = jnp.transpose(dK, (1, 0, 2)) * mask_loc[:, None, None]
            cols.append(dK.reshape(n_loc, m * dq))
        B_loc = jnp.concatenate(cols, axis=1)
    else:
        B_loc = y_loc[:, None]  # (n_loc, 1+m+m*dq)
    wB = B_loc.shape[1]

    rows_g = r0 + jnp.arange(n_loc)
    cols_g = jnp.arange(n)

    K_loc = _gram_strip(
        kernel, theta, X, X_loc, alpha_loc, mask, mask_loc, rows_g, cols_g
    )

    # --- blocked right-looking sweep, forward solves interleaved ---
    eye_nb = jnp.eye(nb, dtype=K_loc.dtype)
    steps = n // nb

    def step(k, carry):
        K_loc, B_loc, quad, logdet, dot, qnorm, qouter, dotg, qcross = carry
        # int32 throughout: axis_index is int32, the fori_loop counter
        # is int64 under x64 — dynamic_slice requires matching types
        row0 = (k * nb).astype(jnp.int32)
        owner = row0 // n_loc
        is_owner = p == owner
        loc0 = jnp.clip(row0 - r0, 0, n_loc - nb).astype(jnp.int32)

        Akk = lax.psum(
            jnp.where(
                is_owner,
                lax.dynamic_slice(K_loc, (loc0, row0), (nb, nb)),
                0.0,
            ),
            ax,
        )
        Bk = lax.psum(
            jnp.where(
                is_owner,
                lax.dynamic_slice(
                    B_loc, (loc0, jnp.int32(0)), (nb, wB)
                ),
                0.0,
            ),
            ax,
        )
        # tiny block: every device factorizes redundantly
        Lkk = jnp.linalg.cholesky(Akk)
        Zk = solve_triangular(Lkk, Bk, lower=True)  # (nb, 1+m)
        LinvT = solve_triangular(Lkk, eye_nb, lower=True).T

        # local panel rows strictly below the diagonal block
        Cl = lax.dynamic_slice(K_loc, (jnp.int32(0), row0), (n_loc, nb))
        Pl = jnp.matmul(Cl, LinvT, precision=lax.Precision.HIGHEST)
        below = rows_g >= row0 + nb
        Pl = jnp.where(below[:, None], Pl, 0.0)

        P_full = lax.all_gather(Pl, ax, tiled=True)  # (n, nb)
        U = jnp.matmul(Pl, P_full.T, precision=lax.Precision.HIGHEST)
        colmask = cols_g >= row0 + nb
        K_loc = K_loc - U * colmask[None, :]
        # forward-solve update: precision-critical matmul (CLAUDE.md 5)
        B_loc = B_loc - jnp.matmul(
            Pl, Zk, precision=lax.Precision.HIGHEST
        )

        zy = Zk[:, 0]
        quad = quad + jnp.sum(zy * zy)  # elementwise, not a reduced-precision dot
        logdet = logdet + jnp.sum(jnp.log(jnp.diagonal(Lkk)))
        if m:
            Zq = Zk[:, 1:1 + m]
            dot = dot + jnp.sum(Zq * zy[:, None], axis=0)
            qnorm = qnorm + jnp.sum(Zq * Zq, axis=0)
            if with_outer:
                # near-cancelling against k(Xq,Xq) downstream: HIGHEST
                qouter = qouter + jnp.matmul(
                    Zq.T, Zq, precision=lax.Precision.HIGHEST
                )
            if dq:
                Zg = Zk[:, 1 + m:].reshape(nb, m, dq)
                dotg = dotg + jnp.sum(Zg * zy[:, None, None], axis=0)
                qcross = qcross + jnp.sum(Zq[:, :, None] * Zg, axis=0)
        return K_loc, B_loc, quad, logdet, dot, qnorm, qouter, dotg, qcross

    zero = jnp.zeros((), K_loc.dtype)
    zm = jnp.zeros((m,), K_loc.dtype)
    zmm = jnp.zeros((m, m) if with_outer else (0, 0), K_loc.dtype)
    zmd = jnp.zeros((m, dq) if dq else (0, 0), K_loc.dtype)

    if not unroll:
        _, _, quad, logdet, dot, qnorm, qouter, dotg, qcross = (
            lax.fori_loop(
                0, steps, step,
                (K_loc, B_loc, zero, zero, zm, zm, zmm, zmd, zmd),
            )
        )
        return quad, logdet, dot, qnorm, qouter, dotg, qcross

    # --- static-index unrolled sweep: trapezoid-only trailing update ---
    quad, logdet, dot, qnorm, qouter = zero, zero, zm, zm, zmm
    dotg, qcross = zmd, zmd
    for k in range(steps):
        row0 = k * nb  # static
        owner = row0 // n_loc  # static: strips are contiguous blocks
        loc0 = row0 - owner * n_loc  # static local offset on the owner
        is_owner = p == owner

        Akk = lax.psum(
            jnp.where(
                is_owner,
                K_loc[loc0:loc0 + nb, row0:row0 + nb],
                0.0,
            ),
            ax,
        )
        Bk = lax.psum(
            jnp.where(is_owner, B_loc[loc0:loc0 + nb, :], 0.0), ax
        )
        Lkk = jnp.linalg.cholesky(Akk)
        Zk = solve_triangular(Lkk, Bk, lower=True)
        LinvT = solve_triangular(Lkk, eye_nb, lower=True).T

        Pl = jnp.matmul(
            K_loc[:, row0:row0 + nb], LinvT,
            precision=lax.Precision.HIGHEST,
        )
        below = rows_g >= row0 + nb
        Pl = jnp.where(below[:, None], Pl, 0.0)

        P_full = lax.all_gather(Pl, ax, tiled=True)  # (n, nb)
        w = n - row0 - nb  # static trailing width
        if w:
            Ut = jnp.matmul(
                Pl, P_full[row0 + nb:, :].T,
                precision=lax.Precision.HIGHEST,
            )  # (n_loc, w): the trapezoid only
            K_loc = K_loc.at[:, row0 + nb:].add(-Ut)
        B_loc = B_loc - jnp.matmul(
            Pl, Zk, precision=lax.Precision.HIGHEST
        )

        zy = Zk[:, 0]
        quad = quad + jnp.sum(zy * zy)
        logdet = logdet + jnp.sum(jnp.log(jnp.diagonal(Lkk)))
        if m:
            Zq = Zk[:, 1:1 + m]
            dot = dot + jnp.sum(Zq * zy[:, None], axis=0)
            qnorm = qnorm + jnp.sum(Zq * Zq, axis=0)
            if with_outer:
                qouter = qouter + jnp.matmul(
                    Zq.T, Zq, precision=lax.Precision.HIGHEST
                )
            if dq:
                Zg = Zk[:, 1 + m:].reshape(nb, m, dq)
                dotg = dotg + jnp.sum(Zg * zy[:, None, None], axis=0)
                qcross = qcross + jnp.sum(Zq[:, :, None] * Zg, axis=0)
    return quad, logdet, dot, qnorm, qouter, dotg, qcross


def _lml_strip_body(theta, X, y, alpha_diag, mask, *, kernel, ax, P_sz,
                    nb, unroll=False, n_warp=0):
    """shard_map body: masked LML from the distributed sweep.

    ``n_warp > 0`` makes ``theta`` a full MCMC row (kernel theta + warp
    log-alphas + log-betas): the Beta-CDF warp is applied to the
    replicated ``X`` INSIDE the body — the warp is elementwise, so each
    walker's warped inputs cost O(n·d) transient compute per evaluation
    and nothing persistent, which is what lets warped models run in
    row-sharded mode at all (a per-walker (W, n, d) warped-X batch is
    exactly the kind of replicated memory this module exists to avoid).
    """
    if n_warp:
        from ..models import warping as _wp

        theta, la, lb = _wp.split_warp_params(theta, n_warp)
        X = _wp.warp(X, la, lb)
    quad, logdet, _, _, _, _, _ = _sweep_strip(
        theta, X, None, y, alpha_diag, mask,
        kernel=kernel, ax=ax, P_sz=P_sz, nb=nb, unroll=unroll,
    )
    n_real = jnp.sum(mask)
    lml = -0.5 * quad - logdet - 0.5 * n_real * _LOG2PI
    return jnp.where(jnp.isfinite(lml), lml, -jnp.inf)


def row_sharded_lml(kernel, theta, X, y, alpha_diag, mask, mesh, nb=256,
                    unroll=False):
    """Masked LML of one theta with the gram row-sharded over ``mesh``.

    Parameters mirror :func:`bask_tpu.ops.linalg.masked_lml`; ``mesh``
    is a single-axis :class:`jax.sharding.Mesh` whose size divides
    ``n_pad``. ``nb`` is the panel width (clamped to a divisor of the
    local row count). Inputs are replicated (they are O(n·d)); the
    O(n²) gram only ever exists as per-device strips.
    """
    ax, P_sz, nb = _prep_row_mesh(mesh, X.shape[0], nb, "row_sharded_lml")
    body = partial(
        _lml_strip_body, kernel=kernel, ax=ax, P_sz=P_sz, nb=nb,
        unroll=unroll,
    )
    # check_vma=False: outputs are built from psum'd values and are
    # bit-identical across devices (same convention as batched_lml's
    # shard_map path).
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    return fn(theta, X, y, alpha_diag, mask)


def _adjoint_strip_body(theta, X, y, alpha_diag, mask, *, kernel, ax,
                        P_sz, nb):
    """shard_map body: masked LML + exact theta-gradient, one strip.

    Closed-form adjoint of GPML eq. 5.9:

        ∂LML/∂θᵢ = ½ αᵀ(∂K/∂θᵢ)α − ½ tr(K⁻¹ ∂K/∂θᵢ),   α = K⁻¹y

    assembled from THREE distributed passes whose cost is independent
    of the hyperparameter count D (the jvp fallback pays D primal+
    tangent sweeps):

    1. one factorization sweep that STORES the factor strip ``L_loc``
       and forward-solves ``L⁻¹[y, I]`` (the identity right-hand side
       rides the same panel updates, so ``L⁻¹`` comes out row-sharded
       for free),
    2. one distributed backward sweep ``Lᵀ[α, K⁻¹] = [L⁻¹y, L⁻¹]``
       (bottom-up over panels; each step one psum of the local
       contributions), giving α and the row-sharded ``K⁻¹`` strips,
    3. D cheap elementwise reductions: ``∂K/∂θᵢ`` strips from one jvp
       of the gram builder each (O(n²/P) work, no factorization),
       contracted against ``K⁻¹`` (trace term, symmetry of both sides
       makes the row-sharded elementwise product exact) and α
       (quadratic term).

    Peak memory is ~4 strips of (n_loc, n) — same O(n²/P) class as the
    plain sweep; reverse-mode autodiff through the sweep would need
    O(steps·n²/P) saved panels, which is exactly what this module
    exists to avoid.
    """
    n = X.shape[0]
    D = theta.shape[0]
    n_loc = n // P_sz
    p = lax.axis_index(ax)
    r0 = p * n_loc

    X_loc = lax.dynamic_slice_in_dim(X, r0, n_loc, 0)
    mask_loc = lax.dynamic_slice_in_dim(mask, r0, n_loc, 0)
    alpha_loc = lax.dynamic_slice_in_dim(alpha_diag, r0, n_loc, 0)
    y_loc = lax.dynamic_slice_in_dim(y, r0, n_loc, 0)
    rows_g = r0 + jnp.arange(n_loc)
    cols_g = jnp.arange(n)

    def gram_fn(t):
        return _gram_strip(
            kernel, t, X, X_loc, alpha_loc, mask, mask_loc, rows_g, cols_g
        )

    K_loc = gram_fn(theta)
    dt = K_loc.dtype
    # RHS [y, I-strip]: rows of the identity owned by this device
    I_loc = (cols_g[None, :] == rows_g[:, None]).astype(dt)
    B_loc = jnp.concatenate([y_loc[:, None], I_loc], axis=1)  # (n_loc, 1+n)
    L_loc = jnp.zeros_like(K_loc)
    Z_loc = jnp.zeros_like(B_loc)

    eye_nb = jnp.eye(nb, dtype=dt)
    steps = n // nb

    def fwd_step(k, carry):
        K_loc, B_loc, L_loc, Z_loc, logdet = carry
        row0 = (k * nb).astype(jnp.int32)
        owner = row0 // n_loc
        is_owner = p == owner
        loc0 = jnp.clip(row0 - r0, 0, n_loc - nb).astype(jnp.int32)

        Akk = lax.psum(
            jnp.where(
                is_owner,
                lax.dynamic_slice(K_loc, (loc0, row0), (nb, nb)),
                0.0,
            ),
            ax,
        )
        Bk = lax.psum(
            jnp.where(
                is_owner,
                lax.dynamic_slice(B_loc, (loc0, jnp.int32(0)), (nb, 1 + n)),
                0.0,
            ),
            ax,
        )
        Lkk = jnp.linalg.cholesky(Akk)
        Zk = solve_triangular(Lkk, Bk, lower=True)  # (nb, 1+n)
        LinvT = solve_triangular(Lkk, eye_nb, lower=True).T

        Cl = lax.dynamic_slice(K_loc, (jnp.int32(0), row0), (n_loc, nb))
        Pl = jnp.matmul(Cl, LinvT, precision=lax.Precision.HIGHEST)
        below = rows_g >= row0 + nb
        Pl = jnp.where(below[:, None], Pl, 0.0)

        # store the factor: sub-diagonal panel rows everywhere, the
        # little Cholesky block on its owner (panels never straddle
        # strips: nb divides n_loc)
        Lcol = jnp.where(
            is_owner,
            lax.dynamic_update_slice(Pl, Lkk, (loc0, jnp.int32(0))),
            Pl,
        )
        L_loc = lax.dynamic_update_slice(L_loc, Lcol, (jnp.int32(0), row0))
        Z_loc = jnp.where(
            is_owner,
            lax.dynamic_update_slice(Z_loc, Zk, (loc0, jnp.int32(0))),
            Z_loc,
        )

        P_full = lax.all_gather(Pl, ax, tiled=True)
        U = jnp.matmul(Pl, P_full.T, precision=lax.Precision.HIGHEST)
        colmask = cols_g >= row0 + nb
        K_loc = K_loc - U * colmask[None, :]
        B_loc = B_loc - jnp.matmul(
            Pl, Zk, precision=lax.Precision.HIGHEST
        )
        logdet = logdet + jnp.sum(jnp.log(jnp.diagonal(Lkk)))
        return K_loc, B_loc, L_loc, Z_loc, logdet

    zero = jnp.zeros((), dt)
    _, _, L_loc, Z_loc, logdet = lax.fori_loop(
        0, steps, fwd_step, (K_loc, B_loc, L_loc, Z_loc, zero)
    )
    # rows of Z are local now: |L⁻¹y|² is a psum of local squares
    quad = lax.psum(jnp.sum(Z_loc[:, 0] ** 2), ax)

    # --- backward sweep: Lᵀ S = Z  (S = [α, K⁻¹] row-sharded) ---------
    def bwd_step(i, S_loc):
        k = steps - 1 - i
        row0 = (k * nb).astype(jnp.int32)
        owner = row0 // n_loc
        is_owner = p == owner
        loc0 = jnp.clip(row0 - r0, 0, n_loc - nb).astype(jnp.int32)

        Lcol = lax.dynamic_slice(L_loc, (jnp.int32(0), row0), (n_loc, nb))
        solved = rows_g >= row0 + nb  # rows already back-solved
        contrib = lax.psum(
            jnp.matmul(
                (Lcol * solved[:, None]).T, S_loc,
                precision=lax.Precision.HIGHEST,
            ),
            ax,
        )  # (nb, 1+n)
        Vk = lax.psum(
            jnp.where(
                is_owner,
                lax.dynamic_slice(Z_loc, (loc0, jnp.int32(0)), (nb, 1 + n)),
                0.0,
            ),
            ax,
        )
        Lkk = lax.psum(
            jnp.where(
                is_owner,
                lax.dynamic_slice(L_loc, (loc0, row0), (nb, nb)),
                0.0,
            ),
            ax,
        )
        Sk = solve_triangular(Lkk.T, Vk - contrib, lower=False)
        return jnp.where(
            is_owner,
            lax.dynamic_update_slice(S_loc, Sk, (loc0, jnp.int32(0))),
            S_loc,
        )

    S_loc = lax.fori_loop(0, steps, bwd_step, jnp.zeros_like(Z_loc))
    alpha_vec_loc = S_loc[:, 0]  # α strip
    Kinv_loc = S_loc[:, 1:]  # K⁻¹ strip (n_loc, n)
    alpha_full = lax.all_gather(alpha_vec_loc, ax, tiled=True)  # (n,)

    # --- D elementwise contractions against ∂K/∂θᵢ strips -------------
    def one(i):
        tangent = jnp.zeros_like(theta).at[i].set(1.0)
        _, dK_loc = jax.jvp(gram_fn, (theta,), (tangent,))
        v = jnp.matmul(dK_loc, alpha_full, precision=lax.Precision.HIGHEST)
        quadform = lax.psum(jnp.sum(alpha_vec_loc * v), ax)
        tr = lax.psum(jnp.sum(Kinv_loc * dK_loc), ax)
        return 0.5 * quadform - 0.5 * tr

    grads = lax.map(one, jnp.arange(D))

    n_real = jnp.sum(mask)
    lml = -0.5 * quad - logdet - 0.5 * n_real * _LOG2PI
    lml = jnp.where(jnp.isfinite(lml), lml, -jnp.inf)
    return lml, grads


def row_sharded_lml_value_grad(
    kernel, theta, X, y, alpha_diag, mask, mesh, nb=256, unroll=False,
    method="adjoint",
):
    """Masked LML and its theta-gradient, each pass row-sharded.

    Reverse mode through the distributed sweep would have to store every
    panel's intermediates (O(steps · n²/P) memory — exactly what this
    module exists to avoid), so two storage-free strategies are offered:

    * ``method="adjoint"`` (default): the closed-form GPML gradient
      from ~3 distributed passes total — one factor sweep that also
      forward-solves ``L⁻¹[y, I]``, one backward sweep for
      ``[α, K⁻¹]``, then D cheap elementwise contractions. Cost is
      independent of the hyperparameter count D.
    * ``method="jvp"``: one ``jax.jvp`` of :func:`row_sharded_lml` per
      hyperparameter, run sequentially under ``lax.map`` — D primal+
      tangent sweeps, but the leanest memory (~2 strips) and the only
      path honoring ``unroll``.

    Both seed the ML-II warm start whose handful of L-BFGS steps only
    initialize the MCMC chain (``/root/reference/bask/bayesgpr.py:78-79``).
    Returns ``(lml, grad)`` with ``grad`` of shape ``theta.shape``.
    """
    if method == "adjoint":
        ax, P_sz, nb = _prep_row_mesh(
            mesh, X.shape[0], nb, "row_sharded_lml_value_grad"
        )
        body = partial(
            _adjoint_strip_body, kernel=kernel, ax=ax, P_sz=P_sz, nb=nb
        )
        fn = jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P(), P(), P(), P(), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )
        return fn(theta, X, y, alpha_diag, mask)
    if method != "jvp":
        raise ValueError(f"unknown method {method!r} (adjoint|jvp)")

    def f(t):
        return row_sharded_lml(
            kernel, t, X, y, alpha_diag, mask, mesh, nb=nb, unroll=unroll
        )

    def one(i):
        tangent = jnp.zeros_like(theta).at[i].set(1.0)
        return jax.jvp(f, (theta,), (tangent,))

    vals, grads = lax.map(one, jnp.arange(theta.shape[0]))
    return vals[0], grads


def row_sharded_predict(
    kernel,
    theta,
    X,
    y,
    alpha_diag,
    mask,
    Xq,
    mesh,
    nb=256,
    y_mean=0.0,
    y_std=1.0,
    theta_diag=None,
    return_lml=False,
    return_cov=False,
    return_grad=False,
    unroll=False,
):
    """Predictive mean/std (or full covariance) with the gram row-sharded.

    The huge-n counterpart of :func:`bask_tpu.models.gp.predict`: both
    forward solves (``L⁻¹y`` and ``L⁻¹k(X, Xq)``) ride the same
    distributed factorization sweep as the LML — no stored factor, no
    backward solve —

        mean = y_mean + y_std · (L⁻¹Kq)ᵀ(L⁻¹y)
        var  = diag k(Xq, Xq) − |L⁻¹Kq|²
        cov  = (k(Xq, Xq) − (L⁻¹Kq)ᵀ(L⁻¹Kq)) · y_std²   [return_cov]

    ``theta_diag``: optional separate theta for the query-side kernel
    (noise-free prediction, mirroring ``gp.predict``'s ``theta_diag``).
    Returns ``(mean, std-or-cov)`` in original y units, plus the masked
    LML when ``return_lml`` (it falls out of the same sweep for free).
    ``return_grad`` appends ``(mean_grad, std_grad)`` — the gradients of
    the predictive mean and std wrt each query point, (m, d) each,
    computed as extra forward-solve columns of the SAME sweep (the
    row-mode counterpart of ``gp.predict``'s autodiff gradients; needed
    by ``expected_minimum``). Return order:
    ``mean, uncert[, mean_grad, std_grad][, lml]``.
    Query batches should stay ≪ n (each device carries an (n_loc, m)
    solve block).
    """
    if return_grad and return_cov:
        raise ValueError(
            "return_grad gives mean/std gradients; it is incompatible "
            "with return_cov"
        )
    ax, P_sz, nb = _prep_row_mesh(
        mesh, X.shape[0], nb, "row_sharded_predict"
    )
    tq = theta if theta_diag is None else theta_diag

    def body(theta, tq, X, Xq, y, alpha_diag, mask):
        quad, logdet, dot, qnorm, qouter, dotg, qcross = _sweep_strip(
            theta, X, Xq, y, alpha_diag, mask,
            kernel=kernel, ax=ax, P_sz=P_sz, nb=nb, theta_diag=tq,
            with_outer=return_cov, with_grad=return_grad, unroll=unroll,
        )
        n_real = jnp.sum(mask)
        lml = -0.5 * quad - logdet - 0.5 * n_real * _LOG2PI
        lml = jnp.where(jnp.isfinite(lml), lml, -jnp.inf)
        return dot, qnorm, qouter, lml, dotg, qcross

    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P()),
        out_specs=(P(), P(), P(), P(), P(), P()),
        check_vma=False,
    )
    dot, qnorm, qouter, lml, dotg, qcross = fn(
        theta, tq, X, Xq, y, alpha_diag, mask
    )
    mean = y_mean + y_std * dot
    if return_cov:
        uncert = (kernel.eval(tq, Xq, None) - qouter) * y_std**2
    else:
        var = jnp.maximum(kernel.diag(tq, Xq) - qnorm, 0.0)
        uncert = jnp.sqrt(var) * y_std
    out = [mean, uncert]
    if return_grad:
        # mean = y_mean + y_std·(L⁻¹Kq)ᵀ(L⁻¹y)  →  ∂mean = y_std·dotg
        # var  = diag k(x, x) − |L⁻¹Kq|²
        #   →  ∂std = y_std·(½·∂diag k − qcross)/std
        ddiag = jax.vmap(
            jax.grad(lambda x: kernel.diag(tq, x[None, :])[0])
        )(Xq)
        # same clipping as the reported std (var floored at 0, NOT a
        # tiny epsilon): where the variance clips to exactly 0 — e.g. a
        # query coinciding with a training point under noise-free
        # theta_diag — the division propagates inf/nan exactly like the
        # dense path's autodiff through sqrt(max(var, 0)), instead of
        # silently emitting huge finite garbage gradients
        std = jnp.sqrt(jnp.maximum(kernel.diag(tq, Xq) - qnorm, 0.0))
        out.append(y_std * dotg)
        out.append(y_std * (0.5 * ddiag - qcross) / std[:, None])
    if return_lml:
        out.append(lml)
    return tuple(out) if len(out) > 2 else (out[0], out[1])


def row_sharded_sample_y(
    kernel,
    theta,
    X,
    y,
    alpha_diag,
    mask,
    Xq,
    key,
    mesh,
    n_samples=1,
    nb=256,
    y_mean=0.0,
    y_std=1.0,
    theta_diag=None,
):
    """Joint predictive draws at ``Xq`` with the gram row-sharded:
    (m, n_samples). Mirrors :func:`bask_tpu.models.gp.sample_y`'s
    eigendecomposition factor (exact for the rank-deficient posterior
    covariances dense query grids produce); the (m, m) covariance comes
    from the distributed sweep, the factorization of it is replicated
    (m ≪ n by assumption)."""
    from ..models.gp import eigh_draws

    mean, cov = row_sharded_predict(
        kernel, theta, X, y, alpha_diag, mask, Xq, mesh=mesh, nb=nb,
        y_mean=y_mean, y_std=y_std, theta_diag=theta_diag,
        return_cov=True,
    )
    return eigh_draws(mean, cov, key, n_samples)


def row_sharded_lml_batch(
    kernel, thetas, X, y, alpha_diag, mask, mesh, nb=256, unroll=False,
    n_warp=0,
):
    """(W, n_theta) → (W,) LMLs, each factorization row-sharded.

    Walkers run sequentially (``lax.map``): this path is for n so large
    that one gram strains a chip — there, walker-axis parallelism is
    already out of memory and the mesh's parallelism goes to the rows.
    ``n_warp > 0``: rows carry per-walker Beta-CDF warp parameters,
    applied to the replicated ``X`` inside each walker's sweep (see
    ``_lml_strip_body``).
    """
    ax, P_sz, nb = _prep_row_mesh(
        mesh, X.shape[0], nb, "row_sharded_lml_batch"
    )
    body = partial(
        _lml_strip_body, kernel=kernel, ax=ax, P_sz=P_sz, nb=nb,
        unroll=unroll, n_warp=n_warp,
    )

    def mapped(thetas, X, y, alpha_diag, mask):
        return lax.map(
            lambda t: body(t, X, y, alpha_diag, mask), thetas
        )

    fn = jax.shard_map(
        mapped,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    return fn(thetas, X, y, alpha_diag, mask)


def walker_row_sharded_lml(
    kernel, thetas, X, y, alpha_diag, mask, mesh, nb=256, unroll=False,
    n_warp=0,
):
    """(W, n_theta) → (W,) LMLs on a 2-D (walker × row) mesh.

    Composes both parallelism axes: the walker batch shards over the
    mesh's FIRST axis (pure data parallelism, no communication) and
    each walker's factorization row-shards over the SECOND axis
    (collectives as in :func:`row_sharded_lml`). This is the layout
    for ensembles at n too large for per-device grams but small enough
    that devices outnumber walkers' memory needs — e.g. 100 walkers ×
    n=32k on a 4×4 device mesh: 25 sequential row-sharded
    factorizations per 4-device row group instead of 100.

    The walker count must be divisible by the first axis size;
    ``n_pad`` by the second.
    """
    if len(mesh.axis_names) != 2:
        raise ValueError(
            "walker_row_sharded_lml expects a 2-axis mesh (walkers, rows)"
        )
    w_ax, r_ax = mesh.axis_names
    W_sz = mesh.shape[w_ax]
    P_sz = mesh.shape[r_ax]
    W = thetas.shape[0]
    n = X.shape[0]
    if W % W_sz:
        raise ValueError(
            f"walker count {W} must be divisible by the mesh's "
            f"{w_ax} axis size {W_sz}"
        )
    if n % P_sz:
        raise ValueError(
            f"n_pad={n} must be divisible by the mesh's "
            f"{r_ax} axis size {P_sz}"
        )
    nb = pick_row_nb(n // P_sz, nb)
    body = partial(
        _lml_strip_body, kernel=kernel, ax=r_ax, P_sz=P_sz, nb=nb,
        unroll=unroll, n_warp=n_warp,
    )

    def mapped(thetas_loc, X, y, alpha_diag, mask):
        return lax.map(
            lambda t: body(t, X, y, alpha_diag, mask), thetas_loc
        )

    fn = jax.shard_map(
        mapped,
        mesh=mesh,
        in_specs=(P(w_ax, None), P(), P(), P(), P()),
        out_specs=P(w_ax),
        check_vma=False,
    )
    return fn(thetas, X, y, alpha_diag, mask)
