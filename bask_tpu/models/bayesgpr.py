"""Fully-Bayesian GP regressor with on-device hyperparameter MCMC.

API-compatible rebuild of the reference's ``BayesGPR``
(``bask/bayesgpr.py:18``): kernel hyperparameters are inferred by an
affine-invariant ensemble sampler and summarized at the geometric median;
prediction/sampling marginalize over the hyperposterior.

Design differences from the reference:

* the reference advances 100 emcee walkers serially in Python, one
  O(n^3) Cholesky per walker per step; here the whole chain runs inside
  one jitted ``lax.scan`` with a *batched* Cholesky per half-ensemble
  (``bask_tpu.parallel.mcmc``), and the walker axis shards over a device
  mesh,
* training data lives on device in padded buckets (static shapes across
  a growing BO loop — no per-iteration recompiles),
* input warping (Beta CDF) is fused into the jitted log-probability
  instead of rebuilding scipy distributions per walker step
  (reference ``bask/bayesgpr.py:351-365``),
* ``noise_set_to_zero`` becomes an immutable theta variant rather than
  kernel mutation (reference ``bask/bayesgpr.py:318-336``), and
* the ML-II warm start uses JAX autodiff gradients of the LML.
"""

from __future__ import annotations

import math
import warnings
from collections import OrderedDict
from contextlib import contextmanager
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import kernels as bk
from ..ops.linalg import masked_cholesky, masked_gram, cho_solve_masked
from ..parallel.mcmc import flatten_chain, run_ensemble
from ..utils.aot import aot_call
from ..utils.median import geometric_median
from ..utils.priors import guess_priors
from . import gp as gpc
from . import warping as wp

__all__ = ["BayesGPR"]

# Route the common sample() case (no add-chains, no progress bar;
# sharded ensembles included) through the single fused device program
# `_fused_sample`. "off" forces the legacy multi-dispatch path (used by
# the parity tests that pin fused == unfused).
FUSED_SAMPLE = "on"


def _bucket(n: int) -> int:
    """Padding bucket: 64 minimum, then multiples of 64.

    A 64x64 factorization costs microseconds, but every bucket change
    recompiles the jitted chain/acquisition programs, which costs far
    more than the factorization. Starting at 64 means a typical BO loop
    (10-60 observations) compiles exactly one set of programs.
    """
    return max(64, ((n + 63) // 64) * 64)


# ---------------------------------------------------------------------------
# Jitted entry points (module-level so the cache survives across facade
# calls; all static args are hashable and reused between calls)
# ---------------------------------------------------------------------------


# Host-callback adapters for NumPy/SciPy priors (reference users pass
# e.g. ``lambda x: halfnorm(scale=2).logpdf(...)``; those are not JAX-
# traceable). Cached by prior *equality* (one cache per wrapping mode —
# element-wise vs joint produce different callback shapes) so the jitted
# chain, which takes the priors tuple as a static argument, is not
# recompiled per tell. A bounded strong-reference LRU, not a weak dict:
# transient callables (e.g. ``dist.logpdf`` creates a fresh bound method
# per attribute access, whose weakref dies immediately) must still map to
# ONE stable wrapper identity — bound methods of the same object compare
# and hash equal, so the LRU reuses the wrapper where a weak cache would
# silently recompile the whole chain every sample().
_HOST_PRIOR_CACHE = {
    False: OrderedDict(),
    True: OrderedDict(),
}
_HOST_PRIOR_CACHE_MAX = 64

# Tabulated-interpolation wrappers for opaque priors under
# host_prior_mode="interp" — keyed by (callable, range) so the jitted
# chain's static priors tuple stays identity-stable across tells.
_INTERP_PRIOR_CACHE = OrderedDict()
# Margin (in log-theta units) beyond the kernel bounds covered by the
# table; the chain's priors confine walkers near the bounds, and beyond
# the table the interpolant extrapolates the edge slopes linearly.
_INTERP_PRIOR_MARGIN = 5.0


def _host_prior_wrapper(p, joint: bool = False):
    """Wrap a host-only log-prior in ``jax.pure_callback``.

    ``joint=False``: ``p`` maps one log-theta scalar to a log-density
    (evaluated elementwise via ``np.vectorize`` so plain-Python and
    NumPy/SciPy callables both batch over walkers). ``joint=True``:
    ``p`` maps the whole theta vector to one log-density.
    """
    if joint:
        def host_prior(x):
            def call(v):
                out = p(np.asarray(v, dtype=np.float64))
                return np.asarray(out, dtype=np.float64).astype(x.dtype)

            return jax.pure_callback(
                call,
                jax.ShapeDtypeStruct((), x.dtype),
                x,
                vmap_method="sequential",
            )

        return host_prior

    vec = np.vectorize(p, otypes=[np.float64])

    def host_prior(x):
        def call(v):
            return vec(np.asarray(v, dtype=np.float64)).astype(x.dtype)

        return jax.pure_callback(
            call,
            jax.ShapeDtypeStruct(x.shape, x.dtype),
            x,
            vmap_method="expand_dims",
        )

    return host_prior


# convergence guard active by default: sample()/fit() warn when the
# retained chain's max split R-hat exceeds this (the standard threshold).
# The estimator is host-side numpy over the already-fetched kept steps,
# cheap next to one device dispatch. The reference ships NO convergence signal at all
# (bask/bayesgpr.py:381-548); pass warn_rhat=None for its silence.
DEFAULT_WARN_RHAT = 1.1


def _maybe_warn_rhat(kept_steps, warn_rhat):
    """Shared convergence guard of both sample() branches.

    Chains too short for the split estimator (< 4 kept steps — e.g. the
    reference-shaped ``fit()`` default of 100 samples over 100 walkers)
    are skipped: no cheap honest estimate exists there."""
    if warn_rhat is None or kept_steps.shape[0] < 4:
        return
    from ..utils.diagnostics import split_rhat

    max_rhat = float(np.max(split_rhat(kept_steps)))
    if max_rhat > warn_rhat:
        warnings.warn(
            f"MCMC chain may not be converged: max split R-hat "
            f"{max_rhat:.3f} exceeds the threshold {warn_rhat}. "
            "Sample to convergence with until_rhat="
            f"{warn_rhat} (warm chunk extensions), increase "
            "n_desired_samples/n_burnin, or inspect "
            "mcmc_diagnostics() per dimension. Pass warn_rhat=None "
            "to silence this guard.",
            UserWarning,
            stacklevel=3,
        )


def _eval_priors(priors, theta_gp):
    if callable(priors):
        return priors(theta_gp)
    lp = 0.0
    for i, p in enumerate(priors):
        lp = lp + p(theta_gp[i])
    return lp


def _make_log_prob(kernel, priors, warp_prior, n_warp, data):
    def log_prob(x):
        if n_warp:
            theta_gp, la, lb = wp.split_warp_params(x, n_warp)
            d = data._replace(X=wp.warp(data.X, la, lb))
            lp = warp_prior(la, lb)
        else:
            theta_gp, d, lp = x, data, 0.0
        lp = lp + _eval_priors(priors, theta_gp)
        lml = gpc.log_marginal_likelihood(kernel, theta_gp, d)
        total = lp + lml
        return jnp.where(jnp.isfinite(total), total, -jnp.inf)

    return log_prob


def _make_log_prob_batch(
    kernel, priors, warp_prior, n_warp, data, mesh=None, row_cfg=None
):
    """Batched (W, D) -> (W,) log-probability for the ensemble sampler.

    The prior/warp terms are vmapped (trivial); the LML batch goes
    through :func:`bask_tpu.ops.linalg.batched_lml`, which fuses the
    gram construction in a Pallas kernel and uses one batched
    factorization when the kernel structure allows. A ``mesh`` makes the
    per-walker LML pipeline an explicit ``shard_map`` over the walker
    axis (the Pallas gram is a custom call GSPMD cannot partition — see
    ``batched_lml``).

    ``row_cfg``: optional ``(row_mesh, nb, unroll)`` — the huge-n mode
    (``BayesGPR(row_mesh=...)``): each walker's LML comes from the
    row-sharded distributed factorization sweep (no (n, n) gram ever
    materializes on one device; :mod:`bask_tpu.ops.dist_chol`). A
    two-axis row mesh additionally data-parallelizes the walker batch
    over its first axis. Mutually exclusive with ``mesh``. With input
    warping, the per-walker Beta-CDF warp folds INTO each walker's
    sweep (no (W, n, d) warped-X batch ever materializes).
    """
    from ..ops.linalg import batched_lml

    n_gp = kernel.n_theta

    def log_prob_batch(xs):
        theta_gp = xs[:, :n_gp]
        if n_warp:
            def prior_one(x):
                _, la, lb = wp.split_warp_params(x, n_warp)
                return warp_prior(la, lb)

            lp = jax.vmap(prior_one)(xs)
        else:
            lp = jnp.zeros(xs.shape[0], dtype=xs.dtype)
        lp = lp + jax.vmap(lambda t: _eval_priors(priors, t))(theta_gp)
        if row_cfg is not None:
            from ..ops.dist_chol import (
                row_sharded_lml_batch,
                walker_row_sharded_lml,
            )

            row_mesh, row_nb, row_unroll = row_cfg
            lml_fn = (
                walker_row_sharded_lml
                if len(row_mesh.axis_names) == 2
                else row_sharded_lml_batch
            )
            # full rows when warping: the warp is applied per walker
            # inside the sweep body against the replicated data.X
            lml = lml_fn(
                kernel, xs if n_warp else theta_gp, data.X, data.y,
                data.alpha_diag, data.mask,
                mesh=row_mesh, nb=row_nb, unroll=row_unroll,
                n_warp=n_warp,
            )
        else:
            if n_warp:
                Xb = jax.vmap(
                    lambda x: wp.warp(
                        data.X, *wp.split_warp_params(x, n_warp)[1:]
                    )
                )(xs)
            else:
                Xb = data.X
            lml = batched_lml(
                kernel, theta_gp, Xb, data.y, data.alpha_diag, data.mask,
                mesh=mesh,
            )
        total = lp + lml
        return jnp.where(jnp.isfinite(total), total, -jnp.inf)

    return log_prob_batch


# NB: the three chain entry points take their DYNAMIC arguments
# positionally and every static argument keyword-only — the contract
# :func:`bask_tpu.utils.aot.aot_call` relies on to call a cached
# serialized executable (which accepts only the dynamic arguments).


@partial(
    jax.jit,
    static_argnames=(
        "kernel", "priors", "warp_prior", "n_warp", "n_steps", "a", "mesh",
        "row_cfg", "moves",
    ),
)
def _run_chain(
    data, pos0, key, *,
    kernel, priors, warp_prior, n_warp, n_steps, a=2.0, mesh=None,
    row_cfg=None, moves=None,
):
    log_prob = _make_log_prob_batch(
        kernel, priors, warp_prior, n_warp, data, mesh=mesh, row_cfg=row_cfg
    )
    return run_ensemble(log_prob, pos0, key, n_steps, a=a, moves=moves)


@partial(
    jax.jit,
    static_argnames=(
        "kernel", "priors", "warp_prior", "n_warp", "mesh", "row_cfg"
    ),
)
def _init_chain_state(
    data, pos, *, kernel, priors, warp_prior, n_warp, mesh=None, row_cfg=None
):
    from ..parallel.mcmc import init_ensemble

    log_prob = _make_log_prob_batch(
        kernel, priors, warp_prior, n_warp, data, mesh=mesh, row_cfg=row_cfg
    )
    return init_ensemble(log_prob, pos)


def _theta_block_logpost(data, x0, kernel, priors, n_warp):
    """Shared scalar for the Laplace-init jits: the log posterior as a
    function of the KERNEL-THETA block, with warp parameters held FIXED
    at ``x0``'s warp slice (JAX's ``betainc`` has no a/b derivatives,
    so neither gradients nor curvature across the warp dims are
    computable — the caller gives those dims the ball width instead).
    Returns ``(scalar_fn, x0_theta_block)``."""
    n_theta = x0.shape[0] - 2 * n_warp
    if n_warp:
        _, la, lb = wp.split_warp_params(x0, n_warp)
        d = data._replace(X=wp.warp(data.X, la, lb))
    else:
        d = data

    def scalar(tg):
        # The SECOND-order graph through the Cholesky (solve-triangular
        # transposes, quadratic forms) would run at default matmul
        # precision (TF32 on a GPU, about three digits) — trace every
        # matmul in this one-off program at HIGHEST
        with jax.default_matmul_precision("highest"):
            return _eval_priors(priors, tg) - _neg_lml_plain(kernel, tg, d)

    return scalar, x0[:n_theta]


@partial(
    jax.jit,
    static_argnames=("kernel", "priors", "n_warp"),
)
def _log_post_value_grad(data, x0, *, kernel, priors, n_warp):
    """Packed ``[-log posterior, d(-log posterior)/d theta]`` over the
    kernel-theta block at ``x0`` — drives the host L-BFGS MAP
    refinement of the Laplace-init center (one device fetch per
    step, like the ML-II host driver)."""
    scalar, x0g = _theta_block_logpost(data, x0, kernel, priors, n_warp)
    v, g = jax.value_and_grad(lambda t: -scalar(t))(x0g)
    return jnp.concatenate([v[None], g])


@partial(
    jax.jit,
    static_argnames=("kernel", "priors", "n_warp"),
)
def _log_post_hessian(data, x0, *, kernel, priors, n_warp):
    """Kernel-theta Hessian of the log posterior at ``x0`` for the
    Laplace chain init. Differentiates the PLAIN XLA Cholesky (the
    ML-II rationale squared: second-order reverse through the blocked
    Newton-Schulz path would compile an enormous graph), and builds the
    (Dg, Dg) matrix as Dg sequential Hessian-vector products under
    ``lax.map`` — peak memory is ONE reverse graph, not Dg of them, so
    the init never dominates the fit's own footprint at large n."""
    scalar, x0g = _theta_block_logpost(data, x0, kernel, priors, n_warp)
    g = jax.grad(scalar)

    def hvp(v):
        return jax.jvp(g, (x0g,), (v,))[1]

    eye = jnp.eye(x0g.shape[0], dtype=x0.dtype)
    return jax.lax.map(hvp, eye)


# Laplace-init spread guards (log-space hyperparameters): directions
# with vanishing or negative curvature at the MAP point (flat LML
# ridges) are capped at prior-scale width — the guess_priors round-flat
# densities have O(1) log-space spread, so 1.0 is the honest
# overdispersed-but-finite choice; the floor keeps the historical 1e-2
# ball as the lower bound so a razor-sharp mode still gets a
# non-degenerate ensemble.
_LAPLACE_STD_MAX = 1.0
_LAPLACE_STD_MIN = 1e-2


@partial(
    jax.jit,
    static_argnames=(
        "kernel", "priors", "warp_prior", "n_warp", "a", "mesh", "row_cfg",
        "moves",
    ),
)
def _run_chain_chunk(
    data, state, keys, *, kernel, priors, warp_prior, n_warp, a=2.0,
    mesh=None, row_cfg=None, moves=None,
):
    """Advance an existing ensemble state by ``len(keys)`` steps.

    Used by the ``progress=True`` path: the chain is split into fixed
    chunks with a host progress tick between them. Fed the same per-step
    key array as the fused path, the produced chain is bit-identical.
    """
    from ..parallel.mcmc import make_step_fn

    log_prob = _make_log_prob_batch(
        kernel, priors, warp_prior, n_warp, data, mesh=mesh, row_cfg=row_cfg
    )
    step = make_step_fn(log_prob, a=a, moves=moves)
    final, chain = jax.lax.scan(step, state, keys)
    return chain, final


def _neg_lml_plain(kernel, theta, data, inf_value=jnp.inf):
    """Negative LML through the plain XLA Cholesky path (never the
    blocked-matmul fast path): XLA's cholesky has a compact, well-tested
    gradient, whereas reverse-mode through the Newton-Schulz blocks
    compiles a very large graph for a one-off warm start. Shared by the
    host-driven and on-device ML-II optimizers."""
    import math as _math

    from jax.scipy.linalg import solve_triangular as _st

    from ..ops.linalg import masked_cholesky, masked_gram

    Kp = masked_gram(kernel, theta, data.X, data.alpha_diag, data.mask)
    L = masked_cholesky(Kp)
    w = _st(L, data.y, lower=True)
    n = jnp.sum(data.mask)
    lml = (
        -0.5 * jnp.sum(w * w)  # elementwise: no reduced-precision dot
        - jnp.sum(jnp.where(data.mask, jnp.log(jnp.diagonal(L)), 0.0))
        - 0.5 * n * _math.log(2.0 * _math.pi)
    )
    return jnp.where(jnp.isfinite(lml), -lml, inf_value)


@partial(jax.jit, static_argnames=("kernel",))
def _lml_value_grad(theta, data, *, kernel):
    """Value+grad of the LML for the ML-II warm start, packed into ONE
    output vector [value, grad...] (one device->host fetch per L-BFGS
    step — fetch latency, not compute, dominates the small-n warm
    start)."""
    v, g = jax.value_and_grad(
        lambda t: _neg_lml_plain(kernel, t, data)
    )(theta)
    return jnp.concatenate([v[None], g])


def _ml2_lbfgs_core(theta0s, lb, ub, *, obj_t, maxiter, restart_mapper):
    """Shared on-device L-BFGS driver for both ML-II device programs.

    ``obj_t`` is the bounded-space objective (negative LML as a finite
    1e25 sentinel on failed factorizations — the zoom linesearch needs
    comparable values). Bounds are handled by a smooth sigmoid
    reparameterization theta = lb + (ub-lb)*sigmoid(u) (a post-update
    clip-projection was measured to stall against active bounds and
    lose ~1 nat of LML; the transform matches scipy's L-BFGS-B optimum
    to ~10 digits on the test problems). ``restart_mapper`` maps
    ``solve_one`` over the restart batch (``jax.vmap`` for the dense
    program, ``jax.lax.map`` when restarts must run sequentially).
    """
    import optax

    width = ub - lb

    def to_u(t):
        p = jnp.clip((t - lb) / width, 1e-6, 1.0 - 1e-6)
        return jnp.log(p) - jnp.log1p(-p)

    def to_t(u):
        return lb + width * jax.nn.sigmoid(u)

    def obj(u):
        return obj_t(to_t(u))

    opt = optax.lbfgs()
    vg = optax.value_and_grad_from_state(obj)

    def solve_one(t0):
        u0 = to_u(t0)
        state0 = opt.init(u0)

        def step(carry, _):
            params, state = carry
            value, grad = vg(params, state=state)
            # failed factorizations leak NaN through the cholesky
            # backward pass even though the value is the finite 1e25
            # sentinel — mirror the host driver's zero-gradient guard,
            # and keep the last finite iterate if the linesearch state
            # still produces a NaN step (0/0 slope)
            grad = jnp.where(jnp.isfinite(grad), grad, 0.0)
            updates, state = opt.update(
                grad, state, params, value=value, grad=grad, value_fn=obj
            )
            new_params = optax.apply_updates(params, updates)
            new_params = jnp.where(
                jnp.isfinite(new_params), new_params, params
            )
            return (new_params, state), None

        (uf, _), _ = jax.lax.scan(
            step, (u0, state0), None, length=maxiter
        )
        return to_t(uf), obj(uf)

    tfs, vals = restart_mapper(solve_one, theta0s)
    return tfs[jnp.argmin(vals)]


@partial(jax.jit, static_argnames=("kernel", "maxiter"))
def _ml2_device(theta0s, data, lb, ub, *, kernel, maxiter=60):
    """The WHOLE ML-II warm start in one device program (opt-in via
    ``BayesGPR(optimizer="lbfgs-device")``): projected L-BFGS (optax,
    zoom linesearch) on the negative LML, vmapped over restarts, best
    restart selected on device. No host round trips — the host-driven
    scipy path costs one packed fetch per L-BFGS step (~40 steps), this
    costs one dispatch + one fetch.
    The ML estimate is only the chain seed anyway — the reference
    treats it the same way (``bask/bayesgpr.py:78-79``).
    """

    def obj_t(t):
        return _neg_lml_plain(kernel, t, data, inf_value=1e25)

    return _ml2_lbfgs_core(
        theta0s, lb, ub, obj_t=obj_t, maxiter=maxiter,
        restart_mapper=lambda f, xs: jax.vmap(f)(xs),
    )


def _canonical_moves(moves):
    """Normalize a user ``moves`` spec to the hashable tuple-of-tuples
    the jitted chain programs take as a static argument (``None`` stays
    ``None`` — the bit-stable pure-stretch path). Validates eagerly so a
    typo fails at construction, not at the first jit trace.

    String shorthands: a single move name ("stretch"/"de"/"snooker")
    means that move at weight 1, and "demix" is the measured
    DE 0.8 + snooker 0.2 mixture (north-star convergence ladder:
    R-hat<1.1 at 4800 steps vs stretch >7200). Any move name
    may carry tunable parameters as ``"name:key=val,..."``
    (``"de:jump=0.2,gamma=0.6,sigma=1e-4"``, ``"snooker:gammas=1.3"``,
    ``"stretch:a=1.5"``); on an alias shorthand the keys distribute
    onto the member move that accepts them (``"demix:jump=0.2"`` tunes
    the DE member). Each parameterization is a fixed reversible
    kernel, so tuned mixtures remain valid random scans.

    ``"auto"`` — the library default — is kept as a sentinel and
    resolved per sample() call once the walker count is known: demix
    when the ensemble can support it (W >= 6), pure stretch below.
    Rationale (PARITY.md): on every measured GP hyperposterior the
    DE+snooker mixture both converges ~1.5-2.6x faster AND visits a
    real secondary posterior mode the stretch move never reaches —
    the honest default. ``moves="stretch"``/``None`` restores the
    reference's (emcee-default) sampler bit-stably."""
    if moves is None:
        return None
    if moves == "auto":
        return "auto"
    if isinstance(moves, str):
        base, sep, rest = moves.partition(":")
        alias = _MOVE_ALIASES.get(base)
        if alias is not None and sep:
            # parameterized alias, e.g. "demix:jump=0.2": distribute
            # each key onto the alias member whose move accepts it
            # (jump/gamma/sigma -> de, gammas -> snooker, a -> stretch)
            from ..parallel.mcmc import _MOVE_PARAMS

            items = [it.strip() for it in rest.split(",")]
            keys = [it.partition("=")[0].strip() for it in items]
            claimed = set()
            out = []
            for name, w in alias:
                mbase = name.partition(":")[0]
                mine = [
                    it
                    for it, k in zip(items, keys)
                    if k in _MOVE_PARAMS[mbase]
                ]
                claimed.update(
                    k for k in keys if k in _MOVE_PARAMS[mbase]
                )
                out.append(
                    (name + (":" + ",".join(mine) if mine else ""), w)
                )
            unknown = [k for k in keys if k not in claimed]
            if unknown:
                raise ValueError(
                    f"alias {base!r} members accept no parameter named "
                    f"{unknown[0]!r}"
                )
            moves = tuple(out)
        elif alias is not None:
            moves = alias
        else:
            moves = ((moves, 1.0),)
    from ..parallel.mcmc import _normalize_moves

    canon = tuple((str(n), float(w)) for n, w in moves)
    _normalize_moves(canon)
    return canon


_MOVE_ALIASES = {
    "demix": (("de", 0.8), ("snooker", 0.2)),
    "tri": (("stretch", 0.5), ("de", 0.4), ("snooker", 0.1)),
    # a "dream" alias (DREAM-style subspace-crossover DE) existed during
    # round 5 and was REJECTED by measurement — see the parallel/mcmc.py
    # note
}


def _row_lml_rev(kernel, row_cfg, grad_method="adjoint"):
    """Reverse-differentiable row-sharded LML: ``f(theta, data) -> lml``.

    The distributed sweep cannot be reverse-differentiated directly
    (saving every panel would cost O(steps·n²/P) memory), so the VJP is
    one of the storage-free ``dist_chol`` gradients chosen by
    ``grad_method`` — ``"adjoint"`` (D-independent cost, ~4-5 gram
    strips of peak memory) or ``"jvp"`` (D sweeps, leanest ~2-strip
    memory; honors the row ``unroll`` flag). ONLY the theta cotangent
    is real — ``data`` is treated as a constant (zero cotangent), which
    is exactly the ML-II contract this exists for. Do not use it to
    differentiate through the training data.
    """
    from ..ops.dist_chol import (
        row_sharded_lml,
        row_sharded_lml_value_grad,
    )

    mesh, nb, unroll = row_cfg

    @jax.custom_vjp
    def f(theta, data):
        return row_sharded_lml(
            kernel, theta, data.X, data.y, data.alpha_diag, data.mask,
            mesh, nb=nb, unroll=unroll,
        )

    def fwd(theta, data):
        v, g = row_sharded_lml_value_grad(
            kernel, theta, data.X, data.y, data.alpha_diag, data.mask,
            mesh, nb=nb, unroll=unroll, method=grad_method,
        )
        return v, (g, data)

    def bwd(res, ct):
        g, data = res
        return ct * g, jax.tree.map(jnp.zeros_like, data)

    f.defvjp(fwd, bwd)
    return f


@partial(
    jax.jit,
    static_argnames=("kernel", "row_cfg", "maxiter", "grad_method"),
)
def _ml2_device_row(
    theta0s, data, lb, ub, *, kernel, row_cfg, maxiter=60,
    grad_method="adjoint",
):
    """Row-sharded counterpart of :func:`_ml2_device`: the whole ML-II
    warm start in one device program, gradients from the distributed
    sweep (``grad_method``, see :func:`_row_lml_rev`; never an
    (n_pad, n_pad) factor). Restarts run sequentially under ``lax.map``
    — at huge n the rows own the mesh's parallelism and a vmapped
    restart batch would multiply peak memory. Same sigmoid bound
    transform and NaN guards as the dense program
    (:func:`_ml2_lbfgs_core`).
    """
    lml = _row_lml_rev(kernel, row_cfg, grad_method)

    def obj_t(t):
        v = -lml(t, data)
        return jnp.where(jnp.isfinite(v), v, 1e25)

    return _ml2_lbfgs_core(
        theta0s, lb, ub, obj_t=obj_t, maxiter=maxiter,
        restart_mapper=jax.lax.map,
    )


def _posterior_robust_body(theta, data, kernel):
    """Posterior factorization with a branchless jitter ladder."""
    Kp = masked_gram(kernel, theta, data.X, data.alpha_diag, data.mask)
    scale = jnp.mean(jnp.abs(jnp.diagonal(Kp)))
    eye = jnp.eye(Kp.shape[0], dtype=Kp.dtype)
    L0 = masked_cholesky(Kp)
    L1 = masked_cholesky(Kp + 1e-8 * scale * eye)
    L2 = masked_cholesky(Kp + 1e-4 * scale * eye)
    L = jnp.where(
        jnp.any(jnp.isnan(L0)), jnp.where(jnp.any(jnp.isnan(L1)), L2, L1), L0
    )
    alpha_dual = cho_solve_masked(L, data.y)
    return gpc.GPPosterior(theta=theta, L=L, alpha_dual=alpha_dual)


@partial(jax.jit, static_argnames=("kernel",))
def _posterior_robust(theta, data, *, kernel):
    return _posterior_robust_body(theta, data, kernel)


@partial(jax.jit, static_argnames=("kernel",))
def _lml_value(theta, data, *, kernel):
    """Jitted scalar LML (one dispatch instead of an eager op chain)."""
    return gpc.log_marginal_likelihood(kernel, theta, data)


# -- row-sharded (huge-n) entry points ------------------------------------
#
# BayesGPR(row_mesh=...) never materializes an (n_pad, n_pad) factor:
# the consensus LML, ML-II gradients, predictions, and joint draws all
# re-run the distributed factorization sweep (ops/dist_chol) per call.
# row_cfg = (mesh, nb, unroll) is one hashable static tuple.


@partial(jax.jit, static_argnames=("kernel", "row_cfg", "n_warp"))
def _row_lml_value(theta, data, la=None, lb=None, *, kernel, row_cfg,
                   n_warp=0):
    from ..ops.dist_chol import row_sharded_lml

    mesh, nb, unroll = row_cfg
    X = wp.warp(data.X, la, lb) if n_warp else data.X
    return row_sharded_lml(
        kernel, theta, X, data.y, data.alpha_diag, data.mask,
        mesh, nb=nb, unroll=unroll,
    )


@partial(jax.jit, static_argnames=("kernel", "row_cfg", "grad_method"))
def _row_lml_value_grad(theta, data, *, kernel, row_cfg,
                        grad_method="adjoint"):
    """Negated LML value+grad packed as [value, grad...] — the row-mode
    counterpart of :func:`_lml_value_grad`. ``grad_method`` selects the
    distributed gradient (``dist_chol.row_sharded_lml_value_grad``):
    ``"adjoint"`` (default) does ~3 sweeps regardless of D but holds
    ~4-5 gram strips; ``"jvp"`` does D forward-mode sweeps at the
    leanest ~2-strip memory and is the only path honoring the row
    ``unroll`` flag (``BayesGPR(row_grad_method=...)`` plumbs this)."""
    from ..ops.dist_chol import row_sharded_lml_value_grad

    mesh, nb, unroll = row_cfg
    v, g = row_sharded_lml_value_grad(
        kernel, theta, data.X, data.y, data.alpha_diag, data.mask,
        mesh, nb=nb, unroll=unroll, method=grad_method,
    )
    return jnp.concatenate([(-v)[None], -g])


@partial(
    jax.jit,
    static_argnames=(
        "kernel", "row_cfg", "return_cov", "with_lml", "with_grad",
        "n_warp",
    ),
)
def _row_predict(
    theta, theta_diag, data, Xq, la=None, lb=None, *, kernel, row_cfg,
    return_cov=False, with_lml=False, with_grad=False, n_warp=0,
):
    from ..ops.dist_chol import row_sharded_predict

    mesh, nb, unroll = row_cfg
    X = data.X
    if n_warp:
        X = wp.warp(X, la, lb)
        Xq_w = wp.warp(Xq, la, lb)
    else:
        Xq_w = Xq
    out = row_sharded_predict(
        kernel, theta, X, data.y, data.alpha_diag, data.mask, Xq_w,
        mesh=mesh, nb=nb, y_mean=data.y_mean, y_std=data.y_std,
        theta_diag=theta_diag, return_lml=with_lml,
        return_cov=return_cov, return_grad=with_grad, unroll=unroll,
    )
    if n_warp and with_grad:
        # the sweep's gradients are wrt the WARPED query; chain-rule
        # back through the columnwise Beta CDF (diagonal Jacobian)
        jac = wp.warp_grad(Xq, la, lb)
        out = list(out)
        out[2] = out[2] * jac  # mean grad
        out[3] = out[3] * jac  # std grad
        out = tuple(out)
    return out


@partial(
    jax.jit, static_argnames=("kernel", "row_cfg", "n_samples", "n_warp")
)
def _row_sample_y(
    theta, theta_diag, data, Xq, key, la=None, lb=None, *, kernel,
    row_cfg, n_samples, n_warp=0,
):
    from ..ops.dist_chol import row_sharded_sample_y

    mesh, nb, _ = row_cfg
    X = data.X
    if n_warp:
        X = wp.warp(X, la, lb)
        Xq = wp.warp(Xq, la, lb)
    return row_sharded_sample_y(
        kernel, theta, X, data.y, data.alpha_diag, data.mask, Xq,
        key, mesh=mesh, n_samples=n_samples, nb=nb, y_mean=data.y_mean,
        y_std=data.y_std, theta_diag=theta_diag,
    )


def _consensus_body(kernel, n_warp, theta, la, lb, data, with_lml=True):
    """Warp -> robust factorization -> (optional) LML: the
    consensus-model refresh.

    Shared verbatim by the standalone `_consensus_state` program and the
    fused sample program (whose median feeds it through an optimization
    barrier), so both paths compile the identical subgraph on
    materialized inputs — the fused == unfused bit-parity contract.
    ``with_lml=False`` skips the LML term for refresh paths that discard
    it (X_train_ setter, rewarp) — on the f32 fast path the LML's
    blocked factorization is NOT shared with the jitter ladder's XLA
    cholesky, so skipping it saves a real factorization at large n.
    Returns (posterior, lml-or-0, warped X).
    """
    if n_warp:
        data = data._replace(X=wp.warp(data.X, la, lb))
    post = _posterior_robust_body(theta, data, kernel)
    if with_lml:
        lml = gpc.log_marginal_likelihood(kernel, theta, data)
    else:
        lml = jnp.zeros((), dtype=data.y.dtype)
    return post, lml, data.X


@partial(jax.jit, static_argnames=("kernel", "n_warp", "with_lml"))
def _consensus_state(theta, la, lb, data, *, kernel, n_warp, with_lml=True):
    return _consensus_body(kernel, n_warp, theta, la, lb, data, with_lml)


@partial(
    jax.jit,
    static_argnames=(
        "kernel", "priors", "warp_prior", "n_warp", "n_steps", "a",
        "discard", "thin", "mesh", "moves",
    ),
)
def _fused_sample(
    data, pos0, key, *,
    kernel, priors, warp_prior, n_warp, n_steps, a, discard, thin,
    mesh=None, moves=None,
):
    """ONE device program for the whole warm-fit path:
    MCMC chain -> kept-step selection -> geometric median -> consensus
    posterior factorization (3-rung jitter ladder) -> LML value.

    Replaces ~5 separate dispatches (plus many eager ops for the LML) in
    ``BayesGPR.sample``: per-dispatch latency adds up against the small
    device compute of one BO iteration. Matches the
    reference's per-tell sequence ``bask/optimizer.py:332-351`` +
    ``bask/bayesgpr.py:522-548`` end to end.
    """
    from ..utils.median import geometric_median

    log_prob = _make_log_prob_batch(
        kernel, priors, warp_prior, n_warp, data, mesh=mesh
    )
    chain, final = run_ensemble(
        log_prob, pos0, key, n_steps, a=a, moves=moves
    )
    kept = chain[discard + thin - 1 :: thin]
    # the barrier materializes the flat chain exactly as the legacy
    # path's separate dispatch would — without it XLA folds the slice
    # into the median's reductions and the result drifts by ~1 ulp,
    # breaking the fused == unfused bit-parity contract
    flat = jax.lax.optimization_barrier(
        kept.reshape(-1, chain.shape[-1])
    )
    median = geometric_median(flat)
    n_gp = kernel.n_theta
    theta_med = median[:n_gp]
    la = median[n_gp : n_gp + n_warp]
    lb = median[n_gp + n_warp :]
    # same materialization contract as above: the legacy path hands the
    # consensus program packed host-side inputs
    theta_med, la, lb = jax.lax.optimization_barrier((theta_med, la, lb))
    post, lml, Xw = _consensus_body(kernel, n_warp, theta_med, la, lb, data)
    # every host-bound output rides ONE flat blob: a device->host fetch
    # pays a round-trip latency regardless of size, so the warm tell
    # fetches once instead of five times (kept until the tell loop is
    # measured on the card, ROADMAP Design #3). The posterior/Xw stay
    # on device (no fetch).
    dt = pos0.dtype
    # the acceptance count rides as two base-2^12 digits so it stays
    # exact in float32 up to 2^36 proposals (a bare f32 lane rounds
    # above 2^24, which very long chains can exceed)
    acc = final.accepted
    blob = jnp.concatenate(
        [
            flat.ravel(),
            final.pos.astype(dt).ravel(),
            median.astype(dt),
            jnp.asarray(acc // 4096, dt)[None],
            jnp.asarray(acc % 4096, dt)[None],
            jnp.asarray(lml, dt)[None],
        ]
    )
    return blob, post, Xw


def _blob_layout(meta):
    """Offsets into the fused-sample blob for ``meta = (n_kept, w_act,
    d_act, n_steps, n_gp_dim, n_warp)``: returns (sz_chain, sz_pos,
    off_median, total). Single source of truth for every site that
    slices the blob (the defer branch, ``_install_from_blob``, and the
    packed-fetch split) — the layout is [flat chain, final pos, median,
    acc_hi, acc_lo, lml], matching ``_fused_sample``'s concat order.
    """
    n_kept, w_act, d_act, _, _, _ = meta
    sz_chain = n_kept * w_act * d_act
    sz_pos = w_act * d_act
    off_median = sz_chain + sz_pos
    total = off_median + d_act + 3
    return sz_chain, sz_pos, off_median, total


def _fetch(x):
    """Single device->host fetch point for the fused-sample blob.

    Kept as a module-level helper so tests can count fetches: each
    device->host transfer pays a round-trip latency regardless of size,
    so the warm-tell budget is counted in fetches, not bytes.
    """
    return np.asarray(x)


@jax.jit
def _pack_fetch(blob, extra):
    """Append a second program's host-bound output to the sample blob so
    the whole warm tell crosses device->host in ONE fetch (the deferred
    overlap path; see ``BayesGPR.sample(_defer_fetch=True)``)."""
    return jnp.concatenate([blob, extra.astype(blob.dtype).ravel()])


@partial(jax.jit, static_argnames=("kernel", "n_samples"))
def _sample_y_mean(theta_diag, post, data, Xq, key, *, kernel, n_samples):
    """Jitted consensus-GP joint draws (one dispatch; also the exact
    subgraph the fused PVRS program embeds, for bit-parity)."""
    return gpc.sample_y(kernel, theta_diag, post, data, Xq, key, n_samples)


@partial(
    jax.jit,
    static_argnames=(
        "kernel",
        "n_warp",
        "include_noise",
        "white_idx",
        "n_total",
    ),
)
def _sample_y_marginal(
    chain_rows, data, Xq, key, *,
    kernel, n_warp, include_noise, white_idx, n_total,
):
    """One predictive draw per hyperposterior row: (S, m)."""
    keys = jax.random.split(key, chain_rows.shape[0])

    def one(x, k):
        if n_warp:
            theta_gp, la, lb = wp.split_warp_params(x, n_warp)
            d = data._replace(X=wp.warp(data.X, la, lb))
            Xq_w = wp.warp(Xq, la, lb)
        else:
            theta_gp, d, Xq_w = x, data, Xq
        # single-Cholesky posterior (not the 3-rung jitter ladder): chain
        # rows are post-burnin posterior samples, so non-PD grams are
        # vanishingly rare, and the ladder would triple the batched
        # factorization cost of every diagnostics/PVRS draw (the
        # acquisition path makes the same trade, acquisition.py)
        post, invs = gpc.posterior_and_invs(kernel, theta_gp, d)
        theta_diag = (
            theta_gp
            if include_noise
            else gpc.noise_free_theta(kernel, theta_gp, white_idx)
        )
        return gpc.sample_y(
            kernel, theta_diag, post, d, Xq_w, k, 1, invs=invs
        )[:, 0]

    return jax.vmap(one)(chain_rows, keys)


@partial(
    jax.jit,
    static_argnames=("kernel", "return_std", "return_cov", "n_warp"),
)
def _predict(
    theta,
    theta_diag,
    post,
    data,
    Xq,
    warp_a,
    warp_b,
    *,
    kernel,
    n_warp,
    return_std,
    return_cov,
):
    if n_warp:
        Xq = wp.warp(Xq, warp_a, warp_b)
    return gpc.predict(
        kernel,
        theta_diag,
        post,
        data,
        Xq,
        return_std=return_std,
        return_cov=return_cov,
    )


@partial(jax.jit, static_argnames=("kernel", "n_warp"))
def _predict_grads(
    theta_diag, post, data, Xq, warp_a, warp_b, *, kernel, n_warp
):
    """Gradients of predictive mean and std wrt each query point."""

    def mean_one(x):
        xq = x[None, :]
        if n_warp:
            xq = wp.warp(xq, warp_a, warp_b)
        return gpc.predict(kernel, theta_diag, post, data, xq)[0]

    def std_one(x):
        xq = x[None, :]
        if n_warp:
            xq = wp.warp(xq, warp_a, warp_b)
        _, s = gpc.predict(kernel, theta_diag, post, data, xq, return_std=True)
        return s[0]

    return jax.vmap(jax.grad(mean_one))(Xq), jax.vmap(jax.grad(std_one))(Xq)


@partial(
    jax.jit, static_argnames=("spec", "n_samples", "n_features", "k")
)
def _pathwise_topk(
    theta, data, L, Xq, key, *, spec, n_samples, n_features, k
):
    """Pathwise draws + per-draw top-k minimizers, all on device."""
    from .pathwise import pathwise_samples

    draws = pathwise_samples(
        spec, theta, data, L, Xq, key, n_samples, n_features
    )
    _, idx = jax.lax.top_k(-draws.T, k)  # (S, k)
    return idx


class BayesGPR:
    """Fully-Bayesian Gaussian process regressor (see module docstring).

    Parameters mirror the reference (``bask/bayesgpr.py:148-180``):
    ``kernel`` (spec from :mod:`bask_tpu.ops.kernels`), ``alpha`` base
    jitter, ``normalize_y``, ``warp_inputs``, ``random_state``, and
    ``noise="gaussian"`` which appends a WhiteKernel to the user kernel.

    Priors are callables of a scalar log-parameter. jit-traceable ones
    (see :mod:`bask_tpu.utils.priors`) run fully on device;
    NumPy/SciPy-style priors ported from reference code are routed
    through a host callback automatically (slower; requires a backend
    with host-callback support).

    bask-tpu extension knobs:
    ``moves`` (ensemble move mixture; default ``"auto"`` = the fastest
    honest sampler — demix at W>=6; ``"stretch"`` restores the
    reference/emcee sampler bit-stably; tunable per-move parameters
    ride the spec string, e.g. ``"demix:jump=0.2"`` or
    ``"stretch:a=1.5"``), ``chain_init`` (``"laplace"``
    = MAP-refined curvature-scaled cold ensemble instead of the 1e-2
    ball; overdispersed starts make the R-hat guard trustworthy),
    ``ml2_objective`` (``"map"`` seeds the chain at the posterior mode
    — the bare-LML optimum rails against kernel bounds on smooth
    objectives), ``ml2_subsample`` (warm-start theta from a dense
    m-point subset; the huge-n row-mode cure), ``row_mesh``/``row_nb``/
    ``row_unroll``/``row_grad_method`` (row-sharded factorization for n
    beyond one device's memory, see docs/production.md section 5).
    """

    # class-level default so instances restored from old pickles (which
    # bypass __init__) still read as "no deferred sample pending"
    _pending = None

    def __init__(
        self,
        kernel: Optional[bk.Kernel] = None,
        alpha: float = 1e-10,
        optimizer: str = "lbfgs",
        n_restarts_optimizer: int = 0,
        normalize_y: bool = False,
        warp_inputs: bool = False,
        copy_X_train: bool = True,
        random_state=None,
        noise: Optional[str] = "gaussian",
        host_prior_mode: str = "callback",
        row_mesh=None,
        row_nb: int = 256,
        row_unroll: bool = False,
        row_grad_method: str = "adjoint",
        moves="auto",
        chain_init: str = "ball",
        ml2_subsample: Optional[int] = None,
        ml2_objective: str = "lml",
    ):
        if kernel is None:
            kernel = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.RBF(
                1.0, (1e-5, 1e5)
            )
        self._user_kernel = kernel
        self.alpha = alpha
        self.optimizer = optimizer
        self.n_restarts_optimizer = n_restarts_optimizer
        self.normalize_y = normalize_y
        self.warp_inputs = warp_inputs
        self.copy_X_train = copy_X_train
        self.noise = noise
        if host_prior_mode not in ("callback", "interp"):
            raise ValueError(
                "host_prior_mode must be 'callback' (exact, needs backend "
                "callback support) or 'interp' (approximate on-device "
                f"tabulation), got {host_prior_mode!r}"
            )
        self.host_prior_mode = host_prior_mode
        if row_mesh is not None:
            # huge-n mode: every factorization is row-sharded over this
            # mesh (ops/dist_chol) and no (n, n) factor is ever stored.
            # 1 axis = rows only; 2 axes = (walkers, rows).
            if len(row_mesh.axis_names) not in (1, 2):
                raise ValueError(
                    "row_mesh must have one (rows) or two (walkers, rows) "
                    f"axes, got {row_mesh.axis_names}"
                )
        if row_grad_method not in ("adjoint", "jvp"):
            raise ValueError(
                "row_grad_method must be 'adjoint' (D-independent cost, "
                "~4-5 gram strips of peak memory) or 'jvp' (D sweeps, "
                f"leanest ~2-strip memory), got {row_grad_method!r}"
            )
        self.row_mesh = row_mesh
        self.row_nb = int(row_nb)
        self.row_unroll = bool(row_unroll)
        self.row_grad_method = row_grad_method
        # ensemble move mixture, e.g. (("de", 0.8), ("snooker", 0.2));
        # "auto" (default) = demix when the walker count supports it,
        # stretch below; None/"stretch" = the historical pure-stretch
        # chain (bit-stable). Normalized eagerly to a hashable tuple —
        # it rides the jitted chain programs as a static argument.
        self.moves = _canonical_moves(moves)
        # cold-chain walker init: "ball" = the reference/emcee tiny ball
        # at the ML-II point (1e-2 sigma; the ensemble then spends its
        # first ~1000 steps EXPANDING to posterior scale — the measured
        # transient of the convergence ladders); "laplace" = draw from
        # N(theta_ML, H^-1) with per-direction spread clamped to
        # [_LAPLACE_STD_MIN, _LAPLACE_STD_MAX] = [1e-2, 1.0], so DE
        # difference vectors are posterior-sized from
        # step 0. Falls back to the ball when the curvature is unusable
        # (non-finite Hessian) or in row-sharded mode.
        if chain_init not in ("ball", "laplace"):
            raise ValueError(
                f"chain_init must be 'ball' or 'laplace', got {chain_init!r}"
            )
        self.chain_init = chain_init
        # huge-n escape hatch for the ML-II warm start: when set and the
        # training set is larger, the warm start optimizes the LML of a
        # random ``ml2_subsample``-point subset through the FAST DENSE
        # path (hyperparameter estimates off 8k points are plenty for a
        # chain-initialization theta; the reference itself uses only "a
        # few" L-BFGS iterations, bask/bayesgpr.py:78-79). Measured
        # motivation: the row-sharded value+grad at n=32768 on ONE 16 GB
        # chip holds ~3 full-width gram strips (12 GB + fragmentation =
        # OOM); the chain itself fits fine. The MCMC ALWAYS runs on the
        # full data — only the warm start subsamples.
        if ml2_subsample is not None and int(ml2_subsample) < 2:
            raise ValueError(
                f"ml2_subsample must be >= 2 points, got {ml2_subsample}"
            )
        self.ml2_subsample = (
            None if ml2_subsample is None else int(ml2_subsample)
        )
        # warm-start objective: "lml" = the reference's bare-LML ML-II
        # (bask/bayesgpr.py:78-79; default for seed parity). "map" adds
        # the (guessed) priors — measured motivation (BASELINE round
        # 5): the bare-LML optimum RAILS against kernel bounds on every
        # measured shape (log-posterior -1e9-class; the round-flat
        # priors plunge there), and a short chain seeded at the rail
        # can leave the consensus in a non-PD region (the n=32768 f32
        # row fit measured -inf exactly this way). The MAP seed starts
        # the chain in posterior mass instead. Host-driver only.
        if ml2_objective not in ("lml", "map"):
            raise ValueError(
                f"ml2_objective must be 'lml' or 'map', got {ml2_objective!r}"
            )
        self.ml2_objective = ml2_objective
        if isinstance(random_state, np.random.RandomState):
            self.random_state = random_state
        else:
            self.random_state = np.random.RandomState(random_state)

        self._spec: Optional[bk.Kernel] = None  # spec incl. White
        self.chain_: Optional[np.ndarray] = None
        self.chain_steps_: Optional[np.ndarray] = None  # (steps, W, D)
        self.pos_: Optional[np.ndarray] = None
        self.noise_: Optional[float] = None
        self.log_marginal_likelihood_value_: Optional[float] = None
        self.warp_alphas_: Optional[np.ndarray] = None
        self.warp_betas_: Optional[np.ndarray] = None

        self._theta: Optional[np.ndarray] = None
        self._data: Optional[gpc.GPData] = None
        self._post: Optional[gpc.GPPosterior] = None
        self._X_orig: Optional[np.ndarray] = None  # unpadded original X
        self._y_orig: Optional[np.ndarray] = None
        self._noise_vector: Optional[np.ndarray] = None
        self._noise_zero = False
        self._priors_cache = None
        self._pending = None  # deferred fused-sample blob (device)
        # machine-readable outcome of the last sample(until_rhat=) run
        # (None until one happens; see docs/production.md section 8)
        self.until_rhat_result_ = None

    # -- basic properties --------------------------------------------------

    @property
    def kernel_(self):
        """Fitted kernel spec with the consensus hyperparameters baked in.

        Reference parity: sklearn GPR's ``kernel_`` carries the fitted
        theta (the reference reads/writes ``kernel_.theta``,
        ``bask/bayesgpr.py:163,200-217``). Internally the *pristine*
        spec (``self._spec``) is the jit static argument — reading this
        property never changes compile-cache keys.
        """
        if self._spec is None:
            return None
        t = self._theta
        if t is None or np.isnan(np.asarray(t, dtype=float)).any():
            return self._spec
        return self._spec.with_theta(np.asarray(t, dtype=float))

    @kernel_.setter
    def kernel_(self, value):
        self._spec = value

    @property
    def X_train_(self):
        """Training inputs (warped if ``warp_inputs``), unpadded."""
        if self._X_orig is None:
            return None
        if self.warp_inputs and self.warp_alphas_ is not None:
            return np.asarray(
                wp.warp(
                    jnp.asarray(self._X_orig),
                    jnp.asarray(self.warp_alphas_),
                    jnp.asarray(self.warp_betas_),
                )
            )
        return self._X_orig

    @X_train_.setter
    def X_train_(self, X_train):
        """Replace the training inputs (original, unwarped space).

        Mirrors the reference setter (``bask/bayesgpr.py:237-247``): the
        warped view is (re)derived from the current warp parameters, and
        the padded device data + factorization refresh.
        """
        X_train = np.atleast_2d(np.asarray(X_train, dtype=float))
        self._X_orig = np.copy(X_train) if self.copy_X_train else X_train
        if self._y_orig is not None:
            self._upload()
            self._refresh_posterior(with_lml=False)

    @property
    def y_train_(self):
        if self._y_orig is None:
            return None
        return (self._y_orig - self.y_train_mean_) / self.y_train_std_

    @property
    def theta(self):
        if self._theta is None:
            return None
        return np.copy(self._theta)

    @theta.setter
    def theta(self, value):
        self._theta = np.asarray(value, dtype=float)
        self._refresh_posterior()

    @property
    def L_(self):
        if self._post is None:
            return None
        n = len(self._y_orig)
        return np.asarray(self._post.L)[:n, :n]

    @property
    def alpha_(self):
        if self._post is None:
            return None
        return np.asarray(self._post.alpha_dual)[: len(self._y_orig)]

    @property
    def K_inv_(self):
        """Inverse of the (noisy) training gram, unpadded.

        The reference keeps this as mutable state
        (``bask/bayesgpr.py:207-208``); here it is derived on demand
        from the Cholesky factor.
        """
        if self._post is None:
            return None
        n = len(self._y_orig)
        L = np.asarray(self._post.L)[:n, :n]
        L_inv = np.linalg.solve(L, np.eye(n))
        return L_inv.T @ L_inv

    @property
    def white_index_(self):
        if self._spec is None:
            return None
        return bk.white_theta_index(self._spec)

    # -- data management ---------------------------------------------------

    def _dtype(self):
        return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

    def _row_cfg(self):
        """Hashable (mesh, nb, unroll) static for the row-sharded jits,
        or ``None`` when row mode is off (or detached after unpickling)."""
        if self.row_mesh is None:
            return None
        return (self.row_mesh, self.row_nb, self.row_unroll)

    def __getstate__(self):
        """Meshes hold device handles and cannot cross processes; pickles
        carry ``row_mesh=None`` (reattach by assigning ``.row_mesh`` on
        the loaded instance — all other row-mode state survives). A
        deferred fused-sample blob is device memory and is dropped too
        (it only ever exists inside ``Optimizer.tell``)."""
        state = self.__dict__.copy()
        if state.get("row_mesh") is not None:
            state["row_mesh"] = None
        state["_pending"] = None
        return state

    def __setstate__(self, state):
        # defaults for payloads pickled before these attributes existed
        state.setdefault("row_mesh", None)
        state.setdefault("row_nb", 256)
        state.setdefault("row_unroll", False)
        state.setdefault("row_grad_method", "adjoint")
        state.setdefault("moves", None)
        state.setdefault("_pending", None)
        state.setdefault("chain_init", "ball")
        state.setdefault("ml2_subsample", None)
        state.setdefault("ml2_objective", "lml")
        self.__dict__.update(state)

    def _set_data(self, X, y, noise_vector):
        X = np.atleast_2d(np.asarray(X, dtype=float))
        y = np.asarray(y, dtype=float).ravel()
        if self.normalize_y:
            self.y_train_mean_ = float(np.mean(y))
            self.y_train_std_ = float(np.std(y)) or 1.0
        else:
            self.y_train_mean_ = 0.0
            self.y_train_std_ = 1.0
        self._X_orig = np.copy(X) if self.copy_X_train else X
        self._y_orig = np.copy(y) if self.copy_X_train else y
        if noise_vector is not None:
            noise_vector = (
                np.asarray(noise_vector, dtype=float)
                / self.y_train_std_**2
            )
        self._noise_vector = noise_vector
        self._upload()

    def _build_padded_data(self, X, y, noise_rows=None):
        """Padded dense ``GPData`` from raw rows, using the estimator's
        normalization / alpha-floor / 64-bucket conventions. ``y`` is
        raw (unnormalized); ``noise_rows`` is an optional per-row
        pre-scaled noise-variance add-on."""
        n, d = X.shape
        n_pad = _bucket(n)
        dt = self._dtype()
        Xp = np.full((n_pad, d), 0.5)
        Xp[:n] = X
        yp = np.zeros(n_pad)
        yp[:n] = (y - self.y_train_mean_) / self.y_train_std_
        # float32 cannot represent the reference's 1e-10 jitter against a
        # unit-scale gram; floor it so near-noise-free problems factor
        # instead of rejecting every MCMC move
        base_alpha = self.alpha
        if dt == jnp.float32:
            base_alpha = max(base_alpha, 1e-6)
        alpha = np.full(n_pad, base_alpha, dtype=float)
        if noise_rows is not None:
            alpha[:n] += noise_rows
        mask = np.arange(n_pad) < n
        return gpc.make_data(
            jnp.asarray(Xp, dtype=dt),
            jnp.asarray(yp, dtype=dt),
            jnp.asarray(alpha, dtype=dt),
            jnp.asarray(mask),
            y_mean=self.y_train_mean_,
            y_std=self.y_train_std_,
        )

    def _upload(self):
        """(Re)build the padded device-side GPData."""
        n = self._X_orig.shape[0]
        noise_rows = None
        if self._noise_vector is not None:
            nv = np.zeros(n)
            nv[: len(self._noise_vector)] += self._noise_vector
            noise_rows = nv
        self._data = self._build_padded_data(
            self._X_orig, self._y_orig, noise_rows
        )

    def _refresh_posterior(self, with_lml: bool = True):
        if self._theta is None or self._data is None:
            return
        data = self._data
        dt = data.X.dtype
        if self.row_mesh is not None:
            # row-sharded mode: no (n_pad, n_pad) factor is ever
            # materialized — predictions re-run the distributed sweep
            # per call; the consensus LML comes from one sweep here.
            self._post = None
            self._post_data = data
            wa, wb, n_warp = self._warp_params()
            self._consensus_lml_ = (
                _row_lml_value(
                    jnp.asarray(self._theta, dtype=dt),
                    data,
                    wa,
                    wb,
                    kernel=self._spec,
                    row_cfg=self._row_cfg(),
                    n_warp=n_warp,
                )
                if with_lml
                else None
            )
            return
        if self.warp_inputs and self.warp_alphas_ is not None:
            n_warp = self._X_orig.shape[1]
            la = jnp.asarray(self.warp_alphas_, dtype=dt)
            lb = jnp.asarray(self.warp_betas_, dtype=dt)
        else:
            n_warp = 0
            la = lb = jnp.zeros(0, dtype=dt)
        post, lml, Xw = aot_call(
            _consensus_state,
            jnp.asarray(self._theta, dtype=dt),
            la,
            lb,
            data,
            kernel=self._spec,
            n_warp=n_warp,
            with_lml=with_lml,
        )
        self._post = post
        self._post_data = data._replace(X=Xw)
        self._consensus_lml_ = lml if with_lml else None

    # -- ML-II warm start --------------------------------------------------

    def _ml2_optimize(self):
        """L-BFGS(-B) maximization of the LML.

        Result is only the MCMC initial position, mirroring the
        reference's use of the inherited skopt fit
        (``bask/bayesgpr.py:78-79``). Default ``optimizer="lbfgs"`` is
        scipy's L-BFGS-B driving jitted value+grad evaluations (exact
        bound handling, one packed device fetch per step);
        ``optimizer="lbfgs-device"`` runs the whole optimization —
        restarts included — inside ONE device program (see
        :func:`_ml2_device`).
        """
        kernel = self._spec
        data = self._data
        bounds = kernel.bounds
        dt = self._dtype()
        row_cfg = self._row_cfg()

        n = self._X_orig.shape[0]
        if self.ml2_subsample is not None and n > self.ml2_subsample:
            # warm start on a random subset through the FAST DENSE path
            # (constructor docstring has the measured motivation: the
            # full-n row-sharded value+grad OOMs one chip at n=32768
            # while the chain itself fits). The subset shares the FULL
            # data's y-normalization so the optimized theta transfers.
            idx = np.sort(
                self.random_state.choice(
                    n, size=self.ml2_subsample, replace=False
                )
            )
            noise_rows = None
            if self._noise_vector is not None:
                nv = np.zeros(n)
                nv[: len(self._noise_vector)] += self._noise_vector
                noise_rows = nv[idx]
            data = self._build_padded_data(
                self._X_orig[idx], self._y_orig[idx], noise_rows
            )
            row_cfg = None

        objective = self.ml2_objective
        if objective == "map" and row_cfg is not None:
            warnings.warn(
                "ml2_objective='map' runs on the dense warm-start path "
                "(its value+grad program materializes the padded gram); "
                "set ml2_subsample to use it in row mode — falling back "
                "to the bare-LML objective for this fit.",
                UserWarning,
            )
            objective = "lml"
        map_priors = (
            self._resolve_priors(None) if objective == "map" else None
        )

        starts = [kernel.theta0]
        for _ in range(self.n_restarts_optimizer):
            starts.append(
                self.random_state.uniform(bounds[:, 0], bounds[:, 1])
            )

        if self.optimizer == "lbfgs-device" and objective == "map":
            warnings.warn(
                "ml2_objective='map' is implemented on the host L-BFGS-B "
                "driver; ignoring optimizer='lbfgs-device' for this fit.",
                UserWarning,
            )
        elif self.optimizer == "lbfgs-device":
            ok_bounds = bool(
                np.isfinite(bounds).all()
                and (bounds[:, 1] > bounds[:, 0]).all()
            )
            if ok_bounds and row_cfg is not None:
                # whole optimization on device; gradients come from the
                # distributed sweep (custom VJP, row_grad_method), so no
                # (n_pad, n_pad) factor is ever materialized
                best = _ml2_device_row(
                    jnp.asarray(np.stack(starts), dtype=dt),
                    data,
                    jnp.asarray(bounds[:, 0], dtype=dt),
                    jnp.asarray(bounds[:, 1], dtype=dt),
                    kernel=kernel,
                    row_cfg=row_cfg,
                    maxiter=60,
                    grad_method=self.row_grad_method,
                )
                return np.asarray(best, dtype=float)
            if not ok_bounds:
                # the sigmoid reparameterization needs finite, non-
                # degenerate bounds; scipy's L-BFGS-B handles both, so
                # fall back loudly rather than optimize garbage
                warnings.warn(
                    "optimizer='lbfgs-device' requires finite, non-"
                    "degenerate hyperparameter bounds; falling back to "
                    "the host L-BFGS-B driver for this fit.",
                    UserWarning,
                )
            else:
                best = aot_call(
                    _ml2_device,
                    jnp.asarray(np.stack(starts), dtype=dt),
                    data,
                    jnp.asarray(bounds[:, 0], dtype=dt),
                    jnp.asarray(bounds[:, 1], dtype=dt),
                    kernel=kernel,
                    maxiter=60,
                )
                return np.asarray(best, dtype=float)

        from scipy.optimize import minimize

        def obj(t):
            if objective == "map":
                vg_dev = _log_post_value_grad(
                    data,
                    jnp.asarray(t, dtype=dt),
                    kernel=kernel,
                    priors=map_priors,
                    n_warp=0,
                )
            elif row_cfg is not None:
                vg_dev = _row_lml_value_grad(
                    jnp.asarray(t, dtype=dt), data,
                    kernel=kernel, row_cfg=row_cfg,
                    grad_method=self.row_grad_method,
                )
            else:
                vg_dev = aot_call(
                    _lml_value_grad,
                    jnp.asarray(t, dtype=dt),
                    data,
                    kernel=kernel,
                )
            vg = np.asarray(vg_dev, dtype=float)
            v, g = float(vg[0]), vg[1:]
            if not np.isfinite(v):
                return 1e25, np.zeros_like(g)
            return v, g

        best_t, best_v = None, np.inf
        for t0 in starts:
            # The ML-II optimum is only the chain's starting point
            # (reference docstring, bask/bayesgpr.py:78-79); cap the
            # iteration count — every objective call is a device
            # round-trip, and the MCMC replaces the estimate anyway.
            res = minimize(
                obj,
                t0,
                jac=True,
                method="L-BFGS-B",
                bounds=bounds,
                options={"maxiter": 60},
            )
            if res.fun < best_v:
                best_t, best_v = res.x, res.fun
        return np.asarray(best_t, dtype=float)

    # -- sampling ----------------------------------------------------------

    def _adapt_warp_priors(self, pair):
        cache = getattr(self, "_warp_prior_cache", None)
        if cache is not None and cache[0] == pair:
            return cache[1]
        a_prior, b_prior = pair

        def warp_prior(log_alphas, log_betas):
            return jnp.sum(
                jax.vmap(a_prior)(log_alphas)
            ) + jnp.sum(jax.vmap(b_prior)(log_betas))

        self._warp_prior_cache = (pair, warp_prior)
        return warp_prior

    def _resolve_priors(self, priors):
        if priors is None:
            if self._priors_cache is None:
                self._priors_cache = tuple(guess_priors(self._spec))
            return self._priors_cache
        if callable(priors):
            return self._traceable_or_host(priors, joint=True)
        return tuple(
            self._traceable_or_host(p, dim=i) for i, p in enumerate(priors)
        )

    def _traceable_or_host(self, p, joint: bool = False, dim=None):
        """Return ``p`` if it traces under JAX, else an exact on-device
        lift for recognized frozen ``scipy.stats`` log-densities, else a
        cached ``pure_callback`` adapter (reference users pass NumPy/
        SciPy priors, ``bask/bayesgpr.py:368-372`` — those must keep
        working, at host-round-trip cost)."""
        shape = (self._spec.n_theta,) if joint else ()
        try:
            jax.eval_shape(p, jax.ShapeDtypeStruct(shape, self._dtype()))
            return p
        except Exception:
            pass
        cache = _HOST_PRIOR_CACHE[joint]
        try:
            cached = cache.get(p)
        except TypeError:  # unhashable callable: no stable cache key
            cached, cache = None, None
        if cached is not None:
            cache.move_to_end(p)
            return cached
        if not joint:
            # e.g. priors=[halfnorm(scale=2).logpdf, ...]: rebuild the
            # exact density in jnp so the chain stays callback-free
            # (works on backends that reject host callbacks).
            from ..utils.scipy_lift import lift_scipy_prior

            lifted = lift_scipy_prior(p)
            if lifted is not None:
                if cache is not None:
                    cache[p] = lifted
                    while len(cache) > _HOST_PRIOR_CACHE_MAX:
                        cache.popitem(last=False)
                return lifted
            if self.host_prior_mode == "interp":
                return self._interp_prior(p, dim)
        warnings.warn(
            "A gp prior is not JAX-traceable and will run through a host "
            "callback each MCMC step — functional, but slow on an accelerator. "
            "Write priors with jax.numpy (see bask_tpu.utils.priors), or "
            "pass a frozen scipy distribution's logpdf directly (common "
            "families are lifted to exact on-device code), for full "
            "on-device speed.",
            UserWarning,
            stacklevel=3,
        )
        wrapper = _host_prior_wrapper(p, joint=joint)
        if cache is not None:
            cache[p] = wrapper
            while len(cache) > _HOST_PRIOR_CACHE_MAX:
                cache.popitem(last=False)
        return wrapper

    def _interp_prior(self, p, dim):
        """Tabulated on-device approximation of an opaque prior
        (``host_prior_mode="interp"``): callback-free, so reference-
        style lambda priors run on backends that reject host callbacks.
        Range = this theta dimension's log-bounds ±
        a margin; linear extrapolation beyond."""
        from ..utils.scipy_lift import tabulate_prior

        spec = self._spec if self._spec is not None else self._user_kernel
        bounds = np.asarray(spec.bounds, dtype=float)
        if dim is not None and 0 <= dim < bounds.shape[0]:
            lo, hi = bounds[dim]
        else:  # pragma: no cover - elementwise priors always carry dim
            lo, hi = -12.0, 12.0
        # infinite log-bounds (fixed-less parameters) cannot be
        # tabulated — clamp to a wide default range instead
        if not np.isfinite(lo):
            lo = -12.0
        if not np.isfinite(hi):
            hi = 12.0
        lo, hi = lo - _INTERP_PRIOR_MARGIN, hi + _INTERP_PRIOR_MARGIN
        try:
            key = (p, lo, hi)
            cached = _INTERP_PRIOR_CACHE.get(key)
        except TypeError:  # unhashable callable
            key, cached = None, None
        if cached is not None:
            _INTERP_PRIOR_CACHE.move_to_end(key)
            return cached
        interp, max_err = tabulate_prior(p, lo, hi)
        warnings.warn(
            "host_prior_mode='interp': a non-traceable gp prior is "
            f"approximated by on-device interpolation over [{lo:.2f}, "
            f"{hi:.2f}] (measured max |Δlog-density| ≈ {max_err:.2e}). "
            "Chain numerics differ slightly from the exact host prior; "
            "use host_prior_mode='callback' on backends with callback "
            "support for exactness.",
            UserWarning,
            stacklevel=4,
        )
        if key is not None:
            _INTERP_PRIOR_CACHE[key] = interp
            while len(_INTERP_PRIOR_CACHE) > _HOST_PRIOR_CACHE_MAX:
                _INTERP_PRIOR_CACHE.popitem(last=False)
        return interp

    def _laplace_positions(self, theta, n_walkers, priors, n_warp):
        """(W, D) cold-start walker positions from the Laplace
        approximation ``N(theta_MAP, H^-1)`` — the ML-II theta is first
        refined to the POSTERIOR mode by a bounded host L-BFGS on the
        exact log-posterior value+grad, then curvature is taken there —
        or ``None`` when the curvature is unusable (caller falls back
        to the reference's 1e-2 ball, ``bask/bayesgpr.py:432-434``
        semantics).

        Per-direction spreads (eigenbasis of the negative log-posterior
        Hessian over the kernel-theta block) are clamped to
        ``[_LAPLACE_STD_MIN, _LAPLACE_STD_MAX]``: flat/negative-
        curvature directions get an overdispersed-but-finite std
        instead of an unbounded one, razor-sharp modes keep at least
        the historical ball width. Warp dims (no computable betainc
        a/b curvature) keep the ball width. Rationale: the ball start
        spends the chain's first ~1000 steps EXPANDING the ensemble to
        posterior scale (the measured transient of every convergence
        ladder); a curvature-scaled start gives the DE moves
        posterior-sized, correlation-aligned difference vectors from
        step 0."""
        theta = np.asarray(theta, dtype=float)
        n_theta = theta.shape[0] - 2 * n_warp
        dt = self._dtype()

        def grad_at(tg):
            """Exact device gradient of the NEGATIVE log posterior over
            the theta block (the same program the MAP refinement
            drives)."""
            x = np.concatenate([tg, theta[n_theta:]])
            vg = np.asarray(
                _log_post_value_grad(
                    self._data,
                    jnp.asarray(x, dtype=dt),
                    kernel=self._spec,
                    priors=priors,
                    n_warp=n_warp,
                ),
                dtype=float,
            )
            return float(vg[0]), vg[1:]

        try:
            # Refine to the POSTERIOR mode before taking curvature: the
            # ML-II theta optimizes the bare LML and often rails
            # against kernel bounds, where the round-flat priors plunge
            # — the Hessian there describes the prior's penalty wall
            # (eigenvalues ~1e11 measured), not the posterior mass, and
            # walkers seeded from it mixed WORSE than the ball (R-hat
            # 8.7 vs 1.1 at 1200 steps on the small ladder shape).
            from scipy.optimize import minimize

            def obj(tg):
                v, g = grad_at(tg)
                if not np.isfinite(v):
                    return 1e25, np.zeros_like(g)
                return v, g

            res = minimize(
                obj,
                theta[:n_theta],
                jac=True,
                method="L-BFGS-B",
                options={"maxiter": 50},
            )
            center = theta.copy()
            if np.isfinite(res.fun) and np.all(np.isfinite(res.x)):
                center[:n_theta] = res.x
            H = np.asarray(
                _log_post_hessian(
                    self._data,
                    jnp.asarray(center, dtype=dt),
                    kernel=self._spec,
                    priors=priors,
                    n_warp=n_warp,
                ),
                dtype=float,
            )
        except Exception as e:  # host-callback priors etc. — fall back
            warnings.warn(
                f"chain_init='laplace' could not evaluate the "
                f"log-posterior Hessian ({type(e).__name__}: {e}); "
                "falling back to the ball init.",
                UserWarning,
                stacklevel=3,
            )
            return None
        if not np.all(np.isfinite(H)):
            return None
        prec = -0.5 * (H + H.T)  # symmetrized negative Hessian
        w, V = np.linalg.eigh(prec)
        with np.errstate(divide="ignore"):
            std = np.where(w > 0, 1.0 / np.sqrt(np.abs(w) + 1e-300), np.inf)
        std = np.clip(std, _LAPLACE_STD_MIN, _LAPLACE_STD_MAX)
        z = self.random_state.randn(n_walkers, theta.shape[0])
        pos = np.empty((n_walkers, theta.shape[0]))
        pos[:, :n_theta] = center[None, :n_theta] + (
            z[:, :n_theta] * std[None, :]
        ) @ V.T
        if n_warp:
            pos[:, n_theta:] = (
                center[None, n_theta:]
                + _LAPLACE_STD_MIN * z[:, n_theta:]
            )
        return pos

    def sample(
        self,
        X=None,
        y=None,
        noise_vector=None,
        n_threads: int = 1,
        n_desired_samples: int = 100,
        n_burnin: int = 0,
        n_thin: int = 1,
        n_walkers_per_thread: int = 100,
        progress: bool = False,
        priors=None,
        warp_priors=None,
        position=None,
        add: bool = False,
        mesh=None,
        warn_rhat="default",
        moves=None,
        until_rhat: Optional[float] = None,
        max_extensions: int = 10,
        extension_steps: Optional[int] = None,
        chain_init: Optional[str] = None,
        _defer_fetch: bool = False,
        _consensus: bool = True,
        **kwargs,
    ):
        """Sample the kernel-hyperparameter posterior on device.

        Semantics follow the reference (``bask/bayesgpr.py:381-548``):
        warm start from ``pos_`` when available, collect
        ``ceil(n_desired_samples / n_walkers)`` post-burnin steps, set
        the consensus model at the geometric median of the chain.

        ``mesh``: optional ``jax.sharding.Mesh`` with a single axis — the
        walker ensemble is sharded across it (data-parallel LML; the
        stretch move's complementary-half gather becomes the only
        collective). Results are identical to the unsharded run.

        A model constructed with ``row_mesh=`` (huge-n mode) instead
        row-shards every walker's factorization over the mesh
        (:mod:`bask_tpu.ops.dist_chol`): no (n_pad, n_pad) gram ever
        materializes on one device. A two-axis row mesh additionally
        data-parallelizes the walkers over its first axis. ``mesh=`` is
        rejected there, and the fused single-program path is skipped
        (it factorizes the consensus posterior in-program).

        ``warn_rhat``: convergence guard — a ``UserWarning`` is raised
        if the retained step-major chain's maximum split R-hat exceeds
        it. ACTIVE BY DEFAULT at the standard 1.1 threshold (the
        reference exposes no diagnostics at all,
        ``bask/bayesgpr.py:510-534``; a silently-unconverged
        hyperposterior is the failure mode this guards). Pass ``None``
        for the reference's silence, or a float for a custom
        threshold. When ``until_rhat`` is given, its own
        convergence/budget warning supersedes this default (an
        explicitly passed ``warn_rhat`` still applies to the final
        chain). Chains with fewer than 4 kept steps (e.g. the default
        ``fit()`` shape of 100 samples over 100 walkers) carry no
        cheap honest estimate and are not judged. Consensus-median
        estimates are usually usable well before strict convergence,
        hence a warning rather than an error.

        ``moves``: optional ensemble move mixture as ``(name, weight)``
        pairs with names in {"stretch", "de", "snooker"} — e.g.
        ``(("de", 0.8), ("snooker", 0.2))``; overrides the constructor
        default for this call. ``None`` (with no constructor default)
        is the historical pure-stretch chain, bit-identical across
        versions. The reference's emcee sampler exposes the same choice
        via ``moves=`` (emcee ≥3; ``bask/bayesgpr.py:510-524`` uses the
        default stretch move).

        ``until_rhat``: sample-to-convergence — after the base run, the
        chain is warm-extended in equal chunks (each re-dispatching the
        same compiled program; ``add=True`` continuation semantics)
        until the maximum split R-hat over the accumulated chain's
        second half drops to this threshold, or ``max_extensions``
        chunks have been added (then a ``UserWarning``). A typical
        threshold is 1.1. Pair it with a DE+snooker move mixture: on
        the 15-D benchmark posterior the default stretch move needs
        ≥7200 steps to converge where ``moves=(("de", 0.8),
        ("snooker", 0.2))`` passes at 4800 (north-star convergence
        ladder). The reference offers no convergence control at all.
        The final consensus (theta/posterior/LML) is recomputed over
        the full accumulated chain after each extension; the geometric
        median is robust to the pre-converged transient, but pass a
        real ``n_burnin`` if the early steps should be excluded from
        ``chain_`` outright.

        ``extension_steps``: per-leg chain length of the ``until_rhat``
        loop, in ensemble steps. Defaults to the base run's own step
        count (``ceil(n_desired_samples / n_walkers)``) — at the
        default shape of 100 samples over 100 walkers that is ONE step
        per leg, so pass something real (the chunk bench.py and the
        Optimizer's cold fit use is 300) whenever the base run is
        short.

        ``chain_init``: cold-start walker placement when no warm
        ensemble exists — ``None`` defers to the constructor's
        ``chain_init`` ("ball" by default: the reference's 1e-2 ball at
        the ML-II point, ``bask/bayesgpr.py:432-434``); ``"laplace"``
        draws the ensemble from the Laplace approximation
        ``N(theta_ML, H^-1)`` (clamped per-direction spreads) so the
        walkers start at posterior scale instead of expanding a tiny
        ball through the first ~1000 steps. Ignored on warm starts and
        with an explicit ``position``; falls back to the ball when the
        curvature is unusable or in row-sharded mode.
        """
        # a stale result from an earlier until_rhat run must not
        # re-trigger Optimizer.tell()'s convergence warning for a refit
        # that never ran the convergence loop; the until_rhat branch
        # below sets a fresh one after its extension loop
        self.until_rhat_result_ = None
        if isinstance(warn_rhat, str):  # "default" sentinel
            # until_rhat's own convergence/budget warning supersedes
            # the default guard (one verdict per call, not two)
            warn_rhat = None if until_rhat is not None else DEFAULT_WARN_RHAT
        if until_rhat is not None:
            # base run first (fused fast path allowed), then warm
            # chunk-extensions — the same pattern bench.py and
            # benchmarks/bench_convergence.py measure, as a library
            # capability. _defer_fetch is ignored here: the extension
            # loop needs host-side chain state after every leg.
            self.sample(
                X, y, noise_vector,
                n_threads=n_threads,
                n_desired_samples=n_desired_samples,
                n_burnin=n_burnin,
                n_thin=n_thin,
                n_walkers_per_thread=n_walkers_per_thread,
                progress=progress,
                priors=priors,
                warp_priors=warp_priors,
                position=position,
                add=add,
                mesh=mesh,
                moves=moves,
                # the extension loop owns the convergence verdict; the
                # per-leg guard would fire spuriously on partial chains
                warn_rhat=None,
                chain_init=chain_init,
                **kwargs,
            )

            def _second_half_rhat():
                steps = self.chain_steps_
                if steps is None or steps.shape[0] < 4:
                    return float("inf")
                from ..utils.diagnostics import split_rhat

                # diagnose the accumulated chain's second half (the
                # bench_convergence rule) once it is long enough for
                # the split estimator; the full chain before that
                half = steps[steps.shape[0] // 2:]
                if half.shape[0] < 4:
                    half = steps
                return float(np.max(split_rhat(half)))

            if extension_steps is not None:
                # translate "steps per leg" into the sample-count
                # convention: n_steps = ceil(samples / n_walkers).
                # Use the ACTUAL ensemble's walker count (the base run
                # has already applied any mesh / two-axis row_mesh
                # rounding, e.g. 100 -> 112 on an 8-device mesh);
                # deriving it from the raw config would under-deliver
                # each leg AND compile a second leg program shape.
                if self.pos_ is not None:
                    n_w_cfg = int(self.pos_.shape[0])
                else:  # pragma: no cover — base run always sets pos_
                    n_w_cfg = max(2, n_threads * n_walkers_per_thread)
                    if n_w_cfg % 2:
                        n_w_cfg += 1
                leg_samples = int(extension_steps) * n_w_cfg
            else:
                leg_samples = n_desired_samples
            extended = False
            for _ in range(max_extensions):
                if _second_half_rhat() <= until_rhat:
                    break
                extended = True
                self.sample(
                    n_threads=n_threads,
                    n_desired_samples=leg_samples,
                    n_burnin=0,
                    n_thin=n_thin,
                    n_walkers_per_thread=n_walkers_per_thread,
                    progress=progress,
                    priors=priors,
                    warp_priors=warp_priors,
                    # continue the ACTUAL ensemble: a position= base run
                    # may carry a walker count different from the
                    # configured one, and a mismatched extension would
                    # silently re-initialize a fresh ball (losing the
                    # chain the convergence criterion is judging)
                    position=self.pos_,
                    add=True,
                    mesh=mesh,
                    moves=moves,
                    warn_rhat=None,
                    # each leg's consensus would be discarded by the
                    # next — compute it ONCE after the loop instead
                    _consensus=False,
                    **kwargs,
                )
            if extended:
                n_gp = self._spec.n_theta
                n_wp = self._X_orig.shape[1] if self.warp_inputs else 0
                self._set_consensus_from_flat(
                    jnp.asarray(self.chain_, dtype=self._dtype()),
                    n_gp, n_wp,
                )
            final_rhat = _second_half_rhat()
            # machine-readable result (Optimizer.tell suppresses GP
            # warnings during refits and re-surfaces this instead)
            self.until_rhat_result_ = {
                "rhat": final_rhat,
                "threshold": until_rhat,
                "converged": bool(final_rhat <= until_rhat),
                "steps": int(self.chain_steps_.shape[0]),
            }
            if final_rhat > until_rhat:
                warnings.warn(
                    f"sample(until_rhat={until_rhat}) did not converge "
                    f"within max_extensions={max_extensions} chunks: max "
                    f"split R-hat {final_rhat:.3f}. Raise max_extensions "
                    "or use a DE+snooker move mixture (moves=\"demix\") "
                    "— see mcmc_diagnostics().",
                    UserWarning,
                    stacklevel=2,
                )
            elif warn_rhat is not None and final_rhat > warn_rhat:
                # warn on the SAME second-half criterion the stopping
                # rule used — the full accumulated chain includes the
                # pre-converged transient and would spuriously warn
                warnings.warn(
                    f"MCMC chain may not be converged: max split R-hat "
                    f"{final_rhat:.3f} exceeds the threshold {warn_rhat}.",
                    UserWarning,
                    stacklevel=2,
                )
            return self
        if self._pending is not None:
            # a previous deferred sample was never finalized (misuse or
            # an aborted tell) — materialize it before starting a new one
            self._finalize_sample()
        if (X is None and self._X_orig is None) or self._spec is None:
            raise ValueError(
                "No data to sample from: pass X and y or call fit first."
            )
        if X is not None:
            self._set_data(X, y, noise_vector)
        elif noise_vector is not None:
            self._noise_vector = (
                np.asarray(noise_vector, dtype=float) / self.y_train_std_**2
            )
            self._upload()

        priors = self._resolve_priors(priors)
        if warp_priors is None:
            warp_priors = wp.default_warp_log_prior
        elif isinstance(warp_priors, (tuple, list)):
            # reference-style pair of per-parameter logpdfs
            # (bask/bayesgpr.py:360-365); adapt to the (alphas, betas)
            # callable convention, caching by identity for jit stability
            warp_priors = self._adapt_warp_priors(tuple(warp_priors))

        n_gp_dim = self._spec.n_theta
        n_warp = self._X_orig.shape[1] if self.warp_inputs else 0
        n_dim = n_gp_dim + 2 * n_warp
        n_walkers = max(2, n_threads * n_walkers_per_thread)
        if n_walkers % 2:
            n_walkers += 1
        row_cfg = self._row_cfg()
        if row_cfg is not None and mesh is not None:
            raise ValueError(
                "mesh= and row_mesh are mutually exclusive: use a "
                "two-axis row_mesh=(walkers, rows) to combine walker "
                "data-parallelism with row-sharded factorizations."
            )
        if mesh is not None:
            # each complementary HALF-ensemble must shard evenly across
            # the mesh: round the walker count up to a multiple of
            # 2 * n_devices (e.g. 100 walkers on 8 devices -> 112)
            m = 2 * int(np.prod(list(mesh.shape.values())))
            n_walkers = -(-n_walkers // m) * m
        if row_cfg is not None and len(self.row_mesh.axis_names) == 2:
            # the stretch move evaluates HALF-ensembles: each half must
            # shard evenly over the row mesh's walker axis
            m = 2 * int(self.row_mesh.shape[self.row_mesh.axis_names[0]])
            n_walkers = -(-n_walkers // m) * m
        if position is not None:
            # an explicit ensemble fixes the walker count: n_steps (and
            # the retention guard) must be computed from the chain that
            # actually runs, not the configured-then-rounded count —
            # e.g. an until_rhat extension leg continuing a 112-walker
            # mesh ensemble would otherwise run ceil(112·S/100) steps
            # and compile a second leg-program shape
            n_walkers = int(np.asarray(position).shape[0])
        n_steps = int(math.ceil(n_desired_samples / n_walkers)) + n_burnin
        # The retained chain must be non-empty: an empty kept set would
        # silently produce a nan geometric-median consensus (-inf LML,
        # nan predictions) — measured as exactly that failure mode on
        # the n=32768 hardware tier before this guard existed. The
        # reference inherits the same hazard from emcee's
        # get_chain(discard=...) slicing (bask/bayesgpr.py:528-534).
        if len(range(n_burnin + n_thin - 1, n_steps, n_thin)) < 1:
            raise ValueError(
                f"Retained chain would be empty: n_desired_samples="
                f"{n_desired_samples} with {n_walkers} walkers gives "
                f"{n_steps - n_burnin} post-burnin step(s), and "
                f"thin={n_thin} keeps none of them. Increase "
                "n_desired_samples or reduce n_burnin/n_thin."
            )

        if position is not None:
            pos = np.asarray(position, dtype=float)
        elif self.pos_ is not None and self.pos_.shape == (n_walkers, n_dim):
            pos = self.pos_
        else:
            theta = np.copy(self._theta)
            bad = ~np.isfinite(theta)
            if bad.any():
                # NB: noise_ must be finite AND positive to be a usable
                # fill (NaN is truthy; log would poison the ensemble)
                usable = (
                    self.noise_
                    and np.isfinite(self.noise_)
                    and self.noise_ > 0
                )
                fill = math.log(self.noise_) if usable else -10.0
                theta[bad] = fill
            if n_warp:
                theta = np.concatenate([theta, np.zeros(2 * n_warp)])
            ci = self.chain_init if chain_init is None else chain_init
            if ci not in ("ball", "laplace"):
                raise ValueError(
                    f"chain_init must be 'ball' or 'laplace', got {ci!r}"
                )
            pos = None
            if ci == "laplace" and row_cfg is None:
                # posterior-curvature-scaled cold start; None (unusable
                # Hessian) falls through to the reference ball. Drawn
                # AFTER the finite checks so the RNG stream is
                # deterministic per outcome. Row-sharded mode keeps the
                # ball: the plain dense Hessian path would materialize
                # the (n, n) gram this mode exists to avoid.
                pos = self._laplace_positions(
                    theta, n_walkers, priors, n_warp
                )
            if pos is None:
                pos = theta[None, :] + 1e-2 * self.random_state.randn(
                    n_walkers, n_dim
                )

        dt = self._dtype()
        key = jax.random.PRNGKey(self.random_state.randint(0, 2**31 - 1))
        pos_dev = jnp.asarray(pos, dtype=dt)
        if mesh is not None:
            from ..parallel.mesh import shard_walkers

            pos_dev = shard_walkers(pos_dev, mesh, axis=mesh.axis_names[0])
        a_scale = float(kwargs.get("a", 2.0))  # stretch-move scale (the
        # reference forwards sampler kwargs to emcee similarly)
        # per-call moves override the constructor default; both are
        # canonicalized to the hashable static form (None = pure stretch)
        moves = (
            _canonical_moves(moves) if moves is not None else self.moves
        )
        if moves == "auto":
            # the library default, resolved now that the ACTUAL walker
            # count is known: the measured-fastest honest sampler (demix
            # — see _canonical_moves) when the ensemble supports its
            # 3-distinct-anchor snooker draws, DE alone when only its
            # 2-anchor draws fit, pure stretch below
            w_act_moves = pos.shape[0]
            if w_act_moves >= 6:
                moves = _MOVE_ALIASES["demix"]
            elif w_act_moves >= 4:
                moves = (("de", 1.0),)
            else:
                moves = None

        use_fused = (
            FUSED_SAMPLE == "on"
            and not progress
            and not add
            # the fused program factorizes the consensus (n, n) posterior
            # in-program — exactly what row-sharded mode must never do
            and row_cfg is None
        )
        if use_fused:
            # ONE device program: chain -> median -> posterior -> LML
            # (the warm-tell hot path; see _fused_sample). A sharded
            # ensemble (mesh=) runs the same program — the walker axis
            # shardings propagate through the scan and the blob concat
            # gathers the host-bound outputs. The add=True / progress
            # cases keep the legacy multi-dispatch path (combined-chain
            # medians, host ticks).
            blob_dev, post, Xw = aot_call(
                _fused_sample,
                self._data,
                pos_dev,
                key,
                kernel=self._spec,
                priors=priors,
                warp_prior=warp_priors,
                n_warp=n_warp,
                n_steps=n_steps,
                a=a_scale,
                discard=n_burnin,
                thin=n_thin,
                mesh=mesh,
                moves=moves,
            )
            # Slice with the ACTUAL ensemble shape: a user-supplied
            # position= may carry a different walker count than the
            # configured n_walkers (e.g. resuming a saved ensemble)
            w_act, d_act = pos_dev.shape
            n_kept = len(range(n_burnin + n_thin - 1, n_steps, n_thin))
            meta = (n_kept, w_act, d_act, n_steps, n_gp_dim, n_warp)
            post_data = self._data._replace(X=Xw)
            if _defer_fetch and not self.warp_inputs:
                # Overlap path: keep the blob ON DEVICE so the caller can
                # dispatch the acquisition program against the
                # device-resident consensus outputs (theta/posterior/
                # chain) and cross device->host in ONE packed fetch
                # (`_finalize_sample`). Host attributes (chain_, pos_,
                # theta, noise_, acceptance, LML) are STALE until
                # finalize — the window is confined to Optimizer.tell,
                # which always finalizes before returning. Warped models
                # are excluded: the candidate grid needs the new warp
                # parameters on the host, which would force a fetch
                # anyway.
                sz_chain, _, off_median, _ = _blob_layout(meta)
                self._pending = {
                    "blob": blob_dev,
                    "meta": meta,
                    # the convergence guard runs at finalize time — the
                    # kept steps are on the host there anyway, so the
                    # default warn_rhat costs the overlap path nothing
                    "warn_rhat": warn_rhat,
                    "theta_dev": blob_dev[off_median : off_median + n_gp_dim],
                    "chain_dev": blob_dev[:sz_chain].reshape(
                        n_kept * w_act, d_act
                    ),
                    # a failed finalize fetch must leave the estimator
                    # fully-old, not mixed — keep the previous posterior
                    # for rollback
                    "prev_post": (self._post, getattr(self, "_post_data", None)),
                }
                # the program already factorized the consensus posterior;
                # the acquisition program consumes it device-resident
                self._post = post
                self._post_data = post_data
                return self
            # ONE fetch for everything host-bound (see _fused_sample).
            # Fetch FIRST: a device failure here must not leave a
            # new posterior installed next to stale host state.
            blob = _fetch(blob_dev)
            self._post = post
            self._post_data = post_data
            self._install_from_blob(blob, meta, warn_rhat)
            return self

        if progress:
            # chunked chain with a host progress tick between chunks
            # (the reference shows emcee's bar, bask/bayesgpr.py:523).
            # Same per-step key array as the fused path -> identical
            # chain; costs a couple of extra (cached) compiles and one
            # device dispatch per chunk.
            from ..utils.progress import get_progress_bar

            keys = jax.random.split(key, n_steps)
            state = aot_call(
                _init_chain_state,
                self._data,
                pos_dev,
                kernel=self._spec,
                priors=priors,
                warp_prior=warp_priors,
                n_warp=n_warp,
                mesh=mesh,
                row_cfg=row_cfg,
            )
            chunk = 8
            parts = []
            pbar = get_progress_bar(True, n_steps)
            i = 0
            while i < n_steps:
                ks = keys[i : i + chunk]
                part, state = aot_call(
                    _run_chain_chunk,
                    self._data,
                    state,
                    ks,
                    kernel=self._spec,
                    priors=priors,
                    warp_prior=warp_priors,
                    n_warp=n_warp,
                    a=a_scale,
                    mesh=mesh,
                    row_cfg=row_cfg,
                    moves=moves,
                )
                parts.append(part)
                i += ks.shape[0]
                pbar.update(int(ks.shape[0]))
            pbar.close()
            chain_dev = jnp.concatenate(parts, axis=0)
            final = state
        else:
            chain_dev, final = aot_call(
                _run_chain,
                self._data,
                pos_dev,
                key,
                kernel=self._spec,
                priors=priors,
                warp_prior=warp_priors,
                n_warp=n_warp,
                n_steps=n_steps,
                a=a_scale,
                mesh=mesh,
                row_cfg=row_cfg,
                moves=moves,
            )
        flat = flatten_chain(chain_dev, discard=n_burnin, thin=n_thin)
        # same kept-step selection as flatten_chain (emcee semantics)
        kept_steps = np.asarray(chain_dev[n_burnin + n_thin - 1 :: n_thin])
        homogeneous_add = False
        if add and self.chain_ is not None:
            if (
                self.chain_steps_ is not None
                and self.chain_steps_.shape[1:] == kept_steps.shape[1:]
                and self.chain_steps_.size == self.chain_.size
            ):
                # homogeneous walker count: keep ONE step-major array;
                # the flat chain is a zero-copy view of it
                homogeneous_add = True
                kept_steps = np.concatenate([self.chain_steps_, kept_steps])
                self.chain_steps_ = kept_steps
                self.chain_ = kept_steps.reshape(-1, kept_steps.shape[-1])
            else:
                # walker count changed across add: the flat chain keeps
                # both runs (reference semantics), step-major state only
                # the latest run
                self.chain_ = np.concatenate(
                    [self.chain_, np.asarray(flat)]
                )
                self.chain_steps_ = kept_steps
            flat = jnp.asarray(self.chain_, dtype=dt)
        else:
            self.chain_steps_ = kept_steps
            self.chain_ = kept_steps.reshape(-1, kept_steps.shape[-1])
        self.pos_ = np.asarray(final.pos)
        _maybe_warn_rhat(self.chain_steps_, warn_rhat)
        # the ACTUAL walker count can differ from the configured one when
        # the caller supplied position= (e.g. resuming a saved ensemble)
        w_act = self.chain_steps_.shape[1]
        if homogeneous_add and getattr(self, "n_proposals_", 0):
            # accumulate across homogeneous add=True runs so diagnostics'
            # acceptance describes the same combined chain as
            # chain_steps_; when the walker count changed, chain_steps_
            # keeps only the latest run, so the counters reset with it
            self.n_accepted_ += int(final.accepted)
            self.n_proposals_ += n_steps * w_act
        else:
            self.n_accepted_ = int(final.accepted)
            self.n_proposals_ = n_steps * w_act

        if _consensus:
            self._set_consensus_from_flat(flat, n_gp_dim, n_warp)
        return self

    def _set_consensus_from_flat(self, flat, n_gp_dim, n_warp):
        """Geometric-median consensus + posterior refresh + LML over a
        flat chain. Tail of the legacy sample path; also called ONCE by
        the ``until_rhat`` extension loop after it converges (the
        intermediate legs skip it — each leg's consensus would be
        discarded by the next)."""
        median = np.asarray(geometric_median(flat))
        if self.warp_inputs:
            self.warp_alphas_ = median[n_gp_dim : n_gp_dim + n_warp]
            self.warp_betas_ = median[n_gp_dim + n_warp :]
        theta_med = median[:n_gp_dim]
        widx = self.white_index_
        if widx is not None:
            self.noise_ = float(np.exp(theta_med[widx]))
        self.theta = theta_med  # triggers posterior refresh, which also
        # evaluates the consensus LML in the same program
        self.log_marginal_likelihood_value_ = float(self._consensus_lml_)
        return self

    # -- deferred-fetch plumbing (warm-tell overlap) -----------------------

    def _install_from_blob(self, blob, meta, warn_rhat=None):
        """Unpack the fused-sample blob (host numpy) into estimator state.

        Shared by the immediate fused path and ``_finalize_sample`` so
        the deferred (single combined fetch) and non-deferred paths
        install bit-identical state.
        """
        n_kept, w_act, d_act, n_steps, n_gp_dim, n_warp = meta
        sz_chain, sz_pos, off_median, _ = _blob_layout(meta)
        kept_steps = blob[:sz_chain].reshape(n_kept, w_act, d_act)
        self.chain_steps_ = kept_steps
        self.chain_ = kept_steps.reshape(-1, kept_steps.shape[-1])
        self.pos_ = blob[sz_chain:off_median].reshape(w_act, d_act)
        median = blob[off_median : off_median + d_act]
        accepted = int(round(float(blob[off_median + d_act]))) * 4096
        accepted += int(round(float(blob[off_median + d_act + 1])))
        lml = float(blob[off_median + d_act + 2])
        _maybe_warn_rhat(kept_steps, warn_rhat)
        self.n_accepted_ = accepted
        self.n_proposals_ = n_steps * w_act
        if self.warp_inputs:
            self.warp_alphas_ = median[n_gp_dim : n_gp_dim + n_warp]
            self.warp_betas_ = median[n_gp_dim + n_warp :]
        theta_med = median[:n_gp_dim]
        widx = self.white_index_
        if widx is not None:
            self.noise_ = float(np.exp(theta_med[widx]))
        self._theta = np.asarray(theta_med, dtype=float)
        self._consensus_lml_ = lml
        self.log_marginal_likelihood_value_ = lml

    def _finalize_sample(self, extra_dev=None, extra_shape=None):
        """Materialize a deferred fused sample (ONE device->host fetch).

        ``extra_dev`` optionally rides along: a second device program's
        output (the fused acquisition values) is packed onto the blob by
        a trivial concat program so the entire warm tell costs a single
        device->host round trip instead of two. Returns the unpacked
        extra (host numpy, reshaped to ``extra_shape``) or ``None``.

        If the fetch itself fails (device error, failed async chain
        program), the previously installed posterior is rolled back so
        the estimator is left fully-old rather than mixed.
        """
        p = self._pending
        if p is None:
            return None
        self._pending = None
        blob_dev, meta = p["blob"], p["meta"]
        try:
            if extra_dev is None:
                blob, extra = _fetch(blob_dev), None
            else:
                packed = _fetch(_pack_fetch(blob_dev, extra_dev))
                size = _blob_layout(meta)[3]
                blob, extra = packed[:size], packed[size:]
        except Exception:
            self._post, self._post_data = p["prev_post"]
            raise
        self._install_from_blob(blob, meta, p.get("warn_rhat"))
        if extra is not None and extra_shape is not None:
            extra = extra.reshape(extra_shape)
        return extra

    def _theta_device(self, dt):
        """Consensus theta as a device array (no host fetch while a
        deferred sample is pending)."""
        if self._pending is not None:
            return self._pending["theta_dev"]
        return jnp.asarray(self._theta, dtype=dt)

    def _n_chain_rows(self):
        if self._pending is not None:
            return int(self._pending["chain_dev"].shape[0])
        return len(self.chain_)

    def _chain_rows_device(self, idx, dt):
        """Selected hyperposterior rows as a device array.

        While a deferred sample is pending the gather happens on device
        (the chain never crosses to the host); otherwise the usual host
        gather + upload.
        """
        if self._pending is not None:
            return self._pending["chain_dev"][jnp.asarray(idx)]
        return jnp.asarray(self.chain_[idx], dtype=dt)

    def mcmc_diagnostics(self, c: float = 5.0) -> dict:
        """Convergence diagnostics of the last hyperposterior chain.

        Returns per-dimension split R-hat, effective sample size, and
        emcee-style integrated autocorrelation time (Sokal window
        constant ``c``), plus the acceptance rate. The reference keeps
        only the flat chain and exposes nothing comparable
        (``bask/bayesgpr.py:510-534``); see
        :mod:`bask_tpu.utils.diagnostics` for estimator details and the
        ensemble-sampler caveat.
        """
        if self.chain_steps_ is None:
            raise ValueError(
                "No chain available: call fit()/sample() first."
            )
        if self.chain_steps_.shape[0] < 4:
            raise ValueError(
                "Need at least 4 post-burnin steps for diagnostics "
                f"(have {self.chain_steps_.shape[0]}); increase "
                "n_desired_samples or reduce thinning."
            )
        from ..utils.diagnostics import (
            effective_sample_size,
            integrated_autocorr_time,
            split_rhat,
        )

        x = self.chain_steps_
        n_prop = getattr(self, "n_proposals_", 0)
        return {
            "rhat": split_rhat(x),
            "ess": effective_sample_size(x),
            "autocorr_time": integrated_autocorr_time(x, c=c),
            "acceptance": (
                getattr(self, "n_accepted_", 0) / n_prop if n_prop else None
            ),
            "n_steps": int(x.shape[0]),
            "n_walkers": int(x.shape[1]),
        }

    def fit(
        self,
        X,
        y,
        noise_vector=None,
        n_threads: int = 1,
        n_desired_samples: int = 100,
        n_burnin: int = 10,
        n_walkers_per_thread: int = 100,
        progress: bool = True,
        priors=None,
        warp_priors=None,
        position=None,
        **kwargs,
    ):
        """ML-II warm start + hyperposterior sampling (reference
        ``bask/bayesgpr.py:550-620``)."""
        # Rebuild kernel_ from the pristine user kernel each fit
        if self.noise == "gaussian" and bk.white_theta_index(
            self._user_kernel
        ) is None:
            self._spec = self._user_kernel + bk.WhiteKernel(
                1.0, (1e-5, 1e5)
            )
        else:
            self._spec = self._user_kernel
        self._priors_cache = None
        self._set_data(X, y, noise_vector)

        if self.optimizer is not None:
            theta_ml = self._ml2_optimize()
        else:
            theta_ml = self._spec.theta0
        self._theta = theta_ml
        widx = self.white_index_
        if widx is not None:
            self.noise_ = float(np.exp(theta_ml[widx]))

        return self.sample(
            n_desired_samples=n_desired_samples,
            n_burnin=n_burnin,
            n_walkers_per_thread=n_walkers_per_thread,
            n_threads=n_threads,
            progress=progress,
            priors=priors,
            warp_priors=warp_priors,
            position=position,
            add=False,
            **kwargs,
        )

    # -- prediction --------------------------------------------------------

    @contextmanager
    def noise_set_to_zero(self):
        """Context manager: predictions exclude the Gaussian noise term.

        Functional analogue of the reference context manager
        (``bask/bayesgpr.py:318-336``); the factorized posterior state is
        left untouched.
        """
        prev = self._noise_zero
        self._noise_zero = True
        try:
            yield self
        finally:
            self._noise_zero = prev

    def _is_fitted(self) -> bool:
        if self.row_mesh is not None:
            # row-sharded mode keeps no factorized posterior; fitted
            # means a consensus theta exists over uploaded data
            return self._theta is not None and self._data is not None
        return self._post is not None and self._theta is not None

    def _prior_kernel_theta(self):
        """(kernel, theta0) of the GP *prior* for unfitted predictions.

        Matches the sklearn GPR base the reference inherits
        (``bask/bayesgpr.py:622``; sklearn predicts from the prior before
        ``fit``): the user kernel at its initial hyperparameters — the
        WhiteKernel is only appended at fit time, so the prior excludes
        it, exactly as upstream.
        """
        kernel = self._user_kernel
        return kernel, jnp.asarray(kernel.theta0, dtype=self._dtype())

    def _prior_predict(
        self,
        X,
        return_std=False,
        return_cov=False,
        return_mean_grad=False,
        return_std_grad=False,
    ):
        """Predict from the GP prior (unfitted model): mean 0, variance
        from the kernel diagonal — sklearn GPR semantics."""
        kernel, theta = self._prior_kernel_theta()
        m = X.shape[0]
        results = [np.zeros(m)]
        if return_cov:
            results.append(np.asarray(kernel.eval(theta, X)))
        elif return_std:
            var = jnp.maximum(kernel.diag(theta, X), 0.0)
            results.append(np.asarray(jnp.sqrt(var)))
        if return_mean_grad:
            results.append(np.zeros_like(np.asarray(X)))
        if return_std_grad:
            # autodiff of sqrt(diag k(x, x)); identically zero for the
            # stationary kernel family but exact for any spec
            def std_one(x):
                v = jnp.maximum(kernel.diag(theta, x[None, :])[0], 1e-30)
                return jnp.sqrt(v)

            results.append(np.asarray(jax.vmap(jax.grad(std_one))(X)))
        if len(results) == 1:
            return results[0]
        return tuple(results)

    def _theta_diag(self):
        t = jnp.asarray(self._theta, dtype=self._dtype())
        if self._noise_zero:
            return gpc.noise_free_theta(self._spec, t, self.white_index_)
        return t

    def _warp_params(self):
        dt = self._dtype()
        if self.warp_inputs and self.warp_alphas_ is not None:
            return (
                jnp.asarray(self.warp_alphas_, dtype=dt),
                jnp.asarray(self.warp_betas_, dtype=dt),
                self._X_orig.shape[1],
            )
        d = self._X_orig.shape[1] if self._X_orig is not None else 1
        return jnp.zeros(d, dtype=dt), jnp.zeros(d, dtype=dt), 0

    def predict(
        self,
        X,
        return_std: bool = False,
        return_cov: bool = False,
        return_mean_grad: bool = False,
        return_std_grad: bool = False,
    ):
        X = jnp.asarray(np.atleast_2d(X), dtype=self._dtype())
        if not self._is_fitted():
            # sklearn-GPR semantics the reference inherits
            # (bask/bayesgpr.py:622): predict from the GP prior
            return self._prior_predict(
                X,
                return_std=return_std,
                return_cov=return_cov,
                return_mean_grad=return_mean_grad,
                return_std_grad=return_std_grad,
            )
        if self.warp_inputs:
            from ..utils.validation import validate_zeroone

            validate_zeroone(np.asarray(X))
        if self.row_mesh is not None:
            with_grad = return_mean_grad or return_std_grad
            if with_grad and return_cov:
                raise ValueError(
                    "return_cov cannot be combined with prediction "
                    "gradients in row-sharded mode"
                )
            wa, wb, n_warp = self._warp_params()
            out = _row_predict(
                jnp.asarray(self._theta, dtype=self._dtype()),
                self._theta_diag(),
                self._data,
                X,
                wa,
                wb,
                kernel=self._spec,
                row_cfg=self._row_cfg(),
                return_cov=return_cov,
                with_grad=with_grad,
                n_warp=n_warp,
            )
            if not with_grad:
                mean, unc = out
            else:
                # gradients ride the same distributed sweep as extra
                # forward-solve columns (dist_chol.row_sharded_predict)
                mean, unc, mg, sg = out
            results = [np.asarray(mean)]
            if return_std or return_cov:
                results.append(np.asarray(unc))
            if return_mean_grad:
                results.append(np.asarray(mg))
            if return_std_grad:
                results.append(np.asarray(sg))
            if len(results) == 1:
                return results[0]
            return tuple(results)
        wa, wb, n_warp = self._warp_params()
        out = aot_call(
            _predict,
            jnp.asarray(self._theta, dtype=self._dtype()),
            self._theta_diag(),
            self._post,
            self._post_data,
            X,
            wa,
            wb,
            kernel=self._spec,
            n_warp=n_warp,
            return_std=return_std,
            return_cov=return_cov,
        )
        if return_std or return_cov:
            mean, unc = np.asarray(out[0]), np.asarray(out[1])
        else:
            mean, unc = np.asarray(out), None
        results = [mean]
        if return_std or return_cov:
            results.append(unc)
        if return_mean_grad or return_std_grad:
            mg, sg = aot_call(
                _predict_grads,
                self._theta_diag(),
                self._post,
                self._post_data,
                X,
                wa,
                wb,
                kernel=self._spec,
                n_warp=n_warp,
            )
            if return_mean_grad:
                results.append(np.asarray(mg))
            if return_std_grad:
                results.append(np.asarray(sg))
        if len(results) == 1:
            return results[0]
        return tuple(results)

    def _prior_sample_y(self, X, n_samples, random_state):
        """Joint draws from the GP prior (unfitted model)."""
        kernel, theta = self._prior_kernel_theta()
        if isinstance(random_state, np.random.RandomState):
            seed = random_state.randint(0, 2**31 - 1)
        elif random_state is None:
            seed = self.random_state.randint(0, 2**31 - 1)
        else:
            seed = int(random_state)
        X = jnp.asarray(np.atleast_2d(X), dtype=self._dtype())
        cov = kernel.eval(theta, X)
        evals, evecs = jnp.linalg.eigh(cov)
        factor = evecs * jnp.sqrt(jnp.maximum(evals, 0.0))[None, :]
        z = jax.random.normal(
            jax.random.PRNGKey(seed), (X.shape[0], n_samples), dtype=cov.dtype
        )
        return np.asarray(factor @ z)

    def sample_y(
        self,
        X,
        sample_mean: bool = False,
        noise: bool = False,
        n_samples: int = 1,
        random_state=0,
    ):
        """Draw function realizations: (n_points, n_samples).

        ``sample_mean=True`` samples from the consensus GP;
        otherwise each draw uses a random hyperposterior chain row
        (reference ``bask/bayesgpr.py:637-718``) — here vmapped into one
        fused pass instead of a Python loop.

        On an *unfitted* model, draws come from the GP prior (mean 0,
        covariance from the user kernel at theta0) — the sklearn-GPR
        behavior the reference inherits.
        """
        if not self._is_fitted():
            return self._prior_sample_y(X, n_samples, random_state)
        if isinstance(random_state, np.random.RandomState):
            seed = random_state.randint(0, 2**31 - 1)
        elif random_state is None:
            seed = self.random_state.randint(0, 2**31 - 1)
        else:
            seed = int(random_state)
        key = jax.random.PRNGKey(seed)
        dt = self._dtype()
        X = jnp.asarray(np.atleast_2d(X), dtype=dt)
        widx = self.white_index_
        if self.row_mesh is not None:
            cfg = self._row_cfg()
            theta = jnp.asarray(self._theta, dtype=dt)
            if sample_mean:
                wa, wb, n_warp = self._warp_params()
                td = theta if noise else gpc.noise_free_theta(
                    self._spec, theta, widx
                )
                return np.asarray(
                    _row_sample_y(
                        theta, td, self._data, X, key, wa, wb,
                        kernel=self._spec, row_cfg=cfg,
                        n_samples=n_samples, n_warp=n_warp,
                    )
                )
            # marginalized draws: each sample's theta is a chain row, so
            # each needs its OWN distributed sweep — a host loop of
            # n_samples device programs. Honest cost of marginalization
            # at n beyond one chip; prefer sample_mean=True or small
            # n_samples here.
            n_warp = self._X_orig.shape[1] if self.warp_inputs else 0
            rs = np.random.RandomState(seed)
            idx = rs.choice(len(self.chain_), size=n_samples, replace=True)
            keys = jax.random.split(key, n_samples)
            cols = []
            for i, ki in zip(idx, keys):
                row = jnp.asarray(self.chain_[i], dtype=dt)
                if n_warp:
                    # each draw warps with ITS row's warp parameters,
                    # matching the dense marginal path's semantics
                    th, wa_i, wb_i = wp.split_warp_params(row, n_warp)
                else:
                    th, wa_i, wb_i = row, None, None
                td = th if noise else gpc.noise_free_theta(
                    self._spec, th, widx
                )
                draw = _row_sample_y(
                    th, td, self._data, X, ki, wa_i, wb_i,
                    kernel=self._spec, row_cfg=cfg, n_samples=1,
                    n_warp=n_warp,
                )
                cols.append(np.asarray(draw)[:, 0])
            return np.stack(cols, axis=1)
        if sample_mean:
            wa, wb, n_warp = self._warp_params()
            Xq = wp.warp(X, wa, wb) if n_warp else X
            theta = jnp.asarray(self._theta, dtype=dt)
            theta_diag = theta if noise else gpc.noise_free_theta(
                self._spec, theta, widx
            )
            out = aot_call(
                _sample_y_mean,
                theta_diag,
                self._post,
                self._post_data,
                Xq,
                key,
                kernel=self._spec,
                n_samples=n_samples,
            )
            return np.asarray(out)
        rs = np.random.RandomState(seed)
        idx = rs.choice(len(self.chain_), size=n_samples, replace=True)
        rows = jnp.asarray(self.chain_[idx], dtype=dt)
        n_warp = self._X_orig.shape[1] if self.warp_inputs else 0
        out = aot_call(
            _sample_y_marginal,
            rows,
            self._data,
            X,
            key,
            kernel=self._spec,
            n_warp=n_warp,
            include_noise=bool(noise),
            white_idx=widx,
            n_total=n_samples,
        )
        return np.asarray(out).T

    def sample_y_pathwise(
        self,
        X,
        n_samples: int = 1,
        random_state=0,
        n_features: int = 1024,
    ):
        """Scalable posterior draws via pathwise (decoupled) sampling.

        Unlike :meth:`sample_y`, cost is linear in the number of query
        points (no query-query Cholesky), so tens of thousands of
        candidates are fine — the Thompson batch-ask path. Uses the
        consensus GP. Requires the canonical Constant*(Matern|RBF)
        [+White] kernel family. Returns (n_points, n_samples).
        """
        from ..ops.kernels import match_fusable
        from .pathwise import pathwise_samples

        spec = match_fusable(self._spec)
        if spec is None:
            raise NotImplementedError(
                "Pathwise sampling requires a Constant*(Matern|RBF)[+White] "
                "kernel; use sample_y instead."
            )
        if isinstance(random_state, np.random.RandomState):
            seed = random_state.randint(0, 2**31 - 1)
        elif random_state is None:
            seed = self.random_state.randint(0, 2**31 - 1)
        else:
            seed = int(random_state)
        dt = self._dtype()
        Xq = jnp.asarray(np.atleast_2d(X), dtype=dt)
        wa, wb, n_warp = self._warp_params()
        if n_warp:
            Xq = wp.warp(Xq, wa, wb)
        out = pathwise_samples(
            spec,
            jnp.asarray(self._theta, dtype=dt),
            self._post_data,
            self._post.L,
            Xq,
            jax.random.PRNGKey(seed),
            n_samples,
            n_features,
        )
        return np.asarray(out) * self.y_train_std_ + self.y_train_mean_

    def thompson_argmin_pathwise(
        self,
        X,
        n_samples: int = 1,
        top_k: int = 8,
        random_state=0,
        n_features: int = 1024,
        sample_mean: bool = True,
    ):
        """Per-draw top-k minimizer indices, computed on device.

        For huge candidate grids the (n_cand, n_samples) draw matrix
        never leaves the device — only the (n_samples, top_k) index
        table does. This is the batch-ask hot path.

        ``sample_mean=True`` draws from the consensus GP;
        ``sample_mean=False`` gives each draw its own hyperposterior
        chain row (kernel theta + warp params), matching the reference's
        per-draw ``sample_y`` semantics at pathwise cost.
        """
        from ..ops.kernels import match_fusable
        from .pathwise import pathwise_topk_hyper

        spec = match_fusable(self._spec)
        if spec is None:
            raise NotImplementedError(
                "Pathwise sampling requires a Constant*(Matern|RBF)[+White] "
                "kernel."
            )
        if isinstance(random_state, np.random.RandomState):
            seed = random_state.randint(0, 2**31 - 1)
        elif random_state is None:
            seed = self.random_state.randint(0, 2**31 - 1)
        else:
            seed = int(random_state)
        dt = self._dtype()
        Xq = jnp.asarray(np.atleast_2d(X), dtype=dt)
        n_warp = self._X_orig.shape[1] if self.warp_inputs else 0
        if sample_mean:
            wa, wb, nw = self._warp_params()
            if nw:
                Xq = wp.warp(Xq, wa, wb)
            idx = aot_call(
                _pathwise_topk,
                jnp.asarray(self._theta, dtype=dt),
                self._post_data,
                self._post.L,
                Xq,
                jax.random.PRNGKey(seed),
                spec=spec,
                n_samples=n_samples,
                n_features=n_features,
                k=top_k,
            )
            return np.asarray(idx)
        rs = np.random.RandomState(seed)
        rows = jnp.asarray(
            self.chain_[rs.choice(len(self.chain_), n_samples, replace=True)],
            dtype=dt,
        )
        idx = pathwise_topk_hyper(
            spec,
            rows,
            self._data,
            Xq,
            jax.random.PRNGKey(seed),
            n_warp,
            n_features,
            top_k,
        )
        return np.asarray(idx)

    # -- misc --------------------------------------------------------------

    def log_marginal_likelihood(self, theta=None, clone_kernel=True):
        if theta is None:
            return self.log_marginal_likelihood_value_
        data = getattr(self, "_post_data", None)
        if data is None:
            data = self._data
        if self.row_mesh is not None:
            wa, wb, n_warp = self._warp_params()
            return float(
                _row_lml_value(
                    jnp.asarray(theta, dtype=self._dtype()),
                    data,
                    wa,
                    wb,
                    kernel=self._spec,
                    row_cfg=self._row_cfg(),
                    n_warp=n_warp,
                )
            )
        return float(
            aot_call(
                _lml_value,
                jnp.asarray(theta, dtype=self._dtype()),
                data,
                kernel=self._spec,
            )
        )

    # -- public warper API (reference bask/bayesgpr.py:249-316) ------------

    def create_warpers(self, alphas, betas):
        """Set the Beta-CDF warp parameters (log-space), as the reference's
        ``create_warpers`` does (``bask/bayesgpr.py:298-316``).

        The per-column warper/unwarper callables are exposed through the
        derived :attr:`warpers_` / :attr:`unwarpers_` properties; call
        :meth:`rewarp` (and set :attr:`theta`) afterwards to refresh the
        model, mirroring reference usage.
        """
        if not self.warp_inputs:
            return
        self.warp_alphas_ = np.copy(np.asarray(alphas, dtype=float))
        self.warp_betas_ = np.copy(np.asarray(betas, dtype=float))

    def rewarp(self):
        """Re-apply warping to the training data after the warp parameters
        changed (reference ``bask/bayesgpr.py:284-296``); refreshes the
        factorized posterior when a consensus theta exists."""
        if self.warp_inputs and self.warp_alphas_ is not None:
            self._refresh_posterior(with_lml=False)

    @property
    def warpers_(self):
        """Per-column warp callables (Beta CDFs), reference-compatible."""
        if not self.warp_inputs or self.warp_alphas_ is None:
            return None
        import scipy.stats as st

        return [
            st.beta(a=np.exp(a), b=np.exp(b)).cdf
            for a, b in zip(self.warp_alphas_, self.warp_betas_)
        ]

    @property
    def unwarpers_(self):
        """Per-column unwarp callables (Beta PPFs), reference-compatible."""
        if not self.warp_inputs or self.warp_alphas_ is None:
            return None
        import scipy.stats as st

        return [
            st.beta(a=np.exp(a), b=np.exp(b)).ppf
            for a, b in zip(self.warp_alphas_, self.warp_betas_)
        ]

    def warp(self, X):
        if self.warp_inputs and self.warp_alphas_ is not None:
            return np.asarray(
                wp.warp(
                    jnp.asarray(X, dtype=self._dtype()),
                    jnp.asarray(self.warp_alphas_, dtype=self._dtype()),
                    jnp.asarray(self.warp_betas_, dtype=self._dtype()),
                )
            )
        return X

    def unwarp(self, X):
        if self.warp_inputs and self.warp_alphas_ is not None:
            return np.asarray(
                wp.unwarp(
                    jnp.asarray(X, dtype=self._dtype()),
                    jnp.asarray(self.warp_alphas_, dtype=self._dtype()),
                    jnp.asarray(self.warp_betas_, dtype=self._dtype()),
                )
            )
        return X
