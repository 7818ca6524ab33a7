"""On-device affine-invariant ensemble MCMC (stretch move).

The reference drives emcee's ``EnsembleSampler`` with a Python
log-probability that does one Cholesky per walker per step, serially
(reference ``bask/bayesgpr.py:510-524``; the hot loop flagged in
SURVEY.md §3.1). Here the whole ensemble advances inside one
``lax.scan``:

* each step does the two complementary-half stretch-move updates
  (Goodman & Weare 2010, the same algorithm family emcee implements),
* the log-probability is evaluated for all active walkers at once via
  ``vmap`` — one *batched* Cholesky instead of W serial ones,
* the walker axis is shardable: under a ``jax.sharding.Mesh`` the
  batched log-prob is pure data parallelism, and the only cross-walker
  communication is the complementary-half gather (an all-gather of a
  (W/2, D) matrix — bytes, not megabytes — over the device interconnect).

Detailed-balance notes: the stretch factor is z = ((a-1)u + 1)^2 / a
with density g(z) ∝ 1/sqrt(z) on [1/a, a]; the acceptance factor is
z^(D-1) * exp(lp(prop) - lp(curr)). Proposals with -inf log-prob are
rejected branchlessly (NaN-safe comparison).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = [
    "EnsembleState",
    "init_ensemble",
    "run_ensemble",
    "stretch_step",
    "de_step",
    "snooker_step",
    "make_step_fn",
    "validate_walker_count",
]


class EnsembleState(NamedTuple):
    pos: jnp.ndarray  # (W, D) walker positions
    log_prob: jnp.ndarray  # (W,)
    accepted: jnp.ndarray  # scalar int: total accepted moves


def init_ensemble(log_prob_fn: Callable, pos: jnp.ndarray) -> EnsembleState:
    """``log_prob_fn`` maps a walker batch (W, D) -> (W,).

    Batched (not per-walker) so implementations can use one fused gram +
    batched factorization for the whole half-ensemble; wrap a scalar
    function with ``jax.vmap`` if needed.
    """
    lp = log_prob_fn(pos)
    return EnsembleState(
        pos=pos,
        log_prob=lp,
        accepted=jnp.zeros((), dtype=jnp.int32),
    )


def _half_update(log_prob_fn, active, lp_active, other, key, a, ndim):
    """Stretch-move update of ``active`` walkers against ``other``."""
    h = active.shape[0]
    k_partner, k_z, k_accept = jax.random.split(key, 3)
    partners = jax.random.randint(k_partner, (h,), 0, other.shape[0])
    u = jax.random.uniform(k_z, (h,), dtype=active.dtype)
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    anchor = other[partners]  # cross-half gather (all-gather when sharded)
    prop = anchor + z[:, None] * (active - anchor)
    lp_prop = log_prob_fn(prop)
    log_ratio = (ndim - 1.0) * jnp.log(z) + lp_prop - lp_active
    accept = jnp.log(jax.random.uniform(k_accept, (h,), dtype=active.dtype)) < log_ratio
    new_active = jnp.where(accept[:, None], prop, active)
    new_lp = jnp.where(accept, lp_prop, lp_active)
    return new_active, new_lp, jnp.sum(accept).astype(jnp.int32)


def stretch_step(
    log_prob_fn: Callable, state: EnsembleState, key, a: float = 2.0
) -> EnsembleState:
    """One full ensemble step (both complementary halves)."""
    W, D = state.pos.shape
    half = W // 2
    k0, k1 = jax.random.split(key)

    first, second = state.pos[:half], state.pos[half:]
    lp_first, lp_second = state.log_prob[:half], state.log_prob[half:]

    first, lp_first, acc0 = _half_update(
        log_prob_fn, first, lp_first, second, k0, a, D
    )
    second, lp_second, acc1 = _half_update(
        log_prob_fn, second, lp_second, first, k1, a, D
    )
    return EnsembleState(
        pos=jnp.concatenate([first, second]),
        log_prob=jnp.concatenate([lp_first, lp_second]),
        accepted=state.accepted + acc0 + acc1,
    )


def _de_half_update(
    log_prob_fn, active, lp_active, other, key, gamma, sigma
):
    """Differential-evolution update of ``active`` against ``other``.

    ter Braak (2006) / emcee's ``DEMove``: each active walker proposes
    x' = x + gamma·(x_j − x_k) + sigma·N(0, I) with j ≠ k drawn from the
    complementary half. The (j, k) pair is exchangeable and the noise is
    symmetric, so the proposal density is symmetric and the acceptance
    factor is the bare posterior ratio. The difference vectors inherit
    the ensemble's own covariance — in correlated, high-D posteriors
    this mixes far faster than the isotropic stretch move (the binding
    constraint measured in round 3: R-hat 1.8 at 300 steps).
    """
    h, D = active.shape
    k_j, k_k, k_eps, k_accept = jax.random.split(key, 4)
    c = other.shape[0]
    j = jax.random.randint(k_j, (h,), 0, c)
    k2 = jax.random.randint(k_k, (h,), 0, c - 1)
    k2 = k2 + (k2 >= j)  # distinct second index
    diff = other[j] - other[k2]  # cross-half gather (all-gather sharded)
    eps = sigma * jax.random.normal(k_eps, (h, D), dtype=active.dtype)
    prop = active + gamma * diff + eps
    lp_prop = log_prob_fn(prop)
    log_ratio = lp_prop - lp_active
    accept = (
        jnp.log(jax.random.uniform(k_accept, (h,), dtype=active.dtype))
        < log_ratio
    )
    new_active = jnp.where(accept[:, None], prop, active)
    new_lp = jnp.where(accept, lp_prop, lp_active)
    return new_active, new_lp, jnp.sum(accept).astype(jnp.int32)


def de_step(
    log_prob_fn: Callable,
    state: EnsembleState,
    key,
    gamma0: float | None = None,
    sigma: float = 1e-5,
    jump_prob: float = 0.1,
) -> EnsembleState:
    """One full DE ensemble step (both complementary halves).

    ``gamma0`` defaults to the 2.38/sqrt(2·D) optimal-scaling value;
    with probability ``jump_prob`` the whole step uses gamma = 1 — the
    full-difference "mode jump" that lets walkers hop between posterior
    modes (ter Braak 2006 §2; emcee recommends the same mixture).
    """
    W, D = state.pos.shape
    half = W // 2
    if gamma0 is None:
        gamma0 = 2.38 / (2.0 * D) ** 0.5
    k_jump, k0, k1 = jax.random.split(key, 3)
    jump = jax.random.bernoulli(k_jump, jump_prob)
    gamma = jnp.where(jump, jnp.asarray(1.0, state.pos.dtype), gamma0)

    first, second = state.pos[:half], state.pos[half:]
    lp_first, lp_second = state.log_prob[:half], state.log_prob[half:]

    first, lp_first, acc0 = _de_half_update(
        log_prob_fn, first, lp_first, second, k0, gamma, sigma
    )
    second, lp_second, acc1 = _de_half_update(
        log_prob_fn, second, lp_second, first, k1, gamma, sigma
    )
    return EnsembleState(
        pos=jnp.concatenate([first, second]),
        log_prob=jnp.concatenate([lp_first, lp_second]),
        accepted=state.accepted + acc0 + acc1,
    )


def _snooker_half_update(
    log_prob_fn, active, lp_active, other, key, gamma_s
):
    """Snooker update of ``active`` against ``other`` (ter Braak &
    Vrugt 2008; emcee's ``DESnookerMove``).

    Each active walker x picks three distinct anchors z, z1, z2 from
    the complementary half and proposes along the line through x and z:

        x' = x + gamma_s · (u·z1 − u·z2) · u,   u = (x − z)/‖x − z‖

    The step length scales with the walker's DISTANCE from the
    ensemble, so an outlier walker (e.g. stranded in a secondary
    posterior mode) recovers in O(1) accepted moves where plain DE
    random-walks back in bulk-spread-sized steps. The proposal is not
    symmetric; detailed balance needs the Jacobian factor
    (‖x' − z‖/‖x − z‖)^(D−1) in the acceptance ratio.
    """
    h, D = active.shape
    k_z, k_z1, k_z2, k_accept = jax.random.split(key, 4)
    c = other.shape[0]
    iz = jax.random.randint(k_z, (h,), 0, c)
    i1 = jax.random.randint(k_z1, (h,), 0, c - 1)
    i1 = i1 + (i1 >= iz)
    lo = jnp.minimum(iz, i1)
    hi = jnp.maximum(iz, i1)
    i2 = jax.random.randint(k_z2, (h,), 0, c - 2)
    i2 = i2 + (i2 >= lo)
    i2 = i2 + (i2 >= hi)  # three distinct anchor indices
    z, z1, z2 = other[iz], other[i1], other[i2]
    delta = active - z
    norm = jnp.sqrt(jnp.sum(delta * delta, axis=1))
    # x == z (possible after an accepted full-difference DE jump) gives
    # u = 0 -> proposal = x and a nan log-ratio below; the nan compares
    # False so the degenerate proposal is simply rejected
    u = delta / jnp.maximum(norm, 1e-35)[:, None]
    proj = jnp.sum(u * (z1 - z2), axis=1)
    prop = active + gamma_s * proj[:, None] * u
    lp_prop = log_prob_fn(prop)
    norm_prop = jnp.sqrt(jnp.sum((prop - z) ** 2, axis=1))
    log_ratio = (
        (D - 1.0) * (jnp.log(norm_prop) - jnp.log(norm))
        + lp_prop
        - lp_active
    )
    accept = (
        jnp.log(jax.random.uniform(k_accept, (h,), dtype=active.dtype))
        < log_ratio
    )
    new_active = jnp.where(accept[:, None], prop, active)
    new_lp = jnp.where(accept, lp_prop, lp_active)
    return new_active, new_lp, jnp.sum(accept).astype(jnp.int32)


def snooker_step(
    log_prob_fn: Callable,
    state: EnsembleState,
    key,
    gamma_s: float = 1.7,
) -> EnsembleState:
    """One full snooker ensemble step (both complementary halves).

    ``gamma_s = 1.7`` is the ter Braak & Vrugt (2008) recommendation.
    """
    W, _ = state.pos.shape
    half = W // 2
    k0, k1 = jax.random.split(key)

    first, second = state.pos[:half], state.pos[half:]
    lp_first, lp_second = state.log_prob[:half], state.log_prob[half:]

    first, lp_first, acc0 = _snooker_half_update(
        log_prob_fn, first, lp_first, second, k0, gamma_s
    )
    second, lp_second, acc1 = _snooker_half_update(
        log_prob_fn, second, lp_second, first, k1, gamma_s
    )
    return EnsembleState(
        pos=jnp.concatenate([first, second]),
        log_prob=jnp.concatenate([lp_first, lp_second]),
        accepted=state.accepted + acc0 + acc1,
    )


# NOTE: a DREAM-style subspace-crossover DE move ("de_cr") was built and
# REJECTED by measurement in round 5: on the real bimodal 17-D
# north-star posterior, subspace-masked difference vectors cannot carry
# walkers back across modes — de_cr+snooker mixtures split the ensemble
# (R-hat pinned at 5-7 after 4800 steps vs demix's 1.095 on the
# north-star convergence ladder). Cut per the wins-or-cut bar.
_MOVE_NAMES = ("stretch", "de", "snooker")

# per-move tunable parameters accepted in a "name:key=val,..." spec
# (kept as strings so the whole moves tuple stays hashable — it is a
# jit static argument). Ranges are validated eagerly in _parse_move.
_MOVE_PARAMS = {
    "stretch": ("a",),
    "de": ("gamma", "sigma", "jump"),
    "snooker": ("gammas",),
}

# each move draws its anchors from the COMPLEMENTARY half without
# replacement: stretch needs 1, DE 2, snooker 3 distinct walkers there —
# below these minima jax.random.randint gets an empty range
# (maxval <= minval) and returns implementation-defined indices, i.e. a
# silently corrupt chain instead of an error
_MIN_WALKERS = {"stretch": 2, "de": 4, "snooker": 6}


def _parse_move(name):
    """Parse a move spec string into ``(base, params)``.

    ``"de"`` -> ("de", {}); ``"de:jump=0.2,gamma=0.6"`` ->
    ("de", {"jump": 0.2, "gamma": 0.6}). Raises eagerly on unknown
    bases, unknown/duplicate keys, or non-finite/non-positive values,
    so a typo fails at construction rather than mid-chain."""
    base, sep, rest = name.partition(":")
    if base not in _MOVE_NAMES:
        raise ValueError(
            f"unknown move {base!r} (expected one of {_MOVE_NAMES})"
        )
    params = {}
    if sep:
        allowed = _MOVE_PARAMS[base]
        for item in rest.split(","):
            key, eq, val = item.partition("=")
            key = key.strip()
            if not eq or key not in allowed:
                raise ValueError(
                    f"move {base!r} takes parameters {allowed}; got "
                    f"{item!r} (syntax: '{base}:{allowed[0]}=VALUE')"
                )
            if key in params:
                raise ValueError(f"duplicate parameter {key!r} in {name!r}")
            v = float(val)
            if key == "jump":
                # a probability: 0 (no mode-jumps, a standard DE
                # variant) through 1 (every step a full-difference jump)
                bad = not math.isfinite(v) or v < 0.0 or v > 1.0
                need = "a value in [0, 1]"
            else:
                bad = not math.isfinite(v) or v <= 0.0
                need = "a positive finite value"
            if bad:
                raise ValueError(
                    f"move parameter {key}={val!r} out of range "
                    f"(need {need})"
                )
            params[key] = v
    return base, params


def validate_walker_count(n_walkers, moves):
    """Raise eagerly when ``n_walkers`` cannot support ``moves``.

    ``moves=None`` means pure stretch."""
    names = ("stretch",) if not moves else tuple(n for n, _ in moves)
    for name in names:
        base = name.partition(":")[0]
        need = _MIN_WALKERS.get(base, 2)
        if n_walkers < need:
            raise ValueError(
                f"move {base!r} needs at least {need} walkers (it draws "
                f"{need // 2} distinct anchors from the complementary "
                f"half); got n_walkers={n_walkers}"
            )


def _normalize_moves(moves):
    """Validate a ``moves`` spec — a tuple of ``(name, weight)`` pairs —
    and return ``(names, normalized_weights)``. ``None`` means the
    bit-stable pure-stretch path."""
    if not moves:
        raise ValueError("moves must be a non-empty tuple of (name, weight)")
    names, weights = [], []
    for name, weight in moves:
        _parse_move(name)  # validates base + any :key=val parameters
        if weight < 0:
            raise ValueError(f"move weight must be >= 0, got {weight}")
        names.append(name)
        weights.append(float(weight))
    total = sum(weights)
    if total <= 0:
        raise ValueError("move weights must sum to a positive value")
    return tuple(names), tuple(w / total for w in weights)


def make_step_fn(log_prob_fn: Callable, a: float = 2.0, moves=None):
    """Build the per-step ensemble transition for ``lax.scan``.

    ``moves=None`` returns the plain stretch step (bit-identical to the
    historical chains — every golden test rides this path). Otherwise
    ``moves`` is a hashable tuple of ``(name, weight)`` with names in
    {"stretch", "de", "snooker"}: each step draws one move from the
    weights (a random-scan mixture of reversible kernels keeps the
    posterior stationary) and dispatches via ``lax.switch``. A name may
    carry tunable parameters as ``"name:key=val,..."`` —
    ``"de:jump=0.2,gamma=0.6,sigma=1e-4"``, ``"snooker:gammas=1.3"``,
    ``"stretch:a=1.5"`` — kept in the string so the spec stays a
    hashable jit static; each parameterization is a fixed reversible
    kernel, so mixtures of them remain valid random scans.

    Tuning note (measured on the north-star ladder): on the 17-dim
    benchmark hyperposterior, raising DE's full-jump probability
    (``jump``) from the emcee default 0.1 to 0.25 COLLAPSED mixing
    (acceptance 0.24 -> 0.15, R-hat pinned at 2.3@4800 steps vs 1.095
    for the default) — gamma=1 mode-hop proposals are rare-event
    moves, and spending a quarter of the proposals on them starves the
    in-mode gamma=2.38/sqrt(2D) diffusion. Treat ``jump`` > ~0.1 as a
    last resort for severely multimodal targets, and check
    ``mcmc_diagnostics()`` after any retune.
    """
    if moves is None:
        def step(state, k):
            validate_walker_count(state.pos.shape[0], None)
            new = stretch_step(log_prob_fn, state, k, a=a)
            return new, new.pos

        return step

    def _move_fn(name):
        base, p = _parse_move(name)
        if base == "stretch":
            a_eff = p.get("a", a)
            return lambda s, kk: stretch_step(log_prob_fn, s, kk, a=a_eff)
        if base == "de":
            return lambda s, kk: de_step(
                log_prob_fn, s, kk,
                gamma0=p.get("gamma"),
                sigma=p.get("sigma", 1e-5),
                jump_prob=p.get("jump", 0.1),
            )
        return lambda s, kk: snooker_step(
            log_prob_fn, s, kk, gamma_s=p.get("gammas", 1.7)
        )

    names, weights = _normalize_moves(moves)
    norm_moves = tuple(zip(names, weights))
    if len(names) == 1:
        fn = _move_fn(names[0])

        def step(state, k):
            validate_walker_count(state.pos.shape[0], norm_moves)
            new = fn(state, k)
            return new, new.pos

        return step

    branches = [_move_fn(name) for name in names]
    w = jnp.asarray(weights)

    def step(state, k):
        validate_walker_count(state.pos.shape[0], norm_moves)
        k_move, k_step = jax.random.split(k)
        idx = jax.random.choice(k_move, len(branches), p=w)
        new = jax.lax.switch(idx, branches, state, k_step)
        return new, new.pos

    return step


@partial(jax.jit, static_argnames=("log_prob_fn", "n_steps", "a", "moves"))
def run_ensemble(
    log_prob_fn: Callable,
    pos0: jnp.ndarray,
    key,
    n_steps: int,
    a: float = 2.0,
    moves=None,
):
    """Run ``n_steps`` full ensemble steps from ``pos0``.

    ``log_prob_fn`` must be *batched*: (W, D) -> (W,). ``moves`` is an
    optional hashable tuple of ``(name, weight)`` pairs mixing the
    stretch and DE moves per step (see :func:`make_step_fn`); ``None``
    keeps the historical pure-stretch chain bit-identical.

    Returns ``(chain, final_state)`` with ``chain`` of shape
    (n_steps, W, D) — one sample per walker per step, matching emcee's
    ``get_chain`` layout so downstream discard/thin/flatten semantics
    carry over (reference ``bask/bayesgpr.py:528-534``).
    """
    validate_walker_count(pos0.shape[0], moves)
    state0 = init_ensemble(log_prob_fn, pos0)
    keys = jax.random.split(key, n_steps)
    step = make_step_fn(log_prob_fn, a=a, moves=moves)
    final, chain = jax.lax.scan(step, state0, keys)
    return chain, final


def flatten_chain(chain, discard: int = 0, thin: int = 1):
    """(n_steps, W, D) -> (n_kept * W, D), step-major like emcee flat=True.

    Matches emcee's ``get_chain(discard=, thin=)`` sample selection
    exactly: the kept steps are ``discard + thin - 1, discard +
    2*thin - 1, ...`` (emcee ``backends/backend.py`` slices
    ``[discard + thin - 1 :: thin]``).
    """
    kept = chain[discard + thin - 1 :: thin]
    return kept.reshape(-1, chain.shape[-1])
