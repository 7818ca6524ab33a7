"""Optimization result container and expected-minimum search.

Replaces the skopt helpers the reference imports (``create_result``,
``expected_minimum``; reference ``bask/optimizer.py:7-13,490-504``). The
expected-minimum search is a multistart refinement of the GP posterior
mean using the autodiff gradients the GP core provides.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import OptimizeResult

__all__ = ["create_result", "expected_minimum"]


def create_result(Xi, yi, space=None, rng=None, models=None) -> OptimizeResult:
    """Bundle observations + model into a scipy OptimizeResult.

    ``space``/``rng``/``models`` are optional keywords, matching the
    skopt helper the reference re-exports (used as
    ``create_result(opt.Xi, opt.yi, space=..., models=[...])`` in its
    Optimize-1D tutorial)."""
    yi = np.asarray(yi, dtype=float)
    res = OptimizeResult()
    if len(yi):
        best = int(np.argmin(yi))
        res.x = Xi[best]
        res.fun = yi[best]
    else:
        res.x, res.fun = None, None
    res.func_vals = yi
    res.x_iters = list(Xi)
    res.models = list(models) if models else []
    res.space = space
    res.random_state = rng
    res.specs = {}
    return res


def expected_minimum(
    res: OptimizeResult, n_random_starts: int = 20, random_state=None
):
    """Minimize the GP posterior mean over the space.

    Multistart strategy: sample candidate starts (always including the
    best observed point), refine the non-categorical case with L-BFGS-B
    on the transformed [0,1]^d cube using the GP's autodiff mean
    gradients; categorical spaces fall back to dense random sampling.

    Returns ``(x_best, fun_best)`` in the original space.
    """
    from scipy.optimize import minimize

    space = res.space
    gp = res.models[-1]
    if not isinstance(random_state, np.random.RandomState):
        random_state = np.random.RandomState(random_state)

    if space.is_partly_categorical:
        cand = space.rvs(
            n_samples=max(10 * n_random_starts, 1000),
            random_state=random_state,
        )
        mu = gp.predict(space.transform(cand))
        i = int(np.argmin(mu))
        return cand[i], float(mu[i])

    d = space.transformed_n_dims
    starts = [space.transform([res.x])[0]] if res.x is not None else []
    starts.extend(random_state.uniform(size=(n_random_starts, d)))
    starts = np.asarray(starts)

    # All restarts descend in parallel on device (one fused program)
    # instead of one scipy L-BFGS per start (each iteration of which is
    # a host-device round trip); a single scipy polish finishes from the
    # best basin with ONE packed [value, grad] fetch per step.
    u_best, v_best = _batched_descent(gp, starts)

    import jax.numpy as jnp

    from ..utils.aot import aot_call

    dt = gp._dtype()
    wa, wb, n_warp = gp._warp_params()

    def f(u):
        vg = np.asarray(
            aot_call(
                _mean_value_grad,
                jnp.asarray(u, dtype=dt),
                gp._post,
                gp._post_data,
                wa,
                wb,
                kernel=gp._spec,
                n_warp=n_warp,
            ),
            dtype=float,
        )
        return float(vg[0]), vg[1:]

    r = minimize(
        f, u_best, jac=True, method="L-BFGS-B",
        bounds=[(0.0, 1.0)] * d, options={"maxiter": 50},
    )
    if r.fun < v_best:
        u_best, v_best = r.x, float(r.fun)
    x = space.inverse_transform(np.asarray(u_best)[None, :])[0]
    return x, float(v_best)


def _make_mean_one(kernel, n_warp, post, data, wa, wb):
    from ..models import gp as gpc
    from ..models import warping as wpm

    def mean_one(u):
        uq = u[None, :]
        if n_warp:
            uq = wpm.warp(uq, wa, wb)
        return gpc.predict_mean(kernel, post.theta, post, data, uq)[0]

    return mean_one


def _jitted(fn):
    from functools import partial

    import jax

    return partial(jax.jit, static_argnames=("kernel", "n_warp"))(fn)


@_jitted
def _mean_value_grad(u, post, data, wa, wb, *, kernel, n_warp):
    """GP posterior mean + gradient, packed into one [value, grad...]
    vector (one fetch per polish step; fetch latency, not compute,
    dominates)."""
    import jax
    import jax.numpy as jnp

    mean_one = _make_mean_one(kernel, n_warp, post, data, wa, wb)
    v, g = jax.value_and_grad(mean_one)(u)
    return jnp.concatenate([v[None], g])


@_jitted
def _batched_descent_prog(U, post, data, wa, wb, *, kernel, n_warp):
    """Vmapped projected-Adam descent of the GP mean over all starts.

    Module-level jit (static kernel/n_warp): the compiled program is
    reused across expected_minimum calls — the previous per-call closure
    recompiled the whole descent every diagnostics invocation.
    """
    import jax
    import jax.numpy as jnp

    n_steps, lr = 120, 0.03
    mean_one = _make_mean_one(kernel, n_warp, post, data, wa, wb)

    def descend(u0):
        def step(carry, _):
            u, m, v, t = carry
            g = jax.grad(mean_one)(u)
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            u = u - lr * (m / (1 - 0.9**t)) / (
                jnp.sqrt(v / (1 - 0.999**t)) + 1e-8
            )
            u = jnp.clip(u, 0.0, 1.0)
            return (u, m, v, t + 1.0), None

        (u, _, _, _), _ = jax.lax.scan(
            step,
            (u0, jnp.zeros_like(u0), jnp.zeros_like(u0), 1.0),
            None,
            length=n_steps,
        )
        return u, mean_one(u)

    return jax.vmap(descend)(U)


def _batched_descent(gp, starts):
    import jax.numpy as jnp

    from ..utils.aot import aot_call

    dt = gp._dtype()
    wa, wb, n_warp = gp._warp_params()
    U, V = aot_call(
        _batched_descent_prog,
        jnp.asarray(starts, dtype=dt),
        gp._post,
        gp._post_data,
        wa,
        wb,
        kernel=gp._spec,
        n_warp=n_warp,
    )
    V = np.asarray(V)
    i = int(np.argmin(V))
    return np.asarray(U[i], dtype=float), float(V[i])
