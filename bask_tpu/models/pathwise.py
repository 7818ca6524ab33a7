"""Pathwise (decoupled) GP posterior sampling with random Fourier features.

Exact joint posterior draws need an O(m^3) Cholesky of the query-query
covariance, which caps Thompson sampling at a few thousand candidates
(the reference's `sample_y` path, `bask/bayesgpr.py:637-718`). Pathwise
sampling (Wilson et al., "Efficiently Sampling Functions from Gaussian
Process Posteriors", ICML 2020) decouples the draw:

    f~(x) = f0(x) + k(x, X) K^-1 (y - f0(X) - eps),   f0 ~ GP prior (RFF)

where f0 is a weight-space prior sample over M random Fourier features
and eps ~ N(0, noise). Every term is a matmul, so evaluating S samples at
65k+ candidates is matmul work with no large factorization — the scalable
batch-ask path (BASELINE config: 256-point Thompson batch over 65k
candidates).

Spectral sampling: a Matern-nu kernel's spectral measure is a
multivariate Student-t with 2*nu degrees of freedom (Cauchy for nu=1/2,
Gaussian in the RBF limit): omega_d = (z_d / ls_d) * sqrt(2 nu / u),
z ~ N(0,1), u ~ chi^2_{2 nu}.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from ..ops.kernels import FusedSpec

__all__ = ["sample_frequencies", "pathwise_samples"]


def sample_frequencies(key, spec: FusedSpec, inv_ls, n_features: int):
    """Draw (M, d) spectral frequencies for the fused kernel family."""
    d = inv_ls.shape[0]
    kz, ku = jax.random.split(key)
    z = jax.random.normal(kz, (n_features, d), dtype=inv_ls.dtype)
    if math.isinf(spec.nu):
        scale = jnp.ones((n_features, 1), dtype=inv_ls.dtype)
    else:
        dof = 2.0 * spec.nu
        u = 2.0 * jax.random.gamma(
            ku, dof / 2.0, (n_features, 1), dtype=inv_ls.dtype
        )
        scale = jnp.sqrt(dof / u)
    return z * scale * inv_ls[None, :]


@partial(jax.jit, static_argnames=("spec", "n_features", "n_samples"))
def pathwise_samples(
    spec: FusedSpec,
    theta,
    data,
    L,
    Xq,
    key,
    n_samples: int,
    n_features: int = 1024,
):
    """S pathwise posterior draws at Xq: returns (n_q, n_samples).

    ``theta`` is the consensus log-parameter vector in the fused layout;
    ``data`` a GPData (padded); ``L`` the masked train Cholesky factor
    of the *noisy* kernel. Draws are from the noise-free latent f.
    """
    dt = Xq.dtype
    off = 1 if spec.has_const else 0
    amp = jnp.exp(theta[0]) if spec.has_const else jnp.asarray(1.0, dt)
    inv_ls = jnp.exp(-theta[off : off + spec.n_ls])
    if spec.n_ls == 1:
        inv_ls = jnp.broadcast_to(inv_ls, (data.X.shape[1],))
    noise = (
        jnp.exp(theta[off + spec.n_ls])
        if spec.has_white
        else jnp.asarray(0.0, dt)
    )

    k_freq, k_phase, k_w, k_eps = jax.random.split(key, 4)
    omega = sample_frequencies(k_freq, spec, inv_ls, n_features)  # (M, d)
    phase = jax.random.uniform(
        k_phase, (n_features,), dtype=dt, maxval=2.0 * math.pi
    )
    coef = jnp.sqrt(2.0 * amp / n_features)

    def features(X):  # (n, d) -> (n, M)
        return coef * jnp.cos(_mm(X, omega.T) + phase[None, :])

    w = jax.random.normal(k_w, (n_features, n_samples), dtype=dt)
    f0_train = _mm(features(data.X), w)  # (n_pad, S)
    f0_query = _mm(features(Xq), w)  # (n_q, S)

    eps = jnp.sqrt(noise + data.alpha_diag)[:, None] * jax.random.normal(
        k_eps, (data.X.shape[0], n_samples), dtype=dt
    )
    resid = jnp.where(
        data.mask[:, None], data.y[:, None] - f0_train - eps, 0.0
    )
    # v = K^-1 resid via the existing masked factor
    v = solve_triangular(
        L.T, solve_triangular(L, resid, lower=True), lower=False
    )

    Kq = _cross_kernel(spec, theta, Xq, data.X) * data.mask[None, :]
    return f0_query + _mm(Kq, v)


def _mm(a, b):
    """Full-f32 matmul. ``v = K^-1 resid`` is large and oscillatory, so
    ``Kq @ v`` is a near-cancelling sum that a reduced-precision (TF32)
    product would swamp; the prior-feature products feed that residual."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _cross_kernel(spec: FusedSpec, theta, Xq, X):
    """Noise-free cross covariance k(Xq, X) for the fused family (White
    contributes nothing off-diagonal)."""
    from ..ops import kernels as bk  # local import to avoid cycle

    off = 1 if spec.has_const else 0
    amp = jnp.exp(theta[0]) if spec.has_const else jnp.asarray(1.0, Xq.dtype)
    ls_theta = theta[off : off + spec.n_ls]
    ls_init = 1.0 if spec.n_ls == 1 else tuple([1.0] * spec.n_ls)
    if math.isinf(spec.nu):
        base = bk.RBF(ls_init, (1e-5, 1e5))
    else:
        base = bk.Matern(ls_init, (1e-5, 1e5), nu=spec.nu)
    return amp * base.eval(ls_theta, Xq, X)


@partial(
    jax.jit,
    static_argnames=("spec", "n_warp", "n_features", "k"),
)
def pathwise_topk_hyper(
    spec: FusedSpec,
    rows,
    data,
    Xq,
    key,
    n_warp: int,
    n_features: int = 1024,
    k: int = 8,
):
    """Hyperposterior-marginal Thompson top-k over huge candidate grids.

    Each of the S draws uses its own chain row (kernel theta + warp
    params), matching the reference's per-draw `sample_y` semantics
    (``bask/bayesgpr.py:679-710``) at pathwise cost: one batched
    factorization for all rows, then a `lax.scan` over draws that builds
    each draw's cross-kernel on the fly and reduces straight to its
    top-k minimizer indices — the (n_q, S) draw matrix is never
    materialized.

    ``rows``: (S, n_theta [+ 2*n_warp]); returns (S, k) int32 indices.
    """
    from ..models import warping as wpm

    S = rows.shape[0]
    n_gp = rows.shape[1] - 2 * n_warp
    thetas = rows[:, :n_gp]

    if n_warp:
        Xb = jax.vmap(
            lambda x: wpm.warp(data.X, *wpm.split_warp_params(x, n_warp)[1:])
        )(rows)
        Kp = jax.vmap(lambda t, Xi: _fused_spec_gram(spec, t, Xi, data))(
            thetas, Xb
        )
    else:
        Xb = data.X
        Kp = jax.vmap(lambda t: _fused_spec_gram(spec, t, data.X, data))(
            thetas
        )
    L = jnp.linalg.cholesky(Kp)  # (S, n_pad, n_pad)

    keys = jax.random.split(key, S)

    def x_q_for(row):
        if n_warp:
            _, la, lb = wpm.split_warp_params(row, n_warp)
            return wpm.warp(Xq, la, lb)
        return Xq

    def one(_, inp):
        theta_s, L_s, key_s, x_s = inp
        d_s = data._replace(X=x_s)
        draws = pathwise_samples(
            spec,
            theta_s[:n_gp],
            d_s,
            L_s,
            x_q_for(theta_s),
            key_s,
            1,
            n_features,
        )[:, 0]
        _, idx = jax.lax.top_k(-draws, k)
        return None, idx

    Xb_scan = (
        Xb if n_warp else jnp.broadcast_to(data.X, (S,) + data.X.shape)
    )
    _, idx = jax.lax.scan(one, None, (rows, L, keys, Xb_scan))
    return idx


def _fused_spec_gram(spec, theta, X, data):
    """Masked gram via the generic kernel tree for the fused family."""
    from ..ops import kernels as bk
    from ..ops.linalg import masked_gram

    ls_init = 1.0 if spec.n_ls == 1 else tuple([1.0] * spec.n_ls)
    if math.isinf(spec.nu):
        base = bk.RBF(ls_init, (1e-5, 1e5))
    else:
        base = bk.Matern(ls_init, (1e-5, 1e5), nu=spec.nu)
    kernel = base
    if spec.has_const:
        kernel = bk.ConstantKernel(1.0, (1e-5, 1e5)) * kernel
    if spec.has_white:
        kernel = kernel + bk.WhiteKernel(1.0, (1e-5, 1e5))
    return masked_gram(kernel, theta, X, data.alpha_diag, data.mask)
