"""Functional Gaussian-process core (GPML Algorithm 2.1) on padded data.

This is the JAX replacement for the sklearn/skopt
``GaussianProcessRegressor`` machinery the reference inherits
(``bask/bayesgpr.py:18`` subclasses skopt's GPR). Instead of a mutable
estimator, the model is a pair of immutable structs:

* :class:`GPData` — padded training data (static shapes; the BO loop grows
  ``n`` without recompiling by bumping the mask inside a padding bucket),
* :class:`GPPosterior` — per-theta derived state (Cholesky factor, dual
  coefficients), the analogue of sklearn's ``L_``/``alpha_``/``K_inv_``
  attributes that the reference mutates in its ``theta`` setter
  (``bask/bayesgpr.py:200-217``).

All functions are pure and jit/vmap-friendly; gradients of the predictive
mean/std (needed by ``expected_minimum``, reference
``bask/optimizer.py:490-504``) come from autodiff instead of the skopt
fork's hand-written formulas.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from ..ops.linalg import cho_solve_masked, masked_cholesky, masked_gram

__all__ = [
    "GPData",
    "GPPosterior",
    "make_data",
    "posterior",
    "posterior_and_invs",
    "log_marginal_likelihood",
    "predict",
    "predict_mean",
    "sample_y",
    "noise_free_theta",
]


class GPData(NamedTuple):
    """Padded, normalized training data."""

    X: jnp.ndarray  # (n_pad, d) inputs (warped space if warping is on)
    y: jnp.ndarray  # (n_pad,) normalized targets, 0 at padded entries
    alpha_diag: jnp.ndarray  # (n_pad,) jitter + noise variance per point
    mask: jnp.ndarray  # (n_pad,) bool
    y_mean: jnp.ndarray  # scalar
    y_std: jnp.ndarray  # scalar


class GPPosterior(NamedTuple):
    """Derived per-theta state."""

    theta: jnp.ndarray  # (n_theta,)
    L: jnp.ndarray  # (n_pad, n_pad) lower Cholesky of masked K
    alpha_dual: jnp.ndarray  # (n_pad,)


def make_data(X, y, alpha_diag, mask, y_mean=0.0, y_std=1.0) -> GPData:
    X = jnp.asarray(X)
    y = jnp.asarray(y)
    mask = jnp.asarray(mask, dtype=bool)
    y = jnp.where(mask, y, 0.0)
    return GPData(
        X=X,
        y=y,
        alpha_diag=jnp.asarray(alpha_diag),
        mask=mask,
        y_mean=jnp.asarray(y_mean, dtype=X.dtype),
        y_std=jnp.asarray(y_std, dtype=X.dtype),
    )


def posterior(kernel, theta, data: GPData) -> GPPosterior:
    """Factorize the training gram for one theta."""
    Kp = masked_gram(kernel, theta, data.X, data.alpha_diag, data.mask)
    L = masked_cholesky(Kp)
    alpha_dual = cho_solve_masked(L, data.y)
    return GPPosterior(theta=theta, L=L, alpha_dual=alpha_dual)


def posterior_and_invs(kernel, theta, data: GPData):
    """Like :func:`posterior`, additionally returning the cached
    diagonal-block inverses of the factor when the f32 blocked fast path
    applies (else ``None``).

    The inverses come free from ``block_cholesky`` and let
    :func:`predict` replace XLA's latency-bound triangular substitution
    with batched matmuls — the marginalized-acquisition hot path, where
    each hyperposterior draw solves against hundreds of candidates.
    """
    from ..ops import linalg as _lin

    Kp = masked_gram(kernel, theta, data.X, data.alpha_diag, data.mask)
    if not _lin._use_fast_path(Kp):
        L = masked_cholesky(Kp)
        return GPPosterior(theta=theta, L=L, alpha_dual=cho_solve_masked(L, data.y)), None
    from ..ops.fast_cholesky import (
        block_cholesky,
        block_solve_lower_mat,
        block_solve_upper_mat,
    )

    L, invs = block_cholesky(Kp)
    invs = tuple(invs)
    w = block_solve_lower_mat(L, invs, data.y[..., :, None])
    alpha_dual = block_solve_upper_mat(L, invs, w)[..., 0]
    return GPPosterior(theta=theta, L=L, alpha_dual=alpha_dual), invs


def log_marginal_likelihood(kernel, theta, data: GPData):
    """Scalar LML; -inf when the gram is not positive definite."""
    from ..ops.linalg import masked_lml

    return masked_lml(
        kernel, theta, data.X, data.y, data.alpha_diag, data.mask
    )


def noise_free_theta(kernel, theta, white_index: Optional[int]):
    """theta variant with the WhiteKernel noise set to zero.

    Functional analogue of the reference's ``noise_set_to_zero`` context
    manager (``bask/bayesgpr.py:318-336``): the Cholesky/dual state is NOT
    recomputed — only the prior-variance diagonal used by predict/sample
    changes.
    """
    if white_index is None:
        return theta
    return theta.at[white_index].set(-jnp.inf)


def _cross(kernel, theta, Xq, data: GPData):
    """k(Xq, X_train) with padded columns zeroed: (m, n_pad)."""
    Ks = kernel.eval(theta, Xq, data.X)
    return Ks * data.mask[None, :]


def predict_mean(kernel, theta, post: GPPosterior, data: GPData, Xq):
    """Predictive mean in original y units; (m,)."""
    return predict(kernel, theta, post, data, Xq)


def predict(
    kernel,
    theta_diag,
    post: GPPosterior,
    data: GPData,
    Xq,
    return_std=False,
    return_cov=False,
    invs=None,
):
    """Predictive mean and uncertainty.

    ``theta_diag`` is the theta used for the *prior-variance* diagonal /
    query-query gram — pass ``noise_free_theta(...)`` to predict epistemic
    uncertainty only (the factorized state in ``post`` keeps the noisy
    theta, matching reference semantics where ``noise_set_to_zero`` does
    not recompute ``alpha_``/``K_inv_``).

    ``invs``: optional cached diagonal-block inverses from
    :func:`posterior_and_invs` — routes the cross-gram solve through
    batched matmuls instead of XLA's substitution. (Computing fresh inverses
    just for this solve measured slower — only pass cached ones.)
    """
    Ks = _cross(kernel, theta_diag, Xq, data)
    # full-f32 matvec: alpha_dual = K^-1 y is oscillatory, a reduced-
    # precision (TF32) product loses digits to cancellation
    mean = data.y_mean + data.y_std * jnp.matmul(
        Ks, post.alpha_dual, precision=jax.lax.Precision.HIGHEST
    )
    if not (return_std or return_cov):
        return mean
    if invs is not None:
        from ..ops.fast_cholesky import block_solve_lower_mat

        v = block_solve_lower_mat(post.L, invs, Ks.T)  # (n_pad, m)
    else:
        v = solve_triangular(post.L, Ks.T, lower=True)  # (n_pad, m)
    if return_cov:
        Kqq = kernel.eval(theta_diag, Xq, None)
        # Kqq - v^T v is a near-cancelling difference near training
        # points: full precision, like every other solve-adjacent matmul
        cov = (
            Kqq
            - jnp.matmul(v.T, v, precision=jax.lax.Precision.HIGHEST)
        ) * data.y_std**2
        return mean, cov
    var = kernel.diag(theta_diag, Xq) - jnp.sum(v * v, axis=0)
    var = jnp.maximum(var, 0.0)
    return mean, jnp.sqrt(var) * data.y_std


def sample_y(
    kernel,
    theta_diag,
    post: GPPosterior,
    data: GPData,
    Xq,
    key,
    n_samples: int = 1,
    invs=None,
):
    """Draw joint samples from the predictive distribution: (m, n_samples).

    Uses an eigendecomposition factor: posterior covariances over dense
    query grids are rank-deficient (rank <= n_train), where a Cholesky
    needs jitter large enough (especially in float32) to visibly inflate
    the draws. ``sqrt(max(eigvals, 0))`` is exact for PSD matrices with
    no added noise; NaN inputs still propagate to NaN draws.
    """
    mean, cov = predict(
        kernel, theta_diag, post, data, Xq, return_cov=True, invs=invs
    )
    return eigh_draws(mean, cov, key, n_samples)


def eigh_draws(mean, cov, key, n_samples):
    """Joint normal draws from (mean, cov) via the eigen-factor.

    Shared by :func:`sample_y` and the row-sharded distributed path
    (:func:`bask_tpu.ops.dist_chol.row_sharded_sample_y`) so both
    construct draws identically (their bit-comparable-draws parity test
    depends on it)."""
    evals, evecs = jnp.linalg.eigh(cov)
    factor = evecs * jnp.sqrt(jnp.maximum(evals, 0.0))[None, :]
    z = jax.random.normal(key, (mean.shape[0], n_samples), dtype=cov.dtype)
    return mean[:, None] + jnp.matmul(
        factor, z, precision=jax.lax.Precision.HIGHEST
    )
