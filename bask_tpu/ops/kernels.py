"""Covariance-kernel algebra with sklearn-compatible log-space ``theta``.

This replaces the sklearn/skopt kernel objects the reference builds on
(see reference ``bask/bayesgpr.py:163``, ``bask/utils.py:68-151``). Kernels
here are immutable *specs* (static pytree-free Python objects); all
hyperparameters live in a flat log-space vector ``theta`` that is threaded
through evaluation as a JAX array. This makes every kernel evaluation a pure
function ``k(theta, X, Y)`` that can be ``jit``/``vmap``/``grad``-ed — the
walker-batched MCMC evaluates the Gram matrix for hundreds of thetas in one
fused call.

theta ordering matches sklearn's convention (depth-first: Sum/Product visit
``k1`` then ``k2``, Exponentiation visits its child; leaves contribute their
parameters unless their bounds are "fixed"), which the reference relies on
for prior ordering parity (reference ``bask/utils.py:68-124``).

The pairwise squared distance is computed as ``|x|^2 + |y|^2 - 2 x.y^T`` so
the O(n^2 d) work is a single matmul.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from functools import partial
from typing import NamedTuple, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "Kernel",
    "ConstantKernel",
    "WhiteKernel",
    "RBF",
    "Matern",
    "Sum",
    "Product",
    "Exponentiation",
    "CompoundKernel",
    "sqdist",
    "FusedSpec",
    "match_fusable",
]

Bounds = Union[str, Tuple[float, float]]


# ---------------------------------------------------------------------------
# General-nu Matern (modified-Bessel form), fully on device
#
# The reference supports arbitrary nu through sklearn's Matern (Bessel
# K_nu, computed by scipy). K_nu is evaluated on device by
# :mod:`bask_tpu.ops.bessel` (Temme series + Steed CF2 + stable upward
# recurrence — no host callback, so general-nu models work on every
# backend, including ones that reject host callbacks). The
# value is assembled fully in log space,
# exp(nu log z + log(e^z K_nu(z)) - z + (1-nu) log 2 - lgamma(nu)),
# so z^nu underflow cannot produce 0*inf for any nu. Gradients use the
# exact identity d/dz [z^nu K_nu(z)] = -z^nu K_{nu-1}(z). The pathwise
# sampler never matches general nu (:func:`match_fusable` returns
# None). The ``*_np`` host twins below are kept as test oracles.
# ---------------------------------------------------------------------------


# z below this is the r -> 0 limit: z**nu underflows while K_nu(z)
# overflows, so the product must be replaced by its analytic limit
# (K(0)=1, dK/dr(0)=0 for nu>1/2). The on-device path accumulates in
# float64 when x64 is enabled (the CPU parity config); on f32-only
# backends it runs at f32 accuracy (~1e-6 relative) — see
# _matern_general_compute_dtype. Either way the epsilon-floored gram
# diagonal (Matern.eval adds 1e-36 under sqrt) cannot hit 0*inf = NaN:
# the evaluation happens fully in log space,
# exp(nu*log z + log(kve(nu, z)) - z), so z**nu underflow (which hits
# z < 10**(-308/nu) — well above this threshold for nu > ~38) cannot
# produce 0*inf for ANY nu; the only remaining non-finite source is
# kve() itself overflowing at tiny z, which the isfinite guard maps to
# the same analytic limit.
_MATERN_Z_TINY = 1e-8


def _matern_general_np(r, nu):
    import scipy.special as sps

    r = np.asarray(r)
    z = np.sqrt(2.0 * nu) * r.astype(np.float64)
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        logval = (
            (1.0 - nu) * np.log(2.0)
            - sps.gammaln(nu)
            + nu * np.log(z)
            + np.log(sps.kve(nu, z))
            - z
        )
        val = np.exp(logval)
    ok = (z > _MATERN_Z_TINY) & np.isfinite(logval)
    return np.where(ok, val, 1.0).astype(r.dtype)


def _matern_general_dr_np(r, nu):
    import scipy.special as sps

    r = np.asarray(r)
    a = np.sqrt(2.0 * nu)
    z = a * r.astype(np.float64)
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        # d/dr [coef * z^nu K_nu(z)] = -coef * a * z^nu K_{nu-1}(z);
        # kve handles the negative order (kve(-v, z) == kve(v, z))
        logmag = (
            (1.0 - nu) * np.log(2.0)
            - sps.gammaln(nu)
            + nu * np.log(z)
            + np.log(sps.kve(nu - 1.0, z))
            - z
        )
        val = -np.exp(logmag) * a
    ok = (z > _MATERN_Z_TINY) & np.isfinite(logmag)
    return np.where(ok, val, 0.0).astype(r.dtype)


def _matern_general_compute_dtype():
    # accumulate in f64 where the backend has it (the CPU parity path);
    # f32-only backends run the same code at f32 accuracy
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


@partial(jax.custom_jvp, nondiff_argnums=(1,))
def _matern_general(r, nu):
    from .bessel import log_kve

    dt = r.dtype
    rr = r.astype(_matern_general_compute_dtype())
    a = math.sqrt(2.0 * nu)
    z = a * rr
    logval = (
        (1.0 - nu) * math.log(2.0)
        - math.lgamma(nu)
        + nu * jnp.log(z)
        + log_kve(nu, z)
        - z
    )
    ok = (z > _MATERN_Z_TINY) & jnp.isfinite(logval)
    return jnp.where(ok, jnp.exp(logval), 1.0).astype(dt)


@_matern_general.defjvp
def _matern_general_jvp(nu, primals, tangents):
    from .bessel import log_kve

    (r,) = primals
    (dr,) = tangents
    primal = _matern_general(r, nu)
    dt = r.dtype
    rr = r.astype(_matern_general_compute_dtype())
    a = math.sqrt(2.0 * nu)
    z = a * rr
    # d/dr [coef z^nu K_nu(z)] = -coef a z^nu K_{nu-1}(z); K is even in
    # its order, so |nu-1| handles nu < 1
    logmag = (
        (1.0 - nu) * math.log(2.0)
        - math.lgamma(nu)
        + nu * jnp.log(z)
        + log_kve(abs(nu - 1.0), z)
        - z
    )
    ok = (z > _MATERN_Z_TINY) & jnp.isfinite(logmag)
    grad = jnp.where(ok, -jnp.exp(logmag) * a, 0.0).astype(dt)
    return primal, grad * dr


def sqdist(X, Y, inv_ls):
    """Pairwise squared Euclidean distance of scaled inputs.

    ``inv_ls`` is 1/length_scale, scalar or per-dimension (anisotropic).
    Returns shape (n, m). Uses one matmul.
    """
    Xs = X * inv_ls
    Ys = Y * inv_ls
    d2 = (
        jnp.sum(Xs * Xs, axis=1)[:, None]
        + jnp.sum(Ys * Ys, axis=1)[None, :]
        - 2.0 * jnp.matmul(Xs, Ys.T, precision=jax.lax.Precision.HIGHEST)
    )
    return jnp.maximum(d2, 0.0)


class Kernel:
    """Base class. Subclasses are immutable specs.

    ``n_theta``    number of free (non-fixed) log-space parameters
    ``theta0``     initial log-space parameter vector (np array)
    ``bounds``     (n_theta, 2) log-space bounds (np array; inf for fixed-less)
    ``eval(theta, X, Y)``  full cross-gram; ``Y is None`` means train gram
                   (White contributes only there)
    ``diag(theta, X)``     diagonal of ``eval(theta, X, X)``
    """

    # -- algebra ----------------------------------------------------------
    def __add__(self, other):
        return Sum(self, _as_kernel(other))

    def __radd__(self, other):
        return Sum(_as_kernel(other), self)

    def __mul__(self, other):
        return Product(self, _as_kernel(other))

    def __rmul__(self, other):
        return Product(_as_kernel(other), self)

    def __pow__(self, exponent):
        return Exponentiation(self, float(exponent))

    # -- interface --------------------------------------------------------
    @property
    def n_theta(self) -> int:
        raise NotImplementedError

    @property
    def theta0(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def bounds(self) -> np.ndarray:
        raise NotImplementedError

    def eval(self, theta, X, Y=None):
        raise NotImplementedError

    def diag(self, theta, X):
        raise NotImplementedError

    def with_theta(self, theta) -> "Kernel":
        """Return a copy of this spec whose *initial* values are ``theta``.

        Analogue of sklearn's ``clone_with_theta`` — used to persist a fitted
        theta back into a spec.
        """
        new, rest = self._with_theta(np.asarray(theta, dtype=float))
        assert rest.size == 0, "theta has wrong length"
        return new

    def _with_theta(self, theta):
        raise NotImplementedError


def _as_kernel(x):
    if isinstance(x, Kernel):
        return x
    return ConstantKernel(float(x), "fixed")


def _nb(value_bounds) -> Tuple[bool, np.ndarray]:
    """Normalize a bounds argument -> (fixed, log_bounds array)."""
    if isinstance(value_bounds, str):
        if value_bounds != "fixed":
            raise ValueError(f"Unknown bounds: {value_bounds!r}")
        return True, np.zeros((0, 2))
    lo, hi = value_bounds
    return False, np.log(np.asarray([[lo, hi]], dtype=float))


@dataclass(frozen=True)
class ConstantKernel(Kernel):
    """k(x, y) = constant_value (sklearn ConstantKernel)."""

    constant_value: float = 1.0
    constant_value_bounds: Bounds = (1e-5, 1e5)

    @property
    def _fixed(self):
        return isinstance(self.constant_value_bounds, str)

    @property
    def n_theta(self):
        return 0 if self._fixed else 1

    @property
    def theta0(self):
        if self._fixed:
            return np.zeros(0)
        return np.log(np.asarray([self.constant_value], dtype=float))

    @property
    def bounds(self):
        return _nb(self.constant_value_bounds)[1]

    def _value(self, theta):
        if self._fixed:
            return jnp.asarray(self.constant_value, dtype=jnp.result_type(float))
        return jnp.exp(theta[0])

    def eval(self, theta, X, Y=None):
        m = X.shape[0] if Y is None else Y.shape[0]
        return jnp.full((X.shape[0], m), self._value(theta))

    def diag(self, theta, X):
        return jnp.full((X.shape[0],), self._value(theta))

    def _with_theta(self, theta):
        if self._fixed:
            return self, theta
        return (
            replace(self, constant_value=float(np.exp(theta[0]))),
            theta[1:],
        )


@dataclass(frozen=True)
class WhiteKernel(Kernel):
    """k(x_i, x_j) = noise_level * delta_ij on the training gram only.

    Matches sklearn semantics: on a cross-gram (``Y is not None``) the white
    kernel contributes zeros.
    """

    noise_level: float = 1.0
    noise_level_bounds: Bounds = (1e-5, 1e5)

    @property
    def _fixed(self):
        return isinstance(self.noise_level_bounds, str)

    @property
    def n_theta(self):
        return 0 if self._fixed else 1

    @property
    def theta0(self):
        if self._fixed:
            return np.zeros(0)
        with np.errstate(divide="ignore"):
            return np.log(np.asarray([self.noise_level], dtype=float))

    @property
    def bounds(self):
        return _nb(self.noise_level_bounds)[1]

    def _value(self, theta):
        if self._fixed:
            return jnp.asarray(self.noise_level, dtype=jnp.result_type(float))
        return jnp.exp(theta[0])

    def eval(self, theta, X, Y=None):
        if Y is not None:
            return jnp.zeros((X.shape[0], Y.shape[0]))
        return self._value(theta) * jnp.eye(X.shape[0])

    def diag(self, theta, X):
        return jnp.full((X.shape[0],), self._value(theta))

    def _with_theta(self, theta):
        if self._fixed:
            return self, theta
        return replace(self, noise_level=float(np.exp(theta[0]))), theta[1:]


def _ls_array(length_scale):
    return np.atleast_1d(np.asarray(length_scale, dtype=float))


@dataclass(frozen=True)
class RBF(Kernel):
    """Squared-exponential kernel, isotropic or anisotropic."""

    length_scale: Union[float, Tuple[float, ...]] = 1.0
    length_scale_bounds: Bounds = (1e-5, 1e5)

    @property
    def _fixed(self):
        return isinstance(self.length_scale_bounds, str)

    @property
    def _n_ls(self):
        return _ls_array(self.length_scale).size

    @property
    def anisotropic(self):
        return np.iterable(self.length_scale) and self._n_ls > 1

    @property
    def n_theta(self):
        return 0 if self._fixed else self._n_ls

    @property
    def theta0(self):
        if self._fixed:
            return np.zeros(0)
        return np.log(_ls_array(self.length_scale))

    @property
    def bounds(self):
        if self._fixed:
            return np.zeros((0, 2))
        return np.repeat(_nb(self.length_scale_bounds)[1], self._n_ls, axis=0)

    def _inv_ls(self, theta):
        if self._fixed:
            return 1.0 / jnp.asarray(_ls_array(self.length_scale))
        return jnp.exp(-theta[: self._n_ls])

    def eval(self, theta, X, Y=None):
        Yv = X if Y is None else Y
        d2 = sqdist(X, Yv, self._inv_ls(theta))
        return jnp.exp(-0.5 * d2)

    def diag(self, theta, X):
        return jnp.ones((X.shape[0],))

    def _with_theta(self, theta):
        if self._fixed:
            return self, theta
        n = self._n_ls
        ls = np.exp(theta[:n])
        new_ls = float(ls[0]) if not np.iterable(self.length_scale) else tuple(ls)
        return replace(self, length_scale=new_ls), theta[n:]


@dataclass(frozen=True)
class Matern(RBF):
    """Matern kernel; any positive nu (nu=inf falls back to RBF).

    The reference's default kernel uses nu=2.5 (reference
    ``bask/utils.py:144-150``); nu in {0.5, 1.5, 2.5, inf} have closed
    forms (and the random-Fourier-feature spectra the pathwise sampler
    needs, :func:`match_fusable`). Every other nu evaluates the
    modified-Bessel form fully ON DEVICE (:mod:`bask_tpu.ops.bessel` via
    :func:`_matern_general`) — it works on any backend, including ones
    that reject host callbacks.
    """

    nu: float = 1.5

    def eval(self, theta, X, Y=None):
        Yv = X if Y is None else Y
        d2 = sqdist(X, Yv, self._inv_ls(theta))
        nu = self.nu
        if nu == np.inf:
            return jnp.exp(-0.5 * d2)
        r = jnp.sqrt(d2 + 1e-36)  # eps keeps grad finite at r=0
        if nu == 0.5:
            return jnp.exp(-r)
        if nu == 1.5:
            s = math.sqrt(3.0) * r
            return (1.0 + s) * jnp.exp(-s)
        if nu == 2.5:
            s = math.sqrt(5.0) * r
            return (1.0 + s + s * s / 3.0) * jnp.exp(-s)
        return _matern_general(r, float(nu))


@dataclass(frozen=True)
class Sum(Kernel):
    k1: Kernel = field(default=None)
    k2: Kernel = field(default=None)

    @property
    def n_theta(self):
        return self.k1.n_theta + self.k2.n_theta

    @property
    def theta0(self):
        return np.concatenate([self.k1.theta0, self.k2.theta0])

    @property
    def bounds(self):
        return np.concatenate([self.k1.bounds, self.k2.bounds], axis=0)

    def _split(self, theta):
        n1 = self.k1.n_theta
        return theta[:n1], theta[n1 : self.n_theta]

    def eval(self, theta, X, Y=None):
        t1, t2 = self._split(theta)
        return self.k1.eval(t1, X, Y) + self.k2.eval(t2, X, Y)

    def diag(self, theta, X):
        t1, t2 = self._split(theta)
        return self.k1.diag(t1, X) + self.k2.diag(t2, X)

    def _with_theta(self, theta):
        k1, rest = self.k1._with_theta(theta)
        k2, rest = self.k2._with_theta(rest)
        return Sum(k1, k2), rest


@dataclass(frozen=True)
class Product(Sum):
    def eval(self, theta, X, Y=None):
        t1, t2 = self._split(theta)
        return self.k1.eval(t1, X, Y) * self.k2.eval(t2, X, Y)

    def diag(self, theta, X):
        t1, t2 = self._split(theta)
        return self.k1.diag(t1, X) * self.k2.diag(t2, X)

    def _with_theta(self, theta):
        k1, rest = self.k1._with_theta(theta)
        k2, rest = self.k2._with_theta(rest)
        return Product(k1, k2), rest


@dataclass(frozen=True)
class CompoundKernel(Kernel):
    """Container of independent kernels with concatenated theta.

    Analogue of sklearn's ``CompoundKernel``, which the reference
    special-cases in ``guess_priors`` (``bask/utils.py:74-78``). Like
    upstream it is a parameter-space container, not a covariance
    function usable for GP fitting: ``eval`` returns the *stacked*
    per-kernel grams (n, m, K), matching sklearn's semantics.
    """

    kernels: Tuple[Kernel, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "kernels", tuple(self.kernels))

    @property
    def n_theta(self):
        return sum(k.n_theta for k in self.kernels)

    @property
    def theta0(self):
        if not self.kernels:
            return np.zeros(0)
        return np.concatenate([k.theta0 for k in self.kernels])

    @property
    def bounds(self):
        if not self.kernels:
            return np.zeros((0, 2))
        return np.concatenate([k.bounds for k in self.kernels], axis=0)

    def _split(self, theta):
        out, lo = [], 0
        for k in self.kernels:
            out.append(theta[lo : lo + k.n_theta])
            lo += k.n_theta
        return out

    def eval(self, theta, X, Y=None):
        parts = self._split(theta)
        return jnp.stack(
            [k.eval(t, X, Y) for k, t in zip(self.kernels, parts)], axis=-1
        )

    def diag(self, theta, X):
        parts = self._split(theta)
        return jnp.stack(
            [k.diag(t, X) for k, t in zip(self.kernels, parts)], axis=-1
        )

    def _with_theta(self, theta):
        new = []
        rest = theta
        for k in self.kernels:
            nk, rest = k._with_theta(rest)
            new.append(nk)
        return CompoundKernel(tuple(new)), rest


@dataclass(frozen=True)
class Exponentiation(Kernel):
    kernel: Kernel = field(default=None)
    exponent: float = 1.0

    @property
    def n_theta(self):
        return self.kernel.n_theta

    @property
    def theta0(self):
        return self.kernel.theta0

    @property
    def bounds(self):
        return self.kernel.bounds

    def eval(self, theta, X, Y=None):
        return self.kernel.eval(theta, X, Y) ** self.exponent

    def diag(self, theta, X):
        return self.kernel.diag(theta, X) ** self.exponent

    def _with_theta(self, theta):
        k, rest = self.kernel._with_theta(theta)
        return Exponentiation(k, self.exponent), rest


# ---------------------------------------------------------------------------
# Structure helpers (used by guess_priors and the white-noise machinery)
# ---------------------------------------------------------------------------


def iter_leaves(kernel):
    """Depth-first leaf iterator in sklearn theta order."""
    if isinstance(kernel, Exponentiation):
        yield from iter_leaves(kernel.kernel)
    elif isinstance(kernel, CompoundKernel):
        # reference guess_priors special-case (bask/utils.py:74-78):
        # traverse each member kernel in order
        for k in kernel.kernels:
            yield from iter_leaves(k)
    elif isinstance(kernel, (Sum, Product)):
        yield from iter_leaves(kernel.k1)
        yield from iter_leaves(kernel.k2)
    else:
        yield kernel


def white_theta_index(kernel):
    """Index into theta of the WhiteKernel noise parameter of a top-level Sum.

    Mirrors ``_param_for_white_kernel_in_Sum`` (used by the reference's
    ``noise_set_to_zero``, ``bask/bayesgpr.py:318-336``): looks for a
    WhiteKernel *summand*, recursing only through Sum nodes — a
    WhiteKernel inside a Product is a multiplicative factor, not
    additive noise, and zeroing it would zero the whole product term.
    Returns None if absent or fixed.
    """

    def scan(k, offset):
        if isinstance(k, WhiteKernel) and k.n_theta == 1:
            return offset
        if type(k) is Sum:  # NB: Product subclasses Sum here
            hit = scan(k.k1, offset)
            if hit is not None:
                return hit
            return scan(k.k2, offset + k.k1.n_theta)
        return None

    return scan(kernel, 0)


class FusedSpec(NamedTuple):
    """Trace-time description of a ``Constant * (Matern|RBF) [+ White]``
    kernel tree: the structure the pathwise sampler has closed-form
    spectra and a flat parameter layout for."""

    nu: float  # 0.5 / 1.5 / 2.5 / inf (inf = RBF)
    n_ls: int  # number of lengthscales (1 = isotropic)
    has_const: bool  # leading ConstantKernel amplitude param
    has_white: bool  # trailing WhiteKernel noise param


def match_fusable(kernel) -> Optional[FusedSpec]:
    """Match ``Constant * (Matern|RBF) [+ White]`` (free params only) —
    the default BO kernel family (reference ``bask/utils.py:127-151``)."""
    base = kernel
    has_white = False
    # NB: Product subclasses Sum in the kernel algebra; use exact type.
    if type(base) is Sum:
        if not (isinstance(base.k2, WhiteKernel) and base.k2.n_theta == 1):
            return None
        has_white = True
        base = base.k1
    has_const = False
    if type(base) is Product:
        if not (
            isinstance(base.k1, ConstantKernel) and base.k1.n_theta == 1
        ):
            return None
        has_const = True
        base = base.k2
    if not isinstance(base, RBF) or base.n_theta == 0:
        return None
    nu = base.nu if isinstance(base, Matern) else math.inf
    if nu not in (0.5, 1.5, 2.5, math.inf):
        return None
    return FusedSpec(
        nu=nu, n_ls=base.n_theta, has_const=has_const, has_white=has_white
    )
