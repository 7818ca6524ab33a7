"""Ask/tell Bayesian optimization loop with stopping-rule diagnostics.

Capability parity with the reference ``Optimizer``
(``bask/optimizer.py:35-689``): the same acquisition registry, init
strategies ("sb", "r2", "random"), per-point noise vectors, GP warm-start
cadence (full ``fit`` once, cheap ``sample`` afterwards), and the three
diagnostics ``probability_of_optimality`` / ``expected_optimality_gap`` /
``optimum_intervals``.

The device work per ``tell`` is two fused programs: the MCMC chain
(``BayesGPR.sample``) and the marginalized acquisition pass
(``evaluate_acquisitions``); the host only orchestrates.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np

from . import acquisition as acq_mod
from .acquisition import evaluate_acquisitions
from .models.bayesgpr import BayesGPR
from .space import normalize_dimensions
from .utils.init_seq import r2_sequence, sb_sequence
from .utils.priors import construct_default_kernel
from .utils.result import create_result, expected_minimum
from .utils.stats import hdi

__all__ = ["Optimizer", "ACQUISITION_FUNC"]

ACQUISITION_FUNC = {
    "ei": acq_mod.ExpectedImprovement(),
    "lcb": acq_mod.LCB(),
    "mean": acq_mod.Expectation(),
    "mes": acq_mod.MaxValueSearch(),
    "pvrs": acq_mod.PVRS(),
    "ts": acq_mod.ThompsonSampling(),
    "ttei": acq_mod.TopTwoEI(),
    "vr": acq_mod.VarianceReduction(),
}


def _is_listlike(x):
    return isinstance(x, (list, tuple, np.ndarray))


def _is_2dlistlike(x):
    return _is_listlike(x) and len(x) > 0 and all(_is_listlike(p) for p in x)


class Optimizer:
    """Stepwise Bayesian optimization over a search space.

    Parameters follow the reference (``bask/optimizer.py:38-117``):
    ``dimensions`` (tuples / category lists / Dimension objects),
    ``n_points`` candidate-grid size, ``n_initial_points`` +
    ``init_strategy`` in {"sb", "r2", "random"}, ``gp_kernel`` /
    ``gp_kwargs`` / ``gp_priors``, ``acq_func`` from
    :data:`ACQUISITION_FUNC` or a custom :class:`Acquisition`, and
    ``random_state``. Unknown kwargs are tolerated.

    ``mesh``: optional single-axis ``jax.sharding.Mesh`` — every GP
    refit shards the walker ensemble across it (data-parallel batched
    LML; the stretch move's complementary-half gather is the only
    collective). Results are bit-identical to the unsharded run; the
    reference has no distributed execution at all (SURVEY.md §2).

    ``gp_sample_kwargs``: extra keyword arguments forwarded to every GP
    refit's ``BayesGPR.sample``/``fit`` call inside :meth:`tell` —
    e.g. ``{"moves": "demix"}`` for the measured fast-convergence move
    mixture, or ``{"until_rhat": 1.1}`` for converged refits (the
    latter disables the single-fetch warm-tell overlap, since the
    extension loop needs host-side chain state after every leg).
    """

    def __init__(
        self,
        dimensions,
        n_points: int = 500,
        n_initial_points: int = 10,
        init_strategy: Optional[str] = "sb",
        gp_kernel=None,
        gp_kwargs: Optional[dict] = None,
        gp_priors=None,
        acq_func="pvrs",
        acq_func_kwargs: Optional[dict] = None,
        random_state=None,
        mesh=None,
        gp_sample_kwargs: Optional[dict] = None,
        acq_polish: int = 0,
        acq_polish_starts: int = 4,
        acq_polish_lr: float = 0.05,
        **kwargs,
    ):
        if isinstance(random_state, np.random.RandomState):
            self.rng = random_state
        else:
            self.rng = np.random.RandomState(random_state)

        if callable(acq_func):
            self.acq_func = acq_func
        else:
            self.acq_func = ACQUISITION_FUNC[acq_func]
        self.acq_func_kwargs = acq_func_kwargs or {}

        self.space = normalize_dimensions(dimensions)
        self._n_initial_points = n_initial_points
        self.n_initial_points_ = n_initial_points
        self.init_strategy = init_strategy
        if self.init_strategy == "r2":
            self._initial_points = self.space.inverse_transform(
                r2_sequence(n=n_initial_points, d=self.space.transformed_n_dims)
            )
        elif self.init_strategy == "sb":
            self._init_rng = np.random.RandomState(self.rng.randint(2**31))
        self.n_points = n_points

        gp_kwargs = dict(gp_kwargs or {})
        if gp_kwargs.get("row_mesh") is not None:
            # acquisition evaluation marginalizes per-draw posteriors —
            # (W, n, n) working sets row-sharded mode exists to avoid.
            # The BO loop's n grows one point per tell and never reaches
            # the beyond-one-chip regime; shard walkers instead.
            raise ValueError(
                "row_mesh is a BayesGPR regression-scale feature and is "
                "not supported inside Optimizer; use Optimizer(mesh=...) "
                "walker sharding for multi-device BO loops."
            )
        if gp_kernel is None:
            gp_kernel = construct_default_kernel(
                list(range(self.space.transformed_n_dims))
            )
        self.gp = BayesGPR(
            kernel=gp_kernel,
            random_state=self.rng.randint(0, np.iinfo(np.int32).max),
            **gp_kwargs,
        )
        self.gp_priors = gp_priors
        self.mesh = mesh
        self.gp_sample_kwargs = dict(gp_sample_kwargs or {})
        # gradient-polished argmax (opt-in, beyond reference): after the
        # grid pass, run `acq_polish` Adam steps on the acquisition
        # surface from the top `acq_polish_starts` grid points using the
        # GP's analytic prediction gradients (acquisition
        # .polish_acquisition). The reference stops at the 500-point
        # random grid (bask/optimizer.py:353-376). Skipped for
        # acquisitions with no coherent pointwise surface (MES/TS),
        # categorical spaces, and custom acquisition classes — with a
        # one-time warning so "I turned it on" is never silently off.
        self.acq_polish = int(acq_polish)
        self.acq_polish_starts = int(acq_polish_starts)
        self.acq_polish_lr = float(acq_polish_lr)
        self._polish_noop_warned = False
        if self.acq_polish > 0 and self.space.is_partly_categorical:
            warnings.warn(
                "acq_polish is ignored on (partly) categorical spaces: "
                "the acquisition surface is not differentiable across "
                "category one-hots; the grid argmax is used.",
                UserWarning,
            )
            self._polish_noop_warned = True

        self.Xi = []
        self.yi = []
        self.noisei = []
        self._next_x = None

    # ------------------------------------------------------------------

    def ask(self, n_points: int = 1):
        """Next point(s) to evaluate.

        ``n_points=1`` (default) returns the init-phase design point or
        the cached acquisition argmax computed by the last ``tell``.

        ``n_points>1`` returns a *batch*: during initialization, the next
        ``n_points`` design points; after fitting, one candidate per
        Thompson sample of the GP posterior over a fresh candidate grid
        (the whole batch computed in one fused device pass). The
        reference raises NotImplementedError here
        (``bask/optimizer.py:201-204``); batch proposals are first-class
        in bask-tpu.
        """
        if n_points > 1:
            return self._ask_batch(n_points)
        if self._n_initial_points > 0:
            if self.init_strategy == "r2":
                return self._initial_points[self._n_initial_points - 1]
            if self.init_strategy == "sb":
                existing = (
                    self.space.transform(self.Xi) if len(self.Xi) else None
                )
                pts = sb_sequence(
                    n=len(self.Xi) + 1,
                    d=self.space.transformed_n_dims,
                    existing_points=existing,
                    random_state=self._init_rng.randint(2**31),
                )
                return self.space.inverse_transform(
                    np.atleast_2d(pts[len(self.Xi)])
                )[0]
            return self.space.rvs(random_state=self.rng)[0]
        if self.gp.kernel_ is None:
            raise RuntimeError(
                "Initialization is finished, but no model has been fit."
            )
        return self._next_x

    def _ask_batch(self, n_points: int):
        """Batch proposal via Thompson sampling over a fresh candidate grid.

        Each returned point is the argmin of one joint posterior draw —
        one fused ``sample_y`` pass on device, batch-size-independent
        host logic. Duplicate argmins are replaced by the best remaining
        candidates of their draw.
        """
        if self._n_initial_points > 0:
            # hand out the next init-phase design points
            out = []
            if self.init_strategy == "r2":
                for k in range(n_points):
                    idx = self._n_initial_points - 1 - k
                    if idx >= 0:
                        out.append(self._initial_points[idx])
                    else:
                        out.append(self.space.rvs(random_state=self.rng)[0])
                return out
            if self.init_strategy == "sb":
                existing = (
                    self.space.transform(self.Xi) if len(self.Xi) else None
                )
                pts = sb_sequence(
                    n=len(self.Xi) + n_points,
                    d=self.space.transformed_n_dims,
                    existing_points=existing,
                    random_state=self._init_rng.randint(2**31),
                )
                return self.space.inverse_transform(pts[len(self.Xi) :])
            return self.space.rvs(n_samples=n_points, random_state=self.rng)
        if self.gp.kernel_ is None:
            raise RuntimeError(
                "Initialization is finished, but no model has been fit."
            )
        X = self._candidate_grid()  # warp-density candidates when warping
        if n_points > len(X):
            raise ValueError(
                f"ask(n_points={n_points}) exceeds the candidate grid "
                f"size ({len(X)}); raise Optimizer(n_points=...)"
            )
        seed = self.rng.randint(0, np.iinfo(np.int32).max)
        if len(X) > 2048:
            # exact joint draws need an O(m^3) factorization of the
            # candidate covariance; switch to pathwise sampling, whose
            # cost is linear in the candidate count. Top-k selection
            # happens on device so the (n_cand, n_points) draw matrix
            # never crosses to the host.
            try:
                order = self.gp.thompson_argmin_pathwise(
                    X,
                    n_samples=n_points,
                    top_k=min(max(2 * n_points, 8), len(X)),
                    random_state=seed,
                    sample_mean=False,  # hyperposterior-marginal draws,
                    # matching the exact path's semantics
                ).T  # (k, n_points)
            except NotImplementedError:
                # exact joint draws build an (m, m) predictive covariance
                # per draw — subsample the grid so a non-fusable kernel
                # degrades gracefully instead of OOMing at 65k candidates
                keep = self.rng.choice(
                    len(X), size=max(2048, n_points), replace=False
                )
                X = X[keep]
                order = np.argsort(
                    self.gp.sample_y(
                        X, n_samples=n_points, random_state=seed
                    ),
                    axis=0,
                )
        else:
            draws = self.gp.sample_y(
                X, n_samples=n_points, random_state=seed
            )  # (n_cand, n_points)
            order = np.argsort(draws, axis=0)
        chosen, used = [], set()
        for j in range(n_points):
            picked = None
            for idx in order[:, j]:
                if int(idx) not in used:
                    picked = int(idx)
                    break
            if picked is None:  # all of this draw's top-k already taken
                picked = next(
                    i for i in range(len(X)) if i not in used
                )
            used.add(picked)
            chosen.append(picked)
        return self.space.inverse_transform(X[chosen])

    def _candidate_grid(self):
        """Fresh uniform candidate grid in the (unwarped) GP space.

        With input warping on, candidates are drawn uniformly in the
        *warped* space and mapped back, so their density follows the
        learned warp (reference behavior, ``bask/optimizer.py:353-363``).
        """
        d = self.space.transformed_n_dims
        if self.gp.warp_inputs:
            return self.gp.unwarp(
                self.rng.uniform(size=(self.n_points, d))
            )
        return self.space.transform(
            self.space.rvs(n_samples=self.n_points, random_state=self.rng)
        )

    @staticmethod
    def _coerce_observations(x, y, noise_vector):
        """Normalize a tell() payload to parallel lists (X, y, noise).

        Accepts either one point (``x`` list-like, ``y`` scalar, noise
        scalar/None) or a batch (``x`` 2-D list-like, ``y`` list-like,
        noise list-like/None). Mixed or mismatched shapes raise.
        """
        batched = _is_listlike(y) and _is_2dlistlike(x)
        if batched:
            xs = [list(p) for p in x]
            ys = [float(v) for v in y]
            if noise_vector is None:
                return xs, ys, [0.0] * len(ys)
            bad = not _is_listlike(noise_vector) or len(noise_vector) != len(ys)
            if bad:
                raise ValueError(
                    "Vector of noise variances needs to be of equal length as y."
                )
            return xs, ys, [float(v) for v in noise_vector]
        if not _is_listlike(x):
            raise ValueError(
                f"Incompatible argument types: x ({type(x)}) and y ({type(y)})"
            )
        if _is_listlike(noise_vector):
            raise ValueError(
                "Vector of noise variances passed with a single point."
            )
        noise = 0.0 if noise_vector is None else float(noise_vector)
        return [list(x)], [float(y)], [noise]

    def tell(
        self,
        x,
        y,
        noise_vector=None,
        fit: bool = True,
        replace: bool = False,
        n_samples: int = 0,
        gp_samples: int = 100,
        gp_burnin: int = 10,
        progress: bool = False,
    ):
        """Report objective value(s) and (optionally) refit + precompute
        the next proposal. Returns a scipy OptimizeResult."""
        if replace:
            self.Xi, self.yi, self.noisei = [], [], []
            self._n_initial_points = self.n_initial_points_
        xs, ys, ns = self._coerce_observations(x, y, noise_vector)
        self.Xi += xs
        self.yi += ys
        self.noisei += ns
        self._n_initial_points -= len(ys)

        if fit and self._n_initial_points <= 0:
            import time as _time

            if (
                self.gp_priors is not None
                and not callable(self.gp_priors)
                and len(self.gp_priors) != self.space.transformed_n_dims + 2
            ):
                raise ValueError(
                    "The number of priors does not match the number of "
                    "dimensions + 2."
                )
            t_fit = _time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                common = dict(
                    noise_vector=np.asarray(self.noisei),
                    priors=self.gp_priors,
                    n_desired_samples=gp_samples,
                    n_burnin=gp_burnin,
                    progress=progress,
                    mesh=self.mesh,
                )
                # user keys OVERRIDE the defaults (a dict-literal **
                # merge would raise on overlap instead)
                common.update(self.gp_sample_kwargs)
                if self.gp.pos_ is None or replace:
                    # Convergence-honest first fit: the cold fit is the
                    # one refit with real non-convergence risk (every
                    # later refit warm-starts from a mixed ensemble and
                    # only tracks a one-observation posterior shift), so
                    # it samples to R-hat <= 1.1 by default, warm-
                    # extending in the hardware-validated 300-step
                    # chunks and warning if the budget runs out. The
                    # reference's first fit is 11 silent steps
                    # (bask/optimizer.py:248-270 + bask/bayesgpr.py:381).
                    # Opt out (or re-tune) via
                    # gp_sample_kwargs={"until_rhat": None}.
                    cold = dict(common)
                    if "until_rhat" not in cold:
                        cold["until_rhat"] = 1.1
                        cold.setdefault("max_extensions", 12)
                        cold.setdefault("extension_steps", 300)
                    self.gp.fit(
                        self.space.transform(self.Xi), self.yi, **cold
                    )
                else:
                    # warm refit: defer the device->host fetch so the
                    # acquisition program below is dispatched against the
                    # device-resident consensus outputs and BOTH
                    # programs' host-bound results cross in ONE packed
                    # fetch (one round-trip latency instead of two)
                    self.gp.sample(
                        self.space.transform(self.Xi),
                        self.yi,
                        _defer_fetch=True,
                        **common,
                    )
            # the catch_warnings block above suppresses GP warnings;
            # a failed until_rhat refit must still be visible
            ur = getattr(self.gp, "until_rhat_result_", None)
            if ur is not None and not ur["converged"]:
                warnings.warn(
                    f"GP refit did not reach R-hat <= {ur['threshold']} "
                    f"within the extension budget (max split R-hat "
                    f"{ur['rhat']:.3f} after {ur['steps']} kept steps); "
                    "proceeding with the consensus estimate.",
                    UserWarning,
                    stacklevel=2,
                )

            t_acq = _time.perf_counter()
            try:
                X = self._candidate_grid()
                acq_seed = self.rng.randint(0, np.iinfo(np.int32).max)
                # one fused device program for supported acquisitions
                # (the warm-tell hot path); bit-identical legacy
                # fallback for custom/unhashable configurations
                res = acq_mod.evaluate_acquisitions_fused(
                    X=X,
                    gpr=self.gp,
                    acq=self.acq_func,
                    n_samples=n_samples,
                    random_state=acq_seed,
                    _defer=self.gp._pending is not None,
                    **self.acq_func_kwargs,
                )
                if isinstance(res, tuple):
                    # overlapped path: one combined fetch for the sample
                    # blob + acquisition values, then host postprocess
                    vals_dev, shape, post_fn = res
                    acq_out = post_fn(
                        self.gp._finalize_sample(vals_dev, shape)
                    )
                else:
                    # not fusable (or not deferred): materialize the
                    # pending sample (no-op when nothing is pending)
                    # before any legacy host-side evaluation
                    self.gp._finalize_sample()
                    acq_out = res
                if acq_out is None:
                    acq_out = evaluate_acquisitions(
                        X=X,
                        gpr=self.gp,
                        acquisition_functions=(self.acq_func,),
                        n_samples=n_samples,
                        progress=False,
                        random_state=acq_seed,
                        **self.acq_func_kwargs,
                    )
            finally:
                # safety net: never let a deferred sample escape tell()
                self.gp._finalize_sample()
            acq_values = acq_out.flatten()
            best_x_t = X[np.argmax(acq_values)]
            if self.acq_polish > 0 and not self.space.is_partly_categorical:
                # top-k grid points (always including the argmax) seed a
                # few Adam steps on the differentiable acquisition
                # surface; the polished winner is compared WITHIN the
                # polish program's own MC draws (best-tracking ascent
                # never returns worse than its start there)
                k = min(self.acq_polish_starts, len(X))
                top = np.argsort(acq_values)[-k:]
                polished = acq_mod.polish_acquisition(
                    X[top],
                    gpr=self.gp,
                    acq=self.acq_func,
                    n_samples=n_samples,
                    random_state=self.rng.randint(0, np.iinfo(np.int32).max),
                    n_steps=self.acq_polish,
                    lr=self.acq_polish_lr,
                    X_pool=X,
                    **self.acq_func_kwargs,
                )
                if polished is not None:
                    xb, vb = polished
                    best_x_t = xb[int(np.argmax(vb))]
                elif not self._polish_noop_warned:
                    self._polish_noop_warned = True
                    reason = acq_mod.polish_noop_reason(
                        self.acq_func, n_samples=n_samples,
                        **self.acq_func_kwargs,
                    ) or "unsupported configuration"
                    warnings.warn(
                        f"acq_polish is inactive: {reason}; the grid "
                        "argmax is used.",
                        UserWarning,
                    )
            self._next_x = self.space.inverse_transform(
                best_x_t[None, :]
            )[0]
            # lightweight per-phase observability (the reference exposes
            # none, SURVEY.md §5): wall-clock of the MCMC refit and the
            # acquisition pass for the last tell
            # NOTE: on the overlapped warm path the sample program is
            # dispatched asynchronously, so gp_fit_s measures dispatch
            # (+ any ML-II host work on cold fits) and acquisition_s
            # carries the joint device compute + the single combined
            # fetch of both programs' outputs
            done = _time.perf_counter()
            self.last_timings_ = {
                "gp_fit_s": t_acq - t_fit,
                "acquisition_s": done - t_acq,
                "mcmc_acceptance": (
                    self.gp.n_accepted_ / max(self.gp.n_proposals_, 1)
                    if hasattr(self.gp, "n_accepted_")
                    else None
                ),
            }

        return create_result(
            self.Xi, self.yi, self.space, self.rng, models=[self.gp]
        )

    def run(
        self,
        func,
        n_iter: int = 1,
        replace: bool = False,
        n_samples: int = 5,
        gp_samples: int = 100,
        gp_burnin: int = 10,
    ):
        """Drive the ask/tell loop on ``func`` (scalar or (value, noise))."""
        for _ in range(n_iter):
            x = self.ask()
            out = func(x)
            if hasattr(out, "__len__"):
                val, noise = out
            else:
                val, noise = out, 0.0
            self.tell(
                x,
                val,
                noise_vector=noise,
                n_samples=n_samples,
                gp_samples=gp_samples,
                gp_burnin=gp_burnin,
                replace=replace,
            )
            replace = False
        return create_result(
            self.Xi, self.yi, self.space, self.rng, models=[self.gp]
        )

    # -- stopping-rule diagnostics (reference bask/optimizer.py:447-689) --

    def probability_of_optimality(
        self,
        threshold,
        n_space_samples: int = 500,
        n_gp_samples: int = 200,
        n_random_starts: int = 100,
        use_mean_gp: bool = True,
        normalized_scores: bool = True,
        random_state=None,
    ):
        """Monte-Carlo probability that the current expected optimum is
        within ``threshold`` of the true optimum under the GP posterior."""
        result = create_result(
            self.Xi, self.yi, self.space, self.rng, models=[self.gp]
        )
        X_orig = [
            expected_minimum(
                result,
                random_state=random_state,
                n_random_starts=n_random_starts,
            )[0]
        ]
        X_orig.extend(
            self.space.rvs(n_samples=n_space_samples, random_state=random_state)
        )
        X_trans = self.space.transform(X_orig)
        score_samples = self.gp.sample_y(
            X_trans,
            n_samples=n_gp_samples,
            sample_mean=use_mean_gp,
            random_state=random_state,
        )
        if normalized_scores:
            std = np.std(score_samples, axis=0)
            std = np.where(std > 0, std, 1.0)

        thresholds = threshold if _is_listlike(threshold) else [threshold]
        probabilities = []
        for eps in thresholds:
            diff = score_samples[0][None, :] - score_samples
            if normalized_scores:
                diff = diff / std
            probabilities.append(
                float((((diff - eps).max(axis=0)) < 0.0).mean())
            )
        if len(probabilities) == 1:
            return probabilities[0]
        return probabilities

    def expected_optimality_gap(
        self,
        max_tries: int = 3,
        n_probabilities: int = 50,
        n_space_samples: int = 500,
        n_gp_samples: int = 200,
        n_random_starts: int = 100,
        tol: float = 0.01,
        use_mean_gp: bool = True,
        normalized_scores: bool = True,
        random_state=None,
    ):
        """Expected optimality gap by integrating the gap CDF estimated
        from ``probability_of_optimality`` over thresholds."""
        from scipy.optimize import minimize_scalar

        if not isinstance(random_state, np.random.RandomState):
            random_state = np.random.RandomState(random_state)
        seed = random_state.randint(0, 2**31 - 1)

        def func(threshold):
            prob = self.probability_of_optimality(
                threshold=threshold,
                n_random_starts=n_random_starts,
                n_gp_samples=n_gp_samples,
                n_space_samples=n_space_samples,
                use_mean_gp=use_mean_gp,
                normalized_scores=normalized_scores,
                random_state=seed,
            )
            return (prob - 1.0) ** 2 + threshold**2 * 1e-3

        max_gap = float(np.max(self.yi) - np.min(self.yi))
        upper = None
        for _ in range(max_tries):
            try:
                upper = minimize_scalar(
                    func, bounds=(0.0, max_gap), method="bounded", tol=tol
                ).x
                break
            except ValueError:
                continue
        if upper is None:
            raise ValueError("Determining the upper threshold was not possible.")

        thresholds = list(np.linspace(0.0, upper, num=n_probabilities))
        probabilities = self.probability_of_optimality(
            thresholds,
            n_random_starts=n_random_starts,
            n_gp_samples=n_gp_samples,
            n_space_samples=n_space_samples,
            use_mean_gp=use_mean_gp,
            normalized_scores=normalized_scores,
            random_state=seed,
        )
        gap = 0.0
        for i in range(len(probabilities) - 1):
            gap += (probabilities[i + 1] - probabilities[i]) * thresholds[i + 1]
        return gap

    def optimum_intervals(
        self,
        hdi_prob: float = 0.95,
        multimodal: bool = True,
        opt_samples: int = 200,
        space_samples: int = 500,
        only_mean: bool = True,
        random_state=None,
    ):
        """Highest-density intervals of the optimum location per dimension
        via Thompson sampling (replaces arviz.hdi with the in-house
        estimator)."""
        if self.space.is_partly_categorical:
            raise NotImplementedError(
                "Highest density intervals not supported for categorical "
                "dimensions."
            )
        X = self.space.rvs(n_samples=space_samples, random_state=random_state)
        Xt = self.space.transform(X)
        optimum_samples = self.gp.sample_y(
            Xt,
            sample_mean=only_mean,
            n_samples=opt_samples,
            random_state=random_state,
        )
        X_opt = Xt[np.argmin(optimum_samples, axis=0)]
        intervals = []
        for i, col in enumerate(X_opt.T):
            raw = hdi(col, hdi_prob=hdi_prob, multimodal=multimodal)
            dim = self.space.dimensions[i]
            intervals.append(np.asarray(dim.inverse_transform(raw)))
        return intervals
