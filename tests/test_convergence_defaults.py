"""Round-5 convergence-honest defaults.

The reference ships NO convergence signal at all (its sampler loop,
``bask/bayesgpr.py:381-548``, keeps whatever emcee returns silently).
bask-tpu's defaults must not reproduce that silence:

* ``BayesGPR(moves="auto")`` (the default) resolves to the measured
  fastest honest sampler the walker count supports (demix at W>=6, DE
  at W>=4, stretch below — the north-star convergence ladder).
* ``sample()/fit()`` warn at max split R-hat > 1.1 by default whenever
  the kept chain is long enough to judge (>= 4 kept steps).
* ``Optimizer.tell``'s COLD fit samples to R-hat <= 1.1 by default
  (warm chunk extensions); warm refits stay on the fused fast path and
  the deferred-fetch finalize still applies the default guard.
"""

import warnings

import numpy as np
import pytest

from bask_tpu.models.bayesgpr import BayesGPR, DEFAULT_WARN_RHAT
from bask_tpu.ops import kernels as bk


def _problem(n=16, d=2, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.uniform(size=(n, d))
    y = np.sum((X - 0.5) ** 2, axis=1)
    kernel = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.RBF(
        (0.3,) * d, (0.05, 2.0)
    )
    return X, y, kernel


def test_default_warn_rhat_is_standard_threshold():
    assert DEFAULT_WARN_RHAT == 1.1


def test_default_sample_warns_on_unconverged_judgeable_chain():
    """Zero extra kwargs: a judgeable (>=4 kept steps) unconverged chain
    warns by default; warn_rhat=None restores the reference's silence."""
    X, y, kernel = _problem()
    gp = BayesGPR(kernel=kernel, random_state=0)
    # 80 samples over 10 walkers = 8 kept steps of a fresh ball: max
    # split R-hat over so short a chain is far above 1.1
    with pytest.warns(UserWarning, match="split R-hat"):
        gp.fit(X, y, n_burnin=0, n_desired_samples=80,
               n_walkers_per_thread=10, progress=False)

    gp2 = BayesGPR(kernel=kernel, random_state=0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        gp2.fit(X, y, n_burnin=0, n_desired_samples=80,
                n_walkers_per_thread=10, progress=False, warn_rhat=None)
    # the guard changes nothing about the chain itself
    np.testing.assert_array_equal(gp.chain_, gp2.chain_)


def test_default_fit_shape_too_short_to_judge_stays_silent():
    """The reference-shaped default (100 samples / 100 walkers = 1 kept
    step) carries no honest estimate and must not warn spuriously."""
    X, y, kernel = _problem()
    gp = BayesGPR(kernel=kernel, random_state=0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        gp.fit(X, y, progress=False)


def test_auto_moves_ladder_by_walker_count():
    """"auto" resolves per-call from the ACTUAL walker count:
    demix at W>=6, DE at W>=4, pure stretch below — each bit-identical
    to the explicit spelling at the same seed."""
    X, y, kernel = _problem()

    def chain(moves, wpt):
        gp = BayesGPR(kernel=kernel, random_state=0, moves=moves)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            gp.fit(X, y, n_burnin=2, n_desired_samples=4 * wpt,
                   n_walkers_per_thread=wpt, progress=False)
        return gp.chain_

    np.testing.assert_array_equal(chain("auto", 10), chain("demix", 10))
    np.testing.assert_array_equal(chain("auto", 4), chain("de", 4))
    np.testing.assert_array_equal(chain("auto", 2), chain("stretch", 2))
    # and the small-ensemble resolutions never hit the walker-count
    # validation the explicit demix spelling would trip at W=4
    with pytest.raises(ValueError, match="walker"):
        chain("demix", 4)


def test_optimizer_cold_fit_converges_by_default():
    """A fresh-user BO loop converges-or-warns with zero extra kwargs:
    the first full refit runs the until_rhat extension loop (so the kept
    chain grows past the base run's single step) and records a
    machine-readable verdict; gp_sample_kwargs={"until_rhat": None}
    opts out back to the reference's 1-kept-step silence."""
    import bask_tpu as bt

    def f(x):
        return float((x[0] - 0.3) ** 2)

    opt = bt.Optimizer(
        dimensions=[(-1.0, 1.0)], n_initial_points=2, random_state=7,
        n_points=16,
        # keep the CPU test bounded; until_rhat itself is the default
        gp_sample_kwargs={"max_extensions": 2, "extension_steps": 8},
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        # the 2nd tell exhausts n_initial_points and runs the COLD fit
        for _ in range(2):
            x = opt.ask()
            opt.tell(x, f(x), gp_samples=20, gp_burnin=2)
        assert opt.gp.until_rhat_result_ is not None
        assert opt.gp.until_rhat_result_["threshold"] == 1.1
        # base run kept 1 step; the default convergence loop extended it
        assert opt.gp.until_rhat_result_["steps"] > 1
        # warm refits are plain fast-path samples: the cold verdict is
        # cleared (it described a different chain), not re-reported
        x = opt.ask()
        opt.tell(x, f(x), gp_samples=20, gp_burnin=2)
        assert opt.gp.until_rhat_result_ is None

    opt2 = bt.Optimizer(
        dimensions=[(-1.0, 1.0)], n_initial_points=2, random_state=7,
        n_points=16, gp_sample_kwargs={"until_rhat": None},
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(3):
            x = opt2.ask()
            opt2.tell(x, f(x), gp_samples=20, gp_burnin=2)
    assert opt2.gp.until_rhat_result_ is None
    assert opt2.gp.chain_steps_.shape[0] == 1


def test_deferred_finalize_applies_default_guard():
    """The fused warm-tell path must not lose the convergence guard:
    the R-hat check runs at finalize time (kept steps are host-side
    there), so an unconverged warm refit still surfaces a UserWarning
    from tell() — outside its refit warning suppression."""
    import bask_tpu as bt

    def f(x):
        return float((x[0] - 0.3) ** 2)

    opt = bt.Optimizer(
        dimensions=[(-1.0, 1.0)], n_initial_points=2, random_state=7,
        n_points=16,
        # impossible threshold -> the warm refits' deferred finalize
        # must warn every tell; until_rhat bounded for CPU speed
        gp_sample_kwargs={"warn_rhat": 0.5, "max_extensions": 1,
                          "extension_steps": 8},
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(3):
            x = opt.ask()
            # gp_samples=400 -> 4 kept steps per warm refit (judgeable)
            opt.tell(x, f(x), gp_samples=400, gp_burnin=2)
    # warm tell: deferred-fetch path pending -> finalize carries the
    # guard; assert the warning actually crosses tell's boundary
    x = opt.ask()
    with pytest.warns(UserWarning, match="split R-hat"):
        opt.tell(x, f(x), gp_samples=400, gp_burnin=2)
