"""Fused warm-tell path (VERDICT r2 #1).

The warm BO iteration used to cost ~10 separate device programs (chain,
median, posterior, eager LML chain, eager Thompson draws, scores,
per-draw predictions, acquisition eval); it now runs as TWO fused
programs — ``_fused_sample`` (chain -> median -> consensus posterior ->
LML) and one fused acquisition program — with BIT-IDENTICAL results to
the legacy multi-dispatch path (pinned here on the CPU backend).
"""

import numpy as np
import pytest

import bask_tpu.acquisition as am
import bask_tpu.models.bayesgpr as bg
from bask_tpu import Optimizer
from bask_tpu.ops import kernels as bk


@pytest.fixture
def fused_switch():
    """Restore the fused-path flags after each test."""
    yield
    bg.FUSED_SAMPLE = "on"
    am.FUSED_ACQUISITION = "on"


def _fit_gp(warp):
    rng = np.random.RandomState(0)
    X = rng.uniform(size=(9, 2))
    y = np.sin(3 * X[:, 0]) + 0.1 * rng.randn(9)
    gp = bg.BayesGPR(
        kernel=bk.ConstantKernel(1.0, (0.1, 2.0))
        * bk.Matern((0.3, 0.3), (0.05, 2.0), nu=2.5),
        random_state=7,
        warp_inputs=warp,
    )
    gp.fit(
        X, y, n_desired_samples=40, n_burnin=3, n_walkers_per_thread=10,
        progress=False,
    )
    return gp


@pytest.mark.parametrize("warp", [False, True])
def test_fused_sample_bit_identical(fused_switch, warp):
    bg.FUSED_SAMPLE = "on"
    g1 = _fit_gp(warp)
    bg.FUSED_SAMPLE = "off"
    g2 = _fit_gp(warp)
    assert np.array_equal(g1.chain_, g2.chain_)
    assert np.array_equal(g1.pos_, g2.pos_)
    assert np.array_equal(g1.theta, g2.theta)
    assert np.array_equal(g1.L_, g2.L_)
    assert (
        g1.log_marginal_likelihood_value_
        == g2.log_marginal_likelihood_value_
    )
    Xq = np.random.RandomState(5).uniform(size=(6, 2))
    mu1, s1 = g1.predict(Xq, return_std=True)
    mu2, s2 = g2.predict(Xq, return_std=True)
    assert np.array_equal(mu1, mu2) and np.array_equal(s1, s2)


def _bo_next_xs(acq, n_samples, warp, fused):
    bg.FUSED_SAMPLE = "on" if fused else "off"
    am.FUSED_ACQUISITION = "on" if fused else "off"
    opt = Optimizer(
        dimensions=[(-1.0, 1.0), (0.0, 2.0)],
        n_points=60,
        n_initial_points=3,
        init_strategy="random",
        acq_func=acq,
        random_state=11,
        gp_kwargs={"warp_inputs": warp} if warp else None,
    )
    rng = np.random.RandomState(3)
    nxs = []
    for _ in range(5):
        x = opt.ask()
        y = float((np.asarray(x) ** 2).sum() + 0.05 * rng.randn())
        opt.tell(x, y, n_samples=n_samples, gp_samples=40, gp_burnin=3)
        if opt._next_x is not None:
            nxs.append(np.asarray(opt._next_x, dtype=float))
    return np.asarray(nxs)


@pytest.mark.parametrize(
    "acq,n_samples,warp",
    [
        ("pvrs", 0, False),
        ("vr", 0, False),
        ("ei", 5, False),
        ("ts", 5, False),
        ("mes", 3, False),
        ("pvrs", 0, True),
    ],
)
def test_fused_tell_next_x_bit_identical(fused_switch, acq, n_samples, warp):
    a = _bo_next_xs(acq, n_samples, warp, fused=True)
    b = _bo_next_xs(acq, n_samples, warp, fused=False)
    assert np.array_equal(a, b)


def test_warm_tell_is_two_device_programs(fused_switch, monkeypatch):
    """The whole warm tell (PVRS default) dispatches exactly TWO fused
    device programs: the sample and the acquisition pass (plus a trivial
    jitted concat that packs their host-bound outputs for the single
    combined fetch — not an aot_call)."""
    from bask_tpu.utils import aot

    opt = Optimizer(
        dimensions=[(-1.0, 1.0)],
        n_points=40,
        n_initial_points=2,
        init_strategy="random",
        acq_func="pvrs",
        random_state=0,
    )
    rng = np.random.RandomState(1)
    for _ in range(3):  # init phase + first (cold) fit
        x = opt.ask()
        opt.tell(x, float(x[0] ** 2 + 0.01 * rng.randn()), gp_samples=40,
                 gp_burnin=3)

    calls = []
    real = aot.aot_call

    def counting(fn, *args, **kwargs):
        calls.append(getattr(fn, "__name__", str(fn)))
        return real(fn, *args, **kwargs)

    # both call sites import aot_call by name — patch them directly
    monkeypatch.setattr(bg, "aot_call", counting)
    monkeypatch.setattr(am, "aot_call", counting)
    x = opt.ask()
    opt.tell(x, float(x[0] ** 2), gp_samples=40, gp_burnin=3)
    assert len(calls) == 2, calls
    assert "_fused_sample" in calls[0]
    assert "_fused_fullgp_vals" in calls[1]


@pytest.mark.parametrize("acq,n_samples", [("pvrs", 0), ("ei", 5)])
def test_warm_tell_is_one_fetch(fused_switch, monkeypatch, acq, n_samples):
    """The overlapped warm tell crosses device->host exactly ONCE: the
    acquisition program is dispatched against the pending sample's
    device-resident outputs, and both programs' host-bound results ride
    one packed blob (the single-fetch design, kept until the tell loop
    is measured on the card)."""
    opt = Optimizer(
        dimensions=[(-1.0, 1.0)],
        n_points=40,
        n_initial_points=2,
        init_strategy="random",
        acq_func=acq,
        random_state=0,
    )
    rng = np.random.RandomState(1)
    for _ in range(3):  # init phase + first (cold) fit
        x = opt.ask()
        opt.tell(x, float(x[0] ** 2 + 0.01 * rng.randn()),
                 n_samples=n_samples, gp_samples=40, gp_burnin=3)

    fetches = []
    real = bg._fetch
    monkeypatch.setattr(bg, "_fetch", lambda a: fetches.append(1) or real(a))
    x = opt.ask()
    opt.tell(x, float(x[0] ** 2), n_samples=n_samples, gp_samples=40,
             gp_burnin=3)
    assert len(fetches) == 1
    assert opt.gp._pending is None  # never escapes tell()
    assert opt.gp.chain_ is not None and opt.gp.pos_ is not None


def test_deferred_sample_finalizes_on_reuse(fused_switch):
    """A deferred sample left pending (aborted tell / direct misuse) is
    materialized before any later sample() starts, and finalize is
    idempotent."""
    gp = _fit_gp(warp=False)
    gp.sample(n_desired_samples=20, n_burnin=2, n_walkers_per_thread=10,
              _defer_fetch=True)
    assert gp._pending is not None
    chain_stale = gp.chain_
    gp.sample(n_desired_samples=20, n_burnin=2, n_walkers_per_thread=10)
    assert gp._pending is None
    assert gp.chain_ is not chain_stale
    assert gp._finalize_sample() is None  # idempotent no-op


def test_deferred_equals_immediate_sample(fused_switch):
    """sample(_defer_fetch=True) + finalize installs bit-identical state
    to the immediate fused path."""
    g1 = _fit_gp(warp=False)
    g2 = _fit_gp(warp=False)
    g1.sample(n_desired_samples=20, n_burnin=2, n_walkers_per_thread=10,
              _defer_fetch=True)
    g1._finalize_sample()
    g2.sample(n_desired_samples=20, n_burnin=2, n_walkers_per_thread=10)
    assert np.array_equal(g1.chain_, g2.chain_)
    assert np.array_equal(g1.pos_, g2.pos_)
    assert np.array_equal(g1.theta, g2.theta)
    assert g1.n_accepted_ == g2.n_accepted_
    assert (
        g1.log_marginal_likelihood_value_
        == g2.log_marginal_likelihood_value_
    )


def test_finalize_fetch_failure_rolls_back(fused_switch, monkeypatch):
    """A failed finalize fetch (device error / failed async chain program)
    must leave the estimator fully-old: the deferred sample's
    device-installed posterior is rolled back, the exception propagates,
    and a retried sample() works from the clean state."""
    gp = _fit_gp(warp=False)
    post_before = gp._post
    post_data_before = gp._post_data
    chain_before = gp.chain_
    gp.sample(n_desired_samples=20, n_burnin=2, n_walkers_per_thread=10,
              _defer_fetch=True)
    assert gp._post is not post_before  # new posterior device-installed

    def boom(_):
        raise RuntimeError("fetch failed")

    monkeypatch.setattr(bg, "_fetch", boom)
    with pytest.raises(RuntimeError, match="fetch failed"):
        gp._finalize_sample()
    assert gp._pending is None
    assert gp._post is post_before
    assert gp._post_data is post_data_before
    assert gp.chain_ is chain_before  # host state untouched
    monkeypatch.undo()
    gp.sample(n_desired_samples=20, n_burnin=2, n_walkers_per_thread=10)
    assert gp._pending is None
    assert gp.chain_ is not chain_before


def test_custom_acquisition_falls_back(fused_switch):
    """A custom FullGP acquisition is not fusable; the dispatcher must
    return None and the legacy path must still drive the loop."""

    class MyFullGP(am.FullGPAcquisition):
        def __call__(self, X, gp, *args, **kwargs):
            mu = gp.predict(np.asarray(X))
            return -np.asarray(mu)

    out = am.evaluate_acquisitions_fused(
        np.zeros((3, 1)), gpr=None, acq=MyFullGP(), n_samples=0
    )
    assert out is None


def test_fused_sample_custom_position_walker_count(fused_switch):
    """A user-supplied position= with a non-default walker count must
    unpack correctly through the fused blob (regression: the slicing
    used the configured count, silently corrupting chain_/pos_/theta)."""
    rng = np.random.RandomState(0)
    X = rng.uniform(size=(8, 1))
    y = np.sin(3 * X[:, 0])

    def run(fused):
        bg.FUSED_SAMPLE = "on" if fused else "off"
        gp = bg.BayesGPR(
            kernel=bk.ConstantKernel(1.0, (0.1, 2.0))
            * bk.Matern(0.3, (0.05, 2.0), nu=2.5),
            random_state=9,
        )
        gp.fit(
            X, y, n_desired_samples=20, n_burnin=2,
            n_walkers_per_thread=10, progress=False,
        )
        # resume with DOUBLE the configured walker count
        pos = np.concatenate([gp.pos_, gp.pos_ + 1e-3])
        gp.sample(
            n_desired_samples=20, n_burnin=1, n_walkers_per_thread=10,
            position=pos,
        )
        return gp

    g1, g2 = run(True), run(False)
    assert g1.pos_.shape == (20, 3)
    assert np.array_equal(g1.chain_, g2.chain_)
    assert np.array_equal(g1.pos_, g2.pos_)
    assert np.array_equal(g1.theta, g2.theta)
    # n_steps follows the ACTUAL 20-walker ensemble (round-5 review
    # fix): ceil(20 samples / 20 walkers) + 1 burn-in = 2 steps — the
    # configured count (10) would have over-run to 3
    assert g1.n_proposals_ == g2.n_proposals_ == 2 * 20
    assert g1.chain_.shape == (20, 3)  # exactly n_desired_samples kept
