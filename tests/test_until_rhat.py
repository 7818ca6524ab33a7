"""sample(until_rhat=...): sample-to-convergence by warm chunk
extension. The library-level form of the measured convergence pattern
(bench.py / benchmarks/bench_convergence.py). The reference exposes no convergence control at all
(``/root/reference/bask/bayesgpr.py:381-548``)."""

import numpy as np
import pytest

from bask_tpu.models.bayesgpr import BayesGPR
from bask_tpu.ops import kernels as bk


def _fitted_gp(**kw):
    rng = np.random.RandomState(0)
    X = rng.uniform(size=(16, 2))
    y = np.sum((X - 0.5) ** 2, axis=1)
    kernel = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.RBF(
        (0.3, 0.3), (0.05, 2.0)
    )
    gp = BayesGPR(kernel=kernel, random_state=0, **kw)
    return gp, X, y


def test_loose_threshold_adds_no_extension():
    gp, X, y = _fitted_gp()
    gp.fit(X, y, n_burnin=2, n_desired_samples=40,
           n_walkers_per_thread=10, progress=False, until_rhat=1e6)
    # base run only: kept steps = ceil(40/10) = 4
    assert gp.chain_steps_.shape[0] == 4
    assert np.isfinite(gp.theta).all()


def test_impossible_threshold_extends_and_warns():
    gp, X, y = _fitted_gp()
    with pytest.warns(UserWarning, match="did not converge"):
        gp.fit(X, y, n_burnin=2, n_desired_samples=40,
               n_walkers_per_thread=10, progress=False,
               until_rhat=0.5, max_extensions=2)
    # base 4 kept steps + 2 extensions x 4 steps each
    assert gp.chain_steps_.shape[0] == 12
    # consensus state recomputed over the accumulated chain
    assert np.isfinite(gp.theta).all()
    assert np.isfinite(gp.log_marginal_likelihood_value_)
    # acceptance counters describe the combined chain
    assert gp.n_proposals_ > 0
    # flat chain is the accumulated one
    assert gp.chain_.shape[0] == 12 * gp.chain_steps_.shape[1]


def test_until_rhat_converges_on_easy_posterior():
    """A reachable threshold on a well-identified posterior (noisy
    target, bounded white kernel) converges before max_extensions —
    no warning, and the loop stops early. Threshold calibrated from a
    measured trajectory on this exact problem (1.606 at 60 steps,
    monotone decline after)."""
    rng = np.random.RandomState(0)
    X = rng.uniform(size=(24, 2))
    y = np.sum((X - 0.5) ** 2, axis=1) + 0.1 * rng.randn(24)
    kernel = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.RBF(
        (0.3, 0.3), (0.05, 2.0)
    ) + bk.WhiteKernel(0.05, (1e-3, 1e2))
    gp = BayesGPR(kernel=kernel, random_state=0,
                  moves=[("de", 0.8), ("snooker", 0.2)])
    import warnings as _w

    with _w.catch_warnings():
        _w.simplefilter("error", UserWarning)
        gp.fit(X, y, n_burnin=8, n_desired_samples=320,
               n_walkers_per_thread=32, progress=False,
               until_rhat=1.7, max_extensions=12)
    steps = gp.chain_steps_
    # stopped EARLY (not by exhausting the budget)
    assert steps.shape[0] < 10 * 13
    from bask_tpu.utils.diagnostics import split_rhat

    r = float(np.max(split_rhat(steps[steps.shape[0] // 2:])))
    assert r <= 1.7, r


def test_until_rhat_consensus_matches_manual_extension():
    """The extension loop computes the consensus ONCE after converging;
    the result must be bit-identical to extending by hand (where every
    add=True leg recomputes it and the last one wins)."""
    gp, X, y = _fitted_gp()
    with pytest.warns(UserWarning, match="did not converge"):
        gp.fit(X, y, n_burnin=2, n_desired_samples=40,
               n_walkers_per_thread=10, progress=False,
               until_rhat=0.5, max_extensions=2)

    gp2, _, _ = _fitted_gp()
    gp2.fit(X, y, n_burnin=2, n_desired_samples=40,
            n_walkers_per_thread=10, progress=False)
    for _ in range(2):
        gp2.sample(n_desired_samples=40, n_burnin=0,
                   n_walkers_per_thread=10, progress=False,
                   position=gp2.pos_, add=True)

    np.testing.assert_array_equal(gp.chain_steps_, gp2.chain_steps_)
    np.testing.assert_array_equal(gp.theta, gp2.theta)
    assert gp.log_marginal_likelihood_value_ == (
        gp2.log_marginal_likelihood_value_
    )
    assert gp.noise_ == gp2.noise_


def test_until_rhat_keeps_user_position_walker_count():
    """A position= base run with a walker count different from the
    configured one must be CONTINUED by the extensions, not silently
    re-initialized (homogeneous accumulation, same walker count)."""
    gp, X, y = _fitted_gp()
    gp.fit(X, y, n_burnin=2, n_desired_samples=40,
           n_walkers_per_thread=10, progress=False)
    pos12 = np.concatenate([gp.pos_, gp.pos_[:2]])  # 12 walkers
    with pytest.warns(UserWarning, match="did not converge"):
        gp.sample(n_burnin=2, n_desired_samples=40,
                  n_walkers_per_thread=10, progress=False,
                  position=pos12, until_rhat=0.5, max_extensions=1)
    # base leg: ceil(40/10)=4 kept steps at 12 walkers; extension adds
    # 4 more at the SAME 12 walkers (homogeneous)
    assert gp.chain_steps_.shape[:2] == (8, 12)


def test_until_rhat_in_row_sharded_mode():
    """The extension loop composes with row-sharded mode (legacy chain
    path + add=True continuation over the distributed sweep)."""
    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices("cpu")[:8])
    if devs.size < 8:
        pytest.skip("needs 8 virtual CPU devices")
    mesh = Mesh(devs, ("r",))

    rng = np.random.RandomState(3)
    X = rng.uniform(size=(40, 2))
    y = np.sin(3.0 * X[:, 0]) + 0.5 * X[:, 1] + 0.05 * rng.randn(40)
    kernel = bk.ConstantKernel(1.0, (0.1, 10.0)) * bk.Matern(
        (0.5, 0.5), (0.05, 5.0), nu=2.5
    )
    gp = BayesGPR(kernel=kernel, random_state=0, row_mesh=mesh,
                  moves="demix")
    with pytest.warns(UserWarning, match="did not converge"):
        gp.fit(X, y, n_burnin=2, n_desired_samples=32,
               n_walkers_per_thread=8, progress=False,
               until_rhat=0.5, max_extensions=1)
    # base 4 kept steps + 1 extension x 4
    assert gp.chain_steps_.shape[0] == 8
    mu = gp.predict(X[:4])
    assert np.all(np.isfinite(mu))


def test_until_rhat_under_walker_mesh():
    """The extension loop composes with mesh-sharded ensembles (the
    add=True legs inherit the walker sharding)."""
    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices("cpu")[:8])
    if devs.size < 8:
        pytest.skip("needs 8 virtual CPU devices")
    mesh = Mesh(devs, ("w",))

    gp, X, y = _fitted_gp()
    with pytest.warns(UserWarning, match="did not converge"):
        gp.fit(X, y, n_burnin=2, n_desired_samples=64,
               n_walkers_per_thread=16, progress=False, mesh=mesh,
               until_rhat=0.5, max_extensions=1)
    # walkers round to 2 x n_devices multiples (16 stays 16);
    # base 4 kept steps + 1 extension x 4
    assert gp.chain_steps_.shape[0] == 8
    assert np.isfinite(gp.theta).all()


def test_optimizer_gp_sample_kwargs_passthrough(tmp_path):
    """Optimizer(gp_sample_kwargs=...) reaches every refit: a stretch BO
    loop's chain differs from the default (auto -> demix) loop at
    identical seeds, and the kwargs round-trip through save/load."""
    import bask_tpu as bt

    def f(x):
        return float((x[0] - 0.3) ** 2)

    def run(**kw):
        opt = bt.Optimizer(
            dimensions=[(-1.0, 1.0)], n_initial_points=3, random_state=7,
            n_points=32, **kw,
        )
        for _ in range(5):
            x = opt.ask()
            opt.tell(x, f(x), gp_samples=20, gp_burnin=2)
        return opt

    opt_stretch = run(gp_sample_kwargs={"moves": "stretch"})
    opt_plain = run()
    assert not np.array_equal(opt_stretch.gp.chain_, opt_plain.gp.chain_)

    p = str(tmp_path / "opt.npz")
    bt.save_optimizer(opt_stretch, p)
    opt2 = bt.load_optimizer(p)
    assert opt2.gp_sample_kwargs == {"moves": "stretch"}

    # until_rhat inside warm tells: the wrapper ignores the deferred-
    # fetch fast path (host chain state needed per leg) and extends —
    # 1 base kept step (20 samples / 100 walkers) + 1 extension
    opt3 = run(gp_sample_kwargs={"until_rhat": 0.5, "max_extensions": 1})
    assert opt3.gp.chain_steps_.shape[0] == 2
    assert opt3.gp._pending is None


def test_moves_round_trip_through_checkpoints(tmp_path):
    """The constructor move mixture survives save/load at both levels
    (it is a jit static: a resumed optimizer must keep sampling with
    the same moves), and non-JSON gp_sample_kwargs degrade with a
    warning instead of crashing the save."""
    import bask_tpu as bt

    gp, X, y = _fitted_gp(moves="demix")
    gp.fit(X, y, n_burnin=2, n_desired_samples=20,
           n_walkers_per_thread=10, progress=False)
    p = str(tmp_path / "gp.npz")
    bt.save_gpr(gp, p)
    gp2 = bt.load_gpr(p)
    assert gp2.moves == (("de", 0.8), ("snooker", 0.2))

    opt = bt.Optimizer(dimensions=[(-1.0, 1.0)], n_initial_points=1,
                       random_state=0, n_points=16,
                       gp_kwargs={"moves": "demix"})
    opt.tell([0.3], 0.1, gp_samples=20, gp_burnin=2)
    po = str(tmp_path / "opt.npz")
    bt.save_optimizer(opt, po)
    opt2 = bt.load_optimizer(po)
    assert opt2.gp.moves == (("de", 0.8), ("snooker", 0.2))

    opt.gp_sample_kwargs = {"warp_priors": lambda a, b: 0.0}
    with pytest.warns(UserWarning, match="gp_sample_kwargs"):
        bt.save_optimizer(opt, po)
    opt3 = bt.load_optimizer(po)
    assert opt3.gp_sample_kwargs == {}


def test_until_rhat_result_reset_on_plain_sample():
    """A stale non-converged until_rhat_result_ from an earlier run must
    not survive a later sample() that never ran the convergence loop
    (Optimizer.tell reads it to re-surface convergence warnings)."""
    gp, X, y = _fitted_gp()
    with pytest.warns(UserWarning, match="did not converge"):
        gp.fit(X, y, n_burnin=2, n_desired_samples=40,
               n_walkers_per_thread=10, progress=False,
               until_rhat=0.5, max_extensions=1)
    assert gp.until_rhat_result_ is not None
    assert not gp.until_rhat_result_["converged"]
    # plain refit: no convergence loop -> the stale result is cleared
    gp.sample(n_desired_samples=40, n_burnin=0,
              n_walkers_per_thread=10, progress=False,
              position=gp.pos_, add=True)
    assert gp.until_rhat_result_ is None


def test_until_rhat_with_moves_and_warm_continuation():
    """Extensions warm-continue (pos_ reused) and respect the moves
    mixture: the extended chain must differ from a pure-stretch one of
    the same total length, and every leg shares walker count."""
    gp, X, y = _fitted_gp()
    with pytest.warns(UserWarning, match="did not converge"):
        gp.fit(X, y, n_burnin=2, n_desired_samples=40,
               n_walkers_per_thread=10, progress=False,
               until_rhat=0.5, max_extensions=1,
               moves=[("de", 0.8), ("snooker", 0.2)])
    assert gp.chain_steps_.shape == (8, 10, gp.chain_steps_.shape[-1])

    gp2, _, _ = _fitted_gp()
    with pytest.warns(UserWarning, match="did not converge"):
        gp2.fit(X, y, n_burnin=2, n_desired_samples=40,
                n_walkers_per_thread=10, progress=False,
                until_rhat=0.5, max_extensions=1, moves="stretch")
    assert not np.array_equal(gp.chain_steps_, gp2.chain_steps_)


def test_explicit_position_sets_step_count():
    """n_steps must follow the ACTUAL ensemble when position= overrides
    the configured walker count (an until_rhat extension leg continuing
    a mesh-rounded 112-walker ensemble would otherwise under-run its
    step budget and compile a second program shape; round-5 review)."""
    import numpy as np

    from bask_tpu.models.bayesgpr import BayesGPR

    rng = np.random.RandomState(0)
    X = rng.uniform(size=(12, 1))
    y = np.sin(4 * X[:, 0])
    gp = BayesGPR(random_state=0)
    gp.fit(X, y, n_burnin=2, n_desired_samples=40,
           n_walkers_per_thread=20, progress=False)
    d = gp.chain_steps_.shape[-1]
    pos64 = np.repeat(gp.pos_, 4, axis=0)[:64]  # 64-walker ensemble
    gp.sample(n_desired_samples=320, n_burnin=0,
              n_walkers_per_thread=20, position=pos64, progress=False)
    # ceil(320 / 64-actual) = 5 steps, NOT ceil(320 / 20-config) = 16
    assert gp.chain_steps_.shape == (5, 64, d)
