"""END-TO-END large-n BayesGPR fits on an accelerator.

Round 3 measured large n only at the per-batch LML level; this drives
the FULL estimator — ML-II warm start, MCMC chain, consensus
factorization, predictions — at n beyond the default bucket:

    python benchmarks/bench_large_fit.py dense 4096    # chunked walkers
    python benchmarks/bench_large_fit.py row 8192      # 1-device row mesh
    python benchmarks/bench_large_fit.py row 16384

dense: the walker-chunked batched_lml path (default 50-walker chain).
row:   BayesGPR(row_mesh=1-device mesh) — the huge-n mode end to end
       (ML-II gradients from the distributed adjoint, W=16 chain of
       sequential row-sharded sweeps, predict via the same sweep).

One variant per process; wall-clock split into fit phases. W/steps are
deliberately small at huge n — the point is a MEASURED end-to-end fit,
not a converged posterior.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

D = 15


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "dense"
    N = int(sys.argv[2]) if len(sys.argv) > 2 else 4096

    import jax

    if os.environ.get("BENCH_CPU"):
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)

    from jax.sharding import Mesh

    import bask_tpu as bt
    from bask_tpu.ops import kernels as bk

    # keep each dispatched chain program short at the top shapes
    if N >= 32768:
        # one f32 gram strip set is ~4 GB at this n: W=2 chain, the
        # leanest (jvp, ~2-strip) ML-II gradients, minimal steps — the
        # point is that the tier RUNS and what a sweep costs. NB
        # burn must stay below steps (burn=4 > steps=3 retains an EMPTY
        # chain: nan consensus, -inf LML); burn=1 keeps 2 steps x 2
        # walkers
        W, steps, burn = 2, 3, 1
    elif N >= 16384:
        W, steps, burn = 8, 10, 4
    else:
        W, steps, burn = (50 if mode == "dense" else 16), 20, 4
    kernel = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern(
        tuple([0.3] * D), (0.05, 2.0), nu=2.5
    ) + bk.WhiteKernel(0.05, (1e-5, 1e5))
    rng = np.random.RandomState(42)
    X = rng.uniform(size=(N, D))
    y = np.sum((X - 0.5) ** 2, axis=1) + 0.2 * rng.randn(N)

    kw = {}
    if mode == "row":
        n_dev = len(jax.devices())
        mesh = Mesh(np.array(jax.devices()[: max(1, n_dev)]), ("r",))
        kw = dict(row_mesh=mesh, row_nb=512, row_unroll=N <= 8192)
        if N >= 32768:
            kw["row_grad_method"] = "jvp"  # leanest peak memory
            # the FULL-n row value+grad holds ~3 gram strips (~12 GB);
            # the warm start only seeds the chain, so optimize it on a
            # dense 8k subset and keep the chain full + row-sharded.
            # MAP objective: the bare-LML seed rails at the kernel
            # bounds; MAP refines to the posterior mode.
            kw["ml2_subsample"] = 8192
            kw["ml2_objective"] = "map"
    # n>=16384: the host L-BFGS driver dispatches one small
    # sweep+adjoint program per step instead of the one-program device
    # L-BFGS (60 iters x sweep+adjoint in a single scan).
    ml2 = "lbfgs-device" if (mode == "row" and N < 16384) else "lbfgs"
    gp = bt.BayesGPR(
        kernel=kernel, normalize_y=True, random_state=0,
        optimizer=ml2, **kw,
    )

    t0 = time.perf_counter()
    gp.fit(
        X, y, n_burnin=burn, n_desired_samples=(steps - burn) * W,
        n_walkers_per_thread=W, progress=False,
    )
    t_fit = time.perf_counter() - t0

    t0 = time.perf_counter()
    Xq = rng.uniform(size=(64, D))
    mu, std = gp.predict(Xq, return_std=True)
    float(np.sum(mu))
    t_pred = time.perf_counter() - t0

    # a second fit reuses every compiled program: the steady-state cost
    gp2 = bt.BayesGPR(
        kernel=kernel, normalize_y=True, random_state=1,
        optimizer=gp.optimizer, **kw,
    )
    t0 = time.perf_counter()
    gp2.fit(
        X, y, n_burnin=burn, n_desired_samples=(steps - burn) * W,
        n_walkers_per_thread=W, progress=False,
    )
    t_fit_warm = time.perf_counter() - t0

    # warm predict: same shapes as gp.predict above, so every program
    # is already compiled (the first predict's number is compile-bound)
    t0 = time.perf_counter()
    mu2, std = gp2.predict(Xq, return_std=True)
    float(np.sum(mu2))
    t_pred_warm = time.perf_counter() - t0

    acc = gp2.n_accepted_ / max(1, gp2.n_proposals_)
    print(
        f"{mode} N={N} D={D} W={W} steps={steps}: "
        f"fit cold {t_fit:.1f} s / warm {t_fit_warm:.1f} s "
        f"({t_fit_warm/steps*1e3:.0f} ms/chain-step-equivalent), "
        f"predict(64) cold {t_pred*1e3:.0f} / warm {t_pred_warm*1e3:.0f} ms, "
        f"acc {acc:.3f}, "
        f"lml {gp2.log_marginal_likelihood_value_:.1f}, "
        f"max_std {float(np.max(std)):.4f}"
    )


if __name__ == "__main__":
    main()
