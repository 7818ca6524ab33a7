"""Production BO loop: compile warmup + persistent executable cache.

Each padding bucket compiles its own device programs, and a compile in
the middle of a loop stalls it; this example shows the two tools that
make a production loop stall-free:

1. ``enable_aot_cache(dir)`` — compiled executables persist on disk, so
   *every process after the first* loads them in milliseconds.
2. ``warmup_optimizer(opt, buckets)`` — pre-touches every padding
   bucket the run will traverse, so the loop itself never waits on a
   compile (first process: compiles up front; later processes: loads).

Run:  python examples/production_loop.py  (add --cpu to force CPU)

Convergence: the first full refit samples to R-hat <= 1.1 by default
(the convergence-honest cold fit), and every later refit warm-tracks
the one-observation posterior shift on the fused fast path. Add
``--converged`` to instead sample EVERY refit to R-hat <= 1.1
(``gp_sample_kwargs={"until_rhat": 1.1, ...}``) — the strictest
converged-by-construction loop, with the per-iteration cost printed so
the trade-off is a measurement, not a guess.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np

from bask_tpu import Optimizer, enable_aot_cache, warmup_optimizer


def hartmann3(x):
    A = np.array([[3, 10, 30], [0.1, 10, 35], [3, 10, 30], [0.1, 10, 35]])
    P = 1e-4 * np.array(
        [[3689, 1170, 2673], [4699, 4387, 7470],
         [1091, 8732, 5547], [381, 5743, 8828]]
    )
    alpha = np.array([1.0, 1.2, 3.0, 3.2])
    inner = np.sum(A * (np.asarray(x)[None, :] - P) ** 2, axis=1)
    return float(-np.sum(alpha * np.exp(-inner)))


def main():
    cache_dir = enable_aot_cache(
        os.environ.get("BASK_TPU_AOT_CACHE", "~/.cache/bask_tpu_aot")
    )
    print(f"executable cache: {cache_dir}")

    converged = "--converged" in sys.argv
    gp_sample_kwargs = {}
    if converged:
        # sample EVERY refit to convergence: warm chunk extensions until
        # the accumulated second-half split R-hat passes 1.1 (the warm
        # ensemble usually passes within one 300-step leg)
        gp_sample_kwargs = {
            "until_rhat": 1.1, "max_extensions": 4, "extension_steps": 300,
        }
    opt = Optimizer(
        dimensions=[(0.0, 1.0)] * 3,
        n_points=200,
        n_initial_points=5,
        acq_func="pvrs",
        random_state=0,
        gp_sample_kwargs=gp_sample_kwargs,
    )

    gp_samples, gp_burnin = 100, 5
    t0 = time.time()
    warmed = warmup_optimizer(
        opt, n_observations=[30], gp_samples=gp_samples, gp_burnin=gp_burnin
    )
    print(f"warmup (buckets {warmed}): {time.time() - t0:.1f}s "
          "(first process compiles; later processes load from the cache)")

    t0 = time.time()
    iter_times = []
    for _ in range(30):
        ti = time.time()
        x = opt.ask()
        result = opt.tell(
            x, hartmann3(x), n_samples=0,
            gp_samples=gp_samples, gp_burnin=gp_burnin,
        )
        iter_times.append(time.time() - ti)
    dt = time.time() - t0
    # the 5th tell (index 4) finishes the init phase and runs the first
    # gp.fit() with the one-off ML-II warm start
    print(
        f"30 iterations: {dt:.1f}s total  "
        f"(median warm iteration {np.median(iter_times[8:]):.3f}s; "
        f"first fitted iteration {iter_times[4]:.2f}s incl. the one-off "
        f"ML-II warm start and the convergence-honest cold fit; "
        f"zero mid-run compiles)  "
        f"best y={result.fun:.4f} at x={np.round(result.x, 3)}"
    )
    print(f"last tell timings: {opt.last_timings_}")
    if converged:
        ur = opt.gp.until_rhat_result_
        print(
            f"per-refit convergence (--converged): last refit R-hat "
            f"{ur['rhat']:.3f} <= {ur['threshold']} after {ur['steps']} "
            f"kept steps ({'converged' if ur['converged'] else 'BUDGET EXHAUSTED'})"
        )
    else:
        from bask_tpu.utils.diagnostics import split_rhat

        steps = opt.gp.chain_steps_
        note = (
            f"max split R-hat {float(np.max(split_rhat(steps))):.3f} "
            f"over {steps.shape[0]} kept steps"
            if steps.shape[0] >= 4
            else f"{steps.shape[0]} kept step(s) per warm refit — too "
            "short to judge; rerun with --converged for per-refit R-hat"
        )
        print(f"warm-refit chain: {note}")


if __name__ == "__main__":
    main()
