"""Gradient-polished acquisition argmax: regret A/B.

The reference optimizes acquisitions over a 500-point uniform random
grid only (``/root/reference/bask/optimizer.py:353-376``).
``Optimizer(acq_polish=N)`` follows the grid argmax with a few vmapped
Adam ascent steps on the differentiable acquisition surface from the
top-k grid points (bask_tpu/acquisition.py:polish_acquisition). This
bench measures whether that buys real BO quality: simple regret on
Hartmann-6 (global min -3.32237) over full ask/tell loops, identical
seeds per arm, with per-iteration wall-clock so the comparison can be
made at equal time budget, not just equal iteration count.

    python benchmarks/bench_polish.py grid   4     # arm, n_seeds
    python benchmarks/bench_polish.py polish 4

One arm per process; all seeds share one process so the compiled
programs amortize. BENCH_CPU=1 for a local smoke run (regret only; its
times are the CPU's).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

HART6_A = np.array(
    [
        [10, 3, 17, 3.5, 1.7, 8],
        [0.05, 10, 17, 0.1, 8, 14],
        [3, 3.5, 1.7, 10, 17, 8],
        [17, 8, 0.05, 10, 0.1, 14],
    ]
)
HART6_P = 1e-4 * np.array(
    [
        [1312, 1696, 5569, 124, 8283, 5886],
        [2329, 4135, 8307, 3736, 1004, 9991],
        [2348, 1451, 3522, 2883, 3047, 6650],
        [4047, 8828, 8732, 5743, 1091, 381],
    ]
)
HART6_ALPHA = np.array([1.0, 1.2, 3.0, 3.2])
HART6_MIN = -3.32237


def hartmann6(x):
    inner = np.sum(HART6_A * (np.asarray(x)[None, :] - HART6_P) ** 2, axis=1)
    return float(-np.sum(HART6_ALPHA * np.exp(-inner)))


def main():
    arm = sys.argv[1] if len(sys.argv) > 1 else "grid"
    n_seeds = int(sys.argv[2]) if len(sys.argv) > 2 else 4

    import jax

    if os.environ.get("BENCH_CPU"):
        jax.config.update("jax_platforms", "cpu")

    from bask_tpu import Optimizer, warmup_optimizer

    n_iters = int(os.environ.get("BENCH_ITERS", "50"))
    # round-5 widening: the first A/B (2026-08-20) ran EI; BENCH_ACQ
    # swaps the acquisition so the default-flip decision rests on more
    # than one surface (pvrs exercises the full-GP score path)
    acq = os.environ.get("BENCH_ACQ", "ei")
    n_init = 10
    polish_kw = {}
    if arm == "polish":
        polish_kw = dict(acq_polish=20, acq_polish_starts=8)
    elif arm != "grid":
        raise SystemExit(f"unknown arm {arm!r} (grid|polish)")

    finals, iter_meds, traces = [], [], []
    for seed in range(n_seeds):
        opt = Optimizer(
            dimensions=[(0.0, 1.0)] * 6,
            n_points=500,
            n_initial_points=n_init,
            acq_func=acq,
            random_state=seed,
            **polish_kw,
        )
        if seed == 0:
            t0 = time.perf_counter()
            warmup_optimizer(
                opt, n_observations=[30], gp_samples=100, gp_burnin=5
            )
            print(
                f"{arm} warmup: {time.perf_counter() - t0:.1f}s", flush=True
            )
        best = np.inf
        trace, times = [], []
        for _ in range(n_iters):
            ti = time.perf_counter()
            x = opt.ask()
            opt.tell(
                x, hartmann6(x), n_samples=100,
                gp_samples=100, gp_burnin=5,
            )
            times.append(time.perf_counter() - ti)
            best = min(best, opt.yi[-1])
            trace.append(best - HART6_MIN)
        finals.append(trace[-1])
        # median warm iteration past the init phase + first cold fit
        iter_meds.append(float(np.median(times[n_init + 2:])))
        traces.append(trace)
        print(
            f"{arm}[{acq}] seed={seed}: final regret {trace[-1]:.4f}, "
            f"median warm iter {iter_meds[-1]:.3f}s, "
            f"total {sum(times):.1f}s",
            flush=True,
        )
        print(
            f"  trace: "
            + " ".join(f"{r:.3f}" for r in trace[n_init - 1 :: 5]),
            flush=True,
        )

    print(
        f"RESULT {arm}[{acq}]: median final regret "
        f"{float(np.median(finals)):.4f} "
        f"(per-seed {[round(f, 4) for f in finals]}), "
        f"median warm iter {float(np.median(iter_meds)):.3f}s"
    )


if __name__ == "__main__":
    main()
