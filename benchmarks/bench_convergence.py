"""Chain-length-to-convergence on the north-star problem (measured).

This harness measures how many steps reach R-hat < 1.1 by extending
the chain in 2400-step chunks with position warm-starts between chunks — the same continuation
semantics as `BayesGPR.sample(add=True)` — and computing the split
R-hat trajectory over the cumulative chain (first third discarded,
bench.py's rule).

The problem definition (kernel, padding, priors, -inf clamp) is
`bench.build_north_star` — the SAME object the headline bench times.

    python benchmarks/bench_convergence.py [n_chunks]

One chunk program compiles once (static n_steps=2400); every chunk
reuses it, so the measurement is compile-free after the first.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

CHUNK = 2400


def main():
    n_chunks = int(sys.argv[1]) if len(sys.argv) > 1 else 7

    import jax

    import bench as B
    from bask_tpu.parallel.mcmc import run_ensemble
    from bask_tpu.utils.diagnostics import effective_sample_size, split_rhat

    kernel, data, log_prob, pos = B.build_north_star()

    chunks = []
    walls = []
    for c in range(n_chunks):
        t0 = time.perf_counter()
        chain, final = run_ensemble(
            log_prob, pos, jax.random.PRNGKey(100 + c), CHUNK
        )
        steps = np.asarray(chain)  # fetch = sync
        walls.append(time.perf_counter() - t0)
        chunks.append(steps)
        pos = final.pos
        acc = float(final.accepted) / (CHUNK * B.N_WALKERS)

        full = np.concatenate(chunks, axis=0)
        kept = full[full.shape[0] // 3 :]
        rhat = float(np.max(split_rhat(kept)))
        ess = float(np.min(effective_sample_size(kept)))
        print(
            f"steps={full.shape[0]:6d}  max split R-hat={rhat:.3f}  "
            f"min ESS={ess:7.1f}  chunk acc={acc:.3f}  "
            f"chunk wall={walls[-1]:.1f}s"
            f"{' (incl. compile)' if c == 0 else ''}",
            flush=True,
        )
        if rhat < 1.1:
            # chunk 0's wall includes the one-off remote compile; estimate
            # the warm chain time as (median warm chunk) x (chunks used)
            warm = walls[1:]
            if warm:
                est = float(np.median(warm)) * len(walls)
                note = "(chunk-0 compile excluded via median warm chunk)"
            else:
                est = walls[0]
                note = "(single chunk — INCLUDES the one-off compile)"
            print(
                f"R-hat < 1.1 REACHED at {full.shape[0]} steps; "
                f"warm chain time ~= {est:.1f}s {note}",
                flush=True,
            )
            break
    else:
        print(f"R-hat < 1.1 NOT reached in {n_chunks * CHUNK} steps", flush=True)


if __name__ == "__main__":
    main()
