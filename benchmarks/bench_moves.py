"""Move-mixture mixing A/B: stretch vs stretch+DE time-to-convergence.

The vanilla stretch move needs
7200 steps to reach R-hat < 1.1 on the north-star posterior. This
drives the REAL north-star chain (15-D n=500 BayesGPR posterior, 100
walkers) under each move spec and reports split R-hat / min ESS at a
ladder of chain lengths, so the default move mixture is set by
measurement.

    python benchmarks/bench_moves.py stretch
    python benchmarks/bench_moves.py mix25        # 75% stretch / 25% de
    python benchmarks/bench_moves.py mix50
    python benchmarks/bench_moves.py de

CPU smoke (relative mixing only; slow): BENCH_CPU=1 and a smaller
problem via BENCH_SMALL=1. One variant per process; chains extend in
warm-started 1200-step chunks.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SPECS = {
    "stretch": None,
    "mix25": (("stretch", 0.75), ("de", 0.25)),
    "mix50": (("stretch", 0.5), ("de", 0.5)),
    "mix75": (("stretch", 0.25), ("de", 0.75)),
    "de": (("de", 1.0),),
    # emcee's recommended remedy for slow stretch mixing
    "demix": (("de", 0.8), ("snooker", 0.2)),
    # stretch for local mixing + DE/snooker for covariance adaptation
    # and mode hopping
    "tri": (("stretch", 0.5), ("de", 0.4), ("snooker", 0.1)),
    # round-5 DREAM-crossover candidates (decr/dream/dream9/dreammix)
    # were measured here and REJECTED (split R-hat, see parallel/mcmc.py)
    # — the de_cr move is deleted
    #
    # round-5 parameterized-demix tuning ladder (r5i queue): the demix
    # control numbers are the r5 ladder's (identical seeds/starts) —
    # 1.380@1200 / 1.187@2400 / 1.127@3600 / 1.095@4800. Hypotheses on
    # the measured-bimodal posterior: more gamma=1 mode jumps
    # (jump 0.1->0.25), a bigger in-mode DE step (gamma 0.408->0.55),
    # more snooker weight (outlier recovery), and jumps+snooker
    # combined.
    "demixj25": (("de:jump=0.25", 0.8), ("snooker", 0.2)),
    "demixg55": (("de:gamma=0.55", 0.8), ("snooker", 0.2)),
    "demixs35": (("de", 0.65), ("snooker", 0.35)),
    "demixj25s35": (("de:jump=0.25", 0.65), ("snooker", 0.35)),
}


def main():
    variant = sys.argv[1] if len(sys.argv) > 1 else "stretch"
    moves = SPECS[variant]

    import jax

    if os.environ.get("BENCH_CPU"):
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from bask_tpu.models.bayesgpr import (
        _init_chain_state,
        _run_chain_chunk,
    )
    from bask_tpu.ops import kernels as bk
    from bask_tpu.utils.diagnostics import (
        effective_sample_size,
        split_rhat,
    )

    small = bool(os.environ.get("BENCH_SMALL"))
    med = bool(os.environ.get("BENCH_MED"))
    if small:
        D, N, W = 4, 64, 32
    elif med:
        # CPU-tractable stand-in for the north-star hyperposterior:
        # FULL 15-D kernel (17 chain dims) over a smaller train set
        D, N, W = 15, 128, 100
    else:
        D, N, W = 15, 500, 100
    chunk = int(os.environ.get("BENCH_CHUNK", 1200))
    max_steps = int(os.environ.get("BENCH_MAX_STEPS", 7200))

    import bask_tpu as bt

    kernel = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern(
        tuple([0.3] * D), (0.05, 2.0), nu=2.5
    ) + bk.WhiteKernel(0.05, (1e-5, 1e5))
    rng = np.random.RandomState(42)
    X = rng.uniform(size=(N, D))
    y = np.sum((X - 0.5) ** 2, axis=1) + 0.2 * rng.randn(N)

    gp = bt.BayesGPR(kernel=kernel, normalize_y=True, random_state=0)
    # fit with a tiny chain purely to build data/priors/theta state
    gp.fit(X, y, n_burnin=0, n_desired_samples=W,
           n_walkers_per_thread=W, progress=False)

    data = gp._data
    priors = gp._resolve_priors(None)
    dt = data.X.dtype
    theta = jnp.asarray(gp._theta, dtype=dt)

    # identical dispersed start for every variant; BENCH_INIT=laplace
    # swaps in the curvature-scaled cold start (round 5) — the A/B for
    # the chain_init="laplace" feature
    if os.environ.get("BENCH_INIT") == "laplace":
        gp.random_state = np.random.RandomState(7)
        pos_np = gp._laplace_positions(
            np.asarray(gp._theta), W, priors, 0
        )
        assert pos_np is not None, "laplace init unusable on this posterior"
        pos0 = jnp.asarray(pos_np, dtype=dt)
    else:
        k0 = jax.random.PRNGKey(7)
        pos0 = theta[None, :] + 0.1 * jax.random.normal(
            k0, (W, theta.shape[0]), dtype=dt
        )

    # step-fn statics: thread moves through the chunked runner
    state = _init_chain_state(
        data, pos0, kernel=gp._spec, priors=priors,
        warp_prior=None, n_warp=0,
    )

    # warm up the chunk program with the real statics
    keys = jax.random.split(jax.random.PRNGKey(0), chunk)
    chain_parts = []
    t_total = 0.0
    report = []
    steps_done = 0
    kmaster = jax.random.PRNGKey(123)
    first = True
    while steps_done < max_steps:
        kmaster, sub = jax.random.split(kmaster)
        keys = jax.random.split(sub, chunk)
        t0 = time.perf_counter()
        chain, state = _run_chain_chunk(
            data, state, keys, kernel=gp._spec, priors=priors,
            warp_prior=None, n_warp=0, moves=moves,
        )
        chain_np = np.asarray(chain)  # host fetch = sync
        dt_chunk = time.perf_counter() - t0
        if first:
            # first chunk includes compile; re-run once for warm timing
            t0 = time.perf_counter()
            kmaster, sub = jax.random.split(kmaster)
            keys = jax.random.split(sub, chunk)
            chain, state = _run_chain_chunk(
                data, state, keys, kernel=gp._spec, priors=priors,
                warp_prior=None, n_warp=0, moves=moves,
            )
            chain_np = np.asarray(chain)
            dt_chunk = time.perf_counter() - t0
            first = False
        t_total += dt_chunk
        chain_parts.append(chain_np)
        steps_done += chunk
        full = np.concatenate(chain_parts)  # (steps, W, D) step-major
        # split R-hat over the second half of the accumulated chain
        half = full[full.shape[0] // 2 :]
        rhat = float(np.max(split_rhat(half)))
        es = float(np.min(effective_sample_size(half)))
        acc = float(state.accepted) / (steps_done * full.shape[1])
        report.append((steps_done, rhat, es, t_total, acc))
        print(
            f"{variant} steps={steps_done} rhat={rhat:.3f} "
            f"minESS={es:.0f} warm_time={t_total:.1f}s acc={acc:.3f}",
            flush=True,
        )
        if rhat < 1.1 and steps_done >= 2 * chunk:
            break

    print(f"RESULT {variant}: " + "; ".join(
        f"{s}:{r:.3f}" for s, r, *_ in report
    ))


if __name__ == "__main__":
    main()
