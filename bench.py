"""North-star benchmark: fully-Bayesian GP fit wall-clock.

Config from BASELINE.json: 15-D, n=500 observations, 100 stretch-move
walkers x 300 steps. The reference (CPU bask) executes this as
100 x 300 = 30,000 *serial* Cholesky factorizations of the 500x500 gram
inside emcee; bask-tpu advances all walkers per step with one batched
factorization on device.

Prints ONE JSON line:
  {"metric": ..., "value": <device seconds>, "unit": "s", "vs_baseline": <cpu/device speedup>}

Needs a GPU: on any other JAX platform it exits non-zero without a
result.

The CPU baseline is measured in-process with a NumPy/SciPy
implementation of the identical workload (serial per-walker
prior+LML evaluations, the computational shape of the reference's
``bask/bayesgpr.py:351-379`` hot loop), timed over a slice of steps and
extrapolated linearly — emcee itself is not installed in this image.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def _enable_compile_cache():
    """Persistent XLA compile cache: JAX reads
    ``JAX_COMPILATION_CACHE_DIR`` itself; only when it is unset is the
    fixed in-repo directory configured."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache"),
    )


_enable_compile_cache()

N_OBS = 500
N_DIM = 15
N_WALKERS = 100
N_STEPS = 300
CPU_MEASURE_STEPS = 10  # serial steps per timed repetition
CPU_MEASURE_REPS = 3  # repetitions; the median is extrapolated to N_STEPS


def _dataset():
    rng = np.random.RandomState(0)
    X = rng.uniform(size=(N_OBS, N_DIM))
    y = np.sum((X - 0.5) ** 2, axis=1) + 0.05 * rng.randn(N_OBS)
    y = (y - y.mean()) / y.std()
    return X, y


def _init_positions(n_theta, rng):
    pos = 0.05 * rng.randn(N_WALKERS, n_theta)
    pos[:, -1] += np.log(0.05)  # white-noise channel near the truth
    return pos


# ---------------------------------------------------------------------------
# Device path (bask-tpu)
# ---------------------------------------------------------------------------


def build_north_star(dtype=None):
    """Kernel, padded GPData, batched log-prob, and init positions for
    the north-star problem. Shared by this bench and
    ``benchmarks/bench_convergence.py`` so both measure the SAME problem
    (one definition of the padding bucket, priors, and -inf clamping).
    """
    import jax
    import jax.numpy as jnp

    from bask_tpu.models import gp as gpc
    from bask_tpu.ops import kernels as bk, linalg
    from bask_tpu.utils.priors import guess_priors

    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    X, y = _dataset()
    kernel = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern(
        tuple([0.3] * N_DIM), (0.05, 2.0), nu=2.5
    ) + bk.WhiteKernel(0.05, (1e-5, 1e5))
    n_pad = 512
    Xp = np.full((n_pad, N_DIM), 0.5)
    Xp[:N_OBS] = X
    yp = np.zeros(n_pad)
    yp[:N_OBS] = y
    data = gpc.make_data(
        jnp.asarray(Xp, dtype=dtype),
        jnp.asarray(yp, dtype=dtype),
        jnp.asarray(np.full(n_pad, 1e-6), dtype=dtype),
        jnp.asarray(np.arange(n_pad) < N_OBS),
    )
    priors = tuple(guess_priors(kernel))

    def _prior_one(theta):
        lp = 0.0
        for i, p in enumerate(priors):
            lp = lp + p(theta[i])
        return lp

    def log_prob(thetas):  # batched (W, D) -> (W,)
        lp = jax.vmap(_prior_one)(thetas)
        lml = linalg.batched_lml(
            kernel, thetas, data.X, data.y, data.alpha_diag, data.mask
        )
        tot = lp + lml
        return jnp.where(jnp.isfinite(tot), tot, -jnp.inf)

    pos0 = jnp.asarray(
        _init_positions(kernel.n_theta, np.random.RandomState(1)),
        dtype=dtype,
    )
    return kernel, data, log_prob, pos0


def bench_device():
    import jax
    import jax.numpy as jnp
    from jax import lax

    from bask_tpu.ops import linalg
    from bask_tpu.parallel.mcmc import run_ensemble

    # Factorization variant: BENCH_FAST=0 switches the blocked-matmul
    # Cholesky to XLA's native one (cuSOLVER on the GPU).
    linalg.FAST_CHOLESKY = (
        "off" if os.environ.get("BENCH_FAST") == "0" else "auto"
    )

    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

    kernel, data, log_prob, pos0 = build_north_star(dtype)

    # BENCH_MOVES selects the ensemble move mixture for the timed chain
    # (default: the historical pure-stretch chain so the headline stays
    # comparable across rounds; "demix" = DE 0.8 + snooker 0.2). Names
    # resolve through the library's single alias table so a retuned
    # mixture never drifts from what the bench measures.
    def _resolve_moves(name):
        from bask_tpu.models.bayesgpr import _canonical_moves

        return None if name == "stretch" else _canonical_moves(name)

    moves = _resolve_moves(os.environ.get("BENCH_MOVES", "stretch"))
    # resolve the convergence-leg mixture NOW too (fail fast on a typo
    # BEFORE the expensive timed run, not after it)
    _conv_moves = _resolve_moves(os.environ.get("BENCH_CONV_MOVES", "demix"))

    # warmup/compile with the SAME static n_steps as the timed run
    chain, final = jax.block_until_ready(run_ensemble(
        log_prob, pos0, jax.random.PRNGKey(0), N_STEPS, moves=moves
    ))

    t0 = time.perf_counter()
    chain, final = jax.block_until_ready(run_ensemble(
        log_prob, pos0, jax.random.PRNGKey(1), N_STEPS, moves=moves
    ))
    elapsed = time.perf_counter() - t0

    acc = float(final.accepted) / (N_STEPS * N_WALKERS)
    assert np.isfinite(np.asarray(final.log_prob)).all(), "chain diverged"
    assert 0.05 < acc < 0.99, f"implausible acceptance rate {acc}"

    # time-to-convergence: extend the SAME chain warm-started in
    # N_STEPS-sized chunks until split R-hat over the accumulated second
    # half drops under 1.1. The extension samples with the DE+snooker
    # mixture by default (BENCH_CONV_MOVES) — the convergence ladder
    # had it converging at 4800 steps where pure stretch was still
    # R-hat 1.17 at 7200 — while the fixed-workload headline chain
    # above stays pure-stretch for comparability.
    from bask_tpu.utils.diagnostics import split_rhat as _split_rhat

    conv_steps, conv_time, conv_rhat = None, None, None
    alt_elapsed = None
    if os.environ.get("BENCH_CONVERGENCE", "1") != "0" and N_STEPS >= 100:
        conv_moves = _conv_moves
        max_chunks = int(os.environ.get("BENCH_CONV_MAX_CHUNKS", "24"))
        if conv_moves != moves:
            # one-off compile of the mixture program OUTSIDE the timed
            # extension (same static n_steps)
            jax.block_until_ready(run_ensemble(
                log_prob, pos0, jax.random.PRNGKey(9), N_STEPS,
                moves=conv_moves,
            ))
            # demix-headline variant: the identical 100x300 fixed
            # workload timed under the convergence-leg mixture, from
            # the same start, warm (the compile above). Recorded
            # alongside the stretch headline so the cost of the honest
            # default sampler is a bench field, not lore.
            t0 = time.perf_counter()
            jax.block_until_ready(run_ensemble(
                log_prob, pos0, jax.random.PRNGKey(1), N_STEPS,
                moves=conv_moves,
            ))
            alt_elapsed = time.perf_counter() - t0
        parts = [np.asarray(chain)]
        t_conv = elapsed  # the headline chunk is the first leg
        kc = jax.random.PRNGKey(2)
        pos_c = final.pos
        for _ in range(max_chunks - 1):
            acc_chain = np.concatenate(parts)
            r = float(np.max(_split_rhat(acc_chain[acc_chain.shape[0] // 2:])))
            if r < 1.1:
                break
            kc, sub = jax.random.split(kc)
            t0 = time.perf_counter()
            ch, fin = jax.block_until_ready(run_ensemble(
                log_prob, pos_c, sub, N_STEPS, moves=conv_moves
            ))
            t_conv += time.perf_counter() - t0
            parts.append(np.asarray(ch))
            pos_c = fin.pos
        acc_chain = np.concatenate(parts)
        conv_rhat = float(np.max(_split_rhat(acc_chain[acc_chain.shape[0] // 2:])))
        if conv_rhat < 1.1:
            conv_steps = acc_chain.shape[0]
            conv_time = t_conv

    # acquisition throughput: EI marginalized over 100 hyperposterior
    # thetas on a 512-point candidate grid (the other driver metric)
    from bask_tpu.acquisition import _per_draw_predictions, ExpectedImprovement

    rows = jnp.asarray(
        np.asarray(chain[-1])[:100, :], dtype=dtype
    )  # 100 walker thetas
    Xc = jnp.asarray(
        np.random.RandomState(3).uniform(size=(512, N_DIM)), dtype=dtype
    )
    kacq = jax.random.PRNGKey(0)

    ei = ExpectedImprovement()

    # Time K passes inside one lax.scan (same methodology as the chain:
    # one program, so per-dispatch latency does not count). The
    # per-iteration theta perturbation keeps XLA from hoisting the
    # loop-invariant body.
    ACQ_K = 50

    @jax.jit
    def acq_pass():
        def body(c, i):
            mu, std, _ = _per_draw_predictions(
                rows * (1.0 + 1e-6 * i), data, Xc, kacq,
                kernel=kernel, n_warp=0,
                white_idx=kernel.n_theta - 1, need_sample=False,
            )
            vals = jax.vmap(lambda m, s: ei(m, s))(mu, std)
            return c + jnp.sum(vals), None

        out, _ = lax.scan(
            body, jnp.asarray(0.0, dtype), jnp.arange(ACQ_K, dtype=dtype)
        )
        return out

    jax.block_until_ready(acq_pass())  # compile+sync
    t0 = time.perf_counter()
    jax.block_until_ready(acq_pass())
    acq_elapsed = time.perf_counter() - t0
    acq_evals_per_s = ACQ_K * 100 * 512 / acq_elapsed

    # chain-health CONTEXT for the headline number (host-side, not in
    # the timed section). NB: this is a fixed-workload throughput
    # benchmark (the 100x300 shape is driver-defined) — the R-hat/ESS
    # below describe how far that fixed chain got, they are NOT a claim
    # of convergence (benchmarks/bench_convergence.py extends the chain
    # until R-hat < 1.1).
    from bask_tpu.utils.diagnostics import effective_sample_size, split_rhat

    steps = np.asarray(chain)[N_STEPS // 3:]
    if steps.shape[0] >= 4:
        rhat = float(np.max(split_rhat(steps)))
        ess = float(np.min(effective_sample_size(steps)))
    else:
        rhat, ess = float("nan"), float("nan")
    conv = (conv_steps, conv_time, conv_rhat, alt_elapsed)
    return elapsed, acc, acq_evals_per_s, rhat, ess, conv


# ---------------------------------------------------------------------------
# CPU reference path (NumPy/SciPy, serial per-walker like emcee)
# ---------------------------------------------------------------------------


def bench_cpu_reference():
    """Serial stretch-move steps with the reference's per-walker LML.

    Faithful to the reference hot loop (``bask/bayesgpr.py:374``): each
    log-probability call goes through sklearn's
    ``GaussianProcessRegressor.log_marginal_likelihood(theta,
    clone_kernel=True)`` — the same code path bask inherits from the
    skopt GPR fork — on the identical Const*Matern(2.5)+White kernel.
    """
    import sklearn.gaussian_process as skgp
    import sklearn.gaussian_process.kernels as skk

    X, y = _dataset()
    rng = np.random.RandomState(1)
    n_theta = 1 + N_DIM + 1
    pos = _init_positions(n_theta, rng)

    sk_kernel = skk.ConstantKernel(1.0, (0.1, 2.0)) * skk.Matern(
        [0.3] * N_DIM, (0.05, 2.0), nu=2.5
    ) + skk.WhiteKernel(0.05, (1e-5, 1e5))
    gpr = skgp.GaussianProcessRegressor(
        kernel=sk_kernel, alpha=1e-6, optimizer=None
    )
    gpr.fit(X, y)

    def lml(theta):
        try:
            return gpr.log_marginal_likelihood(theta)
        except np.linalg.LinAlgError:
            return -np.inf

    lp = np.array([lml(p) for p in pos])
    half = N_WALKERS // 2
    per_step_samples = []
    # rep 0 is a warmup (BLAS thread pools, allocator, caches) and is
    # discarded; the r2 driver run showed it ~35% faster than steady state
    for _rep in range(CPU_MEASURE_REPS + 1):
        t0 = time.perf_counter()
        for _ in range(CPU_MEASURE_STEPS):
            for lo, hi, olo, ohi in ((0, half, half, N_WALKERS), (half, N_WALKERS, 0, half)):
                for i in range(lo, hi):
                    j = rng.randint(olo, ohi)
                    z = ((2 - 1) * rng.rand() + 1) ** 2 / 2
                    prop = pos[j] + z * (pos[i] - pos[j])
                    lp_prop = lml(prop)
                    if np.log(rng.rand()) < (n_theta - 1) * np.log(z) + lp_prop - lp[i]:
                        pos[i], lp[i] = prop, lp_prop
        if _rep > 0:
            per_step_samples.append(
                (time.perf_counter() - t0) / CPU_MEASURE_STEPS
            )
    per_step = float(np.median(per_step_samples))
    spread = (
        float(np.min(per_step_samples) * N_STEPS),
        float(np.max(per_step_samples) * N_STEPS),
    )
    return per_step * N_STEPS, spread


def _pinned_baseline():
    """Pinned steady-state CPU reference from BASELINE.json: the live
    CPU measurement swings with machine load (r1 308 s,
    r2-driver 193 s, r2-idle 256 s for the identical workload), which
    made `vs_baseline` noise. The pinned idle-machine value makes the
    speedup reproducible; the live measure is kept as a sanity field."""
    try:
        with open(
            os.path.join(os.path.dirname(__file__), "BASELINE.json")
        ) as f:
            return json.load(f).get("pinned_cpu_baseline")
    except Exception:
        return None


def main():
    quick = "--quick" in sys.argv
    global N_STEPS, CPU_MEASURE_STEPS, CPU_MEASURE_REPS
    if quick:
        N_STEPS = 20
        CPU_MEASURE_STEPS = 2
        CPU_MEASURE_REPS = 1

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX platform is {dev.platform!r}")
    dev_time, acc, acq_rate, rhat, ess, conv = bench_device()
    conv_steps, conv_time, conv_rhat, alt_time = conv
    cpu_time, cpu_spread = bench_cpu_reference()
    pinned = None if quick else _pinned_baseline()
    if pinned is not None:
        speedup = pinned["seconds"] / dev_time
    else:
        speedup = cpu_time / dev_time

    print(
        json.dumps(
            {
                "metric": "bayesgpr_fit_n500_d15_100walkers_300steps_wallclock",
                "value": round(dev_time, 3),
                "unit": "s",
                "vs_baseline": round(speedup, 2),
                "detail": {
                    "cpu_reference_pinned_s": (
                        pinned["seconds"] if pinned is not None else None
                    ),
                    "cpu_reference_live_s": round(cpu_time, 1),
                    "cpu_reference_live_spread_s": [
                        round(cpu_spread[0], 1),
                        round(cpu_spread[1], 1),
                    ],
                    "vs_baseline_live": round(cpu_time / dev_time, 2),
                    "acceptance_rate": round(acc, 3),
                    "n_steps": N_STEPS,
                    "acquisition_evals_per_s": round(acq_rate),
                    # fixed-workload context, not a convergence claim:
                    # the timed 300-step chain is NOT converged by this
                    # threshold (see the bench_device comments)
                    "chain_max_rhat": round(rhat, 3),
                    "chain_min_ess": round(ess, 1),
                    "rhat_threshold": 1.1,
                    "chain_converged_at_rhat_1.1": bool(rhat < 1.1),
                    # measured by warm-extending the same chain until
                    # split R-hat < 1.1 (None = not reached within
                    # BENCH_CONV_MAX_CHUNKS x N_STEPS steps or skipped)
                    "steps_to_rhat_1.1": conv_steps,
                    "time_to_rhat_1.1_s": (
                        round(conv_time, 3) if conv_time is not None else None
                    ),
                    "final_extended_rhat": (
                        round(conv_rhat, 3) if conv_rhat is not None else None
                    ),
                    "moves": os.environ.get("BENCH_MOVES", "stretch"),
                    "convergence_moves": os.environ.get(
                        "BENCH_CONV_MOVES", "demix"
                    ),
                    # the SAME fixed workload timed under the
                    # convergence-leg mixture (the library's honest
                    # default sampler at this walker count) — both
                    # headline variants in one bench run
                    "headline_conv_moves_s": (
                        round(alt_time, 3) if alt_time is not None else None
                    ),
                    "vs_baseline_conv_moves": (
                        round(speedup * dev_time / alt_time, 2)
                        if alt_time is not None
                        else None
                    ),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
