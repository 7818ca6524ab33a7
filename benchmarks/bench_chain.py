"""North-star warm chain wall-clock under config knobs.

Runs the REAL fused chain program (n=500 d=15 pad->512, W=100, 300
steps) twice in-process (first run compiles+warms) and reports the
second, scalar-fetch synced. One variant per process:

    python benchmarks/bench_chain.py            # defaults
    BENCH_MOVES=demix python benchmarks/bench_chain.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

MOVES = {
    "stretch": None,
    "demix": (("de", 0.8), ("snooker", 0.2)),
    "tri": (("stretch", 0.5), ("de", 0.4), ("snooker", 0.1)),
}


def main():
    import jax

    if os.environ.get("BENCH_CPU"):
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from bask_tpu.ops import kernels as bk

    moves = MOVES[os.environ.get("BENCH_MOVES", "stretch")]

    if os.environ.get("BENCH_FWD") == "left":
        # A/B: the pre-r4 LEFT-looking vector forward solve (library
        # code was cut after the matrix-solve A/B at n=8192; this
        # bench-local copy answers whether the VECTOR solve inside the
        # chain LML regressed at the north-star n=512 shape)
        from bask_tpu.ops import fast_cholesky as fc

        def _left_forward_solve(L, invs, y, nb=None):
            n = L.shape[-1]
            if len(invs) == 1 and invs[0].shape[-1] == n:
                return (fc._mm(invs[0], y[..., None]))[..., 0]
            spans = fc._layout_from_invs(invs)
            ws = []
            for j, (lo, hi) in enumerate(spans):
                rhs = y[..., lo:hi]
                for k, wk in enumerate(ws):
                    klo, khi = spans[k]
                    Ljk = L[..., lo:hi, klo:khi]
                    rhs = rhs - (fc._mm(Ljk, wk[..., None]))[..., 0]
                ws.append((fc._mm(invs[j], rhs[..., None]))[..., 0])
            import jax.numpy as _jnp

            return _jnp.concatenate(ws, axis=-1)

        fc.block_forward_solve = _left_forward_solve
        from bask_tpu.ops import linalg as _linalg  # noqa: F401 (re-bind check)

    import bask_tpu as bt

    D, N, W, steps = 15, 500, 100, 300
    kernel = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern(
        tuple([0.3] * D), (0.05, 2.0), nu=2.5
    ) + bk.WhiteKernel(0.05, (1e-5, 1e5))
    rng = np.random.RandomState(42)
    X = rng.uniform(size=(N, D))
    y = np.sum((X - 0.5) ** 2, axis=1) + 0.2 * rng.randn(N)

    # optimizer=None: time the SAMPLE phase only (the ML-II warm start
    # is host-driven and identical across the knobs under test)
    gp = bt.BayesGPR(
        kernel=kernel, normalize_y=True, random_state=0, optimizer=None
    )
    t0 = time.perf_counter()
    gp.fit(
        X, y, n_burnin=0, n_desired_samples=steps * W,
        n_walkers_per_thread=W, progress=False, moves=moves,
    )
    cold = time.perf_counter() - t0

    gp2 = bt.BayesGPR(
        kernel=kernel, normalize_y=True, random_state=0, optimizer=None
    )
    t0 = time.perf_counter()
    gp2.fit(
        X, y, n_burnin=0, n_desired_samples=steps * W,
        n_walkers_per_thread=W, progress=False, moves=moves,
    )
    warm = time.perf_counter() - t0
    acc = gp2.n_accepted_ / gp2.n_proposals_
    print(
        f"chain moves={os.environ.get('BENCH_MOVES', 'stretch')}: "
        f"warm {warm:.3f} s / cold {cold:.1f} s for {steps} steps, "
        f"acc {acc:.3f}"
    )


if __name__ == "__main__":
    main()
