"""Row-sharded distributed LML vs the single-device masked LML.

The row-sharded factorization (``ops/dist_chol.py``) is the
model-parallel path for n beyond one device's memory. On one device
what this measures is the path's constant overhead — a
1-device mesh runs the identical program (shard_map, psum/all_gather
collectives degenerate to copies) and an A/B against ``masked_lml``
bounds the cost of the sharded formulation:

    python benchmarks/bench_dist_lml.py 4096 sharded
    python benchmarks/bench_dist_lml.py 4096 sharded-unroll
    python benchmarks/bench_dist_lml.py 4096 plain

One variant per process; K evals inside one
lax.scan, scalar-host-fetch synced; exactness asserted before timing.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

D = 15


def main():
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    variant = sys.argv[2] if len(sys.argv) > 2 else "sharded"
    nb = int(os.environ.get("BENCH_NB", 512))
    K = max(2, 8192 // N)

    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh

    from bask_tpu.ops import kernels as bk
    from bask_tpu.ops import linalg
    from bask_tpu.ops.dist_chol import row_sharded_lml

    kernel = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern(
        tuple([0.3] * D), (0.05, 2.0), nu=2.5
    ) + bk.WhiteKernel(0.05, (1e-5, 1e5))

    rng = np.random.RandomState(0)
    X = jnp.asarray(rng.uniform(size=(N, D)), jnp.float32)
    y_np = np.sum((rng.uniform(size=(N, D)) - 0.5) ** 2, axis=1)
    y = jnp.asarray((y_np - y_np.mean()) / y_np.std(), jnp.float32)
    alpha = jnp.full(N, 1e-4, jnp.float32)
    mask = jnp.ones(N, bool)
    theta = jnp.asarray(kernel.theta0 + 0.05, jnp.float32)

    mesh = Mesh(np.array(jax.devices()[:1]), ("r",))

    def sharded(t):
        return row_sharded_lml(
            kernel, t, X, y, alpha, mask, mesh=mesh, nb=nb
        )

    def sharded_unroll(t):
        return row_sharded_lml(
            kernel, t, X, y, alpha, mask, mesh=mesh, nb=nb, unroll=True
        )

    def plain(t):
        return linalg.masked_lml(kernel, t, X, y, alpha, mask)

    fn = {
        "sharded": sharded,
        "sharded-unroll": sharded_unroll,
        "plain": plain,
    }[variant]

    # Exactness: only in the sharded process, and at a SMALL n (a
    # timed-shape compile is slow; the plain process must never compile
    # the sharded program — one
    # variant per process is the point of the A/B).
    if variant.startswith("sharded"):
        nc = 512
        Xc_, yc_ = X[:nc], y[:nc]
        ac_, mc_ = alpha[:nc], mask[:nc]
        a = float(
            jax.jit(
                lambda t: row_sharded_lml(
                    kernel, t, Xc_, yc_, ac_, mc_, mesh=mesh,
                    nb=min(nb, 256),
                )
            )(theta)
        )
        b = float(
            jax.jit(
                lambda t: linalg.masked_lml(kernel, t, Xc_, yc_, ac_, mc_)
            )(theta)
        )
        # f32: the blocked orderings differ, allow loose rtol
        assert abs(a - b) < 1e-3 * max(1.0, abs(b)), (a, b)

    @jax.jit
    def bench(t):
        def body(c, i):
            return c + fn(t + 1e-5 * i), None

        out, _ = lax.scan(
            body, jnp.float32(0.0), jnp.arange(K, dtype=jnp.float32)
        )
        return out

    out = bench(theta)
    float(out)
    t0 = time.perf_counter()
    out = bench(theta)
    float(out)
    dt = (time.perf_counter() - t0) / K
    flops = N**3 / 3
    print(
        f"{variant} N={N} nb={nb}: {dt*1e3:.1f} ms per LML "
        f"({flops/dt/1e12:.2f} TFLOP/s chol-equivalent); "
        f"sum={float(out):.3e}"
    )


if __name__ == "__main__":
    main()
