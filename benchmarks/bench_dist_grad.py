"""Adjoint vs jvp row-sharded ML-II gradient (value+grad per call).

The adjoint path (``row_sharded_lml_value_grad(method="adjoint")``)
assembles the closed-form GPML gradient from ~3 distributed passes
regardless of the hyperparameter count D; the jvp path pays D primal+
tangent factorization sweeps. With the north-star D=17 theta the flop
ratio is ~10x — this measures what actually lands:

    python benchmarks/bench_dist_grad.py 2048 adjoint
    python benchmarks/bench_dist_grad.py 2048 jvp

Runs on whatever backend is ambient: on one GPU use a 1-device mesh
(constant-overhead A/B, like bench_dist_lml.py); on CPU set
BENCH_CPU=1 for the 8-virtual-device mesh (relative numbers only).
One variant per process; K evals inside one
lax.scan, scalar-host-fetch synced; exactness asserted at a small n.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# XLA_FLAGS must be set BEFORE jax import — backend init is lazy today,
# but any import that touches devices would otherwise silently yield a
# 1-device mesh and a misleading benchmark
if os.environ.get("BENCH_CPU"):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import numpy as np

D = 15  # input dim; theta has D+3 entries (const + D ls + white)


def main():
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    variant = sys.argv[2] if len(sys.argv) > 2 else "adjoint"
    nb = int(os.environ.get("BENCH_NB", 256))
    K = max(2, 4096 // N)

    import jax

    if os.environ.get("BENCH_CPU"):
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh

    from bask_tpu.ops import kernels as bk
    from bask_tpu.ops.dist_chol import row_sharded_lml_value_grad

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

    n_dev = len(jax.devices()) if os.environ.get("BENCH_CPU") else 1
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("r",))

    def vg(t, method):
        return row_sharded_lml_value_grad(
            kernel, t, X, y, alpha, mask, mesh=mesh, nb=nb, method=method
        )

    # exactness at a small n before timing (both paths vs each other)
    nc = 512
    va, ga = jax.jit(
        lambda t: row_sharded_lml_value_grad(
            kernel, t, X[:nc], y[:nc], alpha[:nc], mask[:nc],
            mesh=mesh, nb=min(nb, 128), method="adjoint",
        )
    )(theta)
    vj, gj = jax.jit(
        lambda t: row_sharded_lml_value_grad(
            kernel, t, X[:nc], y[:nc], alpha[:nc], mask[:nc],
            mesh=mesh, nb=min(nb, 128), method="jvp",
        )
    )(theta)
    assert abs(float(va) - float(vj)) < 1e-3 * max(1.0, abs(float(vj)))
    ga, gj = np.asarray(ga), np.asarray(gj)
    scale = max(1.0, float(np.abs(gj).max()))
    assert float(np.abs(ga - gj).max()) < 1e-2 * scale, (ga, gj)

    @jax.jit
    def bench(t):
        def body(c, i):
            v, g = vg(t + 1e-5 * i, variant)
            return c + v + jnp.sum(g), None

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
    print(
        f"{variant} N={N} nb={nb} D_theta={kernel.n_theta}: "
        f"{dt*1e3:.1f} ms per value+grad; sum={float(out):.3e}"
    )


if __name__ == "__main__":
    main()
