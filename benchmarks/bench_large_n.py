"""Large-n END-TO-END batched LML: gram + factorization + assembly.

Unlike bench_scaling.py (factorization-only on a pre-built gram batch),
this measures the full per-half-ensemble MCMC work at large n through
``batched_lml`` — including the walker-axis memory chunking that
activates when the (W, n, n) gram batch exceeds ``LML_MAX_BATCH_BYTES``
(the default 100-walker fit must run at n=4096+ instead of running out
of memory).

Run ONE config per process:

    BENCH_W=50  python benchmarks/bench_large_n.py 4096
    BENCH_W=100 python benchmarks/bench_large_n.py 4096

Times K evaluations inside one lax.scan, scalar-host-fetch synced.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

W = int(os.environ.get("BENCH_W", 50))
D = 15


def main():
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    K = max(2, 8192 // N)

    import jax
    import jax.numpy as jnp
    from jax import lax

    from bask_tpu.ops import kernels as bk
    from bask_tpu.ops import linalg

    kernel = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern(
        tuple([0.3] * D), (0.05, 2.0), nu=2.5
    ) + bk.WhiteKernel(0.05, (1e-5, 1e5))

    rng = np.random.RandomState(0)
    X = jnp.asarray(rng.uniform(size=(N, D)), jnp.float32)
    y_np = np.sum((rng.uniform(size=(N, D)) - 0.5) ** 2, axis=1)
    y = jnp.asarray((y_np - y_np.mean()) / y_np.std(), jnp.float32)
    alpha = jnp.full(N, 1e-4, jnp.float32)
    mask = jnp.ones(N, bool)
    thetas = jnp.asarray(
        np.concatenate(
            [
                0.05 * rng.randn(W, 1),
                np.log(0.5) + 0.05 * rng.randn(W, D),
                np.log(0.05) + 0.05 * rng.randn(W, 1),
            ],
            axis=1,
        ),
        jnp.float32,
    )

    chunk = linalg._lml_chunk_walkers(N, 4, W)
    print(
        f"W={W} N={N}: chunk={chunk} walkers/chunk "
        f"({'chunked' if chunk < W else 'single batch'}; "
        f"gram batch {W * N * N * 4 / 1e9:.1f} GB unchunked)"
    )

    @jax.jit
    def bench(th):
        def body(c, i):
            lml = linalg.batched_lml(kernel, th + 1e-5 * i, X, y, alpha, mask)
            return c + jnp.sum(lml), None

        out, _ = lax.scan(
            body, jnp.float32(0.0), jnp.arange(K, dtype=jnp.float32)
        )
        return out

    out = bench(thetas)
    float(out)
    t0 = time.perf_counter()
    out = bench(thetas)
    float(out)
    dt = (time.perf_counter() - t0) / K
    flops = W * N**3 / 3  # factorization flops (gram/solves excluded)
    print(
        f"W={W} N={N}: {dt*1e3:.1f} ms per batched LML "
        f"({flops/dt/1e12:.2f} TFLOP/s chol-equivalent); "
        f"sum={float(out):.3e}"
    )


if __name__ == "__main__":
    main()
