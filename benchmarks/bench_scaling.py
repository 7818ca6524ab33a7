"""Large-n scaling of the batched blocked Cholesky (MCMC hot shape).

The production config (50, 512, 512) is latency-bound; at larger n the
panels get fat and utilization should climb — IF the panel width nb
scales with n. ``pick_nb`` uses 128 up to n=512 and 256 beyond; this
benchmark measures other widths to set the large-n policy.

Run ONE config per process:

    python benchmarks/bench_scaling.py 1024 128
    python benchmarks/bench_scaling.py 1024 256
    python benchmarks/bench_scaling.py 2048 256   # etc.

Times K factorizations inside one lax.scan, scalar-host-fetch synced.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

W = int(os.environ.get("BENCH_W", 50))


def main():
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    nb = int(sys.argv[2]) if len(sys.argv) > 2 else None
    K = max(4, 20480 // N)

    import jax
    import jax.numpy as jnp
    from jax import lax

    from bask_tpu.ops import fast_cholesky as fc

    def fact(A):
        return fc.block_cholesky(A, nb=nb)[0]

    rng = np.random.RandomState(0)
    Xp = rng.uniform(size=(N, 15))
    d2 = ((Xp[:, None, :] - Xp[None, :, :]) ** 2).sum(-1)
    K0 = np.exp(-0.5 * d2 / 0.3**2) + 1e-2 * np.eye(N)
    A = jnp.asarray(
        np.broadcast_to(K0, (W, N, N)).copy()
        * (1.0 + 0.01 * rng.rand(W))[:, None, None],
        dtype=jnp.float32,
    )

    @jax.jit
    def bench(A):
        # eye is built INSIDE the jit: a closed-over host constant of
        # N^2 floats would be embedded in the compiled program
        eye = jnp.eye(N, dtype=jnp.float32)

        def body(c, i):
            L = fact(A + (1e-5 * (i + 1.0)) * eye)
            return c + L[0, 0, 0] + L[-1, -1, -1], None

        out, _ = lax.scan(
            body, jnp.float32(0.0), jnp.arange(K, dtype=jnp.float32)
        )
        return out

    L1 = fact(A)
    err = float(
        jnp.max(
            jnp.abs(
                jnp.matmul(
                    L1[0], L1[0].T, precision=jax.lax.Precision.HIGHEST
                )
                - A[0]
            )
        )
    )

    out = bench(A)
    float(out)
    t0 = time.perf_counter()
    out = bench(A)
    float(out)
    dt = (time.perf_counter() - t0) / K
    flops = W * N**3 / 3
    print(
        f"N={N} nb={nb}: {dt*1e3:.3f} ms per ({W},{N},{N}) factorization; "
        f"{flops/dt/1e12:.2f} TFLOP/s; recon err {err:.2e}"
    )


if __name__ == "__main__":
    main()
