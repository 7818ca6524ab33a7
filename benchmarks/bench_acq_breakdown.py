"""Acquisition-pass breakdown at the bench shape (100 thetas x 512 cand).

Times progressively larger slices of the marginalized prediction
program inside one lax.scan (one slice per process):

    python benchmarks/bench_acq_breakdown.py gram      # batched gram only
    python benchmarks/bench_acq_breakdown.py chol      # gram + factorization
    python benchmarks/bench_acq_breakdown.py full      # the production pass

The deltas localize the cost between gram construction, the batched
factorization, and the predict solves/std assembly.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

S, N, C, D, K = 100, 512, 512, 15, 50


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "full"

    import jax
    import jax.numpy as jnp
    from jax import lax

    from bask_tpu.models import gp as gpc
    from bask_tpu.ops import kernels as bk
    from bask_tpu.ops.linalg import masked_gram
    from bask_tpu.acquisition import _per_draw_predictions, ExpectedImprovement

    rng = np.random.RandomState(0)
    n = 500
    X = rng.uniform(size=(n, D))
    y = np.sum((X - 0.5) ** 2, axis=1) + 0.05 * rng.randn(n)
    y = (y - y.mean()) / y.std()
    kernel = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern(
        tuple([0.3] * D), (0.05, 2.0), nu=2.5
    ) + bk.WhiteKernel(0.01, (1e-5, 1e5))
    Xp = np.full((N, D), 0.5)
    Xp[:n] = X
    yp = np.zeros(N)
    yp[:n] = y
    data = gpc.make_data(
        jnp.asarray(Xp, jnp.float32),
        jnp.asarray(yp, jnp.float32),
        jnp.full(N, 1e-6, jnp.float32),
        jnp.asarray(np.arange(N) < n),
    )
    rows = jnp.asarray(
        np.log(0.3) * np.ones((S, kernel.n_theta))
        + 0.05 * rng.randn(S, kernel.n_theta),
        jnp.float32,
    )
    Xc = jnp.asarray(rng.uniform(size=(C, D)), jnp.float32)
    key = jax.random.PRNGKey(0)
    ei = ExpectedImprovement()

    # NB: sinks must consume the FULL outputs — a partial sink (e.g.
    # L[0,0]) lets XLA dead-code-eliminate most of the slice and the
    # deltas become meaningless.
    def gram_only(rows_i):
        G = jax.vmap(
            lambda t: masked_gram(kernel, t, data.X, data.alpha_diag, data.mask)
        )(rows_i)
        return jnp.sum(G)

    def gram_chol(rows_i):
        def one(t):
            post, invs = gpc.posterior_and_invs(kernel, t, data)
            s = jnp.sum(post.L) + jnp.sum(post.alpha_dual)
            if invs is not None:
                for iv in invs:
                    s = s + jnp.sum(iv)
            return s

        return jnp.sum(jax.vmap(one)(rows_i))

    def mu_only(rows_i):
        def one(t):
            post, invs = gpc.posterior_and_invs(kernel, t, data)
            mu = gpc.predict(kernel, t, post, data, Xc, invs=invs)
            return jnp.sum(mu)

        return jnp.sum(jax.vmap(one)(rows_i))

    def mu_std(rows_i):
        def one(t):
            post, invs = gpc.posterior_and_invs(kernel, t, data)
            mu, std = gpc.predict(
                kernel, t, post, data, Xc, return_std=True, invs=invs
            )
            return jnp.sum(mu) + jnp.sum(std)

        return jnp.sum(jax.vmap(one)(rows_i))

    def mu_std_high(rows_i):
        """std solve at HIGH (reduced) matmul precision — experiment."""
        from jax.scipy.linalg import solve_triangular  # noqa: F401
        from bask_tpu.ops import fast_cholesky as fc

        def one(t):
            post, invs = gpc.posterior_and_invs(kernel, t, data)
            Ks = kernel.eval(t, Xc, data.X) * data.mask[None, :]
            mu = Ks @ post.alpha_dual
            v = fc.block_solve_lower_mat(
                post.L, invs, Ks.T, precision=lax.Precision.HIGH
            )
            var = kernel.diag(t, Xc) - jnp.sum(v * v, axis=0)
            return jnp.sum(mu) + jnp.sum(jnp.sqrt(jnp.maximum(var, 0.0)))

        return jnp.sum(jax.vmap(one)(rows_i))

    def full(rows_i):
        mu, std, _ = _per_draw_predictions(
            rows_i, data, Xc, key,
            kernel=kernel, n_warp=0,
            white_idx=kernel.n_theta - 1, need_sample=False,
        )
        return jnp.sum(jax.vmap(lambda m, s: ei(m, s))(mu, std))

    fn = {
        "gram": gram_only,
        "chol": gram_chol,
        "mu": mu_only,
        "mustd": mu_std,
        "mustd-high": mu_std_high,
        "full": full,
    }[which]

    @jax.jit
    def bench(rows):
        def body(c, i):
            return c + fn(rows + 1e-5 * i), None

        out, _ = lax.scan(
            body, jnp.float32(0.0), jnp.arange(K, dtype=jnp.float32)
        )
        return out

    out = bench(rows)
    float(out)
    t0 = time.perf_counter()
    out = bench(rows)
    float(out)
    dt = (time.perf_counter() - t0) / K
    print(f"{which}: {dt*1e3:.2f} ms per ({S} thetas, {N} train, {C} cand) pass")


if __name__ == "__main__":
    main()
