"""Candidate-grid sharding: acquisition evaluation over a mesh-sharded
candidate grid must match the unsharded values exactly (pure data
parallelism; the only collective is the final argmax reduction)."""

import numpy as np
import jax
import jax.numpy as jnp

from bask_tpu.acquisition import ExpectedImprovement
from bask_tpu.models import gp as gpc
from bask_tpu.models.bayesgpr import BayesGPR
from bask_tpu.ops import kernels as bk
from bask_tpu.parallel.mesh import shard_candidates, walker_mesh


def test_sharded_candidate_grid_matches_unsharded():
    rng = np.random.RandomState(0)
    X = rng.uniform(size=(12, 2))
    y = np.sin(4 * X[:, 0]) + X[:, 1]

    gp = BayesGPR(
        kernel=bk.ConstantKernel(1.0, (0.1, 2.0))
        * bk.Matern((0.3, 0.3), (0.05, 2.0), nu=2.5),
        random_state=3,
    )
    gp.fit(
        X, y, n_burnin=2, n_desired_samples=16, n_walkers_per_thread=16,
        progress=False,
    )

    n_cand = 64  # 8 per device on the 8-device mesh
    Xc = rng.uniform(size=(n_cand, 2))
    theta = jnp.asarray(gp.theta)
    kernel = gp.kernel_
    data = gp._post_data
    post = gp._post
    ei = ExpectedImprovement()

    @jax.jit
    def acq_argmax(Xc):
        mu, std = gpc.predict(
            kernel, theta, post, data, Xc, return_std=True
        )
        vals = ei(mu, std)
        return vals, jnp.argmax(vals)

    vals_ref, best_ref = acq_argmax(jnp.asarray(Xc))

    mesh = walker_mesh(8, axis="cand")
    Xc_sharded = shard_candidates(jnp.asarray(Xc), mesh, axis="cand")
    vals_sh, best_sh = acq_argmax(Xc_sharded)

    np.testing.assert_allclose(
        np.asarray(vals_sh), np.asarray(vals_ref), rtol=1e-12
    )
    assert int(best_sh) == int(best_ref)


def test_sharded_candidates_through_fused_gram_precompute():
    """The marginalized per-draw path (one batched gram and
    factorization for all draws) must match unsharded values when the
    candidate grid is mesh-sharded: the per-draw training grams have
    replicated operands, and GSPMD shards only the downstream
    cross-gram/predict."""
    from bask_tpu import acquisition as acq

    rng = np.random.RandomState(1)
    n_pad, n_real, d, S = 64, 40, 2, 8
    kernel = (
        bk.ConstantKernel(1.0, (0.1, 2.0))
        * bk.Matern((0.3,) * d, (0.05, 2.0), nu=2.5)
        + bk.WhiteKernel(0.05, (1e-5, 1e5))
    )
    Xp = np.zeros((n_pad, d), np.float32)
    Xp[:n_real] = rng.uniform(size=(n_real, d))
    yp = np.zeros(n_pad, np.float32)
    yp[:n_real] = rng.randn(n_real)
    data = gpc.make_data(
        jnp.asarray(Xp, jnp.float32),
        jnp.asarray(yp, jnp.float32),
        jnp.full(n_pad, 1e-6, jnp.float32),
        jnp.arange(n_pad) < n_real,
    )
    rows = jnp.asarray(
        np.log(0.3) + 0.05 * rng.randn(S, kernel.n_theta), jnp.float32
    )
    Xc = jnp.asarray(rng.uniform(size=(64, d)), jnp.float32)
    key = jax.random.PRNGKey(0)

    @jax.jit
    def per_draw(Xq):
        mu, std, _ = acq._per_draw_body(
            rows, data, Xq, key, kernel, 0, kernel.n_theta - 1, False
        )
        return mu, std

    mu_ref, std_ref = per_draw(Xc)

    mesh = walker_mesh(8, axis="cand")
    Xc_sh = shard_candidates(Xc, mesh, axis="cand")
    mu_sh, std_sh = per_draw(Xc_sh)

    np.testing.assert_allclose(
        np.asarray(mu_sh), np.asarray(mu_ref), rtol=0, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(std_sh), np.asarray(std_ref), rtol=0, atol=1e-6
    )
