"""Row-sharded GP inference across a device mesh (huge-n scaling path).

Demonstrates `bask_tpu.ops.dist_chol`: one gram factorized by
block-row across all devices — each device builds only its own
(n_loc, n) strip, so problems whose full (n, n) gram exceeds a single
device's memory still fit — with the LML, predictive mean/std, and joint
draws all falling out of a single distributed sweep.

Runs anywhere: on a multi-GPU host the collectives ride NVLink; this
script also runs on CPU with virtual devices:

    python examples/large_n_mesh.py

(The script forces an 8-virtual-device CPU mesh when only one device
is visible, so it is runnable on a laptop; on a real multi-chip
runtime it uses the actual devices.)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    # Default to a virtual 8-device CPU mesh (runnable anywhere).
    # Set LARGE_N_MESH_BACKEND=native to use the real devices of the
    # ambient backend (e.g. the GPUs of one host).
    import jax

    if os.environ.get("LARGE_N_MESH_BACKEND", "cpu") == "cpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp
    from jax.sharding import Mesh

    from bask_tpu.ops import kernels as bk
    from bask_tpu.ops.dist_chol import (
        row_sharded_lml,
        row_sharded_predict,
        row_sharded_sample_y,
    )
    from bask_tpu.ops.linalg import masked_lml

    devs = np.array(jax.devices())
    mesh = Mesh(devs, ("rows",))
    P = devs.size
    print(f"mesh: {P} × {devs[0].platform} devices, axis 'rows'")

    # synthetic 4-D problem, padded to a multiple of the mesh size
    d, n_real = 4, 1011
    n_pad = -(-n_real // (64 * P)) * 64 * P
    rng = np.random.RandomState(0)
    X = np.zeros((n_pad, d))
    X[:n_real] = rng.uniform(size=(n_real, d))
    f = lambda Z: np.sin(3 * Z[:, 0]) * np.cos(2 * Z[:, 1]) + Z[:, 2]  # noqa: E731
    y = np.zeros(n_pad)
    y_real = f(X[:n_real]) + 0.05 * rng.randn(n_real)
    y_mean, y_std = y_real.mean(), y_real.std()
    y[:n_real] = (y_real - y_mean) / y_std
    mask = np.arange(n_pad) < n_real
    alpha = np.where(mask, 1e-6, 0.0)

    kernel = bk.ConstantKernel(1.0, (0.1, 10.0)) * bk.Matern(
        tuple([0.4] * d), (0.05, 5.0), nu=2.5
    ) + bk.WhiteKernel(0.01, (1e-6, 1e2))
    theta = jnp.asarray(kernel.theta0)

    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    aj, mj = jnp.asarray(alpha), jnp.asarray(mask)

    # 1. distributed LML == single-device masked LML
    lml_d = float(row_sharded_lml(kernel, theta, Xj, yj, aj, mj, mesh=mesh))
    lml_s = float(masked_lml(kernel, theta, Xj, yj, aj, mj))
    print(f"LML  row-sharded {lml_d:.6f}  vs single-device {lml_s:.6f}  "
          f"(|Δ| {abs(lml_d - lml_s):.2e})")

    # 2. distributed predictions at held-out points
    Xq = rng.uniform(size=(256, d))
    mu, std = row_sharded_predict(
        kernel, theta, Xj, yj, aj, mj, jnp.asarray(Xq), mesh=mesh,
        y_mean=y_mean, y_std=y_std,
    )
    mu, std = np.asarray(mu), np.asarray(std)
    resid = np.abs(mu - f(Xq))
    cover = float(np.mean(resid <= 3 * std + 3 * 0.05))
    print(f"predict: mean |resid| {resid.mean():.4f}, "
          f"3σ coverage {cover:.3f}")

    # 3. joint draws from the distributed posterior
    draws = row_sharded_sample_y(
        kernel, theta, Xj, yj, aj, mj, jnp.asarray(Xq[:16]),
        jax.random.PRNGKey(0), mesh=mesh, n_samples=5,
        y_mean=y_mean, y_std=y_std,
    )
    print(f"sample_y: draws shape {tuple(draws.shape)}, "
          f"spread {float(np.std(np.asarray(draws))):.4f}")


if __name__ == "__main__":
    main()
