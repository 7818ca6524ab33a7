"""Device-mesh helpers for sharding walker ensembles and candidate grids.

The reference is single-process with no distributed backend (SURVEY.md §2
absent-rows). The scaling axes are the walker ensemble and the
acquisition candidate grid: both are embarrassingly data-parallel, so the
sharding story is one 1-D mesh axis, with XLA inserting the (tiny)
complementary-half all-gather of the stretch move (over NVLink on a
multi-GPU host).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["walker_mesh", "shard_walkers", "shard_candidates"]


def walker_mesh(n_devices: Optional[int] = None, axis: str = "walkers") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    devs: Sequence = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_walkers(pos, mesh: Mesh, axis: str = "walkers"):
    """Place a (W, D) walker array with W sharded across ``mesh``."""
    return jax.device_put(pos, NamedSharding(mesh, PartitionSpec(axis, None)))


def shard_candidates(X, mesh: Mesh, axis: str = "walkers"):
    """Place a candidate grid (C, d) with C sharded across ``mesh``."""
    return jax.device_put(X, NamedSharding(mesh, PartitionSpec(axis, None)))
