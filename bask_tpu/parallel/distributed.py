"""Multi-host (multi-process) runtime: jax.distributed wiring + global mesh.

The reference is strictly single-process (SURVEY.md §2 absent-rows: no
NCCL/MPI/Gloo anywhere). The scaling story past one host is:

* ``init_distributed`` — opt-in `jax.distributed.initialize` wrapper
  (coordinator/process-count/process-id from args or the standard
  ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``
  env vars). After it returns, ``jax.devices()`` is the *global* device
  list spanning all hosts.
* ``global_walker_mesh`` — a 1-D mesh over the global devices. Walker
  ensembles and candidate grids shard across it exactly as on one host;
  the stretch move's complementary-half gather is the only collective
  and rides the intra-host interconnect (NVLink) within a host and the
  network across hosts.
* ``shard_global`` — build a process-spanning global array from a
  host-local copy (every process holds the same full array, e.g. the
  deterministic seeded walker init; each contributes its addressable
  shards).

Network-aware candidate sharding plan: candidate grids are
embarrassingly parallel with *zero* cross-shard communication until the
final argmax (one scalar+index all-reduce), so candidate shards should
map to the outermost (cross-host) mesh axis while walker ensembles —
whose per-step gather is latency-sensitive — stay within a host: build
a 2-D mesh
``Mesh(devices.reshape(n_hosts, devs_per_host), ("cand", "walkers"))``
and shard candidates on "cand", walkers on "walkers".
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["init_distributed", "global_walker_mesh", "shard_global"]


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> tuple:
    """Initialize the multi-process runtime (opt-in; no-op args read env).

    Returns ``(process_index, process_count)``. Must be called before the
    first device use. Single-process callers never need this.
    """
    kwargs = {}
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)
    return jax.process_index(), jax.process_count()


def global_walker_mesh(axis: str = "walkers") -> Mesh:
    """1-D mesh over ALL global devices (all hosts)."""
    return Mesh(np.array(jax.devices()), (axis,))


def shard_global(arr, mesh: Mesh, axis: str, sharded_dim: int = 0):
    """Global array sharded on ``sharded_dim`` from a host-local full copy.

    Every process must hold the same full ``arr`` (true for seeded
    deterministic inits); each contributes only its addressable shards.
    Works single-process too (equivalent to a sharded device_put).
    """
    arr = np.asarray(arr)
    spec = [None] * arr.ndim
    spec[sharded_dim] = axis
    sharding = NamedSharding(mesh, PartitionSpec(*spec))
    return jax.make_array_from_callback(
        arr.shape, sharding, lambda idx: arr[idx]
    )
