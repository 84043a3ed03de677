"""Device meshes and axis-name conventions.

The framework uses two canonical mesh axes (the reference library is
single-process — SURVEY.md section 2.9/2.10 specifies these as new,
first-class components):

- ``BATCH`` ("batch"): scenario/data parallelism — independent problem
  instances sharded across chips; no cross-instance communication.
- ``MODEL`` ("model"): block partitioning of a single huge variable/tangent
  vector; inner products and operator applications turn into per-chip work
  plus ``psum`` collectives over this axis.

Multi-host entry: call :func:`initialize_distributed` once per process, then
build meshes over the global device set.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

BATCH = "batch"
MODEL = "model"

__all__ = ["BATCH", "MODEL", "make_mesh", "batch_mesh", "model_mesh",
           "initialize_distributed"]


def initialize_distributed(**kwargs) -> None:
    """Multi-host entry point: wire up jax.distributed over DCN.

    Thin wrapper over ``jax.distributed.initialize`` so user code has a single
    import site.  No-op if already initialized.
    """
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError:
        pass  # already initialized


def make_mesh(shape: Sequence[int],
              axis_names: Sequence[str] = (BATCH, MODEL),
              devices=None) -> Mesh:
    """Build a mesh of the given logical shape over (a prefix of) devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = int(np.prod(shape))
    if devices.size < n:
        raise ValueError(
            f"Mesh of shape {tuple(shape)} needs {n} devices, "
            f"have {devices.size}")
    return Mesh(devices[:n].reshape(shape), tuple(axis_names))


def batch_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over the batch axis (pure scenario parallelism)."""
    n = n_devices if n_devices is not None else len(jax.devices())
    return make_mesh((n,), (BATCH,))


def model_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over the model axis (block-partitioned vectors)."""
    n = n_devices if n_devices is not None else len(jax.devices())
    return make_mesh((n,), (MODEL,))


def spec(*names) -> PartitionSpec:
    return PartitionSpec(*names)


def shard(tree, mesh: Mesh, pspec: PartitionSpec):
    """device_put a PyTree with a uniform NamedSharding."""
    sharding = NamedSharding(mesh, pspec)
    return jax.tree_util.tree_map(lambda l: jax.device_put(l, sharding), tree)
