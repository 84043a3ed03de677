"""Scenario (DP) and block-partition (TP-analog) sharding drivers.

Strategy (SURVEY.md section 2.9):

- **Scenario batching (DP)**: vmap a solver over a fleet of problem instances
  and shard the batch axis of (x0, data) over the mesh's "batch" axis.  No
  cross-instance communication exists, so this weak-scales trivially.
- **Block partitioning (TP-analog)**: shard one huge variable/tangent vector
  over the "model" axis.  Under jit, the GSPMD partitioner turns the
  solver's inner products into per-device partial reductions + ``psum``,
  and partitions the user's Hv/Jv operators — the JAX analog of the
  reference's injected-operator seam.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from .mesh import BATCH, MODEL

__all__ = ["batch_sharded_solve", "shard_batch", "shard_model_vector",
           "constrain_model"]


def shard_batch(tree: Any, mesh: Mesh, axis_name: str = BATCH) -> Any:
    """Shard the leading (batch) axis of every leaf over ``axis_name``."""

    def put(leaf):
        ndim = getattr(leaf, "ndim", 0)
        spec = PartitionSpec(axis_name, *([None] * (ndim - 1))) if ndim \
            else PartitionSpec()
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(put, tree)


def batch_sharded_solve(solve_fn: Callable, mesh: Mesh,
                        axis_name: str = BATCH) -> Callable:
    """vmap ``solve_fn(x0, data)`` over a leading batch axis and pin the batch
    to the mesh.  Returns a jitted callable; pass batched (x0s, datas) that
    were placed with :func:`shard_batch` (or let GSPMD move them).
    """
    vmapped = jax.vmap(solve_fn)

    def run(x0s, datas=None):
        x0s = shard_batch(x0s, mesh, axis_name)
        if datas is not None:
            datas = shard_batch(datas, mesh, axis_name)
        return vmapped(x0s, datas)

    return run


def shard_model_vector(x: Any, mesh: Mesh, axis_name: str = MODEL) -> Any:
    """Shard the *last* axis of each leaf over the model axis (long-vector
    block partitioning for 10^6-dim tangent vectors)."""

    def put(leaf):
        ndim = getattr(leaf, "ndim", 0)
        spec = PartitionSpec(*([None] * (ndim - 1)), axis_name) if ndim \
            else PartitionSpec()
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(put, x)


def constrain_model(x: Any, mesh: Mesh, axis_name: str = MODEL) -> Any:
    """In-graph sharding constraint keeping a long vector block-partitioned
    (use inside user operators to pin intermediate layouts)."""

    def pin(leaf):
        ndim = getattr(leaf, "ndim", 0)
        spec = PartitionSpec(*([None] * (ndim - 1)), axis_name) if ndim \
            else PartitionSpec()
        return jax.lax.with_sharding_constraint(leaf, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(pin, x)
