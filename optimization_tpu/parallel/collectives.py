"""Named reduction primitives: the distributed seam of every solver.

The reference's algorithms communicate *only* through injected inner products,
operator applications, and Gram-matrix formation (SURVEY.md section 2.9).
Those are exactly the reduction points that become XLA collectives on a
device mesh.  This module packages them so solver code never mentions mesh
axes:

- under plain ``jit`` with ``NamedSharding``-annotated arguments, the GSPMD
  partitioner inserts the collectives automatically — solvers need nothing;
- inside ``shard_map``-ed code (manual-collective kernels, consensus ADMM),
  use these wrappers.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp

from ..core.tree import tree_dot

__all__ = ["pdot", "pnorm", "pmean_tree", "sharded_inner", "psum_scalar",
           "sharded_gram", "sharded_gram_pair", "ring_gram"]


def psum_scalar(x, axis) -> jnp.ndarray:
    return jax.lax.psum(x, axis)


def pdot(u: Any, v: Any, axis) -> jnp.ndarray:
    """Distributed inner product: local PyTree dot + psum over ``axis``."""
    return jax.lax.psum(tree_dot(u, v), axis)


def pnorm(u: Any, axis) -> jnp.ndarray:
    return jnp.sqrt(pdot(u, u, axis))


def pmean_tree(tree: Any, axis) -> Any:
    """Leafwise pmean — the consensus-averaging primitive for ADMM."""
    return jax.tree_util.tree_map(lambda l: jax.lax.pmean(l, axis), tree)


def sharded_gram(S_local: jnp.ndarray, AS_local: jnp.ndarray,
                 axis) -> jnp.ndarray:
    """Distributed Gram matrix ``S' AS`` for a basis row-sharded over
    ``axis`` (the long-vector / SP-analog seam of SURVEY.md section 2.9,
    mapping the LOBPCG Gram stage ``LOBPCG.h:271-272``): each shard forms its
    local (k x k) contribution, then one small psum crosses devices."""
    local = jnp.matmul(S_local.T, AS_local,
                       precision=jax.lax.Precision.HIGHEST)
    return jax.lax.psum(local, axis)


def sharded_gram_pair(S_local, AS_local, BS_local, axis):
    """``(S'AS, S'BS)`` with a single fused psum over ``axis``."""
    ga = jnp.matmul(S_local.T, AS_local,
                    precision=jax.lax.Precision.HIGHEST)
    gb = jnp.matmul(S_local.T, BS_local,
                    precision=jax.lax.Precision.HIGHEST)
    return jax.lax.psum((ga, gb), axis)


def ring_gram(S_local: jnp.ndarray, AS_local: jnp.ndarray,
              axis) -> jnp.ndarray:
    """Distributed Gram matrix ``S' AS`` for a basis COLUMN-blocked over
    ``axis`` — the SURVEY.md section-2.9 ppermute ring variant of
    :func:`sharded_gram` (LOBPCG Gram stage ``LOBPCG.h:271-272``): each
    device holds its (m, nx/k) column block of S and AS; the S block
    rotates around the ring while each device accumulates its (nx, nx/k)
    output column block ``S' AS_local``.  Returns the LOCAL output column
    block — under ``shard_map`` reassemble the full (nx, nx) Gram
    columnwise with ``out_specs=P(None, axis)``, or keep it sharded for a
    column-blocked consumer.

    **Adjudication — row-sharding dominates
    at every feasible shape; this exists as the tested completeness of
    the SURVEY design row, not a production path.**  Per device, the ring
    moves (k-1) messages of m*nx/k words ~= m*nx words per Gram, where
    :func:`sharded_gram`'s single psum moves ~nx^2 words; LOBPCG bases
    have m >> nx (m ~ 1e4..1e7 rows, nx <= 3*n_ev ~ 1e1..1e2 columns), so
    the ring pays ~m/nx MORE communication — orders of magnitude at every
    realistic size.  Column-blocking buys no memory headroom either: a
    column block is (m, nx/k) = the same m*nx/k words per device as a row
    shard's (m/k, nx), so there is no (m, nx) where a basis fits
    column-blocked but not row-sharded.  The row-sharded local-GEMM +
    one-psum design of :func:`sharded_gram` is therefore optimal at every
    feasible shape (the verdict SURVEY section 2.9 left open).
    """
    k = jax.lax.psum(1, axis)
    idx = jax.lax.axis_index(axis)
    c = S_local.shape[1]
    perm = [(i, (i + 1) % k) for i in range(k)]

    def step(t, carry):
        S_rot, blk = carry
        owner = jnp.mod(idx - t, k)       # whose column block we hold
        g = jnp.matmul(S_rot.T, AS_local,
                       precision=jax.lax.Precision.HIGHEST)
        off = (owner * c).astype(jnp.int32)
        blk = jax.lax.dynamic_update_slice(
            blk, g, (off, jnp.zeros((), jnp.int32)))
        S_rot = jax.lax.ppermute(S_rot, axis, perm)
        return S_rot, blk

    # the accumulator is device-varying from step 0 (each device holds a
    # different column block) — mark it so under shard_map's vma typing
    blk0 = jax.lax.pcast(jnp.zeros((k * c, c), S_local.dtype), (axis,),
                         to="varying")
    _, blk = jax.lax.fori_loop(0, k, step, (S_local, blk0))
    # device d's blk is G[:, d*c:(d+1)*c]
    return blk


def sharded_inner(axis) -> Callable[[Any, Any, Any], jnp.ndarray]:
    """A manifold-metric-shaped inner product (x, u, v) -> scalar that
    reduces across ``axis`` — inject into a Manifold for shard_map-ed solves."""

    def inner(x, u, v):
        return pdot(u, v, axis)

    return inner
