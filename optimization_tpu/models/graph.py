"""Edge->vertex accumulation strategies for graph-structured operators.

Every hot operator in the pose/rotation model family reduces per-edge
contributions onto vertices (the adjoint of the edge-incidence gather):
the weighted graph Laplacian, the connection Laplacian, the incidence
adjoint A', and the translation-data adjoint B'.  The reference computes
these with Eigen sparse matrices (SE-Sync-style cached products); the
baseline JAX expression is a pair of ``out.at[idx].add(...)`` scatters.

XLA may lower scatter-with-duplicate-indices conservatively (serialized,
or with atomics whose order changes from run to run on a GPU), so this
module provides drop-in alternatives with identical semantics, chosen per
problem at *construction* time (indices must be concrete — every caller
builds its operator closures outside jit):

- ``"scatter"`` — the baseline ``.at[].add()`` pair.
- ``"gather"``  — a host-precomputed padded incidence table: each vertex
  row lists its (up to deg_max) incident edge slots, apply = one dense
  gather + a sum over the slot axis.  No scatter at all; pads the edge
  reads by deg_max/mean_deg (bounded-degree graphs only — a hub vertex
  makes the table explode, so construction falls back to ``"sort"`` when
  padding exceeds ``pad_factor``).
- ``"sort"``    — entries sorted by vertex once at construction; apply =
  ``segment_sum(..., indices_are_sorted=True)``, which XLA lowers without
  the duplicate-index serialization hazard.

All three are numerically identical up to f32 summation order (each
vertex's contributions are summed in a different association); tests pin
them against each other at f64 tolerance on random multigraphs including
self-loops, isolated vertices, and hubs.

The benchmark ``benchmarks/probe_scatter.py`` measures the strategies; the
model-layer default stays ``"scatter"`` unless a measurement says
otherwise for the target scale.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
from jax import ops as jax_ops

__all__ = ["adjacency_tables", "edge_accumulator", "laplacian_apply"]


def _padded_table(entries_vert: np.ndarray, n: int, n_slots: int):
    """(n, deg_max) int32 table of entry-slot ids per vertex, sentinel
    ``n_slots`` for padding (points at an appended zero row)."""
    order = np.argsort(entries_vert, kind="stable")
    sorted_vert = entries_vert[order]
    counts = np.bincount(entries_vert, minlength=n)
    deg_max = int(counts.max()) if counts.size else 0
    table = np.full((n, max(deg_max, 1)), n_slots, dtype=np.int32)
    # position of each sorted entry within its vertex's run
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    within = np.arange(sorted_vert.size, dtype=np.int64) - \
        starts[sorted_vert]
    table[sorted_vert, within] = order.astype(np.int32)
    return table, deg_max


def edge_accumulator(src, dst, n, *, method: str = "scatter",
                     sides=("src", "dst"), pad_factor: float = 8.0):
    """Build ``acc(a_src, a_dst) -> (n, *trailing)`` summing per-edge
    contributions onto their incident vertices.

    ``a_src``/``a_dst`` are (E, ...) arrays of contributions accumulated at
    ``src[e]`` resp. ``dst[e]`` (pass ``None`` for a side excluded from
    ``sides``).  Signs/weights are the caller's job (fold them into the
    contributions).  ``src``/``dst`` must be concrete (construction runs
    host-side numpy); the returned closure is jit/vmap-safe in the
    contributions.

    ``method="gather"`` falls back to ``"sort"`` when the padded table
    would read more than ``pad_factor`` times the true entry count (hub
    vertices), so callers can request it unconditionally.
    """
    if method == "scatter":
        def acc_scatter(a_src, a_dst):
            ref = a_src if a_src is not None else a_dst
            out = jnp.zeros((n,) + ref.shape[1:], ref.dtype)
            if a_src is not None:
                out = out.at[jnp.asarray(src)].add(a_src)
            if a_dst is not None:
                out = out.at[jnp.asarray(dst)].add(a_dst)
            return out
        return acc_scatter

    src_np = np.asarray(src)
    dst_np = np.asarray(dst)
    parts = []
    if "src" in sides:
        parts.append(src_np)
    if "dst" in sides:
        parts.append(dst_np)
    entries_vert = (np.concatenate(parts) if parts
                    else np.zeros((0,), np.int64))
    n_slots = entries_vert.size
    n_sided = len(parts)

    if method == "gather":
        counts = np.bincount(entries_vert, minlength=n)
        deg_max = int(counts.max()) if counts.size else 0
        if n * max(deg_max, 1) > pad_factor * max(n_slots, 1):
            method = "sort"

    def _flat(a_src, a_dst):
        chunks = []
        if "src" in sides:
            chunks.append(a_src)
        if "dst" in sides:
            chunks.append(a_dst)
        assert len(chunks) == n_sided and all(c is not None for c in chunks)
        return chunks[0] if len(chunks) == 1 else jnp.concatenate(chunks, 0)

    if method == "gather":
        table, _ = _padded_table(entries_vert, n, n_slots)
        table = jnp.asarray(table)

        def acc_gather(a_src, a_dst):
            flat = _flat(a_src, a_dst)
            flat = jnp.concatenate(
                [flat, jnp.zeros((1,) + flat.shape[1:], flat.dtype)], 0)
            return jnp.sum(flat[table], axis=1)
        return acc_gather

    if method == "sort":
        order_np = np.argsort(entries_vert, kind="stable")
        verts_sorted = jnp.asarray(entries_vert[order_np].astype(np.int32))
        order = jnp.asarray(order_np.astype(np.int32))

        def acc_sort(a_src, a_dst):
            flat = _flat(a_src, a_dst)[order]
            return jax_ops.segment_sum(flat, verts_sorted, num_segments=n,
                                       indices_are_sorted=True)
        return acc_sort

    raise ValueError(f"edge_accumulator: unknown method {method!r} "
                     "(expected 'scatter', 'gather', or 'sort')")


def adjacency_tables(src, dst, n):
    """Host-precomputed padded neighbor tables for *adjacency-form* graph
    operators (the dense formulation: one neighbor gather + a slot-axis
    contraction, no scatter and no E-sized intermediate).

    Every edge e=(src,dst) yields two directed slots: one at vertex
    ``src[e]`` pointing at ``dst[e]`` and one at ``dst[e]`` pointing at
    ``src[e]``.  Returns ``(nb, eid, fwd, deg_max)``:

    - ``nb``  (n, deg_max) int32 — neighbor vertex id per slot (padding
      points at vertex ``n``: gather from an array extended by one zero
      row, or mask by ``eid < E``);
    - ``eid`` (n, deg_max) int32 — the originating edge id per slot
      (padding = E), for gathering per-edge weights/blocks;
    - ``fwd`` (n, deg_max) bool — True where the slot is the edge's
      forward direction (vertex == src), for direction-dependent blocks
      (e.g. the connection Laplacian's R vs R');
    - ``deg_max`` int.

    Self-loops produce two slots at the same vertex (their Laplacian
    contribution cancels exactly, matching the incidence form).
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    E = src.shape[0]
    vert = np.concatenate([src, dst])
    nbr = np.concatenate([dst, src])
    eid = np.concatenate([np.arange(E), np.arange(E)])
    fwd = np.concatenate([np.ones(E, bool), np.zeros(E, bool)])

    order = np.argsort(vert, kind="stable")
    vert, nbr, eid, fwd = vert[order], nbr[order], eid[order], fwd[order]
    counts = np.bincount(vert, minlength=n)
    deg_max = int(counts.max()) if counts.size else 0
    deg_max = max(deg_max, 1)

    nb_t = np.full((n, deg_max), n, dtype=np.int32)
    eid_t = np.full((n, deg_max), E, dtype=np.int32)
    fwd_t = np.zeros((n, deg_max), dtype=bool)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    within = np.arange(vert.size, dtype=np.int64) - starts[vert]
    nb_t[vert, within] = nbr.astype(np.int32)
    eid_t[vert, within] = eid.astype(np.int32)
    fwd_t[vert, within] = fwd
    return (jnp.asarray(nb_t), jnp.asarray(eid_t), jnp.asarray(fwd_t),
            deg_max)


def laplacian_apply(src, dst, tau, n, *, method: str = "scatter"):
    """Build ``L(z) -> (n, k)`` applying the weighted graph Laplacian
    L = A' diag(tau) A (A = edge incidence) to vertex fields.

    ``method`` in {"scatter", "gather", "sort"} routes the incidence
    adjoint through :func:`edge_accumulator`; ``"adjacency"`` uses the
    dense padded-neighbor form  L z = deg*z - sum_s w_s z[nb_s]  — one
    gather + one slot reduction, no scatter, no E-sized intermediate.
    """
    deg = (jnp.zeros((n,), tau.dtype)
           .at[jnp.asarray(src)].add(tau).at[jnp.asarray(dst)].add(tau))

    if method == "adjacency":
        nb, eid, _, _ = adjacency_tables(src, dst, n)
        w_slots = jnp.concatenate([tau, jnp.zeros((1,), tau.dtype)])[eid]

        def L_adj(z):
            z_ext = jnp.concatenate(
                [z, jnp.zeros((1,) + z.shape[1:], z.dtype)], 0)
            return deg[:, None] * z - jnp.sum(
                w_slots[:, :, None] * z_ext[nb], axis=1)
        return L_adj

    acc = edge_accumulator(src, dst, n, method=method)

    def L(z):
        dz = tau[:, None] * (z[jnp.asarray(dst)] - z[jnp.asarray(src)])
        return acc(-dz, dz)
    return L
