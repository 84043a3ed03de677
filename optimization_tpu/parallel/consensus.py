"""Global-consensus ADMM over scenario shards.

Solves   min_x  sum_i f_i(x) + g(x)   by the consensus splitting

    min  sum_i f_i(x_i) + g(z)   s.t.  x_i - z = 0  for all i

mapped onto the generic :mod:`optimization_tpu.solvers.admm` engine with
VariableX = the stacked per-scenario block (N, ...), VariableY = the global
consensus variable z, A = identity, B = -broadcast, c = 0 (the seam described
at reference ``ADMM.h:378-402``, distributed per SURVEY.md section 2.9).

The stacked x-block is sharded over the mesh "batch" axis; the z-update is a
mean over scenarios, which the GSPMD partitioner lowers to an all-reduce —
the only cross-device communication per iteration.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from ..solvers.admm import ADMMProblem

__all__ = ["consensus_problem"]


def consensus_problem(
    local_argmin: Callable[..., Any],
    prox_g: Optional[Callable[..., Any]] = None,
    n_scenarios: Optional[int] = None,
) -> ADMMProblem:
    """Build the consensus-form ADMMProblem.

    - ``local_argmin(z, lam_i, rho, data_i) -> x_i``: per-scenario minimizer
      of  f_i(x) + <lam_i, x> + (rho/2) |x - z|^2  (vmapped over the leading
      scenario axis of lam/data).
    - ``prox_g(v, lam, data) -> z``: optional prox of the shared regularizer g
      (g = 0, i.e. plain averaging, when omitted).
    - ``n_scenarios``: the scenario count N.  When omitted it is inferred
      from the leading axis of the first leaf of ``data`` — which is only
      correct when *every* data leaf is batched over scenarios.  Pass it
      explicitly for data trees that mix batched and shared (unbatched)
      leaves; the vmapped x-update would otherwise silently broadcast wrong.

    Use with ``admm.solve(problem, c=0-block, x0=(N, ...) zeros, y0=z0,
    data=per_scenario_data)``.
    """

    def n_of(data, z=None):
        if n_scenarios is not None:
            return n_scenarios
        leaves = jax.tree_util.tree_leaves(data)
        if not leaves:
            raise ValueError(
                "consensus_problem: pass n_scenarios explicitly when data "
                "has no array leaves to infer the scenario count from")
        return leaves[0].shape[0]

    def check(x, data):
        n = n_of(data)
        if x.shape[0] != n:
            raise ValueError(
                f"consensus_problem: stacked block has leading axis "
                f"{x.shape[0]} but the scenario count is {n} "
                f"(inferred from data; pass n_scenarios= if the data tree "
                f"mixes batched and shared leaves)")
        return n

    def minLx(z, lam, rho, data):
        check(lam, data)
        return jax.vmap(
            lambda lam_i, data_i: local_argmin(z, lam_i, rho, data_i)
        )(lam, data)

    def minLy(x, lam, rho, data):
        n = check(x, data)
        v = jnp.mean(x + lam / rho, axis=0)
        if prox_g is None:
            return v
        # z-update: prox of g with weight 1/(N rho) (Boyd Sec. 7.1)
        return prox_g(v, 1.0 / (n * rho), data)

    return ADMMProblem(
        minLx=minLx,
        minLy=minLy,
        A=lambda x, d: x,
        B=lambda z, d: -jnp.broadcast_to(z, (n_of(d),) + tuple(z.shape)),
        At=lambda r, d: r,
    )
