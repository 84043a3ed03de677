"""Edge->vertex accumulation A/B at config6 scale.

config6's marginalized SE-Sync pipeline is gather/scatter bound: every
inner-CG iteration (nested Laplacian solve) and every Hv applies
``out.at[idx].add()`` scatters over E ~ 3e4 edges.  XLA may lower
duplicate-index scatter conservatively (serialized, or with atomics on a
GPU), so this probe measures the
three strategies of ``models/graph.edge_accumulator`` on the REAL hot
chains:

  1. the bare weighted-Laplacian apply L(z), chained K times;
  2. the full nested Jacobi-PCG Laplacian solve (what every projection
     in the marginalized operator pays), chained;
  3. the full marginalized Hv (Q_op apply: connection Laplacian + B ops +
     nested solve), chained.

Graph = config6's synthetic 10^4-pose / ~3x10^4-edge instance (odometry
chain + random loop closures; max degree printed).  f32, k = d = 3.

Decision rule: flip config6 / solve_pose_graph defaults only if a
non-scatter method wins the Q_op chain by >=1.15x.
"""

import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp
import numpy as np

from optimization_tpu.models import pose_sync as ps
from optimization_tpu.models.graph import laplacian_apply

N = 10_000
EXTRA = 20_000
K_APPLY = 200     # chained L applies
K_SOLVE = 8       # chained nested PCG solves
K_HV = 8          # chained Q_op applies
REPS = 3
DT = jnp.float32


def timeit(fn, *args):
    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best


def graph():
    rng = np.random.default_rng(0)
    src = np.concatenate([np.arange(N - 1), rng.integers(0, N, EXTRA)])
    dst = np.concatenate([np.arange(1, N), rng.integers(0, N, EXTRA)])
    keep = src != dst
    return src[keep].astype(np.int32), dst[keep].astype(np.int32)


def main():
    print("backend:", jax.default_backend(), flush=True)
    src, dst = graph()
    E = src.shape[0]
    deg = np.bincount(np.concatenate([src, dst]), minlength=N)
    print(f"n={N} E={E} mean_deg={deg.mean():.1f} max_deg={deg.max()}",
          flush=True)
    rng = np.random.default_rng(1)
    tau = jnp.asarray(rng.uniform(0.5, 2.0, E), DT)
    k = 3
    r0 = jnp.asarray(rng.standard_normal((N, k)), DT)
    r0 = r0 - jnp.mean(r0, axis=0, keepdims=True)   # consistent rhs

    d = 3

    def rand_rot(_):
        q, _r = np.linalg.qr(rng.standard_normal((d, d)))
        return q * np.sign(np.linalg.det(q))

    Mij = jnp.asarray(np.stack([rand_rot(e) for e in range(E)]), DT)
    tij = jnp.asarray(rng.standard_normal((E, d)), DT)
    X0 = jnp.asarray(rng.standard_normal((N * d, d)), DT)

    for method in ("scatter", "gather", "sort", "adjacency"):
        L = laplacian_apply(src, dst, tau, N, method=method)

        @jax.jit
        def chain_apply(z, L=L):
            def body(i, z):
                out = L(z)
                return out / (1.0 + jnp.max(jnp.abs(out)))
            return jax.lax.fori_loop(0, K_APPLY, body, z)

        dt = timeit(chain_apply, r0)
        print(f"[{method:7s}] L apply      {dt / K_APPLY * 1e6:9.1f} "
              f"us/apply", flush=True)

        solve = ps._weighted_laplacian_solver(src, dst, tau, N,
                                              scatter_method=method)

        @jax.jit
        def chain_solve(r):
            def body(i, r):
                z = solve(r)
                return r + 1e-6 * z
            return jax.lax.fori_loop(0, K_SOLVE, body, r)

        dt = timeit(chain_solve, r0)
        print(f"[{method:7s}] nested PCG   {dt / K_SOLVE * 1e3:9.2f} "
              f"ms/solve", flush=True)

        _, Q_op, _ = ps.marginalized_problem(src, dst, Mij, tij, n=N,
                                             scatter_method=method)

        @jax.jit
        def chain_hv(X):
            def body(i, X):
                Y = Q_op(X)
                return Y / (1.0 + jnp.max(jnp.abs(Y)))
            return jax.lax.fori_loop(0, K_HV, body, X)

        dt = timeit(chain_hv, X0)
        print(f"[{method:7s}] Q_op (Hv)    {dt / K_HV * 1e3:9.2f} "
              f"ms/apply", flush=True)


if __name__ == "__main__":
    main()
