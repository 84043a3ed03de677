"""Hardware probe: s-step flat-CG TNT throughput grid at n = 2^24.

Measures the headline config (config2: TNT Rayleigh-quotient on S^{n-1},
affine diagonal operator) across the s-step group size (1, 2, 3) and the
storage dtype (f32, bf16), printing CG iterations/s, the achieved f*, and
the implied effective memory bandwidth for each cell.  Used to pick the
headline settings for bench.py; run on the accelerator:

    python benchmarks/probe_sstep.py [n_log2]

Timing closes with ``jax.block_until_ready``.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from optimization_tpu import RiemannianProblem
from optimization_tpu.linalg.flat_cg import sphere_rayleigh_flat
from optimization_tpu.manifolds import sphere
from optimization_tpu.solvers import tnt


def build_problem(n, dtype):
    b = 999.0 / (n - 1)
    M = sphere()

    def A_elem(v):
        i = jax.lax.iota(jnp.float32, n)
        return (1.0 + b * i) * v.astype(jnp.float32)

    def f(x, dd):
        return jnp.dot(x.astype(jnp.float32), A_elem(x))

    def grad(x, dd):
        return M.proj(x, (2.0 * A_elem(x)).astype(dtype))

    def flat_qm(x, dd):
        A0, U, B, _ = sphere_rayleigh_flat(x, A_elem)
        return A0, U, B

    return RiemannianProblem(f=f, manifold=M, grad=grad, flat_qm=flat_qm), M


def run_cell(n, dtype, s_steps, grad_tol):
    problem, M = build_problem(n, dtype)
    params = tnt.TNTParams(
        max_iterations=30, max_TPCG_iterations=50,
        gradient_tolerance=grad_tol, relative_decrease_tolerance=0.0,
        stepsize_tolerance=0.0, preconditioned_gradient_tolerance=0.0,
        flat_s_steps=s_steps)
    x0 = M.rand(jax.random.PRNGKey(2), n).astype(dtype)
    jax.block_until_ready(tnt.solve(problem, x0, params, data=None))  # warm
    x1 = jax.block_until_ready(M.rand(jax.random.PRNGKey(3), n).astype(dtype))
    t0 = time.perf_counter()
    res = jax.block_until_ready(tnt.solve(problem, x1, params, data=None))
    dt = time.perf_counter() - t0
    fstar = float(res.f)
    outer = int(res.num_iterations)
    inner = int(np.nansum(np.where(np.arange(params.max_iterations) < outer,
                                   np.asarray(res.inner_iterations), 0)))
    cg_per_s = inner / dt if dt > 0 else 0.0
    wbytes = jnp.dtype(dtype).itemsize
    # s-step pass traffic: read r/p/s/x + write r/p/s = 7n words per group,
    # one group per s_steps CG iterations
    gbps = 7 * n * wbytes * (inner / max(s_steps, 1)) / dt / 1e9
    print(f"  dtype={jnp.dtype(dtype).name:9s} s={s_steps}  "
          f"{cg_per_s:7.1f} cg it/s  ({outer} outer / {inner} cg in "
          f"{dt:6.2f}s)  f*={fstar:.5f}  ~{gbps:.0f} GB/s pass traffic",
          flush=True)
    return cg_per_s, fstar


def main():
    n = 1 << (int(sys.argv[1]) if len(sys.argv) > 1 else 24)
    print(f"n = 2^{n.bit_length() - 1}, device = {jax.devices()[0].device_kind}",
          flush=True)
    cells = [(jnp.float32, 1e-5, 1), (jnp.bfloat16, 0.0, 1),
             (jnp.bfloat16, 0.5, 1)]
    if len(sys.argv) > 2 and sys.argv[2] == "grid":
        cells += [(dt, tol, s) for dt, tol in
                  ((jnp.float32, 1e-5), (jnp.bfloat16, 0.5))
                  for s in (2, 3)]
    for dtype, tol, s in cells:
        run_cell(n, dtype, s, tol)


if __name__ == "__main__":
    main()
