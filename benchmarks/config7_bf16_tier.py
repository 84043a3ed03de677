"""Config 7: bf16-storage / f32-accumulate TNT at n = 2^26.

The single-chip scale tier (SURVEY.md section 7.3 double-precision risk):
at n = 2^26 the CG working set in f32 (x, g + s/r/v/p + operator scratch)
is several GB; storing all iterate vectors in bf16 halves the memory
footprint *and* the per-iteration memory traffic, while every reduction
(metric inner products, CG recurrences, trust-region scalars) accumulates
in f32 — the sphere manifold promotes sub-f32 storage for accumulation and
``stpcg`` casts its axpy updates back to the storage dtype.

Metric: TNT outer iterations/s at n=2^26 in bf16 storage, with the
trust-region subproblem in the generic ``stpcg`` engine on the
``quadratic_model`` Hv.  vs_baseline = convergence parity: 1.0 when the
Rayleigh quotient reaches the documented bf16 floor (f* = 1 + O(1e-2))
with a unit-norm final iterate.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np

from _util import emit

from optimization_tpu import RiemannianProblem
from optimization_tpu.manifolds import sphere
from optimization_tpu.solvers import tnt


def main():
    n = 1 << 26
    dtype = jnp.bfloat16
    M = sphere()
    b = 999.0 / (n - 1)

    def A_op(v):
        # affine diagonal 1..1000 generated on the fly (f32 accumulate)
        i = jax.lax.iota(jnp.float32, n)
        return (1.0 + b * i) * v.astype(jnp.float32)

    def f(x, dd):
        return jnp.dot(x.astype(jnp.float32), A_op(x))

    def grad(x, dd):
        return M.proj(x, (2.0 * A_op(x)).astype(dtype))

    def quadratic_model(x, dd):
        g = grad(x, None)
        rq = jnp.dot(x.astype(jnp.float32), 2.0 * A_op(x))

        def hvp(v):
            t = (2.0 * A_op(v)).astype(dtype)
            return (M.proj(x, t).astype(jnp.float32)
                    - rq * v.astype(jnp.float32)).astype(dtype)

        return g, hvp

    problem = RiemannianProblem(f=f, manifold=M, grad=grad,
                                quadratic_model=quadratic_model)
    x0 = M.rand(jax.random.PRNGKey(2), n).astype(dtype)
    params = tnt.TNTParams(
        max_iterations=30, max_TPCG_iterations=50,
        gradient_tolerance=0.5, relative_decrease_tolerance=0.0,
        stepsize_tolerance=0.0, preconditioned_gradient_tolerance=0.0)

    jax.block_until_ready(tnt.solve(problem, x0, params, data=None))
    t0 = time.perf_counter()
    res = jax.block_until_ready(tnt.solve(problem, x0, params, data=None))
    dt = time.perf_counter() - t0

    outer = int(res.num_iterations)
    inner = int(np.nansum(np.where(np.arange(params.max_iterations) < outer,
                                   np.asarray(res.inner_iterations), 0)))
    fstar = float(res.f)
    nrm = float(jnp.linalg.norm(res.x.astype(jnp.float32)))
    ok = (res.x.dtype == dtype and abs(nrm - 1.0) < 0.01
          and abs(fstar - 1.0) < 0.05)
    emit("tnt_bf16_2p26_iters_per_s", outer / dt if dt > 0 else 0.0,
         f"TNT outer it/s at n=2^26, bf16 storage / f32 accumulate "
         f"({outer} outer / {inner} cg in {dt:.2f}s; f*={fstar:.4f} "
         f"vs 1.0 exact, |x|={nrm:.4f}, dtype={res.x.dtype})",
         1.0 if ok else 0.0)


if __name__ == "__main__":
    main()
