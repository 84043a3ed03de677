"""bf16 -> f32 dtype escalation (tnt.solve_escalated).

Run the fast bf16 storage tier until its own trust-region-collapse floor
detector fires, promote the carry to f32 (with the zero-tangent
re-retraction back onto the manifold), and finish to the reference's
|grad| tolerance (``TNT.h:122-125``) — reference termination semantics
at (mostly) the low tier's speed.  ``benchmarks/config12_escalation.py``
measures the speedup on the device (not measured on the H100 yet);
this example shows the user-facing API and the staged traces at a
CPU-friendly size.

Run: python examples/dtype_escalation.py   [JAX_PLATFORMS=cpu]
"""

import time

import jax
import jax.numpy as jnp

from _common import setup

# bf16 storage / f32 accumulate: x64 must stay OFF for the tier contract
setup(x64=False)

from optimization_tpu import RiemannianProblem  # noqa: E402
from optimization_tpu.linalg.flat_cg import (sphere_rayleigh_flat,  # noqa: E402
                                             sphere_rayleigh_step)
from optimization_tpu.manifolds import sphere  # noqa: E402
from optimization_tpu.solvers import tnt  # noqa: E402


def main():
    n = 1 << 16
    b = 999.0 / (n - 1)
    M = sphere()

    def A_elem(v):
        i = jax.lax.iota(jnp.float32, n)
        return (1.0 + b * i) * v.astype(jnp.float32)

    def f(x, dd):
        return jnp.dot(x.astype(jnp.float32), A_elem(x))

    def grad(x, dd):
        return M.proj(x, (2.0 * A_elem(x)).astype(x.dtype))

    def flat_qm(x, dd, aux=None):
        rq = aux.rq if aux is not None else None
        A0, U, B, _ = sphere_rayleigh_flat(x, A_elem, rq=rq)
        return A0, U, B, (aux.init if aux is not None else None)

    problem = RiemannianProblem(f=f, manifold=M, grad=grad, flat_qm=flat_qm,
                                step_eval=sphere_rayleigh_step(A_elem))
    params = tnt.TNTParams(
        max_iterations=200, max_TPCG_iterations=25,
        gradient_tolerance=2e-3, relative_decrease_tolerance=0.0,
        stepsize_tolerance=0.0, preconditioned_gradient_tolerance=0.0)

    x0 = M.rand(jax.random.PRNGKey(0), n)

    t0 = time.time()
    res = tnt.solve_escalated(problem, x0, params, data=None,
                              low_dtype=jnp.bfloat16,
                              high_dtype=jnp.float32)
    float(res.f)
    dt = time.time() - t0
    lo, hi = res.stage_low, res.stage_high
    print(f"escalated: {int(res.switch_iteration)} bf16 outer "
          f"(stage-1 status {int(lo.status)}: GRADIENT=1 means bf16 "
          f"already met the tolerance, TRUST_REGION=5 is the floor "
          f"detector) + "
          f"{int(hi.num_iterations)} f32 outer -> "
          f"f = {float(res.f):.6f}, |g| = {float(res.gradfx_norm):.2e} "
          f"(tol {params.gradient_tolerance}), status {int(res.status)} "
          f"[{dt:.1f}s incl. both compiles]")
    # the bf16 stage did the bulk of the march; f32 only finishes
    print(f"  stage objectives: bf16 {float(lo.f):.6f} -> "
          f"f32 {float(hi.f):.6f} (exact smallest eigenvalue 1.0)")
    assert float(res.gradfx_norm) <= params.gradient_tolerance


if __name__ == "__main__":
    main()
