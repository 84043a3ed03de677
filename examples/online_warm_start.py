"""Online re-solving with warm starts: a growing rotation-sync problem.

The deployment story: a SLAM / mapping session keeps appending relative
measurements to its graph.  Re-solving each snapshot from a cold spectral
initialization wastes the fact that the previous optimum is (nearly) a
critical point of the grown problem; warm-starting TNT from it converges
in a handful of outer iterations, and the SE-Sync certificate
(``rotation_sync.certify``) confirms each snapshot is still the *global*
optimum — turning an online estimator into a certifiably-correct one.

Mechanics this exercises (all public seams):

- fixed edge capacity + a weight mask: the jitted solve has ONE static
  shape, so growing the graph never recompiles (``kappa`` zeroes the
  not-yet-seen edges — the same masking discipline the solvers use
  internally for static-shape iteration);
- ``tnt.solve(problem, x0=previous_R, ...)`` — warm start is just the
  initial iterate (reference contract: ``TNT.h:704-736`` takes x0);
- ``certify(..., rr_method="chol", precondition=True)`` — the cheap
  certificate configuration.

Run:  python examples/online_warm_start.py   (f32; JAX_ENABLE_X64=1 for f64)
"""

from _common import setup

setup()

import jax
import jax.numpy as jnp

from optimization_tpu.models import rotation_sync as rs
from optimization_tpu.solvers import tnt


def main():
    n, d = 40, 3
    dtype = (jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    key = jax.random.PRNGKey(0)

    # Full measurement set, revealed in chunks: a spanning chain first
    # (keeps every snapshot connected), then batches of loop closures.
    _, data_full = rs.random_instance(key, n, d, extra_edges=3 * n,
                                      noise=0.03, dtype=dtype)
    E = int(data_full.src.shape[0])
    chunks = [n - 1] + [n] * ((E - (n - 1) + n - 1) // n)

    params_cold = tnt.TNTParams(
        max_iterations=100,
        gradient_tolerance=(1e-9 if dtype == jnp.float64 else 2e-3),
        relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
        preconditioned_gradient_tolerance=0.0)

    @jax.jit
    def solve_snapshot(mask, R0):
        data_t = rs.RotationSyncData(src=data_full.src, dst=data_full.dst,
                                     Rij=data_full.Rij,
                                     kappa=mask.astype(dtype))
        res = tnt.solve(rs.make_problem(), R0, params_cold, data=data_t)
        cert = rs.certify(res.x, data_t, rr_method="chol",
                          precondition=True)
        return res.x, res.f, res.num_iterations, cert.certified, cert.lam_min

    # One cold init, ever — from the FIRST snapshot only (no peeking at
    # future measurements).
    mask0 = (jnp.arange(E) < chunks[0]).astype(dtype)
    R = rs.spectral_init(
        rs.RotationSyncData(src=data_full.src, dst=data_full.dst,
                            Rij=data_full.Rij, kappa=mask0), n, d)
    shown = 0
    print(f"online rotation sync: n={n}, {E} total edges, "
          f"{len(chunks)} snapshots (one compile, static shapes)")
    for t, grow in enumerate(chunks):
        shown = min(E, shown + grow)
        mask = (jnp.arange(E) < shown)
        R, f, iters, certified, lam = solve_snapshot(mask, R)
        print(f"  t={t}: edges={shown:3d}  outer_iters={int(iters):3d}  "
              f"f*={float(f):9.4f}  certified={bool(certified)!s:5} "
              f"lam_min={float(lam):+.1e}")
        if not bool(certified):
            raise SystemExit("snapshot lost certified optimality")
    print("all snapshots certified globally optimal; warm-started "
          "re-solves converged in a handful of outer iterations")


if __name__ == "__main__":
    main()
