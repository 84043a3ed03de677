"""Fleet certification: solve + globally certify MANY rotation-sync
instances in lockstep on one chip.

The user story: a mapping / SfM pipeline produces a stream of rotation
synchronization problems over the SAME measurement topology (e.g. one
session per day over a fixed camera rig).  Single-instance solves at these
sizes are dispatch/latency-bound on an accelerator, so the fleet path
batches the ENTIRE pipeline — spectral init, TNT trust-region solve, and
the SE-Sync global-optimality certificate — with one ``jax.vmap`` into
fused batched GEMMs (reference context: the certificate's LOBPCG plays
exactly the role ``LOBPCG.h`` plays in the reference ecosystem; the solver
stack is ``TNT.h`` + ``IterativeSolvers.h``).

Scaling story beyond one chip: the same vmapped fleet shards over a device
mesh's batch axis unchanged (tests/test_parallel.py::
test_dp_sharded_lobpcg_fleet_matches_single_device pins bitwise equality).

Run:  python examples/certification_fleet.py  (f32; JAX_ENABLE_X64=1 for f64)
"""

from _common import setup

setup()

import jax
import jax.numpy as jnp

from optimization_tpu.models import rotation_sync as rs
from optimization_tpu.solvers import tnt


def main():
    B, n, d = 8, 30, 3          # fleet of 8 instances, 30 rotations each
    dtype = (jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    key = jax.random.PRNGKey(0)

    R_trues, fleet = rs.random_fleet(key, B, n, d, extra_edges=2 * n,
                                     noise=0.03, dtype=dtype)
    params = tnt.TNTParams(
        max_iterations=100,
        gradient_tolerance=(1e-9 if dtype == jnp.float64 else 2e-3),
        relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
        preconditioned_gradient_tolerance=0.0)

    def one(Rij):
        data_i = rs.RotationSyncData(src=fleet.src, dst=fleet.dst, Rij=Rij)
        R0 = rs.spectral_init(data_i, n, d, rr_method="chol")
        res = tnt.solve(rs.make_problem(), R0, params, data=data_i)
        cert = rs.certify(res.x, data_i, rr_method="chol")
        return res.x, res.f, cert.certified, cert.lam_min, cert.stationarity

    Rs, fs, certified, lam, stat = jax.jit(jax.vmap(one))(fleet.Rij)

    print(f"fleet of {B} instances (n={n} rotations, d={d}):")
    for b in range(B):
        print(f"  [{b}] f* = {float(fs[b]):10.4f}   "
              f"certified = {bool(certified[b])!s:5}   "
              f"lam_min = {float(lam[b]):+9.2e}   "
              f"stationarity = {float(stat[b]):.1e}")
    n_cert = int(jnp.sum(certified))
    print(f"{n_cert}/{B} certified globally optimal")
    if n_cert != B:
        raise SystemExit("uncertified instance in a noise-floor fleet")


if __name__ == "__main__":
    main()
