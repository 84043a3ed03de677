"""Weak-scaling harness: DP scenario-sharded TNT fleet across mesh sizes.

Measures aggregate solver throughput (TNT outer iterations/s across the
fleet) as the mesh grows with the workload (fixed instances *per device*),
and reports weak-scaling efficiency vs the 1-device run (north-star target
>= 0.85).  On several GPUs this exercises their interconnect; on a
single-device or CPU host it runs over virtual devices (methodology check
— true scaling numbers require real devices).

Usage:  python benchmarks/scaling.py [--devices 8]
        JAX_PLATFORMS=cpu python benchmarks/scaling.py --fake-cpu
Prints ONE JSON line with the efficiency at the largest mesh.
"""

import argparse
import time

import jax

from _util import emit


def run_fleet(mesh, per_device, n, noise=0.05):
    import jax.numpy as jnp

    from optimization_tpu.models import rotation_sync as rs
    from optimization_tpu.parallel.sharding import shard_batch
    from optimization_tpu.solvers import tnt

    B = per_device * mesh.devices.size
    # One shared edge topology, per-instance rotations/noise (vmappable);
    # throughput scaling only, so random inits are fine here.
    _, data = rs.random_fleet(jax.random.PRNGKey(0), B, n, 3,
                              extra_edges=2 * n, noise=noise)
    src, dst, Rijs = data.src, data.dst, data.Rij
    R0 = jax.vmap(lambda k: rs.ROTATIONS.rand(k, n, 3, 3))(
        jax.random.split(jax.random.PRNGKey(1), B)).astype(jnp.float32)

    problem = rs.make_problem()
    params = tnt.TNTParams(
        max_iterations=15, max_TPCG_iterations=25, gradient_tolerance=0.0,
        relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
        preconditioned_gradient_tolerance=0.0)

    def one(R0_i, Rij_i):
        d_i = rs.RotationSyncData(src=src, dst=dst, Rij=Rij_i)
        r = tnt.solve(problem, R0_i, params, data=d_i)
        return r.num_iterations, r.f

    R0 = shard_batch(R0, mesh)
    Rijs = shard_batch(Rijs, mesh)
    fleet = jax.jit(jax.vmap(one))
    iters, f = fleet(R0, Rijs)            # compile + warm
    jax.block_until_ready(f)
    t0 = time.perf_counter()
    iters, f = fleet(R0, Rijs)
    jax.block_until_ready(f)
    dt = time.perf_counter() - t0
    total = int(jax.numpy.sum(iters))
    return total / dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--fake-cpu", action="store_true",
                    help="split the CPU into --devices virtual devices "
                         "(methodology check; run with JAX_PLATFORMS=cpu)")
    ap.add_argument("--per-device", type=int, default=4)
    ap.add_argument("--n", type=int, default=48,
                    help="rotations per instance")
    args = ap.parse_args()

    # NB: the CPU device count must be set before anything initializes the
    # backend (len(jax.devices()) counts as initialization).
    if args.fake_cpu:
        jax.config.update("jax_num_cpu_devices", args.devices or 8)
    n_dev = args.devices or len(jax.devices())

    from optimization_tpu.parallel import make_mesh

    sizes = [1]
    while sizes[-1] * 2 <= n_dev:
        sizes.append(sizes[-1] * 2)

    rates = {}
    for s in sizes:
        mesh = make_mesh((s,), ("batch",))
        rates[s] = run_fleet(mesh, args.per_device, args.n)
        print(f"# {s} device(s): {rates[s]:.1f} agg TNT it/s "
              f"({rates[s] / s:.1f} per device)", flush=True)

    largest = sizes[-1]
    eff = (rates[largest] / largest) / rates[1]
    emit("tnt_fleet_weak_scaling_efficiency", eff,
         f"per-device it/s at {largest} devices / 1 device "
         f"({rates[largest]:.1f} vs {rates[1]:.1f} it/s, "
         f"{args.per_device} instances/device, n={args.n} rotations; "
         f"virtual-CPU methodology run unless on a real multi-chip slice)",
         eff / 0.85)


if __name__ == "__main__":
    main()
