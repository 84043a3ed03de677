"""Child process for the localhost two-process multihost smoke test.

Launched by tests/test_multihost.py::test_localhost_two_process_psum as

    python tests/_multihost_child.py <coordinator> <num_procs> <proc_id>

Each process pins the CPU backend (by dynamic config, as
tests/conftest.py does), wires up
``jax.distributed`` over 127.0.0.1, and runs one cross-process ``psum``
plus a global-mesh sharded reduction.  Prints ``OK <total> <gsum>`` on
success; any exception exits nonzero with a traceback on stderr.

This gives the ``parallel/mesh.py`` ``initialize_distributed`` wiring CI
coverage without a cluster; the real multi-host variant
remains the env-gated test above it.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    coord, num_procs, proc_id = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)

    from optimization_tpu.parallel import initialize_distributed

    initialize_distributed(coordinator_address=coord,
                           num_processes=num_procs,
                           process_id=proc_id,
                           initialization_timeout=60)

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from optimization_tpu.parallel import make_mesh

    n_dev = len(jax.devices())
    n_local = jax.local_device_count()
    assert n_dev == num_procs * n_local, (n_dev, num_procs, n_local)

    # Global-mesh sharded reduction: each process contributes its local
    # shard; jnp.sum over the sharded array becomes a cross-process psum.
    mesh = make_mesh((n_dev,), ("model",))
    per = 8
    sharding = NamedSharding(mesh, P("model"))
    x = jax.make_array_from_callback(
        (n_dev * per,), sharding,
        lambda idx: jnp.arange(n_dev * per, dtype=jnp.float32)[idx])
    total = float(jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))(x))
    expect = n_dev * per * (n_dev * per - 1) / 2.0
    assert total == expect, (total, expect)

    # Explicit collective: psum over the mesh axis via shard_map.
    from jax.experimental.shard_map import shard_map

    y = jax.make_array_from_callback(
        (n_dev,), sharding,
        lambda idx: (jnp.arange(n_dev, dtype=jnp.float32) + 1.0)[idx])
    gsum = shard_map(lambda v: jax.lax.psum(v, "model"),
                     mesh=mesh, in_specs=P("model"), out_specs=P("model"))(y)
    gval = float(jax.jit(lambda a: a[0])(gsum))
    expect_g = n_dev * (n_dev + 1) / 2.0
    assert gval == expect_g, (gval, expect_g)

    print(f"OK {total} {gval}", flush=True)


if __name__ == "__main__":
    main()
