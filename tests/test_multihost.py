"""Optional real multi-host smoke tests (SURVEY.md section 4, plan (c)).

Gated behind RUN_MULTIHOST: these require a real multi-process JAX cluster
(e.g. one process per host of a GPU cluster).  Launch on every host:

    RUN_MULTIHOST=1 JAX_COORD=<host0>:8476 JAX_NUM_PROC=<N> JAX_PROC_ID=<i> \
        python -m pytest tests/test_multihost.py -q

The single-process CI path is covered by the fake 8-device CPU mesh tests in
test_parallel.py; this file only checks that the jax.distributed wiring and
the cross-host collectives function on real DCN.
"""

import os
import socket
import subprocess
import sys

import pytest

RUN = os.environ.get("RUN_MULTIHOST", "")

requires_cluster = pytest.mark.skipif(
    not RUN, reason="multi-host smoke tests need RUN_MULTIHOST=1 + a cluster")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_localhost_two_process_psum():
    """Two-process jax.distributed smoke on 127.0.0.1 (no pod needed).

    Spawns two fresh CPU-backend python processes that wire up
    ``initialize_distributed`` against a local coordinator and run a
    cross-process sharded reduction + an explicit shard_map psum
    (tests/_multihost_child.py).  Skips only if the runtime forbids
    spawning or the distributed service cannot bind; a numeric mismatch
    or wiring error in the children FAILS.
    """
    coord = f"127.0.0.1:{_free_port()}"
    child = os.path.join(os.path.dirname(__file__), "_multihost_child.py")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"  # belt-and-braces; child pins via config
    procs = []
    try:
        for pid in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, child, coord, "2", str(pid)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=env))
    except OSError as e:  # runtime forbids spawning
        pytest.skip(f"cannot spawn subprocesses: {e}")
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("localhost multihost children timed out (180 s)")
    for rc, out, err in outs:
        assert rc == 0, f"child failed (rc={rc}):\n{err[-2000:]}"
        # Gloo prints a connection banner before the child's OK line
        assert any(l.startswith("OK") for l in out.splitlines()), (
            out, err[-2000:])


@requires_cluster
def test_distributed_psum_and_sharded_tnt():
    import jax

    from optimization_tpu.parallel import initialize_distributed

    initialize_distributed(
        coordinator_address=os.environ["JAX_COORD"],
        num_processes=int(os.environ["JAX_NUM_PROC"]),
        process_id=int(os.environ["JAX_PROC_ID"]))

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from optimization_tpu import RiemannianProblem
    from optimization_tpu.manifolds import sphere
    from optimization_tpu.parallel import make_mesh
    from optimization_tpu.solvers import tnt

    n_dev = len(jax.devices())
    assert n_dev > jax.local_device_count(), "expected a multi-host device set"

    # Global psum across all hosts' devices
    mesh = make_mesh((n_dev,), ("model",))
    x = jnp.ones((n_dev * 8,))
    x = jax.device_put(x, NamedSharding(mesh, P("model")))
    total = jax.jit(jnp.sum)(x)
    assert float(total) == n_dev * 8

    # Block-partitioned TNT over the full pod slice
    dim = 128 * n_dev
    d = jnp.linspace(1.0, 100.0, dim)
    problem = RiemannianProblem(
        f=lambda x, dd: jnp.dot(x, dd * x), manifold=sphere())
    x0 = sphere().rand(jax.random.PRNGKey(0), dim)
    x0 = jax.device_put(x0, NamedSharding(mesh, P("model")))
    d_sh = jax.device_put(d, NamedSharding(mesh, P("model")))
    res = tnt.solve(problem, x0,
                    tnt.TNTParams(gradient_tolerance=1e-4,
                                  relative_decrease_tolerance=0.0,
                                  stepsize_tolerance=0.0,
                                  preconditioned_gradient_tolerance=0.0),
                    data=d_sh)
    np.testing.assert_allclose(float(res.f), 1.0, atol=1e-2)
