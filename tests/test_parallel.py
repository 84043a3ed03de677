"""Multi-device tests on the fake 8-device CPU mesh.

Mirrors the plan in SURVEY.md section 4 ("multi-node testing"): mesh-
parametrized tests asserting that sharded solves equal single-device solves
to tolerance, for each parallelism strategy of section 2.9:

- DP / scenario sharding: a vmapped TNT fleet sharded over "batch".
- TP-analog / block partitioning: one large problem with its variable sharded
  over "model"; GSPMD inserts the psum for every metric reduction.
- Consensus ADMM: per-shard x-updates + all-reduce averaging z-update.
- shard_map collectives: the explicit pdot/pmean primitives.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from optimization_tpu import RiemannianProblem
from optimization_tpu.core.types import ADMMStatus, TNTStatus
from optimization_tpu.manifolds import sphere
from optimization_tpu.parallel import (batch_mesh, collectives, consensus,
                                       make_mesh, model_mesh)
from optimization_tpu.parallel.sharding import shard_batch, shard_model_vector
from optimization_tpu.solvers import admm, tnt
from optimization_tpu.solvers.prox import soft_threshold

PARAMS = tnt.TNTParams(
    gradient_tolerance=1e-8, relative_decrease_tolerance=0.0,
    stepsize_tolerance=0.0, preconditioned_gradient_tolerance=0.0)


def f_sphere(x, data):
    d = x - data
    return jnp.sum(d * d)


def test_scenario_sharded_tnt_matches_single_device():
    """DP: 8 sphere instances sharded over an 8-device batch mesh."""
    mesh = batch_mesh(8)
    problem = RiemannianProblem(f=f_sphere, manifold=sphere())
    key = jax.random.PRNGKey(0)
    Ps = sphere().rand(key, 8, 3)
    x0s = jnp.tile(jnp.array([-0.5, -0.5, -0.707107]), (8, 1))

    solve1 = lambda x, p: tnt.solve(problem, x, PARAMS, data=p)
    ref = jax.vmap(solve1)(x0s, Ps)

    x0s_sh = shard_batch(x0s, mesh)
    Ps_sh = shard_batch(Ps, mesh)
    res = jax.jit(jax.vmap(solve1))(x0s_sh, Ps_sh)

    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               atol=1e-12)
    assert (np.asarray(res.status) == TNTStatus.GRADIENT).all()


def test_block_partitioned_tnt_matches_single_device():
    """TP-analog: Rayleigh quotient on S^{n-1} with x sharded over 'model'.

    The metric inner products and the diagonal Hv become per-shard work +
    psum, inserted by GSPMD from the NamedSharding annotation alone.
    """
    n = 1024
    d = jnp.linspace(1.0, 100.0, n)

    def f(x, data):
        return jnp.dot(x, data * x)

    problem = RiemannianProblem(f=f, manifold=sphere())
    x0 = sphere().rand(jax.random.PRNGKey(42), n)
    params = tnt.TNTParams(
        gradient_tolerance=1e-8, relative_decrease_tolerance=0.0,
        stepsize_tolerance=0.0, preconditioned_gradient_tolerance=0.0,
        max_iterations=500)

    ref = tnt.solve(problem, x0, params, data=d)

    mesh = model_mesh(8)
    x0_sh = shard_model_vector(x0, mesh)
    d_sh = shard_model_vector(d, mesh)
    res = tnt.solve(problem, x0_sh, params, data=d_sh)

    assert int(res.status) == TNTStatus.GRADIENT
    np.testing.assert_allclose(float(res.f), float(ref.f), atol=1e-10)
    np.testing.assert_allclose(np.abs(np.asarray(res.x)),
                               np.abs(np.asarray(ref.x)), atol=1e-6)


def test_consensus_admm_lasso():
    """Consensus ADMM: split a LASSO across 8 scenario shards; the solution
    matches the full-data FISTA objective."""
    rng = np.random.default_rng(21)
    N, mi, n = 8, 40, 64
    A = rng.normal(size=(N, mi, n))
    x_true = np.zeros(n)
    x_true[rng.integers(0, n, 8)] = rng.normal(size=8)
    b = A @ x_true + 0.01 * rng.normal(size=(N, mi))
    mu = 0.1

    A_j, b_j = jnp.asarray(A), jnp.asarray(b)

    def local_argmin(z, lam_i, rho, data_i):
        Ai, bi = data_i
        # argmin 0.5|A_i x - b_i|^2 + <lam_i, x> + rho/2 |x - z|^2
        H = Ai.T @ Ai + rho * jnp.eye(n)
        return jax.scipy.linalg.solve(
            H, Ai.T @ bi - lam_i + rho * z, assume_a="pos")

    prox_g = lambda v, lam, d: soft_threshold(v, mu * N * lam)

    problem = consensus.consensus_problem(local_argmin, prox_g=prox_g)
    # Residual balancing pushes rho up when the primal residual dominates,
    # which this splitting needs to hit the tight tolerances quickly.
    params = admm.ADMMParams(
        max_iterations=1000, eps_rel=1e-5, eps_abs_pri=1e-4,
        eps_abs_dual=1e-4, rho=1.0,
        penalty_adaptation_mode=admm.ADMMPenaltyAdaptation.RESIDUAL_BALANCE,
        penalty_adaptation_period=2, penalty_adaptation_window=200)

    mesh = batch_mesh(8)
    data = (shard_batch(A_j, mesh), shard_batch(b_j, mesh))
    res = admm.solve(problem, jnp.zeros((N, n)), jnp.zeros((N, n)),
                     jnp.zeros(n), params, data=data)
    assert int(res.status) == ADMMStatus.RESIDUAL_TOLERANCE

    # Compare with full-data FISTA on sum_i 0.5|A_i x - b_i|^2 + mu N |x|_1
    from optimization_tpu import CompositeProblem
    from optimization_tpu.solvers import proximal_gradient as pg
    Afull = A.reshape(N * mi, n)
    bfull = b.reshape(N * mi)
    fista = CompositeProblem(
        f=lambda x, dd: 0.5 * jnp.sum((jnp.asarray(Afull) @ x
                                       - jnp.asarray(bfull)) ** 2),
        g=lambda x, dd: mu * N * jnp.sum(jnp.abs(x)),
        prox_g=lambda x, lam, dd: soft_threshold(x, mu * N * lam))
    ref = pg.solve(fista, jnp.zeros(n), pg.ProximalGradientParams(
        max_iterations=50000, composite_gradient_tolerance=1e-8,
        relative_composite_gradient_tolerance=1e-10))
    obj = lambda x: (0.5 * float(jnp.sum((jnp.asarray(Afull) @ x
                                          - jnp.asarray(bfull)) ** 2))
                     + mu * N * float(jnp.sum(jnp.abs(x))))
    assert obj(res.y) <= obj(ref.x) * 1.02 + 1e-8


def test_shard_map_collectives():
    mesh = make_mesh((8,), ("model",))
    u = jnp.arange(32.0)
    v = jnp.ones(32)

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=P("model"), out_specs=P())
    def distributed_dot(a, b):
        return collectives.pdot(a, b, "model")

    np.testing.assert_allclose(float(distributed_dot(u, v)),
                               float(jnp.dot(u, v)))

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=P("model"), out_specs=P("model"))
    def consensus_avg(a):
        return jnp.broadcast_to(collectives.pmean_tree(jnp.mean(a), "model"),
                                a.shape)

    out = consensus_avg(u)
    np.testing.assert_allclose(np.asarray(out), np.full(32, float(u.mean())))


def test_sharded_basis_lobpcg_matches_single_device():
    """SP-analog (SURVEY.md 2.9): LOBPCG with the basis row-sharded over the
    "model" axis.  Under jit + NamedSharding the Gram GEMMs lower to
    per-shard partials + psum; results must match the unsharded
    solve to tolerance."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from optimization_tpu.linalg.lobpcg import lobpcg
    from optimization_tpu.parallel import make_mesh

    m, nx, nev = 4096, 8, 4
    d = jnp.linspace(1.0, 400.0, m)
    X0 = jax.random.normal(jax.random.PRNGKey(7), (m, nx))

    def solve(dd, X):
        res = lobpcg(lambda S: dd[:, None] * S,
                     T=lambda S: S / dd[:, None], X0=X, nev=nev,
                     max_iterations=150, tau=1e-8)
        return res.theta, res.num_converged

    theta_ref, nc_ref = jax.jit(solve)(d, X0)

    mesh = make_mesh((8,), ("model",))
    d_sh = jax.device_put(d, NamedSharding(mesh, P("model")))
    X_sh = jax.device_put(X0, NamedSharding(mesh, P("model", None)))
    theta_sh, nc_sh = jax.jit(solve)(d_sh, X_sh)

    assert int(nc_sh) == int(nc_ref) == nev
    np.testing.assert_allclose(np.asarray(theta_sh), np.asarray(theta_ref),
                               rtol=1e-8, atol=1e-8)


def test_sharded_gram_collectives():
    """sharded_gram / sharded_gram_pair inside shard_map equal the dense
    Gram computed on one device."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from functools import partial
    from jax.sharding import NamedSharding, PartitionSpec as P

    from optimization_tpu.parallel import make_mesh
    from optimization_tpu.parallel.collectives import (sharded_gram,
                                                       sharded_gram_pair)

    m, k = 1024, 6
    key1, key2, key3 = jax.random.split(jax.random.PRNGKey(0), 3)
    S = jax.random.normal(key1, (m, k))
    AS = jax.random.normal(key2, (m, k))
    BS = jax.random.normal(key3, (m, k))

    mesh = make_mesh((8,), ("model",))
    shard_map = jax.shard_map

    gram = shard_map(
        partial(sharded_gram, axis="model"), mesh=mesh,
        in_specs=(P("model", None), P("model", None)),
        out_specs=P(None, None))
    np.testing.assert_allclose(np.asarray(gram(S, AS)),
                               np.asarray(S.T @ AS), rtol=1e-10)

    pair = shard_map(
        partial(sharded_gram_pair, axis="model"), mesh=mesh,
        in_specs=(P("model", None),) * 3,
        out_specs=(P(None, None), P(None, None)))
    ga, gb = pair(S, AS, BS)
    np.testing.assert_allclose(np.asarray(ga), np.asarray(S.T @ AS),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(gb), np.asarray(S.T @ BS),
                               rtol=1e-10)


def test_ring_gram_matches_dense():
    """ring_gram (column-blocked basis, ppermute ring) inside shard_map
    equals the dense Gram — the tested completeness of the SURVEY section
    2.9 ring design row.  The production Gram path stays
    :func:`sharded_gram` (row-sharded, one psum): the ring moves ~m*nx
    words/device per Gram vs the psum's ~nx^2, and column-blocking buys no
    memory headroom over row-sharding — adjudication in the ring_gram
    docstring."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from functools import partial
    from jax.sharding import PartitionSpec as P

    from optimization_tpu.parallel import make_mesh
    from optimization_tpu.parallel.collectives import ring_gram

    m, nx = 256, 16          # 8 devices x 2-column blocks
    key1, key2 = jax.random.split(jax.random.PRNGKey(3))
    S = jax.random.normal(key1, (m, nx))
    AS = jax.random.normal(key2, (m, nx))

    mesh = make_mesh((8,), ("model",))
    gram = jax.shard_map(
        partial(ring_gram, axis="model"), mesh=mesh,
        in_specs=(P(None, "model"), P(None, "model")),
        out_specs=P(None, "model"))   # column blocks reassemble the Gram
    np.testing.assert_allclose(np.asarray(jax.jit(gram)(S, AS)),
                               np.asarray(S.T @ AS), rtol=1e-10)


def test_consensus_scenario_count_guard():
    """consensus_problem: an explicit n_scenarios overrides leaf inference,
    and a stacked block whose leading axis disagrees with the scenario count
    is rejected instead of silently broadcasting (round-2 hardening; the
    operator contract is reference ``ADMM.h:265-279``)."""
    local_argmin = lambda z, lam_i, rho, data_i: z - lam_i / rho

    problem = consensus.consensus_problem(local_argmin, n_scenarios=4)
    z = jnp.zeros(3)
    lam = jnp.zeros((4, 3))
    data = jnp.zeros((4, 2))
    x = problem.minLx(z, lam, 1.0, data)
    assert x.shape == (4, 3)

    # A stacked block that disagrees with the scenario count is rejected.
    with pytest.raises(ValueError, match="leading axis 5"):
        problem.minLy(jnp.zeros((5, 3)), jnp.zeros((5, 3)), 1.0, data)

    # Inference path: first-leaf leading axis rules; a lam built for a
    # different count is caught instead of silently broadcast.
    inferred = consensus.consensus_problem(local_argmin)
    with pytest.raises(ValueError, match="scenario count is 7"):
        inferred.minLx(z, jnp.zeros((4, 3)), 1.0, jnp.zeros((7, 2)))

    # No data leaves at all: explicit count required.
    with pytest.raises(ValueError, match="n_scenarios"):
        inferred.minLx(z, lam, 1.0, None)


def test_dp_sharded_lobpcg_fleet_matches_single_device():
    """DP x fleet: the vmapped LOBPCG fleet sharded over the 8-device batch
    mesh must reproduce the single-device fleet exactly (no cross-instance
    communication exists, so GSPMD partitions the whole lockstep iteration
    per-shard).  This is the scaling story for certification / spectral-init
    sweeps: fleets batch on-chip (config10) AND shard across chips."""
    from optimization_tpu.linalg.lobpcg import lobpcg_fleet

    mesh = batch_mesh(8)
    fleet, m, nx, nev = 8, 600, 8, 3
    ds = (jnp.arange(1.0, fleet + 1.0)[:, None]
          * jnp.linspace(1.0, 60.0, m)[None, :])

    def run(data):
        return lobpcg_fleet(lambda S, d: d[:, None] * S, data,
                            T=lambda S, d: S / d[:, None],
                            m=m, nx=nx, nev=nev, max_iterations=60,
                            tau=1e-8, key=jax.random.PRNGKey(3))

    ref = jax.jit(run)(ds)
    ds_sh = shard_batch(ds, mesh)
    res = jax.jit(run)(ds_sh)
    assert bool(jnp.all(res.num_converged >= nev))
    np.testing.assert_allclose(np.asarray(res.theta), np.asarray(ref.theta),
                               rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(res.X), np.asarray(ref.X),
                               rtol=0, atol=0)


def test_sharded_collectives_deterministic():
    """Sanitizer-analog CI, determinism leg (SURVEY.md section 5): repeated
    executions of the sharded collective reductions must be BITWISE
    identical — XLA's all-reduce order on a fixed mesh is deterministic,
    and solver-level reproducibility (the parity tests above) rests on it.
    Runs under OPTTPU_DEBUG_NANS too (no NaN carriers here)."""
    from jax import shard_map

    mesh = model_mesh(8)
    n = 4096
    v = jax.random.normal(jax.random.PRNGKey(7), (n,))
    w = jax.random.normal(jax.random.PRNGKey(8), (n,))
    v_sh = shard_model_vector(v, mesh)
    w_sh = shard_model_vector(w, mesh)

    dot = jax.jit(shard_map(
        lambda a, b: collectives.pdot(a, b, "model"),
        mesh=mesh, in_specs=(P("model"), P("model")), out_specs=P()))
    outs = {float(dot(v_sh, w_sh)) for _ in range(5)}
    assert len(outs) == 1, f"nondeterministic sharded pdot: {outs}"

    nrm = jax.jit(shard_map(
        lambda a: collectives.pnorm(a, "model"),
        mesh=mesh, in_specs=(P("model"),), out_specs=P()))
    outs = {float(nrm(v_sh)) for _ in range(5)}
    assert len(outs) == 1, f"nondeterministic sharded pnorm: {outs}"


def test_sharded_tnt_deterministic():
    """Determinism leg at the solver level: the block-partitioned TNT solve
    (every metric reduction a GSPMD-inserted psum) repeated on the same
    sharded inputs must return bitwise-identical iterates and traces."""
    n = 1024
    d = jnp.linspace(1.0, 100.0, n)

    def f(x, data):
        return jnp.dot(x, data * x)

    problem = RiemannianProblem(f=f, manifold=sphere())
    params = tnt.TNTParams(
        gradient_tolerance=1e-8, relative_decrease_tolerance=0.0,
        stepsize_tolerance=0.0, preconditioned_gradient_tolerance=0.0,
        max_iterations=200)
    mesh = model_mesh(8)
    x0_sh = shard_model_vector(sphere().rand(jax.random.PRNGKey(42), n), mesh)
    d_sh = shard_model_vector(d, mesh)

    r1 = tnt.solve(problem, x0_sh, params, data=d_sh)
    r2 = tnt.solve(problem, x0_sh, params, data=d_sh)
    np.testing.assert_array_equal(np.asarray(r1.x), np.asarray(r2.x))
    np.testing.assert_array_equal(np.asarray(r1.f), np.asarray(r2.f))
    # traces too (NaN pads compare equal under array_equal)
    np.testing.assert_array_equal(np.asarray(r1.objective_values),
                                  np.asarray(r2.objective_values))
    np.testing.assert_array_equal(np.asarray(r1.gradient_norms),
                                  np.asarray(r2.gradient_norms))
