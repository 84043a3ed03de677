"""SE(d) pose synchronization: g2o-convention rotations + LSQR translations.

End-to-end SE-Sync pipeline over synthetic pose graphs written in the real
g2o convention (M_e = R_i' R_j, t_e = R_i'(t_j - t_i)), including the
round-trip through the g2o file loader.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from optimization_tpu.io.g2o import PoseGraph
from optimization_tpu.models import pose_sync, rotation_sync as rs


N, D = 20, 3


def _make_pose_graph(seed, noise_rot=0.0, noise_t=0.0):
    """Synthetic SE(3) pose graph with g2o measurement conventions."""
    key = jax.random.PRNGKey(seed)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    R_true = rs.ROTATIONS.rand(k1, N, D, D).astype(jnp.float64)
    t_true = jax.random.normal(k2, (N, D), jnp.float64)

    src = jnp.arange(N - 1, dtype=jnp.int32)
    dst = src + 1
    extra = 2 * N
    src = jnp.concatenate(
        [src, jax.random.randint(k3, (extra,), 0, N, jnp.int32)])
    dst = jnp.concatenate(
        [dst, jax.random.randint(k4, (extra,), 0, N, jnp.int32)])

    Rt = jnp.swapaxes(R_true, -1, -2)
    Mij = jnp.einsum("eij,ejk->eik", Rt[src], R_true[dst])
    tij = jnp.einsum("eij,ej->ei", Rt[src], t_true[dst] - t_true[src])
    if noise_rot:
        w = noise_rot * jax.random.normal(k3, (src.shape[0], D, D),
                                          jnp.float64)
        skew = 0.5 * (w - jnp.swapaxes(w, -1, -2))
        pert = rs._orthonormalize(
            jnp.eye(D, dtype=jnp.float64) + skew + 0.5 * (skew @ skew))
        Mij = pert @ Mij
    if noise_t:
        tij = tij + noise_t * jax.random.normal(k4, tij.shape, jnp.float64)

    g = PoseGraph(n_vertices=N, dim=D,
                  src=np.asarray(src), dst=np.asarray(dst),
                  Rij=np.asarray(Mij), tij=np.asarray(tij),
                  kappa=np.ones(int(src.shape[0])))
    return g, np.asarray(R_true), np.asarray(t_true)


def _errors(R, t, R_true, t_true):
    er, et = pose_sync.alignment_errors(
        jnp.asarray(R), jnp.asarray(t), jnp.asarray(R_true),
        jnp.asarray(t_true))
    return float(er), float(et)


@pytest.mark.slow
def test_noiseless_pose_graph_exact():
    g, R_true, t_true = _make_pose_graph(0)
    res = pose_sync.solve_pose_graph(g, dtype=jnp.float64)
    err_R, err_t = _errors(res.R, res.t, R_true, t_true)
    assert err_R < 1e-6
    # LSQR's S1 stop fires at btol * |b| (btol = 1e-8, |b| ~ 17)
    assert float(res.translation_residual) < 1e-5
    assert err_t < 1e-6


def test_noisy_pose_graph_near_truth():
    g, R_true, t_true = _make_pose_graph(1, noise_rot=0.02, noise_t=0.01)
    res = pose_sync.solve_pose_graph(g, dtype=jnp.float64)
    err_R, err_t = _errors(res.R, res.t, R_true, t_true)
    assert err_R < 0.05
    assert err_t < 0.15


def test_g2o_file_roundtrip_pipeline(tmp_path):
    """Write the graph as a real g2o file, reload, solve — the loader and the
    model agree on the measurement convention."""
    from optimization_tpu.io import load_g2o

    g, R_true, t_true = _make_pose_graph(2)
    lines = []
    info = np.zeros(21)
    info[[0, 6, 11, 15, 18, 20]] = 1.0
    info_s = " ".join(map(str, info))
    for e in range(len(g.src)):
        M = g.Rij[e]
        w = np.sqrt(max(0.0, 1 + np.trace(M))) / 2
        x = (M[2, 1] - M[1, 2]) / (4 * w)
        y = (M[0, 2] - M[2, 0]) / (4 * w)
        z = (M[1, 0] - M[0, 1]) / (4 * w)
        tx, ty, tz = g.tij[e]
        lines.append(
            f"EDGE_SE3:QUAT {int(g.src[e])} {int(g.dst[e])} "
            f"{tx:.14f} {ty:.14f} {tz:.14f} "
            f"{x:.14f} {y:.14f} {z:.14f} {w:.14f} {info_s}")
    p = tmp_path / "pose.g2o"
    p.write_text("\n".join(lines) + "\n")

    loaded = load_g2o(str(p))
    res = pose_sync.solve_pose_graph(loaded, dtype=jnp.float64)
    err_R, err_t = _errors(res.R, res.t, R_true, t_true)
    assert err_R < 1e-5
    assert err_t < 1e-4


def test_translation_recovery_weighted():
    g, R_true, t_true = _make_pose_graph(3, noise_t=0.05)
    w = np.linspace(0.5, 2.0, len(g.src))
    t, resid = pose_sync.recover_translations(
        jnp.asarray(R_true), jnp.asarray(g.src), jnp.asarray(g.dst),
        jnp.asarray(g.tij), weights=jnp.asarray(w))
    # With true rotations the LS recovers translations to ~noise accuracy
    _, err_t = _errors(R_true, np.asarray(t), R_true, t_true)
    assert err_t < 0.2
    assert float(resid) > 0  # noisy: nonzero residual reported


def test_pose_graph_certification():
    """certify=True checks global optimality of the rotation estimate via the
    SE-Sync dual certificate (LOBPCG on S = L - Lambda)."""
    g, R_true, t_true = _make_pose_graph(4, noise_rot=0.02, noise_t=0.01)
    res = pose_sync.solve_pose_graph(g, dtype=jnp.float64, certify=True)
    assert res.certificate is not None
    assert float(res.certificate.stationarity) < 1e-6
    assert bool(res.certificate.certified)


@pytest.mark.parametrize("n", [300, 1000])
def test_marginalized_objective_f32_matches_f64(n):
    """The marginalized objective, compiled in f32, agrees with its f64
    value near the optimum of a graph with translations of scale 5 and
    noise 0.01.  Both terms are sums of squared residuals; inner-product
    forms of them cancel O(|t|^2) down to O(noise^2), which left ~1e-3
    relative error in f32 and let the trust region accept steps on
    rounding."""
    rng = np.random.default_rng(n)
    R_true = np.asarray(rs.ROTATIONS.rand(jax.random.PRNGKey(n), n, D, D),
                        np.float64)
    t_true = 5.0 * rng.normal(size=(n, D))
    src = np.concatenate([np.arange(n - 1), rng.integers(0, n, 2 * n)])
    dst = np.concatenate([np.arange(1, n), rng.integers(0, n, 2 * n)])
    keep = src != dst
    src, dst = src[keep], dst[keep]
    Rt = np.swapaxes(R_true, -1, -2)
    Mij = Rt[src] @ R_true[dst]
    w = 0.01 * rng.normal(size=(len(src), D, D))
    skew = 0.5 * (w - np.swapaxes(w, -1, -2))
    Mij = np.asarray(rs._orthonormalize(
        jnp.asarray(np.eye(D) + skew + 0.5 * skew @ skew))) @ Mij
    tij = (np.einsum("eij,ej->ei", Rt[src], t_true[dst] - t_true[src])
           + 0.01 * rng.normal(size=(len(src), D)))
    Q = jnp.asarray(Rt + 0.003 * rng.normal(size=Rt.shape))
    Q = rs._orthonormalize(Q)            # a point near the optimum

    def value(dtype):
        problem, _, _ = pose_sync.marginalized_problem(
            jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32),
            jnp.asarray(Mij, dtype), jnp.asarray(tij, dtype), n=n)
        return float(jax.jit(problem.f)(Q.astype(dtype), None))

    f64 = value(jnp.float64)
    assert abs(value(jnp.float32) - f64) <= 1e-4 * f64, f64


@pytest.mark.slow
def test_se2_pose_graph_pipeline(tmp_path):
    """SE(2) end-to-end: write an EDGE_SE2 g2o file, load, solve."""
    from optimization_tpu.io import load_g2o

    rng = np.random.default_rng(5)
    n = 16
    th_true = jnp.asarray(rng.uniform(-np.pi, np.pi, n))
    t_true = jnp.asarray(rng.normal(size=(n, 2)))

    def rot(t):
        return jnp.array([[jnp.cos(t), -jnp.sin(t)],
                          [jnp.sin(t), jnp.cos(t)]])

    R_true = jnp.stack([rot(t) for t in th_true])
    src = list(range(n - 1)) + [int(rng.integers(n)) for _ in range(2 * n)]
    dst = [i + 1 for i in range(n - 1)] + [int(rng.integers(n))
                                           for _ in range(2 * n)]
    lines = []
    for i, j in zip(src, dst):
        dth = float(th_true[j] - th_true[i])
        dt = jnp.swapaxes(R_true[i], -1, -2) @ (t_true[j] - t_true[i])
        info = "4.0 0.0 0.0 4.0 0.0 2.5"
        lines.append(f"EDGE_SE2 {i} {j} {float(dt[0]):.14f} "
                     f"{float(dt[1]):.14f} {dth:.14f} {info}")
    p = tmp_path / "se2.g2o"
    p.write_text("\n".join(lines) + "\n")

    g = load_g2o(str(p))
    assert g.dim == 2
    res = pose_sync.solve_pose_graph(g, dtype=jnp.float64, certify=True)
    err_R, err_t = _errors(res.R, res.t, np.asarray(R_true),
                           np.asarray(t_true))
    assert err_R < 1e-6
    assert err_t < 1e-6
    assert bool(res.certificate.certified)


@pytest.mark.slow
class TestMarginalized:
    def test_operator_symmetry_and_quadratic_form(self):
        """Q_op is symmetric PSD and f(X) = tr(X' Q X) exactly."""
        g, R_true, t_true = _make_pose_graph(5, noise_rot=0.02, noise_t=0.02)
        src, dst = jnp.asarray(g.src), jnp.asarray(g.dst)
        Mij, tij = jnp.asarray(g.Rij), jnp.asarray(g.tij)
        problem, Q_op, n = pose_sync.marginalized_problem(src, dst, Mij, tij)
        rng = np.random.default_rng(0)
        U = jnp.asarray(rng.normal(size=(n * D, 4)))
        V = jnp.asarray(rng.normal(size=(n * D, 4)))
        np.testing.assert_allclose(float(jnp.sum(U * Q_op(V))),
                                   float(jnp.sum(V * Q_op(U))), rtol=1e-9)
        # PSD on random probes
        quad = jnp.sum(U * Q_op(U), axis=0)
        assert (np.asarray(quad) > -1e-9).all()
        # f agrees with the quadratic form on a rotation point
        Q = rs.ROTATIONS.rand(jax.random.PRNGKey(1), n, D, D)
        X = Q.reshape(n * D, D)
        np.testing.assert_allclose(
            float(problem.value(Q)),
            float(jnp.trace(X.T @ Q_op(X))), rtol=1e-9)

    def test_hessian_second_order_model(self):
        """The analytic Hessian gives a second-order model along the
        retraction (O(t^3) error) — it cannot come from autodiff because the
        inner CG while_loop is not differentiable."""
        g, _, _ = _make_pose_graph(6, noise_rot=0.02, noise_t=0.02)
        problem, _, n = pose_sync.marginalized_problem(
            jnp.asarray(g.src), jnp.asarray(g.dst),
            jnp.asarray(g.Rij), jnp.asarray(g.tij))
        M = rs.ROTATIONS
        X = M.rand(jax.random.PRNGKey(2), n, D, D)
        V = M.proj(X, jax.random.normal(jax.random.PRNGKey(3), (n, D, D)))
        V = V / jnp.sqrt(M.inner(X, V, V))
        gr, hvp = problem.qm(X, None)
        errs = []
        for t in (1e-2, 1e-3):
            fr = float(problem.value(M.retract(X, t * V)))
            model = (float(problem.value(X)) + t * float(M.inner(X, gr, V))
                     + 0.5 * t * t * float(M.inner(X, V, hvp(V))))
            errs.append(abs(fr - model))
        # O(t^3): shrinking t by 10 shrinks the error by ~1000
        assert errs[1] < errs[0] * 1e-2

    def test_noiseless_marginalized_exact_and_certified(self):
        g, R_true, t_true = _make_pose_graph(7)
        res = pose_sync.solve_pose_graph(g, dtype=jnp.float64,
                                         marginalized=True, certify=True)
        err_R, err_t = _errors(res.R, res.t, R_true, t_true)
        assert err_R < 1e-6
        assert err_t < 1e-6
        assert float(res.rotation_result.f) < 1e-12
        assert bool(res.certificate.certified)
        assert float(res.certificate.stationarity) < 1e-6

    def test_loose_certificate_operator_decision_parity(self):
        """The certificate-grade LOOSE-inner-CG Q operator (the f32
        cg_rtol=1e-4 / 60-cap build solve_pose_graph certifies with —
        VERDICT round 4, next 4) reproduces the tight operator's decision
        and lam_min well inside the certificate slack eta on BOTH sides: a
        certifying point (the solved optimum) and a non-certifying one (a
        perturbed iterate).  f32 only — the slack eta = 1e3 eps(dtype) |L|
        scales with the dtype, and in f64 it is too small for any loose
        inner residual (solve_pose_graph gates the loose operator on
        dtype accordingly)."""
        g, _, _ = _make_pose_graph(9, noise_rot=0.02, noise_t=0.02)
        src, dst = jnp.asarray(g.src), jnp.asarray(g.dst)
        Mij = jnp.asarray(g.Rij, jnp.float32)
        tij = jnp.asarray(g.tij, jnp.float32)
        kappa = jnp.asarray(g.kappa, jnp.float32)
        _, Q_tight, n = pose_sync.marginalized_problem(
            src, dst, Mij, tij, kappa=kappa, n=g.n_vertices)
        _, Q_loose, _ = pose_sync.marginalized_problem(
            src, dst, Mij, tij, kappa=kappa, n=g.n_vertices,
            cg_iterations=60, cg_rtol=1e-4)
        rot_data = pose_sync._transposed_rotation_data(src, dst, Mij, kappa)

        res = pose_sync.solve_pose_graph(g, dtype=jnp.float32,
                                         marginalized=True)
        X_opt = res.rotation_result.x
        ct = rs.certify(X_opt, rot_data, operator=Q_tight)
        cl = rs.certify(X_opt, rot_data, operator=Q_loose)
        assert bool(ct.certified) and bool(cl.certified)
        # the loose operator's lam_min perturbation must sit WELL inside
        # the slack (0.5 eta), not just squeak under it
        assert (abs(float(cl.lam_min) - float(ct.lam_min))
                <= 0.5 * float(ct.eta))

        # a genuinely perturbed point must FAIL under both operators
        pert = 0.3 * jax.random.normal(jax.random.PRNGKey(3),
                                       X_opt.shape, jnp.float32)
        X_bad = rs._orthonormalize(X_opt + pert)
        cb_t = rs.certify(X_bad, rot_data, operator=Q_tight)
        cb_l = rs.certify(X_bad, rot_data, operator=Q_loose)
        assert not bool(cb_t.certified) and not bool(cb_l.certified)

    def test_noisy_marginalized_beats_or_matches_two_stage(self):
        """The single-stage objective uses the translation measurements to
        inform rotations: its total SE(3) cost is <= the two-stage one."""
        g, R_true, t_true = _make_pose_graph(8, noise_rot=0.05, noise_t=0.05)

        def total_cost(res):
            R, t = res.R, res.t
            src, dst = jnp.asarray(g.src), jnp.asarray(g.dst)
            Mij, tij = jnp.asarray(g.Rij), jnp.asarray(g.tij)
            rot = jnp.sum((R[dst] - jnp.einsum("eij,ejk->eik", R[src], Mij))
                          ** 2)
            tr = jnp.sum((t[dst] - t[src]
                          - jnp.einsum("eij,ej->ei", R[src], tij)) ** 2)
            return float(rot + tr)

        two = pose_sync.solve_pose_graph(g, dtype=jnp.float64)
        single = pose_sync.solve_pose_graph(g, dtype=jnp.float64,
                                            marginalized=True)
        assert total_cost(single) <= total_cost(two) * (1 + 1e-8)
        err_R, err_t = _errors(single.R, single.t, R_true, t_true)
        assert err_R < 0.1
        assert err_t < 0.3


class TestFlatInnerSolver:
    """Round-3: the communication-avoiding s-step inner Laplacian solver
    (flat engine in solve_mode, Jacobi folded in symmetrically, null
    direction grounded through the U B U' term) matches the round-2
    Jacobi-PCG path."""

    def _graph(self, n=50, seed=7):
        rng = np.random.default_rng(seed)
        src = np.concatenate([np.arange(n - 1), rng.integers(0, n, 2 * n)])
        dst = np.concatenate([np.arange(1, n), rng.integers(0, n, 2 * n)])
        keep = src != dst
        src, dst = src[keep], dst[keep]
        tau = 10.0 ** rng.uniform(-2.0, 2.0, src.shape[0])
        return (jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32),
                jnp.asarray(tau))

    def test_flat_matches_cg_solver(self):
        src, dst, tau = self._graph()
        n = 50
        rng = np.random.default_rng(1)
        r = jnp.asarray(rng.normal(size=(n, 3)))
        r = r - jnp.mean(r, axis=0, keepdims=True)

        cg = pose_sync._weighted_laplacian_solver(
            src, dst, tau, n, max_iterations=5000, engine="cg",
            with_iters=True)
        for s in (1, 2, 3):
            flat = pose_sync._weighted_laplacian_solver(
                src, dst, tau, n, max_iterations=5000, engine="flat",
                s_steps=s, with_iters=True)
            z0, k0 = cg(r)
            z1, k1 = flat(r)
            # same solution through the edge-difference observable
            np.testing.assert_allclose(np.asarray(z1[dst] - z1[src]),
                                       np.asarray(z0[dst] - z0[src]),
                                       atol=1e-8)
            # the residual meets the same tolerance
            dz = tau[:, None] * (z1[dst] - z1[src])
            Lz = jnp.zeros_like(z1).at[dst].add(dz).at[src].add(-dz)
            rel = float(jnp.linalg.norm(Lz - r) / jnp.linalg.norm(r))
            assert rel < 1e-9, (s, rel)

    def test_marginalized_objective_engine_invariant(self):
        src, dst, tau = self._graph(n=24, seed=3)
        rng = np.random.default_rng(4)
        d = 3
        E = src.shape[0]
        key = jax.random.PRNGKey(0)
        Mij = rs.ROTATIONS.rand(key, E, d, d)
        tij = jnp.asarray(rng.normal(size=(E, d)))
        Q = rs.ROTATIONS.rand(jax.random.PRNGKey(1), 24, d, d)

        p_flat, _, _ = pose_sync.marginalized_problem(
            src, dst, Mij, tij, tau=tau, n=24, inner_engine="flat")
        p_cg, _, _ = pose_sync.marginalized_problem(
            src, dst, Mij, tij, tau=tau, n=24, inner_engine="cg")
        np.testing.assert_allclose(float(p_flat.value(Q, None)),
                                   float(p_cg.value(Q, None)), rtol=1e-10)
        np.testing.assert_allclose(np.asarray(p_flat.rgrad(Q, None)),
                                   np.asarray(p_cg.rgrad(Q, None)),
                                   rtol=1e-7, atol=1e-10)


@pytest.mark.slow
class TestLaplacianPreconditioner:
    """Round-2: Jacobi (degree-diagonal) preconditioning of the inner
    weighted-Laplacian CG in the marginalized objective (the reference's
    preconditioner seam, ``Riemannian/TNT.h:122-125``, instantiated for the
    Schur-complement solve)."""

    def _graph(self, n=60, seed=5):
        rng = np.random.default_rng(seed)
        src = np.concatenate([np.arange(n - 1), rng.integers(0, n, 2 * n)])
        dst = np.concatenate([np.arange(1, n), rng.integers(0, n, 2 * n)])
        keep = src != dst
        src, dst = src[keep], dst[keep]
        # tau spanning 5 orders of magnitude: harsh conditioning
        tau = 10.0 ** rng.uniform(-2.5, 2.5, src.shape[0])
        return (jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32),
                jnp.asarray(tau))

    def test_pcg_matches_cg_and_cuts_iterations(self):
        src, dst, tau = self._graph()
        n = 60
        rng = np.random.default_rng(0)
        r = jnp.asarray(rng.normal(size=(n, 3)))
        r = r - jnp.mean(r, axis=0, keepdims=True)   # consistent RHS

        plain = pose_sync._weighted_laplacian_solver(
            src, dst, tau, n, max_iterations=5000, jacobi=False,
            with_iters=True)
        pre = pose_sync._weighted_laplacian_solver(
            src, dst, tau, n, max_iterations=5000, jacobi=True,
            with_iters=True)
        z0, k0 = plain(r)
        z1, k1 = pre(r)

        # Both solve the system: residual check against the operator itself
        def L(z):
            dz = tau[:, None] * (z[dst] - z[src])
            return (jnp.zeros_like(z).at[dst].add(dz).at[src].add(-dz))

        rn0 = float(jnp.linalg.norm(L(z0) - r) / jnp.linalg.norm(r))
        rn1 = float(jnp.linalg.norm(L(z1) - r) / jnp.linalg.norm(r))
        assert rn1 < 1e-8, rn1
        assert rn1 <= rn0 * 10 + 1e-10
        # The solutions agree through the edge-difference observable (the
        # only way z enters the marginalized objective; any null-space
        # component is invisible there)
        np.testing.assert_allclose(np.asarray(z1[dst] - z1[src]),
                                   np.asarray(z0[dst] - z0[src]), atol=1e-7)
        # And the preconditioner pays: >= 2x fewer iterations here
        assert int(k1) * 2 <= int(k0), (int(k1), int(k0))

    def test_marginalized_objective_invariant_to_precon(self):
        src, dst, tau = self._graph(n=24, seed=2)
        rng = np.random.default_rng(3)
        d = 3
        from optimization_tpu.models import rotation_sync as rs
        key = jax.random.PRNGKey(0)
        E = src.shape[0]
        Mij = rs.ROTATIONS.rand(key, E, d, d)
        tij = jnp.asarray(rng.normal(size=(E, d)))
        Q = rs.ROTATIONS.rand(jax.random.PRNGKey(1), 24, d, d)

        p_on, _, _ = pose_sync.marginalized_problem(
            src, dst, Mij, tij, tau=tau, n=24, jacobi=True)
        p_off, _, _ = pose_sync.marginalized_problem(
            src, dst, Mij, tij, tau=tau, n=24, jacobi=False)
        f_on = float(p_on.value(Q, None))
        f_off = float(p_off.value(Q, None))
        np.testing.assert_allclose(f_on, f_off, rtol=1e-9)
        g_on = p_on.rgrad(Q, None)
        g_off = p_off.rgrad(Q, None)
        np.testing.assert_allclose(np.asarray(g_on), np.asarray(g_off),
                                   rtol=1e-6, atol=1e-9)


@pytest.mark.slow
class TestRobustSE:
    """Round-2: Geman-McClure GNC over the marginalized SE(d) objective
    (extends rotation_sync.solve_robust to translation outliers through the
    tau seam)."""

    def _instance(self, n=30, noise=0.01, seed=9):
        # Dense enough that 20% corruption leaves an inlier *majority* at
        # every vertex: with sparser graphs a vertex can end up with (say)
        # 1 inlier vs 2 independent outlier edges, where the robust cost has
        # two equal-cost basins (reject-the-inlier vs reject-the-outliers)
        # and the problem is fundamentally unidentifiable at that vertex.
        rng = np.random.default_rng(seed)
        key = jax.random.PRNGKey(seed)
        R_true = rs.ROTATIONS.rand(key, n, 3, 3)
        t_true = jnp.asarray(rng.normal(size=(n, 3)) * 2.0)
        src = np.concatenate([np.arange(n - 1), rng.integers(0, n, 4 * n)])
        dst = np.concatenate([np.arange(1, n), rng.integers(0, n, 4 * n)])
        keep = src != dst
        src = jnp.asarray(src[keep], jnp.int32)
        dst = jnp.asarray(dst[keep], jnp.int32)
        E = src.shape[0]
        Rt = jnp.swapaxes(R_true, -1, -2)
        Mij = jnp.einsum("eij,ejk->eik", Rt[src], R_true[dst])
        tij = jnp.einsum("eij,ej->ei", Rt[src], t_true[dst] - t_true[src])
        # small inlier noise
        w = noise * jnp.asarray(rng.normal(size=(E, 3, 3)))
        skew = 0.5 * (w - jnp.swapaxes(w, -1, -2))
        pert = rs._orthonormalize(jnp.eye(3) + skew + 0.5 * (skew @ skew))
        Mij = pert @ Mij
        tij = tij + noise * jnp.asarray(rng.normal(size=(E, 3)))
        return R_true, t_true, src, dst, Mij, tij, rng

    def test_rejects_mixed_se3_outliers(self):
        """20% corrupted edges: half full SE(3) outliers (random rotation +
        random offset), half translation-ONLY outliers (correct rotation,
        wrong offset) — the channel rotation-only GNC cannot see."""
        R_true, t_true, src, dst, Mij, tij, rng = self._instance()
        E = int(src.shape[0])
        n_out = int(0.2 * E)
        out_idx = rng.choice(E, n_out, replace=False)
        full_out = out_idx[: n_out // 2]
        tr_out = out_idx[n_out // 2:]

        key = jax.random.PRNGKey(123)
        Mij_c = Mij.at[full_out].set(
            rs.ROTATIONS.rand(key, len(full_out), 3, 3))
        bad_t = jnp.asarray(rng.normal(size=(n_out, 3)) * 10.0)
        tij_c = tij.at[out_idx].set(bad_t)

        n = int(R_true.shape[0])
        rob = pose_sync.solve_robust_se(src, dst, Mij_c, tij_c, n)
        R, t, w_rot, w_tr = rob.R, rob.t, rob.w_rot, rob.w_tr
        # every vertex keeps an inlier majority in this fixture
        assert bool(rob.all_identifiable)

        rot_err, t_err = pose_sync.alignment_errors(R, t, R_true, t_true)
        # at the inlier noise floor (noise=0.01); non-robust solves are
        # dragged far off by the 10-sigma translation outliers
        assert float(rot_err) < 0.05, float(rot_err)
        assert float(t_err) < 0.1, float(t_err)

        w_tr = np.asarray(w_tr)
        w_rot = np.asarray(w_rot)
        inlier = np.setdiff1d(np.arange(E), out_idx)
        # translation weights of ALL corrupted edges driven to ~0
        assert w_tr[np.asarray(out_idx)].max() < 0.05
        # rotation weights of full outliers driven to ~0; translation-only
        # outliers keep their (correct) rotation channel
        assert w_rot[np.asarray(full_out)].max() < 0.05
        assert np.median(w_rot[inlier]) > 0.5
        assert np.median(w_tr[inlier]) > 0.5

        # and the non-robust marginalized solve IS dragged off (sanity that
        # the fixture actually stresses robustness)
        g = type("G", (), dict(src=np.asarray(src), dst=np.asarray(dst),
                               Rij=np.asarray(Mij_c), tij=np.asarray(tij_c),
                               kappa=None, n_vertices=n))()
        plain = pose_sync.solve_pose_graph(g, dtype=jnp.float64,
                                           marginalized=True)
        p_rot, p_t = pose_sync.alignment_errors(plain.R, plain.t,
                                                R_true, t_true)
        assert float(p_t) > float(t_err) * 3
