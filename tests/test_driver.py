"""Host-chunked driver: exactness of resume, wall-clock stop, times/verbose.

The reference checks the wall clock and prints at the top of every iteration
(``TNT.h:447-471``); the compiled-loop equivalent is host-chunked stepping
(core/driver.py).  These tests pin the driver's central claim: a chunked run
visits exactly the iterates of a monolithic run.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from optimization_tpu import RiemannianProblem, CompositeProblem
from optimization_tpu.core import driver
from optimization_tpu.core.types import (GradientDescentStatus, TNTStatus,
                                         ProximalGradientStatus, ADMMStatus)
from optimization_tpu.manifolds import sphere
from optimization_tpu.solvers import (admm, gradient_descent, prox,
                                      proximal_gradient, tnls, tnt)



def rosenbrock(x, data):
    return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


X0 = jnp.array([-0.5, 0.5])


class TestChunkedEqualsMonolithic:
    def test_gradient_descent(self):
        problem = RiemannianProblem(f=rosenbrock)
        params = gradient_descent.GradientDescentParams(
            max_iterations=200, gradient_tolerance=1e-6,
            relative_decrease_tolerance=0.0, stepsize_tolerance=0.0)
        mono = gradient_descent.solve(problem, X0, params)
        chunked = driver.drive(gradient_descent, problem, X0, params,
                               chunk_iterations=17)
        assert int(chunked.num_iterations) == int(mono.num_iterations)
        assert int(chunked.status) == int(mono.status)
        np.testing.assert_allclose(chunked.x, mono.x, rtol=0, atol=0)
        np.testing.assert_allclose(chunked.objective_values,
                                   mono.objective_values, equal_nan=True)
        np.testing.assert_allclose(chunked.gradient_norms,
                                   mono.gradient_norms, equal_nan=True)
        # chunk-end timestamps recorded for every completed iteration
        n = int(chunked.num_iterations)
        assert np.all(np.isfinite(np.asarray(chunked.times)[:n]))

    def test_tnt_delta_carry(self):
        problem = RiemannianProblem(f=rosenbrock)
        params = tnt.TNTParams(
            max_iterations=100, gradient_tolerance=1e-9,
            relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
            preconditioned_gradient_tolerance=0.0)
        mono = tnt.solve(problem, X0, params)
        chunked = driver.drive(tnt, problem, X0, params, chunk_iterations=7)
        assert int(chunked.num_iterations) == int(mono.num_iterations)
        assert int(chunked.status) == int(mono.status) == TNTStatus.GRADIENT
        np.testing.assert_array_equal(np.asarray(chunked.x),
                                      np.asarray(mono.x))
        np.testing.assert_allclose(chunked.trust_region_radius,
                                   mono.trust_region_radius, equal_nan=True)
        np.testing.assert_allclose(chunked.gain_ratios, mono.gain_ratios,
                                   equal_nan=True)

    def test_tnt_sphere_log_iterates(self):
        P = jnp.array([0.0, 0.0, 1.0])
        problem = RiemannianProblem(
            f=lambda x, d: jnp.sum((x - P) ** 2), manifold=sphere())
        params = tnt.TNTParams(max_iterations=50, gradient_tolerance=1e-8,
                               relative_decrease_tolerance=0.0,
                               stepsize_tolerance=0.0,
                               preconditioned_gradient_tolerance=0.0,
                               log_iterates=True)
        x0 = jnp.array([1.0, 0.0, 0.0])
        mono = tnt.solve(problem, x0, params)
        chunked = driver.drive(tnt, problem, x0, params, chunk_iterations=3)
        n = int(mono.num_iterations)
        np.testing.assert_array_equal(
            np.asarray(chunked.iterates)[:n + 1],
            np.asarray(mono.iterates)[:n + 1])

    def test_proximal_gradient_momentum_carry(self):
        # LASSO keeps FISTA momentum/restart active across chunk boundaries
        A = jnp.array([[3.0, 0.5], [0.5, 1.0], [0.2, -0.7]])
        b = jnp.array([1.0, -2.0, 0.5])
        mu = 0.1
        problem = CompositeProblem(
            f=lambda x, d: 0.5 * jnp.sum((A @ x - b) ** 2),
            g=lambda x, d: mu * jnp.sum(jnp.abs(x)),
            prox_g=lambda x, lam, d: prox.soft_threshold(x, lam * mu))
        params = proximal_gradient.ProximalGradientParams(
            max_iterations=300, composite_gradient_tolerance=1e-8,
            relative_composite_gradient_tolerance=1e-8)
        mono = proximal_gradient.solve(problem, X0, params)
        chunked = driver.drive(proximal_gradient, problem, X0, params,
                               chunk_iterations=11)
        assert int(chunked.num_iterations) == int(mono.num_iterations)
        np.testing.assert_array_equal(np.asarray(chunked.x),
                                      np.asarray(mono.x))
        np.testing.assert_allclose(chunked.objective_values,
                                   mono.objective_values, equal_nan=True)

    def test_admm_warm_start_carry(self):
        # Accelerated LASSO ADMM: acceleration + penalty history must carry
        key_A = jnp.array([[2.0, 0.3], [0.1, 1.5], [0.4, -0.2]])
        b = jnp.array([1.0, 0.5, -0.3])
        mu = 0.05
        AtA = key_A.T @ key_A
        Atb = key_A.T @ b

        def minLx(y, lam, rho, data):
            M = AtA + rho * jnp.eye(2)
            return jnp.linalg.solve(M, Atb + rho * y - lam)

        def minLy(x, lam, rho, data):
            return prox.soft_threshold(x + lam / rho, mu / rho)

        problem = admm.ADMMProblem(
            minLx=minLx, minLy=minLy,
            A=lambda x, d: x, B=lambda y, d: -y, At=lambda r, d: r)
        params = admm.ADMMParams(
            max_iterations=150, mode=admm.ADMMMode.ACCELERATED,
            eps_abs_pri=1e-7, eps_abs_dual=1e-7, eps_rel=1e-8)
        c = jnp.zeros(2)
        mono = admm.solve(problem, c, X0, X0, params)
        chunked = driver.drive_admm(problem, c, X0, X0, params,
                                    chunk_iterations=13)
        assert int(chunked.num_iterations) == int(mono.num_iterations)
        np.testing.assert_array_equal(np.asarray(chunked.x),
                                      np.asarray(mono.x))
        np.testing.assert_allclose(chunked.primal_residuals,
                                   mono.primal_residuals, equal_nan=True)
        np.testing.assert_allclose(chunked.iteration_types,
                                   mono.iteration_types)


class TestHostFacilities:
    def test_elapsed_time_status(self):
        problem = RiemannianProblem(f=rosenbrock)
        params = gradient_descent.GradientDescentParams(
            max_iterations=10**6, gradient_tolerance=0.0,
            relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
            max_computation_time=0.05)
        r = driver.drive(gradient_descent, problem, X0, params,
                         chunk_iterations=50)
        assert int(r.status) == GradientDescentStatus.ELAPSED_TIME
        assert 0 < int(r.num_iterations) < 10**6

    def test_verbose_prints(self, capsys):
        problem = RiemannianProblem(f=rosenbrock)
        params = gradient_descent.GradientDescentParams(
            max_iterations=3, gradient_tolerance=0.0,
            relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
            verbose=True, precision=4)
        driver.drive(gradient_descent, problem, X0, params)
        out = capsys.readouterr().out
        assert out.count("Iter:") == 3
        assert "|g|:" in out

    def test_observer_called_per_chunk(self):
        problem = RiemannianProblem(f=rosenbrock)
        params = gradient_descent.GradientDescentParams(
            max_iterations=20, gradient_tolerance=0.0,
            relative_decrease_tolerance=0.0, stepsize_tolerance=0.0)
        seen = []
        driver.drive(gradient_descent, problem, X0, params,
                     chunk_iterations=5,
                     observer=lambda k, r, t: seen.append(k))
        assert seen == [5, 10, 15, 20]

    def test_per_iteration_observer_parity(self):
        """chunk_iterations=1 recovers the reference's per-iteration void
        callback semantics exactly (GradientDescent.h:34-39,
        ProximalGradient.h:45-49): the observer fires once per iteration,
        and each call sees the iteration-start objective of the monolithic
        solve's trace."""
        problem = RiemannianProblem(f=rosenbrock)
        params = gradient_descent.GradientDescentParams(
            max_iterations=12, gradient_tolerance=0.0,
            relative_decrease_tolerance=0.0, stepsize_tolerance=0.0)
        mono = gradient_descent.solve(problem, X0, params)
        fs, ks = [], []
        driver.drive(gradient_descent, problem, X0, params,
                     chunk_iterations=1,
                     observer=lambda k, r, t: (
                         ks.append(k), fs.append(float(r.objective_values[0]))))
        n = int(mono.num_iterations)
        assert ks == list(range(1, n + 1))          # one call per iteration
        np.testing.assert_allclose(
            fs, np.asarray(mono.objective_values)[:n], rtol=0, atol=0)

        # proximal gradient (FISTA): same per-iteration equivalence
        A = jnp.array([[2.0, 0.3], [0.1, 1.5], [0.4, -0.2]])
        b = jnp.array([1.0, 0.5, -0.3])
        mu = 0.05
        cp = CompositeProblem(
            f=lambda x, d: 0.5 * jnp.sum((A @ x - b) ** 2),
            g=lambda x, d: mu * jnp.sum(jnp.abs(x)),
            prox_g=lambda x, lam, d: prox.soft_threshold(x, lam * mu))
        pparams = proximal_gradient.ProximalGradientParams(
            max_iterations=15, composite_gradient_tolerance=0.0,
            relative_composite_gradient_tolerance=0.0)
        pmono = proximal_gradient.solve(cp, jnp.zeros(2), pparams)
        pfs = []
        driver.drive(proximal_gradient, cp, jnp.zeros(2), pparams,
                     chunk_iterations=1,
                     observer=lambda k, r, t: pfs.append(
                         float(r.objective_values[0])))
        pn = int(pmono.num_iterations)
        assert len(pfs) == pn
        np.testing.assert_allclose(
            pfs, np.asarray(pmono.objective_values)[:pn], rtol=0, atol=0)

    def test_admm_per_iteration_observer_parity(self):
        """drive_admm at chunk_iterations=1: one observer call per ADMM
        iteration, each seeing that iteration's residuals (the reference's
        per-iteration callback, ADMM.h:71-76)."""
        key_A = jnp.array([[2.0, 0.3], [0.1, 1.5], [0.4, -0.2]])
        b = jnp.array([1.0, 0.5, -0.3])
        mu = 0.05
        AtA = key_A.T @ key_A
        Atb = key_A.T @ b

        def minLx(y, lam, rho, data):
            M = AtA + rho * jnp.eye(2)
            return jnp.linalg.solve(M, Atb + rho * y - lam)

        def minLy(x, lam, rho, data):
            return prox.soft_threshold(x + lam / rho, mu / rho)

        problem = admm.ADMMProblem(
            minLx=minLx, minLy=minLy,
            A=lambda x, d: x, B=lambda y, d: -y, At=lambda r, d: r)
        params = admm.ADMMParams(
            max_iterations=25, mode=admm.ADMMMode.ACCELERATED,
            eps_abs_pri=1e-7, eps_abs_dual=1e-7, eps_rel=1e-8)
        c = jnp.zeros(2)
        mono = admm.solve(problem, c, X0, X0, params)
        rs = []
        driver.drive_admm(problem, c, X0, X0, params, chunk_iterations=1,
                          observer=lambda k, r, t: rs.append(
                              float(r.primal_residuals[0])))
        n = int(mono.num_iterations)
        assert len(rs) == n
        np.testing.assert_allclose(
            rs, np.asarray(mono.primal_residuals)[:n], rtol=0, atol=0)

    def test_checkpoint_written(self, tmp_path):
        problem = RiemannianProblem(f=rosenbrock)
        params = tnt.TNTParams(max_iterations=10, gradient_tolerance=0.0,
                               relative_decrease_tolerance=0.0,
                               stepsize_tolerance=0.0,
                               preconditioned_gradient_tolerance=0.0)
        path = str(tmp_path / "ckpt.npz")
        r = driver.drive(tnt, problem, X0, params, chunk_iterations=5,
                         checkpoint_path=path)
        from optimization_tpu.core.checkpoint import load_pytree
        x, Delta = load_pytree(path, (r.x, jnp.zeros(())))
        np.testing.assert_array_equal(np.asarray(x), np.asarray(r.x))


def test_tnls_chunked_equals_monolithic():
    from optimization_tpu import LeastSquaresProblem
    from optimization_tpu.solvers import tnls

    t = jnp.linspace(0.0, 2.0, 60)
    y = jnp.sin(1.7 * t + 0.4) + 0.01 * jnp.cos(13 * t)

    problem = LeastSquaresProblem(
        residual=lambda b, d: jnp.sin(b[0] * t + b[1]) - y)
    params = tnls.TNLSParams(max_iterations=60, gradient_tolerance=1e-10,
                             root_tolerance=1e-12,
                             relative_decrease_tolerance=0.0,
                             stepsize_tolerance=0.0)
    b0 = jnp.array([1.5, 0.2])
    mono = tnls.solve(problem, b0, params)
    chunked = driver.drive(tnls, problem, b0, params, chunk_iterations=7)
    assert int(chunked.num_iterations) == int(mono.num_iterations)
    assert int(chunked.status) == int(mono.status)
    np.testing.assert_array_equal(np.asarray(chunked.x), np.asarray(mono.x))
    np.testing.assert_allclose(chunked.trust_region_radius,
                               mono.trust_region_radius, equal_nan=True)


def test_zero_max_iterations():
    """max_iterations=0 mirrors the monolithic solver (no IndexError)."""
    problem = RiemannianProblem(f=rosenbrock)
    params = gradient_descent.GradientDescentParams(
        max_iterations=0, gradient_tolerance=1e-6)
    mono = gradient_descent.solve(problem, X0, params)
    r = driver.drive(gradient_descent, problem, X0, params)
    assert int(r.num_iterations) == int(mono.num_iterations) == 0
    np.testing.assert_array_equal(np.asarray(r.x), np.asarray(X0))


def _small_lasso_admm():
    """2-d accelerated LASSO ADMM fixture shared by the new parity tests."""
    key_A = jnp.array([[2.0, 0.3], [0.1, 1.5], [0.4, -0.2]])
    b = jnp.array([1.0, 0.5, -0.3])
    mu = 0.05
    AtA = key_A.T @ key_A
    Atb = key_A.T @ b

    def minLx(y, lam, rho, data):
        return jnp.linalg.solve(AtA + rho * jnp.eye(2), Atb + rho * y - lam)

    def minLy(x, lam, rho, data):
        return prox.soft_threshold(x + lam / rho, mu / rho)

    return admm.ADMMProblem(
        minLx=minLx, minLy=minLy,
        A=lambda x, d: x, B=lambda y, d: -y, At=lambda r, d: r)


class TestReferenceHostParity:
    """Round-2 parity items: ADMM iterate logging (ref ``ADMM.h:514-515``) and
    the final verbose status report every reference solver prints
    (``TNT.h:626-686``, ``ADMM.h:597-620``)."""

    def test_admm_log_iterates_roundtrip(self):
        problem = _small_lasso_admm()
        params = admm.ADMMParams(
            max_iterations=60, mode=admm.ADMMMode.ACCELERATED,
            eps_abs_pri=1e-7, eps_abs_dual=1e-7, eps_rel=1e-8,
            log_iterates=True)
        c = jnp.zeros(2)
        mono = admm.solve(problem, c, X0, X0, params)
        k = int(mono.num_iterations)
        assert mono.iterates is not None
        # Logged iterates are the per-iteration x values: the last logged
        # entry is the returned x.
        np.testing.assert_array_equal(np.asarray(mono.iterates)[k - 1],
                                      np.asarray(mono.x))
        assert np.isfinite(np.asarray(mono.iterates)[:k]).all()
        # Chunked run logs the identical history.
        chunked = driver.drive_admm(problem, c, X0, X0, params,
                                    chunk_iterations=7)
        np.testing.assert_array_equal(
            np.asarray(chunked.iterates)[:k], np.asarray(mono.iterates)[:k])

    def test_admm_log_iterates_off_by_default(self):
        problem = _small_lasso_admm()
        params = admm.ADMMParams(max_iterations=5)
        r = admm.solve(problem, jnp.zeros(2), X0, X0, params)
        assert r.iterates is None

    def test_final_report_gd(self, capsys):
        problem = RiemannianProblem(f=rosenbrock)
        params = gradient_descent.GradientDescentParams(
            max_iterations=3, gradient_tolerance=0.0,
            relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
            verbose=True)
        driver.drive(gradient_descent, problem, X0, params)
        out = capsys.readouterr().out
        assert "Gradient descent terminated: iteration limit reached" in out
        assert "f:" in out and "elapsed:" in out

    def test_final_report_tnt_gradient(self, capsys):
        problem = RiemannianProblem(f=rosenbrock)
        params = tnt.TNTParams(
            max_iterations=100, gradient_tolerance=1e-9,
            relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
            preconditioned_gradient_tolerance=0.0, verbose=True)
        r = driver.drive(tnt, problem, X0, params, chunk_iterations=10)
        out = capsys.readouterr().out
        assert int(r.status) == TNTStatus.GRADIENT
        assert "TNT terminated: gradient norm tolerance reached" in out
        assert "|M^-1 g|:" in out

    def test_final_report_admm(self, capsys):
        problem = _small_lasso_admm()
        params = admm.ADMMParams(max_iterations=4, verbose=True,
                                 eps_abs_pri=1e-12, eps_abs_dual=1e-12,
                                 eps_rel=1e-14)
        driver.drive_admm(problem, jnp.zeros(2), X0, X0, params,
                          chunk_iterations=2)
        out = capsys.readouterr().out
        assert "ADMM terminated: iteration limit reached" in out
        assert "primal residual:" in out


class TestTimeInterpolation:
    """``time_interpolation=True``: reference-shaped per-iteration
    timestamps (``Util/Stopwatch.h:15-29`` via ``TNT.h:454-459``) by linear
    interpolation across each chunk — strictly increasing within chunks,
    exact at chunk ends, zero extra dispatches; iterates unchanged."""

    def test_fill_times_exact(self):
        """Unit pin on the fill itself: chunk ends exact, even split
        inside chunks, plateau shape when off."""
        counts, ends = [3, 2, 4], [0.3, 0.5, 0.9]
        t, pos = driver._fill_times(9, counts, ends, True)
        assert pos == 9
        np.testing.assert_allclose(
            t, [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9], rtol=1e-6)
        flat, _ = driver._fill_times(9, counts, ends, False)
        np.testing.assert_allclose(
            flat, [0.3, 0.3, 0.3, 0.5, 0.5, 0.9, 0.9, 0.9, 0.9], rtol=1e-6)
        # zero-iteration chunks (converged mid-chunk) must not divide by 0
        t0, _ = driver._fill_times(3, [2, 0], [0.2, 0.3], True)
        np.testing.assert_allclose(t0[:2], [0.1, 0.2], rtol=1e-6)

    def test_interpolated_times_monotone_iterates_unchanged(self):
        problem = RiemannianProblem(f=rosenbrock)
        params = gradient_descent.GradientDescentParams(
            max_iterations=40, gradient_tolerance=0.0,
            relative_decrease_tolerance=0.0, stepsize_tolerance=0.0)
        flat = driver.drive(gradient_descent, problem, X0, params,
                            chunk_iterations=17)
        interp = driver.drive(gradient_descent, problem, X0, params,
                              chunk_iterations=17, time_interpolation=True)
        np.testing.assert_array_equal(np.asarray(interp.x),
                                      np.asarray(flat.x))
        n = int(interp.num_iterations)
        t = np.asarray(interp.times)[:n]
        assert np.all(np.isfinite(t))
        # strictly increasing (wall clocks advance between chunks and the
        # interpolation splits each chunk evenly); the default stays the
        # documented plateau shape (NB: absolute values are per-run wall
        # clocks — compile time differs between the two runs, so only the
        # SHAPES are comparable, not the values)
        assert np.all(np.diff(t) > 0), t
        tf = np.asarray(flat.times)[:n]
        assert np.all(np.diff(tf) >= 0)
        assert np.any(np.diff(tf) == 0)   # plateaus exist within chunks

    def test_interpolation_admm(self):
        problem = _small_lasso_admm()
        c = jnp.zeros(2)
        params = admm.ADMMParams(max_iterations=30, eps_rel=0.0,
                                 eps_abs_pri=0.0, eps_abs_dual=0.0)
        flat = driver.drive_admm(problem, c, X0, X0, params,
                                 chunk_iterations=11)
        interp = driver.drive_admm(problem, c, X0, X0, params,
                                   chunk_iterations=11,
                                   time_interpolation=True)
        np.testing.assert_array_equal(np.asarray(interp.x),
                                      np.asarray(flat.x))
        n = int(interp.num_iterations)
        assert np.all(np.diff(np.asarray(interp.times)[:n]) > 0)
