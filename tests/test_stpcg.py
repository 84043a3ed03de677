"""STPCG tests mirroring reference ``IterativeSolvers_unit_test.cpp`` (STPCG half).

- Exact regime (kappa=1e-8, theta=.999, Delta=inf): s == -H^{-1} g, with and
  without preconditioning (ref lines 138-215).
- Negative curvature: step lands exactly on the trust-region boundary, with
  and without preconditioning (ref lines 165-251).
- Truncation contract on n=1000: relative residual < kappa (in the
  M^{-1}-norm when preconditioned) (ref lines 254-310).
- Projected (equality-constrained) STPCG vs a direct dense KKT solve
  (ref lines 316-496); exact and truncated variants.
- Reported |s|_M matches an independently computed M-norm in every case.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from optimization_tpu.linalg import stpcg

EPS_ABS = 1e-6
EPS_REL = 1e-6

SMALL_DIM = 3
LARGE_DIM = 1000
NUM_CONSTRAINTS = 100

inner = lambda u, v: jnp.dot(u, v)

small_g = jnp.array([21.0, -0.4, 19.0])
small_P = jnp.array([1000.0, 100.0, 1.0])      # diagonal PD Hessian
small_M = jnp.array([100.0, 10.0, 1.0])        # diagonal PD preconditioner

rng = np.random.default_rng(0)
large_g = jnp.asarray(rng.uniform(-1, 1, LARGE_DIM))
large_P = jnp.asarray(2000.0 + 1000.0 * rng.uniform(-1, 1, LARGE_DIM))
large_M = jnp.asarray(2000.0 + 1000.0 * rng.uniform(-1, 1, LARGE_DIM))


def diag_op(d):
    return lambda v: d * v


def diag_precon(d):
    """SPD preconditioner M: returns (M^{-1} v, None)."""
    return lambda v: (v / d, None)


def test_exact_stpcg():
    res = stpcg(small_g, diag_op(small_P), inner, jnp.inf,
                max_iterations=SMALL_DIM, kappa_fgr=1e-8, theta=0.999)
    s_gt = -(small_g / small_P)
    assert float(jnp.linalg.norm(res.s - s_gt)) < EPS_ABS
    s_norm = float(jnp.linalg.norm(res.s))
    assert abs(float(res.update_step_M_norm) - s_norm) / s_norm < EPS_REL


def test_exact_stpcg_negative_curvature():
    Delta = 1000.0
    res = stpcg(small_g, diag_op(-small_P), inner, Delta,
                max_iterations=SMALL_DIM, kappa_fgr=1e-8, theta=0.999)
    s_gt = -(Delta / jnp.linalg.norm(small_g)) * small_g
    assert float(jnp.linalg.norm(res.s - s_gt)) < EPS_ABS
    s_norm = float(jnp.linalg.norm(res.s))
    assert abs(float(res.update_step_M_norm) - s_norm) / s_norm < EPS_REL


def test_exact_stpcg_preconditioned():
    res = stpcg(small_g, diag_op(small_P), inner, jnp.inf,
                max_iterations=SMALL_DIM, kappa_fgr=1e-8, theta=0.999,
                precon=diag_precon(small_M))
    s_gt = -(small_g / small_P)
    assert float(jnp.linalg.norm(res.s - s_gt)) < EPS_ABS
    s_M_norm = float(jnp.sqrt(jnp.dot(res.s, small_M * res.s)))
    assert abs(float(res.update_step_M_norm) - s_M_norm) / s_M_norm < EPS_REL


def test_exact_stpcg_negative_curvature_preconditioned():
    Delta = 1000.0
    res = stpcg(small_g, diag_op(-small_P), inner, Delta,
                max_iterations=SMALL_DIM, kappa_fgr=1e-8, theta=0.999,
                precon=diag_precon(small_M))
    # Ground truth: walk the (preconditioned) steepest descent direction to
    # the boundary in the M-norm (ref IterativeSolvers_unit_test.cpp:230-245)
    p = -(small_g / small_M)
    p_M_norm = jnp.sqrt(jnp.dot(p, small_M * p))
    s_gt = (Delta / p_M_norm) * p
    assert float(jnp.linalg.norm(res.s - s_gt)) < EPS_ABS
    s_M_norm = float(jnp.sqrt(jnp.dot(res.s, small_M * res.s)))
    assert abs(float(res.update_step_M_norm) - s_M_norm) / s_M_norm < EPS_REL


def test_stpcg_truncation():
    kappa = 0.1
    res = stpcg(large_g, diag_op(large_P), inner, 1000.0,
                max_iterations=SMALL_DIM, kappa_fgr=kappa, theta=0.7)
    r_norm = jnp.linalg.norm(large_g + large_P * res.s)
    assert float(r_norm / jnp.linalg.norm(large_g)) < kappa
    s_norm = float(jnp.linalg.norm(res.s))
    assert abs(float(res.update_step_M_norm) - s_norm) / s_norm < EPS_REL


def test_stpcg_preconditioned_truncation():
    kappa = 0.1
    res = stpcg(large_g, diag_op(large_P), inner, 1000.0,
                max_iterations=LARGE_DIM, kappa_fgr=kappa, theta=0.7,
                precon=diag_precon(large_M))
    # Residual contract is in the M^{-1} norm when preconditioned
    g_Minv = float(jnp.sqrt(jnp.dot(large_g, large_g / large_M)))
    r = large_g + large_P * res.s
    r_Minv = float(jnp.sqrt(jnp.dot(r, r / large_M)))
    assert r_Minv / g_Minv < kappa
    s_M_norm = float(jnp.sqrt(jnp.dot(res.s, large_M * res.s)))
    assert abs(float(res.update_step_M_norm) - s_M_norm) / s_M_norm < EPS_REL


def _kkt_setup():
    """Dense KKT ground truth for the equality-constrained subproblem."""
    rng_c = np.random.default_rng(1)
    A = 1000.0 * rng_c.uniform(-1, 1, (NUM_CONSTRAINTS, LARGE_DIM))
    n, m = LARGE_DIM, NUM_CONSTRAINTS
    K = np.zeros((n + m, n + m))
    K[:n, :n] = np.diag(np.asarray(large_P))
    K[:n, n:] = A.T
    K[n:, :n] = A
    rhs = np.zeros(n + m)
    rhs[:n] = -np.asarray(large_g)
    z = np.linalg.solve(K, rhs)
    s_gt = z[:n]

    # Constraint preconditioner: solve [M A'; A 0][x; l] = [r; 0]
    Mc = np.zeros((n + m, n + m))
    Mc[:n, :n] = np.diag(np.asarray(large_M))
    Mc[:n, n:] = A.T
    Mc[n:, :n] = A
    Mc_inv = np.linalg.inv(Mc)
    Mc_inv_j = jnp.asarray(Mc_inv)
    A_j = jnp.asarray(A)

    def precon(r):
        w = jnp.concatenate([r, jnp.zeros(m, dtype=r.dtype)])
        z = Mc_inv_j @ w
        return z[:n], z[n:]

    At_op = lambda lam: A_j.T @ lam
    return A, s_gt, precon, At_op


def test_exact_projected_stpcg():
    A, s_gt, precon, At_op = _kkt_setup()
    res = stpcg(large_g, diag_op(large_P), inner, jnp.inf,
                max_iterations=5 * LARGE_DIM, kappa_fgr=1e-8, theta=0.7,
                precon=precon, At=At_op)
    s = np.asarray(res.s)
    # Step lies in the null space of A
    assert np.linalg.norm(A @ s) / np.linalg.norm(s) < EPS_ABS
    # Step agrees with the primal KKT solution
    assert np.linalg.norm(s - s_gt) / np.linalg.norm(s_gt) < EPS_REL
    s_M_norm = float(np.sqrt(s @ (np.asarray(large_M) * s)))
    assert abs(float(res.update_step_M_norm) - s_M_norm) / s_M_norm < EPS_REL


def test_truncated_projected_stpcg():
    kappa = 0.1
    A, s_gt, precon, At_op = _kkt_setup()
    res = stpcg(large_g, diag_op(large_P), inner, jnp.inf,
                max_iterations=5 * LARGE_DIM, kappa_fgr=kappa, theta=0.7,
                precon=precon, At=At_op)
    s = res.s
    # Fractional reduction of the residual in the P-norm
    v0, _ = precon(large_g)
    r0_Pnorm = float(jnp.sqrt(jnp.dot(large_g, v0)))
    rk = large_g + large_P * s
    vk, _ = precon(rk)
    rk_Pnorm = float(jnp.sqrt(jnp.dot(rk, vk)))
    assert rk_Pnorm / r0_Pnorm < kappa
    s_M_norm = float(jnp.sqrt(jnp.dot(s, large_M * s)))
    assert abs(float(res.update_step_M_norm) - s_M_norm) / s_M_norm < EPS_REL


def test_zero_gradient_returns_zero():
    """g = 0: target norm is 0, loop never runs, s = 0."""
    res = stpcg(jnp.zeros(SMALL_DIM), diag_op(small_P), inner, 1.0,
                max_iterations=SMALL_DIM)
    assert int(res.num_iterations) == 0
    np.testing.assert_array_equal(np.asarray(res.s), np.zeros(SMALL_DIM))


def test_user_function_early_stop():
    stop_all = lambda k, s, r, v, p, alpha: jnp.asarray(True)
    res = stpcg(small_g, diag_op(small_P), inner, jnp.inf,
                max_iterations=SMALL_DIM, kappa_fgr=1e-8, theta=0.999,
                user_function=stop_all)
    # Stops before the first update is applied
    assert int(res.num_iterations) == 0
    np.testing.assert_array_equal(np.asarray(res.s), np.zeros(SMALL_DIM))


def test_param_validation():
    with pytest.raises(ValueError):
        stpcg(small_g, diag_op(small_P), inner, 1.0, kappa_fgr=1.5)
    with pytest.raises(ValueError):
        stpcg(small_g, diag_op(small_P), inner, 1.0, theta=-0.1)


def test_kernel_of_H_walks_descent_to_boundary():
    """H = 0: the search direction lies in ker(H); the step must walk the
    *descent* direction -g to the trust-region boundary.

    NB: the reference's sign flip (IterativeSolvers.h:320-326) is inverted —
    it walks the model uphill in this regime; we implement the correct
    descent alignment (see stpcg.py).
    """
    g = jnp.array([3.0, -4.0, 0.0])
    Delta = 0.7
    res = stpcg(g, lambda v: jnp.zeros_like(v), inner, Delta,
                max_iterations=10)
    expected = -Delta * g / jnp.linalg.norm(g)
    np.testing.assert_allclose(np.asarray(res.s), np.asarray(expected),
                               atol=1e-12)
    assert float(res.update_step_M_norm) == Delta
    # The step decreases the model m(s) = <g, s>
    assert float(jnp.dot(g, res.s)) < 0


def test_kernel_direction_after_progress():
    """Kernel escape on a later iteration: H is PSD with a kernel; once CG
    exhausts the range-space component the kernel direction must still be
    walked downhill."""
    # H = diag(1, 1, 0); g has a component in ker(H)
    H = jnp.array([1.0, 1.0, 0.0])
    g = jnp.array([1.0, 2.0, 0.5])
    Delta = 10.0
    res = stpcg(g, diag_op(H), inner, Delta, max_iterations=10,
                kappa_fgr=1e-10, theta=0.999)
    m = float(jnp.dot(g, res.s) + 0.5 * jnp.dot(res.s, H * res.s))
    assert m < 0  # model strictly decreased
    assert abs(float(jnp.sqrt(jnp.dot(res.s, res.s))) - Delta) < 1e-6


def test_predicted_decrease_matches_explicit_dm():
    """STPCGResult.predicted_decrease (scalar recurrence) equals the
    explicit -<g,s> - 1/2 <s,Hs> in every exit regime, including the
    preconditioned path (the recurrence is what lets TNT skip its second
    Hv application, TNT.h:511-521)."""
    rng = np.random.default_rng(29)
    n = 200
    d = jnp.asarray(rng.uniform(0.5, 40.0, n))
    g = jnp.asarray(rng.normal(size=n))
    Hv = lambda v: d * v
    inner = lambda u, v: jnp.dot(u, v)

    for Delta, precon in [(1e9, None), (0.5, None), (0.05, None),
                          (1e9, lambda r: (r / d, None)),
                          (0.3, lambda r: (r / d, None))]:
        res = stpcg(g, Hv, inner, Delta, max_iterations=400,
                    kappa_fgr=0.05, theta=0.5, precon=precon)
        dm = float(-inner(g, res.s) - 0.5 * inner(res.s, Hv(res.s)))
        np.testing.assert_allclose(float(res.predicted_decrease), dm,
                                   rtol=1e-9, atol=1e-12,
                                   err_msg=f"Delta={Delta} "
                                           f"precon={precon is not None}")

    # indefinite -> negative-curvature boundary exit
    d_ind = jnp.asarray(rng.uniform(-3.0, 5.0, n))
    Hv_i = lambda v: d_ind * v
    res = stpcg(g, Hv_i, inner, 2.0, max_iterations=400,
                kappa_fgr=1e-8, theta=0.999)
    dm = float(-inner(g, res.s) - 0.5 * inner(res.s, Hv_i(res.s)))
    np.testing.assert_allclose(float(res.predicted_decrease), dm,
                               rtol=1e-9, atol=1e-12)
