"""stpcg_flat (single-synchronization Steihaug-Toint CG) == generic stpcg.

The flat engine restructures the iteration (Chronopoulos-Gear recurrences,
one fused pass, one reduction group) but must reproduce the reference STPCG
semantics (``IterativeSolvers.h:166-426``): exact-regime solutions,
truncation contract, negative-curvature and trust-region boundary exits,
kernel escape with descent alignment.  Each regime is checked against the
generic engine and/or closed forms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from optimization_tpu.linalg.flat_cg import sphere_rayleigh_flat, stpcg_flat
from optimization_tpu.linalg.stpcg import stpcg

DOT = lambda u, v: jnp.sum(u * v)


def _diag_lowrank(n=400, seed=0, rank=2, shift=1.0):
    rng = np.random.default_rng(seed)
    d = jnp.asarray(rng.uniform(1.0, 50.0, n))
    Um = jnp.asarray(rng.normal(size=(n, rank)) / np.sqrt(n))
    U = tuple(Um[:, j] for j in range(rank))   # tuple-of-vectors contract
    Bm = jnp.asarray(rng.normal(size=(rank, rank)))
    B = 0.5 * (Bm + Bm.T) + rank * jnp.eye(rank)
    g = jnp.asarray(rng.normal(size=n))
    A0 = lambda v: (d + shift) * v
    Hv = lambda v: A0(v) + Um @ (B @ (Um.T @ v))
    return d, U, B, g, A0, Hv, Um


class TestParityWithGeneric:
    def test_exact_regime_matches_direct(self):
        d, U, B, g, A0, Hv, Um = _diag_lowrank()
        res = stpcg_flat(g, A0, U, B, 1e9, max_iterations=2000,
                         kappa_fgr=1e-8, theta=0.999)
        H = np.diag(np.asarray(d) + 1.0) + np.asarray(Um) @ np.asarray(B) \
            @ np.asarray(Um).T
        s_direct = -np.linalg.solve(H, np.asarray(g))
        np.testing.assert_allclose(np.asarray(res.s), s_direct, atol=1e-6)
        np.testing.assert_allclose(float(res.update_step_M_norm),
                                   np.linalg.norm(s_direct), rtol=1e-8)

    @pytest.mark.parametrize("body_kind", ["single", "pair"])
    def test_truncation_contract(self, body_kind):
        d, U, B, g, A0, Hv, Um = _diag_lowrank(seed=3)
        kappa = 0.1
        res = stpcg_flat(g, A0, U, B, 1e9, max_iterations=1000,
                         kappa_fgr=kappa, theta=0.5, body_kind=body_kind)
        r = np.asarray(Hv(res.s) + g)
        assert np.linalg.norm(r) < kappa * float(jnp.linalg.norm(g))

    def test_matches_generic_iterates(self):
        d, U, B, g, A0, Hv, Um = _diag_lowrank(seed=5)
        for Delta in (1e9, 0.5, 0.05):
            ref = stpcg(g, Hv, DOT, Delta, max_iterations=300,
                        kappa_fgr=0.05, theta=0.5)
            res = stpcg_flat(g, A0, U, B, Delta, max_iterations=300,
                             kappa_fgr=0.05, theta=0.5)
            assert int(res.num_iterations) == int(ref.num_iterations), Delta
            np.testing.assert_allclose(np.asarray(res.s), np.asarray(ref.s),
                                       rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(float(res.update_step_M_norm),
                                       float(ref.update_step_M_norm),
                                       rtol=1e-8)

    @pytest.mark.parametrize("body_kind", ["single", "pair"])
    def test_negative_curvature_boundary(self, body_kind):
        n = 200
        rng = np.random.default_rng(7)
        d = jnp.asarray(rng.uniform(-2.0, 5.0, n))   # indefinite
        g = jnp.asarray(rng.normal(size=n))
        A0 = lambda v: d * v
        Delta = 2.0
        ref = stpcg(g, A0, DOT, Delta, max_iterations=500, kappa_fgr=1e-8,
                    theta=0.999)
        res = stpcg_flat(g, A0, None, None, Delta, max_iterations=500,
                         kappa_fgr=1e-8, theta=0.999, body_kind=body_kind)
        np.testing.assert_allclose(float(res.update_step_M_norm), Delta,
                                   rtol=1e-10)
        np.testing.assert_allclose(float(jnp.linalg.norm(res.s)), Delta,
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(res.s), np.asarray(ref.s),
                                   rtol=1e-5, atol=1e-8)

    def test_kernel_escape_descent_aligned(self):
        n = 64
        g = jnp.asarray(np.random.default_rng(1).normal(size=n))
        A0 = lambda v: jnp.zeros_like(v)
        Delta = 3.0
        res = stpcg_flat(g, A0, None, None, Delta, max_iterations=50,
                         kappa_fgr=1e-8, theta=0.999)
        # one kernel step to the boundary, descending along -g
        assert int(res.num_iterations) == 0
        np.testing.assert_allclose(float(jnp.linalg.norm(res.s)), Delta,
                                   rtol=1e-6)
        assert float(DOT(res.s, g)) < 0

    def test_sphere_rayleigh_structure_matches_projected_hessian(self):
        n = 500
        rng = np.random.default_rng(11)
        d = jnp.asarray(rng.uniform(1.0, 100.0, n))
        A_elem = lambda v: d * v
        x = jnp.asarray(rng.normal(size=n))
        x = x / jnp.linalg.norm(x)

        A0, U, B, rq = sphere_rayleigh_flat(x, A_elem)
        proj = lambda v: v - DOT(x, v) * x
        Hv = lambda v: proj(2.0 * A_elem(v)) - rq * v   # one-sided form
        g = proj(jnp.asarray(rng.normal(size=n)))       # tangent gradient

        # the symmetrized operator equals the one-sided form on tangents
        # (U entries may be generator callables or (base, elem_fn)
        # adjoint-form pairs — materialize for the check)
        Um = [u[1](u[0]) if isinstance(u, tuple)
              else (u() if callable(u) else u) for u in U]
        v = proj(jnp.asarray(rng.normal(size=n)))
        mv = jnp.stack([jnp.sum(u * v) for u in Um])
        c = B @ mv
        Hs = A0(v) + c[0] * Um[0] + c[1] * Um[1]
        np.testing.assert_allclose(np.asarray(Hs), np.asarray(Hv(v)),
                                   atol=1e-9)

        for Delta in (1e9, 0.3):
            ref = stpcg(g, Hv, DOT, Delta, max_iterations=400,
                        kappa_fgr=0.01, theta=0.5)
            res = stpcg_flat(g, A0, U, B, Delta, max_iterations=400,
                             kappa_fgr=0.01, theta=0.5)
            assert int(res.num_iterations) == int(ref.num_iterations)
            np.testing.assert_allclose(np.asarray(res.s), np.asarray(ref.s),
                                       rtol=1e-5, atol=1e-8)

    @pytest.mark.parametrize("body_kind", ["single", "pair"])
    def test_bf16_storage(self, body_kind):
        n = 1024
        rng = np.random.default_rng(2)
        d = jnp.asarray(rng.uniform(1.0, 20.0, n), jnp.float32)
        g32 = jnp.asarray(rng.normal(size=n), jnp.float32)
        g = g32.astype(jnp.bfloat16)
        A0 = lambda v: d * v.astype(jnp.float32)
        res = stpcg_flat(g, A0, None, None, 1e9, max_iterations=200,
                         kappa_fgr=0.05, theta=0.5, body_kind=body_kind)
        assert res.s.dtype == jnp.bfloat16
        ref = stpcg(g32, lambda v: d * v, DOT, 1e9, max_iterations=200,
                    kappa_fgr=0.05, theta=0.5)
        # bf16 storage: agreement at the storage precision
        np.testing.assert_allclose(
            np.asarray(res.s, np.float32), np.asarray(ref.s),
            atol=0.05 * float(jnp.linalg.norm(ref.s)))


def test_tnt_flat_qm_matches_generic():
    """TNT with problem.flat_qm runs the flat engine and converges to the
    same optimum as the generic path on the benchmark problem family."""
    from optimization_tpu import RiemannianProblem
    from optimization_tpu.manifolds import sphere
    from optimization_tpu.solvers import tnt

    n = 2048
    d = jnp.linspace(1.0, 1000.0, n)
    A_elem = lambda v: d * v
    M = sphere()

    def f(x, dd):
        return jnp.dot(x, A_elem(x))

    def grad(x, dd):
        return M.proj(x, 2.0 * A_elem(x))

    def flat_qm(x, dd):
        A0, U, B, _ = sphere_rayleigh_flat(x, A_elem)
        return A0, U, B

    params = tnt.TNTParams(
        max_iterations=60, max_TPCG_iterations=60, gradient_tolerance=1e-8,
        relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
        preconditioned_gradient_tolerance=0.0)
    x0 = M.rand(jax.random.PRNGKey(5), n)

    flat = RiemannianProblem(f=f, manifold=M, grad=grad, flat_qm=flat_qm)
    generic = RiemannianProblem(f=f, manifold=M, grad=grad)

    r_flat = tnt.solve(flat, x0, params, data=None)
    r_gen = tnt.solve(generic, x0, params, data=None)

    # both drive the Rayleigh quotient to the smallest eigenvalue
    np.testing.assert_allclose(float(r_flat.f), 1.0, atol=1e-6)
    np.testing.assert_allclose(float(r_gen.f), 1.0, atol=1e-6)
    assert float(r_flat.gradfx_norm) < 1e-6
    # iteration effort comparable (same algorithm, restructured arithmetic)
    assert abs(int(r_flat.num_iterations) - int(r_gen.num_iterations)) <= 3


def test_predicted_decrease_matches_explicit_dm():
    """The scalar-recurrence model decrease equals -<g,s> - 1/2 <s,Hs>
    in every exit regime (interior truncation, Delta boundary, negative
    curvature)."""
    d, U, B, g, A0, Hv, Um = _diag_lowrank(seed=13)

    for Delta in (1e9, 0.5, 0.05):
        res = stpcg_flat(g, A0, U, B, Delta, max_iterations=300,
                         kappa_fgr=0.05, theta=0.5)
        s = res.s
        dm_explicit = float(-DOT(g, s) - 0.5 * DOT(s, Hv(s)))
        np.testing.assert_allclose(float(res.predicted_decrease),
                                   dm_explicit, rtol=1e-8, atol=1e-12)

    # negative curvature boundary
    rng = np.random.default_rng(7)
    dneg = jnp.asarray(rng.uniform(-2.0, 5.0, 200))
    gneg = jnp.asarray(rng.normal(size=200))
    A0n = lambda v: dneg * v
    res = stpcg_flat(gneg, A0n, None, None, 2.0, max_iterations=500,
                     kappa_fgr=1e-8, theta=0.999)
    s = res.s
    dm_explicit = float(-DOT(gneg, s) - 0.5 * DOT(s, A0n(s)))
    np.testing.assert_allclose(float(res.predicted_decrease), dm_explicit,
                               rtol=1e-7)


def test_step_eval_matches_separate_evaluation():
    """The fused sphere Rayleigh step evaluator (problem.step_eval) is
    algebraically identical to retract -> f -> rgrad, and TNT with it
    reproduces the plain flat-path solve."""
    from optimization_tpu import RiemannianProblem
    from optimization_tpu.linalg.flat_cg import (sphere_rayleigh_flat,
                                                 sphere_rayleigh_step)
    from optimization_tpu.manifolds import sphere
    from optimization_tpu.solvers import tnt

    n = 1024
    d = jnp.linspace(1.0, 300.0, n)
    A_elem = lambda v: d * v
    M = sphere()
    se = sphere_rayleigh_step(A_elem)

    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=n))
    x = x / jnp.linalg.norm(x)
    h = M.proj(x, jnp.asarray(rng.normal(size=n)) * 0.1)

    x_prop, f_prop, g, gn, aux = se(x, h, None)
    x_ref = M.retract(x, h)
    np.testing.assert_allclose(np.asarray(x_prop), np.asarray(x_ref),
                               atol=1e-12)
    np.testing.assert_allclose(float(f_prop), float(jnp.dot(x_ref,
                                                            A_elem(x_ref))),
                               rtol=1e-12)
    g_ref = M.proj(x_ref, 2.0 * A_elem(x_ref))
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), atol=1e-10)
    np.testing.assert_allclose(float(gn), float(jnp.linalg.norm(g_ref)),
                               rtol=1e-10)
    np.testing.assert_allclose(float(aux.rq),
                               float(jnp.dot(x_ref, 2.0 * A_elem(x_ref))),
                               rtol=1e-12)
    # the aux init group == the engine's own init dots at the trial point
    from optimization_tpu.linalg.flat_cg import flat_init_dots
    A0p, Up, Bp, _ = sphere_rayleigh_flat(x_prop, A_elem, rq=aux.rq)
    ref_init = flat_init_dots(g, A0p, Up, Bp)
    for got, want in zip(aux.init, ref_init):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-13, atol=0)

    # full-solve parity through TNT
    def f(x, dd):
        return jnp.dot(x, A_elem(x))

    def grad(x, dd):
        return M.proj(x, 2.0 * A_elem(x))

    def flat_qm(x, dd):
        A0, U, B, _ = sphere_rayleigh_flat(x, A_elem)
        return A0, U, B

    def flat_qm_aux(x, dd, aux=None):
        # the step_eval aux carry supplies the Rayleigh quotient AND the
        # engine's pre-loop dot group (threaded to stpcg_flat(init=))
        rq = aux.rq if aux is not None else None
        A0, U, B, _ = sphere_rayleigh_flat(x, A_elem, rq=rq)
        return A0, U, B, (aux.init if aux is not None else None)

    params = tnt.TNTParams(
        max_iterations=100, max_TPCG_iterations=60,
        gradient_tolerance=1e-6, relative_decrease_tolerance=0.0,
        stepsize_tolerance=0.0, preconditioned_gradient_tolerance=0.0)
    x0 = M.rand(jax.random.PRNGKey(7), n).astype(jnp.float64)
    plain = RiemannianProblem(f=f, manifold=M, grad=grad, flat_qm=flat_qm)
    fused = RiemannianProblem(f=f, manifold=M, grad=grad,
                              flat_qm=flat_qm_aux, step_eval=se)
    r0 = tnt.solve(plain, x0, params, data=None)
    r1 = tnt.solve(fused, x0, params, data=None)
    assert int(r0.status) == int(r1.status)
    assert abs(int(r0.num_iterations) - int(r1.num_iterations)) <= 1
    np.testing.assert_allclose(float(r1.f), float(r0.f), rtol=1e-10)
    assert float(r1.gradfx_norm) < 1e-6


class TestInitThreading:
    """stpcg_flat(init=flat_init_dots(...)) must be numerically invisible:
    the same helper computes the same dots the engine would, so supplying
    them only removes the pre-loop pass/sync (the TNT per-outer fixed-cost
    lever, docs/ROADMAP.md 'Outer-iteration overhead')."""

    def test_engine_parity_exact(self):
        from optimization_tpu.linalg.flat_cg import flat_init_dots
        d, U, B, g, A0, Hv, Um = _diag_lowrank(seed=21)
        for Delta in (1e9, 0.5, 0.05):
            ref = stpcg_flat(g, A0, U, B, Delta, max_iterations=300,
                             kappa_fgr=0.05, theta=0.5)
            res = stpcg_flat(g, A0, U, B, Delta, max_iterations=300,
                             kappa_fgr=0.05, theta=0.5,
                             init=flat_init_dots(g, A0, U, B))
            assert int(res.num_iterations) == int(ref.num_iterations)
            np.testing.assert_array_equal(np.asarray(res.s),
                                          np.asarray(ref.s))
            np.testing.assert_array_equal(float(res.update_step_M_norm),
                                          float(ref.update_step_M_norm))

    def test_engine_parity_indefinite_and_kernel(self):
        from optimization_tpu.linalg.flat_cg import flat_init_dots
        n = 200
        rng = np.random.default_rng(9)
        for d in (jnp.asarray(rng.uniform(-2.0, 5.0, n)),   # indefinite
                  jnp.zeros(n)):                             # kernel
            g = jnp.asarray(rng.normal(size=n))
            A0 = lambda v: d * v
            ref = stpcg_flat(g, A0, None, None, 2.0, max_iterations=500,
                             kappa_fgr=1e-8, theta=0.999)
            res = stpcg_flat(g, A0, None, None, 2.0, max_iterations=500,
                             kappa_fgr=1e-8, theta=0.999,
                             init=flat_init_dots(g, A0, None))
            assert int(res.num_iterations) == int(ref.num_iterations)
            np.testing.assert_array_equal(np.asarray(res.s),
                                          np.asarray(ref.s))

    def test_sstep_engine_rejects_init(self):
        from optimization_tpu.linalg.flat_cg import flat_init_dots
        d, U, B, g, A0, Hv, Um = _diag_lowrank(seed=22)
        init = flat_init_dots(g, A0, U, B)
        with pytest.raises(ValueError, match="pair engine"):
            stpcg_flat(g, A0, U, B, 1.0, s_steps=2, init=init)

    def test_tnt_init_threading_matches_plain_flat(self):
        """Full TNT: step_eval aux carrying FlatCGInit (the headline
        bench.py wiring) == the plain flat path, including across
        REJECTED steps (small Delta0 forces rejections, exercising the
        carried-dot-group-unchanged-on-reject invariant)."""
        from optimization_tpu import RiemannianProblem
        from optimization_tpu.linalg.flat_cg import sphere_rayleigh_step
        from optimization_tpu.manifolds import sphere
        from optimization_tpu.solvers import tnt

        n = 1024
        d = jnp.linspace(1.0, 300.0, n)
        A_elem = lambda v: d * v
        M = sphere()

        def f(x, dd):
            return jnp.dot(x, A_elem(x))

        def grad(x, dd):
            return M.proj(x, 2.0 * A_elem(x))

        def flat_qm(x, dd):
            A0, U, B, _ = sphere_rayleigh_flat(x, A_elem)
            return A0, U, B

        def flat_qm_aux(x, dd, aux=None):
            rq = aux.rq if aux is not None else None
            A0, U, B, _ = sphere_rayleigh_flat(x, A_elem, rq=rq)
            return A0, U, B, (aux.init if aux is not None else None)

        # eta1 high + tiny alpha1 => plenty of rejected steps early on
        params = tnt.TNTParams(
            max_iterations=80, max_TPCG_iterations=40, Delta0=10.0,
            eta1=0.3, gradient_tolerance=1e-6,
            relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
            preconditioned_gradient_tolerance=0.0)
        x0 = M.rand(jax.random.PRNGKey(11), n).astype(jnp.float64)
        plain = RiemannianProblem(f=f, manifold=M, grad=grad,
                                  flat_qm=flat_qm)
        fused = RiemannianProblem(f=f, manifold=M, grad=grad,
                                  flat_qm=flat_qm_aux,
                                  step_eval=sphere_rayleigh_step(A_elem))
        r0 = tnt.solve(plain, x0, params, data=None)
        r1 = tnt.solve(fused, x0, params, data=None)
        # some step must have been rejected for this test to bite
        gains = np.asarray(r1.gain_ratios)[:int(r1.num_iterations)]
        assert np.any(~(gains > params.eta1))
        assert int(r0.status) == int(r1.status)
        assert int(r0.num_iterations) == int(r1.num_iterations)
        np.testing.assert_allclose(float(r1.f), float(r0.f), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r0.x),
                                   atol=1e-10)

    def test_tnt_init_threading_bf16(self):
        """bf16 storage tier with init threading converges to the same
        quality as without (the headline configuration in miniature)."""
        from optimization_tpu import RiemannianProblem
        from optimization_tpu.linalg.flat_cg import sphere_rayleigh_step
        from optimization_tpu.manifolds import sphere
        from optimization_tpu.solvers import tnt

        n = 4096
        dvec = jnp.linspace(1.0, 1000.0, n).astype(jnp.float32)
        A_elem = lambda v: dvec * v.astype(jnp.float32)
        M = sphere()

        def f(x, dd):
            return jnp.dot(x.astype(jnp.float32), A_elem(x))

        def grad(x, dd):
            return M.proj(x, (2.0 * A_elem(x)).astype(x.dtype))

        def flat_qm_aux(x, dd, aux=None):
            rq = aux.rq if aux is not None else None
            A0, U, B, _ = sphere_rayleigh_flat(x, A_elem, rq=rq)
            return A0, U, B, (aux.init if aux is not None else None)

        params = tnt.TNTParams(
            max_iterations=30, max_TPCG_iterations=50,
            gradient_tolerance=0.0, relative_decrease_tolerance=0.0,
            stepsize_tolerance=0.0, preconditioned_gradient_tolerance=0.0)
        x0 = M.rand(jax.random.PRNGKey(2), n).astype(jnp.bfloat16)
        for with_init in (False, True):
            prob = RiemannianProblem(
                f=f, manifold=M, grad=grad, flat_qm=flat_qm_aux,
                step_eval=sphere_rayleigh_step(A_elem,
                                               with_init=with_init))
            res = tnt.solve(prob, x0, params, data=None)
            assert res.x.dtype == jnp.bfloat16
            # both tiers march the kappa=1000 quotient to the same
            # neighborhood of lambda_min = 1 at this fixed effort
            assert float(res.f) < 1.05, with_init


def test_adjoint_form_u_entry_matches_stored():
    """A ``(base, elem_fn)`` U entry (adjoint-form dots: <u, v> computed
    as <base, elem_fn(v)>; Hessian term via ``mat_scaled`` =
    ``elem_fn(c * base)``) must produce the same solve as the same vector
    passed stored, up to reassociation rounding — the per-element
    products differ by one multiplication order, so a knife-edge
    truncation may shift by one iteration while the step agrees to
    rounding.  This is the form sphere_rayleigh_flat emits
    for y = 2Ax so the engine's reductions read only x and no hoisted
    loop-invariant y is materialized (flat_cg._norm_U)."""
    n = 600
    rng = np.random.default_rng(3)
    d = jnp.asarray(rng.uniform(0.5, 50.0, n))
    x = jnp.asarray(rng.normal(size=n))
    x = x / jnp.linalg.norm(x)
    g = jnp.asarray(rng.normal(size=n)) * 0.1

    def A0(v):
        return d * v + 2.0 * v

    B = jnp.asarray([[0.3, -0.1], [-0.1, 0.2]])
    elem = lambda v: 2.0 * (d * v)
    U_pair = (x, (x, elem))
    U_stored = (x, elem(x))

    for Delta in (1e9, 0.25):
        ra = stpcg_flat(g, A0, U_pair, B, Delta, max_iterations=300,
                        kappa_fgr=1e-8, theta=1.0)
        rb = stpcg_flat(g, A0, U_stored, B, Delta, max_iterations=300,
                        kappa_fgr=1e-8, theta=1.0)
        assert abs(int(ra.num_iterations) - int(rb.num_iterations)) <= 1
        np.testing.assert_allclose(np.asarray(ra.s), np.asarray(rb.s),
                                   rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(float(ra.predicted_decrease),
                                   float(rb.predicted_decrease),
                                   rtol=1e-8)


@pytest.mark.parametrize("body_kind", ["single", "pair"])
def test_body_kinds_match_generic(body_kind):
    """Both pair-engine loop bodies (single-iteration and pair-deferred)
    reproduce the generic STPCG iterates exactly."""
    d, U, B, g, A0, Hv, Um = _diag_lowrank(seed=9)
    for Delta in (1e9, 0.4, 0.04):
        ref = stpcg(g, Hv, DOT, Delta, max_iterations=300,
                    kappa_fgr=0.05, theta=0.5)
        res = stpcg_flat(g, A0, U, B, Delta, max_iterations=300,
                         kappa_fgr=0.05, theta=0.5, body_kind=body_kind)
        assert int(res.num_iterations) == int(ref.num_iterations), Delta
        np.testing.assert_allclose(np.asarray(res.s), np.asarray(ref.s),
                                   rtol=1e-6, atol=1e-9)


def test_resolve_body_boundary():
    """The loop body is no longer chosen by size: the pair body is the
    default (it was faster in both headline tiers at n = 2^24 on the H100),
    and a body kind other than single/pair is refused."""
    d, U, B, g, A0, Hv, Um = _diag_lowrank(seed=9)
    kw = dict(max_iterations=300, kappa_fgr=0.05, theta=0.5)
    dflt = stpcg_flat(g, A0, U, B, 0.4, **kw)
    pair = stpcg_flat(g, A0, U, B, 0.4, body_kind="pair", **kw)
    assert int(dflt.num_iterations) == int(pair.num_iterations)
    np.testing.assert_array_equal(np.asarray(dflt.s), np.asarray(pair.s))
    with pytest.raises(ValueError, match="body_kind"):
        stpcg_flat(g, A0, U, B, 0.4, body_kind="auto", **kw)


@pytest.mark.parametrize("body_kind", ["single", "pair"])
def test_kernel_check_off_matches_generic(body_kind):
    """``kernel_check=False`` (drop the kernel-of-H epsilon safeguard and
    its |q|^2 recurrence + nr/pa anchor dots — an op-count cut,
    benchmarks/probe_ugroup.py) must be bit-equivalent on
    every subproblem without an eps-kernel direction: PD, indefinite
    (negative-curvature boundary exits go through kappa <= 0, untouched),
    and trust-region-binding regimes, on both loop bodies."""
    for seed, shift in ((5, 1.0), (11, -30.0)):     # PD and indefinite
        d, U, B, g, A0, Hv, Um = _diag_lowrank(seed=seed, shift=shift)
        for Delta in (1e9, 0.5, 0.05):
            ref = stpcg_flat(g, A0, U, B, Delta, max_iterations=300,
                             kappa_fgr=0.05, theta=0.5, body_kind=body_kind)
            res = stpcg_flat(g, A0, U, B, Delta, max_iterations=300,
                             kappa_fgr=0.05, theta=0.5, body_kind=body_kind,
                             kernel_check=False)
            assert int(res.num_iterations) == int(ref.num_iterations), \
                (seed, Delta)
            np.testing.assert_array_equal(np.asarray(res.s),
                                          np.asarray(ref.s))
            np.testing.assert_array_equal(float(res.predicted_decrease),
                                          float(ref.predicted_decrease))
            np.testing.assert_array_equal(float(res.update_step_M_norm),
                                          float(ref.update_step_M_norm))


def test_kernel_check_off_sphere_structure_and_guards():
    """kernel_check=False on the production sphere Rayleigh structure
    (adjoint-form U) matches the default engine; the s-step engine
    rejects the flag (it keeps the safeguard)."""
    n = 500
    rng = np.random.default_rng(21)
    d = jnp.asarray(rng.uniform(0.5, 100.0, n))
    x = jnp.asarray(rng.normal(size=n))
    x = x / jnp.linalg.norm(x)
    A0, U, B, rq = sphere_rayleigh_flat(x, lambda v: d * v)
    g = jnp.asarray(rng.normal(size=n)) * 0.1
    g = g - jnp.dot(g, x) * x
    for Delta in (1e9, 0.3):
        ra = stpcg_flat(g, A0, U, B, Delta, max_iterations=300,
                        kappa_fgr=1e-6, theta=1.0)
        rb = stpcg_flat(g, A0, U, B, Delta, max_iterations=300,
                        kappa_fgr=1e-6, theta=1.0, kernel_check=False)
        assert int(ra.num_iterations) == int(rb.num_iterations)
        np.testing.assert_array_equal(np.asarray(ra.s), np.asarray(rb.s))

    with pytest.raises(ValueError, match="kernel_check"):
        stpcg_flat(g, A0, U, B, 1.0, s_steps=2, kernel_check=False)
    from optimization_tpu.solvers import tnt
    with pytest.raises(ValueError, match="flat_kernel_check"):
        tnt.TNTParams(flat_s_steps=2, flat_kernel_check=False).validate()


class TestPreconditionedFlat:
    """The prec= seam (symmetric folding) == generic preconditioned STPCG.

    Reference semantics under test (``IterativeSolvers.h:236-291,388-420``):
    v = M^{-1} r inner products, truncation in the |.|_{M^{-1}} residual
    norm, trust region and reported step norm in |.|_M.
    """

    @staticmethod
    def _setup(seed=11, n=300, cond=1e4):
        rng = np.random.default_rng(seed)
        d = jnp.asarray(rng.uniform(1.0, cond, n))       # ill-conditioned
        Um = jnp.asarray(rng.normal(size=(n, 2)) / np.sqrt(n))
        U = (Um[:, 0], Um[:, 1])
        Bm = jnp.asarray(rng.normal(size=(2, 2)))
        B = 0.5 * (Bm + Bm.T) + 2.0 * jnp.eye(2)
        g = jnp.asarray(rng.normal(size=n))
        A0 = lambda v: d * v
        Hv = lambda v: A0(v) + Um @ (B @ (Um.T @ v))
        prec = lambda v: v * jax.lax.rsqrt(d)            # M^{-1/2}, M = D
        gen_precon = lambda r: (r / d, None)             # M^{-1} r
        return d, U, B, g, A0, Hv, prec, gen_precon

    def test_exact_regime_matches_direct(self):
        d, U, B, g, A0, Hv, prec, _ = self._setup()
        res = stpcg_flat(g, A0, U, B, 1e9, max_iterations=3000,
                         kappa_fgr=1e-10, theta=0.999, prec=prec)
        n = g.shape[0]
        Um = jnp.stack(U, axis=1)
        H = (np.diag(np.asarray(d)) + np.asarray(Um) @ np.asarray(B)
             @ np.asarray(Um).T)
        s_direct = -np.linalg.solve(H, np.asarray(g))
        np.testing.assert_allclose(np.asarray(res.s), s_direct,
                                   rtol=1e-6, atol=1e-9)
        # reported step norm is the M-norm |s|_D
        m_norm = float(np.sqrt(s_direct @ (np.asarray(d) * s_direct)))
        np.testing.assert_allclose(float(res.update_step_M_norm), m_norm,
                                   rtol=1e-6)

    @pytest.mark.parametrize("Delta", [1e9, 1.0, 1e-2])
    def test_matches_generic_preconditioned(self, Delta):
        d, U, B, g, A0, Hv, prec, gen_precon = self._setup(seed=23)

        # generic engine: M-norm inner product is implicit in its
        # recurrences; precon returns (M^{-1} r, None)
        ref = stpcg(g, Hv, DOT, Delta, max_iterations=400,
                    kappa_fgr=0.05, theta=0.5, precon=gen_precon)
        res = stpcg_flat(g, A0, U, B, Delta, max_iterations=400,
                         kappa_fgr=0.05, theta=0.5, prec=prec)
        assert int(res.num_iterations) == int(ref.num_iterations), Delta
        np.testing.assert_allclose(np.asarray(res.s), np.asarray(ref.s),
                                   rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(float(res.update_step_M_norm),
                                   float(ref.update_step_M_norm), rtol=1e-6)

    def test_sstep_engine_preconditioned(self):
        d, U, B, g, A0, Hv, prec, gen_precon = self._setup(seed=31)
        ref = stpcg(g, Hv, DOT, 2.0, max_iterations=200,
                    kappa_fgr=0.05, theta=0.5, precon=gen_precon)
        res = stpcg_flat(g, A0, U, B, 2.0, max_iterations=200,
                         kappa_fgr=0.05, theta=0.5, s_steps=2, prec=prec)
        assert int(res.num_iterations) == int(ref.num_iterations)
        np.testing.assert_allclose(np.asarray(res.s), np.asarray(ref.s),
                                   rtol=1e-5, atol=1e-9)

    def test_speedup_vs_unpreconditioned_iterations(self):
        """The whole point: Jacobi preconditioning on an ill-conditioned
        diagonal-dominant problem slashes CG iterations to the target."""
        d, U, B, g, A0, Hv, prec, _ = self._setup(seed=7, cond=1e6)
        plain = stpcg_flat(g, A0, U, B, 1e9, max_iterations=3000,
                           kappa_fgr=1e-6, theta=0.9)
        pc = stpcg_flat(g, A0, U, B, 1e9, max_iterations=3000,
                        kappa_fgr=1e-6, theta=0.9, prec=prec)
        assert int(pc.num_iterations) * 10 < int(plain.num_iterations)

    def test_prec_rejects_init(self):
        d, U, B, g, A0, Hv, prec, _ = self._setup()
        from optimization_tpu.linalg.flat_cg import flat_init_dots
        init = flat_init_dots(g, A0, U, B)
        with pytest.raises(ValueError):
            stpcg_flat(g, A0, U, B, 1.0, prec=prec, init=init)

    def test_tnt_flat_prec_matches_generic_precon(self):
        """TNT routes problem.flat_prec through the flat engine and matches
        the generic preconditioned path's trajectory."""
        from optimization_tpu import RiemannianProblem
        from optimization_tpu.manifolds import sphere
        from optimization_tpu.solvers import tnt

        n = 1024
        d = jnp.linspace(1.0, 1e5, n)
        A_elem = lambda v: d * v
        M = sphere()

        def f(x, dd):
            return jnp.dot(x, A_elem(x))

        def grad(x, dd):
            return M.proj(x, 2.0 * A_elem(x))

        def flat_qm(x, dd):
            A0, U, B, _ = sphere_rayleigh_flat(x, A_elem)
            return A0, U, B

        # Jacobi on the dominant elementwise part: D = 2 d (a valid SPD
        # preconditioner for both paths; both must see the SAME M)
        prec_elem = lambda v: v * jax.lax.rsqrt(2.0 * d)

        def flat_prec(x, dd):
            return prec_elem

        def precon(x, v, dd):
            return M.proj(x, v / (2.0 * d))

        params = tnt.TNTParams(
            max_iterations=50, max_TPCG_iterations=200,
            gradient_tolerance=1e-8, relative_decrease_tolerance=0.0,
            stepsize_tolerance=0.0, preconditioned_gradient_tolerance=0.0)
        x0 = M.rand(jax.random.PRNGKey(9), n)

        flat = RiemannianProblem(f=f, manifold=M, grad=grad,
                                 flat_qm=flat_qm, flat_prec=flat_prec,
                                 precon=precon)
        generic = RiemannianProblem(f=f, manifold=M, grad=grad,
                                    precon=precon)
        r_flat = tnt.solve(flat, x0, params, data=None)
        r_gen = tnt.solve(generic, x0, params, data=None)

        np.testing.assert_allclose(float(r_flat.f), float(r_gen.f),
                                   rtol=1e-8)
        np.testing.assert_allclose(float(r_flat.f), 1.0, atol=1e-4)


# ----------------------------------------------------------------------
# The headline structure: the sphere Rayleigh-quotient Hessian
# P H P = A0 + U B U' (sphere_rayleigh_flat) against the generic STPCG on
# the one-sided projected form, across the reference STPCG contract
# (``IterativeSolvers.h:166-426``): interior/truncation,
# trust-region-boundary and negative-curvature exits, for both loop bodies.

SPHERE_N = 4096
DELTAS = [1e6, 0.5, 0.02]
BODIES = ["single", "pair"]


def _sphere(seed=0, spread=25.0, rq=None):
    """(A_elem, x, g, flat structure, generic Hv) at a random point of
    S^{n-1}; ``rq`` replaces the Rayleigh quotient of the Hessian's shift
    (a value below 2 min(a) makes the operator positive definite)."""
    n = SPHERE_N
    b = spread / (n - 1)
    a = 1.0 + b * jnp.arange(n, dtype=jnp.float64)
    A_elem = lambda v: a * v
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=n))
    x = x / jnp.linalg.norm(x)
    y = 2.0 * A_elem(x)
    g = y - DOT(x, y) * x                            # tangent gradient
    A0, U, B, rq_x = sphere_rayleigh_flat(x, A_elem, rq=rq)
    shift = rq_x if rq is None else rq
    proj = lambda v: v - DOT(x, v) * x
    Hv = lambda v: proj(2.0 * A_elem(v)) - shift * v
    return A_elem, x, g, (A0, U, B), Hv


@pytest.mark.parametrize("body_kind", BODIES)
@pytest.mark.parametrize("Delta", DELTAS)
def test_sphere_matches_generic(Delta, body_kind):
    A_elem, x, g, (A0, U, B), Hv = _sphere()
    kw = dict(max_iterations=300, kappa_fgr=0.05, theta=0.5)
    ref = stpcg(g, Hv, DOT, Delta, **kw)
    res = stpcg_flat(g, A0, U, B, Delta, body_kind=body_kind, **kw)
    assert int(res.num_iterations) == int(ref.num_iterations)
    np.testing.assert_allclose(np.asarray(res.s), np.asarray(ref.s),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(res.update_step_M_norm),
                               float(ref.update_step_M_norm), rtol=1e-8)
    dm = float(-DOT(g, res.s) - 0.5 * DOT(res.s, Hv(res.s)))
    np.testing.assert_allclose(float(res.predicted_decrease), dm,
                               rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("body_kind", BODIES)
@pytest.mark.parametrize("Delta", DELTAS)
def test_sphere_init_threading_parity(Delta, body_kind):
    """init=flat_init_dots(...) is bit-identical to the engine's own
    pre-loop dot group on the sphere structure."""
    from optimization_tpu.linalg.flat_cg import flat_init_dots

    A_elem, x, g, (A0, U, B), Hv = _sphere(seed=4)
    kw = dict(max_iterations=300, kappa_fgr=0.05, theta=0.5,
              body_kind=body_kind)
    ref = stpcg_flat(g, A0, U, B, Delta, **kw)
    res = stpcg_flat(g, A0, U, B, Delta, init=flat_init_dots(g, A0, U, B),
                     **kw)
    assert int(res.num_iterations) == int(ref.num_iterations)
    np.testing.assert_array_equal(np.asarray(res.s), np.asarray(ref.s))
    np.testing.assert_array_equal(float(res.predicted_decrease),
                                  float(ref.predicted_decrease))


@pytest.mark.parametrize("body_kind", BODIES)
@pytest.mark.parametrize("Delta", DELTAS)
def test_sphere_preconditioned_parity(Delta, body_kind):
    """prec= (Jacobi on the elementwise part, folded symmetrically) ==
    the generic engine with the same M^{-1}."""
    A_elem, x, g, (A0, U, B), Hv = _sphere(seed=6, spread=400.0)
    dvec = 2.0 * A_elem(jnp.ones(SPHERE_N))
    prec = lambda v: v * jax.lax.rsqrt(dvec)
    gen_precon = lambda r: (r / dvec, None)
    kw = dict(max_iterations=300, kappa_fgr=0.05, theta=0.5)
    ref = stpcg(g, Hv, DOT, Delta, precon=gen_precon, **kw)
    res = stpcg_flat(g, A0, U, B, Delta, prec=prec, body_kind=body_kind,
                     **kw)
    assert int(res.num_iterations) == int(ref.num_iterations)
    np.testing.assert_allclose(np.asarray(res.s), np.asarray(ref.s),
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(float(res.update_step_M_norm),
                               float(ref.update_step_M_norm), rtol=1e-6)


@pytest.mark.parametrize("body_kind", BODIES)
@pytest.mark.parametrize("Delta", [1e6, 1.2])
def test_sphere_interior_multi_iteration_parity(Delta, body_kind):
    """Many interior CG iterations on a positive-definite shift of the
    sphere structure: the carried recurrences track the generic engine,
    and an interior exit meets the truncation target."""
    kappa = 1e-3
    A_elem, x, g, (A0, U, B), Hv = _sphere(seed=7, rq=0.5)
    kw = dict(max_iterations=400, kappa_fgr=kappa, theta=0.9)
    ref = stpcg(g, Hv, DOT, Delta, **kw)
    res = stpcg_flat(g, A0, U, B, Delta, body_kind=body_kind, **kw)
    assert int(res.num_iterations) == int(ref.num_iterations) > 3
    # the restructured recurrences round differently, and many iterations
    # amplify that: agreement to 1e-7 of |s|
    np.testing.assert_allclose(
        np.asarray(res.s), np.asarray(ref.s),
        atol=1e-7 * float(jnp.linalg.norm(ref.s)))
    if Delta > 10.0:                         # interior truncation exit
        r = np.asarray(Hv(res.s) + g)
        assert np.linalg.norm(r) < kappa * float(jnp.linalg.norm(g))
    else:                                    # trust-region boundary
        np.testing.assert_allclose(float(jnp.linalg.norm(res.s)), Delta,
                                   rtol=1e-8)


@pytest.mark.parametrize("preconditioned", [False, True],
                         ids=["plain", "prec"])
def test_tnt_flat_solve_seam(preconditioned):
    """TNT's bring-your-own-engine seam (``RiemannianProblem.flat_solve``)
    driven by ``stpcg_flat`` with a pinned loop body follows the same
    trajectory as the built-in flat path, with and without the elementwise
    preconditioner it must fold itself."""
    from optimization_tpu import RiemannianProblem
    from optimization_tpu.linalg.flat_cg import sphere_rayleigh_step
    from optimization_tpu.manifolds import sphere
    from optimization_tpu.solvers import tnt

    n = 2048
    d = jnp.linspace(1.0, 1e4 if preconditioned else 1e3, n)
    A_elem = lambda v: d * v
    M = sphere()
    f = lambda x, dd: jnp.dot(x, A_elem(x))
    grad = lambda x, dd: M.proj(x, 2.0 * A_elem(x))
    prec_elem = lambda v: v * jax.lax.rsqrt(2.0 * d)

    def flat_qm(x, dd, aux=None):
        rq = aux.rq if aux is not None else None
        A0, U, B, _ = sphere_rayleigh_flat(x, A_elem, rq=rq)
        init = aux.init if (aux is not None and not preconditioned) else None
        return A0, U, B, init

    def flat_solve(g, x, dd, aux, Delta, params):
        A0, U, B, init = flat_qm(x, dd, aux)
        return stpcg_flat(g, A0, U, B, Delta,
                          max_iterations=params.max_TPCG_iterations,
                          kappa_fgr=params.kappa_fgr, theta=params.theta,
                          init=init, body_kind="pair",
                          prec=prec_elem if preconditioned else None)

    extra = {}
    if preconditioned:
        extra = dict(flat_prec=lambda x, dd: prec_elem,
                     precon=lambda x, v, dd: M.proj(x, v / (2.0 * d)))
    se = sphere_rayleigh_step(A_elem, with_init=not preconditioned)
    params = tnt.TNTParams(
        max_iterations=60, max_TPCG_iterations=100, gradient_tolerance=1e-8,
        relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
        preconditioned_gradient_tolerance=0.0)
    x0 = M.rand(jax.random.PRNGKey(12), n)
    seam = RiemannianProblem(f=f, manifold=M, grad=grad, flat_qm=flat_qm,
                             flat_solve=flat_solve, step_eval=se, **extra)
    built_in = RiemannianProblem(f=f, manifold=M, grad=grad, flat_qm=flat_qm,
                                 step_eval=se, **extra)
    r_seam = tnt.solve(seam, x0, params, data=None)
    r_ref = tnt.solve(built_in, x0, params, data=None)
    np.testing.assert_allclose(float(r_seam.f), 1.0, atol=1e-6)
    np.testing.assert_allclose(float(r_seam.f), float(r_ref.f), rtol=1e-10)
    assert abs(int(r_seam.num_iterations) - int(r_ref.num_iterations)) <= 1
