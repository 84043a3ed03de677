"""Decompose the headline TNT's per-outer fixed cost.

A whole-solve two-point fit gives the outer-iteration overhead only as one
number; this probe attributes it to the flat engine's loop entry, the
trial-step evaluation, or the trust-region epilogue, with two
methodologies:

  A.  chained ``stpcg_flat`` calls (C data-dependent calls inside ONE jit,
      so the dispatch cost amortizes) at max_iterations in {2, 26} on a
      **purely elementwise PD operator** (U=None): the slope is the
      marginal per-CG-iteration cost, the intercept the engine's init +
      while-loop-entry charge.  The operator MUST be PD and unconverging
      at these tolerances or the loop exits early and the fit degenerates
      (the sphere Rayleigh closure's Hessian is indefinite at a random
      point: both chain lengths would boundary-exit after the same few
      iterations).
  A2. chained ``flat_init_dots`` on the real sphere structure: the
      standalone cost of the init reduction group — an upper bound on
      what init-threading saves per outer iteration when the group does
      NOT ride an existing fused pass.
  C.  whole-TNT two-point fits (REPS best-of) in three wirings: C1
      production (``step_eval`` with the init group riding), C2
      ``step_eval(with_init=False)`` (fused trial evaluation, init paid by
      the engine), C3 no ``step_eval`` (separate retract/f/grad passes).
      C3-C2 isolates the fused-evaluator win, C2-C1 the init-threading
      win, and C1 is the production per-outer fixed cost.

Intercepts and standalone per-call figures include the host's dispatch
cost; the SLOPES and the whole-solve two-point fits cancel it.  Every time
is closed with ``jax.block_until_ready``.

Usage: ``python benchmarks/probe_outer.py [n_log2=24] [dtype=bf16|f32]``.
"""

import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from optimization_tpu.linalg.flat_cg import (flat_init_dots,
                                             sphere_rayleigh_flat,
                                             sphere_rayleigh_step,
                                             stpcg_flat)

N_LOG2 = int(sys.argv[1]) if len(sys.argv) > 1 else 24
DT = jnp.bfloat16 if (len(sys.argv) < 3 or sys.argv[2] == "bf16") \
    else jnp.float32
N = 1 << N_LOG2
C = 8      # chained calls per jit
REPS = 3


def timeit(fn, *args):
    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best


def A_elem(v):
    i = jax.lax.iota(jnp.float32, N)
    b = 999.0 / (N - 1)
    return (1.0 + b * i) * v.astype(jnp.float32)


def mk_x(key):
    x = jax.random.uniform(jax.random.PRNGKey(key), (N,), jnp.float32,
                           0.5, 1.0)
    return (x / jnp.sqrt(jnp.dot(x, x))).astype(DT)


def probe_engine():
    """A: chained PD elementwise stpcg_flat; slope = per-CG-iter,
    intercept = init+entry (U-free variant: the real subproblem adds the
    2-vector U group to the init pass — see A2 — but the loop entry and
    the per-iteration pass structure are identical)."""
    g0 = mk_x(1)

    def chain(m_its):
        @jax.jit
        def run(g):
            tot = jnp.zeros((), jnp.float32)
            for _ in range(C):
                res = stpcg_flat(g, A_elem, None, None,
                                 jnp.asarray(1e9, jnp.float32),
                                 max_iterations=m_its, kappa_fgr=1e-6,
                                 theta=1.0)
                tot = tot + res.update_step_M_norm
                # data dependence: perturb g with the result's scalar
                g = (g.astype(jnp.float32)
                     * (1.0 + 1e-12 * res.update_step_M_norm)).astype(DT)
            return g, tot
        return run

    lo, hi = 2, 26
    t_lo = timeit(chain(lo), g0)
    t_hi = timeit(chain(hi), g0)
    per_iter = (t_hi - t_lo) / ((hi - lo) * C)
    init = t_lo / C - lo * per_iter
    if per_iter <= 0:
        print("A DEGENERATE (non-positive slope — early exit?)", flush=True)
    print(f"A stpcg_flat per-CG-iter      {per_iter * 1e3:7.3f} ms "
          f"({1.0 / per_iter if per_iter > 0 else 0:6.0f} it/s)", flush=True)
    print(f"A stpcg_flat init+loop-entry  {init * 1e3:7.3f} ms/call",
          flush=True)
    return per_iter, init


def probe_init_group():
    """A2: chained flat_init_dots on the real sphere structure — the
    standalone init-group cost (what the engine pays per outer when the
    group does not ride the trial-evaluation pass)."""
    x0 = mk_x(2)
    g0 = mk_x(3)

    @jax.jit
    def run(x, g):
        tot = jnp.zeros((), jnp.float32)
        for _ in range(C):
            A0, U, B, _ = sphere_rayleigh_flat(x, A_elem)
            init = flat_init_dots(g, A0, U, B)
            tot = tot + init.rv + init.ar
            g = (g.astype(jnp.float32)
                 * (1.0 + 1e-12 * init.nr)).astype(DT)
        return g, tot

    t = timeit(run, x0, g0) / C
    print(f"A2 init dot group standalone  {t * 1e3:7.3f} ms/call",
          flush=True)
    return t


def probe_tnt(wiring):
    """C: whole TNT solves at two inner caps (chained methodology is not
    possible across solves — one solve is already one program — so this
    is a two-point fit at REPS best-of)."""
    from optimization_tpu import RiemannianProblem
    from optimization_tpu.manifolds import sphere
    from optimization_tpu.solvers import tnt

    M = sphere()

    def f(x, dd):
        return jnp.dot(x.astype(jnp.float32), A_elem(x))

    def grad(x, dd):
        return M.proj(x, (2.0 * A_elem(x)).astype(DT))

    def flat_qm(x, dd, aux=None):
        rq = aux.rq if aux is not None else None
        A0, U, B, _ = sphere_rayleigh_flat(x, A_elem, rq=rq)
        return A0, U, B, (aux.init if aux is not None else None)

    step_eval = {"C1": sphere_rayleigh_step(A_elem),
                 "C2": sphere_rayleigh_step(A_elem, with_init=False),
                 "C3": None}[wiring]
    problem = RiemannianProblem(f=f, manifold=M, grad=grad, flat_qm=flat_qm,
                                step_eval=step_eval)

    def solve_time(cap):
        params = tnt.TNTParams(
            max_iterations=30, max_TPCG_iterations=cap,
            gradient_tolerance=0.0, relative_decrease_tolerance=0.0,
            stepsize_tolerance=0.0, preconditioned_gradient_tolerance=0.0)
        x0 = mk_x(4)

        def run(x):
            res = tnt.solve(problem, x, params, data=None)
            return res

        res = run(x0)
        jax.block_until_ready(res.f)
        best, inner, outer = float("inf"), 0, 0
        for _ in range(REPS):
            t0 = time.perf_counter()
            res = run(x0)
            jax.block_until_ready(res.f)
            best = min(best, time.perf_counter() - t0)
        outer = int(res.num_iterations)
        inner = int(jnp.nansum(jnp.where(
            jnp.arange(30) < outer, res.inner_iterations, 0)))
        return best, outer, inner

    t25, o25, i25 = solve_time(25)
    t50, o50, i50 = solve_time(50)
    if i50 == i25 or o50 == 0:
        print(f"{wiring} TNT fit degenerate (same inner counts)", flush=True)
        return None
    per_cg = (t50 - t25) / (i50 - i25)
    per_outer = max(t50 - i50 * per_cg, 0.0) / o50
    label = {"C1": "step_eval + init riding (prod)",
             "C2": "step_eval, engine-paid init  ",
             "C3": "separate passes              "}[wiring]
    print(f"{wiring} {label} per-CG {per_cg * 1e3:6.3f} ms, per-outer "
          f"fixed {per_outer * 1e3:6.3f} ms ({o50} outer / {i50} cg in "
          f"{t50:.2f}s)", flush=True)
    return per_cg, per_outer


if __name__ == "__main__":
    print(f"backend={jax.default_backend()} n=2^{N_LOG2} dtype="
          f"{jnp.dtype(DT).name} chain={C}", flush=True)
    per_iter, init = probe_engine()
    t_init = probe_init_group()
    fits = {w: probe_tnt(w) for w in ("C1", "C2", "C3")}
    if fits["C1"] and fits["C2"] and fits["C3"]:
        _, p1 = fits["C1"]
        _, p2 = fits["C2"]
        _, p3 = fits["C3"]
        print(f"=> fused trial evaluator win (C3-C2) {(p3 - p2) * 1e3:7.3f}"
              f" ms/outer", flush=True)
        print(f"=> init-threading win        (C2-C1) {(p2 - p1) * 1e3:7.3f}"
              f" ms/outer", flush=True)
        print(f"=> engine entry+init (A, U-free)     {init * 1e3:7.3f}"
              f" ms; residual TR glue (C1 - A-intercept) "
              f"{(p1 - init) * 1e3:7.3f} ms/outer", flush=True)
