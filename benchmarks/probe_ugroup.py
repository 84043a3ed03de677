"""U-group op count of the flat CG pass: the ``kernel_check=False`` A/B.

In the sphere subproblem the flat-CG pass carries a low-rank U group.  The
q = Hp low-rank add and the mA = U'(A0 r) anchor dots are load-bearing
(they feed the Chronopoulos-Gear kappa), but the |q|^2 recurrence
(ww/wq/qq) and its fresh anchors nr = |A0 r|^2, pa = <A0 r, A0 p> exist
ONLY to serve the kernel-of-H epsilon safeguard
(IterativeSolvers.h:300-338).  ``stpcg_flat(kernel_check=False)`` drops
them (exact-parity-tested on PD + indefinite subproblems — the
negative-curvature and TR-boundary branches are untouched).

This probe measures the chained engine slope (C data-dependent calls
inside one jit; the slope over max_iterations in {2, 26} cancels init,
loop entry and dispatch) for three arms:

  A  U-free, kernel_check=True
  B  sphere-shaped U group (tiny-B PD perturbation so the loop never
     boundary-exits), kernel_check=True   (the production shape)
  C  same U group, kernel_check=False     (the candidate cut)

Fewer ops need not mean a faster pass: XLA's fusion of the reduction group
decides, so every default keeps the safeguard until a device measures C
ahead of B.  Not measured on the H100 yet.

Usage: ``python benchmarks/probe_ugroup.py [n_log2=24] [dtype=bf16|f32]``.
"""

import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from optimization_tpu.linalg.flat_cg import stpcg_flat

N_LOG2 = int(sys.argv[1]) if len(sys.argv) > 1 else 24
DT = jnp.bfloat16 if (len(sys.argv) < 3 or sys.argv[2] == "bf16") \
    else jnp.float32
N = 1 << N_LOG2
C = 4      # 4-chain: fixed per-call costs cancel in the two-point slope;
           # C only averages noise, and compile cost scales with C
REPS = 2


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


def arm(label, with_u, kernel_check):
    """Chained stpcg_flat slope (us/CG-iteration) for one arm.

    The U arms reuse the production sphere SHAPE — U = (x, (x, 2A.)) with
    the adjoint-form second entry — but scale B by 1e-6 so H = A0 + U B U'
    stays PD (|U B U'| <~ 4e-3 vs A0's min eigenvalue 1): identical op
    structure, no early boundary exit to degenerate the fit."""
    x = mk_x(7)
    g0 = mk_x(1)
    if with_u:
        rq = 667.0
        U = (x, (x, lambda v: 2.0 * A_elem(v)))
        B = 1e-6 * jnp.asarray([[2.0 * rq, -1.0], [-1.0, 0.0]], jnp.float32)
    else:
        U = B = None

    def chain(m_its):
        @jax.jit
        def run(g):
            tot = jnp.zeros((), jnp.float32)
            for _ in range(C):
                res = stpcg_flat(g, A_elem, U, B,
                                 jnp.asarray(1e9, jnp.float32),
                                 max_iterations=m_its, kappa_fgr=1e-6,
                                 theta=1.0, kernel_check=kernel_check)
                tot = tot + res.update_step_M_norm
                g = (g.astype(jnp.float32)
                     * (1.0 + 1e-12 * res.update_step_M_norm)).astype(DT)
            return g, tot
        return run

    lo, hi = 2, 26
    t_lo = timeit(chain(lo), g0)
    t_hi = timeit(chain(hi), g0)
    per_iter = (t_hi - t_lo) / ((hi - lo) * C)
    flag = "" if per_iter > 0 else "  DEGENERATE (early exit?)"
    print(f"{label:44s} {per_iter * 1e6:8.1f} us/CG-iter "
          f"({1.0 / per_iter if per_iter > 0 else 0:6.0f} it/s){flag}",
          flush=True)
    return per_iter


if __name__ == "__main__":
    print(f"backend={jax.default_backend()} n=2^{N_LOG2} dtype="
          f"{jnp.dtype(DT).name} chain={C}", flush=True)
    a = arm("A U-free, kernel_check=True", False, True)
    b = arm("B sphere U group, kernel_check=True", True, True)
    c = arm("C sphere U group, kernel_check=False", True, False)
    if min(a, b, c) > 0:
        print(f"=> U-group overhead {1e6 * (b - a):.1f} us/iter; "
              f"kernel_check=False removes {1e6 * (b - c):.1f} us "
              f"({100 * (b - c) / max(b - a, 1e-12):.0f}% of it); "
              f"engine speedup {b / c:.2f}x", flush=True)
