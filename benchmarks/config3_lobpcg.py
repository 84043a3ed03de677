"""Config 3: LOBPCG smallest-5 eigenpairs of a 10^5-dim SPD operator.

The operator is diag(linspace(1, m)) (analytically known spectrum, mirroring
the reference's diagonal fixtures, ``LOBPCG_unit_test.cpp:52-75`` /
``LOBPCG_example.cpp:30-142`` scaled up 200x).

Two measurements:
- accuracy parity: a converged solve (tau=1e-4, exact-inverse
  preconditioner) must reach the f32 eigenvalue floor with nev converged —
  that is the vs_baseline gate;
- **sustained block iterations/second** (the headline value): a fixed
  50-iteration run (tau below the dtype floor so convergence never fires),
  which measures the three-block iteration engine itself rather than the
  ~3-iteration converged solve whose wall time is dispatch-dominated.

vs_baseline = accuracy parity: 1.0 when the converged solve reaches the
dtype floor with nev converged, else 0.0.
"""

import jax
import jax.numpy as jnp
import numpy as np

from _util import emit, timeit

from optimization_tpu.linalg.lobpcg import lobpcg


def main():
    m, nx, nev = 100_000, 16, 5
    d = jnp.linspace(1.0, float(m), m, dtype=jnp.float32)
    A = lambda S: d[:, None] * S
    T = lambda S: S / d[:, None]   # exact inverse preconditioner

    # jit the whole solve so repeated calls reuse one compiled program (the
    # implicit while_loop would otherwise retrace + recompile per call)
    @jax.jit
    def run():
        return lobpcg(A, T=T, m=m, nx=nx, nev=nev, max_iterations=100,
                      tau=1e-4, key=jax.random.PRNGKey(3))

    res = run()
    jax.block_until_ready(res.X)
    iters = int(res.num_iterations)
    err = float(np.max(np.abs(np.asarray(res.theta)
                              - np.arange(1, nev + 1, dtype=np.float64))))
    # Accuracy floor in f32 is eps * |A| ~ 1.2e-2 (|A| = 1e5); x64 reaches
    # the reference's 1e-4 envelope (tests pin that on CPU).
    floor = 5e-2 if res.theta.dtype == jnp.float32 else 1e-4
    ok = err < floor and int(res.num_converged) >= nev

    # Sustained engine rate, convergence test disarmed.  TWO-POINT SLOPE
    # over iteration caps (50, 1000): the slope cancels each call's fixed
    # dispatch and loop-entry cost, which a single short call would
    # include.
    K, K_hi = 50, 1000

    def mk(k, rr="eigh"):
        @jax.jit
        def sustained():
            return lobpcg(A, T=T, m=m, nx=nx, nev=nev, max_iterations=k,
                          tau=1e-30, key=jax.random.PRNGKey(3),
                          rr_method=rr)
        return sustained

    s_lo, s_hi = mk(K), mk(K_hi)
    r2 = s_lo()
    jax.block_until_ready(r2.X)
    jax.block_until_ready(s_hi().X)
    assert int(r2.num_iterations) == K
    per_iter = (timeit(lambda: s_hi().X, iters=3)
                - timeit(lambda: s_lo().X, iters=3)) / (K_hi - K)
    rate = 1.0 / per_iter if per_iter > 0 else 0.0

    # Cheap-RR arm: one eigh per iteration (shifted-Cholesky whitening).
    # Reported alongside; the headline stays the robust default path.
    c_lo, c_hi = mk(K, "chol"), mk(K_hi, "chol")
    rc = c_lo()
    jax.block_until_ready(rc.X)
    rc_hi = c_hi()
    jax.block_until_ready(rc_hi.X)
    # The chol path CAN stop early (RR breakdown sets done); use the
    # iterations actually run so a breakdown can't corrupt the slope.
    k_chol, k_chol_hi = int(rc.num_iterations), int(rc_hi.num_iterations)
    if k_chol_hi > k_chol:
        per_chol = (timeit(lambda: c_hi().X, iters=3)
                    - timeit(lambda: c_lo().X, iters=3)) / (k_chol_hi
                                                            - k_chol)
        rate_chol = 1.0 / per_chol if per_chol > 0 else 0.0
    else:
        rate_chol = 0.0

    emit("lobpcg_1e5_iters_per_s", rate,
         f"sustained block iters/s (m={m}, nx={nx}, nev={nev}; two-point "
         f"slope over {K}..{K_hi} fixed iterations); "
         f"chol-RR arm {rate_chol:.0f} it/s "
         f"({k_chol_hi}/{K_hi} its, consistent={bool(rc.pencil_consistent)}); "
         f"converged solve: {iters} iters, "
         f"max|theta-lambda|={err:.2e} @ dtype floor {floor:.0e}, "
         f"nc={int(res.num_converged)}, "
         f"pencil_consistent={bool(res.pencil_consistent)}",
         1.0 if ok else 0.0)


if __name__ == "__main__":
    main()
