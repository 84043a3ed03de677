"""Config 10: fleet-batched LOBPCG — amortizing the small-op iteration floor.

Single-instance LOBPCG at moderate m is latency-bound (each three-block
iteration is two small (3nx)^2 eighs plus blocked GEMMs,
benchmarks/probe_lobpcg.py splits it), so certification and
spectral-init sweeps that solve one pencil per problem pay that floor
serially.  ``linalg.lobpcg.lobpcg_fleet`` vmaps the ENTIRE iteration —
Rayleigh-Ritz, masking, convergence logic — into fleet-wide batched
GEMMs/eighs.

Measurement: a 16-instance fleet of m=10^4 diagonal pencils (distinct
spectra), sustained over K=50 fixed lockstep iterations (tau below the
dtype floor), against the single-instance sustained rate at the same
(m, nx, nev).  Headline value = aggregate fleet block-iterations/second;
the unit string carries the per-instance serial rate and the fleet
speedup.

The fleet default is the shifted-Cholesky Rayleigh-Ritz
(``rr_method="chol"``, one eigh per iteration);
benchmarks/probe_jacobi.py compares it in-fleet with the eigh RR and the
batched parallel-Jacobi eigensolver.  Not measured on the H100 yet.

vs_baseline = (fleet aggregate) / (1.5x the serial rate): >= 1.0 means
the fleet path beats solving the instances serially by at least 1.5x,
with accuracy parity (every instance's wanted Ritz values at its
converged solve match the known spectrum) gating the score.
"""

import jax
import jax.numpy as jnp
import numpy as np

from _util import emit, timeit

from optimization_tpu.linalg.lobpcg import lobpcg, lobpcg_fleet


def main():
    fleet, m, nx, nev = 16, 10_000, 16, 5
    K = 50

    # distinct spectra: instance b has diagonal linspace(1+b, (1+b)*m/10)
    scales = jnp.arange(1.0, fleet + 1.0, dtype=jnp.float32)
    ds = scales[:, None] * jnp.linspace(1.0, m / 10.0, m,
                                        dtype=jnp.float32)[None, :]

    A = lambda S, d: d[:, None] * S
    T = lambda S, d: S / d[:, None]

    # accuracy parity: converged fleet solve against the known spectra
    @jax.jit
    def converged():
        return lobpcg_fleet(A, ds, T=T, m=m, nx=nx, nev=nev,
                            max_iterations=100, tau=1e-4,
                            key=jax.random.PRNGKey(5))

    res = converged()
    jax.block_until_ready(res.X)
    theta_true = np.asarray(ds[:, :nev], np.float64)
    err = float(np.max(np.abs(np.asarray(res.theta, np.float64) - theta_true)
                       / theta_true))
    ok = (err < 1e-3 and bool(jnp.all(res.num_converged >= nev))
          and bool(jnp.all(res.pencil_consistent)))

    # Sustained lockstep rate, convergence disarmed.  TWO-POINT SLOPE over
    # lockstep counts (K, 10K): the slope cancels each call's fixed
    # dispatch and loop-entry cost.
    K_hi = 10 * K

    def mk_fleet(k):
        @jax.jit
        def sustained_fleet():
            return lobpcg_fleet(A, ds, T=T, m=m, nx=nx, nev=nev,
                                max_iterations=k, tau=1e-30,
                                key=jax.random.PRNGKey(5))
        return sustained_fleet

    f_lo, f_hi = mk_fleet(K), mk_fleet(K_hi)
    jax.block_until_ready(f_lo().X)
    jax.block_until_ready(f_hi().X)
    per_lockstep = (timeit(lambda: f_hi().X, iters=3)
                    - timeit(lambda: f_lo().X, iters=3)) / (K_hi - K)
    aggregate = fleet / per_lockstep if per_lockstep > 0 else 0.0

    d0 = ds[0]

    def mk_one(k):
        @jax.jit
        def sustained_one():
            return lobpcg(lambda S: d0[:, None] * S,
                          T=lambda S: S / d0[:, None],
                          m=m, nx=nx, nev=nev, max_iterations=k, tau=1e-30,
                          key=jax.random.PRNGKey(5))
        return sustained_one

    o_lo, o_hi = mk_one(K), mk_one(K_hi)
    jax.block_until_ready(o_lo().X)
    jax.block_until_ready(o_hi().X)
    per_one = (timeit(lambda: o_hi().X, iters=3)
               - timeit(lambda: o_lo().X, iters=3)) / (K_hi - K)
    serial = 1.0 / per_one if per_one > 0 else 0.0

    speedup = aggregate / serial if serial > 0 else 0.0
    emit("lobpcg_fleet16_aggregate_iters_per_s", aggregate,
         f"aggregate block iters/s, {fleet}-instance vmapped fleet "
         f"(m={m}, nx={nx}, nev={nev}; two-point slope over K={K}..{K_hi} "
         f"lockstep); per-instance fused "
         f"rate {aggregate / fleet:.0f}/s vs serial single-instance "
         f"{serial:.0f}/s -> fleet speedup {speedup:.1f}x of {fleet}x "
         f"ideal; converged parity: max rel err {err:.1e}, "
         f"all nc>={nev}: {bool(jnp.all(res.num_converged >= nev))}, "
         f"pencil_consistent all: {bool(jnp.all(res.pencil_consistent))}",
         (aggregate / (1.5 * serial)) if ok and serial > 0 else 0.0)


if __name__ == "__main__":
    main()
