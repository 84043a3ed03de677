"""A/B the fleet LOBPCG Rayleigh-Ritz eigensolver.

config10's lockstep iteration is bound by its batched (3nx x 3nx) eighs.
Does the parallel-Jacobi batched solver (linalg/jacobi.py) or the one-eigh
shifted-Cholesky RR beat the batched library eigh inside the real fleet
iteration?  Measures the sustained 16-instance fleet rate (convergence
disarmed) and a converged-accuracy parity check for each arm.

These are single-call K=50 timings, so each carries one dispatch on top of
device time; the ranking is unaffected (every arm pays it), but for
absolute rates use config10's two-point slopes.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import jax
import jax.numpy as jnp
import numpy as np

from optimization_tpu.linalg.lobpcg import lobpcg_fleet
from optimization_tpu.linalg.jacobi import jacobi_eigh


def main():
    print(f"backend={jax.default_backend()}", flush=True)
    fleet, m, nx, nev, K = 16, 10_000, 16, 5, 50
    scales = jnp.arange(1.0, fleet + 1.0, dtype=jnp.float32)
    ds = scales[:, None] * jnp.linspace(1.0, m / 10.0, m,
                                        dtype=jnp.float32)[None, :]
    A = lambda S, d: d[:, None] * S
    T = lambda S, d: S / d[:, None]

    for label, fn, rr in [("eigh-rr", None, "eigh"),
                          ("jacobi-eigh-rr", jacobi_eigh, "eigh"),
                          ("chol2-rr", None, "chol")]:
        @jax.jit
        def sustained():
            return lobpcg_fleet(A, ds, T=T, m=m, nx=nx, nev=nev,
                                max_iterations=K, tau=1e-30,
                                key=jax.random.PRNGKey(5), eigh_fn=fn,
                                rr_method=rr)

        t0 = time.perf_counter()
        out = sustained()
        jax.block_until_ready(out.X)
        print(f"{label}: compile+run {time.perf_counter() - t0:.1f}s",
              flush=True)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = sustained()
            jax.block_until_ready(out.X)
            best = min(best, time.perf_counter() - t0)
        agg = fleet * K / best
        print(f"{label}: {best / K * 1e3:.2f} ms/lockstep-iter, "
              f"aggregate {agg:.0f} it/s", flush=True)

        # converged accuracy parity
        @jax.jit
        def converged():
            return lobpcg_fleet(A, ds, T=T, m=m, nx=nx, nev=nev,
                                max_iterations=100, tau=1e-4,
                                key=jax.random.PRNGKey(5), eigh_fn=fn,
                                rr_method=rr)

        res = converged()
        jax.block_until_ready(res.X)
        tt = np.asarray(ds[:, :nev], np.float64)
        err = float(np.max(np.abs(np.asarray(res.theta, np.float64) - tt)
                           / tt))
        print(f"{label}: converged max rel err {err:.2e}, "
              f"nc>=nev all: {bool(jnp.all(res.num_converged >= nev))}, "
              f"consistent: {bool(jnp.all(res.pencil_consistent))}",
              flush=True)


if __name__ == "__main__":
    main()
