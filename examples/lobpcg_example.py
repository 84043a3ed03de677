"""BASELINE config 3: LOBPCG smallest-k eigenpairs of a structured SPD operator.

Mirrors ``examples/LOBPCG_example.cpp`` (diagonal spectrum, m=500, nx=10,
nev=5, tau=1e-6) and scales to the benchmark's 10^5-dim operator (a 1-D
Laplacian stencil — matrix-free, memory-bandwidth-bound on an accelerator).
Run: python examples/lobpcg_example.py
"""

import time

import jax
import jax.numpy as jnp

from _common import setup

setup()

from optimization_tpu.linalg.lobpcg import lobpcg


def main():
    f64 = jnp.zeros(()).dtype == jnp.float64
    tau = 1e-6 if f64 else 1e-4

    # --- reference example: diagonal operator, m=500 ---
    m = 500
    diag = jnp.linspace(1.0, m, m)
    t0 = time.time()
    res = lobpcg(lambda S: diag[:, None] * S, m=m, nx=10, nev=5,
                 max_iterations=m, tau=tau, key=jax.random.PRNGKey(0))
    print(f"[LOBPCG diag-500] iters={int(res.num_iterations)} "
          f"nc={int(res.num_converged)} theta={res.theta} "
          f"wall={time.time() - t0:.2f}s (true: 1..5)")

    # --- benchmark config: 10^5-dim structured SPD operator, matrix-free:
    # A = diag(spectrum) + 3-point stencil coupling, preconditioned by the
    # inverse diagonal (the scaled-up analog of the reference's fixture).
    n = 100_000
    spec = jnp.linspace(1.0, 1000.0, n)

    def A_big(S):
        up = jnp.concatenate([S[1:], jnp.zeros_like(S[:1])], axis=0)
        down = jnp.concatenate([jnp.zeros_like(S[:1]), S[:-1]], axis=0)
        return spec[:, None] * S + (2.0 * S - up - down)

    T_big = lambda S: S / spec[:, None]

    t0 = time.time()
    res = lobpcg(A_big, T=T_big, m=n, nx=16, nev=4, max_iterations=500,
                 tau=(1e-6 if f64 else 1e-4), key=jax.random.PRNGKey(1))
    print(f"[LOBPCG structured-1e5] iters={int(res.num_iterations)} "
          f"nc={int(res.num_converged)} theta={res.theta} "
          f"wall={time.time() - t0:.2f}s")


if __name__ == "__main__":
    main()
