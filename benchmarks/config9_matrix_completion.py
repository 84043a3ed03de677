"""Config 9: low-rank matrix completion on Grassmann (RTRMC-style).

Rank-10 completion of a 5000 x 4000 matrix from 10% noisy observations:
spectral initialization + Riemannian TNT over the column space, with the
inner per-column ridge least-squares batched into einsums and solved by a
fixed-sweep batched CG inside the differentiated objective
(``models/matrix_completion.py``).

Metric: wall seconds for the full solve (excluding compile).  vs_baseline =
recovery parity: 1.0 when the relative error over ALL entries (observed and
unobserved) is within 5x the observation noise.
"""

import time

import jax
import jax.numpy as jnp

from _util import emit

from optimization_tpu.models import matrix_completion as mc
from optimization_tpu.solvers import tnt


def main():
    m, n, k, frac, noise = 5000, 4000, 10, 0.10, 0.01
    M_true, data = mc.random_instance(jax.random.PRNGKey(0), m, n, k,
                                      frac=frac, noise=noise, lam=1e-8)
    U0 = mc.spectral_init(data, k)
    f32 = M_true.dtype == jnp.float32
    params = tnt.TNTParams(
        max_iterations=60, gradient_tolerance=(1e-3 if f32 else 1e-9),
        relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
        preconditioned_gradient_tolerance=0.0, max_TPCG_iterations=100)

    problem = mc.make_problem()
    jax.block_until_ready(tnt.solve(problem, U0, params, data=data))  # warm
    t0 = time.perf_counter()
    res = jax.block_until_ready(tnt.solve(problem, U0, params, data=data))
    wall = time.perf_counter() - t0

    M_hat = mc.predict(res.x, data)
    rel = float(jnp.linalg.norm(M_hat - M_true) / jnp.linalg.norm(M_true))
    outer = int(res.num_iterations)
    ok = rel < 5 * noise
    emit("matrix_completion_5kx4k_wall_s", wall,
         f"RTRMC rank-{k} {m}x{n} @ {frac:.0%} observed (noise {noise}): "
         f"{outer} TNT iters, rel-err(all entries)={rel:.2e}, "
         f"f={float(res.f):.3f}",
         1.0 if ok else 0.0)


if __name__ == "__main__":
    main()
