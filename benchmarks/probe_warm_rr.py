"""Probe: warm-started Jacobi RR vs the batched eigh at the fleet shape.

Could each lockstep Rayleigh-Ritz be seeded from the previous iteration's
Ritz rotation — one or two threshold-Jacobi sweeps on the near-diagonal
conjugated Gram instead of a full eigh (``jacobi_eigh(v0=)``)?  The
decisive number is the PER-SWEEP cost of the batched Jacobi at the config10
fleet shape (16 x 48 x 48) against the batched eigh it would replace
inside ``_rayleigh_ritz_chol``: if one sweep already costs as much as the
whole eigh, no warmth can win.

Methodology: K-chained calls inside one jit with a scalar dependence
between links (one dispatch per K calls); per-sweep cost from the
(max_sweeps=1, max_sweeps=3) difference of warm solves on near-diagonal
inputs (the warm steady state).  Times close with ``block_until_ready``.
"""

import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, __file__.rsplit("/", 1)[0])
sys.path.insert(0, __file__.rsplit("/", 2)[0])

BATCH, NMAT = 16, 48
K = 50


def timeit(fn, *args, reps=3):
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    from optimization_tpu.linalg.jacobi import jacobi_eigh

    rng = jax.random.PRNGKey(0)
    A = jax.random.normal(rng, (BATCH, NMAT, NMAT), jnp.float32)
    A = A + jnp.swapaxes(A, -1, -2)
    w0, V0 = jnp.linalg.eigh(A)         # exact seed -> near-diagonal conj

    def chain(solver):
        @jax.jit
        def run(A):
            def body(i, carry):
                A, acc = carry
                w, V = solver(A + 1e-30 * acc * jnp.eye(NMAT, dtype=A.dtype))
                return (A, 1e-30 * jnp.sum(w))
            return jax.lax.fori_loop(0, K, body, (A, jnp.zeros((),
                                                               A.dtype)))[1]
        return run

    arms = [
        ("eigh (batched)", lambda A: jnp.linalg.eigh(A)),
        ("jacobi warm 1 sweep", lambda A: jacobi_eigh(A, v0=V0,
                                                      max_sweeps=1)),
        ("jacobi warm 3 sweeps", lambda A: jacobi_eigh(A, v0=V0,
                                                       max_sweeps=3)),
        ("jacobi cold 12 sweeps", lambda A: jacobi_eigh(A)),
    ]
    results = {}
    for name, solver in arms:
        dt = timeit(chain(solver), A) / K
        results[name] = dt
        print(f"{name:24s} {dt * 1e3:7.3f} ms/call "
              f"(batch {BATCH} x {NMAT}x{NMAT})", flush=True)
    per_sweep = (results["jacobi warm 3 sweeps"]
                 - results["jacobi warm 1 sweep"]) / 2.0
    print(f"per-sweep cost {per_sweep * 1e3:.3f} ms; eigh "
          f"{results['eigh (batched)'] * 1e3:.3f} ms -> warm Jacobi "
          + ("CANNOT beat the chol-RR eigh (>= 1 sweep needed)"
             if results["jacobi warm 1 sweep"]
             > results["eigh (batched)"] else "is competitive"),
          flush=True)


if __name__ == "__main__":
    main()
