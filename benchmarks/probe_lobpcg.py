"""LOBPCG per-iteration latency breakdown.

Times each stage of config3's LOBPCG loop body (m=1e5, nx=16) in isolation
(chained K times inside one jit, data-dependent so nothing folds) to
locate where an iteration's time goes: the m-sized Gram and block-update
stages, or the dozens of small (3nx)^2 Rayleigh-Ritz ops around the eighs.
Every time is closed with ``jax.block_until_ready``.
"""

import time

import os
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from optimization_tpu.linalg.lobpcg import lobpcg, rayleigh_ritz

M, NX, NEV = 100_000, 16, 5
NS = 3 * NX
K = 50
DT = jnp.float32


def timeit(fn, *args, k=K, label=""):
    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    print(f"{label:36s} {best / k * 1e3:8.3f} ms/iter", flush=True)
    return best / k


def main():
    print(f"backend={jax.default_backend()} m={M} nx={NX}", flush=True)
    key = jax.random.PRNGKey(0)
    d = jnp.linspace(1.0, float(M), M, dtype=DT)
    S = jax.random.normal(key, (M, NS), DT)
    C = jax.random.normal(jax.random.PRNGKey(1), (NS, NS), DT)
    G = C @ C.T + NS * jnp.eye(NS, dtype=DT)
    G2 = 0.5 * (G + G.T)

    hp = jax.lax.Precision.HIGHEST

    # --- full real solve (reference point) ---
    @jax.jit
    def full():
        return lobpcg(lambda s: d[:, None] * s, T=lambda s: s / d[:, None],
                      m=M, nx=NX, nev=NEV, max_iterations=K, tau=1e-30,
                      key=jax.random.PRNGKey(3))

    r = full()
    jax.block_until_ready(r.X)
    iters = int(r.num_iterations)
    t0 = time.perf_counter()
    r = full()
    jax.block_until_ready(r.X)
    dt = (time.perf_counter() - t0) / max(iters, 1)
    print(f"{'FULL lobpcg iteration':36s} {dt * 1e3:8.3f} ms/iter "
          f"({iters} iters)", flush=True)

    # --- Gram stage: S'AS + S'BS ---
    @jax.jit
    def gram(S):
        def body(i, S):
            AS = d[:, None] * S
            StAS = jnp.matmul(S.T, AS, precision=hp)
            StBS = jnp.matmul(S.T, S, precision=hp)
            corr = 1e-12 * (jnp.trace(StAS) + jnp.trace(StBS))
            return S + corr
        return jax.lax.fori_loop(0, K, body, S)

    timeit(gram, S, label="gram stage (A(S), S'AS, S'BS)")

    # --- block update stage: X/AX/BX/R/P from C_x ---
    @jax.jit
    def blockup(S):
        Cx = C[:, :NX]
        th = jnp.linspace(1.0, 16.0, NX).astype(DT)

        def body(i, S):
            X = jnp.matmul(S, Cx, precision=hp)
            AS = d[:, None] * S
            AX = jnp.matmul(AS, Cx, precision=hp)
            R = AX - X * th[None, :]
            P = jnp.matmul(S[:, NX:], Cx[NX:, :], precision=hp)
            W = R / d[:, None]
            S2 = jnp.concatenate([X, W, P], axis=1)
            return S2 * (1.0 + 1e-12 * jnp.sum(th))
        return jax.lax.fori_loop(0, K, body, S)

    timeit(blockup, S, label="block updates + concat (m-sized)")

    # --- RR stage as shipped ---
    @jax.jit
    def rr_chain(G0):
        def body(i, carry):
            A_, acc = carry
            th, Cm = rayleigh_ritz(A_, G2)
            return A_ + 1e-9 * jnp.sum(th), acc + jnp.sum(Cm)
        return jax.lax.fori_loop(0, K, body, (G0, jnp.zeros((), DT)))

    timeit(rr_chain, G2 + jnp.diag(jnp.linspace(1, 48, NS).astype(DT)),
           label="rayleigh_ritz (shipped)")

    # --- single eigh 48x48 ---
    @jax.jit
    def eigh_chain(G0):
        def body(i, G0):
            w, Q = jnp.linalg.eigh(G0)
            return G0 + 1e-9 * jnp.sum(w)
        return jax.lax.fori_loop(0, K, body, G0)

    timeit(eigh_chain, G2, label="one eigh(48x48)")

    # --- pencil repair + mask + slices (small ops around RR) ---
    @jax.jit
    def repair_chain(G0):
        col = jnp.arange(NX)
        theta_all = jnp.linspace(-1.0, 48.0, NS).astype(DT)

        def body(i, G0):
            nc = jnp.asarray(3, jnp.int32)
            w_mask = col >= nc
            p_mask = w_mask
            mask_s = jnp.concatenate(
                [jnp.ones((NX,), bool), w_mask, p_mask]).astype(DT)
            off = 1.0 - mask_s
            StAS = (G0 * mask_s[:, None] * mask_s[None, :]
                    + jnp.diag(-100.0 * off))
            n_fake = (NS - jnp.sum(mask_s)).astype(jnp.int32)
            th = jax.lax.dynamic_slice(theta_all, (n_fake,), (NX,))
            Cx = jax.lax.dynamic_slice(
                StAS, (jnp.zeros((), jnp.int32), n_fake), (NS, NX))
            return G0 + 1e-9 * (jnp.sum(th) + jnp.sum(Cx))
        return jax.lax.fori_loop(0, K, body, G0)

    timeit(repair_chain, G2, label="repair+masks+dynamic slices")

    # --- candidate new RR: eigh(B) whiten + eigh(At) + argsort window ---
    @jax.jit
    def rr_new_chain(G0):
        def body(i, carry):
            A_, acc = carry
            B_ = G2
            n = NS
            eps = jnp.finfo(DT).eps
            bdiag = jnp.diagonal(B_)
            dd = 1.0 / jnp.sqrt(jnp.maximum(bdiag, eps * jnp.max(bdiag)))
            A_eq = A_ * dd[:, None] * dd[None, :]
            B_eq = B_ * dd[:, None] * dd[None, :]
            w, Q = jnp.linalg.eigh(0.5 * (B_eq + B_eq.T))
            good = w > (n * eps) * jnp.max(w)
            isw = jnp.where(good, 1.0 / jnp.sqrt(jnp.where(good, w, 1.0)), 0.0)
            Wh = Q * isw[None, :]
            At = Wh.T @ A_eq @ Wh
            At = 0.5 * (At + At.T)
            gersh = jnp.max(jnp.sum(jnp.abs(At), axis=1)) + 1.0
            At = At + jnp.diag(jnp.where(good, 0.0, gersh))
            th, U = jnp.linalg.eigh(At)
            Cm = (Wh @ U) * dd[:, None]
            # fake-energy classification + argsort windowing
            mask_rows = jnp.arange(NS) < 6
            energy = jnp.sum(jnp.where(mask_rows[:, None], Cm, 0.0) ** 2, 0)
            keyv = jnp.where(energy > 0.5, jnp.inf, th)
            order = jnp.argsort(keyv)[:NX]
            th_w = keyv[order]
            C_w = Cm[:, order]
            return (A_ + 1e-9 * jnp.sum(th_w),
                    acc + jnp.sum(C_w))
        return jax.lax.fori_loop(0, K, body, (G0, jnp.zeros((), DT)))

    with jax.default_matmul_precision("float32"):
        timeit(rr_new_chain, G2 + jnp.diag(jnp.linspace(1, 48, NS).astype(DT)),
               label="candidate RR (2 eigh + argsort)")

    # --- convergence test stage ---
    @jax.jit
    def conv_chain(S):
        def body(i, S):
            X = S[:, :NX]
            R = S[:, NX:2 * NX]
            rn = jnp.linalg.norm(R[:, :NEV], axis=0)
            xn = jnp.linalg.norm(X[:, :NEV], axis=0)
            tol = 1e-4 * (1.0 + jnp.abs(rn)) * xn
            conv = rn <= tol
            nc = jnp.sum(jnp.cumprod(conv.astype(jnp.int32)))
            return S * (1.0 + 1e-12 * nc.astype(DT))
        return jax.lax.fori_loop(0, K, body, S)

    timeit(conv_chain, S, label="convergence test (m-sized norms)")


if __name__ == "__main__":
    main()
