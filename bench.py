"""Headline benchmark: TNT trust-region CG throughput at n = 2^24.

BASELINE config 2 at scale: Riemannian TNT (Rayleigh-quotient minimization)
on S^{n-1}, n = 2^24, with the SPD operator A = diag(1 + b*i) (the
reference's LinSpaced diagonal fixtures, ``LOBPCG_unit_test.cpp:52-75``,
scaled up; the diagonal is generated on the fly, so the Hessian application
is a pure elementwise map).

Engine: the trust-region subproblem runs in the single-synchronization
flat CG (``linalg/flat_cg.py``).  Chronopoulos-Gear recurrences and the
structured sphere Hessian  P H P = A0 + U B U'  make each CG iteration one
fused memory pass with one reduction (q = Hp and y = 2Ax are recomputed
elementwise in-pass), two iterations per loop body by default (the pair
body, ``stpcg_flat(body_kind=)``).

Two tiers at the same fixed effort (30 outer iterations, at most 50 CG
iterations each): f32 storage, and bf16 storage with every reduction and
trust-region scalar in f32.

Prints exactly ONE JSON line  {"metric": ..., "value": ..., "unit": ...}:
the bf16 tier's CG iterations per second of warm wall time (compile
excluded, outer-iteration overhead included).  The unit string names the
device (platform, kind, count, power limit) and carries the f32 tier.
"""

import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

# Published peaks keyed by ``jax.Device.device_kind``.  Source: NVIDIA H100
# SXM data sheet (dense rates without sparsity, at the 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "bf16_tflops": 989.0,
                              "f32_tflops": 67.0},
}


def device_peaks(kind=None):
    """Published peaks of ``kind`` (default: the first JAX device).  A device
    without a row is an error, never a default."""
    if kind is None:
        kind = jax.devices()[0].device_kind
    try:
        return PEAKS[kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {kind!r}; add a row to "
            f"bench.PEAKS with its source") from None


def parse_nvidia_smi(text):
    """``[(name, power_limit), ...]`` from the output of
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``."""
    cards = []
    for line in text.strip().splitlines():
        name, sep, limit = line.rpartition(",")
        if not sep or not name.strip():
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((name.strip(), limit.strip()))
    return cards


def query_cards():
    """The cards' names and power limits, read by ``nvidia-smi`` in a child
    process (which stays off JAX and the device)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return parse_nvidia_smi(out.stdout)


def device_label():
    """Platform, kind, count and power limit of the devices JAX sees (no
    power limit where ``nvidia-smi`` is absent, as on a CPU host)."""
    devs = jax.devices()
    try:
        limits = ",".join(sorted({lim for _, lim in query_cards()}))
    except FileNotFoundError:
        limits = "not reported"
    return (f"platform={devs[0].platform} kind={devs[0].device_kind} "
            f"count={len(devs)} power_limit={limits}")


class Tier(NamedTuple):
    outer: int
    inner: int
    seconds: float          # warm wall time, closed with block_until_ready
    fstar: float            # achieved objective (exact optimum 1.0)

    @property
    def cg_per_s(self):
        return self.inner / self.seconds if self.seconds > 0 else 0.0


def run_tier(n, dtype, grad_tol, max_tpcg=50, body_kind=None, reps=1):
    """A warm TNT solve of the headline config in the given storage dtype
    (a first solve from another start compiles and warms); the best wall
    of ``reps`` timed solves.

    The outer iteration runs through the fused trial-step evaluator
    (``sphere_rayleigh_step`` -> ``RiemannianProblem.step_eval``): the
    retraction, trial objective, trial gradient and the next subproblem's
    pre-loop dot group come from one pass.  ``body_kind`` (``"single"`` or
    ``"pair"``) pins the flat engine's loop body through TNT's
    ``flat_solve`` seam (how the bodies are compared inside the solve);
    None runs TNT's own flat branch, with the engine's default body.
    """
    from optimization_tpu import RiemannianProblem
    from optimization_tpu.linalg.flat_cg import (sphere_rayleigh_flat,
                                                 sphere_rayleigh_step,
                                                 stpcg_flat)
    from optimization_tpu.manifolds import sphere
    from optimization_tpu.solvers import tnt

    b = 999.0 / (n - 1)
    M = sphere()

    def A_elem(v):
        # affine diagonal 1..1000 regenerated on the fly, f32 accumulate
        i = jax.lax.iota(jnp.float32, n)
        return (1.0 + b * i) * v.astype(jnp.float32)

    def f(x, dd):
        return jnp.dot(x.astype(jnp.float32), A_elem(x))

    def grad(x, dd):
        return M.proj(x, (2.0 * A_elem(x)).astype(dtype))

    def flat_qm(x, dd, aux=None):
        # aux arrives as the step_eval carry: the trial Rayleigh quotient
        # plus the flat engine's pre-loop dot group, both computed inside
        # the trial-evaluation pass.
        rq = aux.rq if aux is not None else None
        A0, U, B, _ = sphere_rayleigh_flat(x, A_elem, rq=rq)
        return A0, U, B, (aux.init if aux is not None else None)

    flat_solve = None
    if body_kind is not None:
        def flat_solve(g, x, dd, aux, Delta, params):
            A0, U, B, init = flat_qm(x, dd, aux)
            return stpcg_flat(g, A0, U, B, Delta,
                              max_iterations=params.max_TPCG_iterations,
                              kappa_fgr=params.kappa_fgr, theta=params.theta,
                              init=init, body_kind=body_kind)

    problem = RiemannianProblem(f=f, manifold=M, grad=grad, flat_qm=flat_qm,
                                flat_solve=flat_solve,
                                step_eval=sphere_rayleigh_step(A_elem))
    params = tnt.TNTParams(
        max_iterations=30, max_TPCG_iterations=max_tpcg,
        gradient_tolerance=grad_tol, relative_decrease_tolerance=0.0,
        stepsize_tolerance=0.0, preconditioned_gradient_tolerance=0.0)

    x0 = M.rand(jax.random.PRNGKey(2), n).astype(dtype)
    jax.block_until_ready(tnt.solve(problem, x0, params, data=None))
    x1 = M.rand(jax.random.PRNGKey(3), n).astype(dtype)
    jax.block_until_ready(x1)
    dt = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        res = jax.block_until_ready(tnt.solve(problem, x1, params, data=None))
        dt = min(dt, time.perf_counter() - t0)

    outer = int(res.num_iterations)
    inner = int(jnp.sum(jnp.where(
        jnp.arange(params.max_iterations) < outer, res.inner_iterations, 0)))
    return Tier(outer=outer, inner=inner, seconds=dt, fstar=float(res.f))


class SubproblemCheck(NamedTuple):
    rel_err: float          # |s_flat - s_generic| / |s_generic|
    flat_iterations: int
    generic_iterations: int


def subproblem_check(n, Delta=1e6, max_iterations=50, body_kind="pair"):
    """One trust-region subproblem of the headline problem (f32), solved by
    the flat engine (``stpcg_flat``) and by the generic ``stpcg`` on the
    projected Hessian  v -> P(2Av) - rq v  at the same (g, x, Delta).

    x is proportional to 1/diag(A), a point near the bottom of the spectrum
    like the ones the headline solve visits, where the subproblem runs many
    CG iterations before it truncates or meets negative curvature."""
    from optimization_tpu.linalg.flat_cg import (sphere_rayleigh_flat,
                                                 stpcg_flat)
    from optimization_tpu.linalg.stpcg import stpcg

    b = 999.0 / (n - 1)

    def A_elem(v):
        i = jax.lax.iota(jnp.float32, n)
        return (1.0 + b * i) * v.astype(jnp.float32)

    x = 1.0 / A_elem(jnp.ones(n, jnp.float32))
    x = x / jnp.linalg.norm(x)
    # a reduce-sum, not jnp.dot: XLA's CPU dot accumulates f32 in order,
    # with an error that grows with n, which a tree reduction does not
    dot = lambda u, v: jnp.sum(u * v)
    proj = lambda v: v - dot(x, v) * x
    g = proj(2.0 * A_elem(x))
    kw = dict(max_iterations=max_iterations, kappa_fgr=0.1, theta=0.5)

    @jax.jit
    def flat(g, x):
        A0, U, B, _ = sphere_rayleigh_flat(x, A_elem)
        return stpcg_flat(g, A0, U, B, Delta, body_kind=body_kind, **kw)

    @jax.jit
    def generic(g, x):
        rq = dot(x, 2.0 * A_elem(x))
        Hv = lambda v: proj(2.0 * A_elem(v)) - rq * v
        return stpcg(g, Hv, dot, Delta, **kw)

    rf, rg = flat(g, x), generic(g, x)
    err = jnp.linalg.norm(rf.s - rg.s) / jnp.linalg.norm(rg.s)
    return SubproblemCheck(rel_err=float(err),
                           flat_iterations=int(rf.num_iterations),
                           generic_iterations=int(rg.num_iterations))


def words_per_cg(body):
    """n-vector words one CG iteration of the flat engine moves through
    device memory: the single-iteration body reads s/r/p/x and writes s/r/p
    (7n); the pair body defers the s update across two iterations (6n on
    average).  x is re-read on every pass: nothing stays on chip between
    passes."""
    return {"single": 7, "pair": 6}[body]


def main():
    from optimization_tpu.core.compile_cache import enable_compile_cache

    enable_compile_cache()
    n = 1 << 24
    label = device_label()
    hbm = device_peaks()["hbm_gbps"]
    # f32 storage tier; 1e-5 is unreachable in 30 outer iterations on this
    # kappa = 1000 problem, so both tiers run the same fixed effort.
    f32 = run_tier(n, jnp.float32, 1e-5)
    bf16 = run_tier(n, jnp.bfloat16, 0.0)

    def gbps(t, dtype):
        w = words_per_cg("pair")         # stpcg_flat's default body
        return w, w * n * jnp.dtype(dtype).itemsize * t.cg_per_s / 1e9

    w16, g16 = gbps(bf16, jnp.bfloat16)
    w32, g32 = gbps(f32, jnp.float32)
    print(json.dumps({
        "metric": "tnt_flat_cg_iters_per_s_bf16",
        "value": round(bf16.cg_per_s, 1),
        "unit": (f"CG iterations/s, TNT Rayleigh quotient on S^(2^24-1), "
                 f"bf16 storage / f32 accumulate ({label}); {bf16.outer} "
                 f"outer / {bf16.inner} cg in {bf16.seconds:.3f}s; "
                 f"~{w16}n bf16 words/iter -> {g16:.0f} GB/s = "
                 f"{g16 / hbm:.3f} of {hbm:.0f} GB/s published HBM; "
                 f"f*={bf16.fstar:.4f} (exact 1.0); f32 tier: "
                 f"{f32.cg_per_s:.0f} cg it/s ({f32.outer} outer / "
                 f"{f32.inner} cg in {f32.seconds:.3f}s, ~{w32}n words/iter "
                 f"-> {g32:.0f} GB/s = {g32 / hbm:.3f} of published HBM, "
                 f"f*={f32.fstar:.4f})"),
    }))


if __name__ == "__main__":
    main()
