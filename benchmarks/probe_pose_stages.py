"""Stage-split of config6's certified 10^4-pose pipeline.

config6 reports one end-to-end wall, but the pipeline has five stages —
g2o load, spectral init, marginalized TNT, LSQR translations, LOBPCG dual
certificate.  This probe times each stage twice (cold = first call incl.
compile, warm = second call on the same shapes) so optimization effort
goes where the warm seconds actually are.

Stages mirror ``pose_sync.solve_pose_graph(marginalized=True,
certify=True)`` exactly (same data, dtype, params, default
scatter_method), so stage sums reconcile against config6's wall.  Every
certificate operator application contains the nested Laplacian CG solve,
which is why the certificate arms (eigh RR, chol RR, loose projector) are
timed separately.  Not measured on the H100 yet.

Usage: ``python benchmarks/probe_pose_stages.py [cert_fast]``
(``cert_fast`` adds a second certificate timing with the one-eigh
shifted-Cholesky RR — ``solve_pose_graph(cert_fast=True)``).
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

from config6_pose_graph_10k import synthesize
from optimization_tpu.io import g2o
from optimization_tpu.models import pose_sync, rotation_sync as rs
from optimization_tpu.solvers import tnt


def stage(name, fn, reps=2):
    outs, times = None, []
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = fn()
        jax.block_until_ready(outs)
        times.append(time.perf_counter() - t0)
    cold, warm = times[0], min(times[1:]) if len(times) > 1 else times[0]
    print(f"{name:28s} cold {cold:7.2f} s   warm {warm:7.2f} s", flush=True)
    return outs


def main():
    n, noise = 10_000, 0.01
    graph, R_true, t_true = synthesize(n=n, noise=noise)
    print(f"backend={jax.default_backend()} n={n} E={len(graph.src)}",
          flush=True)

    import os
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pose10k.g2o")
        g2o.save_g2o(path, graph)
        t0 = time.perf_counter()
        loaded = g2o.load_g2o(path)
        print(f"{'g2o load (native)':28s} cold {time.perf_counter()-t0:7.2f} s",
              flush=True)

    dtype = jnp.float32
    src = jnp.asarray(loaded.src)
    dst = jnp.asarray(loaded.dst)
    Mij = jnp.asarray(loaded.Rij, dtype)
    tij = jnp.asarray(loaded.tij, dtype)

    problem, Q_op, nn = pose_sync.marginalized_problem(
        src, dst, Mij, tij, n=loaded.n_vertices)
    rot_data = pose_sync._transposed_rotation_data(src, dst, Mij, None)

    Q0 = stage("spectral init",
               lambda: rs.spectral_init(rot_data, nn, 3).astype(dtype))

    params = tnt.TNTParams(
        max_iterations=100, gradient_tolerance=2e-3,
        relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
        preconditioned_gradient_tolerance=0.0)
    rres = stage("marginalized TNT", lambda: tnt.solve(problem, Q0, params))
    outer = int(rres.num_iterations)
    inner = int(np.sum(np.asarray(rres.inner_iterations)[:outer]))
    print(f"{'':28s} ({outer} outer / {inner} cg, status "
          f"{int(rres.status)})", flush=True)
    R = jnp.swapaxes(rres.x, -1, -2)

    stage("LSQR translations",
          lambda: pose_sync.recover_translations(R, src, dst, tij))

    cert = stage("certificate (chol RR)",
                 lambda: rs.certify(rres.x, rot_data, operator=Q_op,
                                    rr_method="chol"))
    print(f"{'':28s} certified={bool(cert.certified)} "
          f"lam_min={float(cert.lam_min):.2e} "
          f"iters={int(cert.num_iterations)}", flush=True)

    # The production path: the certificate
    # operator's nested projector CG runs LOOSE (rtol 1e-4, cap 60 vs the
    # optimizer's 50 eps / 400) — the lam_min sign decision carries
    # eta ~ 1.2e-4 |L| of slack in f32, decision parity pinned by
    # tests/test_pose_sync.py.
    _, Q_loose, _ = pose_sync.marginalized_problem(
        src, dst, Mij, tij, n=loaded.n_vertices,
        cg_iterations=60, cg_rtol=1e-4)
    cert3 = stage("certificate (chol RR loose)",
                  lambda: rs.certify(rres.x, rot_data, operator=Q_loose,
                                     rr_method="chol"))
    print(f"{'':28s} certified={bool(cert3.certified)} "
          f"lam_min={float(cert3.lam_min):.2e} "
          f"iters={int(cert3.num_iterations)}", flush=True)

    if len(sys.argv) > 1 and sys.argv[1] == "cert_eigh":
        cert2 = stage("certificate (eigh RR)",
                      lambda: rs.certify(rres.x, rot_data, operator=Q_op))
        print(f"{'':28s} certified={bool(cert2.certified)} "
              f"lam_min={float(cert2.lam_min):.2e} "
              f"iters={int(cert2.num_iterations)}", flush=True)


if __name__ == "__main__":
    main()
