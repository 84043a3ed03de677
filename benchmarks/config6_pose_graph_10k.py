"""Config 6: end-to-end certifiable SE(3) pose graph at n = 10^4 poses.

The full production pipeline on one chip: synthesize a 10^4-pose / ~3x10^4-
edge SE(3) pose graph, round-trip it through the g2o writer and the *native
C++ loader* (optimization_tpu.io.g2o), solve the translation-marginalized
single-stage SE-Sync objective with Riemannian TNT (Jacobi-preconditioned
inner Laplacian CG), recover translations with LSQR, and check the SE-Sync
dual certificate with LOBPCG.

Metric: end-to-end certified-solve wall seconds (excluding file synthesis;
INCLUDING the first-call compiles — this is the cold single-shot
production path).  ``benchmarks/probe_pose_stages.py`` splits it by stage.
vs_baseline = quality parity: 1.0 when the gauge-aligned rotation error is
at the injected noise floor AND the solution certifies as a global optimum
of the relaxation.
"""

import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from _util import emit

from optimization_tpu.io import g2o
from optimization_tpu.models import pose_sync, rotation_sync as rs


def synthesize(n=10_000, extra=20_000, noise=0.01, seed=0):
    """(graph, R_true, t_true): a random SE(3) pose graph, a spanning path
    plus ``extra`` random edges, with rotation and translation noise of
    scale ``noise``.  Products run at full f32 precision on every device,
    so the ground truth does not depend on where it was made."""
    hi = jax.lax.Precision.HIGHEST
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    # f64 where jax_enable_x64 is on, else f32
    wide = jax.dtypes.canonicalize_dtype(jnp.float64)
    R_true = rs.ROTATIONS.rand(key, n, 3, 3).astype(wide)
    t_true = jnp.asarray(rng.normal(size=(n, 3)) * 5.0)

    src = np.concatenate([np.arange(n - 1), rng.integers(0, n, extra)])
    dst = np.concatenate([np.arange(1, n), rng.integers(0, n, extra)])
    keep = src != dst
    src = jnp.asarray(src[keep], jnp.int32)
    dst = jnp.asarray(dst[keep], jnp.int32)
    E = src.shape[0]

    Rt = jnp.swapaxes(R_true, -1, -2)
    Mij = jnp.einsum("eij,ejk->eik", Rt[src], R_true[dst], precision=hi)
    tij = jnp.einsum("eij,ej->ei", Rt[src], t_true[dst] - t_true[src],
                     precision=hi)
    w = noise * jnp.asarray(rng.normal(size=(E, 3, 3)))
    skew = 0.5 * (w - jnp.swapaxes(w, -1, -2))
    pert = rs._orthonormalize(
        jnp.eye(3) + skew + 0.5 * jnp.matmul(skew, skew, precision=hi))
    Mij = jnp.matmul(pert, Mij, precision=hi)
    tij = tij + noise * jnp.asarray(rng.normal(size=(E, 3)))

    graph = g2o.PoseGraph(
        n_vertices=n, dim=3, src=np.asarray(src), dst=np.asarray(dst),
        Rij=np.asarray(Mij), tij=np.asarray(tij), kappa=None)
    return graph, np.asarray(R_true), np.asarray(t_true)


def main():
    n, noise = 10_000, 0.01
    graph, R_true, t_true = synthesize(n=n, noise=noise)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pose10k.g2o")
        g2o.save_g2o(path, graph)
        t0 = time.perf_counter()
        loaded = g2o.load_g2o(path)
        t_load = time.perf_counter() - t0
        native = g2o.native_available()

    assert loaded.n_vertices == n and len(loaded.src) == len(graph.src)

    # OPTTPU_SCATTER selects the edge->vertex accumulation strategy of the
    # marginalized operator (models/graph.edge_accumulator) for A/B runs;
    # the committed default follows the measured probe_scatter verdict.
    scatter_method = os.environ.get("OPTTPU_SCATTER", "scatter")
    t0 = time.perf_counter()
    res = pose_sync.solve_pose_graph(loaded, dtype=jnp.float32,
                                     marginalized=True, certify=True,
                                     scatter_method=scatter_method)
    jax.block_until_ready(res.t)
    wall = time.perf_counter() - t0

    rot_err, t_err = pose_sync.alignment_errors(
        res.R.astype(jnp.float64), res.t.astype(jnp.float64),
        jnp.asarray(R_true), jnp.asarray(t_true))
    cert = res.certificate
    outer = int(res.rotation_result.num_iterations)
    inner = int(np.sum(np.asarray(res.rotation_result.inner_iterations)
                       [:outer]))
    # quality parity: rotation error at the noise floor (the mean chordal
    # error of the measurements themselves is ~noise*sqrt(2)) + certificate
    ok = (float(rot_err) < 4 * noise) and bool(cert.certified)
    emit("pose_graph_10k_certified_wall_s", wall,
         f"E2E marginalized SE-Sync solve+certificate, n=10^4 poses, "
         f"E={len(loaded.src)} (g2o via {'native' if native else 'python'} "
         f"loader, {t_load * 1e3:.0f} ms, scatter={scatter_method}); "
         f"TNT {outer} outer/{inner} cg; "
         f"rot_err={float(rot_err):.4f} (noise {noise}), "
         f"t_err={float(t_err):.4f}, certified={bool(cert.certified)}, "
         f"lam_min={float(cert.lam_min):.2e}, "
         f"cert_iters={int(cert.num_iterations)}",
         1.0 if ok else 0.0)


if __name__ == "__main__":
    main()
