"""Checks that only mean something on the card: engines compiled for the GPU
against their plain references, at the GPU's default matmul precision.

Every test takes the ``gpu_device`` fixture, so it skips on the CPU and runs
in phase 4 of ``chip_smoke.py``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("body_kind", ["single", "pair"])
def test_flat_engine_matches_generic_on_gpu(gpu_device, body_kind):
    """Both flat-engine loop bodies against generic STPCG in f32 at 2^22."""
    import bench

    chk = bench.subproblem_check(1 << 22, body_kind=body_kind)
    assert chk.rel_err <= 1e-3, chk
    assert abs(chk.flat_iterations - chk.generic_iterations) <= 2, chk


def test_bf16_tier_marches_to_optimum_on_gpu(gpu_device):
    """The bf16-storage headline tier at 2^20: bf16 iterates, f32 scalars,
    the Rayleigh quotient driven near its minimum 1.0."""
    import bench

    t = bench.run_tier(1 << 20, jnp.bfloat16, 0.0)
    assert t.outer > 0 and t.inner > 0
    assert 1.0 <= t.fstar < 1.1, t


def test_chordal_rotation_sync_certifies_at_default_precision(gpu_device):
    """Chordal rotation sync through the pose pipeline certifies at the
    GPU's default matmul precision (every block product is pinned to
    HIGHEST, so TF32 never reaches the gain ratios or the certificate)."""
    from optimization_tpu.io import g2o
    from optimization_tpu.models import pose_sync, rotation_sync as rs

    R_true, data = rs.random_instance(jax.random.PRNGKey(0), 300, 3,
                                      extra_edges=600, noise=0.02)
    graph = g2o.PoseGraph(
        n_vertices=300, dim=3, src=np.asarray(data.src),
        dst=np.asarray(data.dst),
        Rij=np.asarray(data.Rij),
        tij=np.zeros((data.src.shape[0], 3), np.float32), kappa=None)
    res = pose_sync.solve_pose_graph(graph, certify=True)
    assert bool(res.certificate.certified)
    err = rs.mean_rotation_error(jnp.swapaxes(res.R, -1, -2), R_true)
    assert float(err) < 0.1
