"""chip_smoke.py's phases, rehearsed on the CPU at small sizes.

The script refuses to run its device phases anywhere but a GPU; here each
phase function is called directly with a CPU device and small shapes, so
the control flow, the checks and the output format are exercised before
the card sees them.
"""

import json
import os
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "benchmarks"))

import bench  # noqa: E402
import chip_smoke  # noqa: E402
import __graft_entry__ as graft  # noqa: E402
from optimization_tpu.core import compile_cache  # noqa: E402


def test_device_phase_refuses_cpu(capsys):
    with pytest.raises(chip_smoke.SmokeFailure, match="no GPU"):
        chip_smoke.device_phase()
    assert "platform=cpu" in capsys.readouterr().out


def test_main_exits_nonzero_on_cpu(capsys):
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr().out
    assert '"ok"' not in out


class _Dev:
    platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_format(count):
    line = chip_smoke.result_line(_Dev(), count)
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": %d}}' % count)
    assert json.loads(line)["device"]["count"] == count


@pytest.fixture
def _restore_cache_dir():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_compile_cache_env_set_is_left_alone(monkeypatch, tmp_path,
                                             _restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_unset_uses_fixed_checkout_path(monkeypatch,
                                                      _restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("kind", sorted(bench.PEAKS))
def test_peak_table_known_kinds(kind):
    peaks = bench.device_peaks(kind)
    assert peaks["hbm_gbps"] > 0 and peaks["bf16_tflops"] > 0
    assert peaks["f32_tflops"] > 0


@pytest.mark.parametrize("kind", ["cpu", "Unknown accelerator", "NVIDIA A100"])
def test_peak_table_unknown_kind_raises(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        bench.device_peaks(kind)


@pytest.mark.parametrize("text, want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "500.00 W"),
      ("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("Some GPU, with comma, [N/A]", [("Some GPU, with comma", "[N/A]")]),
])
def test_parse_nvidia_smi(text, want):
    assert bench.parse_nvidia_smi(text) == want


@pytest.mark.parametrize("text", ["no separator here", ", 700 W"])
def test_parse_nvidia_smi_rejects_garbage(text):
    with pytest.raises(ValueError):
        bench.parse_nvidia_smi(text)


@pytest.mark.parametrize("body_kind", ["single", "pair"])
def test_headline_subproblem_check_small(body_kind):
    """Phase 2's reference check at n = 2^14."""
    chk = bench.subproblem_check(1 << 14, body_kind=body_kind)
    assert chk.rel_err <= chip_smoke.SUBPROBLEM_RTOL
    assert chk.flat_iterations == chk.generic_iterations > 0


def test_headline_phase_small(capsys):
    chip_smoke.headline_phase(jax.devices()[0], n=1 << 12)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("headline f32: n=2^12 outer=")
    assert out[1].startswith("headline bf16: n=2^12 outer=")
    assert out[2].startswith("subproblem f32 n=2^12")


def test_pose_phase_small(capsys):
    """Phase 3 on a 200-pose graph: two CLI solves in-process, the
    ground-truth check, and the default-vs-CPU objective check."""
    runs = chip_smoke.pose_phase(jax.devices()[0], n=200, extra=400,
                                 ref_n=100)
    assert [r["certified"] for r in runs] == [True, True]
    out = capsys.readouterr().out
    assert "pose n=200 cold: rc=0" in out
    assert "pose n=200 warm: rc=0" in out
    assert "pose n=100 reference" in out


@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_pose_cost_is_gauge_invariant_and_zero_without_noise(noise):
    """The float64 SE-Sync cost: zero at the truth of a noiseless graph,
    unchanged by a global rigid motion of the poses."""
    import numpy as np
    from config6_pose_graph_10k import synthesize
    from optimization_tpu.models import rotation_sync as rs

    graph, R, t = synthesize(n=50, extra=60, noise=noise, seed=3)
    c0 = chip_smoke.pose_cost(graph, R, t)
    if noise == 0.0:
        assert c0 < 1e-20
    G = np.asarray(rs.ROTATIONS.rand(jax.random.PRNGKey(1), 1, 3, 3))[0]
    c1 = chip_smoke.pose_cost(graph, G @ R, t @ G.T + 1.5)
    np.testing.assert_allclose(c1, c0, rtol=1e-10, atol=1e-20)


def test_check_certified_rejects_failed_solve():
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke._check_certified("x", 2, {"certified": False})
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke._check_certified("x", 0, {"certified": False})


def test_check_objective_limits_reported_vs_cost():
    """A reported objective must match the cost of the returned poses to
    within the phase's limit (the gap the stale objective once showed,
    3.7e-3, is refused)."""
    assert chip_smoke._check_objective("x", 1.1955, 1.1955) == 0.0
    assert chip_smoke._check_objective("x", 1.19547, 1.19545) < 1e-3
    with pytest.raises(chip_smoke.SmokeFailure, match="reported objective"):
        chip_smoke._check_objective("x", 1.19091, 1.19545)


@pytest.mark.parametrize("leg", graft.LEGS, ids=lambda f: f.__name__)
def test_four_device_leg(leg):
    """Each sharded leg on 4 of the 8 virtual CPU devices (the rehearsal of
    ``chip_smoke.py --four-gpus``), in f32 as on the cards; each leg asserts
    sharded == single-device."""
    with jax.enable_x64(False):
        leg(4)
