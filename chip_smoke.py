"""Smoke run of the solver suite on an NVIDIA GPU.

    python chip_smoke.py              # one card: phases 1-5 below
    python chip_smoke.py --four-gpus  # four cards: the sharded legs only

One process, on whatever JAX sees; it refuses to run anywhere but a GPU.
Phases, in order, each printing its own lines:

1. device: JAX's platform, kind and count; every card's name and power
   limit from ``nvidia-smi``; the compile-cache directory.
2. headline engine: ``bench.run_tier`` at n = 2^24 in f32 and bf16 storage
   (TNT with the flat CG subproblem engine), then one subproblem solved by
   the flat engine and by the generic ``stpcg`` at the same (g, x, Delta).
3. certified pose-graph solve through the CLI, in-process, cold then warm:
   a 10^4-pose / ~3x10^4-edge SE(3) graph (the city10000 class of the
   SE-Sync benchmark) made from a seed, checked against its ground truth;
   then a 10^3-pose graph solved on the GPU at the default matmul precision
   and on the CPU device at "highest", whose reported objectives must agree,
   as must the SE-Sync costs of their solutions (evaluated in float64 by
   numpy, :func:`pose_cost`); every reported objective must also match the
   cost of the poses it came with.
4. the tests marked ``gpu``, run in this process on the card.
5. the last line: ``{"ok": true, "device": {...}}``.

Any failed check ends the run with a non-zero exit before the last line.
``--four-gpus`` runs only ``__graft_entry__.dryrun_multichip`` on a 4-GPU
mesh: the seven sharded legs at the default matmul precision, each compared
with its single-device result.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import io
import json
import math
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.join(HERE, "benchmarks"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

HEADLINE_N = 1 << 24
SUBPROBLEM_RTOL = 1e-3      # f32 sums over 1.7e7 elements in another order
POSE_N, POSE_EXTRA, POSE_NOISE = 10_000, 20_000, 0.01
REF_POSE_N = 1_000
OBJECTIVE_RTOL = 1e-3


class SmokeFailure(RuntimeError):
    """A phase's check failed."""


def _require(ok, message):
    if not ok:
        raise SmokeFailure(message)


def _peak_bytes(device):
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not reported")


def device_phase(n_devices=1):
    """Phase 1.  Returns JAX's first device; raises unless it is a GPU and
    JAX sees at least ``n_devices`` of them."""
    devs = jax.devices()
    d0 = devs[0]
    print(f"device: platform={d0.platform} kind={d0.device_kind} "
          f"count={len(devs)}", flush=True)
    _require(d0.platform == "gpu",
             f"no GPU: JAX's first device is on {d0.platform!r}")
    _require(len(devs) >= n_devices,
             f"need {n_devices} GPUs, JAX sees {len(devs)}")

    import bench
    from optimization_tpu.core.compile_cache import enable_compile_cache

    for name, limit in bench.query_cards():
        print(f"nvidia-smi: {name}, {limit}", flush=True)
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    return d0


def headline_phase(device, n=HEADLINE_N):
    """Phase 2: both storage tiers of the headline TNT solve, then the
    flat-vs-generic subproblem check."""
    import bench

    log2n = int(math.log2(n))
    for name, dtype, tol in (("f32", jnp.float32, 1e-5),
                             ("bf16", jnp.bfloat16, 0.0)):
        t = bench.run_tier(n, dtype, tol)
        print(f"headline {name}: n=2^{log2n} outer={t.outer} cg={t.inner} "
              f"warm_s={t.seconds:.6f} cg_per_s={t.cg_per_s:.1f} "
              f"f*={t.fstar:.6f} (exact 1.0) "
              f"peak_bytes_in_use={_peak_bytes(device)}", flush=True)
        _require(math.isfinite(t.fstar) and t.outer > 0,
                 f"headline {name}: f*={t.fstar} after {t.outer} outer")

    chk = bench.subproblem_check(n)
    print(f"subproblem f32 n=2^{log2n}: flat vs generic stpcg "
          f"rel_err={chk.rel_err:.3e} (limit {SUBPROBLEM_RTOL:g}) "
          f"iterations flat={chk.flat_iterations} "
          f"generic={chk.generic_iterations}", flush=True)
    _require(chk.rel_err <= SUBPROBLEM_RTOL,
             f"flat engine disagrees with stpcg: {chk.rel_err:.3e}")
    _require(abs(chk.flat_iterations - chk.generic_iterations) <= 2,
             "flat and generic iteration counts differ by more than 2")


def cli_solve(path, out):
    """``python -m optimization_tpu solve <path> --marginalized --certify``
    through ``cli.main`` in this process.  Returns (exit code, summary)."""
    from optimization_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["solve", path, "--marginalized", "--certify",
                       "--json", "--out", out])
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else {})


def _write_graph(tmp, n, extra, noise, seed):
    from config6_pose_graph_10k import synthesize
    from optimization_tpu.io import g2o

    graph, R_true, t_true = synthesize(n=n, extra=extra, noise=noise,
                                       seed=seed)
    path = os.path.join(tmp, f"pose{n}.g2o")
    g2o.save_g2o(path, graph)
    return path, graph, R_true, t_true


def pose_cost(graph, R, t):
    """The SE-Sync cost of poses (R, t) with unit weights, in float64 numpy:
    sum over edges of |R_i M_ij - R_j|_F^2 + |R_i t_ij - (t_j - t_i)|^2.
    A plain reference, independent of the device and of the solver's own
    f32 evaluation."""
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)
    s, d = graph.src, graph.dst
    rot = np.sum((R[s] @ np.asarray(graph.Rij, np.float64) - R[d]) ** 2)
    tr = np.einsum("eij,ej->ei", R[s], np.asarray(graph.tij, np.float64))
    return float(rot + np.sum((tr - (t[d] - t[s])) ** 2))


def _check_certified(tag, rc, summary):
    _require(rc == 0 and summary.get("certified") is True,
             f"{tag}: exit code {rc}, summary {summary}")


def _rel(a, b):
    return abs(a - b) / abs(b)


def _check_objective(tag, objective, cost):
    """The objective the CLI reports is the SE-Sync cost of the poses it
    returns (the marginalized objective at the returned rotations equals
    the cost at their optimal translations)."""
    rel = _rel(objective, cost)
    _require(rel <= OBJECTIVE_RTOL,
             f"{tag}: reported objective {objective:.8e} vs cost of the "
             f"returned poses {cost:.8e}, rel_diff {rel:.3e}")
    return rel


def pose_phase(device, n=POSE_N, extra=POSE_EXTRA, noise=POSE_NOISE,
               ref_n=REF_POSE_N, seed=0):
    """Phase 3: the certified pose-graph CLI solve, cold then warm, against
    the ground truth; then the GPU-vs-CPU objective and cost check at
    ``ref_n``."""
    from optimization_tpu.models import pose_sync

    with tempfile.TemporaryDirectory() as tmp:
        path, graph, R_true, t_true = _write_graph(tmp, n, extra, noise,
                                                   seed)
        out = os.path.join(tmp, "sol.npz")
        runs = []
        for tag in ("cold", "warm"):
            t0 = time.perf_counter()
            rc, summary = cli_solve(path, out)
            wall = time.perf_counter() - t0
            _check_certified(f"pose {tag}", rc, summary)
            runs.append(summary)
            print(f"pose n={n} {tag}: rc={rc} edges={summary['n_edges']} "
                  f"loader={summary['loader']} load_s={summary['load_s']} "
                  f"solve_s={summary['solve_s']} call_s={wall:.3f} "
                  f"status={summary['status']} "
                  f"tnt_iterations={summary['tnt_iterations']} "
                  f"certificate_iterations="
                  f"{summary['certificate_iterations']} "
                  f"certified={summary['certified']} "
                  f"objective={summary['objective']:.6e} "
                  f"peak_bytes_in_use={_peak_bytes(device)}", flush=True)
        sol = np.load(out)              # the warm run's solution
        rot_err, t_err = pose_sync.alignment_errors(
            jnp.asarray(sol["R"]), jnp.asarray(sol["t"]),
            jnp.asarray(R_true, jnp.float32),
            jnp.asarray(t_true, jnp.float32))
        cost = pose_cost(graph, sol["R"], sol["t"])
        print(f"pose n={n} accuracy: rot_err={float(rot_err):.5f} "
              f"(limit {4 * noise:g}) t_err={float(t_err):.5f} "
              f"cost={cost:.8e} (ground truth "
              f"{pose_cost(graph, R_true, t_true):.8e}) objective vs cost "
              f"rel_diff={_rel(runs[-1]['objective'], cost):.3e} "
              f"(limit {OBJECTIVE_RTOL:g})", flush=True)
        _require(float(rot_err) < 4 * noise,
                 f"rotation error {float(rot_err):.5f} >= {4 * noise:g}")
        _check_objective(f"pose n={n} warm", runs[-1]["objective"], cost)

        ref_path, ref_graph, _, _ = _write_graph(tmp, ref_n, 2 * ref_n,
                                                 noise, seed)
        objectives, costs = {}, {}
        for where in ("default", "cpu"):
            ref_out = os.path.join(tmp, f"ref_{where}.npz")
            if where == "default":
                rc, summary = cli_solve(ref_path, ref_out)
            else:
                with jax.default_device(jax.devices("cpu")[0]), \
                        jax.default_matmul_precision("highest"):
                    rc, summary = cli_solve(ref_path, ref_out)
            _check_certified(f"pose n={ref_n} {where}", rc, summary)
            sol = np.load(ref_out)
            objectives[where] = summary["objective"]
            costs[where] = pose_cost(ref_graph, sol["R"], sol["t"])
            print(f"pose n={ref_n} on {where} device: "
                  f"objective={objectives[where]:.8e} "
                  f"cost={costs[where]:.8e} objective vs cost rel_diff="
                  f"{_rel(objectives[where], costs[where]):.3e} "
                  f"certified={summary['certified']}", flush=True)
            _check_objective(f"pose n={ref_n} {where}", objectives[where],
                             costs[where])
        rel_obj = _rel(objectives["default"], objectives["cpu"])
        rel_cost = _rel(costs["default"], costs["cpu"])
        print(f"pose n={ref_n} reference: {device.platform} default "
              f"precision vs cpu highest: objective rel_diff={rel_obj:.3e} "
              f"cost rel_diff={rel_cost:.3e} (limit {OBJECTIVE_RTOL:g})",
              flush=True)
        _require(rel_obj <= OBJECTIVE_RTOL,
                 f"default-device and CPU objectives differ by {rel_obj:.3e}")
        _require(rel_cost <= OBJECTIVE_RTOL,
                 f"default-device and CPU costs differ by {rel_cost:.3e}")
    return runs


class _GpuTestReport:
    """pytest plugin: outcome and device platform of each test."""

    def __init__(self):
        self.rows = []

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            props = dict(report.user_properties)
            self.rows.append((report.nodeid, report.when, report.outcome,
                              props.get("platform", "-")))


def gpu_tests_phase():
    """Phase 4: the ``gpu``-marked tests, in this process, on the card
    (``OPTTPU_TEST_DEVICE=gpu`` keeps tests/conftest.py off its CPU pin)."""
    import pytest

    os.environ["OPTTPU_TEST_DEVICE"] = "gpu"
    report = _GpuTestReport()
    rc = pytest.main([os.path.join(HERE, "tests"), "-m", "gpu", "-q",
                      "-p", "no:cacheprovider", "-p", "no:randomly"],
                     plugins=[report])
    for nodeid, when, outcome, platform in report.rows:
        print(f"gpu test: {nodeid} [{when}] {outcome} platform={platform}",
              flush=True)
    if rc == pytest.ExitCode.NO_TESTS_COLLECTED:
        print("gpu tests: none marked gpu", flush=True)
        return
    _require(rc == pytest.ExitCode.OK, f"gpu tests: pytest exit code {rc}")
    bad = [r for r in report.rows if r[2] != "passed" or r[3] != "gpu"]
    _require(not bad, f"gpu tests not passed on a GPU: {bad}")


def result_line(device, count):
    """The last line of a successful run."""
    return json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": count}})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the sharded legs, on 4 GPUs")
    args = ap.parse_args(argv)
    try:
        if args.four_gpus:
            import __graft_entry__ as ge

            device = device_phase(n_devices=4)
            # each leg asserts agreement with its single-device result; a
            # failed assertion ends the run with a non-zero exit
            ge.dryrun_multichip(4)
            count = 4
        else:
            device = device_phase()
            headline_phase(device)
            pose_phase(device)
            gpu_tests_phase()
            count = len(jax.devices())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(result_line(device, count), flush=True)
    return 0


if __name__ == "__main__":
    faulthandler.enable()        # a crash in native code prints the stack
    sys.exit(main())
