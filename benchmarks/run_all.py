"""Run every benchmark config; one JSON line each.

Usage:  python benchmarks/run_all.py [--quick]

--quick runs the sub-minute configs only (1, 2, 3, 11) — the smoke tier
for checking a chip/runtime before committing to the full ~15-minute
sweep (configs 6 and 8 each solve a large pose problem).
"""

import os
import runpy
import sys
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

CONFIGS = [
    "config1_gd_rosenbrock",
    "config2_tnt_rayleigh",
    "config3_lobpcg",
    "config4_lasso",
    "config5_rotation_sync",
    "config6_pose_graph_10k",
    "config7_bf16_tier",
    "config8_robust_se",
    "config9_matrix_completion",
    "config10_lobpcg_fleet",
    "config11_hv_roofline",
    "config12_escalation",
]

QUICK = ["config1_gd_rosenbrock", "config2_tnt_rayleigh",
         "config3_lobpcg", "config11_hv_roofline"]


def main(argv=None):
    """Run the configs; returns 1 if any of them raised, else 0."""
    argv = sys.argv[1:] if argv is None else argv
    names = QUICK if "--quick" in argv else CONFIGS
    failed = []
    for name in names:
        print(f"# {name}", file=sys.stderr, flush=True)
        try:
            runpy.run_module(name, run_name="__main__")
        except Exception:  # keep going; report every failed config
            traceback.print_exc()
            print(f"# {name} FAILED", file=sys.stderr, flush=True)
            failed.append(name)
    if failed:
        print(f"# failed configs: {', '.join(failed)}", file=sys.stderr,
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
