"""Shared benchmark harness utilities."""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# Single source of truth for the device peaks table
from bench import device_label, device_peaks  # noqa: F401

from optimization_tpu.core.compile_cache import enable_compile_cache
from optimization_tpu.core.profiling import time_fn

enable_compile_cache()


def timeit(fn, iters=10, warmup=1):
    """Warmup-then-average wall timing (delegates to core.profiling)."""
    return time_fn(fn, iters=iters, warmup=warmup)


def emit(metric, value, unit, vs_baseline):
    print(json.dumps({
        "metric": metric,
        "value": round(float(value), 6),
        "unit": unit,
        "vs_baseline": round(float(vs_baseline), 4),
    }))


def best_time(fn, *args, reps=3):
    """Compile/warm once, then best-of-``reps`` wall seconds per call, each
    closed with ``jax.block_until_ready``."""
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best
