"""Kernel-level profiling hooks (SURVEY.md section 5: tracing/profiling).

The reference samples a wall clock per outer iteration
(``Util/Stopwatch.h``); per-iteration times live in ``result.times`` via the
host-chunked driver.  For *kernel-level* timing the tool is the XLA
profiler: these helpers wrap ``jax.profiler`` so a solve can be traced
and inspected (TensorBoard / xprof) or coarsely timed without one-off
boilerplate.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Iterator

import jax

__all__ = ["trace", "annotate", "time_fn"]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture an XLA profiler trace of the enclosed block into ``log_dir``
    (open with TensorBoard's profile plugin / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named trace annotation context (shows up on the profiler timeline)."""
    return jax.profiler.TraceAnnotation(name)


def time_fn(fn: Callable[..., Any], *args, iters: int = 10,
            warmup: int = 1, **kwargs) -> float:
    """Average wall seconds per call of ``fn``, each timed region closed
    with ``jax.block_until_ready``."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kwargs))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters
