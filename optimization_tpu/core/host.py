"""Host-side timing utilities.

The reference drives wall-clock facilities from inside its solver loops
(``Util/Stopwatch.h:15-29``, ``Base/Concepts.h:47-49,76-80``): per-iteration
``result.time[]`` sampling, the ``max_computation_time`` stopping criterion,
and ``params.verbose`` per-iteration stdout lines.

A wall clock cannot live inside a compiled XLA loop, and host callbacks
(``io_callback`` / ``debug.callback``) would synchronize every iteration —
so the compiled-loop equivalent is **host-chunked stepping** (SURVEY.md
section 7.1): :mod:`optimization_tpu.core.driver` runs a solver K
iterations per dispatch, reads the clock and prints between dispatches.
This module holds the host clock primitives it uses.
"""

from __future__ import annotations

import time

__all__ = ["Stopwatch"]


class Stopwatch:
    """Wall-clock stopwatch in seconds (reference ``Util/Stopwatch.h:15-29``)."""

    def __init__(self) -> None:
        self._start = time.monotonic()

    def tick(self) -> None:
        self._start = time.monotonic()

    def tock(self) -> float:
        return time.monotonic() - self._start
