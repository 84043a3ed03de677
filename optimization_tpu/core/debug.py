"""Sanitizer-tier support (SURVEY.md section 5: the stand-in for
TSan/ASan is ``jax_debug_nans`` + deterministic collectives).

Every solver result carries fixed-length trace arrays whose entries beyond
``num_iterations`` are NaN **by contract** (static shapes under jit; the
padding is contractually unread).  ``jax_debug_nans`` re-runs any jit whose
OUTPUT contains NaN, so that contract used to exclude every whole-result
solver test from the ``OPTTPU_DEBUG_NANS=1`` CI tier.

Under the sanitizer tier the padding is **zero-filled instead**: semantically
invisible to any consumer honoring the contract (entries beyond
``num_iterations`` are unread — and the tier running green over the whole
suite is precisely the assertion that nothing reads them expecting NaN),
while letting the NaN-debug net cover the end-to-end solver paths where an
*unintended* NaN would actually surface.  Tests that intentionally inject or
assert NaN (NaN-rho fixtures, padding-contract pins) keep the ``nan_traces``
marker and skip under the tier.

The flag is read once at import: the conftest / CI sets ``OPTTPU_DEBUG_NANS``
for the whole process before importing the package, exactly like its
``jax.config.update("jax_debug_nans", True)``.
"""

from __future__ import annotations

import os

__all__ = ["DEBUG_NANS", "pad_value"]

DEBUG_NANS = bool(os.environ.get("OPTTPU_DEBUG_NANS"))


def pad_value() -> float:
    """Fill value for contractually-unread trace padding: NaN by the result
    contract; 0.0 under the OPTTPU_DEBUG_NANS sanitizer tier (see module
    docstring)."""
    return 0.0 if DEBUG_NANS else float("nan")
