"""Test configuration: fake 8-device CPU mesh + float64.

The reference's tolerances (1e-6 .. 1e-8) assume double precision, so tests
run in x64 on the CPU; multi-device sharding tests use 8 virtual CPU
devices.  The persistent compile cache stays off, so test runs write
nothing into the checkout.

Tests marked ``gpu`` need the card.  They take the ``gpu_device`` fixture,
which skips here; ``chip_smoke.py`` runs them on a GPU with
``OPTTPU_TEST_DEVICE=gpu``, under which this file leaves JAX's platform,
precision and cache settings alone.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import pytest  # noqa: E402

ON_GPU = os.environ.get("OPTTPU_TEST_DEVICE") == "gpu"
if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_enable_compilation_cache", False)

# Sanitizer-analog CI pass (SURVEY.md section 5: the stand-in for
# TSan/ASan is NaN debugging + deterministic collectives).  Run as
#     OPTTPU_DEBUG_NANS=1 python -m pytest tests/ -q -m "not slow"
# jax_debug_nans re-runs any jit whose OUTPUT contains NaN in op-by-op
# mode and raises at the producing op — catching unintended NaNs in the
# whole compute path INCLUDING the end-to-end solver paths: under this
# mode the solvers zero-fill their contractually-unread trace padding
# instead of NaN-padding it (optimization_tpu/core/debug.py — the env var
# is read by the package at import, before this config runs), so
# whole-result solver tests run under the net; the tier passing is the
# assertion that nothing reads the padding expecting NaN.  Only tests
# that deliberately inject or assert NaN (NaN-rho fixtures, breakdown
# eigh fixtures) carry the ``nan_traces`` marker and skip.  Determinism
# of the sharded collectives is asserted unconditionally in
# test_parallel.py (bitwise-identical repeat of a sharded solve).
DEBUG_NANS = bool(os.environ.get("OPTTPU_DEBUG_NANS"))
if DEBUG_NANS:
    jax.config.update("jax_debug_nans", True)


def pytest_collection_modifyitems(config, items):
    if not DEBUG_NANS:
        return
    skip = pytest.mark.skip(
        reason="outputs legitimately carry NaN (nan_traces marker); "
               "excluded from the OPTTPU_DEBUG_NANS sanitizer pass")
    for item in items:
        if "nan_traces" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled executables between test modules.

    The full suite compiles many hundreds of XLA CPU programs; letting the
    JIT'd code accumulate across all ~20 modules reproducibly segfaults
    the XLA CPU compiler late in the run (observed twice at ~78%, in
    whatever small compile came next — an upstream accumulation bug, not
    a test failure; 125 GB host RAM free at the time).  Per-module cache
    clearing bounds the live compiled-program count at no measurable
    wall-clock cost (modules share almost no programs)."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu_device(request):
    """JAX's first device if it is a GPU; skips otherwise.  Records the
    platform the test ran on in the test's ``user_properties``."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is on {dev.platform} "
                    f"(run on the card by chip_smoke.py)")
    request.node.user_properties.append(("platform", dev.platform))
    return dev
