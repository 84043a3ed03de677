"""Shared example harness: backend setup + result pretty-printing."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax


def setup(n_cpu_devices: int | None = None, x64: bool = False):
    """Configure JAX for an example on its default backend (a GPU when JAX
    finds one; ``JAX_PLATFORMS=cpu`` picks the CPU).  ``x64`` turns on
    double precision, when the example asks for it."""
    if n_cpu_devices:
        jax.config.update("jax_num_cpu_devices", n_cpu_devices)
    if x64:
        jax.config.update("jax_enable_x64", True)
    # Trust-region gain ratios and backtracking line searches compare
    # objective values to ~1e-7 relative precision; a GPU's default TF32
    # matmul inputs are too coarse for that, so examples run matmuls at
    # full f32.
    jax.config.update("jax_default_matmul_precision", "highest")
    print(f"backend={jax.default_backend()} devices={jax.devices()}")


def report(name, res, t0, extra=""):
    print(f"[{name}] status={int(res.status)} iters={int(res.num_iterations)}"
          f" f={float(res.f):.6e} wall={time.time() - t0:.2f}s {extra}")
