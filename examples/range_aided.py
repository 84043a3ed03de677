"""Range-aided pose synchronization (models/range_sync.py).

A spanning chain of noisy SE(3) odometry edges gives a translation
estimate that drifts; adding UWB-style range measurements (distance
only, no bearing) and jointly refining poses + unit range bearings with
ONE Riemannian TNT solve on the product manifold
SO(3)^n x R^{3n} x (S^2)^K recovers most of the lost accuracy — the
CORA-style unit-vector relaxation (module docstring of
``models/range_sync.py``).  Everything is autodiff: the model supplies
only the objective (the reference's primary usage pattern,
``Riemannian/Concepts.h:40-104``).

Run: python examples/range_aided.py   [JAX_PLATFORMS=cpu to stay off the GPU]
"""

from _common import setup

setup()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from optimization_tpu.models import range_sync as rg  # noqa: E402
from optimization_tpu.models.pose_sync import alignment_errors  # noqa: E402


def main():
    n, n_ranges = 30, 60
    key = jax.random.PRNGKey(3)
    R_true, t_true, data = rg.random_instance(
        key, n, 3, extra_edges=0, n_ranges=n_ranges, noise=0.05,
        range_noise=0.001)
    t_ref = t_true - t_true[0][None]

    out = rg.solve_range_aided(data, n)
    rot_err, t_err = alignment_errors(out.R, out.t, R_true, t_ref)
    res = out.result
    print(f"range-aided: {int(res.num_iterations)} TNT iters, "
          f"f = {float(res.f):.3e}, |g| = {float(res.gradfx_norm):.2e}, "
          f"rot_err {float(rot_err):.4f}, max t_err {float(t_err):.4f}")

    data0 = data._replace(rho=jnp.zeros_like(data.dists))
    out0 = rg.solve_range_aided(data0, n)
    _, t_err0 = alignment_errors(out0.R, out0.t, R_true, t_ref)
    print(f"pose-only  : max t_err {float(t_err0):.4f}  "
          f"(ranges tighten translations {float(t_err0 / t_err):.1f}x "
          f"on this chain)")


if __name__ == "__main__":
    main()
