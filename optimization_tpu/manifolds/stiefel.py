"""Stiefel manifold St(n, p) = { X in R^{n x p} : X^T X = I_p } and SO(d).

These are the manifolds of the SE-Sync-style rotation-synchronization
problems that the reference's solver engine was built to serve (the reference
itself is geometry-agnostic — geometry enters through the injected metric /
retraction callbacks, ``Riemannian/Concepts.h:44-112``).

Geometry (canonical embedded metric):

- tangent projection:  P_X(V) = V - X sym(X^T V),  sym(A) = (A + A^T)/2
- retraction:          polar retraction R_X(V) = uv(X + V), the projection
  onto St(n, p) given by the orthogonal factor of the polar decomposition —
  computed eigendecomposition-free via the Newton-Schulz-stabilized SVD-free
  route ( (X+V) (I + V^T V)^{-1/2} ) using a symmetric eigendecomposition of
  the small p x p Gram matrix.  This keeps all heavy math as (n x p) @ (p x p)
  matmuls: accelerator-friendly and exactly differentiable.
- metric: Frobenius inner product.

``so(d)`` is St(d, d) restricted to determinant +1; the polar retraction
preserves the connected component, so the same ops apply.  Product manifolds
of N rotations are represented as stacked arrays (N, d, d) with all ops
broadcasting over leading axes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .base import Manifold


def _sym(a):
    return 0.5 * (a + jnp.swapaxes(a, -1, -2))


def _acc(u):
    """Accumulation view (same contract as ``sphere._acc``): sub-f32 storage
    (bf16/f16) is promoted to f32 for every product/reduction — the
    bf16-storage / f32-accumulate tier.  No-op for f32/f64; XLA fuses the
    convert into the consuming op, so it adds no memory traffic."""
    return u.astype(jnp.promote_types(u.dtype, jnp.float32))


def _mm(a, b):
    # p x p / n x p products at full precision: reduced-precision inputs
    # (a GPU's TF32 default) lose the orthogonality digits trust-region
    # logic relies on.
    # Sub-f32 *storage* is promoted to f32 first (bf16 tier; see _acc).
    return jnp.matmul(_acc(a), _acc(b), precision=jax.lax.Precision.HIGHEST)


def _proj(x, v):
    xtv = _mm(jnp.swapaxes(x, -1, -2), v)
    return (_acc(v) - _mm(x, _sym(xtv))).astype(v.dtype)


def _inner(x, u, v):
    return jnp.sum(_acc(u) * _acc(v))


def _polar_retract(x, v):
    """Polar retraction R_X(V) = uf(X + V) = (X+V) ((X+V)'(X+V))^{-1/2}.

    The Gram matrix is computed exactly (NOT via the tangent-space identity
    (X+V)'(X+V) = I + V'V): truncated-CG steps can carry small non-tangent
    components (roundoff drift amplified by near-boundary walks), and the
    exact polar factor keeps the iterate orthonormal for ANY ambient V —
    making trust-region loops self-correcting instead of silently leaving
    the manifold (where the pulled-back objective is meaningless).

    bf16 tier: the whole computation runs in f32 (``_acc`` promotion) and
    only the final factor is cast back to the storage dtype, so the stored
    iterate's orthonormality error is ONE bf16 rounding (~eps_bf16 per
    entry, re-corrected by the next retraction), not an accumulated drift
    (tests/test_manifolds.py::TestBf16Tier).
    """
    y = _acc(x) + _acc(v)
    g = _mm(jnp.swapaxes(y, -1, -2), y)
    g = 0.5 * (g + jnp.swapaxes(g, -1, -2))
    # inverse matrix square root of the small p x p SPD Gram via eigh
    w, q = jnp.linalg.eigh(g)
    w = jnp.maximum(w, jnp.finfo(g.dtype).tiny)
    inv_sqrt = _mm(q * (1.0 / jnp.sqrt(w))[..., None, :],
                   jnp.swapaxes(q, -1, -2))
    return _mm(y, inv_sqrt).astype(x.dtype)


def _egrad_to_rgrad(x, g):
    return _proj(x, g)


def _rand_stiefel(key, *shape):
    """Random point via QR of a Gaussian; shape = (..., n, p)."""
    a = jax.random.normal(key, shape)
    q, r = jnp.linalg.qr(a)
    # Sign-fix so the factorization (hence the sample) is unique
    d = jnp.sign(jnp.diagonal(r, axis1=-2, axis2=-1))
    d = jnp.where(d == 0, 1.0, d)
    return q * d[..., None, :]


STIEFEL = Manifold(
    name="stiefel",
    retract=_polar_retract,
    inner=_inner,
    proj=_proj,
    egrad_to_rgrad=_egrad_to_rgrad,
    rand=_rand_stiefel,
)


def stiefel() -> Manifold:
    return STIEFEL


def _rand_rotation(key, *shape):
    """Random rotation(s) in SO(d); shape = (..., d, d)."""
    q = _rand_stiefel(key, *shape)
    # Flip one column where det = -1 to land in SO(d)
    det = jnp.linalg.det(q)
    flip = jnp.where(det < 0, -1.0, 1.0)
    return q.at[..., :, 0].multiply(flip[..., None])


ROTATIONS = Manifold(
    name="so",
    retract=_polar_retract,
    inner=_inner,
    proj=_proj,
    egrad_to_rgrad=_egrad_to_rgrad,
    rand=_rand_rotation,
)


def rotations() -> Manifold:
    """SO(d) (or a product of rotations when arrays carry leading axes)."""
    return ROTATIONS
