"""Core vector/bbox math on JAX arrays (SoA-last-axis convention).

Re-expression of the reference's `common/math` layer
(`vec3.h`, `bbox.h`, `affinespace.h`). Vectors are plain jnp arrays whose
*last* axis has size 3; every helper broadcasts over leading axes, so the
same code path serves one ray or a (8, 128) packet. There is no SIMD
wrapper layer (reference `common/simd/*`): XLA's vectorization plays
that role.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Large-but-finite stand-in for embree's `inf` ray bound; keeps arithmetic
# NaN-free inside jitted code while compare semantics stay identical.
INF = jnp.float32(np.inf)
NEG_INF = jnp.float32(-np.inf)


def matmul(a, b):
    """Full-precision f32 product for ray, point and normal transforms;
    a GPU would otherwise run it in TF32 (~1e-3 relative)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def length(a):
    return jnp.sqrt(dot(a, a))


def normalize(a):
    return a / jnp.maximum(length(a), 1e-30)[..., None]


def deg2rad(d):
    return d * (np.pi / 180.0)


class AffineSpace(NamedTuple):
    """3x3 linear part + translation, mirroring reference affinespace.h."""

    vx: jnp.ndarray  # (..., 3)
    vy: jnp.ndarray
    vz: jnp.ndarray
    p: jnp.ndarray

    def xfm_point(self, q):
        return (
            q[..., 0:1] * self.vx + q[..., 1:2] * self.vy + q[..., 2:3] * self.vz + self.p
        )

    def xfm_vector(self, q):
        return q[..., 0:1] * self.vx + q[..., 1:2] * self.vy + q[..., 2:3] * self.vz


def lookat(eye, point, up):
    """Reference common/math/affinespace.h:76-81: Z=to-from, U=up×Z, V=Z×U."""
    eye = jnp.asarray(eye, jnp.float32)
    z = normalize(jnp.asarray(point, jnp.float32) - eye)
    u = normalize(cross(jnp.asarray(up, jnp.float32), z))
    v = normalize(cross(z, u))
    return AffineSpace(u, v, z, eye)


# ---------------------------------------------------------------------------
# Axis-aligned bounding boxes: stored as a pair of (..., 3) arrays.
# ---------------------------------------------------------------------------

def bbox_empty(shape=()):
    lower = jnp.full(shape + (3,), INF, jnp.float32)
    upper = jnp.full(shape + (3,), NEG_INF, jnp.float32)
    return lower, upper


def bbox_merge(lower_a, upper_a, lower_b, upper_b):
    return jnp.minimum(lower_a, lower_b), jnp.maximum(upper_a, upper_b)


def bbox_area(lower, upper):
    """Surface-area metric used by the SAH (reference bbox.h halfArea x2)."""
    d = jnp.maximum(upper - lower, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


def bbox_half_area(lower, upper):
    d = jnp.maximum(upper - lower, 0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]


# float ulp scale factors for robust ("watertight") traversal, following
# reference kernels/bvh/node_intersector1.h:108-179 (1+-3ulp rounding guards).
ROBUST_MIN_RCP = jnp.float32(1.0 - 3.0 * 2.0 ** -23)
ROBUST_MAX_RCP = jnp.float32(1.0 + 3.0 * 2.0 ** -23)


def rcp_safe(a):
    """Reciprocal with +-0 mapped to huge finite value (embree rcp_safe)."""
    return jnp.where(jnp.abs(a) < 1e-30, jnp.where(a < 0, -1e30, 1e30), 1.0 / a)
