"""Ray / hit containers (SoA pytrees).

Analog of the reference internal ray layout (kernels/common/ray.h): rays are
stored struct-of-arrays with an arbitrary batch shape, the batched
generalization of embree's RayK<K> packets. INVALID_ID == -1 stands in for
RTC_INVALID_GEOMETRY_ID (0xFFFFFFFF).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

INVALID_ID = jnp.int32(-1)


class Rays(NamedTuple):
    org: jnp.ndarray    # (..., 3) f32
    dir: jnp.ndarray    # (..., 3) f32
    tnear: jnp.ndarray  # (...,)  f32
    tfar: jnp.ndarray   # (...,)  f32

    @property
    def batch_shape(self):
        return self.tnear.shape


def make_rays(org, dir, tnear=0.0, tfar=jnp.inf):
    org = jnp.asarray(org, jnp.float32)
    dir = jnp.asarray(dir, jnp.float32)
    shape = org.shape[:-1]
    tnear = jnp.broadcast_to(jnp.asarray(tnear, jnp.float32), shape)
    tfar = jnp.broadcast_to(jnp.asarray(tfar, jnp.float32), shape)
    return Rays(org, dir, tnear, tfar)


class Hits(NamedTuple):
    """Per-ray closest hit; miss <=> geom_id == INVALID_ID (ray.h RayHit).

    `gprim` is the internal *global* flattened-triangle index (the leaf
    slot), used by the differentiable re-evaluation pass (diff/) to
    recompute the hit analytically from the winning primitive.
    """

    t: jnp.ndarray        # (...,) f32 hit distance (tfar after intersect)
    u: jnp.ndarray        # (...,) f32 barycentric/patch u
    v: jnp.ndarray        # (...,) f32
    ng: jnp.ndarray       # (..., 3) f32 unnormalized geometric normal
    prim_id: jnp.ndarray  # (...,) i32 prim index within its geometry
    geom_id: jnp.ndarray  # (...,) i32
    gprim: jnp.ndarray    # (...,) i32 global flattened prim index
    inst_id: jnp.ndarray  # (...,) i32 instance id (-1 = top level)

    @property
    def valid(self):
        return self.geom_id != INVALID_ID


def miss_hits(shape, tfar):
    return Hits(
        t=jnp.broadcast_to(jnp.asarray(tfar, jnp.float32), shape),
        u=jnp.zeros(shape, jnp.float32),
        v=jnp.zeros(shape, jnp.float32),
        ng=jnp.zeros(shape + (3,), jnp.float32),
        prim_id=jnp.full(shape, INVALID_ID, jnp.int32),
        geom_id=jnp.full(shape, INVALID_ID, jnp.int32),
        gprim=jnp.full(shape, INVALID_ID, jnp.int32),
        inst_id=jnp.full(shape, INVALID_ID, jnp.int32),
    )
