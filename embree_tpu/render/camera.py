"""Pinhole camera with reference-exact ray generation.

Mirrors tutorials/common/tutorial/camera.h: lookat frame (affinespace.h:76:
Z = to-from, U = up x Z, V = Z x U; right-handed negates vx), and the
ISPCCamera screen transform (camera.h getISPCCamera):

    vx = l.vx, vy = -l.vy
    vz = -w/2 * l.vx + h/2 * l.vy + h/2 * fovScale * l.vz
    ray(x, y): org = p, dir = normalize(x*vx + y*vy + vz)

so pixel (x, y) in [0,w)x[0,h) reproduces the reference images bit-for-
layout. Ray generation is vectorized over a whole pixel grid.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
import numpy as np

import functools

from ..core.math import deg2rad, lookat, normalize
from ..core.rayhit import Rays, make_rays


@functools.lru_cache(maxsize=16)
def pixel_morton_order(width: int, height: int):
    """(perm, inv) int32 arrays mapping flat image-row order to a pixel
    morton (Z-curve) order. Tracing primary rays in morton order makes
    each traversal packet an ~square screen tile instead of a thin row
    strip — the batched expression of the reference's 8x8 render tiles
    (tutorial_device.cpp TILE_SIZE) with far tighter packet frusta.
    Static per (w, h); pass to jitted renderers as arrays rather than
    closing over them, so they are not baked into the program."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.uint64)

    def spread(a):  # interleave with zeros (16 -> 32 bit morton support)
        a = (a | (a << 8)) & np.uint64(0x00FF00FF)
        a = (a | (a << 4)) & np.uint64(0x0F0F0F0F)
        a = (a | (a << 2)) & np.uint64(0x33333333)
        a = (a | (a << 1)) & np.uint64(0x55555555)
        return a

    code = (spread(xs) | (spread(ys) << np.uint64(1))).reshape(-1)
    perm = np.argsort(code, kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return perm, inv


def pixel_coords(width: int, height: int, perm=None):
    """Flat (x, y) f32 pixel-center coordinates for ray generation —
    in morton order when `perm` (from pixel_morton_order) is given,
    image-row order otherwise. Shared by the tutorial renderers."""
    if perm is not None:
        return ((perm % width).astype(jnp.float32),
                (perm // width).astype(jnp.float32))
    xs = jnp.arange(width, dtype=jnp.float32)
    ys = jnp.arange(height, dtype=jnp.float32)
    xg, yg = jnp.meshgrid(xs, ys)
    return xg.reshape(-1), yg.reshape(-1)


@functools.lru_cache(maxsize=16)
def pixel_morton_order_device(width: int, height: int):
    """Device-resident (perm, inv) — cached so per-frame render calls
    don't re-upload ~8 MB of permutations over the (slow) device link."""
    perm, inv = pixel_morton_order(width, height)
    return jnp.asarray(perm), jnp.asarray(inv)


@dataclasses.dataclass
class Camera:
    from_: Tuple[float, float, float] = (0.0001, 0.0001, -3.0)
    to: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    fov: float = 90.0
    right_handed: bool = True

    def ispc_camera(self, width: int, height: int):
        """Returns (vx, vy, vz, p) jnp arrays (camera.h getISPCCamera)."""
        fov_scale = 1.0 / np.tan(deg2rad(0.5 * self.fov))
        frame = lookat(jnp.asarray(self.from_, jnp.float32),
                       jnp.asarray(self.to, jnp.float32),
                       jnp.asarray(self.up, jnp.float32))
        lvx = -frame.vx if self.right_handed else frame.vx
        vx = lvx
        vy = -frame.vy
        vz = (-0.5 * width) * lvx + (0.5 * height) * frame.vy \
            + (0.5 * height * fov_scale) * frame.vz
        return vx, vy, vz, frame.p


def primary_rays(camera: Camera, width: int, height: int,
                 tnear: float = 0.0, tfar: float = np.inf,
                 jitter: jnp.ndarray | None = None) -> Rays:
    """Rays for every pixel, shape (height, width). jitter: (H, W, 2) in
    [0,1) for antialiasing (the pathtracer's subpixel sampling)."""
    vx, vy, vz, p = camera.ispc_camera(width, height)
    xs = jnp.arange(width, dtype=jnp.float32)
    ys = jnp.arange(height, dtype=jnp.float32)
    x, y = jnp.meshgrid(xs, ys)  # (H, W)
    if jitter is not None:
        x = x + jitter[..., 0]
        y = y + jitter[..., 1]
    d = x[..., None] * vx + y[..., None] * vy + vz
    d = normalize(d)
    org = jnp.broadcast_to(p, d.shape)
    return make_rays(org, d, tnear, tfar)
