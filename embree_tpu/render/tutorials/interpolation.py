"""interpolation tutorial: vertex-attribute interpolation at hit points.

Recreates tutorials/interpolation/interpolation_device.cpp: a triangle
cube, a quad cube and a subdivision cube each carry per-vertex colors
(cube_vertex_colors :50-61) bound as vertex-attribute buffers; at every
hit rtcInterpolate fetches the smoothly interpolated color, which is used
directly as the diffuse albedo (renderPixelStandard :330-390).  For the
subdiv cube the color is smoothed through the same Catmull-Clark stencils
as the limit surface.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ...core.device import Device
from ...core.math import dot, normalize
from ...core.rayhit import Rays
from ...scene.geometry import QuadMesh, SubdivMesh, TriangleMesh
from ...scene.scene import Scene, scene_intersect
from ..camera import Camera
from ..tutorial_app import TutorialApplication

CUBE_V = np.asarray([
    [-1, -1, -1], [1, -1, -1], [1, -1, 1], [-1, -1, 1],
    [-1, 1, -1], [1, 1, -1], [1, 1, 1], [-1, 1, 1]], np.float32)
CUBE_COLORS = np.asarray([
    [0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1],
    [0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1]], np.float32)
CUBE_T = np.asarray([
    [1, 4, 5], [0, 4, 1], [2, 5, 6], [1, 5, 2], [3, 6, 7], [2, 6, 3],
    [4, 3, 7], [0, 3, 4], [5, 7, 6], [4, 7, 5], [3, 1, 2], [0, 1, 3]],
    np.int32)
CUBE_Q = np.asarray([
    [0, 4, 5, 1], [1, 5, 6, 2], [2, 6, 7, 3],
    [0, 3, 7, 4], [4, 7, 6, 5], [0, 1, 2, 3]], np.int32)


def build_scene(app=None):
    # compressed-grid subdiv accel: hits carry patch-space uv, which the
    # attribute interpolation needs (the stock eager path reports
    # triangle-local uv)
    dev = Device("ignore_config_files=1,subdiv_accel=bvh4.compressed.grid")
    scene = Scene(dev)
    scene.set_levels(3, 2)
    offs = {"tri": (-4.5, 0, 0), "quad": (0, 0, 0), "subdiv": (4.5, 0, 0)}
    tri = TriangleMesh(CUBE_V + offs["tri"], CUBE_T)
    tri.vertex_attributes.append(CUBE_COLORS)
    gid_tri = scene.attach(tri)
    quad = QuadMesh(CUBE_V + offs["quad"], CUBE_Q)
    quad.vertex_attributes.append(CUBE_COLORS)
    gid_quad = scene.attach(quad)
    sub = SubdivMesh(CUBE_V + offs["subdiv"],
                     np.full(6, 4, np.int32), CUBE_Q.reshape(-1))
    sub.vertex_attributes.append(CUBE_COLORS)
    gid_sub = scene.attach(sub)
    cs = scene.commit()
    # pre-smooth subdiv colors so the render closure is jit-friendly
    scene.interpolate(gid_sub, np.zeros(1, np.int64),
                      np.zeros(1), np.zeros(1), slot=0)
    return dict(cscene=cs, scene=scene,
                gids=(gid_tri, gid_quad, gid_sub))


def _interp_colors(scene, gids, hits):
    """Per-geometry rtcInterpolate of the color attribute, gathered by
    the hit geom_id (the reference's per-hit rtcInterpolate call)."""
    flatten = lambda a: a.reshape(-1)
    prim = flatten(hits.prim_id)
    u, v = flatten(hits.u), flatten(hits.v)
    col = jnp.ones((prim.shape[0], 3), jnp.float32)
    gidv = flatten(hits.geom_id)
    for gid in gids:
        p = jnp.clip(prim, 0, None)
        c = scene.interpolate(gid, p, u, v, slot=0)
        col = jnp.where((gidv == gid)[:, None], c, col)
    return col.reshape(hits.prim_id.shape + (3,))


def render_frame(state, camera: Camera, size):
    w, h = size
    vx, vy, vz, p = camera.ispc_camera(w, h)
    cs, scene, gids = state["cscene"], state["scene"], state["gids"]

    @functools.partial(jax.jit, static_argnames=())
    def trace(cs, vx, vy, vz, p):
        # cs passed as an argument, never captured: a captured scene's
        # device arrays would be baked into the executable
        xs = jnp.arange(w, dtype=jnp.float32)
        ys = jnp.arange(h, dtype=jnp.float32)
        x, y = jnp.meshgrid(xs, ys)
        d = normalize(x[..., None] * vx + y[..., None] * vy + vz)
        org = jnp.broadcast_to(p, d.shape)
        rays = Rays(org, d, jnp.zeros(d.shape[:-1], jnp.float32),
                    jnp.full(d.shape[:-1], jnp.inf, jnp.float32))
        return d, scene_intersect(cs, rays, coherent=True)

    d, hits = trace(cs, vx, vy, vz, p)
    col = _interp_colors(scene, gids, hits)
    ns = normalize(hits.ng)
    ns = jnp.where(dot(d, ns)[..., None] < 0, ns, -ns)
    shade = 0.3 + 0.7 * jnp.clip(dot(-d, ns), 0.0, 1.0)
    img = jnp.where(hits.valid[..., None], col * shade[..., None], 0.0)
    return img, w * h


def make_app() -> TutorialApplication:
    app = TutorialApplication("interpolation", build_scene, render_frame)
    app.camera = Camera(from_=(0, 3, -6.5), to=(0, 0, 0))
    return app


if __name__ == "__main__":
    raise SystemExit(make_app().run())
