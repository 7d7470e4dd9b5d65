"""viewer_stream tutorial: OBJ viewer through the ray-stream API.

Recreates tutorials/viewer_stream/viewer_stream_device.cpp: the same
scene/shading as `viewer`, but each tile's rays go through the large
ray-stream entry (`rtcIntersect1M`, :200-260 renderTileStandardStream)
instead of per-pixel rtcIntersect1.  Here the whole frame is one flat
stream traced as one batch: the kernel walks one ray per thread, so
the stream needs no reordering.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ...core.math import dot, normalize
from ...core.rayhit import Rays
from ...rtcore import rtcIntersect1M
from ...scene.scene import scene_intersect
from ..camera import Camera
from ..texture import sample_texture
from ..tutorial_app import TutorialApplication
from .viewer import build_scene


@functools.partial(jax.jit, static_argnames=("width", "height"))
def render(cscene, materials, geom_mat, textures, kd_tex, tri_uv, prim_base,
           cam_vx, cam_vy, cam_vz, cam_p, *, width: int, height: int):
    xs = jnp.arange(width, dtype=jnp.float32)
    ys = jnp.arange(height, dtype=jnp.float32)
    x, y = jnp.meshgrid(xs, ys)
    d = normalize(x[..., None] * cam_vx + y[..., None] * cam_vy + cam_vz)
    org = jnp.broadcast_to(cam_p, d.shape)
    # ONE flat ray stream for the frame (the 1M entry point); the sorted
    # stream path kicks in inside scene_intersect for R >= 8192
    flat = Rays(org.reshape(-1, 3), d.reshape(-1, 3),
                jnp.zeros(width * height, jnp.float32),
                jnp.full(width * height, jnp.inf, jnp.float32))
    hits = scene_intersect(cscene, flat)
    hits = jax.tree.map(
        lambda a: a.reshape((height, width) + a.shape[1:]), hits)

    mid = geom_mat[jnp.clip(hits.geom_id, 0, geom_mat.shape[0] - 1)]
    kd = materials.kd[mid]
    tid = kd_tex[mid]
    gp = jnp.clip(prim_base[jnp.clip(hits.geom_id, 0,
                                     prim_base.shape[0] - 1)]
                  + hits.prim_id, 0, tri_uv.shape[0] - 1)
    uv3 = tri_uv[gp]
    w0 = (1.0 - hits.u - hits.v)[..., None]
    uv = uv3[..., 0, :] * w0 + uv3[..., 1, :] * hits.u[..., None] \
        + uv3[..., 2, :] * hits.v[..., None]
    tex = sample_texture(textures, jnp.maximum(tid, 0), uv[..., 0],
                         uv[..., 1])
    kd = jnp.where((tid >= 0)[..., None], kd * tex, kd)
    ns = normalize(hits.ng)
    ns = jnp.where(dot(d, ns)[..., None] < 0, ns, -ns)
    shade = jnp.clip(dot(-d, ns), 0.0, 1.0)
    return jnp.where(hits.valid[..., None], kd * shade[..., None], 0.0)


def render_frame(state, camera: Camera, size):
    w, h = size
    vx, vy, vz, p = camera.ispc_camera(w, h)
    img = render(state["cscene"], state["materials"], state["geom_mat"],
                 state["textures"], state["kd_tex"], state["tri_uv"],
                 state["prim_base"], vx, vy, vz, p, width=w, height=h)
    return img, w * h


def make_app() -> TutorialApplication:
    def _build(app):
        obj = getattr(app.args, "input", None)
        if obj is None:
            raise SystemExit("viewer_stream: -i <scene.obj> required")
        return build_scene(obj, getattr(app.args, "subdiv_mode", None),
                           app.args.subdLvl, app.args.compLvl)

    app = TutorialApplication("viewer_stream", _build, render_frame)
    parser_make = app.make_parser

    def make_parser():
        p = parser_make()
        p.add_argument("-i", "--input", type=str, default=None)
        return p

    app.make_parser = make_parser
    return app


if __name__ == "__main__":
    raise SystemExit(make_app().run())
