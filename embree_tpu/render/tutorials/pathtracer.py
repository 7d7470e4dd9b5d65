"""pathtracer tutorial: wavefront Monte Carlo path tracer.

Re-designs tutorials/pathtracer/pathtracer_device.cpp (renderPixelFunction
:1442-1546) as a WAVEFRONT integrator — the batched formulation: every
pixel advances through the bounce loop in lock-step, each bounce is one
batched intersect + one batched NEE shadow pass (the reference's
per-pixel recursion maps to masked whole-image ops). Semantics kept:

  * path length <= MAX_PATH_LENGTH = 8            (:41, :1457)
  * environment/ambient gathered on miss          (:1476-1484)
  * per-light sample + occluded shadow ray        (:1520-1533)
  * throughput update Lw *= c/pdf and the Lw < 0.01 cutoff (:1459-1536)
  * smooth-normal face-forward shading

With no OBJ on the command line the reference loads an empty scene; we
provide the classic procedural Cornell box so the tutorial is
self-contained (scene graph creators analog, geometry_creation.cpp).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ...core.device import Device
from ...core.math import dot, normalize
from ...core.rayhit import Rays
from ...scene.geometry import QuadMesh, TriangleMesh
from ...scene.scene import Scene, scene_intersect, scene_occluded
from ..camera import Camera, pixel_coords
from ..lights import LIGHT_QUAD, LightTable, make_light_table, sample_light
from ..materials import (MAT_MATTE, MAT_MIRROR, MaterialTable, eval_brdf,
                         make_material_table, sample_bsdf_medium)
from ..tutorial_app import TutorialApplication

MAX_PATH_LENGTH = 8


def _quad(p0, du, dv):
    p0 = np.asarray(p0, np.float32)
    du = np.asarray(du, np.float32)
    dv = np.asarray(dv, np.float32)
    verts = np.stack([p0, p0 + du, p0 + du + dv, p0 + dv])
    return verts, np.array([[0, 1, 2, 3]], np.int32)


def build_cornell_scene(device_cfg="ignore_config_files=1"):
    dev = Device(device_cfg)
    scene = Scene(dev)
    mats = []
    geom_mat = []

    def add_quad(p0, du, dv, mat):
        v, q = _quad(p0, du, dv)
        gid = scene.attach(QuadMesh(v, q))
        while len(geom_mat) <= gid:
            geom_mat.append(0)
        geom_mat[gid] = len(mats)
        mats.append(mat)

    white = {"type": MAT_MATTE, "kd": (0.75, 0.75, 0.75)}
    red = {"type": MAT_MATTE, "kd": (0.63, 0.065, 0.05)}
    green = {"type": MAT_MATTE, "kd": (0.14, 0.45, 0.091)}
    mirror = {"type": MAT_MIRROR, "ks": (0.9, 0.9, 0.9)}

    # box [0,1]^3, open towards +z camera
    add_quad((0, 0, 0), (1, 0, 0), (0, 0, 1), dict(white))    # floor
    add_quad((0, 1, 0), (0, 0, 1), (1, 0, 0), dict(white))    # ceiling
    add_quad((0, 0, 0), (0, 1, 0), (1, 0, 0), dict(white))    # back
    add_quad((0, 0, 0), (0, 0, 1), (0, 1, 0), dict(red))      # left
    add_quad((1, 0, 0), (0, 1, 0), (0, 0, 1), dict(green))    # right

    # short box (matte) and tall box (mirror)
    def add_box(lo, hi, mat):
        lo = np.asarray(lo, np.float32)
        hi = np.asarray(hi, np.float32)
        v = np.array([
            [lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
            [hi[0], lo[1], hi[2]], [lo[0], lo[1], hi[2]],
            [lo[0], hi[1], lo[2]], [hi[0], hi[1], lo[2]],
            [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]], np.float32)
        q = np.array([[3, 2, 1, 0], [4, 5, 6, 7], [0, 1, 5, 4],
                      [1, 2, 6, 5], [2, 3, 7, 6], [3, 0, 4, 7]], np.int32)
        gid = scene.attach(QuadMesh(v, q))
        while len(geom_mat) <= gid:
            geom_mat.append(0)
        geom_mat[gid] = len(mats)
        mats.append(mat)

    add_box((0.55, 0.0, 0.55), (0.85, 0.3, 0.85), dict(white))
    add_box((0.15, 0.0, 0.15), (0.45, 0.6, 0.45), dict(mirror))

    cs = scene.commit()
    lights = make_light_table([
        {"type": LIGHT_QUAD, "pos": (0.35, 0.999, 0.35),
         "e1": (0.3, 0.0, 0.0), "e2": (0.0, 0.0, 0.3),
         "radiance": (18.0, 14.0, 8.0)},
    ], ambient=(0.0, 0.0, 0.0))
    mt = make_material_table(mats)
    return dict(cscene=cs, scene=scene, materials=mt, lights=lights,
                geom_mat=jnp.asarray(np.asarray(geom_mat, np.int32)))


@functools.partial(jax.jit,
                   static_argnames=("width", "height", "spp", "n_lights",
                                    "max_path"))
def render_pt(cscene, materials: MaterialTable, lights: LightTable,
              geom_mat, cam_vx, cam_vy, cam_vz, cam_p, seed,
              perm=None, inv=None,
              *, width: int, height: int, spp: int = 4, n_lights: int = 1,
              max_path: int = MAX_PATH_LENGTH):
    key0 = jax.random.PRNGKey(seed)

    px, py = pixel_coords(width, height, perm)
    shape = px.shape

    def one_sample(key):
        kx, ky, kpath = jax.random.split(key, 3)
        x = px + jax.random.uniform(kx, shape)
        y = py + jax.random.uniform(ky, shape)
        d = normalize(x[..., None] * cam_vx + y[..., None] * cam_vy + cam_vz)
        org = jnp.broadcast_to(cam_p, d.shape)

        L = jnp.zeros(shape + (3,))
        Lw = jnp.ones(shape + (3,))
        active = jnp.ones(shape, bool)
        ro, rd = org, d
        # per-ray Medium (pathtracer_device.cpp:57-81): starts vacuum;
        # DIELECTRIC_SOLID refraction events push/pop it
        med_eta = jnp.ones(shape, jnp.float32)
        med_trans = jnp.ones(shape + (3,), jnp.float32)

        for bounce in range(max_path):
            kb = jax.random.fold_in(kpath, bounce)
            rays = Rays(ro, rd, jnp.full(shape, 1e-4, jnp.float32),
                        jnp.full(shape, jnp.inf, jnp.float32))
            # coherent flag on the camera bounce only (the reference
            # sets RTC_INTERSECT_CONTEXT_FLAG_COHERENT at :1467)
            hits = scene_intersect(cscene, rays, coherent=(bounce == 0))
            hit = hits.valid & active

            # environment on miss (:1476-1484)
            L = L + jnp.where((active & ~hits.valid)[..., None],
                              Lw * lights.ambient, 0.0)
            active = hit

            mid = geom_mat[jnp.clip(hits.geom_id, 0,
                                    geom_mat.shape[0] - 1)]
            # emission (area-light geometry would add here)
            L = L + jnp.where(active[..., None], Lw * materials.le[mid], 0.0)

            # sanitize miss lanes: t=inf / ng=0 would produce NaNs that
            # poison jax.grad through the masked branches of jnp.where
            # (0 * NaN cotangents) — the values themselves are never
            # used (every contribution is `active`-masked)
            t_safe = jnp.where(hits.valid, hits.t, 1.0)
            p_hit = ro + t_safe[..., None] * rd
            ng_raw = jnp.where(hits.valid[..., None], hits.ng,
                               jnp.asarray([0.0, 0.0, 1.0], jnp.float32))
            nrm = jnp.linalg.norm(ng_raw, axis=-1, keepdims=True)
            ng = ng_raw / jnp.maximum(nrm, 1e-20)
            # face forward
            ng = jnp.where(dot(rd, ng)[..., None] < 0, ng, -ng)
            wo = -rd

            # next event estimation over every light (:1520-1533)
            for li in range(n_lights):
                kl = jax.random.fold_in(kb, 1000 + li)
                wi, dist, le_w = sample_light(lights, li, p_hit, kl)
                cos_s = jnp.sum(wi * ng, -1)
                f = eval_brdf(materials, mid, wo, ng, wi)
                shadow = Rays(p_hit, wi,
                              jnp.full(shape, 1e-3, jnp.float32),
                              dist * (1.0 - 1e-3))
                occ = scene_occluded(cscene, shadow)
                vis = active & ~occ & (cos_s > 0)
                L = L + jnp.where(vis[..., None], Lw * f * le_w, 0.0)

            # simple volumetric effect (:1503-1506): the medium the
            # segment just crossed attenuates the continuation weight
            # (folded into c exactly as the reference does)
            seg_att = med_trans ** t_safe[..., None]
            # sample continuation (:1459-1536) with Medium tracking
            ks = jax.random.fold_in(kb, 7)
            wi, w, _delta, med_eta2, med_trans2 = sample_bsdf_medium(
                materials, mid, wo, ng, ks, med_eta, med_trans)
            med_eta = jnp.where(active, med_eta2, med_eta)
            med_trans = jnp.where(active[..., None], med_trans2,
                                  med_trans)
            Lw = Lw * jnp.where(active[..., None], w * seg_att, 1.0)
            ro = p_hit + 1e-4 * wi
            rd = wi
            active = active & (jnp.max(Lw, -1) >= 0.01)  # cutoff (:1459)

        return L

    keys = jax.random.split(key0, spp)
    L = jnp.zeros(shape + (3,))
    for s in range(spp):
        L = L + one_sample(keys[s])
    L = L / spp
    if inv is not None:
        L = L[inv]
    return L.reshape(height, width, 3)


def render_frame(state, camera: Camera, size, spp=4, seed=0):
    from ..camera import pixel_morton_order_device
    w, h = size
    vx, vy, vz, p = camera.ispc_camera(w, h)
    perm, inv = pixel_morton_order_device(w, h)
    img = render_pt(state["cscene"], state["materials"], state["lights"],
                    state["geom_mat"], vx, vy, vz, p, seed, perm, inv,
                    width=w, height=h, spp=spp,
                    n_lights=len(state["lights"].type))
    # rays per frame: spp * (primary + NEE shadow) * bounces (upper bound)
    nrays = spp * w * h * 2 * MAX_PATH_LENGTH
    return img, nrays


def make_app() -> TutorialApplication:
    def _build(app):
        return build_cornell_scene()

    app = TutorialApplication("pathtracer", _build, render_frame,
                              default_size=(256, 256))
    app.camera = Camera(from_=(0.5, 0.5, 2.4), to=(0.5, 0.5, 0.0), fov=40)
    return app


if __name__ == "__main__":
    raise SystemExit(make_app().run())
