"""lazy_geometry tutorial: geometry built lazily on first ray contact.

Recreates tutorials/lazy_geometry/lazy_geometry_device.cpp: a grid of
spheres is registered only as bounds (instanceBoundsFunc :49-61); a
sphere's triangle mesh is created and committed the first time a ray
enters its bounds (lazyCreate :120-160, state machine LAZY_INVALID →
LAZY_CREATE → LAZY_COMMIT → LAZY_VALID :29-35).

Batched re-expression: the reference's per-ray lazy trigger is a
divergent host callback — hostile to a batched traced pipeline — so the
laziness is moved to wavefront granularity: each frame first traces
against the bounds proxies, then builds (host-side) the sphere meshes
whose bounds were touched by any ray, re-commits, and re-traces.  Rays
never see a proxy in the final image, exactly like the reference, and
untouched spheres are never tessellated, also like the reference.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ...core.device import Device
from ...core.math import dot, normalize
from ...core.rayhit import Rays
from ...scene.geometry import TriangleMesh, UserGeometry
from ...scene.scene import Scene, scene_intersect
from ..camera import Camera
from ..tutorial_app import TutorialApplication

NUM_SPHERES_X = 5
NUM_SPHERES_Z = 5
RADIUS = 0.8

LAZY_INVALID = 0
LAZY_VALID = 3


def _sphere_mesh(p, r, n_phi=16, n_theta=32):
    phi = np.linspace(0, np.pi, n_phi + 1)
    theta = np.linspace(0, 2 * np.pi, n_theta, endpoint=False)
    P, T = np.meshgrid(phi, theta, indexing="ij")
    v = np.stack([p[0] + r * np.sin(P) * np.sin(T),
                  p[1] + r * np.cos(P),
                  p[2] + r * np.sin(P) * np.cos(T)], -1)
    v = v.reshape(-1, 3).astype(np.float32)
    tris = []
    for i in range(n_phi):
        for j in range(n_theta):
            jn = (j + 1) % n_theta
            a, b = i * n_theta + j, i * n_theta + jn
            c, d = (i + 1) * n_theta + j, (i + 1) * n_theta + jn
            if i > 0:
                tris.append((a, b, c))
            if i < n_phi - 1:
                tris.append((b, d, c))
    return v, np.asarray(tris, np.int32)


def _make_bounds_proxy(centers):
    """UserGeometry over all sphere bounds: intersect = analytic sphere
    (cheap stand-in used only to detect 'a ray entered the bounds')."""
    C = np.asarray(centers)  # numpy: captured by a jitted closure

    def bounds_fn(ids):
        c = centers[np.asarray(ids)]
        return (c - RADIUS).astype(np.float32), (c + RADIUS).astype(np.float32)

    def intersect_fn(pid, rays, tfar):
        c = jnp.asarray(C)[pid]  # inline constant (numpy can't take tracer)
        oc = rays.org - c
        b = jnp.sum(oc * rays.dir, -1)
        dd = jnp.sum(rays.dir * rays.dir, -1)
        disc = b * b - dd * (jnp.sum(oc * oc, -1) - RADIUS * RADIUS)
        ok = disc >= 0
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t0 = (-b - sq) / jnp.maximum(dd, 1e-20)
        t1 = (-b + sq) / jnp.maximum(dd, 1e-20)
        t = jnp.where(t0 > rays.tnear, t0, t1)
        ok = ok & (t > rays.tnear) & (t < tfar)
        pt = rays.org + t[..., None] * rays.dir
        return ok, jnp.where(ok, t, tfar), jnp.zeros_like(t), \
            jnp.zeros_like(t), pt - c

    return bounds_fn, intersect_fn


def build_scene(app=None):
    xs = np.arange(NUM_SPHERES_X) - (NUM_SPHERES_X - 1) / 2.0
    zs = np.arange(NUM_SPHERES_Z) - (NUM_SPHERES_Z - 1) / 2.0
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    centers = np.stack([2.5 * X, np.zeros_like(X), 2.5 * Z],
                       -1).reshape(-1, 3).astype(np.float32)
    state = dict(centers=centers,
                 lazy_state=[LAZY_INVALID] * centers.shape[0],
                 built=0)
    _recommit(state)
    return state


def _recommit(state):
    """Rebuild the scene: real meshes for LAZY_VALID spheres, the bounds
    proxy for the rest, plus the ground plane."""
    dev = Device("ignore_config_files=1")
    scene = Scene(dev)
    centers = state["centers"]
    pending = [i for i, s in enumerate(state["lazy_state"])
               if s != LAZY_VALID]
    for i, s in enumerate(state["lazy_state"]):
        if s == LAZY_VALID:
            v, t = _sphere_mesh(centers[i], RADIUS)
            scene.attach(TriangleMesh(v, t))
    if pending:
        sub = centers[np.asarray(pending)]
        bounds_fn, intersect_fn = _make_bounds_proxy(sub)
        ug = UserGeometry(len(pending), bounds_fn, intersect_fn)
        proxy_gid = scene.attach(ug)
    else:
        proxy_gid = -1
    gv = np.asarray([[-16, -2, -16], [-16, -2, 16], [16, -2, -16],
                     [16, -2, 16]], np.float32)
    gt = np.asarray([[0, 1, 2], [1, 3, 2]], np.int32)
    scene.attach(TriangleMesh(gv, gt))
    state["cscene"] = scene.commit()
    state["proxy_gid"] = proxy_gid
    state["pending"] = pending
    return state


@functools.partial(jax.jit, static_argnames=("width", "height"))
def _trace(cscene, cam_vx, cam_vy, cam_vz, cam_p, *, width, height):
    xs = jnp.arange(width, dtype=jnp.float32)
    ys = jnp.arange(height, dtype=jnp.float32)
    x, y = jnp.meshgrid(xs, ys)
    d = normalize(x[..., None] * cam_vx + y[..., None] * cam_vy + cam_vz)
    org = jnp.broadcast_to(cam_p, d.shape)
    rays = Rays(org, d, jnp.zeros(d.shape[:-1], jnp.float32),
                jnp.full(d.shape[:-1], jnp.inf, jnp.float32))
    hits = scene_intersect(cscene, rays, coherent=True)
    return d, hits


def render_frame(state, camera: Camera, size):
    w, h = size
    vx, vy, vz, p = camera.ispc_camera(w, h)
    d, hits = _trace(state["cscene"], vx, vy, vz, p, width=w, height=h)

    # lazyCreate: any proxy hit promotes that sphere to LAZY_VALID
    if state["proxy_gid"] >= 0:
        proxy_hits = np.asarray(hits.geom_id) == state["proxy_gid"]
        if proxy_hits.any():
            touched = np.unique(np.asarray(hits.prim_id)[proxy_hits])
            for k in touched:
                idx = state["pending"][int(k)]
                state["lazy_state"][idx] = LAZY_VALID
                state["built"] += 1
            _recommit(state)
            d, hits = _trace(state["cscene"], vx, vy, vz, p,
                             width=w, height=h)

    ns = normalize(hits.ng)
    ns = jnp.where(dot(d, ns)[..., None] < 0, ns, -ns)
    shade = 0.2 + 0.8 * jnp.clip(dot(-d, ns), 0.0, 1.0)
    col = jnp.asarray([0.8, 0.8, 0.9], jnp.float32)
    img = jnp.where(hits.valid[..., None], col * shade[..., None], 0.0)
    return img, w * h


def make_app() -> TutorialApplication:
    app = TutorialApplication("lazy_geometry", build_scene, render_frame)
    app.camera = Camera(from_=(6, 6, -10), to=(0, 0, 0))
    return app


if __name__ == "__main__":
    raise SystemExit(make_app().run())
