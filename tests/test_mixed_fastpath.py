"""Mixed-scene kernel dispatch.

Scenes carrying hair / instances / user geometry / filters must NOT
knock the triangle accel off the kernel path: scene_intersect runs the
kernel for the triangle accel and folds the other accels on top, and
intersection filters ride the restart wavefront
(scene.py:_intersect_filter_restart) instead of forcing the XLA chunked
path. These tests select the kernel path with the NumPy twin in place of
the CUDA kernel (conftest `twin_kernel`) and gate on agreement with the
XLA reference fold."""
import jax.numpy as jnp
import numpy as np

import embree_tpu as et
from embree_tpu.scene.curves import BezierCurves
from embree_tpu.verify.fixtures import triangle_sphere


def _rays(rng, n=1024, extent=3.0):
    org = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return et.make_rays(org, d)


def _hair_ball(rng, n_curves=40):
    verts, idx = [], []
    for c in range(n_curves):
        base = rng.uniform(-1, 1, 3).astype(np.float32)
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        for k in range(4):
            p = base + axis * (k / 3.0) * 1.2
            verts.append([p[0], p[1], p[2], 0.03])
        idx.append(4 * c)
    return np.asarray(verts, np.float32), np.asarray(idx, np.int32)


def _check(cs, rays, atol=1e-5):
    """Kernel-dispatch result == XLA fold result."""
    assert cs.gpu is not None
    a = et.scene_intersect(cs, rays)
    b = et.scene_intersect(cs, rays, isa="xla")
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
    m = np.asarray(b.valid)
    np.testing.assert_allclose(np.asarray(a.t)[m], np.asarray(b.t)[m],
                               rtol=1e-4, atol=atol)
    # same accel type won per ray (geom ids agree except t-ties)
    ga, gb = np.asarray(a.geom_id)[m], np.asarray(b.geom_id)[m]
    tie = ~np.isclose(np.asarray(a.t)[m], np.asarray(b.t)[m], rtol=1e-6)
    assert ((ga == gb) | tie).all()
    occ_a = np.asarray(et.scene_occluded(cs, rays))
    occ_b = np.asarray(et.scene_occluded(cs, rays, isa="xla"))
    np.testing.assert_array_equal(occ_a, occ_b)


def test_tris_plus_hair_on_kernel(rng, twin_kernel):
    verts, idx = triangle_sphere((0, 0, 0), 1.6, 16)
    hv, hi = _hair_ball(rng)
    dev = et.Device("ignore_config_files=1,hair_accel=obb")
    s = et.Scene(dev)
    s.attach(et.TriangleMesh(verts, idx))
    s.attach(BezierCurves(hv, hi, tessellation_rate=6))
    cs = s.commit()
    assert cs.hairs
    _check(cs, _rays(rng))


def test_tris_plus_instance_on_kernel(rng, twin_kernel):
    verts, idx = triangle_sphere((0, 0, 0), 1.0, 12)
    dev = et.Device("ignore_config_files=1")
    inner = et.Scene(dev)
    inner.attach(et.TriangleMesh(verts, idx))
    inner.commit()
    xf = np.array([[1, 0, 0, 2.0], [0, 1, 0, 0], [0, 0, 1, 0]], np.float32)
    s = et.Scene(dev)
    s.attach(et.TriangleMesh(verts, idx))
    s.attach(et.Instance(inner, xf))
    cs = s.commit()
    assert cs.instances and cs.instances[0].child.gpu is not None
    _check(cs, _rays(rng, extent=4.0))


def test_tris_plus_user_on_kernel(rng, twin_kernel):
    from embree_tpu.scene.geometry import UserGeometry

    verts, idx = triangle_sphere((0, 0, 0), 1.4, 12)
    centers = rng.uniform(-1.5, 1.5, (8, 3)).astype(np.float32)
    radius = 0.4

    def bounds_fn(i):
        return centers[i] - radius, centers[i] + radius

    def intersect_fn(pid, rays, tfar):
        c = jnp.asarray(centers)[pid]
        oc = rays.org - c
        b = jnp.sum(oc * rays.dir, -1)
        cq = jnp.sum(oc * oc, -1) - radius * radius
        disc = b * b - cq
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t0 = -b - sq
        t1 = -b + sq
        th = jnp.where(t0 > rays.tnear, t0, t1)
        ok = (disc >= 0) & (th > rays.tnear) & (th < tfar)
        p = rays.org + th[..., None] * rays.dir
        ng = p - c
        z = jnp.zeros_like(th)
        return ok, th, z, z, ng

    dev = et.Device("ignore_config_files=1")
    s = et.Scene(dev)
    s.attach(et.TriangleMesh(verts, idx))
    s.attach(UserGeometry(8, bounds_fn, intersect_fn))
    cs = s.commit()
    assert cs.users
    _check(cs, _rays(rng))


def test_filter_restart_on_kernel(rng, twin_kernel):
    """Transparency filter via the restart wavefront on the kernel path:
    exact agreement with the XLA chunked filter path."""
    verts, idx = triangle_sphere((0, 0, 0), 1.5, 16)
    dev = et.Device("ignore_config_files=1")
    s = et.Scene(dev)
    s.attach(et.TriangleMesh(verts, idx))
    cs = s.commit()
    # reject ~half the sphere by primitive parity (forces multi-round
    # restarts: a ray entering the sphere sees front AND back faces)
    def filt(org, d, t, u, v, ng, geom, prim):
        return (prim % 2) == 0

    rays = _rays(rng, n=512)
    a = et.scene_intersect(cs, rays, filter_fn=filt)
    b = et.scene_intersect(cs, rays, isa="xla", filter_fn=filt)
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
    m = np.asarray(b.valid)
    np.testing.assert_allclose(np.asarray(a.t)[m], np.asarray(b.t)[m],
                               rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(a.prim_id)[m],
                                  np.asarray(b.prim_id)[m])
    # accepted hits actually satisfy the filter
    assert (np.asarray(a.prim_id)[m] % 2 == 0).all()


def test_filter_restart_reject_all_and_accept_all(rng, twin_kernel):
    verts, idx = triangle_sphere((0, 0, 0), 1.5, 10)
    dev = et.Device("ignore_config_files=1")
    s = et.Scene(dev)
    s.attach(et.TriangleMesh(verts, idx))
    cs = s.commit()
    rays = _rays(rng, n=256)
    ref = et.scene_intersect(cs, rays, isa="xla")

    h = et.scene_intersect(
        cs, rays,
        filter_fn=lambda org, d, t, u, v, ng, geom, prim:
            jnp.zeros_like(t, bool))
    assert not np.asarray(h.valid).any()

    h = et.scene_intersect(
        cs, rays,
        filter_fn=lambda org, d, t, u, v, ng, geom, prim:
            jnp.ones_like(t, bool))
    np.testing.assert_array_equal(np.asarray(h.valid),
                                  np.asarray(ref.valid))
    m = np.asarray(ref.valid)
    np.testing.assert_allclose(np.asarray(h.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-5)
