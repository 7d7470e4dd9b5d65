"""Multi-device sharding tests on the 8-device virtual CPU mesh
(SURVEY.md §2.7 distributed design; BASELINE.md scaling contract)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import embree_tpu as et
from embree_tpu.diff.hit import intersect_diff
from embree_tpu.dist.sharding import (make_mesh, make_sharded_train_step,
                                      shard_rays, sharded_intersect)
from embree_tpu.verify.fixtures import triangle_sphere


@pytest.fixture(scope="module")
def scene():
    verts, idx = triangle_sphere((0, 0, 0), 1.0, 24)
    dev = et.Device("ignore_config_files=1")
    s = et.Scene(dev)
    s.attach(et.TriangleMesh(verts, idx))
    s.commit()
    return s


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_intersect_matches_single(scene, rng):
    cs = scene.committed
    mesh = make_mesh(8)
    n = 1024
    org = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    rays = et.make_rays(org, d)

    ref = et.scene_intersect(cs, rays, isa="xla")
    srays, r = shard_rays(rays, mesh)
    got = sharded_intersect(cs, srays, mesh, isa="xla")
    got = jax.tree.map(lambda x: x[:r], got)
    np.testing.assert_array_equal(np.asarray(got.valid), np.asarray(ref.valid))
    m = np.asarray(ref.valid)
    np.testing.assert_allclose(np.asarray(got.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-6)


def test_sharded_train_step_descends(scene, rng):
    """Full DP train step: loss decreases and grads agree with the
    unsharded computation (the >=85%-efficiency machinery's correctness
    side)."""
    cs = scene.committed
    mesh = make_mesh(8)
    verts0 = jnp.asarray(np.asarray(cs.tris.v0))

    def loss_fn(scale, rays, target):
        tris = cs.tris._replace(v0=cs.tris.v0 * scale,
                                v1=cs.tris.v1 * scale,
                                v2=cs.tris.v2 * scale)
        cs2 = cs._replace(tris=tris)
        h = intersect_diff(cs2, rays, isa="xla")
        return jnp.sum(jnp.where(h.valid, (h.t - target) ** 2, 0.0))

    step = make_sharded_train_step(mesh, loss_fn)

    n = 512
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = et.make_rays(np.zeros((n, 3), np.float32), d)
    srays, _ = shard_rays(rays, mesh)
    target = jnp.full(srays.tnear.shape, 0.9)  # want radius 0.9, start 1.0

    scale = jnp.float32(1.0)
    losses = []
    for _ in range(5):
        loss, scale = step(scale, srays, target, lr=2e-4)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9
    assert 0.88 < float(scale) < 1.0  # moving toward 0.9

    # grads equal the unsharded value (psum correctness)
    flat = et.Rays(srays.org, srays.dir, srays.tnear, srays.tfar)
    l_ref, g_ref = jax.value_and_grad(loss_fn)(
        jnp.float32(1.0), flat, target)
    l_sh, _ = step(jnp.float32(1.0), srays, target, lr=0.0)
    np.testing.assert_allclose(float(l_sh), float(l_ref), rtol=1e-5)


def test_prim_sharded_ring(rng):
    """Primitive-sharded scene + ray ppermute ring (SURVEY §2.7 last
    axis): D ring hops must reproduce the replicated single-BVH result
    exactly (prim ids bit-equal, t to fp tolerance)."""
    from embree_tpu.build.sah import build_sah
    from embree_tpu.core.rayhit import Rays
    from embree_tpu.dist.prim_shard import (build_prim_sharded,
                                            place_prim_sharded,
                                            prim_sharded_intersect)
    from embree_tpu.dist.sharding import make_mesh
    from embree_tpu.scene.prims import TrianglePrims
    from embree_tpu.traverse.packet import intersect_chunked

    T = 800
    c = rng.random((T, 3)).astype(np.float32) * 4
    v0 = c
    v1 = c + rng.random((T, 3)).astype(np.float32) * 0.4
    v2 = c + rng.random((T, 3)).astype(np.float32) * 0.4
    geom = np.zeros(T, np.int32)
    prim = np.arange(T, dtype=np.int32)
    flip = np.zeros(T, np.int32)

    mesh = make_mesh(8, "sp")
    ps = place_prim_sharded(
        build_prim_sharded(v0, v1, v2, geom, prim, flip, 8), mesh, "sp")

    R = 1024
    org = rng.random((R, 3)).astype(np.float32) * 4
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays(jnp.asarray(org), jnp.asarray(d),
                jnp.zeros(R), jnp.full(R, np.inf))
    h = prim_sharded_intersect(ps, rays, mesh, "sp", packet_size=256)

    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    bvh = build_sah(lo, hi).to_device()
    tris = TrianglePrims(*map(jnp.asarray, (v0, v1, v2, geom, prim, flip)))
    href = intersect_chunked(bvh, tris, rays, packet_size=256)

    hv, rv = np.asarray(h.valid), np.asarray(href.valid)
    assert np.array_equal(hv, rv)
    assert np.allclose(np.asarray(h.t)[hv], np.asarray(href.t)[rv],
                       rtol=1e-5)
    assert np.array_equal(np.asarray(h.prim_id)[hv],
                          np.asarray(href.prim_id)[rv])
    assert np.array_equal(np.asarray(h.gprim)[hv],
                          np.asarray(href.gprim)[rv])


def test_kernel_under_shard_map(rng, twin_kernel):
    """Multi-device runs the kernel path: the traversal kernel (its NumPy
    twin here) under shard_map, ray-sharded over the mesh, against the
    XLA reference."""
    import jax

    import embree_tpu as et
    from embree_tpu.dist.sharding import (make_mesh, shard_rays,
                                          sharded_intersect)
    from embree_tpu.verify.fixtures import triangle_sphere

    verts, idx = triangle_sphere((0, 0, 0), 2.0, 16)
    dev = et.Device("ignore_config_files=1")
    s = et.Scene(dev)
    s.attach(et.TriangleMesh(verts, idx))
    cs = s.commit()
    assert cs.gpu is not None
    n = 1024
    org = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = et.make_rays(org, d)
    ref = et.scene_intersect(cs, rays, isa="xla")

    mesh = make_mesh(min(8, len(jax.devices())))
    srays, _ = shard_rays(rays, mesh)
    h = sharded_intersect(cs, srays, mesh)
    np.testing.assert_array_equal(np.asarray(h.valid)[:n],
                                  np.asarray(ref.valid))
    m = np.asarray(ref.valid)
    np.testing.assert_allclose(np.asarray(h.t)[:n][m], np.asarray(ref.t)[m],
                               rtol=1e-5)
