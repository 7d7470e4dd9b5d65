"""The CUDA traversal path (traverse/gpu.py, native/bvh_traverse.cu).

The kernel itself runs only on a GPU (`gpu` marker). Everything around
it runs here: the NumPy twin of the kernel's loop over the packed layout
against the XLA walk and a float64 brute force, the layout packer, the
stack sizing, the wrapper's shapes and empty cases with the twin in place
of the FFI call, the zero-gradient rule, the stats counters, the choice
of kernel and the compile-cache helper."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import embree_tpu as et
from embree_tpu.core.rayhit import Rays
from embree_tpu.traverse import gpu as G
from embree_tpu.verify.fixtures import (bruteforce_closest, random_triangles,
                                        triangle_sphere)


def _scene(verts, idx, cfg=""):
    s = et.Scene(et.Device("ignore_config_files=1" + cfg))
    s.attach(et.TriangleMesh(verts, idx))
    s.commit()
    return s


def _layout(s, verts, idx):
    v = np.asarray(verts, np.float32)
    i = np.asarray(idx)
    return G.pack_gpu_bvh(s._bvh_host, v[i[:, 0]], v[i[:, 1]], v[i[:, 2]])


def _rays8(org, d, tnear=0.0, tfar=np.inf):
    n = org.shape[0]
    return np.concatenate([org, np.full((n, 1), tnear, np.float32), d,
                           np.full((n, 1), tfar, np.float32)], 1)


def _random_rays(rng, n, extent):
    org = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


def _case(name, rng):
    """(verts, idx, org, d, device cfg) for the twin-vs-XLA matrix."""
    if name.startswith("rand"):
        ntri, nray = {"rand40": (40, 200), "rand700": (700, 300),
                      "rand2500": (2500, 500)}[name]
        verts, idx = random_triangles(rng, ntri, extent=5.0, size=1.2)
        return (verts, idx) + _random_rays(rng, nray, 8.0) + ("",)
    if name == "inside":      # origins inside the closed mesh
        verts, idx = triangle_sphere((0, 0, 0), 2.0, 24)
        return (verts, idx) + _random_rays(rng, 800, 3.0) + ("",)
    if name == "adversarial":  # dense overlapping shell, rays to center
        verts, idx = random_triangles(rng, 3000, extent=1.5, size=0.9)
        d = rng.normal(size=(512, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return verts, idx, (-d * 6.0).astype(np.float32), d, ""
    if name == "deep":        # ~80k-triangle tree, stack depth from commit
        verts, idx = triangle_sphere((0, 0, 0), 2.0, 200)
        return (verts, idx) + _random_rays(rng, 192, 3.0) + ("",)
    if name == "bvh8":
        verts, idx = triangle_sphere((0, 0, 0), 2.0, 30)
        return ((verts, idx) + _random_rays(rng, 400, 3.0)
                + (",tri_accel=bvh8.triangle4",))
    if name == "cull":
        verts, idx = triangle_sphere((0, 0, 0), 2.0, 24)
        return ((verts, idx) + _random_rays(rng, 600, 3.0)
                + (",backface_culling=1",))
    raise KeyError(name)


def _assert_hits_match(valid, t, prim, ref_valid, ref_t, ref_prim,
                       rel=1e-5):
    np.testing.assert_array_equal(valid, ref_valid)
    m = ref_valid
    np.testing.assert_allclose(t[m], ref_t[m], rtol=rel)
    diff = prim[m] != ref_prim[m]        # prims may differ only at t ties
    np.testing.assert_allclose(t[m][diff], ref_t[m][diff], rtol=rel)


@pytest.mark.parametrize("case", ["rand40", "rand700", "rand2500", "inside",
                                  "adversarial", "deep", "bvh8", "cull"])
def test_twin_matches_xla(rng, case):
    """Closest hit and any-hit of the kernel's loop (NumPy twin) against
    the XLA walk on the same committed scene."""
    verts, idx, org, d, cfg = _case(case, rng)
    s = _scene(verts, idx, cfg)
    cs = s.committed
    gs = _layout(s, verts, idx)
    cull = bool(cs.backface_cull)
    rays = et.make_rays(org, d)
    ref = et.scene_intersect(cs, rays, isa="xla")
    t, prim, st = G.traverse_twin(gs.nodes, gs.tris, gs.prim_order,
                                  _rays8(org, d), width=gs.width,
                                  stack=gs.stack, occluded=False, cull=cull)
    _assert_hits_match(prim >= 0, t, prim, np.asarray(ref.valid),
                       np.asarray(ref.t), np.asarray(ref.gprim))
    assert st[:, 2].sum() == 0
    occ = np.asarray(et.scene_occluded(cs, rays, isa="xla"))
    to, po, so = G.traverse_twin(gs.nodes, gs.tris, gs.prim_order,
                                 _rays8(org, d), width=gs.width,
                                 stack=gs.stack, occluded=True, cull=cull)
    np.testing.assert_array_equal(po >= 0, occ)
    assert (to[po >= 0] == -np.inf).all()
    # any-hit stops early: never more work than closest hit
    assert so[:, 0].sum() <= st[:, 0].sum()


@pytest.mark.parametrize("n", [6, 20])
def test_twin_matches_bruteforce(rng, n):
    """Against an independent float64 all-pairs oracle: same hit set up to
    edge-grazing rays, t to float32 precision."""
    verts, idx = triangle_sphere((0, 0, 0), 2.0, n)
    s = _scene(verts, idx)
    gs = _layout(s, verts, idx)
    org, d = _random_rays(rng, 300, 3.0)
    t, prim, _ = G.traverse_twin(gs.nodes, gs.tris, gs.prim_order,
                                 _rays8(org, d), width=4, stack=gs.stack,
                                 occluded=False, cull=False)
    v = np.asarray(verts)
    tb, pb = bruteforce_closest(v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]],
                                org, d)
    agree = (prim >= 0) == (pb >= 0)
    assert agree.mean() >= 0.99
    m = agree & (pb >= 0)
    np.testing.assert_allclose(t[m], tb[m], rtol=1e-4)


@pytest.mark.parametrize("width", [4, 8])
def test_pack_gpu_bvh_roundtrip(rng, width):
    verts, idx = random_triangles(rng, 300, extent=4.0)
    s = _scene(verts, idx, f",tri_accel=bvh{width}.triangle4")
    gs = _layout(s, verts, idx)
    bvh = s._bvh_host
    W = gs.width
    assert W == width
    nodes = np.asarray(gs.nodes).reshape(-1, 8, W)
    np.testing.assert_array_equal(nodes[:, 0:3].transpose(0, 2, 1),
                                  np.asarray(bvh.lower))
    np.testing.assert_array_equal(nodes[:, 3:6].transpose(0, 2, 1),
                                  np.asarray(bvh.upper))
    np.testing.assert_array_equal(nodes[:, 6].view(np.int32), bvh.child)
    np.testing.assert_array_equal(nodes[:, 7].view(np.int32), bvh.count)
    assert nodes.shape[1] * W * 4 == 32 * W      # 128-byte BVH4 line
    order = np.asarray(bvh.prim_order)
    v = np.asarray(verts)
    v0, v1, v2 = (v[idx[order, k]] for k in range(3))
    tr = np.asarray(gs.tris)
    np.testing.assert_array_equal(tr[:, 0:3], v0)
    np.testing.assert_array_equal(tr[:, 3:6], v0 - v1)
    np.testing.assert_array_equal(tr[:, 6:9], v2 - v0)
    np.testing.assert_array_equal(tr[:, 9:12], np.cross(v2 - v0, v0 - v1))
    np.testing.assert_array_equal(np.asarray(gs.prim_order), order)


@pytest.mark.parametrize("depth,width,stack", [
    (6, 4, 64), (21, 4, 64), (22, 4, 128), (30, 8, 256)])
def test_stack_capacity(depth, width, stack):
    """(W-1)*depth + 1 entries bound a nearest-first walk."""
    assert G.stack_capacity(depth, width) == stack


def test_stack_capacity_too_deep_warns():
    with pytest.warns(UserWarning, match="overflow"):
        assert G.stack_capacity(200, 4) == G.STACK_SIZES[-1]


def test_tree_depth_and_overflow_counter(rng):
    """A layout with a stack too small for its tree counts overflows
    instead of dropping them silently."""
    verts, idx = triangle_sphere((0, 0, 0), 2.0, 40)
    s = _scene(verts, idx)
    gs = _layout(s, verts, idx)
    depth = G.tree_depth(np.asarray(s._bvh_host.child),
                         np.asarray(s._bvh_host.count))
    assert depth >= 3 and gs.stack >= 3 * depth + 1
    org, d = _random_rays(rng, 256, 3.0)
    _t, _p, st = G.traverse_twin(gs.nodes, gs.tris, gs.prim_order,
                                 _rays8(org, d), width=4, stack=2,
                                 occluded=False, cull=False)
    assert st[:, 2].sum() > 0


@pytest.mark.parametrize("shape", [(7,), (129,), (1025,), (6, 5), (0,)])
def test_wrapper_shapes(rng, twin_kernel, shape):
    """scene_intersect/scene_occluded on the kernel path: batch shapes,
    sizes that are no multiple of the block, and empty batches."""
    verts, idx = triangle_sphere((0, 0, 0), 1.5, 10)
    s = _scene(verts, idx)
    cs = s.committed
    assert cs.gpu is not None
    n = int(np.prod(shape))
    org, d = _random_rays(rng, n, 3.0)
    rays = et.make_rays(org.reshape(shape + (3,)), d.reshape(shape + (3,)))
    h = et.scene_intersect(cs, rays)
    assert h.t.shape == shape and h.ng.shape == shape + (3,)
    occ = et.scene_occluded(cs, rays)
    assert occ.shape == shape
    if n == 0:
        return
    ref = et.scene_intersect(cs, rays, isa="xla")
    np.testing.assert_array_equal(np.asarray(h.valid), np.asarray(ref.valid))
    m = np.asarray(ref.valid)
    np.testing.assert_allclose(np.asarray(h.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(h.u)[m], np.asarray(ref.u)[m],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(occ), np.asarray(et.scene_occluded(cs, rays, isa="xla")))


def test_wrapper_empty_scene(twin_kernel):
    """No triangles: no layout, no kernel call, every ray misses."""
    s = et.Scene(et.Device("ignore_config_files=1"))
    cs = s.commit()
    assert cs.gpu is None
    rays = et.make_rays(np.zeros((5, 3), np.float32),
                        np.tile(np.float32([0, 0, 1]), (5, 1)))
    assert not np.asarray(et.scene_intersect(cs, rays).valid).any()
    assert not np.asarray(et.scene_occluded(cs, rays)).any()
    empty = G.pack_gpu_bvh(s._bvh_host, *(np.zeros((0, 3), np.float32),) * 3)
    t, prim = G.traverse(empty, rays)
    assert (np.asarray(prim) == -1).all() and np.isinf(np.asarray(t)).all()


def test_zero_gradient_rule(rng, twin_kernel):
    """The traversal's custom_vjp gives zero cotangents to its inputs;
    the loss gradient comes from diff/hit.py alone and equals the XLA
    walk's."""
    from embree_tpu.diff.hit import hit_t_grad

    verts, idx = triangle_sphere((0, 0, 0), 2.0, 12)
    cs = _scene(verts, idx).committed
    org, d = _random_rays(rng, 300, 3.0)
    rays = et.make_rays(org, d)

    def t_sum(o):
        t, prim = G.traverse(cs.gpu, Rays(o, rays.dir, rays.tnear,
                                          rays.tfar))
        return jnp.sum(jnp.where(prim >= 0, t, 0.0))

    g = jax.grad(t_sum)(rays.org)
    assert not np.asarray(g).any()

    idxd = jnp.asarray(idx)

    def loss(v, isa):
        sel = jax.lax.stop_gradient(et.scene_intersect(cs, rays, isa=isa))
        t = hit_t_grad(v, idxd, rays, sel.gprim, sel.valid, sel.t,
                       tris=cs.tris)
        return jnp.sum(jnp.where(sel.valid, t, 0.0))

    v = jnp.asarray(verts)
    gk = jax.jit(jax.grad(loss), static_argnums=1)(v, "default")
    gx = jax.jit(jax.grad(loss), static_argnums=1)(v, "xla")
    assert np.abs(np.asarray(gk)).sum() > 0
    np.testing.assert_allclose(np.asarray(gk), np.asarray(gx), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("platform,isa,want", [
    ("cpu", "default", "xla"), ("cpu", "xla", "xla"),
    ("gpu", "default", "cuda"), ("gpu", "cuda", "cuda"),
    ("gpu", "xla", "xla"),
])
def test_select_traversal(monkeypatch, platform, isa, want):
    monkeypatch.setattr(G, "_platform", lambda: platform)
    assert G.select_traversal(isa) == want


def test_select_traversal_cuda_off_gpu_raises(monkeypatch):
    monkeypatch.setattr(G, "_platform", lambda: "cpu")
    with pytest.raises(RuntimeError, match="needs a GPU"):
        G.select_traversal("cuda")


def test_select_traversal_unknown_isa():
    with pytest.raises(ValueError, match="unknown isa"):
        G.select_traversal("pallas")


def test_compile_cache_dir(monkeypatch):
    from embree_tpu.core import device

    seen = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert device.use_compile_cache() == "/elsewhere/cache"
    assert seen == []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    path = device.use_compile_cache()
    assert path == device.COMPILE_CACHE_DIR
    assert path.endswith(".jax_cache")
    assert seen == [("jax_compilation_cache_dir", path)]


def test_native_library_keyed_on_host(monkeypatch):
    """A -march=native builder library built on one host is never loaded
    on another: the file name hashes the host CPU."""
    from embree_tpu.build import native

    a = native.library_path()
    monkeypatch.setattr(native, "_host_cpu", lambda: "some other cpu")
    assert native.library_path() != a


def test_cuda_build_flags(monkeypatch):
    """sm_90a on Hopper, --fmad=false, FFI headers on the include path."""
    monkeypatch.setattr(G, "_arch", lambda: "90a")
    flags = G.build_flags()
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "--fmad=false" in flags
    assert jax.ffi.include_dir() in flags


@pytest.mark.gpu
def test_kernel_matches_twin(gpu, rng):
    """On the card: the compiled kernel against its NumPy twin, both
    widths, closest and any-hit, with and without culling."""
    for width in (4, 8):
        verts, idx = triangle_sphere((0, 0, 0), 2.0, 60)
        s = _scene(verts, idx, f",tri_accel=bvh{width}.triangle4")
        gs = s.committed.gpu
        org, d = _random_rays(rng, 4096, 3.0)
        r8 = jnp.asarray(_rays8(org, d))
        for occluded in (False, True):
            for cull in (False, True):
                kw = dict(width=gs.width, stack=gs.stack,
                          occluded=int(occluded), cull=int(cull))
                tk, pk, sk = G._kernel_call(gs.nodes, gs.tris,
                                            gs.prim_order, r8, **kw)
                tt, pt, stt = G.traverse_twin(gs.nodes, gs.tris,
                                              gs.prim_order, r8, **kw)
                np.testing.assert_array_equal(np.asarray(pk), pt)
                np.testing.assert_allclose(np.asarray(tk), tt, rtol=1e-6)
                np.testing.assert_array_equal(np.asarray(sk), stt)
