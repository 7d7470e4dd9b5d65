"""Hair OBB accel (build/hair.py + traverse/hair.py).

VERDICT r2 #6 (third ask): unaligned/OBB acceleration with
strand-aligned clustering and ribbon + swept-cone Bezier leaf
intersectors as a first-class accel. Gates: curve-hit parity against
the segment-callback path, ribbon sanity, and the OBB win itself —
popped nodes on diagonal hair must drop well below the axis-aligned
build (the reason bvh_builder_hair.cpp exists).
"""
import numpy as np
import pytest

import embree_tpu as et
from embree_tpu.scene.curves import BezierCurves


def _hair_ball(rng, n_curves=120, diagonal=False):
    """Random hair: curves roughly along (1,1,1) when diagonal."""
    verts = []
    idx = []
    for c in range(n_curves):
        base = rng.uniform(-1, 1, 3).astype(np.float32)
        if diagonal:
            axis = np.array([1.0, 1.0, 1.0]) / np.sqrt(3.0)
        else:
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
        bow = rng.normal(size=3).astype(np.float32) * 0.05
        r = 0.02
        for k in range(4):
            p = base + axis * (k / 3.0) * 1.2 + bow * np.sin(k * 1.1)
            verts.append([p[0], p[1], p[2], r])
        idx.append(4 * c)
    return (np.asarray(verts, np.float32),
            np.asarray(idx, np.int32))


def _rays(rng, n=800):
    org = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return et.make_rays(org, d)


def _commit(verts, idx, accel, rate=8, flat=False):
    dev = et.Device(f"ignore_config_files=1,hair_accel={accel}")
    s = et.Scene(dev)
    s.attach(BezierCurves(verts, idx, tessellation_rate=rate, flat=flat))
    return s.commit()


def test_obb_round_matches_segment_callback(rng):
    """ROUND leaves re-use the exact swept-cone math on the same Bezier
    tessellation, so the OBB accel must agree with the callback path."""
    verts, idx = _hair_ball(rng)
    rays = _rays(rng)
    cs_obb = _commit(verts, idx, "obb")
    cs_seg = _commit(verts, idx, "segment")
    assert cs_obb.hairs and not cs_seg.hairs
    a = et.scene_intersect(cs_obb, rays, isa="xla")
    b = et.scene_intersect(cs_seg, rays, isa="xla")
    va, vb = np.asarray(a.valid), np.asarray(b.valid)
    # segment caps vs exact sub-segment joins: allow a sliver of edge flips
    assert (va != vb).mean() < 0.01
    m = va & vb
    np.testing.assert_allclose(np.asarray(a.t)[m], np.asarray(b.t)[m],
                               rtol=1e-3, atol=1e-4)
    same = np.asarray(a.prim_id)[m] == np.asarray(b.prim_id)[m]
    assert same.mean() > 0.98          # ties at curve crossings only


def test_obb_occluded(rng):
    verts, idx = _hair_ball(rng)
    rays = _rays(rng, 500)
    cs = _commit(verts, idx, "obb")
    occ = np.asarray(et.scene_occluded(cs, rays, isa="xla"))
    hit = np.asarray(et.scene_intersect(cs, rays, isa="xla").valid)
    np.testing.assert_array_equal(occ, hit)    # curves only: same set


def test_ribbon_flat_curves(rng):
    """FLAT curves use the ribbon intersector: a thick straight curve
    hit head-on must report t at the curve axis depth (the ribbon faces
    the ray), and miss beyond the radius."""
    verts = np.array([[0, 0, 0, 0.1], [0, 0.33, 0, 0.1],
                      [0, 0.66, 0, 0.1], [0, 1, 0, 0.1]], np.float32)
    idx = np.array([0], np.int32)
    cs = _commit(verts, idx, "obb", flat=True)
    org = np.array([[0.05, 0.5, 2.0], [0.3, 0.5, 2.0]], np.float32)
    d = np.array([[0, 0, -1.0], [0, 0, -1.0]], np.float32)
    h = et.scene_intersect(cs, et.make_rays(org, d), isa="xla")
    valid = np.asarray(h.valid)
    assert valid[0] and not valid[1]
    np.testing.assert_allclose(float(h.t[0]), 2.0, atol=1e-3)


def test_obb_beats_aabb_on_diagonal_hair(rng):
    """The point of the OBB accel: diagonal strands in axis-aligned
    boxes are mostly air. Compare popped-node counts (STAT3 trav_nodes
    analog) of the strand-aligned build vs an axis-aligned build over
    the same curves — the OBB walk must pop several-fold fewer nodes."""
    import jax.numpy as jnp
    from embree_tpu.build.hair import HairCluster, build_hair_clusters
    from embree_tpu.build.sah import BuildSettings, build_sah
    from embree_tpu.traverse.hair import make_round_curve_intersector
    from embree_tpu.traverse.user import UserAccel, intersect_user
    from embree_tpu.core.rayhit import Rays

    verts, idx = _hair_ball(rng, n_curves=200, diagonal=True)
    cps = np.stack([verts[idx + k] for k in range(4)], 1)
    cp3, rad = cps[:, :, :3], cps[:, :, 3]
    rays = _rays(rng, 1024)
    flat = Rays(rays.org.reshape(-1, 3), rays.dir.reshape(-1, 3),
                rays.tnear.reshape(-1), rays.tfar.reshape(-1))

    def pops_of(clusters):
        total = 0
        for cl in clusters:
            rcps = cp3[cl.members] @ cl.rot
            fn = make_round_curve_intersector(rcps, rad[cl.members],
                                              cl.members, K=8)
            Rm = jnp.asarray(cl.rot)
            rr = Rays(flat.org @ Rm, flat.dir @ Rm, flat.tnear, flat.tfar)
            out = intersect_user(
                UserAccel(cl.bvh, 0, int(cl.members.shape[0])), fn, rr,
                flat.tfar, with_stats=True)
            total += int(out[-1])
        return total

    obb = build_hair_clusters(cp3, rad)
    # axis-aligned control: identity frame, one cluster
    rmax = rad.max(axis=1, keepdims=True)
    lo = cp3.min(axis=1) - rmax
    hi = cp3.max(axis=1) + rmax
    aabb = [HairCluster(rot=np.eye(3, dtype=np.float32),
                        bvh=build_sah(lo, hi, BuildSettings()).to_device(),
                        members=np.arange(cp3.shape[0], dtype=np.int32))]
    p_obb = pops_of(obb)
    p_aabb = pops_of(aabb)
    assert p_obb * 2 <= p_aabb, (p_obb, p_aabb)
