"""Ray-mask and backface-culling tests (verify.cpp RayMasksTest :2286
and BackfaceCullingTest :2346 analogs)."""
import numpy as np
import pytest

import embree_tpu as et
from embree_tpu import rtcore as rtc


def _quad_mesh(z):
    # unit quad at depth z facing +z (two CCW triangles)
    v = np.array([[-1, -1, z], [1, -1, z], [1, 1, z], [-1, 1, z]], np.float32)
    i = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return et.TriangleMesh(v, i)


def test_ray_masks_per_geometry():
    """Four stacked quads with masks 1,2,4,8; a ray with mask m must hit
    the nearest quad whose (geom.mask & m) != 0 (verify.cpp:2286)."""
    dev = et.Device("ignore_config_files=1")
    scene = et.Scene(dev)
    gids = []
    for k in range(4):
        g = _quad_mesh(float(k))
        g.mask = 1 << k
        gids.append(scene.attach(g))
    scene.commit()

    org = np.tile(np.array([0.0, 0.0, -1.0], np.float32), (6, 1))
    d = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (6, 1))
    rays = et.make_rays(org, d)
    masks = np.array([1, 2, 4, 8, 0, 0xF], np.int32)
    hits = scene.intersect(rays, mask=masks)
    geo = np.asarray(hits.geom_id)
    # mask 1<<k hits quad k; mask 0 misses; mask 0xF hits nearest (quad 0)
    assert list(geo[:4]) == gids
    assert geo[4] == -1
    assert geo[5] == gids[0]
    # t matches the quad depth + 1
    t = np.asarray(hits.t)
    np.testing.assert_allclose(t[:4], [1.0, 2.0, 3.0, 4.0], rtol=1e-5)

    occ = np.asarray(scene.occluded(rays, mask=masks))
    assert list(occ) == [True, True, True, True, False, True]


def test_ray_masks_default_matches_all():
    dev = et.Device("ignore_config_files=1")
    scene = et.Scene(dev)
    scene.attach(_quad_mesh(0.0))  # default mask -1
    scene.commit()
    rays = et.make_rays(np.array([[0, 0, -1.0]], np.float32),
                        np.array([[0, 0, 1.0]], np.float32))
    h1 = scene.intersect(rays, mask=np.array([123], np.int32))
    h2 = scene.intersect(rays)
    assert np.asarray(h1.geom_id)[0] == np.asarray(h2.geom_id)[0] == 0


def test_rtc_set_geometry_mask_shim():
    dev = rtc.rtcNewDevice("ignore_config_files=1")
    scene = rtc.rtcNewScene(dev)
    g = rtc.rtcNewGeometry(dev, rtc.RTC_GEOMETRY_TYPE_TRIANGLE)
    v = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    i = np.array([[0, 1, 2]], np.int32)
    rtc.rtcSetSharedGeometryBuffer(g, rtc.RTC_BUFFER_TYPE_VERTEX, 0, v)
    rtc.rtcSetSharedGeometryBuffer(g, rtc.RTC_BUFFER_TYPE_INDEX, 0, i)
    rtc.rtcSetGeometryMask(g, 0x2)
    rtc.rtcCommitGeometry(g)
    rtc.rtcAttachGeometry(scene, g)
    rtc.rtcCommitScene(scene)
    rays = et.make_rays(np.array([[0, 0, -1.0]], np.float32),
                        np.array([[0, 0, 1.0]], np.float32))
    h_hit = scene.intersect(rays, mask=np.array([2], np.int32))
    h_miss = scene.intersect(rays, mask=np.array([1], np.int32))
    assert np.asarray(h_hit.geom_id)[0] == 0
    assert np.asarray(h_miss.geom_id)[0] == -1


@pytest.mark.parametrize("isa", ["xla", "cuda"])
def test_backface_culling(isa, monkeypatch):
    """With backface_culling=1, only front-facing hits (dot(Ng, dir) < 0)
    stand (verify.cpp:2346). The quad faces +z with Ng pointing -z. The
    cuda case runs the kernel path with its NumPy twin."""
    if isa == "cuda":
        from embree_tpu.traverse import gpu
        monkeypatch.setattr(gpu, "_platform", lambda: "gpu")
        monkeypatch.setattr(gpu, "_kernel_call", gpu.twin_call)
    dev = et.Device(f"ignore_config_files=1,backface_culling=1,isa={isa}")
    scene = et.Scene(dev)
    scene.attach(_quad_mesh(0.0))
    scene.commit()
    org_front = np.array([[0.2, 0.2, -1.0]], np.float32)
    org_back = np.array([[0.2, 0.2, 1.0]], np.float32)
    d_fwd = np.array([[0, 0, 1.0]], np.float32)
    d_bwd = np.array([[0, 0, -1.0]], np.float32)
    h_front = scene.intersect(et.make_rays(org_front, d_fwd))
    h_back = scene.intersect(et.make_rays(org_back, d_bwd))
    hit_f = int(np.asarray(h_front.geom_id)[0])
    hit_b = int(np.asarray(h_back.geom_id)[0])
    # exactly one side is culled
    assert (hit_f == -1) != (hit_b == -1)
    occ_f = bool(np.asarray(scene.occluded(et.make_rays(org_front, d_fwd)))[0])
    occ_b = bool(np.asarray(scene.occluded(et.make_rays(org_back, d_bwd)))[0])
    assert occ_f != occ_b
    assert occ_f == (hit_f != -1)


def test_backface_culling_off_hits_both_sides():
    dev = et.Device("ignore_config_files=1")
    scene = et.Scene(dev)
    scene.attach(_quad_mesh(0.0))
    scene.commit()
    h1 = scene.intersect(et.make_rays(np.array([[0, 0, -1.0]], np.float32),
                                      np.array([[0, 0, 1.0]], np.float32)))
    h2 = scene.intersect(et.make_rays(np.array([[0, 0, 1.0]], np.float32),
                                      np.array([[0, 0, -1.0]], np.float32)))
    assert np.asarray(h1.geom_id)[0] == 0
    assert np.asarray(h2.geom_id)[0] == 0
