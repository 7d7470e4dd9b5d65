"""Motion-blur tests (MB builders/intersectors, verify MB matrix analog)."""
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0xB10)


def _sphere(res):
    from embree_tpu.verify.fixtures import triangle_sphere
    return triangle_sphere((0, 0, 0), 2.0, res)


import embree_tpu as et


def test_mb_triangle_interpolates():
    # triangle sweeping from x=0 to x=4 over the shutter
    v0 = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    v1 = v0 + np.array([4, 0, 0], np.float32)
    idx = np.array([[0, 1, 2]], np.int32)
    dev = et.Device("ignore_config_files=1")
    s = et.Scene(dev)
    s.attach(et.TriangleMeshMB(v0, v1, idx))
    s.commit()

    org = np.array([[0, 0, 5], [2, 0, 5], [4, 0, 5]], np.float32)
    d = np.array([[0, 0, -1]] * 3, np.float32)
    rays = et.make_rays(org, d)

    h0 = s.intersect(rays, time=0.0)
    hh = s.intersect(rays, time=0.5)
    h1 = s.intersect(rays, time=1.0)
    assert list(np.asarray(h0.valid)) == [True, False, False]
    assert list(np.asarray(hh.valid)) == [False, True, False]
    assert list(np.asarray(h1.valid)) == [False, False, True]
    np.testing.assert_allclose(float(hh.t[1]), 5.0, atol=1e-4)


def test_mb_per_ray_time():
    v0 = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    v1 = v0 + np.array([4, 0, 0], np.float32)
    idx = np.array([[0, 1, 2]], np.int32)
    dev = et.Device("ignore_config_files=1")
    s = et.Scene(dev)
    s.attach(et.TriangleMeshMB(v0, v1, idx))
    s.commit()
    org = np.array([[0, 0, 5], [4, 0, 5]], np.float32)
    d = np.array([[0, 0, -1]] * 2, np.float32)
    h = s.intersect(et.make_rays(org, d), time=np.array([0.0, 1.0], np.float32))
    assert list(np.asarray(h.valid)) == [True, True]


def test_mb_combined_with_static():
    v0 = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    vmb0 = v0 + np.array([0, 0, 2], np.float32)
    vmb1 = v0 + np.array([0, 0, 3], np.float32)
    idx = np.array([[0, 1, 2]], np.int32)
    dev = et.Device("ignore_config_files=1")
    s = et.Scene(dev)
    s.attach(et.TriangleMesh(v0, idx))                 # static at z=0
    s.attach(et.TriangleMeshMB(vmb0, vmb1, idx))       # moving z=2..3
    s.commit()
    rays = et.make_rays(np.array([[0, 0, 5]], np.float32),
                        np.array([[0, 0, -1]], np.float32))
    h = s.intersect(rays, time=0.0)
    np.testing.assert_allclose(float(h.t[0]), 3.0, atol=1e-4)  # MB closer
    assert int(h.geom_id[0]) == 1
    h = s.intersect(rays, time=1.0)
    np.testing.assert_allclose(float(h.t[0]), 2.0, atol=1e-4)


def test_multisegment_four_timesteps(rng):
    """N=4 timesteps with NON-linear (piecewise) motion: hits at segment
    interior times match a static scene built at the exact interpolated
    positions (bvh_builder_msmblur.h multi-segment semantics)."""
    import embree_tpu as et
    verts, idx = _sphere(12)
    # zig-zag motion: t=0 -> +x, t=1/3 -> +y, t=2/3 -> -x, t=1 -> done
    offs = [np.zeros(3), np.float32([0.5, 0, 0]),
            np.float32([0.5, 0.7, 0]), np.float32([-0.2, 0.7, 0.3])]
    ts = [verts + o.astype(np.float32) for o in offs]
    dev = et.Device("ignore_config_files=1")
    s = et.Scene(dev)
    s.attach(et.TriangleMeshMB(indices=idx, timesteps=ts))
    s.commit()

    n = 4000
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org = np.zeros((n, 3), np.float32)
    rays = et.make_rays(org, d)

    for tq in (0.0, 0.18, 1.0 / 3.0, 0.5, 0.83, 1.0):
        h = s.intersect(rays, time=np.full(n, tq, np.float32))
        # static reference at the interpolated cage
        x = tq * 3
        a = int(min(np.floor(x), 2))
        w = np.float32(x - a)
        vref = (1 - w) * ts[a] + w * ts[a + 1]
        dev2 = et.Device("ignore_config_files=1")
        s2 = et.Scene(dev2)
        s2.attach(et.TriangleMesh(vref, idx))
        s2.commit()
        href = s2.intersect(rays)
        np.testing.assert_array_equal(np.asarray(h.valid),
                                      np.asarray(href.valid))
        m = np.asarray(href.valid)
        np.testing.assert_allclose(np.asarray(h.t)[m],
                                   np.asarray(href.t)[m], rtol=2e-5,
                                   atol=2e-6)


def test_temporal_splits_mb4d(rng):
    """VERDICT r4 #5: object-vs-temporal split competition. Two prim
    clusters swap positions over time, so a single union topology is
    terrible; the builder must emit MB4D time-gated subtrees
    (bvh_builder_msmblur.h / heuristic_timesplit_array.h semantics) and
    the per-knot SAH cost of the split tree must beat the union tree by
    >= 1.3x. Hits must match a brute-force lerp at random times."""
    import jax.numpy as jnp
    from embree_tpu.build.bvh import sah_cost

    n = 220
    tris = []
    # cluster A sweeps left->right, cluster B right->left (crossing)
    for k in range(n):
        base = rng.uniform(-1, 1, 3).astype(np.float32)
        tris.append(base)
    tris = np.asarray(tris)
    e1 = rng.normal(size=(n, 3)).astype(np.float32) * 0.05
    e2 = rng.normal(size=(n, 3)).astype(np.float32) * 0.05
    half = n // 2
    off0 = np.where(np.arange(n)[:, None] < half, [-6.0, 0, 0],
                    [6.0, 0, 0]).astype(np.float32)
    off1 = -off0
    verts_t = []
    S = 5
    for s in range(S):
        w = s / (S - 1)
        off = (1 - w) * off0 + w * off1
        p0 = tris + off
        verts_t.append(np.concatenate([p0, p0 + e1, p0 + e2]))
    idx = np.stack([np.arange(n), np.arange(n) + n,
                    np.arange(n) + 2 * n], 1).astype(np.int32)

    dev = et.Device("ignore_config_files=1")
    s_ = et.Scene(dev)
    s_.attach(et.TriangleMeshMB(indices=idx, timesteps=verts_t))
    cs = s_.commit()
    mb = cs.mb
    assert mb.has_time_splits, "temporal splits did not trigger"
    tlo = np.asarray(mb.time_lo[0])
    assert (tlo > 0).any()   # root children carry real subranges

    # SAH competition gate: per-knot cost of the gated subtrees vs a
    # fresh union-topology build of the same scene
    from embree_tpu.build.sah import BuildSettings, build_sah
    from embree_tpu.build.refit import plan_refit, refit
    from embree_tpu.scene.prims import prim_bounds_np
    los = []
    his = []
    for v in verts_t:
        lo, hi = prim_bounds_np(v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]])
        los.append(lo)
        his.append(hi)
    lo_u = np.minimum.reduce(los)
    hi_u = np.maximum.reduce(his)
    union_np = build_sah(lo_u, hi_u, BuildSettings())
    union_dev = union_np.to_device()
    sched = plan_refit(union_dev)
    worst_union = max(
        sah_cost(union_np._replace(
            lower=np.asarray(refit(union_dev, sched, jnp.asarray(los[s]),
                                   jnp.asarray(his[s])).lower),
            upper=np.asarray(refit(union_dev, sched, jnp.asarray(los[s]),
                                   jnp.asarray(his[s])).upper)))
        for s in range(S))
    # per-knot cost of the subtree VALID at that knot (range gated)
    ch0 = np.asarray(mb.bvh.child)[0]
    cn0 = np.asarray(mb.bvh.count)[0]
    thi0 = np.asarray(mb.time_hi)[0]
    tlo0 = np.asarray(mb.time_lo)[0]
    bases = [int(ch0[r]) for r in range(ch0.shape[0]) if cn0[r] == 0]
    ends = bases[1:] + [np.asarray(mb.bvh.child).shape[0]]
    worst_split = 0.0
    for s in range(S):
        tk = s / (S - 1)
        for r, (b0, b1) in enumerate(zip(bases, ends)):
            if tlo0[r] <= tk <= thi0[r]:
                worst_split = max(worst_split, sah_cost(union_np._replace(
                    lower=np.asarray(mb.lower_ts[s])[b0:b1],
                    upper=np.asarray(mb.upper_ts[s])[b0:b1],
                    child=np.asarray(mb.bvh.child)[b0:b1],
                    count=np.asarray(mb.bvh.count)[b0:b1])))
                break
    assert worst_union > 1.3 * worst_split, (worst_union, worst_split)

    # correctness at random times vs brute force
    nray = 300
    org = rng.uniform(-8, 8, (nray, 3)).astype(np.float32)
    d = rng.normal(size=(nray, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmv = rng.uniform(0, 1, nray).astype(np.float32)
    h = cs and et.scene_intersect(cs, et.make_rays(org, d), isa="xla",
                                  time=tmv)
    # brute force lerp
    x = np.clip(tmv, 0, 1) * (S - 1)
    seg = np.clip(x.astype(np.int32), 0, S - 2)
    w = (x - seg)[:, None, None]
    va = np.stack(verts_t)
    vi = va[seg] * (1 - w) + va[seg + 1] * w    # (R, V, 3)
    hit_any = np.zeros(nray, bool)
    t_best = np.full(nray, np.inf)
    for k in range(n):
        v0 = vi[:, idx[k, 0]]
        v1 = vi[:, idx[k, 1]]
        v2 = vi[:, idx[k, 2]]
        ng = np.cross(v1 - v0, v2 - v0)
        den = np.einsum("ij,ij->i", ng, d)
        ok = np.abs(den) > 1e-12
        t = np.einsum("ij,ij->i", ng, v0 - org) / np.where(ok, den, 1.0)
        p = org + t[:, None] * d
        wv = p - v0
        d00 = np.einsum("ij,ij->i", v1 - v0, v1 - v0)
        d01 = np.einsum("ij,ij->i", v1 - v0, v2 - v0)
        d11 = np.einsum("ij,ij->i", v2 - v0, v2 - v0)
        d20 = np.einsum("ij,ij->i", wv, v1 - v0)
        d21 = np.einsum("ij,ij->i", wv, v2 - v0)
        det = np.maximum(d00 * d11 - d01 * d01, 1e-20)
        u = (d11 * d20 - d01 * d21) / det
        vv = (d00 * d21 - d01 * d20) / det
        okk = ok & (t > 1e-5) & (u >= -1e-6) & (vv >= -1e-6) \
            & (u + vv <= 1 + 1e-6) & (t < t_best)
        t_best = np.where(okk, t, t_best)
        hit_any |= okk
    np.testing.assert_array_equal(np.asarray(h.valid), hit_any)
    m = hit_any
    np.testing.assert_allclose(np.asarray(h.t)[m], t_best[m], rtol=1e-4)


def test_quad_mb(rng):
    """QuadMeshMB: MB quads hit with correct uv flip semantics."""
    v0 = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                  np.float32)
    v1 = v0 + np.array([0, 0, 2], np.float32)
    q = np.array([[0, 1, 2, 3]], np.int32)
    dev = et.Device("ignore_config_files=1")
    s = et.Scene(dev)
    s.attach(et.QuadMeshMB(v0, v1, q))
    cs = s.commit()
    org = np.array([[0.5, 0.5, 5], [-0.5, -0.5, 5]], np.float32)
    d = np.array([[0, 0, -1]] * 2, np.float32)
    h0 = et.scene_intersect(cs, et.make_rays(org, d), isa="xla", time=0.0)
    h1 = et.scene_intersect(cs, et.make_rays(org, d), isa="xla", time=1.0)
    assert bool(h0.valid[0]) and bool(h0.valid[1])
    np.testing.assert_allclose(np.asarray(h0.t), [5.0, 5.0], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(h1.t), [3.0, 3.0], rtol=1e-5)
    # quad uv: (u, v) in [0,1]^2 over the quad; both triangles remapped
    u0 = float(h0.u[0]); vv0 = float(h0.v[0])
    u1 = float(h0.u[1]); vv1 = float(h0.v[1])
    assert 0.6 < u0 < 0.9 and 0.6 < vv0 < 0.9    # (0.75, 0.75) corner
    assert 0.1 < u1 < 0.4 and 0.1 < vv1 < 0.4    # (0.25, 0.25)


def test_curve_mb(rng):
    """BezierCurvesMB: a straight thick curve translating over time —
    hits move with the ray time and match the static curve at t=0/1."""
    def curve_at(zoff):
        return np.array([[0, -1, zoff, 0.2], [0, -0.4, zoff, 0.2],
                         [0, 0.4, zoff, 0.2], [0, 1, zoff, 0.2]],
                        np.float32)

    dev = et.Device("ignore_config_files=1")
    s = et.Scene(dev)
    s.attach(et.BezierCurvesMB(
        indices=np.array([0], np.int32),
        timesteps=[curve_at(0.0), curve_at(2.0)],
        tessellation_rate=8))
    cs = s.commit()
    assert cs.mb_curves is not None
    org = np.array([[3, 0, 0], [3, 0, 2], [3, 0, 1]], np.float32)
    d = np.array([[-1, 0, 0]] * 3, np.float32)
    rays = et.make_rays(org, d)
    h0 = et.scene_intersect(cs, rays, isa="xla", time=0.0)
    h1 = et.scene_intersect(cs, rays, isa="xla", time=1.0)
    hm = et.scene_intersect(cs, rays, isa="xla", time=0.5)
    assert bool(h0.valid[0]) and not bool(h0.valid[1])
    assert bool(h1.valid[1]) and not bool(h1.valid[0])
    assert bool(hm.valid[2])
    np.testing.assert_allclose(float(h0.t[0]), 2.8, atol=1e-2)
    np.testing.assert_allclose(float(hm.t[2]), 2.8, atol=1e-2)
