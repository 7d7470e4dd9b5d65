"""Curve and line-segment geometry (hair primitives).

Analog of the reference's curve stack (kernels/geometry/bezier1v.h,
line_intersector.h, kernels/subdiv/bezier_curve.h): cubic Bezier hair is
tessellated at commit time into round linear segments (position + radius
per endpoint), and segments are intersected with a swept-cone test plus
spherical end caps — the round-curve variant (bezier_curve_intersector /
line_intersector semantics). Internally the segment soup rides the
user-geometry accel machinery (BVH over segment bounds + vectorized
intersector), so no new traversal code is needed.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .geometry import Geometry


class LineSegments(Geometry):
    """RTC_GEOMETRY_TYPE_FLAT/ROUND_LINEAR_CURVE (Line4i analog).

    vertices: (V, 4) xyzr; indices: (S,) first-vertex index per segment."""

    def __init__(self, vertices, indices):
        super().__init__()
        self.vertices = np.asarray(vertices, np.float32)
        self.indices = np.asarray(indices, np.int32)

    @property
    def num_prims(self) -> int:
        return int(self.indices.shape[0])

    def to_segments(self):
        v = self.vertices
        i = self.indices
        p0 = v[i]
        p1 = v[i + 1]
        prim = np.arange(i.shape[0], dtype=np.int32)
        u0 = np.zeros(i.shape[0], np.float32)
        du = np.ones(i.shape[0], np.float32)
        return p0, p1, prim, u0, du


class BezierCurves(Geometry):
    """RTC_GEOMETRY_TYPE_*_BEZIER_CURVE (bezier1v.h / bezier_curve.h).

    vertices: (V, 4) xyzr control points; indices: (C,) first control
    point of each cubic curve; tessellation_rate segments per curve."""

    def __init__(self, vertices, indices, tessellation_rate: int = 8,
                 flat: bool = False):
        super().__init__()
        self.vertices = np.asarray(vertices, np.float32)
        self.indices = np.asarray(indices, np.int32)
        self.tessellation_rate = int(tessellation_rate)
        self.flat = bool(flat)   # FLAT (ribbon) vs ROUND curve type

    @property
    def num_prims(self) -> int:
        return int(self.indices.shape[0])

    def to_bezier(self):
        """(C, 4, 3) Bezier control points + (C, 4) radii."""
        v = self.vertices
        i = self.indices
        cp = np.stack([v[i], v[i + 1], v[i + 2], v[i + 3]], axis=1)
        return cp[:, :, :3].copy(), cp[:, :, 3].copy()

    def to_segments(self):
        """Uniformly tessellate each cubic Bezier into R segments."""
        v = self.vertices
        i = self.indices
        R = self.tessellation_rate
        c0, c1, c2, c3 = v[i], v[i + 1], v[i + 2], v[i + 3]  # (C, 4)
        ts = np.linspace(0.0, 1.0, R + 1, dtype=np.float32)[:, None, None]
        b = ((1 - ts) ** 3 * c0 + 3 * (1 - ts) ** 2 * ts * c1
             + 3 * (1 - ts) * ts ** 2 * c2 + ts ** 3 * c3)  # (R+1, C, 4)
        p0 = b[:-1].transpose(1, 0, 2).reshape(-1, 4)
        p1 = b[1:].transpose(1, 0, 2).reshape(-1, 4)
        C = i.shape[0]
        prim = np.repeat(np.arange(C, dtype=np.int32), R)
        u0 = np.tile(ts[:-1, 0, 0], C).astype(np.float32)
        du = np.full(C * R, 1.0 / R, np.float32)
        return p0, p1, prim, u0, du


class BSplineCurves(Geometry):
    """RTC_GEOMETRY_TYPE_*_BSPLINE_CURVE (kernels/subdiv/bspline_curve.h).

    Uniform cubic B-spline over (V, 4) xyzr control points; indices (C,)
    give the first of 4 consecutive control points per curve (so a shared
    control polygon yields C1-continuous hair, as in
    curve_geometry_device.cpp:66-76)."""

    def __init__(self, vertices, indices, tessellation_rate: int = 8,
                 flat: bool = False):
        super().__init__()
        self.vertices = np.asarray(vertices, np.float32)
        self.indices = np.asarray(indices, np.int32)
        self.tessellation_rate = int(tessellation_rate)
        self.flat = bool(flat)

    @property
    def num_prims(self) -> int:
        return int(self.indices.shape[0])

    def to_bezier(self):
        """(C, 4, 3) + (C, 4): B-spline spans converted to Bezier
        (bspline_curve.h basis conversion)."""
        from ..build.hair import bezier_from_bspline
        v = self.vertices
        i = self.indices
        cp = np.stack([v[i], v[i + 1], v[i + 2], v[i + 3]], axis=1)
        bz = bezier_from_bspline(cp)
        return (bz[:, :, :3].astype(np.float32),
                bz[:, :, 3].astype(np.float32))

    def to_segments(self):
        """Uniform cubic B-spline basis (bspline_curve.h BSplineBasis):
        N0..N3 over t in [0,1), tessellated into R round segments."""
        v = self.vertices
        i = self.indices
        R = self.tessellation_rate
        c0, c1, c2, c3 = v[i], v[i + 1], v[i + 2], v[i + 3]  # (C, 4)
        ts = np.linspace(0.0, 1.0, R + 1, dtype=np.float32)[:, None, None]
        t2, t3 = ts * ts, ts * ts * ts
        n0 = (1 - 3 * ts + 3 * t2 - t3) / 6.0
        n1 = (4 - 6 * t2 + 3 * t3) / 6.0
        n2 = (1 + 3 * ts + 3 * t2 - 3 * t3) / 6.0
        n3 = t3 / 6.0
        b = n0 * c0 + n1 * c1 + n2 * c2 + n3 * c3  # (R+1, C, 4)
        p0 = b[:-1].transpose(1, 0, 2).reshape(-1, 4)
        p1 = b[1:].transpose(1, 0, 2).reshape(-1, 4)
        C = i.shape[0]
        prim = np.repeat(np.arange(C, dtype=np.int32), R)
        u0 = np.tile(ts[:-1, 0, 0], C).astype(np.float32)
        du = np.full(C * R, 1.0 / R, np.float32)
        return p0, p1, prim, u0, du


def segment_bounds(p0: np.ndarray, p1: np.ndarray):
    lo = np.minimum(p0[:, :3] - p0[:, 3:4], p1[:, :3] - p1[:, 3:4])
    hi = np.maximum(p0[:, :3] + p0[:, 3:4], p1[:, :3] + p1[:, 3:4])
    return lo.astype(np.float32), hi.astype(np.float32)


def make_segment_intersector(p0, p1, prim, u0, du):
    """Builds an intersect_fn(seg_id, rays, tfar) over the segment soup:
    swept-cone + endpoint sphere caps (line_intersector.h round segments).

    Returns per-ray (valid, t, u, v, ng) with u = curve parameter and
    Ng = radial direction at the hit (embree's round-curve normal)."""
    # numpy on purpose: these get captured by intersect_fn and traced
    # into callers' jits later — numpy closures embed as plain literals.
    P0 = np.asarray(p0)
    P1 = np.asarray(p1)
    PR = np.asarray(prim)
    U0 = np.asarray(u0)
    DU = np.asarray(du)

    def intersect_fn(sid, rays, tfar):
        # jnp conversion happens here, inside the caller's trace, so the
        # constants inline into the jaxpr (numpy can't index by tracer)
        P0j = jnp.asarray(P0)
        P1j = jnp.asarray(P1)
        a0 = P0j[sid, :3]
        a1 = P1j[sid, :3]
        r0 = P0j[sid, 3]
        r1 = P1j[sid, 3]
        axis = a1 - a0
        aa = jnp.maximum(jnp.sum(axis * axis), 1e-20)
        rr = r1 - r0

        q0 = rays.org - a0
        dvec = rays.dir
        alpha = jnp.sum(q0 * axis, -1)
        beta = jnp.sum(dvec * axis, -1)
        dd = jnp.sum(dvec * dvec, -1)
        q0d = jnp.sum(q0 * dvec, -1)
        q0q0 = jnp.sum(q0 * q0, -1)

        A = dd - beta * beta / aa - (rr * beta) ** 2 / (aa * aa)
        B = 2 * q0d - 2 * alpha * beta / aa - 2 * r0 * rr * beta / aa \
            - 2 * rr * rr * alpha * beta / (aa * aa)
        C = q0q0 - alpha * alpha / aa - r0 * r0 - 2 * r0 * rr * alpha / aa \
            - (rr * alpha) ** 2 / (aa * aa)
        disc = B * B - 4 * A * C
        ok = disc >= 0
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        A_safe = jnp.where(jnp.abs(A) < 1e-20, 1e-20, A)
        tA = (-B - sq) / (2 * A_safe)
        tB = (-B + sq) / (2 * A_safe)

        def side_ok(t):
            s = (alpha + beta * t) / aa
            return (t > rays.tnear) & (t < tfar) & (s >= 0.0) & (s <= 1.0)

        tcone = jnp.where(side_ok(tA), tA,
                          jnp.where(side_ok(tB), tB, jnp.inf))
        cone_ok = ok & jnp.isfinite(tcone)

        # endpoint sphere caps
        def cap(center, radius):
            oc = rays.org - center
            b2 = jnp.sum(oc * dvec, -1)
            c2 = jnp.sum(oc * oc, -1) - radius * radius
            d2 = b2 * b2 - dd * c2
            okc = d2 >= 0
            sqc = jnp.sqrt(jnp.maximum(d2, 0.0))
            t0 = (-b2 - sqc) / jnp.maximum(dd, 1e-20)
            t1 = (-b2 + sqc) / jnp.maximum(dd, 1e-20)
            tc = jnp.where(t0 > rays.tnear, t0, t1)
            okc = okc & (tc > rays.tnear) & (tc < tfar)
            return jnp.where(okc, tc, jnp.inf)

        t_all = jnp.minimum(jnp.where(cone_ok, tcone, jnp.inf),
                            jnp.minimum(cap(a0, r0), cap(a1, r1)))
        valid = jnp.isfinite(t_all)
        t_hit = jnp.where(valid, t_all, tfar)

        s = jnp.clip((alpha + beta * t_hit) / aa, 0.0, 1.0)
        u = jnp.asarray(U0)[sid] + s * jnp.asarray(DU)[sid]
        pt = rays.org + t_hit[..., None] * dvec
        ng = pt - (a0 + s[..., None] * axis)
        return valid, t_hit, u, jnp.zeros_like(u), ng

    return intersect_fn, PR


class BezierCurvesMB(Geometry):
    """Motion-blur Bezier curves: N >= 2 control-point timesteps over
    one topology (the bvh_builder_msmblur_hair analog). Each timestep
    tessellates into the same R segments; the MB curve accel
    (traverse/mb.py MBCurves) lerps segment endpoints/radii at the
    ray's time and runs the swept-cone test."""

    def __init__(self, vertices_begin=None, vertices_end=None, indices=None,
                 timesteps=None, tessellation_rate: int = 8):
        super().__init__()
        if timesteps is not None:
            self.vertex_timesteps = [np.asarray(v, np.float32)
                                     for v in timesteps]
            assert len(self.vertex_timesteps) >= 2
        else:
            self.vertex_timesteps = [np.asarray(vertices_begin, np.float32),
                                     np.asarray(vertices_end, np.float32)]
        self.indices = np.asarray(indices, np.int32)
        self.tessellation_rate = int(tessellation_rate)

    @property
    def num_prims(self) -> int:
        return int(self.indices.shape[0])

    def timestep_segments(self):
        """Per-timestep (p0, p1, prim, u0, du) segment soups (p0/p1
        carry xyzr) over the SHARED tessellation."""
        out = []
        for v in self.vertex_timesteps:
            c = BezierCurves(v, self.indices,
                             tessellation_rate=self.tessellation_rate)
            out.append(c.to_segments())
        return out
