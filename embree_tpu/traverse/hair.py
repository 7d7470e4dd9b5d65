"""Hair leaf intersectors + cluster traversal glue.

Leaves evaluate the cubic Bezier directly, subdivided into K linear
sub-segments per curve (the reference's curve intersectors subdivide
exactly the same way):

* RIBBON (bezier_ribbon intersector semantics,
  kernels/geometry/bezier_hair_intersector.h): each sub-segment is a
  flat strip of width 2r facing the ray — the 2D closest-approach of
  the ray to the segment in a ray-centric frame, hit when the distance
  is under the interpolated radius. Ng faces the viewer:
  cross(tangent, cross(tangent, dir)).

* ROUND (swept-cone, line_intersector.h): the existing cone + cap test
  from scene/curves.py applied per sub-segment — identical geometry to
  the segment-callback path, so OBB-vs-callback parity is exact.

Traversal is the stock AABB BVH walk (traverse/user.py) over a
cluster's ROTATED bounds with the ray batch rotated once per cluster —
see build/hair.py for the OBB design note.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.math import matmul
from ..core.rayhit import Rays


def _bezier_points(cp, K: int):
    """cp: (4, 3+) control points -> (K+1, 3+) polyline samples."""
    t = jnp.linspace(0.0, 1.0, K + 1)[:, None]
    b0 = (1 - t) ** 3
    b1 = 3 * t * (1 - t) ** 2
    b2 = 3 * t * t * (1 - t)
    b3 = t ** 3
    return b0 * cp[0] + b1 * cp[1] + b2 * cp[2] + b3 * cp[3]


def make_ribbon_intersector(cps, radii, prim_ids, K: int = 8):
    """intersect_fn(curve_id, rays, tfar) -> (ok, t, u, v, ng): flat
    ribbon test per sub-segment. cps/radii are CLUSTER-ROTATED numpy
    arrays; rays arrive rotated; ng returns in the rotated frame."""
    CP = np.asarray(cps, np.float32)
    RA = np.asarray(radii, np.float32)

    def intersect_fn(cid, rays, tfar):
        cp = jnp.asarray(CP)[cid]                   # (4, 3)
        ra = jnp.asarray(RA)[cid]                   # (4,)
        pts = _bezier_points(cp, K)                 # (K+1, 3)
        rs = _bezier_points(ra[:, None], K)[:, 0]   # (K+1,)

        o = rays.org
        d = rays.dir
        t_best = tfar
        u_best = jnp.zeros_like(tfar)
        v_best = jnp.zeros_like(tfar)
        ng_best = jnp.zeros(tfar.shape + (3,))
        ok_any = jnp.zeros(tfar.shape, bool)
        dd = jnp.maximum(jnp.sum(d * d, -1), 1e-20)
        for i in range(K):
            a = pts[i] - o                          # (R, 3)
            b = pts[i + 1] - o
            # ray-centric: remove the d component
            az = jnp.sum(a * d, -1) / dd
            bz = jnp.sum(b * d, -1) / dd
            ap = a - az[..., None] * d
            bp = b - bz[..., None] * d
            ab = bp - ap
            denom = jnp.maximum(jnp.sum(ab * ab, -1), 1e-20)
            s = jnp.clip(-jnp.sum(ap * ab, -1) / denom, 0.0, 1.0)
            p = ap + s[..., None] * ab              # closest 2D point
            dist2 = jnp.sum(p * p, -1)
            r = rs[i] * (1 - s) + rs[i + 1] * s
            th = az * (1 - s) + bz * s              # depth along ray
            ok = (dist2 <= r * r) & (th > rays.tnear) & (th < t_best)
            tang = pts[i + 1] - pts[i]
            ngr = jnp.cross(tang, jnp.cross(tang, d))
            upd = ok
            t_best = jnp.where(upd, th, t_best)
            u_best = jnp.where(upd, (i + s) / K, u_best)
            v_best = jnp.where(
                upd, 0.5 + 0.5 * jnp.sqrt(dist2) / jnp.maximum(r, 1e-20),
                v_best)
            ng_best = jnp.where(upd[..., None], ngr, ng_best)
            ok_any = ok_any | ok
        return ok_any, t_best, u_best, v_best, ng_best

    return intersect_fn


def make_round_curve_intersector(cps, radii, prim_ids, K: int = 8):
    """intersect_fn over swept-cone sub-segments (round curves) — the
    line_intersector.h cone test per Bezier sub-segment."""
    CP = np.asarray(cps, np.float32)
    RA = np.asarray(radii, np.float32)

    def intersect_fn(cid, rays, tfar):
        cp = jnp.asarray(CP)[cid]
        ra = jnp.asarray(RA)[cid]
        pts = _bezier_points(cp, K)
        rs = _bezier_points(ra[:, None], K)[:, 0]

        t_best = tfar
        u_best = jnp.zeros_like(tfar)
        v_best = jnp.zeros_like(tfar)
        ng_best = jnp.zeros(tfar.shape + (3,))
        ok_any = jnp.zeros(tfar.shape, bool)
        for i in range(K):
            ok, th, uh, ngh = _cone_hit(pts[i], pts[i + 1], rs[i],
                                        rs[i + 1], rays, t_best)
            upd = ok
            t_best = jnp.where(upd, th, t_best)
            u_best = jnp.where(upd, (i + uh) / K, u_best)
            ng_best = jnp.where(upd[..., None], ngh, ng_best)
            ok_any = ok_any | ok
        return ok_any, t_best, u_best, v_best, ng_best

    return intersect_fn


def _cone_hit(a0, a1, r0, r1, rays, tfar):
    """Swept-cone segment test (scene/curves.py math, shared form)."""
    axis = a1 - a0
    aa = jnp.maximum(jnp.sum(axis * axis), 1e-20)
    rr = r1 - r0
    q0 = rays.org - a0
    d = rays.dir
    alpha = jnp.sum(q0 * axis, -1)
    beta = jnp.sum(d * axis, -1)
    dd = jnp.sum(d * d, -1)
    q0d = jnp.sum(q0 * d, -1)
    q0q0 = jnp.sum(q0 * q0, -1)
    A = dd - beta * beta / aa - (rr * beta) ** 2 / (aa * aa)
    B = (2 * q0d - 2 * alpha * beta / aa - 2 * r0 * rr * beta / aa
         - 2 * rr * rr * alpha * beta / (aa * aa))
    C = (q0q0 - alpha * alpha / aa - r0 * r0 - 2 * r0 * rr * alpha / aa
         - rr * rr * alpha * alpha / (aa * aa))
    disc = B * B - 4 * A * C
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    A_safe = jnp.where(jnp.abs(A) < 1e-20, 1e-20, A)
    t0 = (-B - sq) / (2 * A_safe)
    t1 = (-B + sq) / (2 * A_safe)
    th = jnp.where(t0 > rays.tnear, t0, t1)
    s = (alpha + th * beta) / aa
    ok = (disc >= 0) & (th > rays.tnear) & (th < tfar) \
        & (s >= 0.0) & (s <= 1.0)
    p = rays.org + th[..., None] * d
    onax = a0 + s[..., None] * axis
    ng = p - onax
    return ok, th, jnp.clip(s, 0.0, 1.0), ng


def intersect_hair_clusters(clusters, fns, rays: Rays, t_in, geom_id,
                            prim_of_curve, with_stats: bool = False):
    """Fold the per-cluster rotated BVH walks; min-combine against t_in.

    clusters: [(rot, bvh, members)] (build/hair.HairCluster); fns: one
    leaf intersector per cluster (closures over rotated cps)."""
    from .user import UserAccel, intersect_user

    shape = t_in.shape
    t = t_in.reshape(-1)
    u = jnp.zeros_like(t)
    v = jnp.zeros_like(t)
    ng = jnp.zeros(t.shape + (3,))
    prim = jnp.full(t.shape, -1, jnp.int32)
    org = rays.org.reshape(-1, 3)
    d = rays.dir.reshape(-1, 3)
    tn = rays.tnear.reshape(-1)
    pops_total = jnp.int32(0)
    for cl, fn in zip(clusters, fns):
        Rm = jnp.asarray(cl.rot)
        rrays = Rays(matmul(org, Rm), matmul(d, Rm), tn, t)
        res = intersect_user(
            UserAccel(cl.bvh, geom_id, int(cl.members.shape[0])), fn,
            rrays, t, with_stats=with_stats)
        if with_stats:
            tc, uc, vc, ngc, pc, hitm, pops = res
            pops_total = pops_total + pops
        else:
            tc, uc, vc, ngc, pc, hitm = res
        use = hitm & (tc < t)
        t = jnp.where(use, tc, t)
        u = jnp.where(use, uc, u)
        v = jnp.where(use, vc, v)
        ng = jnp.where(use[..., None], matmul(ngc, Rm.T), ng)
        # pc indexes the cluster's member list -> global curve id
        mem = jnp.asarray(cl.members)
        gcurve = mem[jnp.maximum(pc, 0)]
        prim = jnp.where(use, jnp.asarray(prim_of_curve)[gcurve], prim)
    out = (t.reshape(shape), u.reshape(shape), v.reshape(shape),
           ng.reshape(shape + (3,)), prim.reshape(shape),
           (prim >= 0).reshape(shape))
    if with_stats:
        return out + (pops_total,)
    return out
