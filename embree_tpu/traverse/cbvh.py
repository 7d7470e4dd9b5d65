"""Compressed-patch (cBVH) packet traversal — pure JAX reference path.

Implements the fork's CompressedBVHIntersector1 (kernels/geometry/
compressed.h:441-784) as a shared-stack packet walk:

  1. ray -> tile-local frame (:457-459)
  2. frustum entry/exit: z slab + four 2D edge-line tests
     (intersect_frustum, compressed_help.h:93-133)
  3. ray projected through the homography: origin/target = projected
     entry/exit points; distances map back via zFactor = lDir.z/dir.z;
     tiny and flat local frames handled per :464-505
  4. implicit Morton quadtree walk with a parent-box stack; nodes
     decompressed against the popped parent box (getNode,
     compressed_node.h:489-512), children pushed distance-sorted
     (:660-750). The decompressed boxes are ray-INDEPENDENT, so the whole
     packet shares one scalar box stack.
  5. leaves by mode: reconstructed box = surface ('box' :614-656),
     bilinear pizza-box slab with refit extent ('leaf' :541-590 +
     intersect_patch compressed_help.h:135-229), world-space grid
     triangles ('grid' :591-610 + intersect_triangles :278-308)
  6. uv remapped to patch space (:570-571); Ng is the dummy (1,0,0) —
     consumers use smooth normals via interpolate (viewer_device.cpp:284)
  7. occluded() is conservatively true once a ray reaches any tile
     (compressed.h:754-756)
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..build.bvh import BVH
from ..build.cbvh import (TABLE_BORDER, TABLE_MID, TABLE_Z, CompressedTiles,
                          morton2_decode)
from ..core.math import matmul, rcp_safe, ROBUST_MAX_RCP, ROBUST_MIN_RCP
from ..core.rayhit import Hits, Rays

INF = jnp.float32(np.inf)
G_EPS = 1e-4  # compressed.h g_epsilon


class CompressedAccel(NamedTuple):
    top: BVH                 # top-level BVH4 over tiles (leaf = tile id)
    tiles: CompressedTiles


class _CHit(NamedTuple):
    """Per-ray compressed-hit state."""

    t: jnp.ndarray     # world-space distance (tfar)
    u: jnp.ndarray     # patch-space uv
    v: jnp.ndarray
    tile: jnp.ndarray  # best tile index, -1 = none


def _xfm(m, p):
    """Batched xfmPoint for a scalar 3x3 `m` and (R, 3) points."""
    return matmul(p, m.T)


def _project(p, H):
    """Homography on xy, z passthrough (compressed_help.h:86-90)."""
    w = H[2, 0] * p[..., 0] + H[2, 1] * p[..., 1] + H[2, 2]
    w = jnp.where(jnp.abs(w) < 1e-30, 1e-30, w)
    x = (H[0, 0] * p[..., 0] + H[0, 1] * p[..., 1] + H[0, 2]) / w
    y = (H[1, 0] * p[..., 0] + H[1, 1] * p[..., 1] + H[1, 2]) / w
    return jnp.stack([x, y, p[..., 2]], -1)


def _intersect_line(p2, p3, o, d):
    """2D segment/line param (intersect_line, compressed_help.h:93-106).
    p2/p3: (2,) scalars; o/d: (R, 3). Returns (t, valid)."""
    vx = p2[0] - o[..., 0]
    vy = p2[1] - o[..., 1]
    lx = p3[0] - p2[0]
    ly = p3[1] - p2[1]
    den1 = ly * d[..., 0] - lx * d[..., 1]
    den2 = -den1
    den1 = jnp.where(jnp.abs(den1) < 1e-30, 1e-30, den1)
    den2 = jnp.where(jnp.abs(den2) < 1e-30, 1e-30, den2)
    t1 = (ly * vx - lx * vy) / den1
    t2 = (d[..., 0] * vy - d[..., 1] * vx) / den2
    valid = (t2 >= 0.0) & (t2 <= 1.0)
    return t1, valid


def _frustum(fr, lorg, ldir, tnear, tfar):
    """intersect_frustum (compressed_help.h:109-133), vectorized."""
    rdz = rcp_safe(ldir[..., 2])
    orz = lorg[..., 2] * rdz
    t1z = fr[0] * rdz - orz
    t2z = fr[1] * rdz - orz

    p00, p10 = fr[2:4], fr[4:6]
    p01, p11 = fr[6:8], fr[8:10]
    t1x, v1x = _intersect_line(p00, p01, lorg, ldir)
    t2x, v2x = _intersect_line(p10, p11, lorg, ldir)
    t1y, v1y = _intersect_line(p00, p10, lorg, ldir)
    t2y, v2y = _intersect_line(p01, p11, lorg, ldir)

    # fminf/fmaxf NaN semantics: invalid entries are ignored
    def vmin(a, va, b, vb):
        return jnp.minimum(jnp.where(va, a, INF), jnp.where(vb, b, INF))

    def vmax(a, va, b, vb):
        return jnp.maximum(jnp.where(va, a, -INF), jnp.where(vb, b, -INF))

    near1 = jnp.minimum(vmin(t1x, v1x, t2x, v2x), vmin(t1y, v1y, t2y, v2y))
    far1 = jnp.maximum(vmax(t1x, v1x, t2x, v2x), vmax(t1y, v1y, t2y, v2y))
    any_valid = v1x | v2x | v1y | v2y

    near = jnp.maximum(jnp.maximum(jnp.minimum(t1z, t2z), near1), tnear)
    far = jnp.minimum(jnp.minimum(jnp.maximum(t1z, t2z), far1), tfar)
    return near, far, (near <= far) & any_valid


def _decode_node(node, node_full, plo, phi, mode, flavor="com"):
    """getNode (compressed_node.h:489-512; non :578-658; mid :241-260):
    4 child boxes from the popped parent box. Returns (lo, hi) each
    (4, 3) — ray independent."""
    if mode == "full":
        return node_full[:, 0:3], node_full[:, 3:6]
    tb = jnp.asarray(TABLE_BORDER)
    tm = jnp.asarray(TABLE_MID)
    tz = jnp.asarray(TABLE_Z)
    dim = phi - plo

    if flavor == "non":
        # 8-byte per-child planes: byte pair (xz, yz) per child
        los, his = [], []
        for c in range(4):
            qx, qy = c & 1, (c >> 1) & 1
            xz, yz = node[2 * c], node[2 * c + 1]
            t_minx = tm if qx else tb
            t_maxx = tb if qx else tm
            t_miny = tm if qy else tb
            t_maxy = tb if qy else tm
            los.append(jnp.stack([t_minx[(xz >> 5) & 7],
                                  t_miny[(yz >> 5) & 7],
                                  tz[xz & 3]]))
            his.append(jnp.stack([1 - t_maxx[(xz >> 2) & 7],
                                  1 - t_maxy[(yz >> 2) & 7],
                                  1 - tz[yz & 3]]))
        lo = jnp.stack(los) * dim + plo
        hi = jnp.stack(his) * dim + plo
        return lo, hi

    if flavor == "mid":
        # 2-byte inner planes; outer planes are the parent's
        xz, yz = node[0], node[1]
        ix2 = (xz >> 5) & 7; ix3 = (xz >> 2) & 7
        iy2 = (yz >> 5) & 7; iy3 = (yz >> 2) & 7
        iz1 = xz & 3; iz2 = yz & 3
        zero = jnp.float32(0.0)
        one = jnp.float32(1.0)
        lo_x = jnp.stack([zero, tm[ix2], zero, tm[ix2]])
        hi_x = jnp.stack([1 - tm[ix3], one, 1 - tm[ix3], one])
        lo_y = jnp.stack([zero, zero, tm[iy2], tm[iy2]])
        hi_y = jnp.stack([1 - tm[iy3], 1 - tm[iy3], one, one])
        lo_z = jnp.broadcast_to(tz[iz1], (4,))
        hi_z = jnp.broadcast_to(1 - tz[iz2], (4,))
        lo = jnp.stack([lo_x, lo_y, lo_z], -1) * dim + plo
        hi = jnp.stack([hi_x, hi_y, hi_z], -1) * dim + plo
        return lo, hi

    xz, x, yz, y = node[0], node[1], node[2], node[3]
    ix1 = (xz >> 5) & 7; ix2 = (xz >> 2) & 7
    ix3 = (x >> 5) & 7; ix4 = (x >> 2) & 7
    iy1 = (yz >> 5) & 7; iy2 = (yz >> 2) & 7
    iy3 = (y >> 5) & 7; iy4 = (y >> 2) & 7
    iz1 = xz & 3; iz2 = yz & 3

    # children morton order: 0=(0,0) 1=(1,0) 2=(0,1) 3=(1,1)
    lo_x = jnp.stack([tb[ix1], tm[ix2], tb[ix1], tm[ix2]])
    hi_x = jnp.stack([1 - tm[ix3], 1 - tb[ix4], 1 - tm[ix3], 1 - tb[ix4]])
    lo_y = jnp.stack([tb[iy1], tb[iy1], tm[iy2], tm[iy2]])
    hi_y = jnp.stack([1 - tm[iy3], 1 - tm[iy3], 1 - tb[iy4], 1 - tb[iy4]])
    lo_z = jnp.broadcast_to(tz[iz1], (4,))
    hi_z = jnp.broadcast_to(1 - tz[iz2], (4,))
    lo = jnp.stack([lo_x, lo_y, lo_z], -1) * dim + plo
    hi = jnp.stack([hi_x, hi_y, hi_z], -1) * dim + plo
    return lo, hi


def _slab(lo, hi, org, direction, robust=True):
    """Slab test of one scalar box vs (R,3) rays -> (tmin, tmax)."""
    rd = rcp_safe(direction)
    t0 = (lo - org) * rd
    t1 = (hi - org) * rd
    tmin = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tmax = jnp.min(jnp.maximum(t0, t1), axis=-1)
    if robust:
        tmin = tmin * ROBUST_MIN_RCP
        tmax = tmax * ROBUST_MAX_RCP
    return tmin, tmax


@functools.partial(jax.jit,
                   static_argnames=("mode", "comp_level", "flavor"))
def _tile_intersect(tiles: CompressedTiles, ti, org, direction, tnear, state,
                    mode: str, comp_level: int, flavor: str = "com"):
    """Intersect the whole packet against one tile (the reference's
    CompressedBVHIntersector1::intersect, :441-752)."""
    R = tnear.shape[0]
    g = 1 << comp_level
    cells = g * g
    elems = (4 ** comp_level - 1) // 3
    rcp_edges = 1.0 / g

    space = tiles.space[ti]
    proj = tiles.proj[ti]
    iproj = tiles.iproj[ti]
    fr = tiles.frustum[ti]

    lorg = _xfm(space, org)
    ldir = _xfm(space, direction)

    near, far, alive = _frustum(fr, lorg, ldir, tnear, state.t)

    org_p = _project(lorg + near[..., None] * ldir, proj)
    tar = _project(lorg + far[..., None] * ldir, proj)
    dirp = tar - org_p

    ad = jnp.abs(dirp)
    tiny = (ad[..., 0] < G_EPS) & (ad[..., 1] < G_EPS) & (ad[..., 2] < G_EPS)
    flat = (~tiny) & (ad[..., 2] < G_EPS)

    dlen = jnp.sqrt(jnp.sum(dirp * dirp, -1))
    dn = dirp / jnp.maximum(dlen, 1e-30)[..., None]
    sign_z = jnp.where(ldir[..., 2] >= 0, 1.0, -1.0)

    dir_t = jnp.where(tiny[..., None],
                      jnp.stack([jnp.zeros(R), jnp.zeros(R), sign_z], -1), dn)
    org_t = jnp.where(tiny[..., None],
                      org_p - jnp.stack([jnp.zeros(R), jnp.zeros(R),
                                         sign_z], -1), org_p)
    z_factor = jnp.where(tiny, jnp.float32(3.4e38),
                         ldir[..., 2] / jnp.where(jnp.abs(dir_t[..., 2])
                                                  < 1e-30, 1e-30,
                                                  dir_t[..., 2]))
    tloc = jnp.where(tiny, jnp.float32(3.4e38),
                     jnp.where(flat, dlen, (state.t - near) * z_factor))
    tloc = jnp.where(alive, tloc, -INF)

    root_lo = jnp.asarray([-1.0, -1.0, 0.0]) * jnp.asarray([1.0, 1.0, 0.0]) \
        + jnp.asarray([0.0, 0.0, 1.0]) * fr[0]
    root_hi = jnp.asarray([1.0, 1.0, 0.0]) + jnp.asarray([0.0, 0.0, 1.0]) * fr[1]

    DEPTH = 20

    class S(NamedTuple):
        stack: jnp.ndarray       # (DEPTH,) node idx
        blo: jnp.ndarray         # (DEPTH, 3)
        bhi: jnp.ndarray         # (DEPTH, 3)
        sp: jnp.ndarray
        t: jnp.ndarray           # world t (per ray)
        u: jnp.ndarray
        v: jnp.ndarray
        tile: jnp.ndarray
        tloc: jnp.ndarray        # local-frame tfar (per ray)

    def leaf_box(idx, blo, bhi, s: S):
        """'box' leaf: the reconstructed box is the surface (:614-656)."""
        tmin, tmax = _slab(blo, bhi, org_t, dir_t, robust=True)
        tmin = jnp.maximum(tmin, 0.0)  # projected TravRay has tnear=0
        hit = (tmin <= tmax) & (tmin <= s.tloc) & alive
        mx, my = _cell_xy(idx)
        dim = jnp.maximum(bhi - blo, 1e-30)
        px = org_t[..., 0] + dir_t[..., 0] * tmin
        py = org_t[..., 1] + dir_t[..., 1] * tmin
        cu = ((px - blo[0]) / dim[0] + mx) * rcp_edges
        cv = ((py - blo[1]) / dim[1] + my) * rcp_edges
        t_world = _world_t(tmin, s)
        return _update(s, hit, t_world, cu, cv, tmin)

    def leaf_pizza(idx, blo, bhi, s: S):
        """'leaf' pizza-box (:541-590 + intersect_patch)."""
        tmin, tmax = _slab(blo, bhi, org_t, dir_t, robust=True)
        tmin = jnp.maximum(tmin, 0.0)
        box_ok = (tmin <= tmax) & (tmin <= s.tloc) & alive
        dimz = bhi[2] - blo[2]
        ext = tiles.extent[ti]
        rng = (1.0 + 2.0 * ext) * dimz
        off = blo[2] - dimz * ext
        z12 = tiles.leaf_z[ti, idx, 0]
        z34 = tiles.leaf_z[ti, idx, 1]
        rcpf = rng / 16.0
        z1 = off + rcpf * ((z12 >> 4) & 15)
        z2 = off + rcpf * (z12 & 15)
        z3 = off + rcpf * ((z34 >> 4) & 15)
        z4 = off + rcpf * (z34 & 15)
        dz = rng / 16.0

        p1 = org_t + tmin[..., None] * dir_t
        p2 = org_t + tmax[..., None] * dir_t
        lenx = 1.0 / jnp.maximum(bhi[0] - blo[0], 1e-30)
        leny = 1.0 / jnp.maximum(bhi[1] - blo[1], 1e-30)
        fx1 = (p1[..., 0] - blo[0]) * lenx
        fy1 = (p1[..., 1] - blo[1]) * leny
        fx2 = (p2[..., 0] - blo[0]) * lenx
        fy2 = (p2[..., 1] - blo[1]) * leny

        mx, my = _cell_xy(idx)

        # degenerate-span case: accept entry point (:168-174)
        degen = (tmax - tmin) < 1e-6

        z_at1 = z1 * (1 - fx1) * (1 - fy1) + z2 * fx1 * (1 - fy1) \
            + z3 * (1 - fx1) * fy1 + z4 * fx1 * fy1
        z_at2 = z1 * (1 - fx2) * (1 - fy2) + z2 * fx2 * (1 - fy2) \
            + z3 * (1 - fx2) * fy2 + z4 * fx2 * fy2

        between = (p1[..., 2] >= z_at1) & (p1[..., 2] <= z_at1 + dz)
        above = p1[..., 2] > z_at1 + dz
        z1s = jnp.where(above, z_at1 + dz, z_at1)
        z2s = jnp.where(above, z_at2 + dz, z_at2)

        alpha = p2[..., 2] - z2s
        beta = z1s - p1[..., 2]
        denom = jnp.where(jnp.abs(alpha + beta) < 1e-30, 1e-30, alpha + beta)
        t_sec = (tmin * alpha + tmax * beta) / denom
        dfrac = (t_sec - tmin) / jnp.maximum(tmax - tmin, 1e-30)

        sec_ok = (t_sec < s.tloc) & (t_sec >= tmin) & (t_sec <= tmax)

        t_hit = jnp.where(degen | between, tmin, t_sec)
        hit = box_ok & (degen | between | sec_ok)
        fxh = jnp.where(degen | between, fx1, fx1 + (fx2 - fx1) * dfrac)
        fyh = jnp.where(degen | between, fy1, fy1 + (fy2 - fy1) * dfrac)
        cu = (fxh + mx) * rcp_edges
        cv = (fyh + my) * rcp_edges
        t_world = _world_t(t_hit, s)
        return _update(s, hit, t_world, cu, cv, t_hit)

    def leaf_grid(idx, blo, bhi, s: S):
        """'grid' leaf: world-space cell triangles (:591-610)."""
        mx, my = _cell_xy(idx)
        v0 = tiles.grid[ti, mx, my]
        v1 = tiles.grid[ti, mx + 1, my]
        v2g = tiles.grid[ti, mx, my + 1]
        v3 = tiles.grid[ti, mx + 1, my + 1]

        from .moeller import intersect_triangle
        ok1, t1, u1, vv1, _ = intersect_triangle(org, direction, tnear, s.t,
                                                 v0, v1, v2g)
        ok2, t2, u2, vv2, _ = intersect_triangle(org, direction, tnear, s.t,
                                                 v3, v2g, v1)
        # prefer the closer of the two (reference tests sequentially with
        # ray.tfar updates; min-combine is equivalent)
        use2 = ok2 & (~ok1 | (t2 < t1))
        okg = (ok1 | ok2) & alive
        tg = jnp.where(use2, t2, t1)
        ug = jnp.where(use2, (mx + (1.0 - u2)) * rcp_edges,
                       (mx + u1) * rcp_edges)
        vg = jnp.where(use2, (my + (1.0 - vv2)) * rcp_edges,
                       (my + vv1) * rcp_edges)
        new_t = jnp.where(okg, tg, s.t)
        new_tloc = jnp.where(okg, (new_t - near) * z_factor, s.tloc)
        return S(s.stack, s.blo, s.bhi, s.sp,
                 new_t,
                 jnp.where(okg, tiles.uv0[ti, 0] + ug * tiles.uvd[ti, 0], s.u),
                 jnp.where(okg, tiles.uv0[ti, 1] + vg * tiles.uvd[ti, 1], s.v),
                 jnp.where(okg, ti, s.tile),
                 new_tloc)

    def _cell_xy(idx):
        mxs, mys = morton2_decode(np.arange(cells, dtype=np.uint32))
        return (jnp.asarray(mxs.astype(np.int32))[idx],
                jnp.asarray(mys.astype(np.int32))[idx])

    def _world_t(t_hit, s: S):
        p = _project(org_t + t_hit[..., None] * dir_t, iproj)
        flat_t = jnp.sqrt(jnp.sum((p - lorg) ** 2, -1))
        return jnp.where(flat, flat_t, t_hit / z_factor + near)

    def _update(s: S, hit, t_world, cu, cv, t_hit_loc):
        return S(s.stack, s.blo, s.bhi, s.sp,
                 jnp.where(hit, t_world, s.t),
                 jnp.where(hit, tiles.uv0[ti, 0] + cu * tiles.uvd[ti, 0], s.u),
                 jnp.where(hit, tiles.uv0[ti, 1] + cv * tiles.uvd[ti, 1], s.v),
                 jnp.where(hit, ti, s.tile),
                 jnp.where(hit, t_hit_loc, s.tloc))

    leaf_fn = {"box": leaf_box, "leaf": leaf_pizza, "grid": leaf_grid,
               "full": leaf_box}[mode]
    if mode == "full":
        # full-precision nodes still use the box surface only when the
        # reference is configured use_box; the fullPrecision production
        # type is the accuracy reference with box leaves
        pass

    def body(s: S):
        sp = s.sp - 1
        curr = s.stack[sp]
        plo = s.blo[sp]
        phi = s.bhi[sp]
        s = s._replace(sp=sp)

        def do_leaf(s):
            return leaf_fn(curr - elems, plo, phi, s)

        def do_inner(s):
            node = tiles.nodes[ti, curr]
            node_full = (tiles.nodes_full[ti, curr] if mode == "full"
                         else jnp.zeros((4, 6)))
            clo, chi = _decode_node(node, node_full, plo, phi, mode,
                                    flavor)
            # robust slab per child vs all rays
            tmins, tmaxs, anyh, keys = [], [], [], []
            for c in range(4):
                tmin, tmax = _slab(clo[c], chi[c], org_t, dir_t)
                tmin = jnp.maximum(tmin, 0.0)
                h = (tmin <= tmax) & (tmin <= s.tloc) & alive
                d = jnp.min(jnp.where(h, tmin, INF))
                anyh.append(d < INF)
                keys.append(jnp.where(d < INF, d, -INF))
            order = list(range(4))
            stack, blo_s, bhi_s, sp2 = s.stack, s.blo, s.bhi, s.sp
            # push farthest first (sorting network on 4 scalars)
            ks = keys[:]
            cs = [jnp.int32(curr * 4 + 1 + c) for c in range(4)]
            ls = [clo[c] for c in range(4)]
            hs = [chi[c] for c in range(4)]
            ps = anyh[:]
            for (i, j) in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
                sw = ks[i] < ks[j]
                ks[i], ks[j] = (jnp.where(sw, ks[j], ks[i]),
                                jnp.where(sw, ks[i], ks[j]))
                cs[i], cs[j] = (jnp.where(sw, cs[j], cs[i]),
                                jnp.where(sw, cs[i], cs[j]))
                ls[i], ls[j] = (jnp.where(sw, ls[j], ls[i]),
                                jnp.where(sw, ls[i], ls[j]))
                hs[i], hs[j] = (jnp.where(sw, hs[j], hs[i]),
                                jnp.where(sw, hs[i], hs[j]))
                ps[i], ps[j] = (jnp.where(sw, ps[j], ps[i]),
                                jnp.where(sw, ps[i], ps[j]))
            for k in range(4):
                push = ps[k]
                stack = jnp.where(push, stack.at[sp2].set(cs[k]), stack)
                blo_s = jnp.where(push, blo_s.at[sp2].set(ls[k]), blo_s)
                bhi_s = jnp.where(push, bhi_s.at[sp2].set(hs[k]), bhi_s)
                sp2 = sp2 + push.astype(jnp.int32)
            return s._replace(stack=stack, blo=blo_s, bhi=bhi_s, sp=sp2)

        return jax.lax.cond(curr >= elems, do_leaf, do_inner, s)

    init = S(
        stack=jnp.zeros((DEPTH,), jnp.int32),
        blo=jnp.zeros((DEPTH, 3)).at[0].set(root_lo),
        bhi=jnp.zeros((DEPTH, 3)).at[0].set(root_hi),
        sp=jnp.int32(1),
        t=state.t, u=state.u, v=state.v, tile=state.tile,
        tloc=tloc,
    )

    def cond(s: S):
        return (s.sp > 0) & jnp.any(alive)

    out = jax.lax.while_loop(cond, body, init)
    return _CHit(t=out.t, u=out.u, v=out.v, tile=out.tile)


def intersect_compressed(accel: CompressedAccel, rays: Rays,
                         t_in=None) -> _CHit:
    """Top-level BVH4 walk over tiles; each tile leaf runs the packet
    quadtree intersector. `t_in` seeds per-ray tfar (AccelN combining)."""
    top, tiles = accel.top, accel.tiles
    org = rays.org.reshape(-1, 3)
    direction = rays.dir.reshape(-1, 3)
    tnear = rays.tnear.reshape(-1)
    tfar = rays.tfar.reshape(-1) if t_in is None else t_in.reshape(-1)
    R = tnear.shape[0]

    rdir = rcp_safe(direction)
    org_rdir = org * rdir

    state0 = _CHit(t=tfar, u=jnp.zeros(R), v=jnp.zeros(R),
                   tile=jnp.full((R,), -1, jnp.int32))

    stack0 = jnp.zeros((96,), jnp.int32)

    def box_test(lower, upper, tcur):
        lo = lower[:, None, :]
        hi = upper[:, None, :]
        t_lo = lo * rdir[None] - org_rdir[None]
        t_hi = hi * rdir[None] - org_rdir[None]
        tmin = ROBUST_MIN_RCP * jnp.max(jnp.minimum(t_lo, t_hi), -1)
        tmax = ROBUST_MAX_RCP * jnp.min(jnp.maximum(t_lo, t_hi), -1)
        tmin = jnp.maximum(tmin, tnear[None])
        return tmin, (tmin <= tmax) & (tmin <= tcur[None])

    mode = tiles.mode
    cl = tiles.comp_level

    def body(carry):
        stack, sp, st = carry
        sp = sp - 1
        node = stack[sp]
        lower, upper = top.lower[node], top.upper[node]
        child, count = top.child[node], top.count[node]
        tmin, hit = box_test(lower, upper, st.t)
        any_hit = jnp.any(hit, axis=1) & (count >= 0)

        def do_tile(c, st):
            def run(st):
                ti = top.prim_order[child[c]]
                return _tile_intersect(tiles, ti, org, direction, tnear, st,
                                       mode=mode, comp_level=cl,
                                       flavor=getattr(tiles, "flavor",
                                                      "com"))
            return jax.lax.cond(any_hit[c] & (count[c] > 0), run,
                                lambda s: s, st)

        for c in range(4):
            st = do_tile(c, st)

        traverse = any_hit & (count == 0)
        key = jnp.where(traverse,
                        jnp.min(jnp.where(hit, tmin, INF), axis=1), -INF)
        order = jnp.argsort(-key)
        for k in range(4):
            c = order[k]
            push = traverse[c]
            stack = jnp.where(push, stack.at[sp].set(child[c]), stack)
            sp = sp + push.astype(jnp.int32)
        return stack, sp, st

    def cond(carry):
        return carry[1] > 0

    _stack, _sp, st = jax.lax.while_loop(cond, body,
                                         (stack0, jnp.int32(1), state0))
    return st


def compressed_hits(accel: CompressedAccel, rays: Rays, st: _CHit) -> Hits:
    """Convert tile-hit state to Hits (Ng = dummy (1,0,0), compressed.h
    :574 — consumers use smooth normals via Scene.interpolate)."""
    shape = rays.batch_shape
    valid = st.tile >= 0
    ti = jnp.maximum(st.tile, 0)
    ng = jnp.where(valid[..., None],
                   jnp.asarray([1.0, 0.0, 0.0]), 0.0)
    ng = jnp.broadcast_to(ng, st.t.shape + (3,))
    return Hits(
        t=jnp.where(valid, st.t, rays.tfar.reshape(-1)).reshape(shape),
        u=jnp.where(valid, st.u, 0.0).reshape(shape),
        v=jnp.where(valid, st.v, 0.0).reshape(shape),
        ng=ng.reshape(shape + (3,)),
        prim_id=jnp.where(valid, accel.tiles.prim_id[ti], -1).reshape(shape),
        geom_id=jnp.where(valid, accel.tiles.geom_id[ti], -1).reshape(shape),
        gprim=jnp.full(shape, -1, jnp.int32),
        inst_id=jnp.full(shape, -1, jnp.int32),
    )


def occluded_compressed(accel: CompressedAccel, rays: Rays) -> jnp.ndarray:
    """Conservative occlusion: any ray reaching a tile's top-level leaf box
    counts as occluded (compressed.h:754-756)."""
    top = accel.top
    org = rays.org.reshape(-1, 3)
    direction = rays.dir.reshape(-1, 3)
    tnear = rays.tnear.reshape(-1)
    tfar = rays.tfar.reshape(-1)
    R = tnear.shape[0]
    rdir = rcp_safe(direction)
    org_rdir = org * rdir

    def body(carry):
        stack, sp, occ = carry
        sp = sp - 1
        node = stack[sp]
        lower, upper = top.lower[node], top.upper[node]
        child, count = top.child[node], top.count[node]
        tcur = jnp.where(occ, -INF, tfar)
        lo = lower[:, None, :]
        hi = upper[:, None, :]
        t_lo = lo * rdir[None] - org_rdir[None]
        t_hi = hi * rdir[None] - org_rdir[None]
        tmin = ROBUST_MIN_RCP * jnp.max(jnp.minimum(t_lo, t_hi), -1)
        tmax = ROBUST_MAX_RCP * jnp.min(jnp.maximum(t_lo, t_hi), -1)
        tmin = jnp.maximum(tmin, tnear[None])
        hit = (tmin <= tmax) & (tmin <= tcur[None])
        valid = count >= 0
        # leaves conservatively occlude every ray whose box test passes
        for c in range(4):
            occ = occ | (hit[c] & valid[c] & (count[c] > 0))
        for c in range(4):
            push = jnp.any(hit[c]) & valid[c] & (count[c] == 0)
            stack = jnp.where(push, stack.at[sp].set(child[c]), stack)
            sp = sp + push.astype(jnp.int32)
        return stack, sp, occ

    def cond(carry):
        return (carry[1] > 0) & ~jnp.all(carry[2])

    _s, _sp, occ = jax.lax.while_loop(
        cond, body,
        (jnp.zeros((96,), jnp.int32), jnp.int32(1), jnp.zeros((R,), bool)))
    return occ.reshape(rays.batch_shape)
