"""Differentiable hit evaluation.

The differentiable-rendering core (SURVEY.md §7.6, BASELINE.json north
star): BVH build and hit *selection* are discrete and wrapped in
stop_gradient; the hit point itself is then re-evaluated analytically
from the winning primitive so gradients flow from pixels to vertex
positions (and later: displacement maps and materials) — the reference's
`rtcInterpolate` derivative machinery (rtcore_geometry.h:234-338) defines
which derivatives exist (P, dPdu, dPdv); here they come for free from
jax.grad through the re-evaluation.

Usage: `tris` must be built from the differentiable vertex arrays (the
same jnp arrays the loss differentiates), while the BVH can be stale /
stop-gradient — exactly embree's REFIT-vs-rebuild split.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.math import cross, dot
from ..core.rayhit import Hits, Rays
from ..scene.prims import TrianglePrims
from ..scene.scene import CommittedScene, scene_intersect


@jax.custom_vjp
def _gather_rows(table, idx):
    return table[idx]


def _gather_rows_fwd(table, idx):
    return table[idx], (idx, table.shape[0])


def _gather_rows_bwd(res, ct):
    # Instead of XLA's native gather-VJP (an unsorted scatter-add), the
    # cotangent COLUMNS are sorted along with the index in ONE variadic
    # lax.sort and summed with indices_are_sorted=True. Whether this
    # beats the plain scatter-add on the GPU is not measured yet. This
    # column-split form requires the (rows, cols) gather shape the
    # forward produces from 1-D idx.
    assert ct.ndim == 2, (
        "_gather_rows backward expects a rank-2 cotangent (1-D row "
        f"indices in the forward); got ct.ndim={ct.ndim}. Reshape idx "
        "to 1-D before calling _gather_rows.")
    idx, T = res
    ops = (idx,) + tuple(ct[:, j] for j in range(ct.shape[1]))
    s = jax.lax.sort(ops, num_keys=1)
    # one flat (N,) segment_sum per column rather than one stacked (N, C)
    g = jnp.stack([jax.ops.segment_sum(c, s[0], num_segments=T,
                                       indices_are_sorted=True)
                   for c in s[1:]], axis=-1)
    return g, None


_gather_rows.defvjp(_gather_rows_fwd, _gather_rows_bwd)


def reeval_hit(tris: TrianglePrims, rays: Rays, gprim, valid) -> Hits:
    """Recompute (t, u, v, Ng, P) differentiably for the selected prim."""
    p = jnp.maximum(gprim, 0)
    # one packed gather instead of three; grads flow back through the
    # concat as cheap slices
    packf = jnp.concatenate([tris.v0, tris.v1, tris.v2], axis=-1)  # (T, 9)
    g = _gather_rows(packf, p)
    v0, v1, v2 = g[..., 0:3], g[..., 3:6], g[..., 6:9]
    e1 = v1 - v0
    e2 = v2 - v0
    ng = cross(e1, e2)  # == reference Ng = cross(e2', e1') with their edges
    # solve ray/plane: t = dot(v0 - org, ng) / dot(dir, ng)
    den = dot(rays.dir, ng)
    den_safe = jnp.where(jnp.abs(den) > 1e-30, den, 1.0)
    t = dot(v0 - rays.org, ng) / den_safe
    pt = rays.org + t[..., None] * rays.dir
    # barycentrics via projection onto the dominant-normal plane-free form
    w = pt - v0
    d00 = dot(e1, e1); d01 = dot(e1, e2); d11 = dot(e2, e2)
    d20 = dot(w, e1); d21 = dot(w, e2)
    denom = d00 * d11 - d01 * d01
    denom_safe = jnp.where(jnp.abs(denom) > 1e-30, denom, 1.0)
    u = (d11 * d20 - d01 * d21) / denom_safe
    v = (d00 * d21 - d01 * d20) / denom_safe
    packi = jnp.stack([tris.uv_flip, tris.prim_id, tris.geom_id],
                      axis=-1)  # (T, 3) — one meta gather instead of three
    meta = packi[p]
    flip = meta[..., 0] == 1
    u = jnp.where(flip, 1.0 - u, u)
    v = jnp.where(flip, 1.0 - v, v)
    z = jnp.zeros_like(t)
    return Hits(
        t=jnp.where(valid, t, rays.tfar),
        u=jnp.where(valid, u, z),
        v=jnp.where(valid, v, z),
        ng=jnp.where(valid[..., None], ng, 0.0),
        prim_id=jnp.where(valid, meta[..., 1], -1),
        geom_id=jnp.where(valid, meta[..., 2], -1),
        gprim=jnp.where(valid, gprim, -1),
        inst_id=jnp.full(t.shape, -1, jnp.int32),
    )


def reeval_hit_verts(vertices, tri_idx, rays: Rays, gprim, valid):
    """Like reeval_hit but differentiates w.r.t. the VERTEX table
    directly: gathers the winning primitive's three corners from
    `vertices` in ONE composed gather (rays -> corner vertex ids via the
    static connectivity `tri_idx`) instead of materializing a full
    differentiable per-triangle copy of the scene first. Identical loss
    semantics; the backward pass is one sorted segment-sum (3R -> V)
    instead of a rays->prims segment-sum chained into three prims->verts
    scatter-adds. Returns (t, u, v) only — the training-loss surface.

    Reference analog: rtcInterpolate's vertex-buffer derivative path
    (rtcore_geometry.h:234-338) — gradients exist w.r.t. the vertex
    buffer, not a per-primitive copy.

    CONSTRAINT: `gprim` indexes `tri_idx` directly, so this is only
    correct for a SINGLE triangle-mesh geometry whose committed prim
    order equals the input connectivity order (no quad split, no
    multi-geometry remap, no uv_flip) — true for bench.py's sphere.
    For general scenes use reeval_hit, which goes through the
    committed per-prim tables (uv_flip included)."""
    p = jnp.maximum(gprim, 0)
    vidx = jnp.take(tri_idx, p, axis=0)              # (R, 3) int — discrete
    vidx = jax.lax.stop_gradient(vidx)
    g = _gather_rows(vertices, vidx.reshape(-1))     # (3R, 3)
    g = g.reshape(p.shape + (3, 3))
    v0, v1, v2 = g[..., 0, :], g[..., 1, :], g[..., 2, :]
    e1 = v1 - v0
    e2 = v2 - v0
    ng = cross(e1, e2)
    den = dot(rays.dir, ng)
    den_safe = jnp.where(jnp.abs(den) > 1e-30, den, 1.0)
    t = dot(v0 - rays.org, ng) / den_safe
    pt = rays.org + t[..., None] * rays.dir
    w = pt - v0
    d00 = dot(e1, e1); d01 = dot(e1, e2); d11 = dot(e2, e2)
    d20 = dot(w, e1); d21 = dot(w, e2)
    denom = d00 * d11 - d01 * d01
    denom_safe = jnp.where(jnp.abs(denom) > 1e-30, denom, 1.0)
    u = (d11 * d20 - d01 * d21) / denom_safe
    v = (d00 * d21 - d01 * d20) / denom_safe
    z = jnp.zeros_like(t)
    return (jnp.where(valid, t, rays.tfar),
            jnp.where(valid, u, z), jnp.where(valid, v, z))


@functools.partial(jax.custom_vjp, nondiff_argnums=())
def _t_fused(vertices, vidx, packed9, gprim, org, d, tfar, t_kernel,
             valid):
    return jnp.where(valid, t_kernel, tfar)


def _t_fused_fwd(vertices, vidx, packed9, gprim, org, d, tfar, t_kernel,
                 valid):
    return (_t_fused(vertices, vidx, packed9, gprim, org, d, tfar,
                     t_kernel, valid),
            (vertices, vidx, packed9, gprim, org, d, t_kernel, valid))


def _t_fused_bwd(res, ct):
    """Analytic d t / d corners, gathered ONLY here: for
    t = dot(v0-org, n)/dot(d, n) with n = cross(v1-v0, v2-v0),
        g      = (q - t d) / den,      q = v0 - org
        dt/dv0 = n/den + (e1-e2) x g
        dt/dv1 = e2 x g
        dt/dv2 = g x e1
    (translation check: the three sum to n/den). The cotangent lands in
    the vertex table via the same payload-sort segment-sum as
    _gather_rows."""
    vertices, vidx, packed9, gprim, org, d, t, valid = res
    V = vertices.shape[0]
    if packed9 is not None:
        # corner POSITIONS from the committed per-triangle table: ONE
        # R-row gather of 9 floats instead of a 3R-row vertex gather
        # (the values are stop-gradient coefficient inputs — the
        # GRADIENT still lands in the vertex table below)
        g9 = packed9[jnp.maximum(gprim, 0)]
        v0, v1, v2 = g9[..., 0:3], g9[..., 3:6], g9[..., 6:9]
    else:
        g3 = vertices[vidx.reshape(-1)].reshape(vidx.shape + (3,))
        v0, v1, v2 = g3[..., 0, :], g3[..., 1, :], g3[..., 2, :]
    e1 = v1 - v0
    e2 = v2 - v0
    n = cross(e1, e2)
    den = dot(d, n)
    den_safe = jnp.where(jnp.abs(den) > 1e-30, den, 1.0)
    q = v0 - org
    # sanitize miss lanes (t = tfar = inf would make inf * 0 = NaN
    # under the valid mask below)
    t_s = jnp.where(valid, t, 0.0)
    gv = (q - t_s[..., None] * d) / den_safe[..., None]
    dv0 = n / den_safe[..., None] + cross(e1 - e2, gv)
    dv1 = cross(e2, gv)
    dv2 = cross(gv, e1)
    w = jnp.where(valid, ct, 0.0)[..., None]
    cts = jnp.stack([dv0 * w, dv1 * w, dv2 * w], axis=-2)  # (R, 3, 3)
    idx = vidx.reshape(-1)
    cflat = cts.reshape(-1, 3)
    ops = (idx,) + tuple(cflat[:, j] for j in range(3))
    s = jax.lax.sort(ops, num_keys=1)
    # flat per-column segment_sums (see _gather_rows_bwd layout note)
    gout = jnp.stack([jax.ops.segment_sum(c, s[0], num_segments=V,
                                          indices_are_sorted=True)
                      for c in s[1:]], axis=-1)
    z3 = jnp.zeros_like(org)
    return (gout, None, None, None, z3, z3, jnp.zeros_like(t),
            jnp.zeros_like(t), None)


_t_fused.defvjp(_t_fused_fwd, _t_fused_bwd)


def hit_t_grad(vertices, tri_idx, rays: Rays, gprim, valid, t_kernel,
               tris=None):
    """Fused training-loss surface for t: the PRIMAL is the traversal
    kernel's own t (no forward re-evaluation gathers at all); the VJP
    gathers the winning corners and applies the analytic dt/dcorner
    formulas. Same gradient as reeval_hit_verts' t output
    (tools/profile_bwd.py checks equivalence), ~half the step cost.

    Same single-triangle-mesh constraint as reeval_hit_verts. Pass
    the committed `tris` (TrianglePrims) to source corner positions
    from its packed table (halves the backward gather rows)."""
    p = jnp.maximum(gprim, 0)
    vidx = jax.lax.stop_gradient(jnp.take(tri_idx, p, axis=0))
    packed9 = None
    if tris is not None:
        packed9 = jax.lax.stop_gradient(
            jnp.concatenate([tris.v0, tris.v1, tris.v2], axis=-1))
    return _t_fused(vertices, vidx, packed9, gprim, rays.org, rays.dir,
                    rays.tfar, t_kernel, valid)


def intersect_diff(cs: CommittedScene, rays: Rays, isa: str = "default") -> Hits:
    """Closest-hit with gradients: discrete traversal under stop_gradient,
    differentiable analytic re-evaluation on the selected primitive."""
    sel = scene_intersect(jax.lax.stop_gradient(cs),
                          jax.lax.stop_gradient(rays), isa=isa)
    return reeval_hit(cs.tris, rays, sel.gprim, sel.valid)
