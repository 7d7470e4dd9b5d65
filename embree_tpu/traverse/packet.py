"""Shared-stack ray-packet BVH traversal (pure JAX, jittable).

A generalization of the reference's packet traversal
(kernels/bvh/bvh_intersector_hybrid.cpp + bvh_intersector1.cpp:41-127):
an entire packet of rays (default 1024) walks the BVH in lock-step behind
ONE scalar traversal stack. A node is visited when any ray in the packet
intersects its box; leaf triangles are broadcast against the whole
packet: scalar node fetches and fully vectorized box/triangle tests, no
per-lane gathers. This is the CPU path and the reference that the CUDA
kernel (traverse/gpu.py) is checked against; masks and filters run here.

Semantics preserved from the reference:
  * distance-sorted child push so the nearest child pops first
    (bvh_traverser1.h traverseClosestHit)
  * pop-cull: skip a popped subtree when no ray can still be improved
  * robust slab test with 1+-3ulp scaling (node_intersector1.h:108-179)
  * occluded() early-exits once every ray is occluded
    (bvh_intersector1.cpp:130-210)

Traversal keeps only (t_best, prim_best) per ray; u/v/Ng are recomputed
after the walk from the winning primitive — this is also exactly the
differentiable-hit re-evaluation the diff/ layer needs.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..build.bvh import BVH
from ..core.math import ROBUST_MAX_RCP, ROBUST_MIN_RCP, rcp_safe
from ..core.rayhit import Hits, Rays
from ..scene.prims import TrianglePrims
from .moeller import intersect_triangle


class _TravState(NamedTuple):
    stack: jnp.ndarray  # (D,) i32 node ids
    sp: jnp.ndarray     # scalar i32
    t: jnp.ndarray      # (R,) best hit distance (= tfar while traversing)
    prim: jnp.ndarray   # (R,) best global prim index, -1 = miss


def _node_box_test(lower, upper, rdir, org_rdir, tnear, tcur):
    """Robust slab test of W child boxes vs R rays -> (tmin, hit) (W, R).

    Follows the reference robust variant (node_intersector1.h:108-179):
    plain slab distances, then entry scaled by 1-3ulp and exit by 1+3ulp so
    rays passing exactly through box edges are never missed.
    """
    lo = lower[:, None, :]  # (W, 1, 3) vs rays (R, 3) -> (W, R, 3)
    hi = upper[:, None, :]
    t_lo = lo * rdir[None] - org_rdir[None]
    t_hi = hi * rdir[None] - org_rdir[None]
    tmin = ROBUST_MIN_RCP * jnp.max(jnp.minimum(t_lo, t_hi), axis=-1)
    tmax = ROBUST_MAX_RCP * jnp.min(jnp.maximum(t_lo, t_hi), axis=-1)
    tmin = jnp.maximum(tmin, tnear[None])
    hit = (tmin <= tmax) & (tmin <= tcur[None])
    return tmin, hit


def _leaf_intersect(tris: TrianglePrims, prim_order, start, count, max_leaf,
                    org, direction, tnear, t, prim, filter_fn=None,
                    prim_mask=None, ray_mask=None, backface_cull=False):
    """Test up to max_leaf contiguous leaf prims against the packet.
    `filter_fn` is the intersection-filter callback (filter.h:51
    runIntersectionFilter1): called per candidate hit, may reject lanes
    so traversal keeps searching. `prim_mask`/`ray_mask` implement the
    geometry/ray mask test (geometry.h mask & ray.mask, EMBREE_RAY_MASK):
    a hit stands only when (geom.mask & ray.mask) != 0."""
    def body(i, carry):
        t, prim = carry
        p = prim_order[start + i]
        valid_i = i < count
        v0, v1, v2 = tris.v0[p], tris.v1[p], tris.v2[p]
        valid, t_hit, u, v, ng = intersect_triangle(
            org, direction, tnear, t, v0, v1, v2,
            backface_cull=backface_cull)
        valid = valid & valid_i
        if prim_mask is not None and ray_mask is not None:
            valid = valid & ((prim_mask[p] & ray_mask) != 0)
        if filter_fn is not None:
            accept = filter_fn(org, direction, t_hit, u, v, ng,
                               tris.geom_id[p], tris.prim_id[p])
            valid = valid & accept
        t = jnp.where(valid, t_hit, t)
        prim = jnp.where(valid, p, prim)
        return t, prim

    t, prim = jax.lax.fori_loop(0, jnp.minimum(count, max_leaf), body, (t, prim))
    return t, prim


def _leaf_occluded(tris: TrianglePrims, prim_order, start, count, max_leaf,
                   org, direction, tnear, tfar, occluded,
                   prim_mask=None, ray_mask=None, backface_cull=False):
    def body(i, occ):
        p = prim_order[start + i]
        valid_i = i < count
        valid, _t, _u, _v, _ng = intersect_triangle(
            org, direction, tnear, tfar, tris.v0[p], tris.v1[p], tris.v2[p],
            backface_cull=backface_cull)
        if prim_mask is not None and ray_mask is not None:
            valid = valid & ((prim_mask[p] & ray_mask) != 0)
        return occ | (valid & valid_i)

    return jax.lax.fori_loop(0, jnp.minimum(count, max_leaf), body, occluded)


@functools.partial(jax.jit, static_argnames=("stack_depth", "max_leaf",
                                             "filter_fn", "backface_cull"))
def intersect_packet(bvh: BVH, tris: TrianglePrims, rays: Rays,
                     stack_depth: int = 96, max_leaf: int = 8,
                     filter_fn=None, prim_mask=None, ray_mask=None,
                     backface_cull=False):
    """Closest-hit traversal for a flat batch of rays. Returns Hits."""
    org, direction = rays.org, rays.dir
    tnear, tfar = rays.tnear, rays.tfar
    R = tnear.shape[0]
    W = bvh.width

    # TravRay precompute (node_intersector1.h:33-106)
    rdir = rcp_safe(direction)
    org_rdir = org * rdir

    state = _TravState(
        stack=jnp.zeros((stack_depth,), jnp.int32),
        sp=jnp.int32(1),  # root pushed
        t=tfar,
        prim=jnp.full((R,), -1, jnp.int32),
    )

    def cond(s: _TravState):
        return s.sp > 0

    def body(s: _TravState):
        sp = s.sp - 1
        node = s.stack[sp]
        lower = bvh.lower[node]   # (W, 3)
        upper = bvh.upper[node]
        child = bvh.child[node]   # (W,)
        count = bvh.count[node]

        tmin, hit = _node_box_test(lower, upper, rdir, org_rdir, tnear, s.t)
        child_valid = count >= 0
        any_hit = jnp.any(hit, axis=1) & child_valid       # (W,)

        # --- leaf children: broadcast prim tests over the packet ----------
        t, prim = s.t, s.prim

        def do_leaf(c, t, prim):
            def run(args):
                t, prim = args
                return _leaf_intersect(tris, bvh.prim_order, child[c], count[c],
                                       max_leaf, org, direction, tnear, t, prim,
                                       filter_fn, prim_mask, ray_mask,
                                       backface_cull)
            return jax.lax.cond(any_hit[c] & (count[c] > 0), run,
                                lambda a: a, (t, prim))

        for c in range(W):
            t, prim = do_leaf(c, t, prim)

        # --- inner children: distance-sorted push (bvh_traverser1.h) ------
        traverse = any_hit & (count == 0)
        key = jnp.where(traverse, jnp.min(jnp.where(hit, tmin, jnp.inf), axis=1),
                        -jnp.inf)
        # push farthest first -> nearest on top of stack
        order = jnp.argsort(-key)
        stack, spv = s.stack, sp
        for k in range(W):
            c = order[k]
            push = traverse[c]
            stack = jnp.where(push, stack.at[spv].set(child[c]), stack)
            spv = spv + push.astype(jnp.int32)

        return _TravState(stack, spv, t, prim)

    final = jax.lax.while_loop(cond, body, state)
    return _finalize_hits(tris, rays, final.t, final.prim)


def _finalize_hits(tris: TrianglePrims, rays: Rays, t, prim) -> Hits:
    """Recompute u/v/Ng from the winning prim (differentiable re-eval).

    Vertex/meta tables are packed (concat over the small prim axis is
    ~free) so the per-ray random access is 2 gather ops instead of 6."""
    valid = prim >= 0
    p = jnp.maximum(prim, 0)
    packf = jnp.concatenate([tris.v0, tris.v1, tris.v2], axis=-1)  # (T, 9)
    g = packf[p]
    v0, v1, v2 = g[..., 0:3], g[..., 3:6], g[..., 6:9]
    packi = jnp.stack([tris.uv_flip, tris.prim_id, tris.geom_id],
                      axis=-1)  # (T, 3)
    meta = packi[p]
    _valid, _t, u, v, ng = intersect_triangle(
        rays.org, rays.dir, rays.tnear, t * (1.0 + 1e-6) + 1e-30, v0, v1, v2)
    # quad second-triangle uv remap (kernels/geometry/quadv.h convention);
    # Ng needs no flip: the second triangle is stored with consistent winding
    flip = meta[..., 0] == 1
    u = jnp.where(flip, 1.0 - u, u)
    v = jnp.where(flip, 1.0 - v, v)
    return Hits(
        t=jnp.where(valid, t, rays.tfar),
        u=jnp.where(valid, u, 0.0),
        v=jnp.where(valid, v, 0.0),
        ng=jnp.where(valid[..., None], ng, 0.0),
        prim_id=jnp.where(valid, meta[..., 1], -1),
        geom_id=jnp.where(valid, meta[..., 2], -1),
        gprim=jnp.where(valid, p, -1),
        inst_id=jnp.full(valid.shape, -1, jnp.int32),
    )


@functools.partial(jax.jit, static_argnames=("stack_depth", "max_leaf",
                                             "packet_size", "filter_fn",
                                             "backface_cull"))
def intersect_chunked(bvh: BVH, tris: TrianglePrims, rays: Rays,
                      packet_size: int = 1024, stack_depth: int = 96,
                      max_leaf: int = 8, filter_fn=None, prim_mask=None,
                      ray_mask=None, backface_cull=False):
    """Chunk a flat ray batch into fixed-size packets and traverse each
    with its own shared stack (lax.map = sequential, like the reference's
    per-tile parallel_for tutorial loop). Coherent chunks (image tiles,
    morton-sorted rays) visit far fewer nodes per packet than one giant
    packet would."""
    R = rays.tnear.shape[0]
    if R <= packet_size:
        return intersect_packet(bvh, tris, rays, stack_depth, max_leaf,
                                filter_fn, prim_mask, ray_mask,
                                backface_cull)
    P = packet_size
    Rp = -(-R // P) * P
    pad = Rp - R

    def pad1(x, fill):
        return jnp.concatenate([x, jnp.full((pad,) + x.shape[1:], fill,
                                            x.dtype)])

    org = pad1(rays.org, 0.0).reshape(-1, P, 3)
    d = pad1(rays.dir, 1.0).reshape(-1, P, 3)
    tn = pad1(rays.tnear, 0.0).reshape(-1, P)
    tf = pad1(rays.tfar, -jnp.inf).reshape(-1, P)
    rm = (None if ray_mask is None
          else pad1(ray_mask, 0).reshape(-1, P))

    def run(chunk):
        o, dd, n, f, m = chunk
        return intersect_packet(bvh, tris, Rays(o, dd, n, f),
                                stack_depth, max_leaf, filter_fn,
                                prim_mask, m, backface_cull)

    hits = jax.lax.map(run, (org, d, tn, tf, rm))
    flat = jax.tree.map(lambda x: x.reshape((Rp,) + x.shape[2:]), hits)
    return jax.tree.map(lambda x: x[:R], flat)


@functools.partial(jax.jit, static_argnames=("stack_depth", "max_leaf",
                                             "packet_size", "backface_cull"))
def occluded_chunked(bvh: BVH, tris: TrianglePrims, rays: Rays,
                     packet_size: int = 1024, stack_depth: int = 96,
                     max_leaf: int = 8, prim_mask=None, ray_mask=None,
                     backface_cull=False):
    R = rays.tnear.shape[0]
    if R <= packet_size:
        return occluded_packet(bvh, tris, rays, stack_depth, max_leaf,
                               prim_mask, ray_mask, backface_cull)
    P = packet_size
    Rp = -(-R // P) * P
    pad = Rp - R

    def pad1(x, fill):
        return jnp.concatenate([x, jnp.full((pad,) + x.shape[1:], fill,
                                            x.dtype)])

    org = pad1(rays.org, 0.0).reshape(-1, P, 3)
    d = pad1(rays.dir, 1.0).reshape(-1, P, 3)
    tn = pad1(rays.tnear, 0.0).reshape(-1, P)
    tf = pad1(rays.tfar, -jnp.inf).reshape(-1, P)

    rm = (None if ray_mask is None
          else pad1(ray_mask, 0).reshape(-1, P))

    def run(chunk):
        o, dd, n, f, m = chunk
        return occluded_packet(bvh, tris, Rays(o, dd, n, f),
                               stack_depth, max_leaf, prim_mask, m,
                               backface_cull)

    occ = jax.lax.map(run, (org, d, tn, tf, rm))
    return occ.reshape(Rp)[:R]


@functools.partial(jax.jit, static_argnames=("stack_depth", "max_leaf",
                                             "backface_cull"))
def occluded_packet(bvh: BVH, tris: TrianglePrims, rays: Rays,
                    stack_depth: int = 96, max_leaf: int = 8,
                    prim_mask=None, ray_mask=None, backface_cull=False):
    """Any-hit traversal; returns bool (R,) occlusion mask."""
    org, direction = rays.org, rays.dir
    tnear, tfar = rays.tnear, rays.tfar
    R = tnear.shape[0]
    W = bvh.width

    rdir = rcp_safe(direction)
    org_rdir = org * rdir

    stack0 = jnp.zeros((stack_depth,), jnp.int32)
    occ0 = jnp.zeros((R,), bool)

    def cond(carry):
        stack, sp, occ = carry
        return (sp > 0) & jnp.logical_not(jnp.all(occ))

    def body(carry):
        stack, sp, occ = carry
        sp = sp - 1
        node = stack[sp]
        lower, upper = bvh.lower[node], bvh.upper[node]
        child, count = bvh.child[node], bvh.count[node]

        # un-occluded rays only can trigger traversal
        tcur = jnp.where(occ, -jnp.inf, tfar)
        _tmin, hit = _node_box_test(lower, upper, rdir, org_rdir, tnear, tcur)
        any_hit = jnp.any(hit, axis=1) & (count >= 0)

        def do_leaf(c, occ):
            def run(occ):
                return _leaf_occluded(tris, bvh.prim_order, child[c], count[c],
                                      8, org, direction, tnear,
                                      jnp.where(occ, tnear, tfar), occ,
                                      prim_mask, ray_mask, backface_cull)
            return jax.lax.cond(any_hit[c] & (count[c] > 0), run,
                                lambda o: o, occ)

        for c in range(W):
            occ = do_leaf(c, occ)

        traverse = any_hit & (count == 0)
        for c in range(W):
            push = traverse[c]
            stack = jnp.where(push, stack.at[sp].set(child[c]), stack)
            sp = sp + push.astype(jnp.int32)

        return stack, sp, occ

    _stack, _sp, occ = jax.lax.while_loop(cond, body, (stack0, jnp.int32(1), occ0))
    return occ
