"""Multi-segment motion-blur accel + traversal (N-timestep piecewise-
linear motion).

Analog of the reference's MB stack (AlignedNodeMB bvh.h:597,
AlignedNodeMB4D :837, bvh_builder_msmblur.h:587 multi-segment builder,
MB triangle intersectors): geometry stores N >= 2 vertex timesteps, the
BVH keeps per-node PER-TIMESTEP refit bounds (the lbbox-per-segment
analog — each uniform segment gets exact linear bounds, which is what
the reference's temporal splits buy for its non-uniform segments), and
traversal interpolates node bounds and triangle vertices at the ray's
time within its segment.

Node tests are conservative over the ray batch's whole time range
(union of the timestep knot boxes the range touches); leaf tests gather
the per-ray segment's two knot meshes and lerp exactly.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..build.bvh import BVH
from ..core.math import rcp_safe, ROBUST_MAX_RCP, ROBUST_MIN_RCP
from ..core.rayhit import Hits, Rays
from ..scene.prims import TrianglePrims
from .moeller import intersect_triangle


class MBAccel(NamedTuple):
    bvh: BVH                 # structure (bounds field = timestep 0)
    lower_ts: jnp.ndarray    # (S, M, W, 3) per-timestep refit bounds
    upper_ts: jnp.ndarray
    v0_ts: jnp.ndarray       # (S, T, 3) triangle verts per timestep
    v1_ts: jnp.ndarray
    v2_ts: jnp.ndarray
    geom_id: jnp.ndarray     # (T,)
    prim_id: jnp.ndarray
    uv_flip: jnp.ndarray
    # MB4D temporal splits (AlignedNodeMB4D, bvh.h:837): per-CHILD valid
    # time range — children of the synthetic root carry the temporal-
    # split subranges, everything else is [0, 1]. Rays only enter a
    # child whose range contains their time.
    time_lo: jnp.ndarray = None    # (M, W) f32
    time_hi: jnp.ndarray = None

    @property
    def num_timesteps(self) -> int:
        return self.lower_ts.shape[0]

    @property
    def has_time_splits(self) -> bool:
        return self.time_lo is not None


def _seg_weights(tm, S):
    """time in [0,1] -> (segment index, local weight) over S-1 uniform
    segments."""
    x = jnp.clip(tm, 0.0, 1.0) * (S - 1)
    seg = jnp.clip(x.astype(jnp.int32), 0, S - 2)
    return seg, x - seg


@functools.partial(jax.jit, static_argnames=("stack_depth", "max_leaf"))
def intersect_mb(accel: MBAccel, rays: Rays, time,
                 stack_depth: int = 96, max_leaf: int = 8) -> Hits:
    """Closest hit at ray time in [0, 1]. `time` is (R,) or scalar."""
    bvh = accel.bvh
    S = accel.num_timesteps
    org = rays.org.reshape(-1, 3)
    direction = rays.dir.reshape(-1, 3)
    tnear = rays.tnear.reshape(-1)
    tfar = rays.tfar.reshape(-1)
    R = tnear.shape[0]
    tm = jnp.asarray(time, jnp.float32)
    tm = jnp.broadcast_to(tm.reshape(-1) if tm.ndim > 1 else tm, (R,))
    seg, w = _seg_weights(tm, S)

    rdir = rcp_safe(direction)
    org_rdir = org * rdir

    tmin_time = jnp.min(tm)
    tmax_time = jnp.max(tm)

    def node_test(node, tcur):
        # conservative: union of every timestep knot box whose knot
        # interval intersects the batch's time range (the batch shares
        # one stack) — exact per-segment bounds via the refit knots
        lo = jnp.full((bvh.width, 3), jnp.inf)
        hi = jnp.full((bvh.width, 3), -jnp.inf)
        for s in range(S):
            k0 = (s - 1) / (S - 1)
            k1 = (s + 1) / (S - 1)
            act = (k1 >= tmin_time) & (k0 <= tmax_time)
            lo = jnp.where(act, jnp.minimum(lo, accel.lower_ts[s, node]),
                           lo)
            hi = jnp.where(act, jnp.maximum(hi, accel.upper_ts[s, node]),
                           hi)
        t_lo = lo[:, None, :] * rdir[None] - org_rdir[None]
        t_hi = hi[:, None, :] * rdir[None] - org_rdir[None]
        tmin = ROBUST_MIN_RCP * jnp.max(jnp.minimum(t_lo, t_hi), axis=-1)
        tmax = ROBUST_MAX_RCP * jnp.min(jnp.maximum(t_lo, t_hi), axis=-1)
        tmin = jnp.maximum(tmin, tnear[None])
        hit = (tmin <= tmax) & (tmin <= tcur[None])
        if accel.has_time_splits:
            # MB4D gate: per-ray time inside the child's valid range
            hit = hit & (tm[None] >= accel.time_lo[node][:, None]) \
                & (tm[None] <= accel.time_hi[node][:, None])
        return tmin, hit

    def lerp_tri(p):
        w_ = w[..., None]
        v0 = (accel.v0_ts[seg, p] * (1 - w_)
              + accel.v0_ts[seg + 1, p] * w_)
        v1 = (accel.v1_ts[seg, p] * (1 - w_)
              + accel.v1_ts[seg + 1, p] * w_)
        v2 = (accel.v2_ts[seg, p] * (1 - w_)
              + accel.v2_ts[seg + 1, p] * w_)
        return v0, v1, v2

    def leaf(start, count, t, prim):
        def body(i, carry):
            t, prim = carry
            p = bvh.prim_order[start + i]
            v0, v1, v2 = lerp_tri(p)
            ok, th, _u, _v, _ng = intersect_triangle(
                org, direction, tnear, t, v0, v1, v2)
            ok = ok & (i < count)
            return jnp.where(ok, th, t), jnp.where(ok, p, prim)

        return jax.lax.fori_loop(0, jnp.minimum(count, max_leaf), body,
                                 (t, prim))

    def cond(c):
        return c[0] > 0

    def step(c):
        sp, stack, t, prim = c
        sp = sp - 1
        node = stack[sp]
        child, count = bvh.child[node], bvh.count[node]
        tmin, hit = node_test(node, t)
        any_hit = jnp.any(hit, axis=1) & (count >= 0)
        for cc in range(bvh.width):
            def run(a, cc=cc):
                return leaf(child[cc], count[cc], *a)
            t, prim = jax.lax.cond(any_hit[cc] & (count[cc] > 0), run,
                                   lambda a: a, (t, prim))
        for cc in range(bvh.width):
            push = any_hit[cc] & (count[cc] == 0)
            stack = jnp.where(push, stack.at[sp].set(child[cc]), stack)
            sp = sp + push.astype(jnp.int32)
        return sp, stack, t, prim

    init = (jnp.int32(1), jnp.zeros((stack_depth,), jnp.int32), tfar,
            jnp.full((R,), -1, jnp.int32))
    _sp, _stack, t, prim = jax.lax.while_loop(cond, step, init)
    return _finalize_mb(accel, rays, t, prim, tm)


def _finalize_mb(accel: MBAccel, rays: Rays, t, prim, tm) -> Hits:
    """Finalize (t, winning prim) against time-interpolated triangles."""
    S = accel.num_timesteps
    org = rays.org.reshape(-1, 3)
    direction = rays.dir.reshape(-1, 3)
    tnear = rays.tnear.reshape(-1)
    tfar = rays.tfar.reshape(-1)
    seg, w = _seg_weights(tm, S)
    p = jnp.maximum(prim, 0)
    w_ = w[..., None]
    v0 = accel.v0_ts[seg, p] * (1 - w_) + accel.v0_ts[seg + 1, p] * w_
    v1 = accel.v1_ts[seg, p] * (1 - w_) + accel.v1_ts[seg + 1, p] * w_
    v2 = accel.v2_ts[seg, p] * (1 - w_) + accel.v2_ts[seg + 1, p] * w_
    valid = prim >= 0
    ok, _t2, u, v, ng = intersect_triangle(
        org, direction, tnear, t * (1.0 + 1e-6) + 1e-30, v0, v1, v2)
    # quad second-triangle uv remap (quadv.h: u->1-u, v->1-v)
    fl = accel.uv_flip[p] == 1
    u = jnp.where(fl, 1.0 - u, u)
    v = jnp.where(fl, 1.0 - v, v)
    shape = rays.batch_shape
    return Hits(
        t=jnp.where(valid, t, tfar).reshape(shape),
        u=jnp.where(valid, u, 0.0).reshape(shape),
        v=jnp.where(valid, v, 0.0).reshape(shape),
        ng=jnp.where(valid[..., None], ng, 0.0).reshape(shape + (3,)),
        prim_id=jnp.where(valid, accel.prim_id[p], -1).reshape(shape),
        geom_id=jnp.where(valid, accel.geom_id[p], -1).reshape(shape),
        gprim=jnp.where(valid, p, -1).reshape(shape),
        inst_id=jnp.full(shape, -1, jnp.int32),
    )


class MBCurves(NamedTuple):
    """Motion-blur CURVE accel (bvh_builder_msmblur_hair analog): one
    SAH topology over all-timestep segment union bounds, per-timestep
    refits, swept-cone leaves lerped at the ray's time."""

    bvh: BVH
    lower_ts: jnp.ndarray    # (S, M, W, 3)
    upper_ts: jnp.ndarray
    p0_ts: jnp.ndarray       # (S, C, 4) xyzr segment starts per timestep
    p1_ts: jnp.ndarray       # (S, C, 4)
    geom_id: jnp.ndarray     # (C,)
    prim_id: jnp.ndarray     # (C,) curve id within geometry
    u0: jnp.ndarray          # (C,) curve-u at segment start
    du: jnp.ndarray          # (C,)

    @property
    def num_timesteps(self) -> int:
        return self.lower_ts.shape[0]


@functools.partial(jax.jit, static_argnames=("stack_depth", "max_leaf"))
def intersect_mb_curves(accel: MBCurves, rays: Rays, time,
                        stack_depth: int = 96, max_leaf: int = 8):
    """Closest curve hit at ray time: (t, u, v, ng, prim, hitm) flat."""
    from .hair import _cone_hit

    bvh = accel.bvh
    S = accel.num_timesteps
    org = rays.org.reshape(-1, 3)
    direction = rays.dir.reshape(-1, 3)
    tnear = rays.tnear.reshape(-1)
    tfar = rays.tfar.reshape(-1)
    R = tnear.shape[0]
    tm = jnp.asarray(time, jnp.float32)
    tm = jnp.broadcast_to(tm.reshape(-1) if tm.ndim > 1 else tm, (R,))
    seg, w = _seg_weights(tm, S)
    rdir = rcp_safe(direction)
    org_rdir = org * rdir
    tmin_time = jnp.min(tm)
    tmax_time = jnp.max(tm)
    rr = Rays(org, direction, tnear, tfar)

    def node_test(node, tcur):
        lo = jnp.full((bvh.width, 3), jnp.inf)
        hi = jnp.full((bvh.width, 3), -jnp.inf)
        for s in range(S):
            k0 = (s - 1) / (S - 1)
            k1 = (s + 1) / (S - 1)
            act = (k1 >= tmin_time) & (k0 <= tmax_time)
            lo = jnp.where(act, jnp.minimum(lo, accel.lower_ts[s, node]),
                           lo)
            hi = jnp.where(act, jnp.maximum(hi, accel.upper_ts[s, node]),
                           hi)
        t_lo = lo[:, None, :] * rdir[None] - org_rdir[None]
        t_hi = hi[:, None, :] * rdir[None] - org_rdir[None]
        tmin = ROBUST_MIN_RCP * jnp.max(jnp.minimum(t_lo, t_hi), axis=-1)
        tmax = ROBUST_MAX_RCP * jnp.min(jnp.maximum(t_lo, t_hi), axis=-1)
        tmin = jnp.maximum(tmin, tnear[None])
        return tmin, (tmin <= tmax) & (tmin <= tcur[None])

    def leaf(start, count, t, prim, sh):
        def body(i, carry):
            t, prim, sh = carry
            p = bvh.prim_order[start + i]
            w_ = w[..., None]
            a = accel.p0_ts[seg, p] * (1 - w_) + accel.p0_ts[seg + 1, p] * w_
            b = accel.p1_ts[seg, p] * (1 - w_) + accel.p1_ts[seg + 1, p] * w_
            ok, th, uh, ng = _cone_hit(a[:, :3], b[:, :3], a[:, 3], b[:, 3],
                                       rr, t)
            ok = ok & (i < count)
            return (jnp.where(ok, th, t), jnp.where(ok, p, prim),
                    (jnp.where(ok, uh, sh[0]),
                     jnp.where(ok[..., None], ng, sh[1])))

        return jax.lax.fori_loop(0, jnp.minimum(count, max_leaf), body,
                                 (t, prim, sh))

    def cond(c):
        return c[0] > 0

    def step(c):
        sp, stack, t, prim, sh = c
        sp = sp - 1
        node = stack[sp]
        child, count = bvh.child[node], bvh.count[node]
        tmin, hit = node_test(node, t)
        any_hit = jnp.any(hit, axis=1) & (count >= 0)
        for cc in range(bvh.width):
            def run(a, cc=cc):
                return leaf(child[cc], count[cc], *a)
            t, prim, sh = jax.lax.cond(
                any_hit[cc] & (count[cc] > 0), run,
                lambda a: a, (t, prim, sh))
        for cc in range(bvh.width):
            push = any_hit[cc] & (count[cc] == 0)
            stack = jnp.where(push, stack.at[sp].set(child[cc]), stack)
            sp = sp + push.astype(jnp.int32)
        return sp, stack, t, prim, sh

    sh0 = (jnp.zeros((R,)), jnp.zeros((R, 3)))
    init = (jnp.int32(1), jnp.zeros((stack_depth,), jnp.int32), tfar,
            jnp.full((R,), -1, jnp.int32), sh0)
    _sp, _stack, t, prim, sh = jax.lax.while_loop(cond, step, init)
    hitm = prim >= 0
    p = jnp.maximum(prim, 0)
    u = jnp.where(hitm, accel.u0[p] + sh[0] * accel.du[p], 0.0)
    return (t, u, jnp.zeros_like(u), sh[1],
            jnp.where(hitm, accel.prim_id[p], -1),
            jnp.where(hitm, accel.geom_id[p], -1), hitm)
