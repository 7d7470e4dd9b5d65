"""User-geometry accel: BVH over callback bounds + callback leaf tests.

Analog of kernels/geometry/object.h + object_intersector.h: user prims
are wrapped by a regular BVH; reaching a leaf invokes the user's
intersect function for each prim against the whole packet (the C
callback ABI becomes a traced jax function). XLA path only — user
callbacks are arbitrary traced code that cannot run inside the CUDA
kernel (same boundary as the reference, where user geometry always
calls back into app code).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..build.bvh import BVH
from ..core.math import rcp_safe
from ..core.rayhit import Rays
from .packet import _node_box_test


class UserAccel(NamedTuple):
    bvh: BVH
    geom_id: int          # static
    num_prims: int        # static


def intersect_user(accel: UserAccel, intersect_fn: Callable, rays: Rays,
                   t_in, stack_depth: int = 96, max_leaf: int = 8,
                   with_stats: bool = False):
    """Returns (t, u, v, ng, prim, hit_mask) min-combined against t_in
    (+ per-ray node-test hit count when with_stats — the STAT3
    trav_nodes analog for accel-quality comparisons: how many (ray,
    node) box tests passed, i.e. per-ray traversal work)."""
    bvh = accel.bvh
    org = rays.org.reshape(-1, 3)
    direction = rays.dir.reshape(-1, 3)
    tnear = rays.tnear.reshape(-1)
    R = tnear.shape[0]
    t0 = t_in.reshape(-1)

    rdir = rcp_safe(direction)
    org_rdir = org * rdir

    def leaf(start, count, t, u, v, ng, prim):
        def body(i, carry):
            t, u, v, ng, prim = carry
            p = bvh.prim_order[start + i]
            flat = Rays(org, direction, tnear, t)
            ok, th, uh, vh, ngh = intersect_fn(p, flat, t)
            ok = ok & (i < count) & (th < t) & (th > tnear)
            t = jnp.where(ok, th, t)
            u = jnp.where(ok, uh, u)
            v = jnp.where(ok, vh, v)
            ng = jnp.where(ok[..., None], ngh, ng)
            prim = jnp.where(ok, p, prim)
            return t, u, v, ng, prim

        return jax.lax.fori_loop(0, jnp.minimum(count, max_leaf), body,
                                 (t, u, v, ng, prim))

    def cond(c):
        return c[0] > 0

    def step(c):
        sp, stack, t, u, v, ng, prim, pops = c
        sp = sp - 1
        node = stack[sp]
        lower, upper = bvh.lower[node], bvh.upper[node]
        child, count = bvh.child[node], bvh.count[node]
        tmin, hit = _node_box_test(lower, upper, rdir, org_rdir, tnear, t)
        any_hit = jnp.any(hit, axis=1) & (count >= 0)
        # stats: only REAL child slots (pads carry count < 0)
        pops = pops + jnp.sum(
            jnp.where((count >= 0)[:, None], hit, False).astype(jnp.int32))

        for c_ in range(bvh.width):
            def run(args, c_=c_):
                return leaf(child[c_], count[c_], *args)
            t, u, v, ng, prim = jax.lax.cond(
                any_hit[c_] & (count[c_] > 0), run, lambda a: a,
                (t, u, v, ng, prim))

        for c_ in range(bvh.width):
            push = any_hit[c_] & (count[c_] == 0)
            stack = jnp.where(push, stack.at[sp].set(child[c_]), stack)
            sp = sp + push.astype(jnp.int32)
        return sp, stack, t, u, v, ng, prim, pops

    init = (jnp.int32(1), jnp.zeros((stack_depth,), jnp.int32),
            t0, jnp.zeros(R), jnp.zeros(R), jnp.zeros((R, 3)),
            jnp.full((R,), -1, jnp.int32), jnp.int32(0))
    _sp, _stack, t, u, v, ng, prim, pops = jax.lax.while_loop(
        cond, step, init)
    if with_stats:
        return t, u, v, ng, prim, prim >= 0, pops
    return t, u, v, ng, prim, prim >= 0
