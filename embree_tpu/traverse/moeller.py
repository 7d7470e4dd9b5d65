"""Moeller-Trumbore triangle intersection (vectorized over rays).

Exact semantics of the reference's precomputed-cross variant
(kernels/geometry/triangle_intersector_moeller.h:80-113):

    e1 = v0 - v1,  e2 = v2 - v0,  Ng = cross(e2, e1)        (:122,132-133)
    C = v0 - O,    R = cross(C, D),  den = dot(Ng, D)
    U = dot(R, e2) ^ sgn(den),  V = dot(R, e1) ^ sgn(den)
    valid: den != 0, U >= 0, V >= 0, U + V <= |den|
    T = dot(Ng, C) ^ sgn(den),  |den|*tnear < T <= |den|*tfar
    u = U/|den|, v = V/|den|, t = T/|den|                    (:42-47 finalize)

The division is deferred exactly like the reference (sign-flip instead of
divide), which keeps the test watertight-ish in fp32 and branch-free. Broadcasts a single triangle against any ray batch shape, or
triangle batches against matching ray batches.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.math import cross, dot


def intersect_triangle(org, direction, tnear, tfar, v0, v1, v2,
                       backface_cull: bool = False):
    """Returns (valid, t, u, v, ng); t/u/v are garbage where ~valid."""
    e1 = v0 - v1
    e2 = v2 - v0
    ng = cross(e2, e1)

    c = v0 - org
    r = cross(c, direction)
    den = dot(ng, direction)
    abs_den = jnp.abs(den)
    sgn = jnp.where(den >= 0, 1.0, -1.0)

    u_s = dot(r, e2) * sgn
    v_s = dot(r, e1) * sgn
    if backface_cull:
        valid = (den < 0) & (u_s >= 0) & (v_s >= 0) & (u_s + v_s <= abs_den)
    else:
        valid = (den != 0) & (u_s >= 0) & (v_s >= 0) & (u_s + v_s <= abs_den)

    t_s = dot(ng, c) * sgn
    valid = valid & (abs_den * tnear < t_s) & (t_s <= abs_den * tfar)

    rcp = jnp.where(abs_den > 0, 1.0 / jnp.maximum(abs_den, 1e-37), 0.0)
    return valid, t_s * rcp, u_s * rcp, v_s * rcp, ng


def triangle_uv_and_point(org, direction, t, u, v, v0, v1, v2):
    """Differentiable re-evaluation of the hit point from barycentrics,
    used by the diff/ pass (recompute-from-primID trick, SURVEY.md §7.6)."""
    return v0 * (1.0 - u - v)[..., None] + v1 * u[..., None] + v2 * v[..., None]


def intersect_triangle_pluecker(org, direction, tnear, tfar, v0, v1, v2,
                                backface_cull: bool = False):
    """Pluecker-coordinate triangle test (triangle_intersector_pluecker.h):
    the watertight variant used in robust mode — edge tests share
    computations between adjacent triangles so a ray crossing a shared
    edge always hits exactly one of them.

    Returns (valid, t, u, v, ng) like intersect_triangle."""
    o = org
    d = direction
    e0 = v2 - v0
    e1 = v0 - v1
    e2 = v1 - v2

    a0 = v0 - o
    a1 = v1 - o
    a2 = v2 - o

    # signed edge volumes (Pluecker inner products)
    u_ = dot(cross(a2 + a0, e0), d)
    v_ = dot(cross(a0 + a1, e1), d)
    w_ = dot(cross(a1 + a2, e2), d)
    uvw = u_ + v_ + w_
    eps = 1e-8 * jnp.abs(uvw)
    if backface_cull:
        valid = jnp.minimum(jnp.minimum(u_, v_), w_) >= -eps
    else:
        valid = (jnp.minimum(jnp.minimum(u_, v_), w_) >= -eps) |                 (jnp.maximum(jnp.maximum(u_, v_), w_) <= eps)

    ng = cross(e0, e1)  # == cross(v1-v0, v2-v0), matches MT's Ng
    den = 2.0 * dot(ng, d)
    t_s = 2.0 * dot(a0, ng)
    abs_den = jnp.abs(den)
    sgn = jnp.where(den >= 0, 1.0, -1.0)
    t_scaled = t_s * sgn
    valid = valid & (den != 0) & (abs_den * tnear < t_scaled) \
        & (t_scaled <= abs_den * tfar)

    rcp_uvw = jnp.where(jnp.abs(uvw) > 1e-37, 1.0 / uvw, 0.0)
    u_out = jnp.clip(u_ * rcp_uvw, 0.0, 1.0)
    v_out = jnp.clip(v_ * rcp_uvw, 0.0, 1.0)
    t_out = t_scaled / jnp.maximum(abs_den, 1e-37)
    return valid, t_out, u_out, v_out, ng
