"""Device-side Morton BVH builder (build quality LOW / dynamic scenes).

The analog of the reference's morton builder
(kernels/builders/bvh_builder_morton.h: 30-bit codes :77, radix sort,
bottom-up merge), re-designed for the device: the whole build is jnp ops that run
ON DEVICE — code computation, one argsort, and an implicit complete 4-ary
tree over the sorted order whose bounds come from pure reshape/min/max
reductions. No host round-trip, so dynamic scenes can rebuild every frame
inside jit (the RTC_BUILD_QUALITY_LOW contract, scene.cpp dynamic accels).

Tree quality is below SAH (no object splits), matching the reference's
LOW-quality tradeoff; traversal consumes the same BVH pytree.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .bvh import BVH


def morton3d(x, y, z):
    """Interleave 10-bit coords -> 30-bit morton code (bvh_builder_morton
    .h:77 analog)."""
    def part(v):
        v = v.astype(jnp.uint32) & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v
    return part(x) | (part(y) << 1) | (part(z) << 2)


@functools.partial(jax.jit, static_argnames=("max_leaf",))
def build_morton(prim_lower: jnp.ndarray, prim_upper: jnp.ndarray,
                 max_leaf: int = 4) -> BVH:
    """Jittable BVH build: morton sort + implicit 4-ary tree.

    Returns a BVH with the standard pytree layout (node 0 = root). The
    node count is static for a given prim count, so rebuilds re-use the
    compiled program (dynamic scenes re-commit per frame for free).
    """
    P = prim_lower.shape[0]
    centroid = 0.5 * (prim_lower + prim_upper)
    lo = jnp.min(centroid, axis=0)
    hi = jnp.max(centroid, axis=0)
    scale = 1023.0 / jnp.maximum(hi - lo, 1e-20)
    q = jnp.clip(((centroid - lo) * scale), 0.0, 1023.0).astype(jnp.uint32)
    codes = morton3d(q[:, 0], q[:, 1], q[:, 2])
    order = jnp.argsort(codes).astype(jnp.int32)

    # --- leaves: chunks of max_leaf prims in morton order -----------------
    n_leaves = -(-P // max_leaf)
    pad = n_leaves * max_leaf - P
    # padded prims get empty boxes (inf, -inf) so reductions ignore them
    plo = jnp.concatenate([prim_lower[order],
                           jnp.full((pad, 3), jnp.inf)])
    phi = jnp.concatenate([prim_upper[order],
                           jnp.full((pad, 3), -jnp.inf)])
    leaf_lo = plo.reshape(n_leaves, max_leaf, 3).min(axis=1)
    leaf_hi = phi.reshape(n_leaves, max_leaf, 3).max(axis=1)
    leaf_start = jnp.arange(n_leaves, dtype=jnp.int32) * max_leaf
    leaf_count = jnp.minimum(
        jnp.full(n_leaves, max_leaf, jnp.int32),
        jnp.maximum(P - leaf_start, 0))

    # --- implicit 4-ary levels (bottom-up bounds) -------------------------
    levels = []  # top-down list of (lo, hi) arrays, each (K, 3)
    cur_lo, cur_hi = leaf_lo, leaf_hi
    while cur_lo.shape[0] > 1:
        K = cur_lo.shape[0]
        Kp = -(-K // 4) * 4
        cl = jnp.concatenate([cur_lo, jnp.full((Kp - K, 3), jnp.inf)])
        ch = jnp.concatenate([cur_hi, jnp.full((Kp - K, 3), -jnp.inf)])
        levels.append((cur_lo, cur_hi, K))
        cur_lo = cl.reshape(-1, 4, 3).min(axis=1)
        cur_hi = ch.reshape(-1, 4, 3).max(axis=1)
    levels.append((cur_lo, cur_hi, cur_lo.shape[0]))
    levels.reverse()  # levels[0] = root level (K=1)

    # single-leaf scene: one root node with one leaf child
    if len(levels) == 1:
        lower = jnp.full((1, 4, 3), jnp.inf).at[0, 0].set(leaf_lo[0])
        upper = jnp.full((1, 4, 3), -jnp.inf).at[0, 0].set(leaf_hi[0])
        child = jnp.zeros((1, 4), jnp.int32)
        count = jnp.full((1, 4), -1, jnp.int32).at[0, 0].set(leaf_count[0])
        return BVH(lower.astype(jnp.float32), upper.astype(jnp.float32),
                   child, count, order)

    # node layout: BFS concat of all levels EXCEPT the leaf level; each
    # node's 4 children are the next level's entries 4i..4i+3
    inner_levels = levels[:-1]  # the last level's entries are leaves
    level_sizes = [lv[2] for lv in inner_levels]
    level_offsets = np.concatenate([[0], np.cumsum(level_sizes)]).astype(int)
    M = int(level_offsets[-1]) if inner_levels else 1

    lower = jnp.full((M, 4, 3), jnp.inf)
    upper = jnp.full((M, 4, 3), -jnp.inf)
    child = jnp.zeros((M, 4), jnp.int32)
    count = jnp.full((M, 4), -1, jnp.int32)

    for li, (_, _, K) in enumerate(inner_levels):
        off = int(level_offsets[li])
        nlo, nhi, nK = levels[li + 1]
        Kp = -(-nK // 4) * 4
        clo = jnp.concatenate([nlo, jnp.full((Kp - nK, 3), jnp.inf)]
                              ).reshape(-1, 4, 3)[:K]
        chi = jnp.concatenate([nhi, jnp.full((Kp - nK, 3), -jnp.inf)]
                              ).reshape(-1, 4, 3)[:K]
        lower = lower.at[off:off + K].set(clo)
        upper = upper.at[off:off + K].set(chi)

        child_ids = (jnp.arange(K * 4, dtype=jnp.int32).reshape(K, 4))
        valid = child_ids < nK
        if li + 1 < len(inner_levels):
            noff = int(level_offsets[li + 1])
            child = child.at[off:off + K].set(
                jnp.where(valid, child_ids + noff, 0))
            count = count.at[off:off + K].set(jnp.where(valid, 0, -1))
        else:
            # children are leaves
            starts = leaf_start[jnp.clip(child_ids, 0, n_leaves - 1)]
            cnts = leaf_count[jnp.clip(child_ids, 0, n_leaves - 1)]
            child = child.at[off:off + K].set(jnp.where(valid, starts, 0))
            count = count.at[off:off + K].set(jnp.where(valid, cnts, -1))

    return BVH(lower=lower.astype(jnp.float32),
               upper=upper.astype(jnp.float32),
               child=child, count=count, prim_order=order)
