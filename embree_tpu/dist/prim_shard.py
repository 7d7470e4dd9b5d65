"""Primitive-sharded scenes: ray ppermute ring over the device mesh.

The second distributed mode from SURVEY.md §2.7 (the reference has no
distributed layer at all — its parallelism stops at threads on one
host): when the scene does not fit one card's memory, the *primitives* are
sharded across the mesh axis instead of replicated. Each device builds
and holds a BVH over its spatially-contiguous chunk (morton-ordered
centroid split for locality), and the *rays* travel: D ring steps of
`jax.lax.ppermute` rotate each ray block (with its current best hit)
around the axis, so every ray meets every scene shard while all
transfers are neighbor-to-neighbor (NVLink between GPUs). After D hops the rays
are back home with the global closest hit.

Bandwidth argument: rays+hits are ~30 floats/ray; a scene shard is
O(100) bytes/prim with millions of prims — rotating rays instead of the
scene keeps ring traffic tiny, and the running best-t tightens tfar at
every hop (later shards traverse with a shrinking interval, the
distributed analog of the reference's stream-culling, see
SURVEY.md §2.3 stream traversal).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..build.bvh import BVH
from ..build.sah import BuildSettings, build_sah
from ..core.rayhit import Hits, Rays, miss_hits
from ..scene.prims import TrianglePrims


class PrimShardedScene(NamedTuple):
    """Stacked per-shard accels; every leaf has a leading (D,) shard
    axis which is placed on the mesh's shard axis."""

    lower: jnp.ndarray       # (D, M, W, 3)
    upper: jnp.ndarray       # (D, M, W, 3)
    child: jnp.ndarray       # (D, M, W)
    count: jnp.ndarray       # (D, M, W)
    prim_order: jnp.ndarray  # (D, T)
    v0: jnp.ndarray          # (D, T, 3)
    v1: jnp.ndarray
    v2: jnp.ndarray
    geom_id: jnp.ndarray     # (D, T)
    prim_id: jnp.ndarray     # (D, T)
    uv_flip: jnp.ndarray     # (D, T)
    gmap: jnp.ndarray        # (D, T) shard-local -> global prim index

    @property
    def num_shards(self):
        return self.lower.shape[0]


def _morton_u32(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit x/y/z (build/morton.py codec, host side)."""
    def spread(v):
        v = v.astype(np.uint64) & 0x3FF
        v = (v | (v << 16)) & 0x30000FF
        v = (v | (v << 8)) & 0x300F00F
        v = (v | (v << 4)) & 0x30C30C3
        v = (v | (v << 2)) & 0x9249249
        return v
    return (spread(x[:, 0]) | (spread(x[:, 1]) << 1)
            | (spread(x[:, 2]) << 2))


def build_prim_sharded(v0, v1, v2, geom_id, prim_id, uv_flip,
                       n_shards: int,
                       settings: BuildSettings = BuildSettings(),
                       backend: str = "default") -> PrimShardedScene:
    """Host-side: partition triangles into `n_shards` morton-contiguous
    chunks, build one BVH per chunk, pad to common shapes and stack.
    Shard `i` of the result goes to device `i` of the ring axis."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    geom_id = np.asarray(geom_id, np.int32)
    prim_id = np.asarray(prim_id, np.int32)
    uv_flip = np.asarray(uv_flip, np.int32)
    T = v0.shape[0]

    # morton order of centroids -> equal contiguous chunks (spatial
    # locality keeps per-shard BVHs tight)
    cent = (v0 + v1 + v2) / 3.0
    lo = cent.min(0) if T else np.zeros(3, np.float32)
    hi = cent.max(0) if T else np.ones(3, np.float32)
    q = ((cent - lo) / np.maximum(hi - lo, 1e-30) * 1023).astype(np.int64)
    order = np.argsort(_morton_u32(np.clip(q, 0, 1023)), kind="stable")
    chunks = np.array_split(order, n_shards)

    per = []
    for ch in chunks:
        clo = np.minimum(np.minimum(v0[ch], v1[ch]), v2[ch])
        chi = np.maximum(np.maximum(v0[ch], v1[ch]), v2[ch])
        bvh = build_sah(clo, chi, settings, backend=backend)
        per.append((ch, bvh))

    Mmax = max(b.lower.shape[0] for _, b in per)
    Tmax = max(max(len(ch) for ch, _ in per),
               max(b.prim_order.shape[0] for _, b in per), 1)
    W = per[0][1].lower.shape[1]

    def padded(build_one):
        return np.stack([build_one(ch, b) for ch, b in per])

    def pad_nodes(a, fill, dtype):
        out = np.full((len(per), Mmax) + a(per[0][1]).shape[1:], fill, dtype)
        for i, (_, b) in enumerate(per):
            x = a(b)
            out[i, :x.shape[0]] = x
        return out

    def pad_tris(src, fill, dtype, trailing=()):
        out = np.full((len(per), Tmax) + trailing, fill, dtype)
        for i, (ch, b) in enumerate(per):
            x = src(ch, b)
            out[i, :x.shape[0]] = x
        return out

    del padded
    lower = pad_nodes(lambda b: b.lower, 0.0, np.float32)
    upper = pad_nodes(lambda b: b.upper, 0.0, np.float32)
    child = pad_nodes(lambda b: b.child, -1, np.int32)
    count = pad_nodes(lambda b: b.count, -1, np.int32)
    prim_order = pad_tris(lambda ch, b: b.prim_order.astype(np.int32),
                          0, np.int32)
    pv0 = pad_tris(lambda ch, b: v0[ch], 0.0, np.float32, (3,))
    pv1 = pad_tris(lambda ch, b: v1[ch], 0.0, np.float32, (3,))
    pv2 = pad_tris(lambda ch, b: v2[ch], 0.0, np.float32, (3,))
    pg = pad_tris(lambda ch, b: geom_id[ch], -1, np.int32)
    pp = pad_tris(lambda ch, b: prim_id[ch], -1, np.int32)
    pf = pad_tris(lambda ch, b: uv_flip[ch], 0, np.int32)
    gm = pad_tris(lambda ch, b: ch.astype(np.int32), 0, np.int32)

    assert W == per[0][1].lower.shape[1]
    return PrimShardedScene(
        jnp.asarray(lower), jnp.asarray(upper), jnp.asarray(child),
        jnp.asarray(count), jnp.asarray(prim_order),
        jnp.asarray(pv0), jnp.asarray(pv1), jnp.asarray(pv2),
        jnp.asarray(pg), jnp.asarray(pp), jnp.asarray(pf), jnp.asarray(gm))


def place_prim_sharded(ps: PrimShardedScene, mesh: Mesh,
                       axis: str = "sp") -> PrimShardedScene:
    """Put each scene shard on its ring device (leading axis sharded)."""
    sh = NamedSharding(mesh, P(axis))
    return jax.tree.map(lambda x: jax.device_put(x, sh), ps)


def _merge_hits(best: Hits, h: Hits, gmap: jnp.ndarray) -> Hits:
    """Keep the closer of the running best and this shard's hit; remap
    the shard-local gprim to the global prim index so the differentiable
    re-eval pass (diff/hit.py) keeps working unchanged."""
    better = h.valid & (h.t < best.t)
    hg = h._replace(gprim=jnp.where(h.valid, gmap[h.gprim], h.gprim))
    return jax.tree.map(
        lambda a, b: jnp.where(
            better.reshape(better.shape + (1,) * (a.ndim - better.ndim)),
            a, b),
        hg, best)


def make_prim_sharded_intersect(mesh: Mesh, axis: str = "sp",
                                packet_size: int = 1024):
    """Returns intersect(ps_scene, rays) -> Hits with rays AND scene both
    sharded on `axis`: D ring steps, each intersecting the resident shard
    and ppermute-rotating (rays, best hit) to the right neighbor."""
    from ..traverse.packet import intersect_chunked

    D = mesh.shape[axis]
    perm = [(i, (i + 1) % D) for i in range(D)]

    def local(ps: PrimShardedScene, org, d, tn, tf):
        # local block: leading shard axis is 1 on this device
        ps = jax.tree.map(lambda x: x[0], ps)
        bvh = BVH(ps.lower, ps.upper, ps.child, ps.count, ps.prim_order)
        tris = TrianglePrims(ps.v0, ps.v1, ps.v2, ps.geom_id, ps.prim_id,
                             ps.uv_flip)

        best = miss_hits(tn.shape, tf)

        def step(carry, _):
            org, d, tn, tf, best = carry
            rays = Rays(org, d, tn, jnp.minimum(tf, best.t))
            h = intersect_chunked(bvh, tris, rays, packet_size=packet_size)
            best = _merge_hits(best, h, ps.gmap)
            # rotate this ray block (with its best-so-far) one hop right
            org, d, tn, tf, best = jax.tree.map(
                lambda x: jax.lax.ppermute(x, axis, perm),
                (org, d, tn, tf, best))
            return (org, d, tn, tf, best), None

        (org, d, tn, tf, best), _ = jax.lax.scan(
            step, (org, d, tn, tf, best), None, length=D)
        # D hops of +1 on a ring of size D => every block is home again
        return best

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis), check_vma=False)


def prim_sharded_intersect(ps: PrimShardedScene, rays: Rays, mesh: Mesh,
                           axis: str = "sp",
                           packet_size: int = 1024) -> Hits:
    """Convenience wrapper: flat ray batch (already padded to a multiple
    of the axis size) against a placed PrimShardedScene."""
    f = make_prim_sharded_intersect(mesh, axis, packet_size)
    return f(ps, rays.org, rays.dir, rays.tnear, rays.tfar)
