"""Procedural scene creators for tests/benchmarks.

Analog of tutorials/common/scenegraph/geometry_creation.cpp
(createTriangleSphere / createQuadSphere / createTrianglePlane /
createSubdivSphere) used throughout the reference verify suite
(tutorials/verify/verify.cpp).
"""
from __future__ import annotations

import numpy as np


def triangle_sphere(center, radius: float, n: int):
    """Lat-long sphere: 2*n*n triangles (geometry_creation.cpp:createTriangleSphere)."""
    center = np.asarray(center, np.float32)
    theta = np.linspace(0.0, np.pi, n + 1)
    phi = np.linspace(0.0, 2.0 * np.pi, n + 1)[:-1]
    tt, pp = np.meshgrid(theta, phi, indexing="ij")  # (n+1, n)
    x = np.sin(tt) * np.cos(pp)
    y = np.cos(tt)
    z = np.sin(tt) * np.sin(pp)
    verts = np.stack([x, y, z], -1).reshape(-1, 3) * radius + center
    idx = np.arange((n + 1) * n).reshape(n + 1, n)

    tris = []
    for i in range(n):
        for j in range(n):
            j2 = (j + 1) % n
            a, b, c, d = idx[i, j], idx[i, j2], idx[i + 1, j], idx[i + 1, j2]
            if i > 0:
                tris.append([a, c, b])
            if i < n - 1:
                tris.append([b, c, d])
    return verts.astype(np.float32), np.asarray(tris, np.int32)


def quad_sphere(center, radius: float, n: int):
    center = np.asarray(center, np.float32)
    theta = np.linspace(0.0, np.pi, n + 1)
    phi = np.linspace(0.0, 2.0 * np.pi, n + 1)[:-1]
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    x = np.sin(tt) * np.cos(pp)
    y = np.cos(tt)
    z = np.sin(tt) * np.sin(pp)
    verts = np.stack([x, y, z], -1).reshape(-1, 3) * radius + center
    idx = np.arange((n + 1) * n).reshape(n + 1, n)
    quads = []
    for i in range(n):
        for j in range(n):
            j2 = (j + 1) % n
            quads.append([idx[i, j], idx[i + 1, j], idx[i + 1, j2], idx[i, j2]])
    return verts.astype(np.float32), np.asarray(quads, np.int32)


def triangle_plane(p0, dx, dy, n: int):
    """Regular grid plane with 2*n*n triangles (createTrianglePlane)."""
    p0 = np.asarray(p0, np.float32)
    dx = np.asarray(dx, np.float32)
    dy = np.asarray(dy, np.float32)
    u = np.linspace(0, 1, n + 1)
    v = np.linspace(0, 1, n + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    verts = p0 + uu[..., None] * dx + vv[..., None] * dy
    verts = verts.reshape(-1, 3).astype(np.float32)
    idx = np.arange((n + 1) * (n + 1)).reshape(n + 1, n + 1)
    tris = []
    for i in range(n):
        for j in range(n):
            a, b, c, d = idx[i, j], idx[i, j + 1], idx[i + 1, j], idx[i + 1, j + 1]
            tris.append([a, b, c])
            tris.append([b, d, c])
    return verts, np.asarray(tris, np.int32)


def random_triangles(rng: np.random.Generator, n: int, extent: float = 10.0,
                     size: float = 0.5):
    """Random triangle soup for stress/overlap tests (verify.cpp:1093)."""
    base = rng.uniform(-extent, extent, (n, 1, 3)).astype(np.float32)
    offs = rng.uniform(-size, size, (n, 3, 3)).astype(np.float32)
    tri = base + offs
    verts = tri.reshape(-1, 3)
    idx = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    return verts, idx


def subdiv_cube():
    """8-vertex cube as a 6-quad subdiv control mesh."""
    verts = np.array([
        [-1, -1, -1], [+1, -1, -1], [+1, -1, +1], [-1, -1, +1],
        [-1, +1, -1], [+1, +1, -1], [+1, +1, +1], [-1, +1, +1]], np.float32)
    faces = np.array([
        [0, 1, 2, 3], [4, 7, 6, 5], [0, 4, 5, 1],
        [1, 5, 6, 2], [2, 6, 7, 3], [3, 7, 4, 0]], np.int32)
    counts = np.full(6, 4, np.int32)
    return verts, counts, faces.reshape(-1)


def bruteforce_closest(v0, v1, v2, org, d, eps: float = 1e-9):
    """Float64 all-pairs closest hit, independent of every BVH and of the
    float32 Moeller-Trumbore test: (t, prim) per ray, prim = -1 on a miss.
    Rays within `eps` (barycentric) of an edge count as hits."""
    v0, v1, v2 = (np.asarray(a, np.float64) for a in (v0, v1, v2))
    e1 = v1 - v0
    e2 = v2 - v0
    ng = np.cross(e1, e2)
    d00 = np.einsum("ij,ij->i", e1, e1)
    d01 = np.einsum("ij,ij->i", e1, e2)
    d11 = np.einsum("ij,ij->i", e2, e2)
    det = d00 * d11 - d01 * d01
    ts = np.full(len(org), np.inf)
    prims = np.full(len(org), -1, np.int64)
    with np.errstate(divide="ignore", invalid="ignore"):
        for r, (o, dd) in enumerate(zip(np.asarray(org, np.float64),
                                        np.asarray(d, np.float64))):
            t = np.einsum("ij,ij->i", ng, v0 - o) / (ng @ dd)
            w = o + t[:, None] * dd - v0
            d20 = np.einsum("ij,ij->i", w, e1)
            d21 = np.einsum("ij,ij->i", w, e2)
            u = (d11 * d20 - d01 * d21) / det
            v = (d00 * d21 - d01 * d20) / det
            ok = ((t > 0) & (u >= -eps) & (v >= -eps)
                  & (u + v <= 1 + eps) & np.isfinite(t))
            if ok.any():
                k = int(np.argmin(np.where(ok, t, np.inf)))
                ts[r], prims[r] = t[k], k
    return ts, prims
