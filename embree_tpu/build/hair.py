"""Hair acceleration: strand-aligned OBB clusters over Bezier curves.

The reference builds hair BVHs with UNALIGNED (OBB) nodes binned along
strand directions (bvh_builder_hair.cpp, bvh.h:971 UnalignedNode,
heuristic_binning_array_unaligned.h): axis-aligned boxes around diagonal
hair strands are mostly empty, so OBBs cut traversal work several-fold.

Batched re-design: instead of a per-node affine space (a per-pop 3x3
transform — hostile to the batched node test), curves are CLUSTERED by
strand direction over a fixed set of 13 canonical orientations (axes +
face diagonals + body diagonals, sign-collapsed). Each cluster gets one
rigid frame R aligning its canonical direction to +z; member curves'
bounds are computed IN THE ROTATED FRAME and a standard SAH BVH is
built over them (build/sah.py — the whole existing builder stack is
reused). Traversal rotates the ray batch once per cluster and walks a
plain AABB BVH — one 3x3 transform per (ray, cluster) instead of per
(ray, node), the batch-friendly expression of the same geometric idea.
Leaves evaluate the cubic curve directly (traverse/hair.py: flat RIBBON
facing the ray — bezier_ribbon intersector semantics — or swept-cone
ROUND segments).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .sah import BuildSettings, build_sah

# 13 canonical strand orientations (sign-collapsed)
_DIRS = np.array([
    [1, 0, 0], [0, 1, 0], [0, 0, 1],
    [1, 1, 0], [1, -1, 0], [1, 0, 1], [1, 0, -1],
    [0, 1, 1], [0, 1, -1],
    [1, 1, 1], [1, -1, 1], [1, 1, -1], [-1, 1, 1],
], np.float32)
_DIRS /= np.linalg.norm(_DIRS, axis=1, keepdims=True)


def _frame_for(z: np.ndarray) -> np.ndarray:
    """Orthonormal frame with third column = z (columns are axes; apply
    with x @ R to rotate into the frame)."""
    a = np.array([1.0, 0, 0], np.float32)
    if abs(z[0]) > 0.9:
        a = np.array([0, 1.0, 0], np.float32)
    x = np.cross(a, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1).astype(np.float32)


class HairCluster(NamedTuple):
    """One strand-aligned cluster: rotation + SAH BVH in rotated space.

    Static members (numpy; captured into intersector closures): member
    curve ids. `bvh` is the device pytree handed to intersect_user."""

    rot: np.ndarray        # (3, 3) world -> cluster frame (x @ rot)
    bvh: object            # device BVH over rotated curve bounds
    members: np.ndarray    # (M,) indices into the curve arrays


def build_hair_clusters(cps: np.ndarray, radii: np.ndarray,
                        builder: str = "auto") -> list:
    """cps: (S, 4, 3) cubic Bezier control points; radii: (S, 4).

    Returns [HairCluster] (empty clusters skipped). Strand direction =
    p3 - p0 (the chord embree's unaligned binning uses per strand)."""
    S = cps.shape[0]
    d = cps[:, 3] - cps[:, 0]
    n = np.linalg.norm(d, axis=1, keepdims=True)
    d = d / np.maximum(n, 1e-20)
    # assign to the canonical orientation with max |dot|
    sim = np.abs(d @ _DIRS.T)                      # (S, 13)
    cluster = np.argmax(sim, axis=1)
    cluster[np.squeeze(n, -1) < 1e-12] = 0         # degenerate strands

    out = []
    for k in range(_DIRS.shape[0]):
        members = np.nonzero(cluster == k)[0]
        if members.size == 0:
            continue
        R = _frame_for(_DIRS[k])
        cr = cps[members] @ R                      # (M, 4, 3) rotated cps
        rmax = radii[members].max(axis=1, keepdims=True)  # (M, 1)
        lo = cr.min(axis=1) - rmax                 # cp hull bounds curve
        hi = cr.max(axis=1) + rmax
        bvh = build_sah(lo.astype(np.float32), hi.astype(np.float32),
                        BuildSettings(), backend=builder).to_device()
        out.append(HairCluster(rot=R, bvh=bvh,
                               members=members.astype(np.int32)))
    return out


def bezier_from_bspline(cps4: np.ndarray) -> np.ndarray:
    """Uniform cubic B-spline span -> Bezier control points
    (bspline_curve.h basis conversion)."""
    m = np.array([[1, 4, 1, 0],
                  [0, 4, 2, 0],
                  [0, 2, 4, 0],
                  [0, 1, 4, 1]], np.float32) / 6.0
    return np.einsum("ij,sjk->sik", m, cps4)
