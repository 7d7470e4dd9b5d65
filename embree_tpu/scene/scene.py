"""Scene: geometry container + commit orchestration.

Analog of reference kernels/common/scene.{h,cpp}. `Scene` is the mutable
host container (attach/detach, fork's subdivision/compression levels,
scene.h:231-232); `commit()` plays Scene::commit_task (scene.cpp:632):

  1. per-geometry preCommit (flatten buffers, subdiv tessellation)
  2. accel selection by config (createTriangleAccel scene.cpp:130,
     createSubdivAccel scene.cpp:491 incl. the fork's
     subdiv_accel="bvh4.compressed.{grid,leaf,box,full}" modes :507-510)
  3. build (SAH or morton by build quality)
  4. publish an immutable CommittedScene pytree whose intersect/occluded
     are jittable device functions (the Accel::Intersectors analog).

The reference builds one accel per geometry type and aggregates them with
AccelN (acceln.cpp:51 loops over accels); we do the same with at most two
accels: the flattened triangle/quad soup and the compressed-subdiv accel.
"""
from __future__ import annotations

import enum
import time
from typing import Callable, NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from ..build.bvh import BVH
from ..build.sah import BuildSettings, build_sah
from ..core.device import Device, Error
from ..core.math import matmul as _mm
from ..core.rayhit import Hits, Rays, miss_hits
from ..scene.geometry import (Geometry, Instance, QuadMesh, QuadMeshMB,
                              SubdivMesh, SubdivMeshMB, TriangleMesh,
                              TriangleMeshMB, UserGeometry)
from ..scene.curves import (BezierCurves, BezierCurvesMB, BSplineCurves,
                            LineSegments)
from ..scene.prims import TrianglePrims, empty_triangle_prims, prim_bounds_np
from ..traverse.gpu import pack_gpu_bvh, select_traversal, traverse
from ..traverse.packet import _finalize_hits, intersect_chunked, \
    occluded_chunked


class BuildQuality(enum.IntEnum):
    LOW = 0      # morton/LBVH
    MEDIUM = 1   # binned SAH (default)
    HIGH = 2     # binned SAH + pre-split duplication (spatial splits)
    REFIT = 3


class InstanceEntry(NamedTuple):
    """One committed instance (scene_instance analog)."""

    inst_id: jnp.ndarray       # scalar i32
    child: object              # CommittedScene
    local2world: jnp.ndarray   # (3, 4)
    world2local: jnp.ndarray   # (3, 4)
    # opened-entry world boxes for the two-level cull (open_merge
    # heuristic, build/twolevel.py); None when the child has no tris
    cull_lower: jnp.ndarray = None   # (E, 3)
    cull_upper: jnp.ndarray = None


import jax as _jax


@_jax.tree_util.register_pytree_node_class
class CommittedScene:
    """Immutable device-side scene (the Accel + leaf data).

    `gpu` holds the triangle accel in the CUDA kernel's layout
    (traverse/gpu.py; None off the GPU or without triangles); the XLA
    packet walk always works and is the autodiff reference.
    `instances` are nested committed scenes under transforms; `users`
    (STATIC aux: python callbacks) are user-geometry accels.
    """

    _CHILDREN = ("bvh", "tris", "gpu", "compressed",
                 "instances", "user_bvhs", "mb", "world_lower", "world_upper",
                 "prim_mask", "tri_patch_uv", "hair_bvhs", "mb_curves")

    def __init__(self, bvh, tris, gpu, compressed,
                 world_lower, world_upper, instances=(), user_bvhs=(),
                 users=(), mb=None, prim_mask=None, backface_cull=False,
                 tri_patch_uv=None, hair_bvhs=(), hairs=(), mb_curves=None):
        # (T,3,2) PATCH uv corners per flattened tri (only when the scene
        # has eager-subdiv geometry): hits report patch (u,v), the
        # GridSOA semantics (grid_soa_intersector1.h:60-117)
        self.tri_patch_uv = tri_patch_uv
        self.bvh = bvh
        self.tris = tris
        self.gpu = gpu                      # Optional[GpuBVH]
        self.compressed = compressed
        self.instances = tuple(instances)   # tuple[InstanceEntry]
        self.user_bvhs = tuple(user_bvhs)   # tuple[BVH] (one per user geom)
        self.users = tuple(users)           # STATIC: (geom_id, nprims, fn)
        self.mb = mb                        # Optional[MBAccel]
        self.world_lower = world_lower
        self.world_upper = world_upper
        self.prim_mask = prim_mask      # (T,) i32 per-prim geom mask or None
        self.backface_cull = backface_cull  # STATIC (EMBREE_BACKFACE_CULLING)
        # hair OBB accel (build/hair.py): per-cluster rotated BVHs
        # (pytree) + STATIC per-cluster intersector closures
        self.hair_bvhs = tuple(hair_bvhs)
        self.hairs = tuple(hairs)       # STATIC: (geom_id, cluster_fn)
        self.mb_curves = mb_curves      # Optional[MBCurves] (XLA fold)

    def _replace(self, **kw):
        d = {k: getattr(self, k) for k in self._CHILDREN}
        d["users"] = self.users
        d["backface_cull"] = self.backface_cull
        d["hairs"] = self.hairs
        d.update(kw)
        return CommittedScene(**d)

    def tree_flatten(self):
        return ([getattr(self, k) for k in self._CHILDREN],
                (self.users, self.backface_cull, self.hairs))

    @classmethod
    def tree_unflatten(cls, aux, children):
        users, cull, hairs = aux
        return cls(users=users, backface_cull=cull, hairs=hairs,
                   **dict(zip(cls._CHILDREN, children)))


def _as_np_f32(a):
    return np.asarray(a, np.float32)


_IDENT_UV3_ROW = np.asarray([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]], np.float32)


def _IDENT_UV3(n):
    """Identity patch-uv corners: the remap w0*c0 + u*c1 + v*c2 returns
    (u, v) unchanged for plain triangle/quad prims."""
    return np.broadcast_to(_IDENT_UV3_ROW, (n, 3, 2))


class Scene:
    def __init__(self, device: Device, quality: BuildQuality = BuildQuality.MEDIUM):
        self.device = device
        self.quality = quality
        self.geometries: dict[int, Geometry] = {}
        self._next_id = 0
        # fork extension rtcSetSceneLevels (rtcore_scene.h:64-65), defaults
        # from scene.cpp:41-42
        self.subdivision_level = 6
        self.compression_level = 3
        self.committed: Optional[CommittedScene] = None
        self.progress_monitor: Optional[Callable[[float], bool]] = None
        self.build_time_s: float = 0.0
        self.subdiv_eval = {}  # gid -> SubdivEval (compressed mode)
        self.subdiv_plan = {}  # gid -> SubdivisionPlan (attr interpolation)
        self._attr_cache = {}  # (gid, slot) -> refined attribute array
        self._patch_tables = {}  # gid -> (PatchTable, verts_iso)
        # intersection-filter callback (rtcSetGeometryIntersectFilterFunction
        # analog, scene-level): fn(org, dir, t, u, v, ng, geom, prim) -> keep
        self.intersection_filter = None

    # --- geometry management (scene.cpp:585-620 bind/detachGeometry) -------
    def attach(self, geom: Geometry) -> int:
        gid = self._next_id
        self._next_id += 1
        geom.geom_id = gid
        self.geometries[gid] = geom
        return gid

    def attach_by_id(self, geom: Geometry, gid: int) -> None:
        """rtcAttachGeometryByID analog."""
        if gid in self.geometries:
            self.device.raise_error(Error.INVALID_ARGUMENT, f"geomID {gid} in use")
        geom.geom_id = gid
        self.geometries[gid] = geom
        self._next_id = max(self._next_id, gid + 1)

    def detach(self, geom_id: int) -> None:
        if geom_id not in self.geometries:
            self.device.raise_error(Error.INVALID_ARGUMENT, "bad geomID")
        del self.geometries[geom_id]

    def _subdiv_mode(self):
        """createSubdivAccel mode select (scene.cpp:491-510): returns
        'grid' | 'leaf' | 'box' | 'full' for the fork's compressed modes,
        None for the stock eager path."""
        acc = self.device.state.subdiv_accel
        mapping = {
            "bvh4.compressed.grid": "grid",
            "bvh4.compressed.leaf": "leaf",
            "bvh4.compressed.box": "box",
            "bvh4.compressed.full": "full",
        }
        return mapping.get(acc)

    def set_levels(self, subdivision_level: int, compression_level: int) -> None:
        """Fork API rtcSetSceneLevels (rtcore.cpp:1469)."""
        self.subdivision_level = int(subdivision_level)
        self.compression_level = int(compression_level)

    # --- commit (scene.cpp:632 commit_task) --------------------------------
    def commit(self) -> CommittedScene:
        from ..core.profile import profile_phase, trace
        trace("rtcCommitScene", id(self))
        t0 = time.perf_counter()
        self._progress(0.0)

        tri_v0, tri_v1, tri_v2 = [], [], []
        tri_geom, tri_prim, tri_flip = [], [], []
        subdiv_compressed = []
        instances = []
        users = []
        user_bvhs = []
        mb_geoms = []
        mb_curve_geoms = []
        hair_bvhs = []
        hairs = []
        tri_uv3 = []          # (n,3,2) PATCH uv corners per tri (subdiv
        any_patch_uv = False  # eager path); identity barycentric otherwise

        for gid, g in sorted(self.geometries.items()):
            if not g.enabled:
                continue
            if isinstance(g, TriangleMesh):
                v = _as_np_f32(g.vertices)
                idx = g.indices
                tri_v0.append(v[idx[:, 0]])
                tri_v1.append(v[idx[:, 1]])
                tri_v2.append(v[idx[:, 2]])
                n = idx.shape[0]
                tri_geom.append(np.full(n, gid, np.int32))
                tri_prim.append(np.arange(n, dtype=np.int32))
                tri_flip.append(np.zeros(n, np.int32))
                tri_uv3.append(_IDENT_UV3(n))
            elif isinstance(g, QuadMesh):
                v = _as_np_f32(g.vertices)
                idx = g.indices
                n = idx.shape[0]
                # tri A = (v0, v1, v3), tri B = (v2, v3, v1)  (quadv.h)
                tri_v0.append(v[idx[:, 0]]); tri_v1.append(v[idx[:, 1]]); tri_v2.append(v[idx[:, 3]])
                tri_v0.append(v[idx[:, 2]]); tri_v1.append(v[idx[:, 3]]); tri_v2.append(v[idx[:, 1]])
                tri_geom.append(np.full(2 * n, gid, np.int32))
                tri_prim.append(np.concatenate([np.arange(n, dtype=np.int32)] * 2))
                tri_flip.append(np.concatenate([np.zeros(n, np.int32), np.ones(n, np.int32)]))
                tri_uv3.append(_IDENT_UV3(2 * n))
            elif isinstance(g, SubdivMesh):
                mode = self._subdiv_mode()
                if mode is not None:
                    subdiv_compressed.append((gid, g))
                else:
                    # stock path: eager uniform tessellation to triangles
                    # (the BVHNSubdivPatch1EagerBuilderSAH analog,
                    # bvh_builder_subdiv.cpp:48)
                    from ..subdiv.tessellate import (
                        tessellate_mesh_to_triangles,
                        tessellate_mesh_to_triangles_levels)
                    if g.edge_levels is not None:
                        # RTC_BUFFER_TYPE_LEVEL: per-edge rates with
                        # crack-free stitching (tessellation.h:77)
                        v0, v1, v2, prim, uv3 = \
                            tessellate_mesh_to_triangles_levels(
                                g, g.edge_levels,
                                max_level=self.subdivision_level,
                                with_uv=True)
                    else:
                        v0, v1, v2, prim, uv3 = \
                            tessellate_mesh_to_triangles(
                                g, self.subdivision_level, with_uv=True)
                    tri_v0.append(v0); tri_v1.append(v1); tri_v2.append(v2)
                    tri_geom.append(np.full(v0.shape[0], gid, np.int32))
                    tri_prim.append(prim.astype(np.int32))
                    tri_flip.append(np.zeros(v0.shape[0], np.int32))
                    tri_uv3.append(uv3)
                    any_patch_uv = True
            elif isinstance(g, (TriangleMeshMB, QuadMeshMB, SubdivMeshMB)):
                mb_geoms.append((gid, g))
            elif isinstance(g, BezierCurvesMB):
                mb_curve_geoms.append((gid, g))
            elif isinstance(g, Instance):
                child_cs = g.child_scene.committed
                if child_cs is None:
                    child_cs = g.child_scene.commit()
                l2w = np.asarray(g.transform, np.float32)
                lin = l2w[:, :3]
                inv = np.linalg.inv(lin)
                w2l = np.concatenate([inv, (-inv @ l2w[:, 3:])], axis=1)
                cull_lo = cull_hi = None
                host_bvh = getattr(g.child_scene, "_bvh_host", None)
                if (host_bvh is not None and host_bvh.lower.shape[0]
                        and (np.asarray(host_bvh.count)[0] >= 0).any()):
                    from ..build.twolevel import open_merge_entries
                    ent = open_merge_entries([(l2w,
                                               np.asarray(host_bvh.lower),
                                               np.asarray(host_bvh.upper),
                                               np.asarray(host_bvh.child),
                                               np.asarray(host_bvh.count))])
                    cull_lo = jnp.asarray(ent.lower)
                    cull_hi = jnp.asarray(ent.upper)
                instances.append(InstanceEntry(
                    inst_id=jnp.int32(gid),
                    child=child_cs,
                    local2world=jnp.asarray(l2w),
                    world2local=jnp.asarray(w2l.astype(np.float32)),
                    cull_lower=cull_lo, cull_upper=cull_hi))
            elif isinstance(g, UserGeometry):
                ids = np.arange(g.num_prims, dtype=np.int64)
                blo, bhi = g.bounds_fn(ids)
                ub = build_sah(np.asarray(blo, np.float32),
                               np.asarray(bhi, np.float32),
                               BuildSettings(),
                               backend=self.device.state.builder)
                user_bvhs.append(ub.to_device())
                users.append((gid, g.num_prims, g.intersect_fn, None))
            elif (isinstance(g, (BezierCurves, BSplineCurves))
                  and self.device.state.hair_accel in ("default", "obb",
                                                       "bvh4obb.bezier1v")):
                # first-class hair accel: strand-aligned OBB clusters
                # (bvh_builder_hair.cpp / bvh.h:971 UnalignedNode
                # re-design; build/hair.py) with direct cubic-curve
                # leaves — ribbon for FLAT curves, swept-cone for ROUND
                from ..build.hair import build_hair_clusters
                from ..traverse.hair import (make_ribbon_intersector,
                                             make_round_curve_intersector)
                cps, radii = g.to_bezier()
                clusters = build_hair_clusters(
                    cps, radii, builder=self.device.state.builder)
                K = max(2, int(g.tessellation_rate))
                make = (make_ribbon_intersector if g.flat
                        else make_round_curve_intersector)
                for cl in clusters:
                    rcps = cps[cl.members] @ cl.rot
                    rrad = radii[cl.members]
                    fn = make(rcps, rrad, cl.members, K=K)
                    hair_bvhs.append(cl.bvh)
                    hairs.append((gid, _make_cluster_fn(
                        cl.rot, fn, cl.members, int(cl.members.shape[0]),
                        gid)))
            elif isinstance(g, (LineSegments, BezierCurves, BSplineCurves)):
                # curves ride the callback-accel machinery over tessellated
                # round segments (scene/curves.py)
                from .curves import make_segment_intersector, segment_bounds
                p0, p1, prim, u0, du = g.to_segments()
                blo, bhi = segment_bounds(p0, p1)
                ub = build_sah(blo, bhi, BuildSettings(),
                               backend=self.device.state.builder)
                user_bvhs.append(ub.to_device())
                fn, prim_map = make_segment_intersector(p0, p1, prim, u0, du)
                users.append((gid, p0.shape[0], fn,
                              (lambda pm: (lambda p: jnp.asarray(pm)[
                                  jnp.maximum(p, 0)]))(prim_map)))
            else:
                raise NotImplementedError(type(g))

        if tri_v0:
            v0 = np.concatenate(tri_v0); v1 = np.concatenate(tri_v1)
            v2 = np.concatenate(tri_v2)
            geom = np.concatenate(tri_geom); prim = np.concatenate(tri_prim)
            flip = np.concatenate(tri_flip)
            # per-prim geometry mask via gid lookup (rtcSetGeometryMask)
            lut = np.full(max(self.geometries.keys(), default=0) + 1, -1,
                          np.int32)
            for _gid, _g in self.geometries.items():
                lut[_gid] = np.int32(getattr(_g, "mask", -1))
            prim_mask = jnp.asarray(lut[geom])
            tris = TrianglePrims(
                jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
                jnp.asarray(geom), jnp.asarray(prim), jnp.asarray(flip))
            lower, upper = prim_bounds_np(v0, v1, v2)
            tri_patch_uv = (jnp.asarray(np.concatenate(tri_uv3))
                            if any_patch_uv else None)
        else:
            tris = empty_triangle_prims()
            tri_patch_uv = None
            prim_mask = jnp.zeros((0,), jnp.int32)
            lower = np.zeros((0, 3), np.float32)
            upper = np.zeros((0, 3), np.float32)

        self._progress(0.3)
        # HIGH quality: bounded spatial-split duplication (rtcore_common's
        # RTC_BUILD_QUALITY_HIGH; budget = embree's 1.2 replication cap).
        # Node width from the tri_accel override string (BVH4Factory /
        # BVH8Factory analog): BVH4 by default, bvh8.* for BVH8. The CUDA
        # kernel is compiled for both widths.
        ta = self.device.state.tri_accel
        branching = 8 if ta.startswith("bvh8") else 4
        settings = BuildSettings(
            branching_factor=branching,
            spatial_factor=1.2 if self.quality == BuildQuality.HIGH else 1.0)
        with profile_phase("scene.build_sah"):
            # HIGH quality gets triangle vertices for exact spatial-split
            # clipping (heuristic_spatial_array splitPrimitive semantics)
            tv = ((v0, v1, v2) if (tri_v0 and
                                   self.quality == BuildQuality.HIGH)
                  else None)
            bvh_np = build_sah(lower, upper, settings,
                               backend=self.device.state.builder,
                               tri_verts=tv)
        self._progress(0.9)
        # host builder arrays retained for the parent scene's two-level
        # open-merge (build/twolevel.py)
        self._bvh_host = bvh_np
        with profile_phase("scene.upload"):
            bvh = bvh_np.to_device()

        # the triangle accel in the CUDA kernel's layout, packed from the
        # host builder arrays whenever the kernel can run (a GPU)
        gpu = None
        if lower.shape[0] and select_traversal() == "cuda":
            with profile_phase("scene.pack_gpu"):
                gpu = pack_gpu_bvh(bvh_np, v0, v1, v2)

        # compressed subdiv accel (fork modes, scene.cpp:507-510)
        compressed = None
        self.subdiv_eval = {}
        self.subdiv_plan = {}
        self._attr_cache = {}
        self._patch_tables = {}
        if subdiv_compressed:
            from .subdiv_accel import build_compressed_accel
            (compressed, self.subdiv_eval, self.subdiv_plan, clo,
             chi) = build_compressed_accel(
                subdiv_compressed, self.subdivision_level,
                self.compression_level, self._subdiv_mode(),
                flavor=self.device.state.compressed_node)
            if lower.shape[0]:
                lo_all = np.minimum(lower.min(0), clo)
                hi_all = np.maximum(upper.max(0), chi)
            else:
                lo_all, hi_all = clo, chi
        elif lower.shape[0]:
            lo_all, hi_all = lower.min(0), upper.max(0)
        else:
            lo_all = np.zeros(3, np.float32)
            hi_all = np.zeros(3, np.float32)

        wl = jnp.asarray(lo_all.astype(np.float32))
        wu = jnp.asarray(hi_all.astype(np.float32))

        # motion-blur accel (dual-timestep refit bounds; traverse/mb.py)
        mb = self._build_mb(mb_geoms) if mb_geoms else None
        mb_curves = (self._build_mb_curves(mb_curve_geoms)
                     if mb_curve_geoms else None)

        self.committed = CommittedScene(bvh=bvh, tris=tris, gpu=gpu,
                                        mb_curves=mb_curves,
                                        tri_patch_uv=tri_patch_uv,
                                        hair_bvhs=tuple(hair_bvhs),
                                        hairs=tuple(hairs),
                                        compressed=compressed,
                                        world_lower=wl, world_upper=wu,
                                        instances=tuple(instances),
                                        user_bvhs=tuple(user_bvhs),
                                        users=tuple(users), mb=mb,
                                        prim_mask=prim_mask,
                                        backface_cull=bool(
                                            self.device.state.backface_culling))
        self.build_time_s = time.perf_counter() - t0
        self._progress(1.0)
        if self.device.state.verbose >= 2:
            self.print_statistics()
            from ..core.profile import global_profiler
            global_profiler().print("  profile ")
        return self.committed

    def _mb_timestep_soups(self, g):
        """Per-timestep (v0, v1, v2, prim[, flip]) triangle soups of one
        MB geometry (triangle MB directly; quad MB splits each quad into
        the standard diagonal pair; subdiv MB tessellates every cage
        timestep through the shared plan)."""
        if isinstance(g, TriangleMeshMB):
            idx = g.indices
            return [(v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]],
                     np.arange(idx.shape[0], dtype=np.int32))
                    for v in g.vertex_timesteps]
        if isinstance(g, QuadMeshMB):
            q = g.indices
            Q = q.shape[0]
            prim = np.concatenate([np.arange(Q, dtype=np.int32)] * 2)
            flip = np.concatenate([np.zeros(Q, np.int32),
                                   np.ones(Q, np.int32)])
            out = []
            for v in g.vertex_timesteps:
                v0 = np.concatenate([v[q[:, 0]], v[q[:, 2]]])
                v1 = np.concatenate([v[q[:, 1]], v[q[:, 3]]])
                v2 = np.concatenate([v[q[:, 3]], v[q[:, 1]]])
                out.append((v0, v1, v2, prim, flip))
            return out
        # SubdivMeshMB: tessellate each timestep (same topology/plan)
        from ..subdiv.tessellate import tessellate_mesh_to_triangles

        class _View:
            pass

        out = []
        for v in g.vertex_timesteps:
            m = _View()
            m.vertices = v
            m.face_counts = g.face_counts
            m.face_indices = g.face_indices
            m.edge_creases = g.edge_creases
            m.edge_crease_weights = g.edge_crease_weights
            m.vertex_creases = g.vertex_creases
            m.vertex_crease_weights = g.vertex_crease_weights
            m.displacement = g.displacement
            v0, v1, v2, prim = tessellate_mesh_to_triangles(
                m, self.subdivision_level)
            out.append((v0, v1, v2, prim.astype(np.int32)))
        return out

    def _build_mb(self, mb_geoms):
        """Multi-segment MB accel (bvh_builder_msmblur.h analog): one
        SAH build over all-timestep union bounds, then a refit per
        timestep knot — exact linear bounds per uniform segment."""
        from ..build.refit import plan_refit, refit
        from ..traverse.mb import MBAccel

        # Common knot grid: LCM of per-geometry segment counts so every
        # geometry's own knots land exactly ON common knots (piecewise-
        # linear resampling is then exact — the msmblur builder keeps
        # per-geometry grids exact; ADVICE r2). Capped to keep the refit
        # count sane; beyond the cap the extra-knot motion is chorded
        # with a warning.
        import math
        seg_counts = [max(1, len(g.vertex_timesteps) - 1)
                      for _gid, g in mb_geoms]
        L = 1
        for c in seg_counts:
            L = L * c // math.gcd(L, c)
        if L + 1 > 65:
            if self.device.state.verbose >= 1:
                print(f"embree_tpu: MB knot LCM {L + 1} exceeds cap; "
                      f"non-aligned motion will be chorded")
            L = max(seg_counts)
        S = L + 1
        knots = np.linspace(0.0, 1.0, S)

        per_ts = [[] for _ in range(S)]   # [(v0,v1,v2)] per timestep
        geoms, prims, flips = [], [], []
        for gid, g in mb_geoms:
            soups = self._mb_timestep_soups(g)
            Sg = len(soups)
            prims.append(soups[0][3])
            flips.append(soups[0][4] if len(soups[0]) > 4
                         else np.zeros(soups[0][0].shape[0], np.int32))
            geoms.append(np.full(soups[0][0].shape[0], gid, np.int32))
            for s, tk in enumerate(knots):
                # resample this geometry's piecewise-linear motion at the
                # common knot (exact when knot grids align)
                x = tk * (Sg - 1)
                a = int(np.clip(np.floor(x), 0, Sg - 2))
                w = np.float32(x - a)
                tri = tuple((1 - w) * soups[a][k] + w * soups[a + 1][k]
                            for k in range(3))
                per_ts[s].append(tri)

        geom = np.concatenate(geoms)
        prim = np.concatenate(prims)
        flip = np.concatenate(flips)
        T = geom.shape[0]
        v0_ts = np.stack([np.concatenate([t[0] for t in ts])
                          for ts in per_ts])
        v1_ts = np.stack([np.concatenate([t[1] for t in ts])
                          for ts in per_ts])
        v2_ts = np.stack([np.concatenate([t[2] for t in ts])
                          for ts in per_ts])

        los, his = [], []
        for s in range(S):
            lo, hi = prim_bounds_np(v0_ts[s], v1_ts[s], v2_ts[s])
            los.append(lo)
            his.append(hi)

        def build_range(k0: int, k1: int):
            """Union-topology tree over knots [k0..k1] + ALL-knot refit
            bounds (out-of-range knots clamp to the range edge so
            batch-time unions stay conservative and tight). Returns
            host (BVHArraysNP topology, refit SAH per in-range knot,
            per-knot (lower, upper))."""
            lo_u = np.minimum.reduce(los[k0:k1 + 1])
            hi_u = np.maximum.reduce(his[k0:k1 + 1])
            bvh_np = build_sah(lo_u, hi_u, BuildSettings(),
                               backend=self.device.state.builder)
            bvh_u = bvh_np.to_device()
            sched = plan_refit(bvh_u)
            lows, ups, costs = [], [], []
            for s in range(S):
                sc = min(max(s, k0), k1)
                b = refit(bvh_u, sched, jnp.asarray(los[sc]),
                          jnp.asarray(his[sc]))
                lows.append(b.lower)
                ups.append(b.upper)
                if k0 <= s <= k1:
                    from ..build.bvh import sah_cost
                    costs.append(sah_cost(bvh_np._replace(
                        lower=np.asarray(b.lower),
                        upper=np.asarray(b.upper))))
            return bvh_np, lows, ups, costs

        # ---- temporal-split competition (bvh_builder_msmblur.h /
        # heuristic_timesplit_array.h semantics, batched):
        # recursively halve the TIME domain while per-range topologies
        # beat the union topology's worst refit knot by >25% ----
        def temporal_ranges(k0, k1, depth):
            bvh_np, lows, ups, costs = build_range(k0, k1)
            if depth == 0 or k1 - k0 < 2:
                return [(k0, k1, bvh_np, lows, ups)]
            worst = max(costs)
            km = (k0 + k1) // 2
            left = build_range(k0, km)
            right = build_range(km, k1)
            split_worst = max(max(left[3]), max(right[3]))
            if worst > 1.25 * split_worst:
                return (temporal_ranges(k0, km, depth - 1)
                        + temporal_ranges(km, k1, depth - 1))
            return [(k0, k1, bvh_np, lows, ups)]

        ranges = temporal_ranges(0, S - 1, depth=2) if S > 2 \
            else [(0, S - 1) + build_range(0, S - 1)[:3]]

        if len(ranges) == 1:
            k0, k1, bvh_np, lows, ups = ranges[0]
            bvh_u = bvh_np.to_device()
            bvh0 = bvh_u._replace(lower=lows[0], upper=ups[0])
            return MBAccel(bvh=bvh0,
                           lower_ts=jnp.stack(lows),
                           upper_ts=jnp.stack(ups),
                           v0_ts=jnp.asarray(v0_ts),
                           v1_ts=jnp.asarray(v1_ts),
                           v2_ts=jnp.asarray(v2_ts),
                           geom_id=jnp.asarray(geom),
                           prim_id=jnp.asarray(prim),
                           uv_flip=jnp.asarray(flip))
        # ---- merge K range subtrees under one MB4D root whose children
        # carry the time subranges (AlignedNodeMB4D, bvh.h:837) ----
        if self.device.state.verbose >= 1:
            print(f"embree_tpu: MB temporal splits -> "
                  f"{len(ranges)} time ranges "
                  f"{[(r[0], r[1]) for r in ranges]}")
        W = np.asarray(ranges[0][2].child).shape[1]
        assert len(ranges) <= W
        Ms = [np.asarray(r[2].child).shape[0] for r in ranges]
        ords = [np.asarray(r[2].prim_order) for r in ranges]
        ord_all = np.concatenate(ords)
        M_tot = 1 + sum(Ms)
        child = np.zeros((M_tot, W), np.int64)
        count = np.full((M_tot, W), -1, np.int64)
        tlo = np.zeros((M_tot, W), np.float32)
        thi = np.ones((M_tot, W), np.float32)
        lower_ts = np.zeros((S, M_tot, W, 3), np.float32)
        upper_ts = np.zeros((S, M_tot, W, 3), np.float32)
        node_base = 1
        prim_base = 0
        for ri, (k0, k1, b, lows, ups) in enumerate(ranges):
            ch = np.asarray(b.child).copy()
            cn = np.asarray(b.count)
            M = ch.shape[0]
            # offset node refs and leaf prim starts into the concat
            ch = np.where(cn == 0, ch + node_base,
                          np.where(cn > 0, ch + prim_base, ch))
            child[node_base:node_base + M] = ch
            count[node_base:node_base + M] = cn
            for s in range(S):
                lower_ts[s, node_base:node_base + M] = np.asarray(lows[s])
                upper_ts[s, node_base:node_base + M] = np.asarray(ups[s])
            # root child ri -> this subtree's root, gated to its range
            child[0, ri] = node_base
            count[0, ri] = 0
            tlo[0, ri] = k0 / (S - 1)
            thi[0, ri] = k1 / (S - 1)
            for s in range(S):
                rl = np.asarray(lows[s])[0]
                ru = np.asarray(ups[s])[0]
                vmask = np.asarray(b.count)[0] >= 0
                lower_ts[s, 0, ri] = rl[vmask].min(0)
                upper_ts[s, 0, ri] = ru[vmask].max(0)
            node_base += M
            prim_base += ords[ri].shape[0]
        from ..build.bvh import BVH
        bvh0 = BVH(lower=jnp.asarray(lower_ts[0]),
                   upper=jnp.asarray(upper_ts[0]),
                   child=jnp.asarray(child, jnp.int32),
                   count=jnp.asarray(count, jnp.int32),
                   prim_order=jnp.asarray(ord_all, jnp.int32))
        return MBAccel(bvh=bvh0,
                       lower_ts=jnp.asarray(lower_ts),
                       upper_ts=jnp.asarray(upper_ts),
                       v0_ts=jnp.asarray(v0_ts),
                       v1_ts=jnp.asarray(v1_ts),
                       v2_ts=jnp.asarray(v2_ts),
                       geom_id=jnp.asarray(geom),
                       prim_id=jnp.asarray(prim),
                       uv_flip=jnp.asarray(flip),
                       time_lo=jnp.asarray(tlo),
                       time_hi=jnp.asarray(thi))

    def _build_mb_curves(self, mb_curve_geoms):
        """MB curve accel (bvh_builder_msmblur_hair analog): common-knot
        resampled segment soups, union-topology SAH + per-knot refits,
        swept-cone leaves (traverse/mb.py MBCurves)."""
        import math

        from ..build.refit import plan_refit, refit
        from ..traverse.mb import MBCurves

        seg_counts = [max(1, len(g.vertex_timesteps) - 1)
                      for _gid, g in mb_curve_geoms]
        L = 1
        for c in seg_counts:
            L = L * c // math.gcd(L, c)
        if L + 1 > 65:
            L = max(seg_counts)
        S = L + 1
        knots = np.linspace(0.0, 1.0, S)

        per_ts = [[] for _ in range(S)]
        geoms, prims, u0s, dus = [], [], [], []
        for gid, g in mb_curve_geoms:
            soups = g.timestep_segments()
            Sg = len(soups)
            prims.append(soups[0][2])
            u0s.append(soups[0][3])
            dus.append(soups[0][4])
            geoms.append(np.full(soups[0][0].shape[0], gid, np.int32))
            for s, tk in enumerate(knots):
                x = tk * (Sg - 1)
                a = int(np.clip(np.floor(x), 0, Sg - 2))
                w = np.float32(x - a)
                per_ts[s].append(tuple(
                    (1 - w) * soups[a][k] + w * soups[a + 1][k]
                    for k in range(2)))

        geom = np.concatenate(geoms)
        prim = np.concatenate(prims)
        u0 = np.concatenate(u0s)
        du = np.concatenate(dus)
        p0_ts = np.stack([np.concatenate([t[0] for t in ts])
                          for ts in per_ts])          # (S, C, 4)
        p1_ts = np.stack([np.concatenate([t[1] for t in ts])
                          for ts in per_ts])

        from .curves import segment_bounds
        los, his = [], []
        lo_all = None
        hi_all = None
        for s in range(S):
            lo, hi = segment_bounds(p0_ts[s], p1_ts[s])
            los.append(lo)
            his.append(hi)
            lo_all = lo if lo_all is None else np.minimum(lo_all, lo)
            hi_all = hi if hi_all is None else np.maximum(hi_all, hi)
        bvh_np = build_sah(lo_all, hi_all, BuildSettings(),
                           backend=self.device.state.builder)
        bvh_u = bvh_np.to_device()
        sched = plan_refit(bvh_u)
        lows, ups = [], []
        for s in range(S):
            b = refit(bvh_u, sched, jnp.asarray(los[s]),
                      jnp.asarray(his[s]))
            lows.append(b.lower)
            ups.append(b.upper)
        return MBCurves(bvh=bvh_u._replace(lower=lows[0], upper=ups[0]),
                        lower_ts=jnp.stack(lows), upper_ts=jnp.stack(ups),
                        p0_ts=jnp.asarray(p0_ts), p1_ts=jnp.asarray(p1_ts),
                        geom_id=jnp.asarray(geom),
                        prim_id=jnp.asarray(prim),
                        u0=jnp.asarray(u0), du=jnp.asarray(du))

    def _progress(self, f: float) -> None:
        """Progress-monitor cancellation (scene.cpp:871-879)."""
        if self.progress_monitor is not None:
            if not self.progress_monitor(f):
                self.committed = None
                self.device.raise_error(Error.CANCELLED, "build cancelled")

    # --- queries ------------------------------------------------------------
    def _require_commit(self) -> CommittedScene:
        if self.committed is None:
            self.device.raise_error(Error.INVALID_OPERATION, "scene not committed")
        return self.committed

    def set_intersection_filter(self, fn) -> None:
        """Register the intersection-filter callback (filter.h). Filters
        force the XLA kernel variant — the same accel re-selection the
        reference performs (AccelN::select(filter), acceln.cpp:207)."""
        self.intersection_filter = fn

    def intersect(self, rays: Rays, time=None, coherent: bool = False,
                  mask=None) -> Hits:
        """rtcIntersect1/K/stream analog (batched over all rays). `time`
        in [0,1] samples motion-blur geometry (ray.time analog);
        `coherent` is the RTC_INTERSECT_CONTEXT_FLAG_COHERENT hint (skips
        the stream sort for primary-ray-like batches); `mask` is the
        per-ray i32 mask (ray.mask, EMBREE_RAY_MASK) tested against each
        geometry's rtcSetGeometryMask value. Masks apply to the
        triangle/quad accels (masked batches run the XLA kernel variant,
        like filters); user-geometry callbacks receive no mask."""
        cs = self._require_commit()
        return scene_intersect(cs, rays, isa=self.device.state.isa,
                               time=time,
                               filter_fn=self.intersection_filter,
                               coherent=coherent, ray_mask=mask)

    def occluded(self, rays: Rays, mask=None) -> jnp.ndarray:
        cs = self._require_commit()
        return scene_occluded(cs, rays, isa=self.device.state.isa,
                              ray_mask=mask)

    def interpolate(self, geom_id: int, prim_id, u, v, slot=None,
                    derivatives: bool = False):
        """rtcInterpolate analog: position + smooth normal at
        (prim, u, v) (rtcore.cpp interpolate path; smooth shading of
        compressed hits, viewer_device.cpp:284-295; vertex-attribute
        interpolation per interpolation_device.cpp).

        slot=None interpolates positions and returns (P, N); slot=k
        interpolates vertex_attributes[k] and returns the attribute
        value (for subdiv, smoothed through the same subdivision
        stencils the limit surface uses).

        derivatives=True returns the full rtcInterpolate derivative set
        (rtcore_geometry.h:234-338) as a dict {P, dPdu, dPdv, ddPdudu,
        ddPdvdv, ddPdudv, Ng}; for subdiv geometries these are ANALYTIC
        limit-surface derivatives (B-spline / feature-adaptive patches,
        subdiv/patches.py — bspline_patch.h:503, patch.h:51-78)."""
        from .geometry import QuadMesh, SubdivMesh, TriangleMesh
        g = self.geometries.get(geom_id)
        if derivatives:
            return self._interpolate_derivs(g, geom_id, prim_id, u, v)
        if isinstance(g, TriangleMesh):
            arr = jnp.asarray(g.vertices if slot is None
                              else g.vertex_attributes[slot], jnp.float32)
            idx = jnp.asarray(g.indices)[jnp.asarray(prim_id)]
            u = jnp.asarray(u, jnp.float32)[..., None]
            v = jnp.asarray(v, jnp.float32)[..., None]
            P = ((1.0 - u - v) * arr[idx[..., 0]] + u * arr[idx[..., 1]]
                 + v * arr[idx[..., 2]])
            if slot is not None:
                return P
            vtx = jnp.asarray(g.vertices, jnp.float32)
            ng = jnp.cross(vtx[idx[..., 1]] - vtx[idx[..., 0]],
                           vtx[idx[..., 2]] - vtx[idx[..., 0]])
            n = ng / jnp.maximum(jnp.linalg.norm(ng, axis=-1,
                                                 keepdims=True), 1e-20)
            return P, n
        if isinstance(g, QuadMesh):
            arr = jnp.asarray(g.vertices if slot is None
                              else g.vertex_attributes[slot], jnp.float32)
            idx = jnp.asarray(g.indices)[jnp.asarray(prim_id)]
            u = jnp.asarray(u, jnp.float32)[..., None]
            v = jnp.asarray(v, jnp.float32)[..., None]
            P = ((1 - u) * (1 - v) * arr[idx[..., 0]]
                 + u * (1 - v) * arr[idx[..., 1]]
                 + u * v * arr[idx[..., 2]]
                 + (1 - u) * v * arr[idx[..., 3]])
            if slot is not None:
                return P
            vtx = jnp.asarray(g.vertices, jnp.float32)
            ng = jnp.cross(vtx[idx[..., 1]] - vtx[idx[..., 0]],
                           vtx[idx[..., 3]] - vtx[idx[..., 0]])
            n = ng / jnp.maximum(jnp.linalg.norm(ng, axis=-1,
                                                 keepdims=True), 1e-20)
            return P, n
        if not isinstance(g, SubdivMesh):
            self.device.raise_error(Error.INVALID_ARGUMENT,
                                    f"geom {geom_id} not interpolatable")
        from .subdiv_accel import (build_subdiv_geometry, grid_sample,
                                   interpolate_subdiv)
        ev = self.subdiv_eval.get(geom_id)
        if ev is None:
            # stock (non-compressed) subdiv: build eval data lazily — the
            # rtcInterpolate eval-tree path the tessellation cache backs
            # in the reference
            plan, _vd, _vu, _grids, ev = build_subdiv_geometry(
                g, self.subdivision_level)
            self.subdiv_eval[geom_id] = ev
            self.subdiv_plan[geom_id] = plan
        if slot is None:
            return interpolate_subdiv(ev, prim_id, u, v)
        from ..subdiv.core import evaluate_plan
        key = (geom_id, slot)
        refined = self._attr_cache.get(key)
        if refined is None:
            refined = jnp.asarray(evaluate_plan(
                self.subdiv_plan[geom_id],
                np.asarray(g.vertex_attributes[slot], np.float32)))
            self._attr_cache[key] = refined
        return grid_sample(ev, prim_id, u, v, refined)

    def interpolate_normal(self, geom_id: int, prim_id, u, v):
        """Smooth-normal-only interpolate fast path (the viewer's
        per-frame need, viewer_device.cpp:284-295): samples a FUSED
        normal table (subdiv_accel.fused_normal_table) with one row
        gather per bilinear corner instead of interpolate()'s 16 1M-row
        gathers for (P, N). Falls back to interpolate() for
        non-subdiv geometry."""
        from .geometry import SubdivMesh
        from .subdiv_accel import (build_subdiv_geometry,
                                   fused_normal_table,
                                   sample_normal_fused)
        g = self.geometries.get(geom_id)
        if not isinstance(g, SubdivMesh):
            return self.interpolate(geom_id, prim_id, u, v)[1]
        ev = self.subdiv_eval.get(geom_id)
        if ev is None:
            plan, _vd, _vu, _grids, ev = build_subdiv_geometry(
                g, self.subdivision_level)
            self.subdiv_eval[geom_id] = ev
            self.subdiv_plan[geom_id] = plan
        key = ("nrm_fused", geom_id)
        table = self._attr_cache.get(key)
        if table is None:
            table = fused_normal_table(ev)
            self._attr_cache[key] = table
        return sample_normal_fused(table, ev, jnp.maximum(prim_id, 0),
                                   u, v)

    def _interpolate_derivs(self, g, geom_id, prim_id, u, v):
        """Full-derivative rtcInterpolate (rtcore_geometry.h:234-338)."""
        from .geometry import QuadMesh, SubdivMesh, TriangleMesh
        prim_id = jnp.asarray(prim_id)
        u = jnp.asarray(u, jnp.float32)
        v = jnp.asarray(v, jnp.float32)
        if isinstance(g, TriangleMesh):
            arr = jnp.asarray(g.vertices, jnp.float32)
            idx = jnp.asarray(g.indices)[prim_id]
            p0, p1, p2 = arr[idx[..., 0]], arr[idx[..., 1]], arr[idx[..., 2]]
            P = ((1.0 - u - v)[..., None] * p0 + u[..., None] * p1
                 + v[..., None] * p2)
            du = p1 - p0
            dv = p2 - p0
            z = jnp.zeros_like(P)
            ng = jnp.cross(du, dv)
            ng = ng / jnp.maximum(
                jnp.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
            return {"P": P, "dPdu": du, "dPdv": dv, "ddPdudu": z,
                    "ddPdvdv": z, "ddPdudv": z, "Ng": ng}
        if isinstance(g, QuadMesh):
            arr = jnp.asarray(g.vertices, jnp.float32)
            idx = jnp.asarray(g.indices)[prim_id]
            p0, p1, p2, p3 = (arr[idx[..., 0]], arr[idx[..., 1]],
                              arr[idx[..., 2]], arr[idx[..., 3]])
            uu = u[..., None]
            vv = v[..., None]
            P = ((1 - uu) * (1 - vv) * p0 + uu * (1 - vv) * p1
                 + uu * vv * p2 + (1 - uu) * vv * p3)
            du = (1 - vv) * (p1 - p0) + vv * (p2 - p3)
            dv = (1 - uu) * (p3 - p0) + uu * (p2 - p1)
            z = jnp.zeros_like(P)
            ng = jnp.cross(du, dv)
            ng = ng / jnp.maximum(
                jnp.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
            return {"P": P, "dPdu": du, "dPdv": dv, "ddPdudu": z,
                    "ddPdvdv": z, "ddPdudv": jnp.zeros_like(P), "Ng": ng}
        if not isinstance(g, SubdivMesh):
            self.device.raise_error(Error.INVALID_ARGUMENT,
                                    f"geom {geom_id} not interpolatable")
        pt, verts_iso = self._patch_table(g, geom_id)
        from ..subdiv.patches import eval_patch_table
        return eval_patch_table(pt, verts_iso, prim_id, u, v)

    def _patch_table(self, g, geom_id):
        """Lazily build (and cache) the analytic patch table + iso-level
        control vertices for a SubdivMesh."""
        ent = self._patch_tables.get(geom_id)
        if ent is None:
            from ..subdiv.patches import build_patch_table
            nv = int(np.asarray(g.vertices).shape[0])
            pt = build_patch_table(
                g.face_counts, g.face_indices, nv,
                edge_creases=g.edge_creases,
                edge_crease_weights=g.edge_crease_weights,
                vertex_creases=g.vertex_creases,
                vertex_crease_weights=g.vertex_crease_weights)
            from ..subdiv.core import evaluate_plan
            verts_iso = jnp.asarray(evaluate_plan(
                pt.plan, np.asarray(g.vertices, np.float32)))
            ent = (pt, verts_iso)
            self._patch_tables[geom_id] = ent
        return ent

    @property
    def bounds(self):
        cs = self._require_commit()
        return np.asarray(cs.world_lower), np.asarray(cs.world_upper)

    def print_statistics(self) -> None:
        """Scene::printStatistics (scene.cpp:77-129) analog."""
        cs = self._require_commit()
        from ..build.bvh import sah_cost
        print(f"embree_tpu scene: {len(self.geometries)} geometries, "
              f"{cs.tris.num_prims} flattened triangles, "
              f"{cs.bvh.num_nodes} BVH{cs.bvh.width} nodes, "
              f"build {self.build_time_s * 1e3:.1f} ms")


def _make_cluster_fn(rot, leaf_fn, members, n_members, gid):
    """Whole-cluster intersect closure: rotate the ray batch into the
    cluster frame (x @ R), walk the rotated-AABB BVH, rotate Ng back.
    rot/members are numpy constants."""
    rot_np = np.asarray(rot, np.float32)
    mem_np = np.asarray(members, np.int32)

    def cluster_fn(bvh, org, d, tn, t_in):
        from ..traverse.user import UserAccel, intersect_user
        Rm = jnp.asarray(rot_np)
        rrays = Rays(_mm(org, Rm), _mm(d, Rm), tn, t_in)
        t, u, v, ng, pc, hitm = intersect_user(
            UserAccel(bvh, gid, n_members), leaf_fn, rrays, t_in)
        ng = _mm(ng, Rm.T)
        prim = jnp.asarray(mem_np)[jnp.maximum(pc, 0)]
        prim = jnp.where(hitm, prim, -1)
        return t, u, v, ng, prim, hitm

    return cluster_fn


def _entry_cull(lower, upper, rays: Rays, tfar):
    """Any-hit slab test of the ray batch against an instance's opened
    entry boxes (build/twolevel.py): (batch,) bool reach mask."""
    from ..core.math import rcp_safe
    org = rays.org.reshape(-1, 3)
    d = rays.dir.reshape(-1, 3)
    tn = rays.tnear.reshape(-1)
    tf = tfar.reshape(-1)
    rd = rcp_safe(d)
    ord_ = org * rd
    t_lo = lower[None] * rd[:, None, :] - ord_[:, None, :]   # (R, E, 3)
    t_hi = upper[None] * rd[:, None, :] - ord_[:, None, :]
    tmin = jnp.max(jnp.minimum(t_lo, t_hi), axis=-1)
    tmax = jnp.min(jnp.maximum(t_lo, t_hi), axis=-1)
    tmin = jnp.maximum(tmin, tn[:, None])
    hit = (tmin <= tmax * 1.0000004) & (tmin <= tf[:, None])
    return jnp.any(hit, axis=1).reshape(rays.batch_shape)


def _select(use, new: Hits, old: Hits) -> Hits:
    """Per-ray pick of `new` where `use`: the AccelN min-combine step."""
    return _jax.tree.map(
        lambda a, b: jnp.where(
            use.reshape(use.shape + (1,) * (a.ndim - use.ndim)), a, b),
        new, old)


def _fold_hits(shape, gid, t, u, v, ng, prim, hitm, hits: Hits) -> Hits:
    """Fold one flat accel result (hair cluster, user geometry) into the
    running best where `hitm`."""
    new = Hits(t=t.reshape(shape), u=u.reshape(shape), v=v.reshape(shape),
               ng=ng.reshape(shape + (3,)), prim_id=prim.reshape(shape),
               geom_id=jnp.full(shape, gid, jnp.int32),
               gprim=jnp.full(shape, -1, jnp.int32),
               inst_id=jnp.full(shape, -1, jnp.int32))
    return _select(hitm.reshape(shape), new, hits)


def _apply_patch_uv(cs: "CommittedScene", h: Hits) -> Hits:
    """Remap triangle-barycentric (u, v) to PATCH uv for eager-subdiv
    prims (GridSOA hit semantics, grid_soa_intersector1.h:60-117):
    uv = w0*c0 + u*c1 + v*c2 with per-tri corner table; plain prims
    carry identity corners so the remap is the identity for them."""
    if cs.tri_patch_uv is None:
        return h
    gp = jnp.maximum(h.gprim, 0)
    c = cs.tri_patch_uv[gp]
    w0 = (1.0 - h.u - h.v)[..., None]
    uv = (c[..., 0, :] * w0 + c[..., 1, :] * h.u[..., None]
          + c[..., 2, :] * h.v[..., None])
    keep = h.gprim >= 0
    return h._replace(u=jnp.where(keep, uv[..., 0], h.u),
                      v=jnp.where(keep, uv[..., 1], h.v))


def _flat(rays: Rays) -> Rays:
    return Rays(rays.org.reshape(-1, 3), rays.dir.reshape(-1, 3),
                rays.tnear.reshape(-1), rays.tfar.reshape(-1))


def _flat_mask(ray_mask, shape):
    if ray_mask is None:
        return None
    return jnp.broadcast_to(jnp.asarray(ray_mask, jnp.int32),
                            shape).reshape(-1)


def _use_kernel(cs: CommittedScene, isa: str, ray_mask) -> bool:
    """The triangle accel runs the CUDA kernel where select_traversal
    picks it; calls with a ray mask stay on the XLA walk."""
    return (select_traversal(isa) == "cuda" and cs.gpu is not None
            and ray_mask is None)


def _intersect_filter_restart(cs: CommittedScene, rays: Rays, isa: str,
                              filter_fn, time) -> Hits:
    """Intersection filters on the kernel path.

    The reference calls the filter per candidate hit inside the leaf
    epilog (filter.h:51, intersector_epilog.h:32-160) and keeps
    traversing when it rejects. An arbitrary traceable filter cannot be
    called from inside the CUDA kernel, so filters run as a RESTART
    WAVEFRONT: run the (unfiltered) kernel for the closest hit, apply
    the filter to the whole batch as ordinary XLA ops, and re-traverse
    the rejected rays with tnear advanced past the rejected hit. Each
    round retires >=1 candidate per undecided ray, rays that accept or
    miss drop out, and every round runs the full-speed kernel — the
    filter itself vectorizes over the batch instead of running per hit.

    Hits are therefore delivered to the filter in increasing-t order
    per ray (a valid order under the reference's contract — it promises
    no order). One deviation: after a rejected hit at distance t, other
    primitives at EXACTLY the same t are skipped (measure-zero ties;
    the XLA chunked path keeps exact tie semantics). A forward-progress
    guard re-advances tnear by one ulp if rounding re-finds the same
    primitive, so the loop always terminates."""
    import jax

    shape = rays.batch_shape
    org = rays.org.reshape(-1, 3)
    d = rays.dir.reshape(-1, 3)
    tn = rays.tnear.reshape(-1)
    tf = rays.tfar.reshape(-1)
    R = tn.shape[0]
    tmv = time
    if time is not None and getattr(time, "ndim", 0) > 0:
        tmv = jnp.asarray(time).reshape(-1)

    best0 = miss_hits((R,), tf)
    state0 = (tn, jnp.zeros((R,), bool), best0,
              jnp.full((R,), -2, jnp.int32), jnp.full((R,), -np.inf),
              jnp.int32(0))

    def cond(st):
        return jnp.any(~st[1]) & (st[5] < (1 << 16))

    def body(st):
        tnear_cur, done, best, prev_prim, prev_t, rounds = st
        # decided rays re-traverse with tfar=-inf: the kernel rejects
        # them at the root, so late rounds only pay for the shrinking
        # undecided set
        tf_eff = jnp.where(done, -np.inf, tf)
        h = scene_intersect(cs, Rays(org, d, tnear_cur, tf_eff), isa=isa,
                            time=tmv)
        hitm = h.valid & ~done
        accept = jnp.broadcast_to(
            jnp.asarray(filter_fn(org, d, h.t, h.u, h.v, h.ng,
                                  h.geom_id, h.prim_id)), hitm.shape)
        same = hitm & (h.gprim == prev_prim) & (h.t <= prev_t)
        acc = hitm & accept & ~same
        rej = hitm & (~acc)
        best = _select(acc, h, best)
        done = done | acc | (~h.valid)
        # strictly monotone: past the rejected t, and past the previous
        # tnear if the same hit was re-found by rounding
        adv = jnp.nextafter(jnp.maximum(h.t, tnear_cur), np.inf)
        tnear_cur = jnp.where(rej, adv, tnear_cur)
        prev_prim = jnp.where(rej, h.gprim, prev_prim)
        prev_t = jnp.where(rej, h.t, prev_t)
        return (tnear_cur, done, best, prev_prim, prev_t, rounds + 1)

    out = jax.lax.while_loop(cond, body, state0)
    best = out[2]
    return jax.tree.map(lambda x: x.reshape(shape + x.shape[1:]), best)


def scene_intersect(cs: CommittedScene, rays: Rays, isa: str = "default",
                    time=None, filter_fn=None, coherent: bool = False,
                    ray_mask=None) -> Hits:
    """Functional entry: runs the triangle accel, then folds the
    compressed-subdiv, motion-blur, hair, user and instance accels on
    top, min-combining hits — the AccelN loop (acceln.cpp:51).
    `coherent` is the RTC_INTERSECT_CONTEXT_FLAG_COHERENT hint; the
    kernel treats every batch alike."""
    shape = rays.batch_shape
    kernel = _use_kernel(cs, isa, ray_mask)
    if filter_fn is not None and kernel:
        return _intersect_filter_restart(cs, rays, isa, filter_fn, time)
    flat = _flat(rays)
    if cs.tris.num_prims == 0:
        hits = miss_hits(shape, rays.tfar)
    else:
        if kernel:
            t, prim = traverse(cs.gpu, flat, cull=cs.backface_cull)
            h = _finalize_hits(cs.tris, flat, t, prim)
        else:
            h = intersect_chunked(cs.bvh, cs.tris, flat, filter_fn=filter_fn,
                                  prim_mask=cs.prim_mask,
                                  ray_mask=_flat_mask(ray_mask, shape),
                                  backface_cull=cs.backface_cull)
        hits = _jax.tree.map(lambda x: x.reshape(shape + x.shape[1:]),
                             _apply_patch_uv(cs, h))

    if cs.compressed is not None:
        from ..traverse.cbvh import compressed_hits, intersect_compressed
        st = intersect_compressed(cs.compressed, rays, t_in=hits.t)
        ch = compressed_hits(cs.compressed, rays, st)
        hits = _select((st.tile >= 0).reshape(shape), ch, hits)

    # motion-blur accel at the ray time (MB intersectors)
    if cs.mb is not None:
        from ..traverse.mb import intersect_mb
        tmv = 0.0 if time is None else time
        hmb = intersect_mb(cs.mb, Rays(rays.org, rays.dir, rays.tnear,
                                       hits.t), tmv)
        hits = _select(hmb.valid, hmb, hits)

    # MB curves (bvh_builder_msmblur_hair analog; XLA cone leaves)
    if cs.mb_curves is not None:
        from ..traverse.mb import intersect_mb_curves
        tmv = 0.0 if time is None else time
        fr = Rays(flat.org, flat.dir, flat.tnear, hits.t.reshape(-1))
        tc, uc, vc, ngc, pc, gc, hm = intersect_mb_curves(
            cs.mb_curves, fr, tmv)
        new = Hits(t=tc.reshape(shape), u=uc.reshape(shape),
                   v=vc.reshape(shape), ng=ngc.reshape(shape + (3,)),
                   prim_id=pc.reshape(shape), geom_id=gc.reshape(shape),
                   gprim=jnp.full(shape, -1, jnp.int32),
                   inst_id=jnp.full(shape, -1, jnp.int32))
        hits = _select(hm.reshape(shape), new, hits)

    # hair OBB clusters (bvh_builder_hair analog; build/hair.py)
    for (gid, cfn), bvh in zip(cs.hairs, cs.hair_bvhs):
        t, u, v, ng, prim, hitm = cfn(bvh, flat.org, flat.dir, flat.tnear,
                                      hits.t.reshape(-1))
        hitm = hitm & (t < hits.t.reshape(-1))
        hits = _fold_hits(shape, gid, t, u, v, ng, prim, hitm, hits)

    # user-geometry + curve accels (object_intersector / line_intersector)
    for i, (gid, nprims, fn, prim_map) in enumerate(cs.users):
        from ..traverse.user import UserAccel, intersect_user
        t, u, v, ng, prim, hitm = intersect_user(
            UserAccel(cs.user_bvhs[i], gid, nprims), fn, rays, hits.t)
        if prim_map is not None:
            prim = jnp.where(prim >= 0, prim_map(prim), prim)
        hits = _fold_hits(shape, gid, t, u, v, ng, prim, hitm, hits)

    # instances: transform rays into instance space, recurse, min-combine
    # (AccelN over TransformNodes; instance_intersector.{h,cpp})
    for inst in cs.instances:
        w2l = inst.world2local
        lorg = _mm(rays.org, w2l[:, :3].T) + w2l[:, 3]
        ldir = _mm(rays.dir, w2l[:, :3].T)
        tfar_in = hits.t
        if inst.cull_lower is not None:
            # two-level opened-entry cull (open_merge analog): rays
            # missing every opened box traverse the child as pads
            reach = _entry_cull(inst.cull_lower, inst.cull_upper, rays,
                                hits.t)
            tfar_in = jnp.where(reach, hits.t, -jnp.inf)
        h = scene_intersect(inst.child,
                            Rays(lorg, ldir, rays.tnear, tfar_in),
                            isa=isa)
        # normals transform by (L^-1)^T == w2l_lin^T (row form: ng @ w2l_lin)
        h = h._replace(ng=_mm(h.ng, w2l[:, :3]),
                       inst_id=jnp.broadcast_to(inst.inst_id, shape))
        hits = _select(h.valid & (h.t < hits.t), h, hits)
    return hits


def scene_occluded(cs: CommittedScene, rays: Rays, isa: str = "default",
                   coherent: bool = False, ray_mask=None) -> jnp.ndarray:
    shape = rays.batch_shape
    flat = _flat(rays)
    if cs.tris.num_prims == 0:
        occ = jnp.zeros(shape, bool)
    elif _use_kernel(cs, isa, ray_mask):
        _t, prim = traverse(cs.gpu, flat, occluded=True,
                            cull=cs.backface_cull)
        occ = (prim >= 0).reshape(shape)
    else:
        occ = occluded_chunked(cs.bvh, cs.tris, flat, prim_mask=cs.prim_mask,
                               ray_mask=_flat_mask(ray_mask, shape),
                               backface_cull=cs.backface_cull).reshape(shape)
    if cs.compressed is not None:
        from ..traverse.cbvh import occluded_compressed
        occ = occ | occluded_compressed(cs.compressed, rays)

    for (gid, cfn), hbvh in zip(cs.hairs, cs.hair_bvhs):
        hitm = cfn(hbvh, flat.org, flat.dir, flat.tnear, flat.tfar)[-1]
        occ = occ | hitm.reshape(shape)

    for i, (gid, nprims, fn, _pm) in enumerate(cs.users):
        from ..traverse.user import UserAccel, intersect_user
        _t, _u, _v, _ng, _p, hitm = intersect_user(
            UserAccel(cs.user_bvhs[i], gid, nprims), fn, rays,
            rays.tfar)
        occ = occ | hitm.reshape(shape)

    for inst in cs.instances:
        w2l = inst.world2local
        lorg = _mm(rays.org, w2l[:, :3].T) + w2l[:, 3]
        ldir = _mm(rays.dir, w2l[:, :3].T)
        occ = occ | scene_occluded(
            inst.child, Rays(lorg, ldir, rays.tnear,
                             jnp.where(occ, rays.tnear, rays.tfar)), isa=isa)
    return occ
