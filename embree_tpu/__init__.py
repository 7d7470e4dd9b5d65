"""embree_tpu — a differentiable ray-tracing framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
reference CPU library (Embree 3.0.0 fork `lispbub/embree-compressed`,
the HPG compressed-subdivision-surface paper): SAH BVH build, compressed
quantized per-patch BVHs for displaced Catmull-Clark subdivision surfaces,
wide-BVH packet traversal, watertight triangle / subdiv-patch
intersection, a differentiable shading pass, and multi-chip ray/tile
sharding over a jax device mesh.

Quick start::

    import embree_tpu as et
    dev = et.Device("verbose=1")
    scene = et.Scene(dev)
    scene.attach(et.TriangleMesh(vertices, indices))
    scene.commit()
    hits = scene.intersect(et.make_rays(org, dir))
"""
from .core.config import State
from .core.device import Device, Error, RaytracerError
from .core.rayhit import Hits, INVALID_ID, Rays, make_rays, miss_hits
from .scene.curves import (BezierCurves, BezierCurvesMB,
                           BSplineCurves, LineSegments)
from .scene.geometry import (Geometry, Instance, QuadMesh, QuadMeshMB,
                             SubdivMesh,
                             SubdivMeshMB, TriangleMesh, TriangleMeshMB,
                             UserGeometry)
from .scene.scene import (BuildQuality, CommittedScene, Scene, scene_intersect,
                          scene_occluded)

__version__ = "0.1.0"

__all__ = [
    "State", "Device", "Error", "RaytracerError",
    "Rays", "Hits", "make_rays", "miss_hits", "INVALID_ID",
    "Geometry", "TriangleMesh", "QuadMesh", "SubdivMesh", "Instance",
    "UserGeometry", "LineSegments", "BezierCurves", "BSplineCurves",
    "TriangleMeshMB", "SubdivMeshMB", "QuadMeshMB", "BezierCurvesMB",
    "Scene", "BuildQuality", "CommittedScene",
    "scene_intersect", "scene_occluded",
]
