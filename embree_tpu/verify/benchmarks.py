"""Traversal benchmark matrix (verify.cpp "benchmarks" group analog,
:4473-4560): {coherent, incoherent} x {triangles, quads} million-prim
scenes x {intersect, occluded}, reported as greppable keys.

Run: python -m embree_tpu.verify.benchmarks [num_prims]
"""
from __future__ import annotations

import sys
import time

import numpy as np


def _coherent_rays(n, rng):
    """Camera-style ray bundle (CoherentRaysBenchmark)."""
    side = int(np.sqrt(n))
    xs = np.linspace(-0.45, 0.45, side, dtype=np.float32)
    x, y = np.meshgrid(xs, xs)
    d = np.stack([x, y, -np.ones_like(x)], -1).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org = np.tile(np.array([0, 0, 5.0], np.float32), (d.shape[0], 1))
    return org, d


def _incoherent_rays(n, rng):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    return org, d


def run(n_prims: int = 1_000_000, n_rays: int = 65536, reps: int = 8) -> dict:
    import jax

    import embree_tpu as et
    from embree_tpu.verify.fixtures import quad_sphere, triangle_sphere

    rng = np.random.default_rng(11)
    out = {}

    scenes = {}
    n = max(int(np.sqrt(n_prims / 2)), 8)
    scenes["tri"] = triangle_sphere((0, 0, 0), 2.0, n)
    nq = max(int(np.sqrt(n_prims / 2)), 8)
    qv, qi = quad_sphere((0, 0, 0), 2.0, nq // 2)
    scenes["quad"] = (qv, qi)

    for name, (verts, idx) in scenes.items():
        dev = et.Device("ignore_config_files=1")
        s = et.Scene(dev)
        if name == "quad":
            s.attach(et.QuadMesh(verts, idx))
        else:
            s.attach(et.TriangleMesh(verts, idx))
        t0 = time.perf_counter()
        cs = s.commit()
        out[f"BENCHMARK_BUILD_{name.upper()}_MPRIMS_S"] = \
            idx.shape[0] / (time.perf_counter() - t0) / 1e6

        _trav_rows(out, et, jax, cs, name, n_rays, rng, reps)

    # tri_mb row (verify.cpp benchmark matrix includes *_mb scenes)
    verts, idx = scenes["tri"]
    dev = et.Device("ignore_config_files=1")
    s = et.Scene(dev)
    s.attach(et.TriangleMeshMB(verts, verts + np.float32([0.1, 0, 0]), idx))
    t0 = time.perf_counter()
    cs = s.commit()
    out["BENCHMARK_BUILD_TRI_MB_MPRIMS_S"] = \
        idx.shape[0] / (time.perf_counter() - t0) / 1e6
    _trav_rows(out, et, jax, cs, "tri_mb", n_rays, rng, reps)

    # subdiv row (compressed-leaf mode, the fork's accel)
    from embree_tpu.verify.fixtures import subdiv_cube
    sv, sfc, sfi = subdiv_cube()
    dev = et.Device(
        "ignore_config_files=1,subdiv_accel=bvh4.compressed.leaf")
    s = et.Scene(dev)
    s.attach(et.SubdivMesh(sv, sfc, sfi))
    s.set_levels(5, 3)
    t0 = time.perf_counter()
    cs = s.commit()
    out["BENCHMARK_BUILD_SUBDIV_MPRIMS_S"] = \
        len(sfc) / (time.perf_counter() - t0) / 1e6
    _trav_rows(out, et, jax, cs, "subdiv", n_rays, rng, reps)

    for k, v in out.items():
        print(f"{k} {v:.4g}")
    return out


def _trav_rows(out, et, jax, cs, name, n_rays, rng, reps):
    for mode, raygen in (("coherent", _coherent_rays),
                         ("incoherent", _incoherent_rays)):
        org, d = raygen(n_rays, rng)
        rays = et.make_rays(org, d)
        for q, fn in (("intersect",
                       lambda: et.scene_intersect(cs, rays).t),
                      ("occluded",
                       lambda: et.scene_occluded(cs, rays))):
            jax.block_until_ready(fn())
            t0 = time.perf_counter()
            outs = [fn() for _ in range(reps)]
            jax.block_until_ready(outs)
            dt = time.perf_counter() - t0
            key = (f"BENCHMARK_TRAV_{name.upper()}_{mode.upper()}"
                   f"_{q.upper()}_MRAYPS")
            out[key] = reps * len(org) / dt / 1e6


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000)
