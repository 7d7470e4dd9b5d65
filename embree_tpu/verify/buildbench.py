"""buildbench: BVH build performance microbench.

Analog of tutorials/buildbench/buildbench_device.cpp: static create
(:265), dynamic create (:225), update/refit (:186) — plus this
framework's additions: device-side morton rebuild and jit'd refit. Prints greppable
BENCHMARK_BUILD_* keys (the reference's key-line convention).

Run: python -m embree_tpu.verify.buildbench [num_prims]
"""
from __future__ import annotations

import sys
import time

import numpy as np


def run(n_prims: int = 100_000, reps: int = 5) -> dict:
    import jax
    import jax.numpy as jnp

    from ..build.morton import build_morton
    from ..build.refit import plan_refit, refit
    from ..build.sah import BuildSettings, build_sah
    from ..scene.prims import prim_bounds_np
    from ..verify.fixtures import triangle_sphere

    n = max(int(np.sqrt(n_prims / 2)), 4)
    verts, idx = triangle_sphere((0, 0, 0), 1.0, n)
    v0, v1, v2 = verts[idx[:, 0]], verts[idx[:, 1]], verts[idx[:, 2]]
    lo, hi = prim_bounds_np(v0, v1, v2)
    P = lo.shape[0]
    out = {}

    # static create: native SAH
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        bvh = build_sah(lo, hi, BuildSettings(), backend="default")
        ts.append(time.perf_counter() - t0)
    out["BENCHMARK_BUILD_STATIC_SAH_MPRIMS_S"] = P / min(ts) / 1e6

    # HIGH quality: binned spatial splits (SBVH, exact triangle clip)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        build_sah(lo, hi, BuildSettings(spatial_factor=1.2),
                  backend="default", tri_verts=(v0, v1, v2))
        ts.append(time.perf_counter() - t0)
    out["BENCHMARK_BUILD_STATIC_SBVH_MPRIMS_S"] = P / min(ts) / 1e6

    # python frontier builder (reference point)
    if P <= 20000:
        t0 = time.perf_counter()
        build_sah(lo, hi, BuildSettings(), backend="python")
        out["BENCHMARK_BUILD_PY_SAH_MPRIMS_S"] = P / (time.perf_counter() - t0) / 1e6

    # dynamic create: device-side morton (jit'd; time steady-state)
    jlo, jhi = jnp.asarray(lo), jnp.asarray(hi)
    jax.block_until_ready(build_morton(jlo, jhi))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(build_morton(jlo, jhi))
        ts.append(time.perf_counter() - t0)
    out["BENCHMARK_BUILD_DYNAMIC_MORTON_MPRIMS_S"] = P / min(ts) / 1e6

    # update/refit
    dbvh = bvh.to_device()
    sched = plan_refit(dbvh)
    jax.block_until_ready(refit(dbvh, sched, jlo, jhi))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(refit(dbvh, sched, jlo * 1.01, jhi * 1.01))
        ts.append(time.perf_counter() - t0)
    out["BENCHMARK_BUILD_REFIT_MPRIMS_S"] = P / min(ts) / 1e6

    out["BENCHMARK_BUILD_NUM_PRIMS"] = P
    for k, v in out.items():
        print(f"{k} {v:.4g}")
    return out


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 100_000)
