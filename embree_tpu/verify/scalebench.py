"""scalebench: multi-device scaling measurement.

Measures rays/s of the sharded DP intersect (dist/sharding.py) at 1, 2,
4, ... N of the devices JAX finds and reports scaling efficiency — the
BASELINE.md ">=85% scaling efficiency at N hosts" harness. It runs on
whatever devices are present and refuses to run with fewer than two.
On the virtual CPU mesh (JAX_PLATFORMS=cpu +
xla_force_host_platform_device_count) it validates the sharding program
only: virtual devices share one CPU, so those numbers are not scaling.

Run: python -m embree_tpu.verify.scalebench
"""
from __future__ import annotations

import sys
import time

import numpy as np


def run(n_rays: int = 262144, reps: int = 5) -> dict:
    import jax

    if len(jax.devices()) < 2:
        raise SystemExit(f"scalebench needs >= 2 devices; JAX found "
                         f"{len(jax.devices())} ({jax.default_backend()})")
    import embree_tpu as et
    from embree_tpu.dist.sharding import make_mesh, shard_rays, sharded_intersect
    from embree_tpu.verify.fixtures import triangle_sphere

    rng = np.random.default_rng(7)
    verts, idx = triangle_sphere((0, 0, 0), 1.0, 40)
    dev = et.Device("ignore_config_files=1")
    scene = et.Scene(dev)
    scene.attach(et.TriangleMesh(verts, idx))
    cs = scene.commit()

    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org = rng.uniform(-3, 3, (n_rays, 3)).astype(np.float32)
    rays = et.make_rays(org, d)

    ndev = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= ndev]
    out = {}
    base = None
    for n in sizes:
        mesh = make_mesh(n)
        srays, _r = shard_rays(rays, mesh)
        f = jax.jit(lambda r, m=mesh: sharded_intersect(cs, r, m).t)
        jax.block_until_ready(f(srays))
        t0 = time.perf_counter()
        for _ in range(reps):
            jax.block_until_ready(f(srays))
        dt = (time.perf_counter() - t0) / reps
        mrayps = n_rays / dt / 1e6
        if base is None:
            base = mrayps
        eff = mrayps / (base * n)
        out[f"BENCHMARK_SCALE_{n}DEV_MRAYPS"] = mrayps
        out[f"BENCHMARK_SCALE_{n}DEV_EFF"] = eff
    for k, v in out.items():
        print(f"{k} {v:.4g}")
    return out


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 262144)
