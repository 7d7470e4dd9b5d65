"""Driver benchmark: prints ONE JSON line.

Metric: incoherent-ray forward+backward throughput (Mray/s) at
REFERENCE BENCHMARK SCALE — a ~1M-triangle scene (the reference's
incoherent benchmarks use 1M-prim scenes, verify.cpp:4473-4560) with 2M
random rays, fwd+bwd: forward through scene_intersect (the CUDA
traversal kernel on a GPU, traverse/gpu.py), backward = jax.grad of the
loss through the differentiable hit re-evaluation (pixel -> vertex
gradients; hit selection under the traversal's zero-grad custom_vjp).
The whole fwd+bwd step is ONE jitted program — no host round trips.

Baseline: 3.284 Mray/s — measured from the reference's own binaries
(.refbuild/build-avx2/verify, AVX2, all cores of its 2-vCPU host, the
exact IncoherentRaysBenchmark shape: verify.cpp:4473-4560; see
BASELINE.md "MEASURED reference performance"). vs_baseline = value /
3.284; note the reference figure is fwd-only while ours is fwd+bwd.
"""
import json
import os
import sys
import time

import numpy as np

SCENE_RES = 707       # triangle_sphere(707) = 998,284 triangles
# 2M incoherent rays per dispatch: same scene/ray distribution as the
# reference's 1M-ray benchmark shape, doubled for device occupancy.
# BENCH_LOG2_RAYS=20 reproduces the 1M-ray shape.
N_RAYS = 1 << int(os.environ.get("BENCH_LOG2_RAYS", "21"))
SEED = 0xBE7C4


def headline_rays(n: int, seed: int = SEED):
    """(org, dir) numpy arrays: directions uniform on the sphere, origins
    uniform in [-3, 3]^3 around the radius-2 scene sphere."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    return org, d


def loss_fn(vertices, c, r, tri_idx):
    """The headline loss: sum of hit distances. BVH structure + hit
    selection stay stop-gradient; the loss surface is the FUSED
    t-gradient (diff/hit.py hit_t_grad): the primal is the traversal
    kernel's own t and the VJP gathers the winning corners and applies
    the analytic dt/dcorner formulas."""
    import jax
    import jax.numpy as jnp

    from embree_tpu.diff.hit import hit_t_grad
    from embree_tpu.scene.scene import scene_intersect

    sel = jax.lax.stop_gradient(scene_intersect(c, r))
    t = hit_t_grad(vertices, tri_idx, r, sel.gprim, sel.valid, sel.t,
                   tris=c.tris)
    return jnp.sum(jnp.where(sel.valid, t, 0.0))


def main() -> int:
    import jax
    import jax.numpy as jnp

    import embree_tpu as et
    from embree_tpu.core.device import use_compile_cache
    from embree_tpu.verify.fixtures import triangle_sphere

    use_compile_cache()
    verts, idx = triangle_sphere((0.0, 0.0, 0.0), 2.0, SCENE_RES)
    dev = et.Device("ignore_config_files=1")
    scene = et.Scene(dev)
    scene.attach(et.TriangleMesh(verts, idx))
    cs = scene.commit()

    n = N_RAYS
    rays = et.make_rays(*headline_rays(n))
    idxd = jnp.asarray(idx)

    f = jax.jit(jax.value_and_grad(loss_fn))
    vparam = jnp.asarray(verts)

    v0, _g = jax.block_until_ready(f(vparam, cs, rays, idxd))  # compile
    assert np.isfinite(float(v0))
    reps = 8
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(f(vparam, cs, rays, idxd))
    dt = time.perf_counter() - t0
    mrayps = reps * n / dt / 1e6

    baseline = 3.284   # measured: reference AVX2 all-core, 2-vCPU host
    print(json.dumps({
        "metric": "incoherent_fwdbwd_mrayps_1Mprims",
        "value": round(mrayps, 3),
        "unit": "Mray/s",
        "vs_baseline": round(mrayps / baseline, 3),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
