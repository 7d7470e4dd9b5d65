"""Measure the bomberman.ecs demo frame (1280x768, compressed-leaf) on
the device; prints fps + Mray/s. Each frame ends in block_until_ready."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np


def main():
    import jax

    from embree_tpu.render.camera import Camera
    from embree_tpu.render.tutorials import viewer

    size = (int(sys.argv[1]), int(sys.argv[2])) if len(sys.argv) > 2 \
        else (1280, 768)
    obj = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "golden", "bomberman.obj")
    t0 = time.perf_counter()
    state = viewer.build_scene(obj, subdiv_mode="bvh4.compressed.leaf",
                               subdiv_level=6, comp_level=3)
    print(f"commit: {time.perf_counter()-t0:.1f}s", flush=True)
    cam = Camera(from_=(18.21240425, 20.05745888, 15.46878433),
                 to=(0, 0, 0), fov=90)
    t0 = time.perf_counter()
    img, nrays = viewer.render_frame(state, cam, size)
    jax.block_until_ready(img)
    print(f"first frame (compiles): {time.perf_counter()-t0:.1f}s "
          f"rays={nrays}", flush=True)
    # isolate the smooth-normals (interpolate) pass
    img, nrays = viewer.render_frame(state, cam, size, smooth_normals=False)
    jax.block_until_ready(img)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        img, nrays = viewer.render_frame(state, cam, size,
                                         smooth_normals=False)
        jax.block_until_ready(img)
    dt0 = (time.perf_counter() - t0) / reps
    print(f"no-smooth: {dt0*1e3:.1f} ms/frame = {1/dt0:.2f} fps", flush=True)
    t0 = time.perf_counter()
    for _ in range(reps):
        img, nrays = viewer.render_frame(state, cam, size)
        jax.block_until_ready(img)
    dt = (time.perf_counter() - t0) / reps
    print(f"full: {dt*1e3:.1f} ms/frame")
    print(f"BENCHMARK_RENDER_AVG {1.0/dt:.4f}")
    print(f"BENCHMARK_RENDER_MRAYPS_AVG {nrays/dt/1e6:.3f}")


main()
