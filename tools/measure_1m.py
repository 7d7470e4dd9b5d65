"""Bring-up measurements on one GPU at the headline shape: bench.py's
998,284-triangle sphere and 2^21 incoherent rays.

  * commit and compile time;
  * the CUDA kernel against the XLA walk, per ray (the XLA walk on a
    2^16-ray slice of the same batch; the kernel on the slice and on
    the full batch), both through scene_intersect;
  * forward-only and forward+backward Mray/s.

Every time is the median of --reps runs after a warm-up, each ended by
block_until_ready. Prints one line per number, each with the card's name
and power limit, and with --json writes them all to one file.

    python tools/measure_1m.py [--rays 2097152] [--xla-rays 65536] [--json F]
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from bench import N_RAYS, SCENE_RES, headline_rays, loss_fn


def timed(f, *args, reps):
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(f(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts)), ts


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=N_RAYS)
    ap.add_argument("--xla-rays", type=int, default=1 << 16)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--xla-reps", type=int, default=2)
    ap.add_argument("--json", help="write every number to this file")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import embree_tpu as et
    from embree_tpu.core.device import use_compile_cache
    from embree_tpu.build.native import load_library as build_native_sah
    from embree_tpu.verify.fixtures import triangle_sphere

    dev0 = jax.devices()[0]
    if dev0.platform != "gpu":
        print("measure_1m: no GPU", file=sys.stderr)
        return 1
    use_compile_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    out = {"device_kind": dev0.device_kind, "nvidia_smi": card,
           "rays": args.rays, "xla_rays": args.xla_rays}

    def rec(key, value, unit):
        out[key] = value
        print(f"{key}: {value} {unit}  [{card}]", flush=True)

    verts, idx = triangle_sphere((0.0, 0.0, 0.0), 2.0, SCENE_RES)
    t0 = time.perf_counter()
    build_native_sah()                  # first-use g++ build: set-up
    rec("native_sah_build_s", time.perf_counter() - t0, "s")
    t0 = time.perf_counter()
    scene = et.Scene(et.Device("ignore_config_files=1"))
    scene.attach(et.TriangleMesh(verts, idx))
    cs = scene.commit()
    rec("commit_s", time.perf_counter() - t0, "s")
    n = args.rays
    org, d = headline_rays(n)
    rays = et.make_rays(org, d)
    k = args.xla_rays
    part = et.make_rays(org[:k], d[:k])
    idxd = jnp.asarray(idx)

    def fwd(isa):
        @jax.jit
        def f(c, r):
            h = et.scene_intersect(c, r, isa=isa)
            return h.t, h.gprim
        return f

    _, t_k_full, _ = timed(fwd("default"), cs, rays, reps=args.reps)
    rec("kernel_fwd_ns_per_ray_full", t_k_full / n * 1e9, "ns/ray")
    rec("kernel_fwd_mrayps_full", n / t_k_full / 1e6, "Mray/s")
    _, t_k_part, _ = timed(fwd("default"), cs, part, reps=args.reps)
    rec("kernel_fwd_ns_per_ray_slice", t_k_part / k * 1e9, "ns/ray")
    first, t_x_part, _ = timed(fwd("xla"), cs, part, reps=args.xla_reps)
    rec("xla_fwd_first_call_s_slice", first, "s")
    rec("xla_fwd_ns_per_ray_slice", t_x_part / k * 1e9, "ns/ray")
    rec("xla_over_kernel_per_ray", (t_x_part / k) / (t_k_full / n), "x")

    vparam = jnp.asarray(verts)
    t0 = time.perf_counter()
    step = jax.jit(jax.value_and_grad(loss_fn)).lower(
        vparam, cs, rays, idxd).compile()
    rec("fwdbwd_compile_s", time.perf_counter() - t0, "s")
    _, t_step, ts = timed(step, vparam, cs, rays, idxd, reps=args.reps)
    rec("fwdbwd_step_ms", t_step * 1e3, "ms")
    rec("fwdbwd_step_ms_all", [round(x * 1e3, 3) for x in ts], "ms")
    rec("fwdbwd_mrayps", n / t_step / 1e6, "Mray/s")
    rec("peak_bytes_in_use", dev0.memory_stats().get("peak_bytes_in_use"),
        "B")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
