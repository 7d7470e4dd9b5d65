#!/usr/bin/env python3
"""Bring-up check on an NVIDIA GPU: the main path end to end, every
kernel compiled for the card and compared with the XLA walk.

    python3 chip_smoke.py               # one GPU: phases 1-5
    python3 chip_smoke.py --devices 4   # four GPUs: the multi-card phase

Phases (each prints its own lines; any failure ends the run non-zero):
  1. device: JAX's devices and nvidia-smi's name and power limit;
  2. build: the CUDA traversal library (native/bvh_traverse.cu);
  3. kernel vs XLA walk on a 65k-triangle sphere with 2^16 incoherent
     rays (closest hit and occluded), and the watertight cases;
  4. main path: bench.py's 998,284-triangle sphere, 2^21 incoherent
     rays, jit(value_and_grad(loss)) through scene_intersect and
     diff/hit.py:hit_t_grad, several steps, and a 2^16-ray slice of the
     step's hits against the XLA walk;
  5. tutorials: triangle_geometry and displacement_geometry
     (compressed leaf) against the reference renders in tests/golden.
With --devices 4 only the multi-card phase runs: the dist/sharding.py
train step (kernel inside shard_map) against one card, and the
dist/prim_shard.py ring against the single-device intersect.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
It exits non-zero, without that line, when JAX finds no GPU.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from bench import N_RAYS, SCENE_RES, headline_rays, loss_fn

T_REL = 1e-5          # t tolerance: --fmad=false kernel vs the XLA walk
MISS_GATE = 2e-5      # watertight miss rate (verify.cpp:2707-2709)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare_hits(name, hk, hx, rel=T_REL):
    """Kernel hits vs XLA-walk hits: hit/miss identical, t within `rel`,
    prim equal except at t ties."""
    vk, vx = np.asarray(hk.valid), np.asarray(hx.valid)
    tk, tx = np.asarray(hk.t), np.asarray(hx.t)
    pk, px = np.asarray(hk.gprim), np.asarray(hx.gprim)
    assert (vk == vx).all(), f"{name}: hit/miss differs on {(vk != vx).sum()} rays"
    err = np.abs(tk[vx] - tx[vx]) / np.maximum(np.abs(tx[vx]), 1e-30)
    max_rel = float(err.max()) if err.size else 0.0
    assert max_rel <= rel, f"{name}: t rel err {max_rel:.3e} > {rel:.0e}"
    diff = pk[vx] != px[vx]
    assert (err[diff] <= rel).all(), f"{name}: prim differs off a t tie"
    log(f"  {name}: rays {vk.size} hits {int(vx.sum())} t max rel err "
        f"{max_rel:.3e} (tol {rel:.0e}) prim ties {int(diff.sum())}")


def committed(verts, idx, cfg="ignore_config_files=1"):
    import embree_tpu as et
    scene = et.Scene(et.Device(cfg))
    scene.attach(et.TriangleMesh(verts, idx))
    return scene, scene.commit()


def overflows(gs, rays) -> int:
    from embree_tpu.traverse.gpu import traversal_stats
    return int(traversal_stats(gs, rays)[:, 2].astype(np.int64).sum())


def phase_kernel_vs_xla(xla_rays: int) -> None:
    import jax

    import embree_tpu as et
    from embree_tpu.verify.fixtures import (quad_sphere, subdiv_cube,
                                            triangle_sphere)

    verts, idx = triangle_sphere((0.0, 0.0, 0.0), 2.0, 181)
    _scene, cs = committed(verts, idx)
    log(f"  scene: {len(idx)} triangles, BVH{cs.gpu.width}, stack "
        f"{cs.gpu.stack}")
    rays = et.make_rays(*headline_rays(xla_rays, seed=3))
    hit = jax.jit(lambda c, r: et.scene_intersect(c, r))
    hit_x = jax.jit(lambda c, r: et.scene_intersect(c, r, isa="xla"))
    occ = jax.jit(lambda c, r: et.scene_occluded(c, r))
    occ_x = jax.jit(lambda c, r: et.scene_occluded(c, r, isa="xla"))
    t0 = time.perf_counter()
    hk = jax.block_until_ready(hit(cs, rays))
    log(f"  kernel closest-hit (compile+run): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    hx = jax.block_until_ready(hit_x(cs, rays))
    log(f"  XLA walk closest-hit (compile+run): {time.perf_counter() - t0:.2f} s")
    compare_hits("closest", hk, hx)
    ok_k = np.asarray(occ(cs, rays))
    t0 = time.perf_counter()
    ok_x = np.asarray(jax.block_until_ready(occ_x(cs, rays)))
    log(f"  XLA walk occluded (compile+run): {time.perf_counter() - t0:.2f} s")
    assert (ok_k == ok_x).all(), f"occluded differs on {(ok_k != ok_x).sum()} rays"
    log(f"  occluded: identical on {ok_k.size} rays ({int(ok_k.sum())} occluded)")
    n_over = overflows(cs.gpu, rays)
    assert n_over == 0, f"stack overflows: {n_over}"
    log(f"  stack overflows: {n_over}")

    # watertight cases (tests/test_watertight_matrix.py) through the kernel
    wrng = np.random.default_rng(0x3A7)
    n = 100_000
    d = wrng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    inside = et.make_rays(np.zeros((n, 3), np.float32), d)

    def miss_rate(scene):
        assert scene.committed.gpu is not None
        return 1.0 - float(np.asarray(scene.intersect(inside).valid).mean())

    tv, ti = triangle_sphere((0, 0, 0), 2.0, 60)
    s_tri, _ = committed(tv, ti)
    qv, qi = quad_sphere((0, 0, 0), 2.0, 50)
    s_quad = et.Scene(et.Device("ignore_config_files=1"))
    s_quad.attach(et.QuadMesh(qv, qi))
    s_quad.commit()
    cv, counts, fidx = subdiv_cube()
    s_sub = et.Scene(et.Device("ignore_config_files=1"))
    s_sub.attach(et.SubdivMesh(cv, counts, fidx))
    s_sub.set_levels(4, 2)
    s_sub.commit()
    for name, sc in (("triangles", s_tri), ("quads", s_quad),
                     ("subdiv (eager)", s_sub)):
        m = miss_rate(sc)
        assert m <= MISS_GATE, f"watertight {name}: miss rate {m:.2e}"
        log(f"  watertight {name}: miss rate {m:.2e} (gate {MISS_GATE:.0e})")


def phase_main_path(gpu_name: str, n_rays: int, steps: int,
                    slice_rays: int) -> None:
    import jax
    import jax.numpy as jnp

    import embree_tpu as et
    from embree_tpu.verify.fixtures import triangle_sphere

    verts, idx = triangle_sphere((0.0, 0.0, 0.0), 2.0, SCENE_RES)
    t0 = time.perf_counter()
    _scene, cs = committed(verts, idx)
    commit_s = time.perf_counter() - t0
    log(f"  commit: {len(idx)} triangles in {commit_s:.2f} s "
        f"(BVH{cs.gpu.width}, {cs.bvh.num_nodes} nodes, stack {cs.gpu.stack})")
    org, d = headline_rays(n_rays)
    rays = et.make_rays(org, d)
    idxd = jnp.asarray(idx)

    vparam = jnp.asarray(verts)
    t0 = time.perf_counter()
    step = jax.jit(jax.value_and_grad(loss_fn)).lower(
        vparam, cs, rays, idxd).compile()
    log(f"  compile: {time.perf_counter() - t0:.2f} s")
    log(f"  memory_analysis: {step.memory_analysis()}")
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        loss, grad = jax.block_until_ready(step(vparam, cs, rays, idxd))
        times.append(time.perf_counter() - t0)
        gnorm = float(jnp.linalg.norm(grad))
        assert np.isfinite(float(loss)), f"step {i}: loss {float(loss)}"
        assert np.isfinite(gnorm) and gnorm > 0, f"step {i}: |grad| {gnorm}"
        log(f"  step {i}: {times[-1] * 1e3:.1f} ms loss {float(loss):.6e} "
            f"|grad| {gnorm:.6e}")
    best = min(times[1:] or times)
    log(f"  fwd+bwd: {n_rays / best / 1e6:.3f} Mray/s ({best * 1e3:.1f} ms "
        f"per step, {n_rays} rays) on {gpu_name}")
    hits = jax.jit(lambda c, r: et.scene_intersect(c, r))(cs, rays)
    part = et.make_rays(org[:slice_rays], d[:slice_rays])
    t0 = time.perf_counter()
    hx = jax.block_until_ready(
        jax.jit(lambda c, r: et.scene_intersect(c, r, isa="xla"))(cs, part))
    log(f"  XLA walk on the {slice_rays}-ray slice (compile+run): "
        f"{time.perf_counter() - t0:.2f} s")
    hk = jax.tree.map(lambda x: x[:slice_rays], hits)
    compare_hits("step slice", hk, hx)
    n_over = overflows(cs.gpu, rays)
    assert n_over == 0, f"stack overflows: {n_over}"
    log(f"  stack overflows on {n_rays} rays: {n_over}")


def phase_tutorials() -> None:
    from embree_tpu.render.camera import Camera
    from embree_tpu.render.image import read_pfm
    from embree_tpu.render.tutorials import displacement_geometry as dg
    from embree_tpu.render.tutorials import triangle_geometry as tg

    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "golden")

    def gate(img, name, budget, tol=1.5 / 255):
        # same model as tests/test_ref_golden.py:_gate
        ref = read_pfm(os.path.join(golden, name))
        q = np.floor(255.0 * np.clip(np.asarray(img), 0.0, 1.0)) / 255.0
        frac = float((np.abs(q - ref).max(-1) > tol).mean())
        assert frac <= budget, f"{name}: {frac:.4%} pixels differ"
        log(f"  {name}: {frac:.4%} pixels differ (budget {budget:.2%})")

    state = tg.build_scene()
    assert state["cscene"].gpu is not None
    img, _ = tg.render_frame(state, Camera(from_=(1.5, 1.5, -1.5),
                                           to=(0, 0, 0)), (128, 128))
    gate(img, "ref_triangle_geometry_128.pfm", 0.005)
    state = dg.build_scene("bvh4.compressed.leaf")
    img, _ = dg.render_frame(state, Camera(from_=(2.5, 2.5, 2.5),
                                           to=(0, 0, 0)), (64, 64))
    gate(img, "ref_displacement_leaf_64.pfm", 0.005)


def phase_multi_card(n_dev: int, n_rays: int) -> None:
    import jax
    import jax.numpy as jnp

    import embree_tpu as et
    from embree_tpu.dist.prim_shard import (build_prim_sharded,
                                            place_prim_sharded,
                                            prim_sharded_intersect)
    from embree_tpu.dist.sharding import (make_mesh, make_sharded_train_step,
                                          shard_rays)
    from embree_tpu.verify.fixtures import triangle_sphere

    assert len(jax.devices()) >= n_dev, f"need {n_dev} devices"
    verts, idx = triangle_sphere((0.0, 0.0, 0.0), 2.0, SCENE_RES)
    _scene, cs = committed(verts, idx)
    rays = et.make_rays(*headline_rays(n_rays))
    idxd = jnp.asarray(idx)

    def sharded_loss(vertices, r, target, c, tri_idx):
        return loss_fn(vertices, c, r, tri_idx) - jnp.sum(target)

    mesh = make_mesh(n_dev)
    lr = 1.0
    step = make_sharded_train_step(mesh, sharded_loss)
    srays, _r = shard_rays(rays, mesh)
    target = jnp.zeros_like(srays.tnear)
    vparam = jnp.asarray(verts)
    t0 = time.perf_counter()
    loss_s, new_p = jax.block_until_ready(
        step(vparam, srays, target, cs, idxd, lr=lr))
    log(f"  sharded step over {n_dev} cards (compile+run): "
        f"{time.perf_counter() - t0:.2f} s")
    grad_s = np.asarray(vparam - new_p) / lr
    one = jax.jit(jax.value_and_grad(sharded_loss))
    loss_1, grad_1 = one(vparam, rays, jnp.zeros(n_rays), cs, idxd)
    grad_1 = np.asarray(grad_1)
    log(f"  loss: sharded {float(loss_s):.6e} one card {float(loss_1):.6e}")
    np.testing.assert_allclose(float(loss_s), float(loss_1), rtol=1e-4)
    gerr = float(np.abs(grad_s - grad_1).max() / np.abs(grad_1).max())
    log(f"  grad: max abs diff / max |grad| = {gerr:.3e}")
    assert gerr <= 1e-4, "sharded gradient differs from one card"

    # prim-sharded scene: ppermute ring vs the single-device intersect
    sv, si = triangle_sphere((0.0, 0.0, 0.0), 2.0, 100)
    sv = np.asarray(sv, np.float32)
    v0, v1, v2 = sv[si[:, 0]], sv[si[:, 1]], sv[si[:, 2]]
    T = si.shape[0]
    smesh = make_mesh(n_dev, "sp")
    ps = place_prim_sharded(
        build_prim_sharded(v0, v1, v2, np.zeros(T, np.int32),
                           np.arange(T, dtype=np.int32),
                           np.zeros(T, np.int32), n_dev), smesh, "sp")
    nr = 1024 * n_dev
    prays = et.make_rays(*headline_rays(nr, seed=5))
    h_ring = prim_sharded_intersect(ps, prays, smesh, "sp")
    _s2, cs2 = committed(sv, si)
    h_one = et.scene_intersect(cs2, prays)
    compare_hits("prim-sharded ring", h_ring, h_one)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="4 runs only the multi-card phase")
    ap.add_argument("--phases", default="1,2,3,4,5",
                    help="comma list of single-card phases to run")
    ap.add_argument("--rays", type=int, default=N_RAYS)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--xla-rays", type=int, default=1 << 16,
                    help="rays compared with the XLA walk (phases 3, 4)")
    args = ap.parse_args()

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 1
    from embree_tpu.core.device import use_compile_cache
    from embree_tpu.traverse import gpu

    cache = use_compile_cache()
    phases = ({int(p) for p in args.phases.split(",")}
              if args.devices == 1 else set())
    t_all = time.perf_counter()
    log(f"[1] device: {len(devs)} x {devs[0].device_kind} "
        f"(platform {devs[0].platform}), compile cache {cache}")
    gpu_name = nvidia_smi()
    log(f"nvidia-smi: {gpu_name}")
    t0 = time.perf_counter()
    lib = gpu.build_library()
    gpu._register()
    log(f"[2] build: {lib} in {time.perf_counter() - t0:.2f} s "
        f"({' '.join(gpu.build_flags()[:5])})")
    if 3 in phases:
        log("[3] kernel vs XLA walk")
        phase_kernel_vs_xla(args.xla_rays)
    if 4 in phases:
        log("[4] main path")
        phase_main_path(gpu_name, args.rays, args.steps, args.xla_rays)
    if 5 in phases:
        log("[5] tutorials")
        phase_tutorials()
    if args.devices > 1:
        log(f"[6] {args.devices} cards")
        phase_multi_card(args.devices, args.rays)
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(f"nvidia-smi: {nvidia_smi()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
