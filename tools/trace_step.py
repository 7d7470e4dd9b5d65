"""Profile the headline forward+backward step on one GPU and reduce the
trace to device time per kernel.

Runs bench.py's step (998,284-triangle sphere, 2^21 incoherent rays)
under jax.profiler for --steps steps after a warm-up, then sums the
device durations of the events on the GPU plane's stream lines by name,
and the busy share of the window (union of event intervals). Prints the top
kernels; --json writes the whole reduction to one file.

    python tools/trace_step.py [--steps 3] [--top 25] [--json F]
"""
import argparse
import collections
import glob
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import N_RAYS, SCENE_RES, headline_rays, loss_fn


def reduce_trace(path: str) -> dict:
    """Device time per event name and the busy share, from an xplane.pb."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    per_name = collections.Counter()
    count = collections.Counter()
    spans = []
    lines_seen = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines_seen.append(f"{plane.name} | {line.name}")
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                per_name[ev.name] += ev.duration_ns
                count[ev.name] += 1
                spans.append((ev.start_ns, ev.end_ns))
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    return {"lines": lines_seen,
            "busy_ns": busy, "window_ns": window,
            "busy_share": busy / window if window else 0.0,
            "kernels": [{"name": n, "ns": t, "calls": count[n]}
                        for n, t in per_name.most_common()]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--json", help="write the reduction to this file")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import embree_tpu as et
    from embree_tpu.core.device import use_compile_cache
    from embree_tpu.verify.fixtures import triangle_sphere

    if jax.devices()[0].platform != "gpu":
        print("trace_step: no GPU", file=sys.stderr)
        return 1
    use_compile_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    verts, idx = triangle_sphere((0.0, 0.0, 0.0), 2.0, SCENE_RES)
    scene = et.Scene(et.Device("ignore_config_files=1"))
    scene.attach(et.TriangleMesh(verts, idx))
    cs = scene.commit()
    n = N_RAYS
    rays = et.make_rays(*headline_rays(n))
    idxd = jnp.asarray(idx)

    step = jax.jit(jax.value_and_grad(loss_fn))
    vparam = jnp.asarray(verts)
    jax.block_until_ready(step(vparam, cs, rays, idxd))
    jax.block_until_ready(step(vparam, cs, rays, idxd))
    with tempfile.TemporaryDirectory(prefix="trace_step_") as logdir:
        with jax.profiler.trace(logdir):
            for _ in range(args.steps):
                jax.block_until_ready(step(vparam, cs, rays, idxd))
        out = reduce_trace(glob.glob(os.path.join(
            logdir, "**", "*.xplane.pb"), recursive=True)[0])
    out.update({"nvidia_smi": card, "steps": args.steps, "rays": n})
    print(f"[{card}] busy {out['busy_ns'] / 1e6:.3f} ms of "
          f"{out['window_ns'] / 1e6:.3f} ms window "
          f"({out['busy_share']:.3f}) over {args.steps} steps")
    for k in out["kernels"][:args.top]:
        print(f"  {k['ns'] / 1e6 / args.steps:9.3f} ms/step "
              f"{k['calls'] // args.steps:4d}x  {k['name'][:110]}")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
