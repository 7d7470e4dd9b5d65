"""Time the fwd / fwd+bwd split of the headline workload.

Isolates where the bench.py fwd+bwd step spends time:
  fwd        — scene_intersect (the traversal kernel on a GPU) alone
  bwd_old    — bench.py r3 loss: differentiable per-triangle scene copy
               (vertices -> tris gathers) + reeval_hit packed gather
  bwd_new    — reeval_hit_verts: one composed rays->corner-vertex gather
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def timeit(f, *a, reps=6):
    import jax
    jax.block_until_ready(f(*a))
    t0 = time.perf_counter()
    for _i in range(reps):
        jax.block_until_ready(f(*a))
    return (time.perf_counter() - t0) / reps


def main():
    import jax
    import jax.numpy as jnp

    import embree_tpu as et
    from embree_tpu.diff.hit import reeval_hit, reeval_hit_verts
    from embree_tpu.scene.scene import scene_intersect
    from embree_tpu.verify.fixtures import triangle_sphere

    rng = np.random.default_rng(0xBE7C4)
    verts, idx = triangle_sphere((0.0, 0.0, 0.0), 2.0, 707)
    dev = et.Device("ignore_config_files=1")
    scene = et.Scene(dev)
    scene.attach(et.TriangleMesh(verts, idx))
    cs = scene.commit()
    n = 1 << 20
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    rays = et.make_rays(org, d)
    idxj = np.asarray(idx)
    idxd = jnp.asarray(idxj)

    @jax.jit
    def fwd(c, r):
        h = scene_intersect(c, r)
        return jnp.sum(jnp.where(h.valid, h.t, 0.0))

    def loss_old(vertices, c, r):
        tris = c.tris._replace(v0=vertices[idxj[:, 0]],
                               v1=vertices[idxj[:, 1]],
                               v2=vertices[idxj[:, 2]])
        c2 = c._replace(tris=tris)
        sel = jax.lax.stop_gradient(scene_intersect(c, r))
        h = reeval_hit(c2.tris, r, sel.gprim, sel.valid)
        return jnp.sum(jnp.where(h.valid,
                                 h.t + 0.25 * h.u + 0.125 * h.v, 0.0))

    def loss_new(vertices, c, r):
        sel = jax.lax.stop_gradient(scene_intersect(c, r))
        t, u, v = reeval_hit_verts(vertices, idxd, r, sel.gprim, sel.valid)
        # fold u/v into the loss so the equivalence check covers the
        # FULL (t, u, v) training surface, not just the t-gradient
        # (ADVICE r4: reeval_hit_verts skips the uv_flip correction —
        # valid only because this is a single unflipped triangle mesh)
        return jnp.sum(jnp.where(sel.valid, t + 0.25 * u + 0.125 * v, 0.0))

    f_old = jax.jit(jax.value_and_grad(loss_old))
    f_new = jax.jit(jax.value_and_grad(loss_new))
    vparam = jnp.asarray(verts)

    t_fwd = timeit(fwd, cs, rays)
    print(f"fwd only:        {t_fwd*1e3:8.1f} ms  {n/t_fwd/1e6:6.2f} Mray/s")
    t_old = timeit(f_old, vparam, cs, rays)
    print(f"fwd+bwd old:     {t_old*1e3:8.1f} ms  {n/t_old/1e6:6.2f} Mray/s")
    t_new = timeit(f_new, vparam, cs, rays)
    print(f"fwd+bwd new:     {t_new*1e3:8.1f} ms  {n/t_new/1e6:6.2f} Mray/s")
    # gradient equivalence check on a subset
    g_old = f_old(vparam, cs, rays)[1]
    g_new = f_new(vparam, cs, rays)[1]
    err = float(jnp.max(jnp.abs(g_old - g_new)))
    scale = float(jnp.max(jnp.abs(g_old)))
    print(f"grad equivalence: max|dold-dnew| = {err:.3e} (scale {scale:.3e})")


if __name__ == "__main__":
    main()
