"""Multi-chip sharding layer: rays/tiles data-parallel over a device mesh.

The distributed design the reference never had (SURVEY.md §2.7): rays and
image tiles are sharded over the `dp` mesh axis with shard_map; the
scene/BVH is replicated per device (primitive sharding with a ray
ppermute ring is dist/prim_shard.py). Gradients all-reduce with
jax.lax.psum, which XLA hands to NCCL on GPUs.

Works identically on several GPUs and on the
`--xla_force_host_platform_device_count=N` CPU mesh used by the tests.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.rayhit import Hits, Rays
from ..scene.scene import CommittedScene, scene_intersect


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (axis,))


def pad_to_multiple(x: jnp.ndarray, m: int, fill=0.0):
    r = x.shape[0]
    rp = -(-r // m) * m
    if rp == r:
        return x, r
    pad = jnp.full((rp - r,) + x.shape[1:], fill, x.dtype)
    return jnp.concatenate([x, pad]), r


def shard_rays(rays: Rays, mesh: Mesh, axis: str = "dp"):
    """Pad the flat ray batch to the mesh size and shard the leading axis."""
    n = mesh.shape[axis]
    org, r = pad_to_multiple(rays.org.reshape(-1, 3), n)
    d, _ = pad_to_multiple(rays.dir.reshape(-1, 3), n, fill=1.0)
    tn, _ = pad_to_multiple(rays.tnear.reshape(-1), n)
    tf, _ = pad_to_multiple(rays.tfar.reshape(-1), n, fill=-jnp.inf)
    sh = NamedSharding(mesh, P(axis))
    return Rays(jax.device_put(org, sh), jax.device_put(d, sh),
                jax.device_put(tn, sh), jax.device_put(tf, sh)), r


def sharded_intersect(cs: CommittedScene, rays: Rays, mesh: Mesh,
                      axis: str = "dp", isa: str = "default") -> Hits:
    """DP intersect: each device traverses its ray shard against the
    replicated accel (the reference's tile parallel_for, across cards)."""
    def local(cs, org, d, tn, tf):
        return scene_intersect(cs, Rays(org, d, tn, tf), isa=isa)

    f = jax.shard_map(local, mesh=mesh,
                      in_specs=(P(), P(axis), P(axis), P(axis), P(axis)),
                      out_specs=P(axis), check_vma=False)
    return f(cs, rays.org, rays.dir, rays.tnear, rays.tfar)


def all_reduce_grads(grads, axis: str = "dp"):
    """Gradient all-reduce over the mesh axis (inside shard_map)."""
    return jax.tree.map(lambda g: jax.lax.psum(g, axis), grads)


def make_sharded_train_step(mesh: Mesh, loss_fn: Callable, axis: str = "dp"):
    """Builds a pjit-style training step: rays+targets sharded on `axis`,
    params replicated, grads psum'd over the mesh.

    loss_fn(params, rays, target, *consts) -> scalar local loss, where
    `consts` (e.g. the committed scene) are replicated arguments of the
    step rather than constants captured in its program. The returned
    step is a single compiled function (no host python in the loop).
    """
    def local_step(params, org, d, tn, tf, target, consts):
        rays = Rays(org, d, tn, tf)
        loss, grads = jax.value_and_grad(loss_fn)(params, rays, target,
                                                  *consts)
        loss = jax.lax.psum(loss, axis)
        grads = all_reduce_grads(grads, axis)
        return loss, grads

    sharded = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P(axis), P(axis), P()),
        out_specs=(P(), P()), check_vma=False)

    @jax.jit
    def step(params, rays: Rays, target, *consts, lr=1e-3):
        loss, grads = sharded(params, rays.org, rays.dir, rays.tnear,
                              rays.tfar, target, consts)
        new_params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
        return loss, new_params

    return step
