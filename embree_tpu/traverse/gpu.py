"""Per-ray BVH traversal on NVIDIA GPUs: one CUDA kernel through jax.ffi.

The kernel (native/bvh_traverse.cu) walks one ray per thread with a
private stack (Aila & Laine 2009), children nearest first, leaves as
tagged stack refs and a pop-cull against the current hit. It serves
triangle closest-hit and any-hit for every ray batch the triangle accel
sees on the GPU; `traverse/packet.py` stays the CPU path and the
reference it is checked against.

This module holds everything around the kernel that the CPU can test:

  * `pack_gpu_bvh`: the committed BVH and triangles in the kernel's
    layout (one 128-byte line per BVH4 node, precomputed Moeller-Trumbore
    triangles in leaf order) and the stack depth the tree needs;
  * `traverse_twin`: a NumPy twin of the kernel's loop over that layout,
    operation for operation, vectorized across rays;
  * `traverse`: the jittable wrapper (ray packing, empty batches and
    scenes, a zero-gradient custom_vjp, stats counters);
  * `select_traversal`: the one place that picks the kernel or the XLA
    walk;
  * `build_library`: nvcc at first use into native/build/, keyed on a
    hash of the source and the flags.

The kernel is built with --fmad=false: products and sums round exactly
as in the twin and the XLA walk, so t agrees to the last few ulps (the
XLA walk's own op fusion is the only difference left; tests and
chip_smoke.py hold t to rel 1e-5).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np

from ..core.rayhit import Rays
from ..core.stats import instance as _stat_instance, stats_enabled

BLOCK = 128                     # threads (rays) per CUDA block
STACK_SIZES = (64, 128, 256)    # stack capacities compiled into the library
WIDTHS = (4, 8)                 # node widths compiled into the library
ISAS = ("default", "cuda", "xla")
TARGET = "et_bvh_traverse"

ROBUST_MIN = np.float32(1.0 - 3.0 * 2.0 ** -23)
ROBUST_MAX = np.float32(1.0 + 3.0 * 2.0 ** -23)
INF = np.float32(np.inf)

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "bvh_traverse.cu")
BUILD_DIR = os.path.join(_ROOT, "native", "build")


# --- selection ---------------------------------------------------------------

def _platform() -> str:
    return jax.default_backend()


def select_traversal(isa: str = "default") -> str:
    """'cuda' (the kernel) or 'xla' (traverse/packet.py) for an `isa`
    config value: the kernel on a GPU, the XLA walk on the CPU or
    wherever isa=xla is set. isa=cuda off the GPU raises."""
    if isa not in ISAS:
        raise ValueError(f"unknown isa {isa!r}; expected one of {ISAS}")
    if isa == "xla":
        return "xla"
    on_gpu = _platform() == "gpu"
    if isa == "cuda" and not on_gpu:
        raise RuntimeError(
            f"isa=cuda needs a GPU; JAX's backend is {_platform()!r}")
    return "cuda" if on_gpu else "xla"


# --- layout ------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
class GpuBVH:
    """The kernel's tables. width/stack/num_prims are STATIC aux data so
    the kernel variant is chosen inside a caller's trace."""

    def __init__(self, nodes, tris, prim_order, width, stack, num_prims):
        self.nodes = nodes            # (M, 8W) f32, child/count as i32 bits
        self.tris = tris              # (T, 12) f32 [v0 e1 e2 Ng], leaf order
        self.prim_order = prim_order  # (T,) i32 leaf slot -> prim index
        self.width = width
        self.stack = stack
        self.num_prims = num_prims

    def tree_flatten(self):
        return ((self.nodes, self.tris, self.prim_order),
                (self.width, self.stack, self.num_prims))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def tree_depth(child: np.ndarray, count: np.ndarray) -> int:
    """Number of inner-node levels below and including the root."""
    if not (count >= 0).any():
        return 1
    depth, frontier = 0, np.zeros(1, np.int64)
    while frontier.size:
        depth += 1
        c, n = child[frontier], count[frontier]
        frontier = c[n == 0].astype(np.int64)
    return depth


def stack_capacity(depth: int, width: int) -> int:
    """Smallest compiled stack that holds a nearest-first walk of a tree
    this deep: each inner pop pushes at most `width` refs, so the stack
    never exceeds (width - 1) * depth + 1."""
    need = (width - 1) * depth + 1
    for s in STACK_SIZES:
        if need <= s:
            return s
    warnings.warn(f"BVH{width} of depth {depth} needs a {need}-entry stack; "
                  f"the kernel holds {STACK_SIZES[-1]} and counts every "
                  "dropped push as an overflow")
    return STACK_SIZES[-1]


def pack_gpu_bvh(bvh, v0, v1, v2) -> GpuBVH:
    """Repack host builder output (BVHArraysNP) and the committed triangle
    corners (numpy) into the kernel layout."""
    lower = np.asarray(bvh.lower, np.float32)
    upper = np.asarray(bvh.upper, np.float32)
    child = np.asarray(bvh.child, np.int32)
    count = np.asarray(bvh.count, np.int32)
    order = np.asarray(bvh.prim_order, np.int32)
    M, W = child.shape
    if W not in WIDTHS:
        raise ValueError(f"node width {W} not in {WIDTHS}")
    if count.max(initial=0) > 15 or (child[count > 0] >= 1 << 27).any():
        raise ValueError("leaf refs hold at most 15 prims from slot < 2^27")
    nodes = np.empty((M, 8, W), np.float32)
    nodes[:, 0:3] = lower.transpose(0, 2, 1)
    nodes[:, 3:6] = upper.transpose(0, 2, 1)
    nodes[:, 6] = child.view(np.float32)
    nodes[:, 7] = count.view(np.float32)
    tv0, tv1, tv2 = (np.asarray(v, np.float32)[order] for v in (v0, v1, v2))
    e1 = tv0 - tv1
    e2 = tv2 - tv0
    tris = np.concatenate([tv0, e1, e2, np.cross(e2, e1)], axis=1)
    return GpuBVH(nodes=jnp.asarray(nodes.reshape(M, 8 * W)),
                  tris=jnp.asarray(tris.reshape(-1, 12)),
                  prim_order=jnp.asarray(order),
                  width=W, stack=stack_capacity(tree_depth(child, count), W),
                  num_prims=int(order.shape[0]))


# --- NumPy twin of the kernel ------------------------------------------------

def _rcp_safe_np(a):
    with np.errstate(divide="ignore"):
        r = np.float32(1.0) / a
    return np.where(np.abs(a) < np.float32(1e-30),
                    np.where(a < 0, np.float32(-1e30), np.float32(1e30)),
                    r).astype(np.float32)


def traverse_twin(nodes, tris, order, rays8, *, width, stack, occluded,
                  cull):
    """The kernel's loop in NumPy: every ray pops one stack entry per
    step, in lockstep, with the kernel's float32 operations in the
    kernel's order. Returns (t, prim, stats) like the kernel."""
    W = int(width)
    nodes = np.asarray(nodes, np.float32).reshape(-1, 8, W)
    tris = np.asarray(tris, np.float32).reshape(-1, 12)
    order = np.asarray(order, np.int32)
    rays8 = np.asarray(rays8, np.float32).reshape(-1, 8)
    R = rays8.shape[0]
    o, tnear, d = rays8[:, 0:3], rays8[:, 3], rays8[:, 4:7]
    t = rays8[:, 7].copy()
    rd = _rcp_safe_np(d)
    ord_ = o * rd
    child_all = nodes[:, 6].view(np.int32)
    count_all = nodes[:, 7].view(np.int32)

    stk_ref = np.zeros((R, stack), np.int32)
    stk_key = np.full((R, stack), -INF, np.float32)
    sp = np.ones(R, np.int64)
    prim = np.full(R, -1, np.int32)
    done = np.zeros(R, bool)
    pops = np.zeros(R, np.int64)
    tests = np.zeros(R, np.int64)
    overflows = np.zeros(R, np.int64)
    with np.errstate(invalid="ignore", over="ignore"):
        while True:
            ia = np.nonzero((sp > 0) & ~done)[0]
            if ia.size == 0:
                break
            sp[ia] -= 1
            ref = stk_ref[ia, sp[ia]]
            live = ~(stk_key[ia, sp[ia]] > t[ia])       # pop-cull
            ia, ref = ia[live], ref[live]

            inner = ref >= 0
            nd, nref = ia[inner], ref[inner]
            if nd.size:
                pops[nd] += 1
                f = nodes[nref]                          # (n, 8, W)
                r3, or3 = rd[nd][:, :, None], ord_[nd][:, :, None]
                t_lo = f[:, 0:3] * r3 - or3              # (n, 3, W)
                t_hi = f[:, 3:6] * r3 - or3
                mn, mx = np.fmin(t_lo, t_hi), np.fmax(t_lo, t_hi)
                tmin = ROBUST_MIN * np.fmax(np.fmax(mn[:, 0], mn[:, 1]),
                                            mn[:, 2])
                tmax = ROBUST_MAX * np.fmin(np.fmin(mx[:, 0], mx[:, 1]),
                                            mx[:, 2])
                tmin = np.fmax(tmin, tnear[nd][:, None])
                ch, cn = child_all[nref], count_all[nref]
                hit = (tmin <= tmax) & (tmin <= t[nd][:, None]) & (cn >= 0)
                key = np.where(hit, tmin, INF).astype(np.float32)
                cref = np.where(cn > 0, -(((ch << 4) | cn) + 1), ch)
                srt = np.argsort(key, axis=1, kind="stable")
                key = np.take_along_axis(key, srt, 1)
                cref = np.take_along_axis(cref, srt, 1)
                for c in range(W - 1, -1, -1):
                    push = key[:, c] < INF
                    can = push & (sp[nd] < stack)
                    overflows[nd[push & ~can]] += 1
                    rows = nd[can]
                    stk_ref[rows, sp[rows]] = cref[can, c]
                    stk_key[rows, sp[rows]] = key[can, c]
                    sp[rows] += 1

            lf, lref = ia[~inner], ref[~inner]
            if lf.size:
                v = -lref - 1
                start, cnt = v >> 4, v & 15
                tests[lf] += cnt
                for k in range(int(cnt.max())):
                    m = (k < cnt) & ~done[lf]
                    rows, p = lf[m], start[m] + k
                    tr = tris[p]
                    ox, oy, oz = o[rows, 0], o[rows, 1], o[rows, 2]
                    dx, dy, dz = d[rows, 0], d[rows, 1], d[rows, 2]
                    e1x, e1y, e1z = tr[:, 3], tr[:, 4], tr[:, 5]
                    e2x, e2y, e2z = tr[:, 6], tr[:, 7], tr[:, 8]
                    ngx, ngy, ngz = tr[:, 9], tr[:, 10], tr[:, 11]
                    cx, cy, cz = tr[:, 0] - ox, tr[:, 1] - oy, tr[:, 2] - oz
                    rx = cy * dz - cz * dy
                    ry = cz * dx - cx * dz
                    rz = cx * dy - cy * dx
                    den = ngx * dx + ngy * dy + ngz * dz
                    absden = np.abs(den)
                    sgn = np.where(den >= 0, np.float32(1), np.float32(-1))
                    us = (rx * e2x + ry * e2y + rz * e2z) * sgn
                    vs = (rx * e1x + ry * e1y + rz * e1z) * sgn
                    ts = (ngx * cx + ngy * cy + ngz * cz) * sgn
                    front = (den < 0) if cull else (den != 0)
                    ok = (front & (us >= 0) & (vs >= 0) & (us + vs <= absden)
                          & (absden * tnear[rows] < ts)
                          & (ts <= absden * t[rows]))
                    hr = rows[ok]
                    prim[hr] = p[ok]
                    if occluded:
                        done[hr] = True
                        t[hr] = -INF
                    else:
                        rcp = np.float32(1) / np.fmax(absden[ok],
                                                      np.float32(1e-37))
                        t[hr] = ts[ok] * rcp
    out_prim = np.where(prim >= 0, order[np.maximum(prim, 0)], -1)
    nb = -(-R // BLOCK)
    per = np.zeros((nb * BLOCK, 3), np.int64)
    per[:R] = np.stack([pops, tests, overflows], axis=1)
    stats = per.reshape(nb, BLOCK, 3).sum(1).astype(np.int32)
    return t.astype(np.float32), out_prim.astype(np.int32), stats


# --- the CUDA library ----------------------------------------------------------

def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or shutil.which(
        "nvcc", path=os.path.join(cuda_home, "bin"))
    if not found:
        raise RuntimeError("nvcc not found: the CUDA traversal kernel needs "
                           "the CUDA toolkit (PATH or $CUDA_HOME/bin)")
    return found


def _arch() -> str:
    cc = str(getattr(jax.devices()[0], "compute_capability", "9.0"))
    num = cc.replace(".", "")
    # sm_90a keeps Hopper's own instructions available
    return num + "a" if num == "90" else num


def build_flags() -> list:
    arch = _arch()
    return ["-gencode", f"arch=compute_{arch},code=sm_{arch}",
            "-std=c++17", "-O3", "--fmad=false", "-shared",
            "-Xcompiler", "-fPIC", "-I", jax.ffi.include_dir()]


def build_library() -> str:
    """Compile native/bvh_traverse.cu (once per source+flags hash) into
    native/build/ and return the library path."""
    flags = build_flags()
    with open(_SRC, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libet_bvh_{key}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *flags, "-o", tmp, _SRC],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


_lib = None
_lock = threading.Lock()


def _register() -> None:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.cdll.LoadLibrary(build_library())
            jax.ffi.register_ffi_target(
                TARGET, jax.ffi.pycapsule(lib.EtBvhTraverse),
                platform="CUDA")
            _lib = lib


def _out_types(R: int):
    return (jax.ShapeDtypeStruct((R,), jnp.float32),
            jax.ShapeDtypeStruct((R,), jnp.int32),
            jax.ShapeDtypeStruct((-(-R // BLOCK), 3), jnp.int32))


def _kernel_call(nodes, tris, order, rays8, *, width, stack, occluded,
                 cull):
    _register()
    return jax.ffi.ffi_call(TARGET, _out_types(rays8.shape[0]),
                            vmap_method="sequential")(
        nodes, tris, order, rays8, width=np.int32(width),
        stack=np.int32(stack), occluded=np.int32(occluded),
        cull=np.int32(cull))


def twin_call(nodes, tris, order, rays8, *, width, stack, occluded, cull):
    """`_kernel_call` with the NumPy twin in place of the CUDA kernel
    (a host callback): lets the CPU run everything around the kernel."""
    fn = functools.partial(traverse_twin, width=width, stack=stack,
                           occluded=occluded, cull=cull)
    return jax.pure_callback(fn, _out_types(rays8.shape[0]),
                             nodes, tris, order, rays8)


# --- wrapper -------------------------------------------------------------------

def _zero_cotangent(x):
    if jnp.issubdtype(x.dtype, jnp.floating):
        return jnp.zeros_like(x)
    return np.zeros(x.shape, jax.dtypes.float0)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _traverse_cv(arrs, static):
    return _kernel_call(*arrs, **dict(static))


def _traverse_fwd(arrs, static):
    return _traverse_cv(arrs, static), arrs


def _traverse_bwd(static, arrs, ct):
    # hit selection is discrete: gradients flow through diff/hit.py's
    # re-evaluation of the selected primitive instead
    return (tuple(_zero_cotangent(a) for a in arrs),)


_traverse_cv.defvjp(_traverse_fwd, _traverse_bwd)


def _record_stats(shadow: bool, rays: int, stats) -> None:
    """STAT3 accumulation (core/stats.py); eager calls only."""
    if stats_enabled() and not isinstance(stats, jax.core.Tracer):
        _stat_instance().add(shadow, rays, stats)


def _rays8(rays: Rays):
    """(R, 8) f32 [org.xyz tnear dir.xyz tfar], the kernel's ray record."""
    return jnp.concatenate([rays.org.reshape(-1, 3),
                            rays.tnear.reshape(-1, 1),
                            rays.dir.reshape(-1, 3),
                            rays.tfar.reshape(-1, 1)],
                           axis=1).astype(jnp.float32)


def _static(gs: GpuBVH, occluded: bool, cull: bool):
    return (("width", gs.width), ("stack", gs.stack),
            ("occluded", int(occluded)), ("cull", int(cull)))


def traverse(gs: GpuBVH, rays: Rays, occluded: bool = False,
             cull: bool = False):
    """Flat (t, prim) over the rays, prim = committed prim index or -1.
    Closest-hit t is the hit distance (tfar on a miss); with occluded=True
    prim >= 0 marks an occluded ray. Jittable; zero traversal gradient."""
    tf = rays.tfar.reshape(-1).astype(jnp.float32)
    R = tf.shape[0]
    if R == 0 or gs.num_prims == 0:
        return tf, jnp.full((R,), -1, jnp.int32)
    t, prim, stats = _traverse_cv(
        (gs.nodes, gs.tris, gs.prim_order, _rays8(rays)),
        _static(gs, occluded, cull))
    _record_stats(occluded, R, stats)
    return t, prim


def traversal_stats(gs: GpuBVH, rays: Rays, occluded: bool = False,
                    cull: bool = False):
    """Per-block [inner pops, leaf prim tests, stack overflows] (numpy)."""
    _t, _p, stats = _kernel_call(gs.nodes, gs.tris, gs.prim_order,
                                 _rays8(rays),
                                 **dict(_static(gs, occluded, cull)))
    return np.asarray(stats)
