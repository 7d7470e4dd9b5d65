"""ctypes binding for the native C++ SAH builder (native/sah_builder.cpp).

Compiles the shared library at first use with g++ into native/build/,
keyed on a hash of the source, the flags and the host CPU: -march=native
code is only ever loaded on the kind of host that built it. A failed
build raises; `builder=python` selects the numpy builder explicitly.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

from .bvh import BVHArraysNP

_here = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_here, "native", "sah_builder.cpp")
_BUILD_DIR = os.path.join(_here, "native", "build")
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
          "-pthread"]

_lib = None
_lock = threading.Lock()


def _host_cpu() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    return line
    except OSError:
        pass
    return platform.processor() or platform.machine()


def library_path() -> str:
    with open(_SRC, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()
                             + _host_cpu().encode()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libet_sah_{key}.so")


def load_library():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"native SAH builder failed to compile:\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.et_build_sah.restype = ctypes.c_void_p
        lib.et_build_sah.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float]
        lib.et_build_sah_tri.restype = ctypes.c_void_p
        lib.et_build_sah_tri.argtypes = [
            ctypes.POINTER(ctypes.c_float)] * 5 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float]
        lib.et_num_refs.restype = ctypes.c_int64
        lib.et_num_refs.argtypes = [ctypes.c_void_p]
        lib.et_num_nodes.restype = ctypes.c_int64
        lib.et_num_nodes.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.et_get_arrays.restype = None
        lib.et_get_arrays.argtypes = [ctypes.c_void_p] + \
            [ctypes.POINTER(ctypes.c_float)] * 2 + \
            [ctypes.POINTER(ctypes.c_int32)] * 3
        lib.et_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def build_sah_native(prim_lower: np.ndarray, prim_upper: np.ndarray,
                     branching: int = 4, max_leaf: int = 4,
                     min_leaf: int = 1,
                     spatial_factor: float = 1.0,
                     tri_verts=None) -> BVHArraysNP:
    """spatial_factor > 1 enables BINNED SPATIAL SPLITS (SBVH,
    RTC_BUILD_QUALITY_HIGH; heuristic_spatial_array.h semantics): every
    range evaluates both the 32-bin object split and a 16-bin spatial
    split with entry/exit counts and clipped per-bin bounds, takes the
    cheaper, and duplicates straddling references under a budget of
    (spatial_factor - 1) * P (embree's max_spatial_split_replications,
    state.h:113). `tri_verts=(v0, v1, v2)` enables exact
    Sutherland-Hodgman triangle clipping for tight split boxes;
    without it, boxes are chopped at the plane. The returned prim_order
    then holds up to spatial_factor * P entries with repeats — leaves
    referencing a duplicated prim test it more than once, harmless for
    correctness."""
    lib = load_library()
    lo = np.ascontiguousarray(prim_lower, np.float32)
    hi = np.ascontiguousarray(prim_upper, np.float32)
    P = lo.shape[0]
    fp = ctypes.POINTER(ctypes.c_float)
    if tri_verts is not None and spatial_factor > 1.0:
        v0, v1, v2 = (np.ascontiguousarray(v, np.float32)
                      for v in tri_verts)
        h = lib.et_build_sah_tri(
            lo.ctypes.data_as(fp), hi.ctypes.data_as(fp),
            v0.ctypes.data_as(fp), v1.ctypes.data_as(fp),
            v2.ctypes.data_as(fp),
            P, branching, max_leaf, min_leaf, float(spatial_factor))
    else:
        h = lib.et_build_sah(
            lo.ctypes.data_as(fp), hi.ctypes.data_as(fp),
            P, branching, max_leaf, min_leaf, float(spatial_factor))
    try:
        P = lib.et_num_refs(h)
        M = lib.et_num_nodes(h, branching)
        lower = np.empty((M, branching, 3), np.float32)
        upper = np.empty((M, branching, 3), np.float32)
        child = np.empty((M, branching), np.int32)
        count = np.empty((M, branching), np.int32)
        order = np.empty((P,), np.int32)
        lib.et_get_arrays(
            h,
            lower.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            upper.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            child.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            count.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    finally:
        lib.et_free(h)
    return BVHArraysNP(lower, upper, child, count, order)
