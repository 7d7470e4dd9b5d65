"""Device object: config, error model, observability.

Analog of reference kernels/common/device.{h,cpp}. One Device wraps one
JAX backend (gpu/cpu) plus parsed State. The reference's per-thread
sticky RTCError + error-callback model (state.h:148-176,
rtcore.cpp:36-53) maps to python exceptions from a RaytracerError
hierarchy plus an optional error callback invoked before raising.

The ISA dispatch role (bvh4_factory.cpp symbol tables) is played by
`traverse/gpu.py:select_traversal`: the CUDA kernel on a GPU, the XLA
walk elsewhere.
"""
from __future__ import annotations

import enum
import os
from typing import Callable, Optional

import jax

from .config import State


class Error(enum.IntEnum):
    """Mirrors RTCError (include/embree3/rtcore_common.h)."""

    NONE = 0
    UNKNOWN = 1
    INVALID_ARGUMENT = 2
    INVALID_OPERATION = 3
    OUT_OF_MEMORY = 4
    UNSUPPORTED_CPU = 5  # kept for API parity; unused
    CANCELLED = 6


class RaytracerError(RuntimeError):
    def __init__(self, code: Error, msg: str):
        super().__init__(f"{code.name}: {msg}")
        self.code = code


class Device:
    """rtcNewDevice analog (device.cpp:52): parse config, pick backend."""

    def __init__(self, cfg: Optional[str] = None, *, backend: Optional[str] = None):
        self.state = State()
        # config-file layer first so the explicit string wins (device.cpp:60-68)
        self.state.parse_string(cfg)  # pick up ignore_config_files early
        self.state.parse_config_files()
        self.state.parse_string(cfg)
        self.error_code = Error.NONE
        self.error_fn: Optional[Callable[[Error, str], None]] = None
        self.memory_monitor_fn: Optional[Callable[[int, bool], bool]] = None
        self._memory_bytes = 0
        self.backend = backend or jax.default_backend()
        # setCacheSize(tessellation_cache_size) at device creation
        # (device.cpp:78)
        from ..subdiv.cache import global_cache
        global_cache().set_size(self.state.tessellation_cache_size)
        if self.state.verbose >= 1:
            self.print_banner()

    # -- error model (RTC_CATCH_END analog, rtcore.cpp:36-53) ---------------
    def set_error_function(self, fn: Callable[[Error, str], None]) -> None:
        self.error_fn = fn

    def raise_error(self, code: Error, msg: str) -> None:
        self.error_code = code
        if self.error_fn is not None:
            self.error_fn(code, msg)
        raise RaytracerError(code, msg)

    def get_error(self) -> Error:
        """rtcGetDeviceError: returns and clears the sticky error."""
        code, self.error_code = self.error_code, Error.NONE
        return code

    # -- memory monitor (rtcore_device.h:90-93) ----------------------------
    def set_memory_monitor_function(self, fn: Callable[[int, bool], bool]) -> None:
        self.memory_monitor_fn = fn

    def memory_monitor(self, bytes_delta: int, post: bool) -> None:
        self._memory_bytes += bytes_delta
        if self.memory_monitor_fn is not None:
            if not self.memory_monitor_fn(bytes_delta, post):
                self.raise_error(Error.OUT_OF_MEMORY, "memory monitor veto")

    @property
    def bytes_used(self) -> int:
        return self._memory_bytes

    # -- observability (device.cpp:94-98 banner) ---------------------------
    def print_banner(self) -> None:
        devs = jax.devices(self.backend) if self.backend else jax.devices()
        print(f"embree_tpu Device: backend={self.backend} devices={len(devs)} "
              f"[{devs[0].device_kind if devs else 'none'}]")
        print(f"  config: isa={self.state.isa} threads={self.state.threads} "
              f"packet_size={self.state.packet_size}")


_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
COMPILE_CACHE_DIR = os.path.join(_CHECKOUT, ".jax_cache")


def use_compile_cache() -> str:
    """Persistent XLA compile cache for the entry points. JAX reads
    JAX_COMPILATION_CACHE_DIR itself when it is set; otherwise the cache
    goes to a fixed directory inside the checkout. Returns the path."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    return COMPILE_CACHE_DIR
