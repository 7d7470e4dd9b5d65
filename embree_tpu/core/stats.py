"""Ray-stat counters — the STAT3 / Stat::Counters analog
(kernels/common/stat.{h,cpp}: EMBREE_STAT_COUNTERS).

The reference compiles `STAT3(normal.trav_nodes, ...)` increments into
every traversal loop and prints a per-counter table at device shutdown.
Here the CUDA traversal kernel (traverse/gpu.py) emits per-block (inner
node pops, leaf prim tests, stack overflows) counters as a third output;
when stats are enabled (env EMBREE_TPU_STATS=1 or `enable()`), eager
intersect/occluded calls pull those counters back and accumulate them,
plus ray counts (the RayStats analog, tutorial_device.h:151-173).

Pulling counters forces a device sync per call — exactly the
pay-when-enabled cost profile of EMBREE_STAT_COUNTERS builds.
"""
from __future__ import annotations

import atexit
import os
from dataclasses import dataclass, field


@dataclass
class Counters:
    """One row of the reference's Stat::Counters (normal/shadow)."""

    travs: int = 0        # rays traced (STAT3 normal.travs)
    trav_nodes: int = 0   # node pops (STAT3 normal.trav_nodes)
    trav_prims: int = 0   # leaf prim tests (STAT3 normal.trav_prims)
    stack_overflows: int = 0  # pushes dropped by a full traversal stack


@dataclass
class Stat:
    normal: Counters = field(default_factory=Counters)
    shadow: Counters = field(default_factory=Counters)
    enabled: bool = bool(int(os.environ.get("EMBREE_TPU_STATS", "0")))

    def enable(self, on: bool = True) -> None:
        self.enabled = on

    def clear(self) -> None:
        self.normal = Counters()
        self.shadow = Counters()

    def add(self, shadow: bool, rays: int, stats_arr=None) -> None:
        """Accumulate one traversal call. `stats_arr` is the kernel's
        (B, 3) [pops, leaf_tests, overflows] per-block counter output
        (or None for paths that only count rays)."""
        c = self.shadow if shadow else self.normal
        c.travs += int(rays)
        if stats_arr is not None:
            import numpy as np
            a = np.asarray(stats_arr, np.int64)
            c.trav_nodes += int(a[:, 0].sum())
            c.trav_prims += int(a[:, 1].sum())
            c.stack_overflows += int(a[:, 2].sum())

    def print(self, prefix: str = "") -> None:
        for name, c in (("normal", self.normal), ("shadow", self.shadow)):
            if c.travs == 0:
                continue
            per = lambda v: v / max(c.travs, 1)
            print(f"{prefix}{name}: travs {c.travs}, "
                  f"trav_nodes {c.trav_nodes} ({per(c.trav_nodes):.2f}/ray), "
                  f"trav_prims {c.trav_prims} ({per(c.trav_prims):.2f}/ray), "
                  f"stack_overflows {c.stack_overflows}")


_stat = Stat()


def instance() -> Stat:
    return _stat


def stats_enabled() -> bool:
    return _stat.enabled


@atexit.register
def _print_at_exit() -> None:  # Stat prints at shutdown in the reference
    if _stat.enabled and (_stat.normal.travs or _stat.shadow.travs):
        print("embree_tpu ray statistics (EMBREE_TPU_STATS):")
        _stat.print("  ")
