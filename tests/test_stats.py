"""STAT3 counter tests (kernels/common/stat.h EMBREE_STAT_COUNTERS)."""
import numpy as np

import embree_tpu as et
from embree_tpu.core import stats as st
from embree_tpu.verify.fixtures import triangle_sphere


def test_stat_counters_accumulate(twin_kernel):
    """The kernel path's per-block counters (NumPy twin in place of the
    CUDA kernel) accumulate into the STAT3 table."""
    verts, idx = triangle_sphere((0, 0, 0), 1.0, 8)
    dev = et.Device("ignore_config_files=1,isa=cuda")
    scene = et.Scene(dev)
    scene.attach(et.TriangleMesh(verts, idx))
    scene.commit()

    s = st.instance()
    s.clear()
    s.enable(True)
    try:
        n = 256
        rng = np.random.default_rng(3)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        org = np.tile(np.float32([0, 0, -3]), (n, 1)) \
            + rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
        scene.intersect(et.make_rays(org, d))
        scene.occluded(et.make_rays(org, d))
        assert s.normal.travs == n
        assert s.shadow.travs == n
        assert s.normal.trav_nodes > 0
        assert s.normal.trav_prims > 0
        assert s.shadow.trav_nodes > 0
        assert s.normal.stack_overflows == 0
        s.print("  ")  # smoke: the shutdown report formatter
    finally:
        s.enable(False)
        s.clear()
