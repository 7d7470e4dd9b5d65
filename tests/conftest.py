"""Test configuration: force an 8-device CPU mesh so multi-device
sharding paths compile and execute without accelerators (SURVEY.md §4.4
analog of the reference's multi-thread commit-join stress tests).

Tests of code that only runs on a GPU take the `gpu` fixture (marker
`gpu`), which skips them here; run them on a card with
`EMBREE_TESTS_ON_GPU=1 python -m pytest -m gpu tests/`. The `twin_kernel` fixture runs the
CUDA kernel's path on the CPU with its NumPy twin in place of the
kernel."""
import os

# EMBREE_TESTS_ON_GPU=1 keeps JAX's own backend (the card) for `-m gpu`
ON_GPU = os.environ.get("EMBREE_TESTS_ON_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

assert ON_GPU or jax.default_backend() == "cpu"

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skips unless JAX's default backend is a GPU (decided at run time,
    never at import, so every worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no interpret mode)")


@pytest.fixture
def twin_kernel(monkeypatch):
    """Select the CUDA kernel path as on a GPU, with traverse/gpu.py's
    NumPy twin standing in for the FFI call."""
    from embree_tpu.traverse import gpu as gpu_mod
    monkeypatch.setattr(gpu_mod, "_platform", lambda: "gpu")
    monkeypatch.setattr(gpu_mod, "_kernel_call", gpu_mod.twin_call)
    yield gpu_mod


@pytest.fixture
def rng():
    return np.random.default_rng(0x5EED)


# Quick tier (VERDICT r4 #10): a <5-min correctness smoke covering every
# layer — API, builders, both traversal families, cBVH, subdiv, diff,
# dist — selected per-module. The full matrix stays for CI.
_QUICK_MODULES = {
    "test_api", "test_build", "test_intersect", "test_pluecker",
    "test_cbvh", "test_node_flavors", "test_subdiv", "test_diff",
    "test_filter", "test_mask_cull", "test_stats", "test_rtcore",
    "test_triangle_geometry", "test_user_builder", "test_rotate",
}


def pytest_collection_modifyitems(items):
    for item in items:
        if item.module.__name__ in _QUICK_MODULES:
            item.add_marker(pytest.mark.quick)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """The full suite segfaults deterministically in XLA:CPU when one
    process accumulates ~250 compiled executables and then traces a
    large program (observed after the full alphabetical prefix; neither
    half of the suite alone reproduces it). Dropping
    compiled-program caches between modules keeps the client far from
    the cliff; intra-module reuse (the expensive fixtures) is kept."""
    yield
    import jax

    jax.clear_caches()
