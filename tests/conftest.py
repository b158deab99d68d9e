"""Test configuration.

Tests run on CPU with 8 virtual XLA devices so multi-device sharding paths
(shard_map + halo exchange over a Mesh) are exercised without accelerator
hardware — the standard JAX trick of --xla_force_host_platform_device_count.
Tests that need an NVIDIA GPU carry the ``gpu`` marker and skip on the CPU
(the ``gpu_device`` fixture decides while the test runs).
This must happen before jax is imported anywhere.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# The CPU unless the caller picked a platform: `JAX_PLATFORMS=cuda pytest -m
# gpu` runs the GPU tests on a card.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import reforge_tpu.utils as utils  # noqa: E402

# Don't spam stderr with expected warnings during negative-path tests;
# warnings are still recorded and assertable via utils.recent_warnings().
utils.print_warnings = False

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _clear_warnings():
    utils.clear_warnings()
    yield


@pytest.fixture
def gpu_device():
    """The first JAX device when it is an NVIDIA GPU; skips otherwise.

    Decided here, while the test runs, never at import or collection: every
    xdist worker must collect the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX device: {dev.platform})")
    return dev


# ---- fast-by-default selection -------------------------------------------
#
# The full suite takes ~7.5 min on a 1-core box; the default run deselects
# the randomized fuzz suites (`fuzz`) and the individually heavy tests
# (`slow`, measured > ~2.5 s with --durations) so iteration stays < 2 min.
# `pytest -q -m ""` runs everything.  Centralized here (rather than inline
# decorators) because several entries are single parametrize cases.
_SLOW = [
    "test_goldens.py::test_goldens",
    "test_goldens.py::test_shader_goldens",
    "test_goldens.py::test_builtin_kernel_goldens",
    "test_kernels.py::TestNumerics::test_all_kernels_trace",
    "test_kernels.py::TestNumerics::test_gaussian_preserves_constant",
    "test_kernels.py::TestEdgePreservingKernels::test_bilateral_preserves_step_edge",
    "test_kernels.py::TestArtisticKernels::test_kuwahara_flat_preserved",
    "test_kernels.py::TestStylizedKernels::test_halftone_black_and_white_extremes",
    "test_graph.py::TestExecution::test_branching_equals_manual",
    "test_parallel.py::TestHaloSharding::test_matches_single_device[edge_preserving]",
    "test_parallel.py::TestHaloSharding::test_ssbo_pipeline_sharded",
    "test_parallel.py::TestGspmdSharding::test_matches_single_device",
    "test_parity.py::TestConvParity::test_gaussian",
    "test_parity.py::TestConvParity::test_unsharp",
    "test_parity.py::TestConvParity::test_box_blur",
    "test_ssbo.py::TestSharded::test_histogram_pipeline_sharded",
]


def pytest_collection_modifyitems(config, items):
    for item in items:
        rel = item.nodeid.split("/")[-1]
        if rel.startswith("test_fuzz.py::"):
            item.add_marker(pytest.mark.fuzz)
            continue
        for entry in _SLOW:
            if rel == entry or rel.startswith(entry + "[") or rel.startswith(entry + "::"):
                item.add_marker(pytest.mark.slow)
                break
