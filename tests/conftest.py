"""Test configuration: an 8-fake-device CPU platform (SURVEY.md §5.2
"Distributed without a cluster") so the full Mesh/shard_map/psum code path
runs in CI without GPUs. The Triton kernels run on the CPU only where a
test passes interpret=True.

The suite runs on the CPU unless JAX_PLATFORMS says otherwise. Tests that
need the card carry the `gpu` marker and take the `gpu` fixture, which
skips them when JAX's backend is not a GPU; on the card run them with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)
# The CLI's main() turns the persistent compile cache on; tests write none.
jax.config.update("jax_enable_compilation_cache", False)

import gc  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time,
    never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip(
            "needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/"
        )


@pytest.fixture(autouse=True, scope="module")
def _clear_compiled_program_caches():
    """Release compiled executables between test modules.

    The full suite compiles several hundred programs onto the 8-fake-device
    CPU client in one process, and the cached program factories
    (parallel.sharded, pipelines.pose_graph) keep their executables alive;
    without a release the XLA CPU client has crashed inside a later
    backend_compile. Clearing JAX's global compilation caches per module
    caps the number of live executables; cross-module shape reuse is
    minimal, so the recompile cost is noise."""
    yield
    jax.clear_caches()
    gc.collect()
