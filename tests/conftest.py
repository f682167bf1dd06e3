"""Test configuration.

Tests run on a virtual 8-device CPU mesh with float64 enabled so that
numerical parity with the float64 reference implementation can be asserted
tightly. The environment variables must be set before jax is imported.

Set ``MF_TEST_X64=0`` to run with x64 DISABLED — the float32 production
configuration (what the GPU path runs). Tests that specifically assert
float64-parity behavior call ``require_x64()`` and skip there.
"""

import os

# The test suite runs on a virtual 8-device host mesh; MF_TEST_PLATFORM=cuda
# runs it on the GPU instead (for the tests marked ``gpu``).
_PLATFORM = os.environ.get("MF_TEST_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = _PLATFORM
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
_X64 = os.environ.get("MF_TEST_X64", "1") != "0"
os.environ["JAX_ENABLE_X64"] = "true" if _X64 else "false"

import jax  # noqa: E402

jax.config.update("jax_enable_x64", _X64)
jax.config.update("jax_platforms", _PLATFORM)

# Persistent XLA compilation cache for the suite, in the program's one
# cache directory (JAX_COMPILATION_CACHE_DIR, else .jax_cache in the
# checkout): wall time is dominated by one-time compiles of the df-scan
# programs, and caching them makes every later suite run warm. XLA:CPU
# executables are machine-feature sensitive, but a test cache is only ever
# read back on the machine that wrote it. Opt out with
# MF_TEST_NO_COMPILE_CACHE=1. The x64 flag is part of the program, so the
# f32 lane shares the same directory without conflicts.
if os.environ.get("MF_TEST_NO_COMPILE_CACHE") != "1":
    from microstructure_fingerprinting_tpu import compile_cache_dir  # noqa
    jax.config.update("jax_enable_compilation_cache", True)
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_FIXTURES = os.path.join(
    "/root", "reference", "tests", "integration", "fixtures")


def require_x64():
    """Skip the calling test under the float32 (MF_TEST_X64=0) lane."""
    if not jax.config.jax_enable_x64:
        pytest.skip("float64-parity test (x64 runtime only)")


def fixture_path(name):
    return os.path.join(REFERENCE_FIXTURES, name)


def has_fixture(name):
    return os.path.isfile(fixture_path(name))


@pytest.fixture
def rng():
    return np.random.RandomState(141414)


@pytest.fixture
def gpu():
    """The GPU, for tests marked ``gpu``; they skip where JAX runs on
    another backend (run them with MF_TEST_PLATFORM=cuda)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU; JAX runs on %s" % dev.platform)
    return dev


@pytest.fixture(autouse=True, scope="module")
def _free_compiled_executables():
    """Drop compiled executables between test modules.

    The suite JIT-compiles many large programs; keeping every
    executable alive for the whole session has produced segfaults in
    late-session XLA CPU compilations/executions once the accumulated
    JIT code crossed a process-level threshold. Modules rarely share
    compiled graphs, so per-module cache clearing costs little."""
    yield
    jax.clear_caches()
