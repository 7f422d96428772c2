"""Test configuration: 8-virtual-device CPU platform.

This is the stand-in for multi-device testing without several GPUs
(SURVEY.md §4): sharding/collective tests run on a virtual 8-device CPU mesh.
``jax.config.update`` also pins the platform in case jax was imported before
this file ran; XLA_FLAGS is read when the CPU client is created.
"""
import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()
os.environ["JAX_PLATFORMS"] = "cpu"
# Tests opt in to building the native library (it is not in version control).
os.environ.setdefault("M2S_NATIVE_BUILD", "1")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(20260816)


@pytest.fixture(autouse=True)
def _clear_culled_route_cache():
    """The culled engine self-tunes per (mesh-shape, batch) routing from
    measured work fractions; clear between tests so one test's recorded
    decision can't silently reroute another test away from the code path
    it means to exercise."""
    yield
    try:
        from mesh_to_sdf_tpu.ops import culling

        culling._ROUTE_CACHE.clear()
    except ImportError:
        pass
