"""The dense-engine selection point (ops/dense.py), the compile-cache rule
and the smoke script's refusal to run without a GPU."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from baselines import make_icosphere
from mesh_to_sdf_tpu import SignMethod, Strategy
from mesh_to_sdf_tpu.ops import brute, dense

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,want", [
    ("gpu", Strategy.PALLAS), ("cpu", Strategy.XLA)])
def test_dense_strategy_per_platform(monkeypatch, platform, want):
    monkeypatch.setattr(dense.jax, "default_backend", lambda: platform)
    assert dense.dense_strategy() == want


@pytest.mark.parametrize("platform", ["rocm", "metal"])
def test_dense_strategy_unknown_platform_raises(monkeypatch, platform):
    monkeypatch.setattr(dense.jax, "default_backend", lambda: platform)
    with pytest.raises(RuntimeError, match=platform):
        dense.dense_strategy()


def test_require_kernel_raises_on_cpu():
    with pytest.raises(ValueError, match="GPU"):
        dense.require_kernel()


@pytest.fixture(scope="module")
def soup():
    v, f = make_icosphere(subdiv=2)
    return tuple(jnp.asarray(v[f[:, k]]) for k in range(3))


@pytest.mark.parametrize("sign,axes", [
    (SignMethod.RAYCAST, 3), (SignMethod.RAYCAST, 0), (SignMethod.NORMAL, 3)])
def test_signed_distance_pads_and_masks(soup, sign, axes):
    """Unpadded soups, padded soups with ``n_valid`` and odd query counts
    all give the brute-force answer."""
    ta, tb, tc = soup
    q = jnp.asarray(np.random.default_rng(0).uniform(
        -1.4, 1.4, (333, 3)).astype(np.float32))
    T = ta.shape[0]
    want = np.asarray(brute.sdf_brute(
        q, ta, tb, tc, jnp.ones((T,), bool), sign_method=sign,
        raycast_axes=axes, tri_block=T, query_chunk=333))
    got = np.asarray(dense.signed_distance(
        q, ta, tb, tc, sign_method=sign, raycast_axes=axes))
    np.testing.assert_array_equal(got, want)
    pad = jnp.zeros((61, 3), jnp.float32)
    padded = [jnp.concatenate([x, pad]) for x in (ta, tb, tc)]
    got = np.asarray(dense.signed_distance(
        q, *padded, sign_method=sign, raycast_axes=axes, n_valid=T))
    np.testing.assert_array_equal(got, want)


def test_crossing_counts_match_parity_sweep(soup):
    from mesh_to_sdf_tpu.ops import culling

    ta, tb, tc = soup
    q = jnp.asarray(np.random.default_rng(1).uniform(
        -1.4, 1.4, (200, 3)).astype(np.float32))
    got = np.asarray(dense.crossing_counts(q, ta, tb, tc, raycast_axes=3))
    want = np.asarray(culling._ray_parity_counts(
        q, ta, tb, tc, jnp.ones((ta.shape[0],), bool), 3))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (200, 3)


def test_compile_cache_env_set_is_left_alone(monkeypatch):
    from mesh_to_sdf_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    assert compile_cache.configure_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_checkout_dir(monkeypatch):
    from mesh_to_sdf_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.configure_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_refuses_cpu(tmp_path):
    """Without a GPU the smoke script exits non-zero and prints no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=120,
                       cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding only chip_smoke.py cannot pass for the repo."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, env=env, timeout=120, cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_auto_constants_per_platform(monkeypatch, platform):
    from mesh_to_sdf_tpu import gridgen

    for k in ("M2S_AUTO_CALIBRATE", "M2S_AUTO_DENSE_PAIRS_PER_S",
              "M2S_AUTO_CPT_OVERHEAD_S", "M2S_AUTO_CPT_CELLS_PER_S"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(gridgen, "_AUTO_CAL_CACHE", {})
    monkeypatch.setattr(gridgen.jax, "default_backend", lambda: platform)
    assert gridgen._auto_constants() == gridgen._AUTO_DEFAULTS[platform]


def test_auto_constants_unknown_platform_raises(monkeypatch):
    from mesh_to_sdf_tpu import gridgen

    monkeypatch.setattr(gridgen.jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="AUTO"):
        gridgen._auto_constants()
