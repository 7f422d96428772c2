"""Slab-streamed grid generation (bounded-memory path for huge grids)."""
import numpy as np
import pytest

from baselines import make_icosphere
from mesh_to_sdf_tpu import (
    Grid,
    SignMethod,
    Strategy,
    Topology,
    generate_grid_sdf,
)
from mesh_to_sdf_tpu.gridgen_streamed import generate_grid_sdf_streamed


@pytest.fixture(scope="module")
def setup():
    v, f = make_icosphere(subdiv=2)
    g = Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [32, 16, 16])
    return v, f, g


def test_streamed_matches_cpt(setup):
    v, f, g = setup
    topo = Topology.triangle_list(f.reshape(-1))
    ref = np.asarray(
        generate_grid_sdf(v, topo, g, SignMethod.RAYCAST, strategy=Strategy.CPT)
    )
    got = generate_grid_sdf_streamed(v, f, g, SignMethod.RAYCAST, slab_nx=8)
    assert (np.sign(got) == np.sign(ref)).all()
    np.testing.assert_allclose(got, ref, atol=3e-3)


def test_streamed_normal_sign(setup):
    v, f, g = setup
    topo = Topology.triangle_list(f.reshape(-1))
    ref = np.asarray(
        generate_grid_sdf(v, topo, g, SignMethod.NORMAL, strategy=Strategy.CPT)
    )
    got = generate_grid_sdf_streamed(v, f, g, SignMethod.NORMAL, slab_nx=8)
    np.testing.assert_allclose(np.abs(got), np.abs(ref), atol=3e-3)
    assert (np.sign(got) != np.sign(ref)).mean() <= 0.01


def test_streamed_bad_slab(setup):
    v, f, g = setup
    with pytest.raises(ValueError, match="multiple"):
        generate_grid_sdf_streamed(v, f, g, slab_nx=5)


def test_slab_sign_matches_in_core_parity():
    """Each slab's sign (all three parities slab-local, x counted as the
    suffix of hits beyond each cell, including hits past the slab) equals
    the in-core grid parity restricted to that slab."""
    import jax.numpy as jnp

    from mesh_to_sdf_tpu.gridgen_streamed import _slab_sign_raycast
    from mesh_to_sdf_tpu.ops import raycast

    v, f = make_icosphere(subdiv=2)
    oa, ob, oc = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    grid = Grid.from_bounding_box([-1.4] * 3, [1.4] * 3, [16, 12, 12])
    orig = jnp.asarray(np.stack([oa, ob, oc]))
    want = np.asarray(raycast.grid_inside_mask(
        grid, orig[0], orig[1], orig[2], jnp.ones((len(f),), bool),
        tri_block=256))
    slab_nx = 4
    cs = jnp.asarray(grid.cell_size)
    dist = jnp.ones((slab_nx, 12, 12), jnp.float32)
    for i in range(16 // slab_nx):
        fc = jnp.asarray(grid.first_cell) + jnp.asarray(
            [i * slab_nx, 0, 0], jnp.float32) * cs
        got = np.asarray(
            _slab_sign_raycast(fc, cs, (slab_nx, 12, 12), dist, orig)) < 0
        np.testing.assert_array_equal(
            got, want[i * slab_nx:(i + 1) * slab_nx])
