"""Grid line parity (ops/raycast.py) and CPT sweep contracts.

The XLA line parity is the only grid sign engine: its per-cell counts must
equal +axis ray parity cast from each cell center (brute force), including
depth complexities that exceed any fixed per-line bucket budget.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from baselines import make_icosphere, make_box
from mesh_to_sdf_tpu import Grid, SignMethod
from mesh_to_sdf_tpu.ops import brute, culling
from mesh_to_sdf_tpu.ops import cpt as cpt_mod
from mesh_to_sdf_tpu.ops import raycast as raycast_mod


def _soup(verts, faces):
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces)
    return (
        jnp.asarray(v[f[:, 0]]),
        jnp.asarray(v[f[:, 1]]),
        jnp.asarray(v[f[:, 2]]),
    )


def _per_cell_inside(grid, ta, tb, tc, axes):
    """Brute-force parity: +axis rays cast from every cell center."""
    centers = grid.all_cell_centers().reshape(-1, 3)
    valid = jnp.ones((ta.shape[0],), bool)
    counts = np.asarray(
        culling._ray_parity_counts(centers, ta, tb, tc, valid, axes)
    )
    odd = counts % 2 == 1
    inside = odd[:, 0] if axes == 1 else odd.sum(axis=1) >= 2
    return inside.reshape(grid.cell_count)


def _sheet_stack(n_sheets):
    """n_sheets parallel unit quads perpendicular to +X at distinct x: a +X
    ray crosses n_sheets distinct cell buckets within one triangle block."""
    tris = []
    for i in range(n_sheets):
        x = 0.1 + 0.08 * i
        a, b, c, d = (
            [x, -1, -1], [x, 1, -1], [x, 1, 1], [x, -1, 1],
        )
        tris.append([a, b, c])
        tris.append([a, c, d])
    t = np.asarray(tris, np.float32)
    return jnp.asarray(t[:, 0]), jnp.asarray(t[:, 1]), jnp.asarray(t[:, 2])


@pytest.mark.parametrize("n_sheets", [12, 20])
def test_parity_on_stacked_sheets(n_sheets):
    """Deep depth complexity (every sheet in its own bucket, some beyond the
    grid): the exact XLA parity needs no overflow handling."""
    ta, tb, tc = _sheet_stack(n_sheets)
    grid = Grid.from_bounding_box([0.0, -0.5, -0.5], [1.2, 0.5, 0.5],
                                  [16, 4, 4])
    valid = jnp.ones((ta.shape[0],), bool)
    got = np.asarray(raycast_mod.grid_inside_mask(
        grid, ta, tb, tc, valid, tri_block=24, axes=1))
    np.testing.assert_array_equal(got, _per_cell_inside(grid, ta, tb, tc, 1))
    # Inside iff an odd number of sheets lies beyond the cell center.
    assert got.any() and not got.all()


def test_parity_single_axis_mode():
    """axes=1 (+X only — the reference default backend, `default.rs:34-37`)
    == per-cell brute parity."""
    verts, faces = make_icosphere(subdiv=2)
    ta, tb, tc = _soup(verts, faces)
    grid = Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [12, 12, 12])
    valid = jnp.ones((ta.shape[0],), bool)
    got = np.asarray(raycast_mod.grid_inside_mask(
        grid, ta, tb, tc, valid, tri_block=256, axes=1))
    np.testing.assert_array_equal(got, _per_cell_inside(grid, ta, tb, tc, 1))


@pytest.mark.parametrize("shape", [(16, 16, 12), (9, 14, 11)])
def test_parity_three_axes_matches_per_cell(shape):
    """Best-of-3 voting on a torus (genus 1) on non-cubic grids."""
    from mesh_to_sdf_tpu.utils.meshgen import torus

    ta, tb, tc = _soup(*torus(1.0, 0.35, n_major=24, n_minor=12))
    grid = Grid.from_bounding_box([-1.6] * 3, [1.6] * 3, list(shape))
    valid = jnp.ones((ta.shape[0],), bool)
    got = np.asarray(raycast_mod.grid_inside_mask(
        grid, ta, tb, tc, valid, tri_block=64))
    np.testing.assert_array_equal(got, _per_cell_inside(grid, ta, tb, tc, 3))


def _exact_unsigned(grid, ta, tb, tc):
    centers = grid.all_cell_centers().reshape(-1, 3)
    valid = jnp.ones((ta.shape[0],), bool)
    ta_p, tb_p, tc_p, valid_p, blk = brute.pad_tri_blocks(
        ta, tb, tc, valid, 512)
    return np.asarray(brute.sdf_brute(
        centers, ta_p, tb_p, tc_p, valid_p,
        sign_method=SignMethod.RAYCAST, raycast_axes=0,
        tri_block=blk, query_chunk=centers.shape[0],
    )).reshape(grid.cell_count)


@pytest.mark.parametrize("mesh_fn,grid_shape", [
    (lambda: make_icosphere(subdiv=2), (16, 16, 12)),   # non-cubic
    (lambda: make_box(size=(1.6, 1.0, 0.8)), (10, 14, 12)),
])
def test_sweep_indices_achieve_distance(mesh_fn, grid_shape):
    """Non-cubic grids run the sequential (Gauss-Seidel) sweep schedule:
    every reported triangle index re-evaluates exactly to the reported
    distance, which never undershoots the exact reduction."""
    from mesh_to_sdf_tpu.ops import geometry

    ta, tb, tc = _soup(*mesh_fn())
    grid = Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, list(grid_shape))
    d, idx = cpt_mod.closest_point_grid(grid, ta, tb, tc)
    centers = grid.all_cell_centers().reshape(-1, 3)
    safe = jnp.maximum(idx.reshape(-1), 0)
    d_re = geometry.point_triangle_distance(
        centers, ta[safe], tb[safe], tc[safe])
    np.testing.assert_allclose(np.asarray(d_re), np.asarray(d).reshape(-1),
                               rtol=2e-4, atol=1e-5)
    exact = _exact_unsigned(grid, ta, tb, tc)
    assert np.all(np.asarray(d) >= exact - 1e-4)


def test_sweep_contract_vs_exact_cubic():
    """Cubic grid (batched Jacobi schedule): the CPT contract vs the exact
    dense reduction (never undershoots; ≤2% relative in the far field)."""
    verts, faces = make_icosphere(subdiv=2)
    ta, tb, tc = _soup(verts, faces)
    grid = Grid.from_bounding_box([-1.4] * 3, [1.4] * 3, [16, 16, 16])
    d, _ = cpt_mod.closest_point_grid(grid, ta, tb, tc)
    exact = _exact_unsigned(grid, ta, tb, tc)
    got = np.asarray(d)
    assert np.all(got >= exact - 1e-4)
    rel = np.abs(got - exact) / np.maximum(exact, 1e-3)
    assert rel.max() < 0.02, rel.max()
