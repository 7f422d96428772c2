"""Triton-route Pallas kernel vs the XLA engine (interpret mode on CPU).

The cross-backend strategy of the reference (SURVEY.md §4.3): every
accelerated path is validated against a slower trusted one on real meshes.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from baselines import make_icosphere
from mesh_to_sdf_tpu import (
    AccelerationMethod,
    SignMethod,
    Strategy,
    Topology,
    generate_sdf,
)
from mesh_to_sdf_tpu.ops.kernels import pallas_sdf


@pytest.fixture(scope="module")
def mesh():
    return make_icosphere(subdiv=2)


@pytest.fixture(scope="module")
def queries():
    rng = np.random.default_rng(7)
    return rng.uniform(-1.5, 1.5, (700, 3)).astype(np.float32)


def _tris(mesh):
    v, f = mesh
    return (
        jnp.asarray(v[f[:, 0]]),
        jnp.asarray(v[f[:, 1]]),
        jnp.asarray(v[f[:, 2]]),
    )


def test_raycast_matches_xla(mesh, queries):
    v, f = mesh
    topo = Topology.triangle_list(f.reshape(-1))
    ref = np.asarray(
        generate_sdf(v, topo, queries, AccelerationMethod.none(SignMethod.RAYCAST))
    )
    ta, tb, tc = _tris(mesh)
    got = np.asarray(
        pallas_sdf.sdf_raycast_pallas(
            jnp.asarray(queries), ta, tb, tc, raycast_axes=1, interpret=True
        )
    )
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_raycast3_matches_xla(mesh, queries):
    v, f = mesh
    topo = Topology.triangle_list(f.reshape(-1))
    ref = np.asarray(
        generate_sdf(v, topo, queries, AccelerationMethod.none(SignMethod.RAYCAST))
    )
    ta, tb, tc = _tris(mesh)
    got = np.asarray(
        pallas_sdf.sdf_raycast_pallas(
            jnp.asarray(queries), ta, tb, tc, raycast_axes=3, interpret=True
        )
    )
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_normal_matches_xla(mesh, queries):
    v, f = mesh
    topo = Topology.triangle_list(f.reshape(-1))
    ref = np.asarray(
        generate_sdf(v, topo, queries, AccelerationMethod.none(SignMethod.NORMAL))
    )
    ta, tb, tc = _tris(mesh)
    got = np.asarray(
        pallas_sdf.sdf_normal_pallas(
            jnp.asarray(queries), ta, tb, tc, interpret=True
        )
    )
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_unsigned_grid_mode(mesh, queries):
    """raycast_axes=0 returns the unsigned distance (grid distance pass)."""
    v, f = mesh
    ta, tb, tc = _tris(mesh)
    got = np.asarray(
        pallas_sdf.sdf_raycast_pallas(
            jnp.asarray(queries), ta, tb, tc, raycast_axes=0, interpret=True
        )
    )
    topo = Topology.triangle_list(f.reshape(-1))
    ref = np.abs(
        np.asarray(
            generate_sdf(v, topo, queries, AccelerationMethod.none(SignMethod.RAYCAST))
        )
    )
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert (got >= 0).all()


def test_degenerate_triangles(queries):
    """Degenerate (segment/point) triangles match the XLA ladder exactly."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((64, 3)).astype(np.float32)
    b = a.copy()  # b == a → segment [a, c]
    c = rng.standard_normal((64, 3)).astype(np.float32)
    b[32:] = c[32:]  # b == c → segment [a, b]
    c[48:] = a[48:]  # all equal → vertex a
    b[48:] = a[48:]

    from mesh_to_sdf_tpu.ops import geometry

    q = queries[:100]
    ref = np.asarray(
        geometry.point_triangle_distance(
            q[:, None, :], a[None], b[None], c[None]
        ).min(axis=1)
    )
    got = np.asarray(
        pallas_sdf.sdf_raycast_pallas(
            jnp.asarray(q),
            jnp.asarray(a),
            jnp.asarray(b),
            jnp.asarray(c),
            raycast_axes=0,
            interpret=True,
        )
    )
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_pad_tail_is_neutral(mesh):
    """Triangle counts not divisible by the block size give identical results
    (PAD_COORD sentinel rows must never win a champion or cross a ray)."""
    v, f = mesh
    ta, tb, tc = _tris(mesh)
    q = np.asarray([[0.3, 0.2, 0.1], [2.0, 1.5, 0.7]], np.float32)
    full = np.asarray(
        pallas_sdf.sdf_raycast_pallas(
            jnp.asarray(q), ta, tb, tc, raycast_axes=1, interpret=True
        )
    )
    odd = 321  # not a multiple of anything relevant
    got = np.asarray(
        pallas_sdf.sdf_raycast_pallas(
            jnp.asarray(q), ta[:odd], tb[:odd], tc[:odd], raycast_axes=1,
            interpret=True,
        )
    )
    assert np.isfinite(got).all()
    # With fewer triangles the sphere is open: distances must be >= full-mesh
    # unsigned distances (removing triangles can only increase distance).
    assert (np.abs(got) + 1e-5 >= np.abs(full) - 1e-5).all()


def test_generate_sdf_pallas_strategy(mesh, queries):
    """Strategy.PALLAS through the public API: the kernel is compiled for
    the GPU only, so on the CPU an explicit request raises (no hidden
    interpreter) while AUTO and XLA take the XLA engine."""
    v, f = mesh
    topo = Topology.triangle_list(f.reshape(-1))
    with pytest.raises(ValueError, match="GPU"):
        generate_sdf(v, topo, queries, Strategy.PALLAS)
    with pytest.raises(ValueError, match="GPU"):
        generate_sdf(v, topo, queries, AccelerationMethod.bvh())
    ref = np.asarray(
        generate_sdf(v, topo, queries, Strategy.XLA, sign_method=SignMethod.RAYCAST)
    )
    auto = np.asarray(generate_sdf(v, topo, queries))
    np.testing.assert_array_equal(auto, ref)


def test_generate_grid_sdf_pallas_strategy_raises(mesh):
    from mesh_to_sdf_tpu import Grid, generate_grid_sdf

    v, f = mesh
    topo = Topology.triangle_list(f.reshape(-1))
    g = Grid.from_bounding_box([-1.2] * 3, [1.2] * 3, [4, 4, 4])
    with pytest.raises(ValueError, match="GPU"):
        generate_grid_sdf(v, topo, g, strategy=Strategy.PALLAS)


def _brute_signed(q, ta, tb, tc, sign, axes):
    from mesh_to_sdf_tpu.ops import dense

    return np.asarray(dense.signed_distance(
        jnp.asarray(q), ta, tb, tc, sign_method=sign, raycast_axes=axes))


@pytest.mark.parametrize("axes", [0, 1, 3])
@pytest.mark.parametrize("n_q,n_t", [(1, 1), (33, 77), (70, 320)])
def test_kernel_raycast_ragged_shapes(mesh, axes, n_q, n_t):
    """Query and triangle counts that fill neither a query tile nor a
    triangle block: the padded tails must never win or cross."""
    ta, tb, tc = (x[:n_t] for x in _tris(mesh))
    q = np.random.default_rng(n_q).uniform(-1.4, 1.4, (n_q, 3)).astype(
        np.float32)
    got = np.asarray(pallas_sdf.sdf_raycast_pallas(
        jnp.asarray(q), ta, tb, tc, raycast_axes=axes, interpret=True))
    want = _brute_signed(q, ta, tb, tc, SignMethod.RAYCAST, axes)
    assert got.shape == (n_q,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_kernel_parts_match_brute_counts(mesh, queries):
    """Pre-vote outputs: unsigned distance + per-axis crossing counts."""
    from mesh_to_sdf_tpu.ops import culling

    ta, tb, tc = _tris(mesh)
    q = jnp.asarray(queries[:200])
    dist, counts = pallas_sdf.sdf_raycast_parts_pallas(
        q, ta, tb, tc, raycast_axes=3, interpret=True)
    valid = jnp.ones((ta.shape[0],), bool)
    want = np.asarray(culling._ray_parity_counts(q, ta, tb, tc, valid, 3))
    np.testing.assert_array_equal(np.asarray(counts), want)
    np.testing.assert_allclose(
        np.asarray(dist),
        np.abs(_brute_signed(queries[:200], ta, tb, tc, SignMethod.RAYCAST, 0)),
        rtol=1e-5, atol=1e-5)


def test_kernel_normal_champions(mesh, queries):
    """Champions (min positive, min |negative|) recombine to the NORMAL
    signed distance of the XLA engine."""
    from mesh_to_sdf_tpu.ops.keyed import combine_champions

    ta, tb, tc = _tris(mesh)
    q = queries[:150]
    mp, mn = pallas_sdf.sdf_normal_champions_pallas(
        jnp.asarray(q), ta, tb, tc, interpret=True)
    assert (np.asarray(mp) >= 0).all() and (np.asarray(mn) >= 0).all()
    np.testing.assert_allclose(
        np.asarray(combine_champions(mp, mn)),
        _brute_signed(q, ta, tb, tc, SignMethod.NORMAL, 3),
        rtol=1e-5, atol=1e-5)


def test_kernel_tiles_do_not_change_results(mesh, queries):
    """Tile and warp choices are performance knobs only."""
    ta, tb, tc = _tris(mesh)
    q = jnp.asarray(queries[:100])
    base = np.asarray(pallas_sdf.sdf_raycast_pallas(
        q, ta, tb, tc, interpret=True))
    other = np.asarray(pallas_sdf.sdf_raycast_pallas(
        q, ta, tb, tc, tq=16, tb_block=64, num_warps=8, interpret=True))
    np.testing.assert_array_equal(other, base)


def test_kernel_names_triton_backend(mesh, queries):
    """The kernel lowers for CUDA through the Triton route (checked here by
    cross-platform lowering; compiling needs the GPU)."""
    import jax

    ta, tb, tc = _tris(mesh)
    q = jnp.asarray(queries[:64])
    lowered = jax.jit(
        lambda *a: pallas_sdf.sdf_raycast_pallas(*a)
    ).trace(q, ta, tb, tc).lower(lowering_platforms=("cuda",))
    assert "m2s_sdf_raycast" in lowered.as_text()
