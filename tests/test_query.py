"""generate_sdf tests: README examples, baseline cross-checks, topology."""
import numpy as np
import pytest

from mesh_to_sdf_tpu import (
    AccelerationMethod,
    SignMethod,
    Strategy,
    Topology,
    generate_sdf,
)
import baselines


def test_readme_single_triangle():
    """The reference doctest (`lib.rs:10-31`): sdf == [1.0]."""
    vertices = np.array([[0.5, 1.5, 0.5], [1.0, 2.0, 3.0], [1.0, 3.0, 7.0]], np.float32)
    indices = np.array([0, 1, 2], np.uint32)
    query = np.array([[0.5, 0.5, 0.5]], np.float32)
    sdf = np.asarray(
        generate_sdf(vertices, Topology.triangle_list(indices), query,
                     AccelerationMethod.rtree_bvh())
    )
    assert sdf.shape == (1,)
    assert abs(sdf[0] - 1.0) < 1e-6


def test_doc_example_lib_266():
    """`lib.rs:266-289`: distance from origin to triangle == 1.0."""
    vertices = np.array([[0.0, 1.0, 0.0], [1.0, 2.0, 3.0], [1.0, 3.0, 4.0]], np.float32)
    indices = np.array([0, 1, 2], np.uint32)
    query = np.array([[0.0, 0.0, 0.0]], np.float32)
    sdf = np.asarray(
        generate_sdf(vertices, Topology.triangle_list(indices), query,
                     AccelerationMethod.rtree_bvh())
    )
    assert abs(sdf[0] - 1.0) < 1e-6


@pytest.mark.parametrize("sign", ["raycast", "normal"])
def test_vs_numpy_baseline_sphere(rng, sign):
    verts, faces = baselines.make_icosphere(subdiv=1)
    queries = rng.uniform(-1.6, 1.6, size=(64, 3)).astype(np.float32)

    sdf = np.asarray(
        generate_sdf(
            verts, Topology.triangle_list(faces.reshape(-1)), queries,
            Strategy.XLA,
            sign_method=SignMethod.RAYCAST if sign == "raycast" else SignMethod.NORMAL,
        )
    )
    base = baselines.brute_sdf(verts, faces, queries, sign_method=sign)
    np.testing.assert_allclose(sdf, base, rtol=1e-4, atol=2e-5)


def test_raycast_sign_inside_outside_box(rng):
    verts, faces = baselines.make_box(size=(2.0, 2.0, 2.0))
    inside_pts = rng.uniform(-0.8, 0.8, size=(32, 3)).astype(np.float32)
    outside_pts = inside_pts + np.array([0.0, 0.0, 3.0], np.float32)
    sdf_in = np.asarray(
        generate_sdf(verts, Topology.triangle_list(faces.reshape(-1)), inside_pts,
                     Strategy.XLA, sign_method=SignMethod.RAYCAST)
    )
    sdf_out = np.asarray(
        generate_sdf(verts, Topology.triangle_list(faces.reshape(-1)), outside_pts,
                     Strategy.XLA, sign_method=SignMethod.RAYCAST)
    )
    assert np.all(sdf_in < 0)
    assert np.all(sdf_out > 0)
    # |sdf| of an inside point = distance to the nearest face
    expected = 1.0 - np.max(np.abs(inside_pts), axis=1)
    np.testing.assert_allclose(-sdf_in, expected, atol=1e-5)


def test_single_axis_raycast_matches_reference_default(rng):
    """raycast_axes=1 reproduces the None-backend single +X ray (`default.rs:36`)."""
    verts, faces = baselines.make_icosphere(subdiv=1)
    queries = rng.uniform(-1.5, 1.5, size=(32, 3)).astype(np.float32)
    sdf = np.asarray(
        generate_sdf(verts, Topology.triangle_list(faces.reshape(-1)), queries,
                     Strategy.XLA, sign_method=SignMethod.RAYCAST, raycast_axes=1)
    )
    base = baselines.brute_sdf(verts, faces, queries, sign_method="raycast",
                               raycast_axes=1)
    np.testing.assert_allclose(sdf, base, rtol=1e-4, atol=2e-5)


def test_topology_variants_equivalent(rng):
    """List/Strip × indices/None equivalence (`grid.rs:845-904`'s strategy)."""
    verts, faces = baselines.make_icosphere(subdiv=0)
    queries = rng.uniform(-1.5, 1.5, size=(16, 3)).astype(np.float32)

    flat = faces.reshape(-1)
    soup = verts[flat]  # un-indexed triangle soup

    a = generate_sdf(verts, Topology.triangle_list(flat), queries, Strategy.XLA)
    b = generate_sdf(soup, Topology.triangle_list(None), queries, Strategy.XLA)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)

    # Strip expansion: windows of 3
    strip_idx = np.array([0, 1, 2, 3], np.uint32)
    tri_windows = np.array([[0, 1, 2], [1, 2, 3]], np.uint32)
    c = generate_sdf(verts, Topology.triangle_strip(strip_idx), queries, Strategy.XLA)
    d = generate_sdf(verts, Topology.triangle_list(tri_windows.reshape(-1)), queries,
                     Strategy.XLA)
    np.testing.assert_allclose(np.asarray(c), np.asarray(d), atol=1e-6)


def test_u16_indices(rng):
    verts, faces = baselines.make_icosphere(subdiv=0)
    queries = rng.uniform(-1.5, 1.5, size=(8, 3)).astype(np.float32)
    a = generate_sdf(verts, Topology.triangle_list(faces.astype(np.uint16)), queries)
    b = generate_sdf(verts, Topology.triangle_list(faces.astype(np.uint32)), queries)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=0)


def test_empty_mesh():
    queries = np.zeros((4, 3), np.float32)
    sdf = np.asarray(
        generate_sdf(np.zeros((0, 3), np.float32), Topology.triangle_list(None),
                     queries, Strategy.XLA)
    )
    # No triangles → the fold init survives (`default.rs:45`).
    assert np.all(sdf == np.finfo(np.float32).max)


def test_list_remainder_dropped():
    """`.tuples()` drops a trailing partial triangle (`lib.rs:184-186`)."""
    verts = np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [5, 5, 5]], np.float32
    )
    idx_full = np.array([0, 1, 2], np.uint32)
    idx_extra = np.array([0, 1, 2, 3], np.uint32)  # remainder [3] dropped
    q = np.array([[0.0, 0.0, 1.0]], np.float32)
    a = generate_sdf(verts, Topology.triangle_list(idx_full), q, Strategy.XLA)
    b = generate_sdf(verts, Topology.triangle_list(idx_extra), q, Strategy.XLA)
    assert float(a[0]) == float(b[0])


def test_sign_grid_cache_distinguishes_bc_corners():
    """Two meshes sharing corner-0 vertices but different b/c corners must
    not collide in the content-hashed caches."""
    import mesh_to_sdf_tpu as m
    from mesh_to_sdf_tpu import query as qmod

    rng = np.random.default_rng(7)
    q = rng.normal(size=(8, 3)).astype(np.float32)
    v1, f = baselines.make_icosphere(2)
    v2 = v1.copy()
    # Perturb only vertices that never appear as corner 0.
    corner0 = set(np.asarray(f)[:, 0].tolist())
    others = [i for i in range(len(v2)) if i not in corner0]
    if not others:  # every vertex is a corner-0 somewhere: reorder faces
        f = np.asarray(f).copy()
        f[: len(f) // 2] = f[: len(f) // 2][:, [1, 2, 0]]
        corner0 = set(f[:, 0].tolist())
        others = [i for i in range(len(v2)) if i not in corner0]
    assert others, "fixture must have a non-corner-0 vertex"
    v2[others] *= 1.5

    topo = m.Topology.triangle_list(np.asarray(f).reshape(-1))
    ta1, tb1, tc1, valid, n = qmod.prepare_triangles(v1, topo, 256)
    ta2, tb2, tc2, _, _ = qmod.prepare_triangles(v2, topo, 256)
    # Directly compare the cache keys the two meshes produce.
    import zlib

    def key(ta, tb, tc):
        return (
            zlib.adler32(np.asarray(ta[:n]).tobytes()),
            zlib.adler32(np.asarray(tb[:n]).tobytes()),
            zlib.adler32(np.asarray(tc[:n]).tobytes()),
        )

    assert key(ta1, tb1, tc1) != key(ta2, tb2, tc2)
    # And corner-0 alone would have collided (the r2 bug shape).
    assert np.allclose(np.asarray(ta1[:n]), np.asarray(ta2[:n]))
