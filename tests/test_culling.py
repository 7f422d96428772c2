"""Strategy.CULLED tests — the analog of the reference's Rtree/RtreeBvh
backends (`rtree.rs:96-126`, `bvh_ext.rs:59-168`, `rtree_bvh.rs:123-173`).

Coverage: the real candidate path above the brute-fallback threshold, the
overflow → widened-k retry (exactness under dense tiles), the grid variant
vs the dense engine, and the select_candidates bound semantics.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import mesh_to_sdf_tpu as m
from mesh_to_sdf_tpu import Grid, SignMethod, Strategy, Topology
from mesh_to_sdf_tpu.ops import block_index, culling
from mesh_to_sdf_tpu.query import prepare_triangles

from baselines import make_icosphere


@pytest.fixture(scope="module")
def big_sphere():
    # subdiv=4 → 5120 triangles: above the T ≤ 2k fallback threshold, so the
    # real culled path runs.
    return make_icosphere(subdiv=4)


def _tris(verts, faces):
    topo = Topology.triangle_list(faces.reshape(-1))
    return prepare_triangles(verts, topo, 512)


def test_query_culled_matches_xla(big_sphere, rng):
    verts, faces = big_sphere
    topo = Topology.triangle_list(faces.reshape(-1))
    q = rng.uniform(-1.4, 1.4, (1500, 3)).astype(np.float32)
    for sign in (SignMethod.RAYCAST, SignMethod.NORMAL):
        exact = np.asarray(
            m.generate_sdf(verts, topo, q, Strategy.XLA, sign_method=sign)
        )
        culled = np.asarray(
            m.generate_sdf(verts, topo, q, Strategy.CULLED, sign_method=sign)
        )
        np.testing.assert_allclose(culled, exact, rtol=1e-5, atol=1e-6,
                                   err_msg=str(sign))


def test_query_culled_overflow_retry_is_exact(big_sphere, rng):
    """A tiny k forces overflow; the per-tile dense recompute must restore
    exactness."""
    verts, faces = big_sphere
    ta, tb, tc, valid, _ = _tris(verts, faces)
    q = jnp.asarray(rng.uniform(-1.3, 1.3, (600, 3)).astype(np.float32))

    # Verify the small-k pass alone is genuinely flagged as unreliable.
    _, q_ovf = culling._query_culled_dist(
        q, ta, tb, tc, valid, sign_method=SignMethod.NORMAL, k=8, tile=256
    )
    assert q_ovf is not None and int(jnp.sum(q_ovf)) > 0

    got = np.asarray(
        culling.query_sdf_culled(
            q, ta, tb, tc, valid,
            sign_method=SignMethod.NORMAL, k=8, tile=256,
        )
    )
    want = np.asarray(
        m.generate_sdf(
            verts, Topology.triangle_list(faces.reshape(-1)), np.asarray(q),
            Strategy.XLA, sign_method=SignMethod.NORMAL,
        )
    )
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_grid_culled_matches_dense(big_sphere):
    verts, faces = big_sphere
    topo = Topology.triangle_list(faces.reshape(-1))
    grid = Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [12, 14, 10])
    for sign in (SignMethod.RAYCAST, SignMethod.NORMAL):
        dense = np.asarray(
            m.generate_grid_sdf(verts, topo, grid, sign, strategy=Strategy.XLA)
        )
        culled = np.asarray(
            m.generate_grid_sdf(verts, topo, grid, sign,
                                strategy=Strategy.CULLED)
        )
        np.testing.assert_allclose(culled, dense, rtol=1e-5, atol=1e-6,
                                   err_msg=str(sign))


def test_grid_culled_small_k_retry(big_sphere):
    """Direct grid-culled call with a pathologically small k stays exact."""
    verts, faces = big_sphere
    ta, tb, tc, valid, _ = _tris(verts, faces)
    grid = Grid.from_bounding_box([-1.2] * 3, [1.2] * 3, [9, 9, 9])
    got = np.asarray(
        culling.grid_distance_culled(
            grid, ta, tb, tc, valid, sign=SignMethod.RAYCAST, k=4
        )
    )
    centers = grid.all_cell_centers().reshape(-1, 3)
    from mesh_to_sdf_tpu.ops import brute

    want = np.asarray(
        brute.sdf_brute(
            centers, ta, tb, tc, valid,
            sign_method=SignMethod.RAYCAST, raycast_axes=0,
            query_chunk=centers.shape[0],
        )
    ).reshape(grid.cell_count)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_select_candidates_bound_semantics():
    """Triangles beyond the bound must be prunable; within-bound counted."""
    # Triangles on a line: one near the tile, the rest far away.
    ta = np.array([[0.0, 0, 0], [10, 0, 0], [11, 0, 0], [12, 0, 0]], np.float32)
    tb = ta + np.array([0.1, 0, 0], np.float32)
    tc = ta + np.array([0, 0.1, 0], np.float32)
    valid = jnp.ones((4,), bool)
    centers = jnp.asarray([[0.0, 0.0, 0.0]])
    idx, ovf, n_within = culling.select_candidates(
        centers, jnp.asarray(0.05), jnp.asarray(ta), jnp.asarray(tb),
        jnp.asarray(tc), valid, k=2,
    )
    assert int(idx[0, 0]) == 0  # nearest first
    assert not bool(ovf[0])  # only triangle 0 is within dmin + 2r
    assert int(n_within[0]) == 1

    # Huge tile radius → everything within bound → overflow at k=2.
    idx, ovf, n_within = culling.select_candidates(
        centers, jnp.asarray(100.0), jnp.asarray(ta), jnp.asarray(tb),
        jnp.asarray(tc), valid, k=2,
    )
    assert bool(ovf[0])
    assert int(n_within[0]) == 4


def test_rtree_bvh_acceleration_methods_route_to_culled(big_sphere, rng):
    """AccelerationMethod.rtree()/rtree_bvh() — the reference's best backends
    (`README.md:120`) — must produce exact results through the public API."""
    verts, faces = big_sphere
    topo = Topology.triangle_list(faces.reshape(-1))
    q = rng.uniform(-1.2, 1.2, (400, 3)).astype(np.float32)
    exact_ray = np.asarray(
        m.generate_sdf(verts, topo, q, Strategy.XLA,
                       sign_method=SignMethod.RAYCAST)
    )
    got = np.asarray(
        m.generate_sdf(verts, topo, q, m.AccelerationMethod.rtree_bvh())
    )
    np.testing.assert_allclose(got, exact_ray, rtol=1e-5, atol=1e-6)

    exact_norm = np.asarray(
        m.generate_sdf(verts, topo, q, Strategy.XLA,
                       sign_method=SignMethod.NORMAL)
    )
    got = np.asarray(
        m.generate_sdf(verts, topo, q, m.AccelerationMethod.rtree())
    )
    np.testing.assert_allclose(np.abs(got), np.abs(exact_norm), rtol=1e-5,
                               atol=1e-6)


def test_binned_parity_matches_full_sweep(big_sphere, rng):
    """2D-tile-binned crossing counts == the full O(Q·T) sweep (exactness of
    the BVH-traversal analog)."""
    import jax.numpy as jnp

    verts, faces = big_sphere
    ta, tb, tc, valid, n = _tris(verts, faces)
    q = jnp.asarray(rng.uniform(-1.5, 1.5, (800, 3)).astype(np.float32))
    bins = tuple(
        culling.build_parity_bins(
            np.asarray(ta[:n]), np.asarray(tb[:n]), np.asarray(tc[:n]), axis
        )
        for axis in range(3)
    )
    got = np.asarray(
        culling.binned_parity_counts(q, ta, tb, tc, bins, n_valid=n)
    )
    want = np.asarray(
        culling._ray_parity_counts(q, ta, tb, tc, valid, 3)
    )
    np.testing.assert_array_equal(got, want)


def test_query_culled_with_parity_bins_end_to_end(big_sphere, rng):
    """Full public-API path: CULLED + host parity bins == exact engine."""
    verts, faces = big_sphere
    topo = Topology.triangle_list(faces.reshape(-1))
    q = rng.uniform(-1.4, 1.4, (1200, 3)).astype(np.float32)
    exact = np.asarray(
        m.generate_sdf(verts, topo, q, Strategy.XLA,
                       sign_method=SignMethod.RAYCAST)
    )
    # 5120 tris > 2*DEFAULT_K=1024 → generate_sdf builds parity bins.
    culled = np.asarray(
        m.generate_sdf(verts, topo, q, Strategy.CULLED,
                       sign_method=SignMethod.RAYCAST)
    )
    np.testing.assert_allclose(culled, exact, rtol=1e-5, atol=1e-6)


def test_sign_grid_transfer_exact(big_sphere, rng):
    """Sign-grid signing == per-query parity on a watertight mesh: the
    component-transfer argument (d(q) > reach ⇒ same sign as the cell
    center) plus the near-surface parity fallback must give identical signs."""
    verts, faces = big_sphere
    ta, tb, tc, valid, n = _tris(verts, faces)
    q = jnp.asarray(rng.uniform(-1.4, 1.4, (3000, 3)).astype(np.float32))

    sg = culling.build_sign_grid(ta, tb, tc, valid, res=24)
    # Exact unsigned distances for the transfer test.
    from mesh_to_sdf_tpu.ops import brute

    d = brute.sdf_brute(
        q, ta, tb, tc, valid, sign_method=SignMethod.RAYCAST,
        raycast_axes=0, query_chunk=q.shape[0],
    )
    inside = np.asarray(
        culling.signs_from_grid(q, d, sg, ta, tb, tc, valid)
    )
    counts = np.asarray(culling._ray_parity_counts(q, ta, tb, tc, valid, 3))
    want = (counts % 2 == 1).sum(axis=1) >= 2
    np.testing.assert_array_equal(inside, want)


def test_query_culled_with_sign_grid(big_sphere, rng):
    """query_sdf_culled with an explicit sign grid == the exact engine."""
    verts, faces = big_sphere
    ta, tb, tc, valid, n = _tris(verts, faces)
    q = jnp.asarray(rng.uniform(-1.3, 1.3, (2000, 3)).astype(np.float32))
    sg = culling.build_sign_grid(ta, tb, tc, valid, res=24)
    got = np.asarray(
        culling.query_sdf_culled(
            q, ta, tb, tc, valid, sign_method=SignMethod.RAYCAST,
            sign_grid=sg,
        )
    )
    topo = Topology.triangle_list(faces.reshape(-1))
    want = np.asarray(
        m.generate_sdf(verts, topo, np.asarray(q), Strategy.XLA,
                       sign_method=SignMethod.RAYCAST)
    )
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_query_culled_block_path_end_to_end(big_sphere, rng):
    """query_sdf_culled with a block index == the exact engine: the
    gathered per-sub-tile pass (distance + anchor-segment sign), its widened
    retry and the dense fix-up of certificate-flagged queries."""
    verts, faces = big_sphere
    ta, tb, tc, valid, n = _tris(verts, faces)
    bi = block_index.build_block_index(
        np.asarray(ta[:n]), np.asarray(tb[:n]), np.asarray(tc[:n])
    )
    sg = culling.build_sign_grid(ta, tb, tc, valid, res=24)
    q = jnp.asarray(rng.uniform(-1.3, 1.3, (1500, 3)).astype(np.float32))
    got = np.asarray(
        culling.query_sdf_culled(
            q, ta, tb, tc, valid, sign_method=SignMethod.RAYCAST,
            sign_grid=sg, block_index=bi, st=32,
        )
    )
    topo = Topology.triangle_list(faces.reshape(-1))
    want = np.asarray(
        m.generate_sdf(verts, topo, np.asarray(q), Strategy.XLA,
                       sign_method=SignMethod.RAYCAST)
    )
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)
    assert culling.LAST_CULLED_STATS["queries"] == 1500


def test_query_culled_public_api_builds_block_index(big_sphere, rng):
    """generate_sdf(Strategy.CULLED) on the CPU: at ≥ SIGN_GRID_MIN_QUERIES
    queries it builds the sign grid and the Morton block index on every
    backend and runs the gathered pass — equal to the exact engine."""
    from mesh_to_sdf_tpu import query

    verts, faces = big_sphere
    topo = Topology.triangle_list(faces.reshape(-1))
    q = rng.uniform(-1.3, 1.3, (query.SIGN_GRID_MIN_QUERIES, 3)).astype(
        np.float32)
    culling.LAST_CULLED_STATS.clear()
    got = np.asarray(m.generate_sdf(verts, topo, q, Strategy.CULLED))
    assert culling.LAST_CULLED_STATS["tris"] == len(faces)
    want = np.asarray(m.generate_sdf(verts, topo, q, Strategy.XLA))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_route_cache_self_tunes_and_stays_exact(big_sphere, rng):
    """The gathered path records its measured work fraction per (mesh-shape,
    batch) and reroutes repeat calls to the dense engine when culling
    cannot pay (small batches over few blocks). Both engines are exact, so
    the reroute must be invisible in the results."""
    verts, faces = big_sphere
    ta, tb, tc, valid, n = _tris(verts, faces)
    bi = block_index.build_block_index(
        np.asarray(ta[:n]), np.asarray(tb[:n]), np.asarray(tc[:n])
    )
    sg = culling.build_sign_grid(ta, tb, tc, valid, res=24)
    q = jnp.asarray(rng.uniform(-1.3, 1.3, (1200, 3)).astype(np.float32))

    kw = dict(sign_method=SignMethod.RAYCAST, sign_grid=sg, block_index=bi)
    first = np.asarray(culling.query_sdf_culled(q, ta, tb, tc, valid, **kw))
    key = culling._route_key(bi, q.shape[0])
    assert key in culling._ROUTE_CACHE  # decision recorded
    # 5120 tris in 20 blocks ≤ DEFAULT_KG: every sub-tile evaluates every
    # block — culling cannot pay here.
    assert culling._ROUTE_CACHE[key] is True
    second = np.asarray(culling.query_sdf_culled(q, ta, tb, tc, valid, **kw))
    np.testing.assert_allclose(second, first, rtol=2e-4, atol=5e-5)

    topo = Topology.triangle_list(faces.reshape(-1))
    want = np.asarray(
        m.generate_sdf(verts, topo, np.asarray(q), Strategy.XLA,
                       sign_method=SignMethod.RAYCAST)
    )
    np.testing.assert_allclose(second, want, rtol=2e-4, atol=5e-5)


def test_phase_a_hier_bounds_are_sound(big_sphere, monkeypatch):
    """Hierarchical phase A (coarse AABB → fine csphere): every returned
    bound must be a true lower bound on the exact center→block triangle
    distance, and lb_rest must lower-bound every block outside the window."""
    verts, faces = big_sphere
    ta, tb, tc, valid, n = _tris(verts, faces)
    ta, tb, tc = np.asarray(ta[:n]), np.asarray(tb[:n]), np.asarray(tc[:n])
    bi = block_index.build_block_index(ta, tb, tc)
    B, tbk = bi.n_blocks, bi.tb
    assert B == 20

    centers = jnp.asarray(
        [[0.0, 0.0, 0.0], [1.0, 0.2, -0.3], [2.5, 2.5, 2.5]], jnp.float32
    )
    c = 6
    lb_c, idx_c, lb_rest = block_index._phase_a_hier(centers, bi, c=c)
    lb_c, idx_c, lb_rest = map(np.asarray, (lb_c, idx_c, lb_rest))
    assert lb_c.shape == (3, c) and idx_c.shape == (3, c)
    # Sorted ascending.
    assert (np.diff(lb_c, axis=1) >= -1e-7).all()

    # Exact per-block min distances via the numpy closest-point oracle.
    # build_block_index Morton-sorts, so read the SORTED soup back from the
    # packed planes (pad triangles have a == PAD_COORD).
    from baselines import sdfgen_point_triangle_distance
    from mesh_to_sdf_tpu.ops.block_index import PAD_COORD

    p9 = np.asarray(bi.planes9)
    sa, sb, sc = p9[0:3].T, p9[3:6].T, p9[6:9].T
    real = sa[:, 0] != PAD_COORD

    for s in range(3):
        cs = np.asarray(centers[s])
        d_tri = np.array(
            [sdfgen_point_triangle_distance(cs, sa[i], sb[i], sc[i])
             if real[i] else np.inf for i in range(len(sa))], np.float32,
        )
        d_blk = np.full(B, np.inf, np.float32)
        np.minimum.at(d_blk, np.arange(len(sa)) // tbk, d_tri)
        for j in range(c):
            b = idx_c[s, j]
            assert lb_c[s, j] <= d_blk[b] + 1e-5, (s, j, b)
        outside = np.setdiff1d(np.arange(B), idx_c[s])
        if outside.size:
            assert lb_rest[s] <= d_blk[outside].min() + 1e-5


def test_culled_blocks_hier_path_is_exact(big_sphere, rng, monkeypatch):
    """Force the hierarchical phase A of the gathered pass on the 20-block
    sphere (kg=4, window 6 ⇒ B > 2·window): non-flagged queries must match
    brute force exactly; flagged ones are the caller's dense-recompute
    responsibility."""
    monkeypatch.setattr(block_index, "HIER_C", 6)

    verts, faces = big_sphere
    ta, tb, tc, valid, n = _tris(verts, faces)
    bi = block_index.build_block_index(
        np.asarray(ta[:n]), np.asarray(tb[:n]), np.asarray(tc[:n])
    )
    assert bi.n_blocks > 2 * max(4 + 1, 6)  # hier branch active
    sg = culling.build_sign_grid(ta, tb, tc, valid, res=24)

    centers = rng.uniform(-1.2, 1.2, (10, 3)).astype(np.float32)
    q = (centers[:, None, :]
         + rng.normal(0, 0.03, (10, 128, 3)).astype(np.float32)
         ).reshape(-1, 3)
    # kg=4 is unique to this test → a fresh trace that reads the patch.
    signed, flag, _ = culling._culled_gather_signed_impl(
        jnp.asarray(q), bi, sg.inside, sg.grid, st=32, kg=4,
    )
    want = np.asarray(m.generate_sdf(
        verts, Topology.triangle_list(faces.reshape(-1)), q, Strategy.XLA,
        sign_method=SignMethod.RAYCAST))
    ok = ~np.asarray(flag)
    assert ok.any(), "clustered sub-tiles should pass the certificate"
    np.testing.assert_allclose(
        np.asarray(signed)[ok], want[ok], rtol=2e-4, atol=1e-5
    )
