"""Closest-point-transform engine tests.

The reference asserts its propagation flagship equals brute force on real
meshes (`generate/grid.rs:692-724`); CPT is held to an explicit two-tier
contract instead: exact within a 3-cell band of the surface, ≤0.5%-relative
deviation in the far field (both propagation schemes are heuristics made
safe by exact re-evaluation — see ops/cpt.py docstring).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from baselines import make_icosphere
from mesh_to_sdf_tpu import (
    Grid,
    SignMethod,
    Strategy,
    Topology,
    generate_grid_sdf,
)
from mesh_to_sdf_tpu.ops import cpt
from mesh_to_sdf_tpu.utils.meshgen import box, torus


def _brute_unsigned(v, f, g):
    return np.abs(
        np.asarray(
            generate_grid_sdf(
                v,
                Topology.triangle_list(f.reshape(-1)),
                g,
                SignMethod.RAYCAST,
                strategy=Strategy.XLA,
                flat=False,
            )
        )
    )


def _cpt_dist(v, f, g, **kw):
    cs = float(np.max(np.abs(np.asarray(g.cell_size))))
    ra, rb, rc = cpt.subdivide_to_span(v, f, max_edge=(cpt.SEED_SPAN - 1.5) * cs)
    d, idx = cpt.closest_point_grid(
        g, jnp.asarray(ra), jnp.asarray(rb), jnp.asarray(rc), **kw
    )
    return np.asarray(d), np.asarray(idx)


CASES = [
    ("sphere", make_icosphere(subdiv=2), 20),
    ("torus", torus(n_major=24, n_minor=12), 18),
    ("box", box(), 16),
]


@pytest.mark.parametrize("name,mesh,n", CASES)
def test_cpt_contract(name, mesh, n):
    v, f = mesh
    g = Grid.from_bounding_box(v.min(0) - 0.25, v.max(0) + 0.25, [n, n, n])
    ref = _brute_unsigned(v, f, g)
    got, idx = _cpt_dist(v, f, g)
    assert (idx >= 0).all(), "unseeded cells survived the sweeps"
    cs = float(np.max(np.abs(np.asarray(g.cell_size))))
    err = got - ref
    # CPT only ever evaluates exact distances to real triangles → can never
    # undershoot the true minimum.
    assert err.min() > -1e-5, err.min()
    near = ref <= 1.5 * cs
    np.testing.assert_allclose(got[near], ref[near], atol=1e-5,
                               err_msg=f"{name}: seed band not exact")
    rel = err / np.maximum(ref, 1e-6)
    assert rel.max() <= 2e-2, f"{name}: far-field deviation {rel.max():.2%}"


def test_cpt_through_generate_grid_sdf():
    """AUTO grid strategy = CPT; signs must match the XLA engine exactly."""
    v, f = make_icosphere(subdiv=2)
    g = Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [16] * 3)
    topo = Topology.triangle_list(f.reshape(-1))
    ref = np.asarray(
        generate_grid_sdf(v, topo, g, SignMethod.RAYCAST, strategy=Strategy.XLA)
    )
    got = np.asarray(generate_grid_sdf(v, topo, g, SignMethod.RAYCAST))
    assert (np.sign(got) == np.sign(ref)).all()
    np.testing.assert_allclose(got, ref, atol=5e-3)


def test_subdivide_to_span():
    v, f = box()
    ra, rb, rc = cpt.subdivide_to_span(v, f, max_edge=0.5)
    edges = np.stack(
        [
            np.linalg.norm(rb - ra, axis=1),
            np.linalg.norm(rc - rb, axis=1),
            np.linalg.norm(ra - rc, axis=1),
        ]
    )
    assert edges.max() <= 0.5 + 1e-6
    # Surface area preserved.
    def area(a, b, c):
        return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1).sum()

    a0 = area(v[f[:, 0]], v[f[:, 1]], v[f[:, 2]])
    assert abs(area(ra, rb, rc) - a0) < 1e-3 * a0


def test_cpt_seeds_cover_surface():
    """Every cell adjacent to the surface is seeded directly (preheap parity
    with `grid.rs:383-456`)."""
    v, f = make_icosphere(subdiv=2)
    g = Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [20] * 3)
    ta = jnp.asarray(v[f[:, 0]])
    tb = jnp.asarray(v[f[:, 1]])
    tc = jnp.asarray(v[f[:, 2]])
    dist, idx, *_ = cpt._seed(g, ta, tb, tc, cpt.SEED_SPAN)
    dist = np.asarray(dist).reshape(20, 20, 20)
    ref = _brute_unsigned(v, f, g)
    cs = float(np.max(np.asarray(g.cell_size)))
    near = ref <= 1.0 * cs
    assert (dist[near] < 3.0e38).all()
    np.testing.assert_allclose(dist[near], ref[near], atol=1e-5)


def test_cpt_normal_sign_matches_rtree_semantics():
    """Nearest-triangle sign (reference Rtree, `rtree.rs:96-126`): |d| matches
    the champion engine and signs disagree on at most ~1% of cells — the
    budget the reference's own test allows (`rtree.rs:171-242`)."""
    v, f = make_icosphere(subdiv=2)
    g = Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [16] * 3)
    topo = Topology.triangle_list(f.reshape(-1))
    ref = np.asarray(
        generate_grid_sdf(v, topo, g, SignMethod.NORMAL,
                          strategy=Strategy.XLA, flat=False)
    )
    got = np.asarray(
        generate_grid_sdf(v, topo, g, SignMethod.NORMAL,
                          strategy=Strategy.CPT, flat=False)
    )
    np.testing.assert_allclose(np.abs(got), np.abs(ref), atol=5e-3)
    mismatch = (np.sign(got) != np.sign(ref)).mean()
    assert mismatch <= 0.01, mismatch


def test_cpt_grid_gradients_fd():
    """CPT-backed differentiable grid: envelope VJP vs finite differences."""
    import jax
    import jax.numpy as jnp

    from mesh_to_sdf_tpu.ops import autodiff

    v, f = make_icosphere(subdiv=1)
    g = Grid.from_bounding_box([-1.4] * 3, [1.4] * 3, [10] * 3)
    fn = autodiff.make_cpt_grid_distance(g, f, v)
    vj = jnp.asarray(v)

    def loss(vv):
        return jnp.sum((fn(vv) - 0.3) ** 2)

    gr = jax.grad(loss)(vj)
    eps = 1e-3
    rng = np.random.default_rng(5)
    checked = 0
    for _ in range(6):
        i = int(rng.integers(0, len(v)))
        k = int(rng.integers(0, 3))
        vp = vj.at[i, k].add(eps)
        vm = vj.at[i, k].add(-eps)
        fd = (float(loss(vp)) - float(loss(vm))) / (2 * eps)
        an = float(gr[i, k])
        if abs(fd) < 0.2:
            continue  # fd unreliable near Voronoi boundaries
        np.testing.assert_allclose(an, fd, rtol=5e-2)
        checked += 1
    assert checked >= 3


def test_differentiable_sdf_cpt_engine():
    from mesh_to_sdf_tpu.models.sdf_layer import DifferentiableSDF

    v, f = make_icosphere(subdiv=1)
    g = Grid.from_bounding_box([-1.5] * 3, [1.5] * 3, [10] * 3)
    target = np.abs(
        np.asarray(
            generate_grid_sdf(
                v * 1.15, Topology.triangle_list(f.reshape(-1)), g,
                SignMethod.NORMAL, strategy=Strategy.XLA, flat=False,
            )
        )
    )
    import jax.numpy as jnp

    model = DifferentiableSDF(
        f.astype(np.int32), g, SignMethod.NORMAL, learning_rate=5e-2,
        engine="cpt", vertices_example=v,
    )
    state = model.init(v)
    losses = []
    for _ in range(6):
        state, loss = model.train_step(state, jnp.asarray(target))
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, losses


# ---------------------------------------------------------------------------
# Host-binned seeding (round 2): exact AABB±1 rasterization, no scatter
# ---------------------------------------------------------------------------
def test_binned_seeds_match_reference_rasterization():
    """build_seed_bins + seed_from_bins == the reference preheap semantics
    (`grid.rs:383-456`): every cell inside a triangle's grid-snapped AABB±1
    gets that triangle's exact distance as a candidate."""
    import jax.numpy as jnp
    from baselines import make_icosphere

    verts, faces = make_icosphere(subdiv=2)
    ta = jnp.asarray(verts[faces[:, 0]])
    tb = jnp.asarray(verts[faces[:, 1]])
    tc = jnp.asarray(verts[faces[:, 2]])
    g = Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [13, 11, 9])

    bins = cpt.build_seed_bins(g, np.asarray(ta), np.asarray(tb), np.asarray(tc))
    d1, i1, d2, i2 = cpt.seed_from_bins(g, ta, tb, tc, bins)
    d1 = np.asarray(d1)
    i1 = np.asarray(i1)
    d2 = np.asarray(d2)
    i2 = np.asarray(i2)

    # Independent numpy rasterization of the same windows.
    counts = np.asarray(g.cell_count)
    bmin = np.asarray(g.first_cell) - 0.5 * np.asarray(g.cell_size)
    cs = np.asarray(g.cell_size)
    tv = np.stack([np.asarray(ta), np.asarray(tb), np.asarray(tc)], 1)
    lo = tv.min(1) - 1e-4
    hi = tv.max(1) + 1e-4
    lo_c = np.clip(np.floor((lo - bmin) / cs).astype(int) - 1, 0, counts - 1)
    hi_c = np.clip(np.floor((hi - bmin) / cs).astype(int) + 1, 0, counts - 1)
    centers = np.asarray(g.all_cell_centers())

    from baselines import sdfgen_point_triangle_distance

    rng_t = np.random.default_rng(3)
    for t in rng_t.choice(len(tv), size=25, replace=False):
        for _ in range(4):
            c = [rng_t.integers(lo_c[t][a], hi_c[t][a] + 1) for a in range(3)]
            flat = (c[0] * counts[1] + c[1]) * counts[2] + c[2]
            dt = sdfgen_point_triangle_distance(
                centers[c[0], c[1], c[2]].astype(np.float64),
                *(tv[t][k].astype(np.float64) for k in range(3)),
            )
            # The cell's seed must be at least as good as this candidate.
            assert d1[flat] <= dt + 1e-5
            # And if this triangle IS the winner, the distance is exact.
            if i1[flat] == t:
                assert abs(d1[flat] - dt) < 1e-5

    # Runner-up invariants: distinct triangle, d2 >= d1.
    seeded2 = i2 >= 0
    assert np.all(i2[seeded2] != i1[seeded2])
    assert np.all(d2[seeded2] >= d1[seeded2] - 1e-6)


def test_binned_seeds_dominate_window_scatter():
    """Full-AABB binned coverage can only improve on the fixed window."""
    import jax.numpy as jnp

    verts, faces = make_icosphere(subdiv=2)
    ta = jnp.asarray(verts[faces[:, 0]])
    tb = jnp.asarray(verts[faces[:, 1]])
    tc = jnp.asarray(verts[faces[:, 2]])
    g = Grid.from_bounding_box([-1.4] * 3, [1.4] * 3, [12, 12, 12])
    bins = cpt.build_seed_bins(g, np.asarray(ta), np.asarray(tb), np.asarray(tc))
    b1, _, _, _ = cpt.seed_from_bins(g, ta, tb, tc, bins)
    s1, _, _, _ = cpt._seed(g, ta, tb, tc, cpt.SEED_SPAN)
    b1 = np.asarray(b1)
    s1 = np.asarray(s1)
    covered = s1 < 1e30
    assert np.all(b1[covered] <= s1[covered] + 1e-6)


def test_binned_seeds_empty_and_giant():
    """Degenerate inputs: no triangles; one triangle spanning the grid."""
    import jax.numpy as jnp

    g = Grid.from_bounding_box([-1] * 3, [1] * 3, [6, 6, 6])
    bins = cpt.build_seed_bins(
        g, np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
        np.zeros((0, 3), np.float32),
    )
    z = jnp.zeros((0, 3), jnp.float32)
    d1, i1, _, _ = cpt.seed_from_bins(g, z, z, z, bins)
    assert np.all(np.asarray(i1) == -1)

    # One huge triangle in the z=0 plane: its AABB±1 covers the full x/y
    # extent but only z-cells adjacent to the plane (reference semantics,
    # `grid.rs:410-426`); those cells are seeded exactly, the rest filled
    # by the sweeps.
    ta = jnp.asarray([[-5.0, -5.0, 0.0]])
    tb = jnp.asarray([[5.0, -5.0, 0.0]])
    tc = jnp.asarray([[0.0, 10.0, 0.0]])
    bins = cpt.build_seed_bins(
        g, np.asarray(ta), np.asarray(tb), np.asarray(tc)
    )
    seed = cpt.seed_from_bins(g, ta, tb, tc, bins)
    d1 = np.asarray(seed[0]).reshape(6, 6, 6)
    centers = np.asarray(g.all_cell_centers())
    want = np.abs(centers[..., 2])
    seeded = d1 < 1e30
    assert seeded[:, :, 1:5].all() and not seeded[:, :, 0].any()
    # Tolerance: the algebraic plane-form distance (cpt._pt_dist)
    # loses ~1e-4 relative on huge-coordinate triangles.
    np.testing.assert_allclose(d1[seeded], want[seeded], rtol=5e-4, atol=5e-5)

    # The sweeps complete the field exactly everywhere.
    dist, idx = cpt.closest_point_grid(g, ta, tb, tc, seed=seed)
    np.testing.assert_allclose(np.asarray(dist), want, rtol=5e-4, atol=5e-5)
    assert np.all(np.asarray(idx) == 0)


def test_native_seed_bins_match_numpy():
    """The C++ fast path produces the same (cell → candidate) sets and row
    layout metadata as the numpy reference implementation."""
    from baselines import make_icosphere
    from mesh_to_sdf_tpu import native

    if not native.available():
        pytest.skip("native library not built")

    verts, faces = make_icosphere(subdiv=2)
    tris = verts[faces]
    g = Grid.from_bounding_box([-1.2] * 3, [1.2] * 3, [17, 15, 13])
    b_nat = cpt.build_seed_bins(g, tris[:, 0], tris[:, 1], tris[:, 2])

    # Force the numpy path.
    lib, tried = native._lib, native._tried
    native._lib, native._tried = None, True
    try:
        b_np = cpt.build_seed_bins(g, tris[:, 0], tris[:, 1], tris[:, 2])
    finally:
        native._lib, native._tried = lib, tried

    assert b_nat.entry_tri.shape == b_np.entry_tri.shape
    assert b_nat.n_shift_rounds == b_np.n_shift_rounds
    np.testing.assert_array_equal(b_nat.rows_cell, b_np.rows_cell)

    def pairs(b, T):
        # entry_tri is (K, R): tile rows_cell across the K-major axis.
        rows = np.tile(b.rows_cell, b.entry_tri.shape[0])
        ent = np.asarray(b.entry_tri).reshape(-1)
        keep = ent < T
        return set(zip(rows[keep].tolist(), ent[keep].tolist()))

    T = len(tris)
    assert pairs(b_nat, T) == pairs(b_np, T)
