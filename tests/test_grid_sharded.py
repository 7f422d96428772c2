"""Distributed grid generation tests (8-device virtual CPU mesh)."""
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
from mesh_to_sdf_tpu.parallel import mesh as pmesh
from mesh_to_sdf_tpu.parallel.grid_sharded import generate_grid_sdf_sharded_cpt


@pytest.fixture(scope="module")
def setup():
    v, f = make_icosphere(subdiv=2)
    g = Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [32, 16, 16])
    m = pmesh.make_sdf_mesh(cells=8, tris=1)
    return v, f, g, m


def test_sharded_raycast_matches_single_device(setup):
    v, f, g, m = setup
    topo = Topology.triangle_list(f.reshape(-1))
    ref = np.asarray(
        generate_grid_sdf(v, topo, g, SignMethod.RAYCAST, strategy=Strategy.CPT)
    )
    got = np.asarray(generate_grid_sdf_sharded_cpt(v, f, g, m, SignMethod.RAYCAST))
    assert (np.sign(got) == np.sign(ref)).all()
    np.testing.assert_allclose(got, ref, atol=3e-3)


def test_sharded_vs_exact_brute_contract(setup):
    """Same contract as single-device CPT: signs exact, never (materially)
    undershoots, far field within tolerance."""
    v, f, g, m = setup
    topo = Topology.triangle_list(f.reshape(-1))
    brute = np.asarray(
        generate_grid_sdf(v, topo, g, SignMethod.RAYCAST, strategy=Strategy.XLA)
    )
    got = np.asarray(generate_grid_sdf_sharded_cpt(v, f, g, m, SignMethod.RAYCAST))
    assert (np.sign(got) == np.sign(brute)).all()
    # Never undershoots (absolute epsilon: near-surface cells have |d|~0, so
    # pure-relative undershoot checks amplify float noise on the subdivided
    # soup into percent-scale artifacts).
    assert np.all(np.abs(got) >= np.abs(brute) - 1e-5)
    rel = (np.abs(got) - np.abs(brute)) / np.maximum(np.abs(brute), 1e-6)
    assert rel.max() < 2e-2


def test_sharded_normal_sign(setup):
    v, f, g, m = setup
    topo = Topology.triangle_list(f.reshape(-1))
    ref = np.asarray(
        generate_grid_sdf(v, topo, g, SignMethod.NORMAL, strategy=Strategy.CPT)
    )
    got = np.asarray(generate_grid_sdf_sharded_cpt(v, f, g, m, SignMethod.NORMAL))
    np.testing.assert_allclose(np.abs(got), np.abs(ref), atol=3e-3)
    assert (np.sign(got) != np.sign(ref)).mean() <= 0.01


def test_sharded_uneven_rejects():
    v, f = make_icosphere(subdiv=1)
    g = Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [30, 16, 16])
    m = pmesh.make_sdf_mesh(cells=8, tris=1)
    with pytest.raises(ValueError, match="divide"):
        generate_grid_sdf_sharded_cpt(v, f, g, m)


def test_sharded_four_device_slabs(setup):
    """Non-trivial slab count: 4-way cells axis (x tris=2) on the same grid."""
    v, f, g, _ = setup
    topo = Topology.triangle_list(f.reshape(-1))
    m4 = pmesh.make_sdf_mesh(cells=4, tris=2)
    ref = np.asarray(
        generate_grid_sdf(v, topo, g, SignMethod.RAYCAST, strategy=Strategy.CPT)
    )
    got = np.asarray(generate_grid_sdf_sharded_cpt(v, f, g, m4, SignMethod.RAYCAST))
    assert (np.sign(got) == np.sign(ref)).all()
    np.testing.assert_allclose(got, ref, atol=3e-3)


def test_sharded_halo_rounds_sensitivity(setup):
    """More halo rounds monotonically tightens the far field (distance info
    propagates one slab per round); both settings stay inside the contract."""
    v, f, g, m = setup
    topo = Topology.triangle_list(f.reshape(-1))
    brute = np.asarray(
        generate_grid_sdf(v, topo, g, SignMethod.RAYCAST, strategy=Strategy.XLA)
    )
    errs = []
    for rounds in (1, 3):
        got = np.asarray(
            generate_grid_sdf_sharded_cpt(
                v, f, g, m, SignMethod.RAYCAST, halo_rounds=rounds
            )
        )
        assert (np.sign(got) == np.sign(brute)).all()
        rel = (np.abs(got) - np.abs(brute)) / np.maximum(np.abs(brute), 1e-6)
        errs.append(rel.max())
        assert rel.max() < 3e-2, (rounds, rel.max())
    assert errs[1] <= errs[0] + 1e-6


def test_sharded_asymmetric_grid():
    """Slab sharding on a non-cubic grid (thin y/z) with a torus (genus-1
    sign topology)."""
    from mesh_to_sdf_tpu.utils.meshgen import torus

    v, f = torus(1.0, 0.35, n_major=24, n_minor=12)
    g = Grid.from_bounding_box([-1.6, -0.6, -1.6], [1.6, 0.6, 1.6],
                               [16, 8, 12])
    m = pmesh.make_sdf_mesh(cells=8, tris=1)
    topo = Topology.triangle_list(f.reshape(-1))
    ref = np.asarray(
        generate_grid_sdf(v, topo, g, SignMethod.RAYCAST, strategy=Strategy.XLA)
    )
    got = np.asarray(generate_grid_sdf_sharded_cpt(v, f, g, m, SignMethod.RAYCAST))
    assert (np.sign(got) == np.sign(ref)).all()


def test_sharded_culled_queries_match_exact(setup, rng):
    """Sharded CULLED (gathered pass per query shard + replicated index)
    == the exact single-device engine, including flagged-query
    re-routing."""
    from mesh_to_sdf_tpu.parallel.sharding import generate_sdf_sharded_culled
    from mesh_to_sdf_tpu import generate_sdf

    v, f, _, _ = setup
    m = pmesh.make_sdf_mesh(cells=8, tris=1)
    q = rng.uniform(-1.4, 1.4, (4096, 3)).astype(np.float32)
    got = np.asarray(generate_sdf_sharded_culled(v, f, q, m))
    topo = Topology.triangle_list(f.reshape(-1))
    want = np.asarray(
        generate_sdf(v, topo, q, Strategy.XLA, sign_method=SignMethod.RAYCAST)
    )
    # atol 5e-5: the gathered pass uses the plane-form distance (different
    # float association than the XLA ladder) — near-surface queries sit at
    # |d|~1e-4 where that shows up.
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=5e-5)


def test_sharded_culled_tiny_capacity_still_exact(setup, rng, monkeypatch):
    """Starving the candidate capacity (one block per sub-tile, in both
    gather rounds) floods the flag path — the sharded dense re-route must
    keep the result exact."""
    from mesh_to_sdf_tpu.ops import culling
    from mesh_to_sdf_tpu.parallel.sharding import generate_sdf_sharded_culled
    from mesh_to_sdf_tpu import generate_sdf

    monkeypatch.setattr(culling, "DEFAULT_KG", 1)
    monkeypatch.setattr(culling, "DEFAULT_KG_WIDE", 1)
    v, f, _, _ = setup
    m = pmesh.make_sdf_mesh(cells=8, tris=1)
    q = rng.uniform(-1.4, 1.4, (2048, 3)).astype(np.float32)
    got = np.asarray(generate_sdf_sharded_culled(v, f, q, m, st=32))
    topo = Topology.triangle_list(f.reshape(-1))
    want = np.asarray(
        generate_sdf(v, topo, q, Strategy.XLA, sign_method=SignMethod.RAYCAST)
    )
    # atol 5e-5 as in test_sharded_culled_queries_match_exact.
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=5e-5)


def test_sharded_matches_streamed(setup):
    """Cross-pipeline consistency: the x-slab-sharded device pipeline and
    the host-loop streamed pipeline implement the same slab decomposition
    (binned seeds + sweeps + halo repair vs overlap slices) — their far
    fields may differ slightly where halo exchange vs slab overlap see
    different propagation depth, but signs and the near field must agree."""
    from mesh_to_sdf_tpu.gridgen_streamed import generate_grid_sdf_streamed

    v, f, g, m = setup
    sh = np.asarray(generate_grid_sdf_sharded_cpt(v, f, g, m, SignMethod.RAYCAST))
    st = np.asarray(
        generate_grid_sdf_streamed(v, f, g, SignMethod.RAYCAST, slab_nx=4)
    ).reshape(sh.shape)
    assert (np.sign(sh) == np.sign(st)).all()
    np.testing.assert_allclose(sh, st, atol=5e-3)
