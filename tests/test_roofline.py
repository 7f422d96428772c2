"""Roofline accounting sanity (utils/roofline.py)."""
import numpy as np
import pytest

from mesh_to_sdf_tpu.utils import roofline

H100 = "NVIDIA H100 80GB HBM3"


def test_account_compute_bound():
    # 11.5 TFLOP in 0.5 s on a 67 TFLOP/s roof -> ~34% peak, compute-bound.
    out = roofline.account(0.5, flops=1.15e13, hbm_bytes=1e9,
                           device_kind=H100)
    assert out["bound"] == "compute"
    assert abs(out["achieved_gflops"] - 23000.0) < 1.0
    assert 33.0 < out["pct_fp32_peak"] < 35.0


def test_account_bandwidth_bound():
    out = roofline.account(1.0, flops=1e10, hbm_bytes=2e12, device_kind=H100)
    assert out["bound"] == "bandwidth"
    assert 55.0 < out["pct_mem_peak"] < 65.0


def test_account_latency_bound():
    # Tiny work over a long wall time: neither resource explains it.
    out = roofline.account(1.0, flops=1e9, hbm_bytes=1e6, device_kind=H100)
    assert out["bound"] == "latency"


def test_peak_table_known_kind():
    pk = roofline.peaks(H100)
    assert pk["fp32_flops"] == 67e12 and pk["mem_bytes_per_s"] == 3.35e12


@pytest.mark.parametrize("kind", ["NVIDIA H100 PCIe", "cpu", "NVIDIA A100-SXM4-80GB"])
def test_peak_table_unknown_kind_raises(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        roofline.peaks(kind)
    with pytest.raises(ValueError):
        roofline.account(1.0, flops=1e9, device_kind=kind)


def test_query_pairs_model_padding():
    m = roofline.pairs_query_flops(1000, 500, raycast_axes=3,
                                   chunk=1024, block=1024)
    # Padded to one chunk x one block.
    assert m["pairs"] == 1024 * 1024
    assert m["flops"] > m["pairs"] * 80


def test_sweep_model_scales_with_rounds():
    one = roofline.cpt_sweep_flops(10**6)
    two = roofline.cpt_sweep_flops(10**6, rounds=2)
    assert one["evals_per_cell"] == 20 * 6
    assert two["flops"] == 2 * one["flops"]
    assert two["hbm_bytes"] == 2 * one["hbm_bytes"]


def test_grid_total_counts_from_real_structures():
    # Build tiny real structures and make sure the counting paths run.
    from mesh_to_sdf_tpu import Grid
    from mesh_to_sdf_tpu.ops import cpt as cpt_mod
    from tests.baselines import make_icosphere

    verts, faces = make_icosphere(subdiv=1)
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int64)
    ta, tb, tc = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    grid = Grid.from_bounding_box([-1.2] * 3, [1.2] * 3, [8, 8, 8])
    bins = cpt_mod.build_seed_bins(grid, ta, tb, tc)
    m = roofline.grid_total_flops((8, 8, 8), len(f), bins)
    assert m["flops"] > 0 and m["hbm_bytes"] > 0
    par = roofline.parity_flops((8, 8, 8), len(f))
    assert par["pairs"] == 3 * 64 * len(f)
    no_parity = roofline.grid_total_flops((8, 8, 8), 0, bins)
    assert m["flops"] == no_parity["flops"] + par["flops"]
    acct = roofline.account(0.01, **m, device_kind=H100)
    assert set(acct) >= {"achieved_gflops", "pct_fp32_peak", "bound"}
