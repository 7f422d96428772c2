"""Roofline accounting for the bench workloads.

Every headline rate needs a denominator: this module carries the device
peak table and per-pass flop/byte models so bench.py can report achieved
GFLOP/s, %-of-fp32-peak, achieved GB/s, %-of-memory-peak, and which
resource bounds each phase.

Peaks are keyed by ``jax.devices()[0].device_kind``; an unknown kind is an
error, never a default. The geometry is elementwise fp32 (no matrix
products), so the compute roof is the non-tensor-core fp32 rate.

Flop models (documented estimates, derived from the pass structure):

* Closest-point Embree ladder (`ops/geometry.py::closest_point_vw`, region
  ladder of `geo.rs:70-138`): ~80 flops per (point, triangle) pair — edge
  dots, the branchless where-ladder, final expansion.
* Aligned ray-triangle parity test (`ops/geometry.py::ray_triangle_aligned`
  ≙ `geo.rs:156-216`): 2-D edge cross products + sign agreement + ray-side
  test, ~30 flops per (line, triangle) pair per axis.
* CPT sweep (`ops/cpt.py`): per cell per directional sweep, 2 carried + 9
  slot-1 + 9 slot-2 candidate evaluations, each one ladder eval, plus the
  top-2-distinct keyed merge (~8 flops/candidate).

Byte models count device-memory traffic only:

* CPT sweep state = d1(4) + v1(36) + i1(4) + d2(4) + v2(36) + i2(4)
  = 88 B/cell, read + written once per directional sweep.
* Seed evaluation reads/writes the (9, K, R) gathered payload once each way.
"""
from __future__ import annotations

#: Published peaks per device kind: non-tensor fp32 FLOP/s, memory B/s.
PEAKS = {
    # NVIDIA H100 SXM data sheet (dense, 700 W power limit).
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "mem_bytes_per_s": 3.35e12},
}

#: Per-pair flop estimates (see module docstring).
FLOPS_LADDER_PAIR = 80.0
FLOPS_RAY_PAIR = 30.0
FLOPS_MERGE_CAND = 8.0


def peaks(device_kind: str) -> dict:
    """The peak row for ``device_kind``; raises ValueError if unknown."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; known: "
            f"{sorted(PEAKS)}"
        ) from None


def account(seconds: float, flops: float = 0.0, hbm_bytes: float = 0.0, *,
            device_kind: str) -> dict:
    """Roofline summary for one timed region on ``device_kind``.

    ``bound`` names the limiting resource under the model: whichever of
    compute-time-at-peak vs memory-time-at-peak is larger. When BOTH are a
    small fraction of the wall time (< 30%), the region is dominated by
    neither — launch latency / sequential dependency chains — and is
    labeled ``latency``.
    """
    pk = peaks(device_kind)
    out: dict = {"seconds": seconds, "device_kind": device_kind}
    t_flops = flops / pk["fp32_flops"] if flops else 0.0
    t_bytes = hbm_bytes / pk["mem_bytes_per_s"] if hbm_bytes else 0.0
    if flops:
        out["achieved_gflops"] = flops / seconds / 1e9
        out["pct_fp32_peak"] = 100.0 * t_flops / seconds
    if hbm_bytes:
        out["achieved_gbps"] = hbm_bytes / seconds / 1e9
        out["pct_mem_peak"] = 100.0 * t_bytes / seconds
    if flops or hbm_bytes:
        frac = max(t_flops, t_bytes) / seconds
        if frac < 0.30:
            out["bound"] = "latency"
        else:
            out["bound"] = "compute" if t_flops >= t_bytes else "bandwidth"
    return out


# ---------------------------------------------------------------------------
# Workload models
# ---------------------------------------------------------------------------

def pairs_query_flops(n_queries: int, n_tris: int, raycast_axes: int = 3,
                      chunk: int = 2048, block: int = 512) -> dict:
    """Dense query pass: every (query, triangle) pair runs the ladder plus
    ``raycast_axes`` aligned ray tests (ops/brute.py,
    ops/kernels/pallas_sdf.py). Memory traffic: triangles re-read once per
    query chunk; queries and outputs once."""
    q_pad = -(-n_queries // chunk) * chunk
    t_pad = -(-n_tris // block) * block
    pairs = float(q_pad) * t_pad
    flops = pairs * (FLOPS_LADDER_PAIR + raycast_axes * FLOPS_RAY_PAIR
                     + FLOPS_MERGE_CAND)
    hbm = (q_pad / chunk) * t_pad * 36.0 + q_pad * (12.0 + 4.0)
    return {"flops": flops, "hbm_bytes": hbm, "pairs": pairs}


def cpt_sweep_flops(n_cells: int, rounds: int = 1,
                    n_sweeps_per_round: int = 6) -> dict:
    """CPT directional sweeps (see module docstring for the model)."""
    cands = 2 + 9 + 9
    per_cell = cands * (FLOPS_LADDER_PAIR + FLOPS_MERGE_CAND)
    sweeps = rounds * n_sweeps_per_round
    flops = float(n_cells) * per_cell * sweeps
    hbm = float(n_cells) * 88.0 * 2.0 * sweeps
    return {"flops": flops, "hbm_bytes": hbm,
            "evals_per_cell": cands * sweeps}


def cpt_seed_flops(seed_bins) -> dict:
    """Seed evaluation work, counted from the actual gather lists."""
    import numpy as np

    k, r = np.asarray(seed_bins.entry_tri).shape
    pairs = float(k) * r
    flops = pairs * (FLOPS_LADDER_PAIR + FLOPS_MERGE_CAND)
    hbm = pairs * 36.0 * 2.0 + r * 8.0
    return {"flops": flops, "hbm_bytes": hbm, "pairs": pairs}


def parity_flops(cell_count, n_tris: int, axes: int = 3) -> dict:
    """XLA grid line parity (ops/raycast.py): every line of each axis tests
    every triangle; memory traffic re-reads the soup once per line chunk of
    1024 and writes one count per cell and axis."""
    nx, ny, nz = (int(c) for c in cell_count)
    lines = [ny * nz, nx * nz, nx * ny][:axes]
    pairs = float(sum(lines)) * n_tris
    hbm = sum(-(-n // 1024) for n in lines) * n_tris * 36.0 \
        + float(nx * ny * nz) * 4.0 * axes
    return {"flops": pairs * FLOPS_RAY_PAIR, "hbm_bytes": hbm, "pairs": pairs}


def grid_total_flops(cell_count, n_tris: int = 0, seed_bins=None,
                     rounds: int = 1) -> dict:
    """End-to-end generate_grid_sdf (raycast) model: seeds + sweeps +
    parity over ``n_tris`` original triangles. Missing structures
    contribute zero (their phase is then excluded from the roof)."""
    n_cells = 1
    for c in cell_count:
        n_cells *= int(c)
    parts = [cpt_sweep_flops(n_cells, rounds)]
    if seed_bins is not None:
        parts.append(cpt_seed_flops(seed_bins))
    if n_tris:
        parts.append(parity_flops(cell_count, n_tris))
    return {"flops": sum(p["flops"] for p in parts),
            "hbm_bytes": sum(p["hbm_bytes"] for p in parts)}
