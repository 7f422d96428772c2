"""Driver for the measured single-core CPU baseline (native/baseline_rtree_bvh).

BASELINE.md's north stars are multiples of "single-core Rust RtreeBvh"; the
reference publishes no absolute numbers and no Rust toolchain exists here,
so `native/baseline_rtree_bvh.cpp` implements the same algorithm class in
C++ (BVH median-split + branch-and-bound nearest + 3-axis raycast parity;
preheap → heap-BFS → raycast grid generator) and this module runs it on the
criterion workloads so every "vs reference" multiplier is a MEASUREMENT.
"""
from __future__ import annotations

import json
import os
import struct
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_BIN = Path(__file__).resolve().parent.parent.parent / "native" / "baseline_rtree_bvh"


def available(build: Optional[bool] = None) -> bool:
    """True if the baseline binary exists (optionally building it)."""
    if _BIN.exists():
        return True
    if build or (build is None and os.environ.get("M2S_NATIVE_BUILD") == "1"):
        try:
            subprocess.run(
                ["make", "-C", str(_BIN.parent), _BIN.name],
                capture_output=True, check=True,
            )
        except (OSError, subprocess.CalledProcessError):
            return False
    return _BIN.exists()


def _tri_bytes(ta, tb, tc) -> bytes:
    tris = np.concatenate(
        [np.asarray(ta, np.float32), np.asarray(tb, np.float32),
         np.asarray(tc, np.float32)],
        axis=1,
    )
    return np.ascontiguousarray(tris).tobytes()


def run_query(ta, tb, tc, queries) -> dict:
    """generate_sdf workload (RtreeBvh + 3-axis raycast sign), 1 core.

    Returns the binary's JSON: build_ms / query_ms / queries_per_s /
    checksum (sum of signed distances, for cross-validation).
    """
    q = np.asarray(queries, np.float32)
    buf = (
        struct.pack("<II", 0, len(np.asarray(ta)))
        + _tri_bytes(ta, tb, tc)
        + struct.pack("<I", len(q))
        + np.ascontiguousarray(q).tobytes()
    )
    out = subprocess.run([str(_BIN)], input=buf, capture_output=True,
                         check=True)
    return json.loads(out.stdout.decode())


def run_grid(ta, tb, tc, grid) -> dict:
    """generate_grid_sdf workload (preheap → heap BFS → raycast), 1 core."""
    buf = (
        struct.pack("<II", 1, len(np.asarray(ta)))
        + _tri_bytes(ta, tb, tc)
        + np.asarray(grid.first_cell, np.float32).tobytes()
        + np.asarray(grid.cell_size, np.float32).tobytes()
        + np.asarray(grid.cell_count, np.uint32).tobytes()
    )
    out = subprocess.run([str(_BIN)], input=buf, capture_output=True,
                         check=True)
    return json.loads(out.stdout.decode())
