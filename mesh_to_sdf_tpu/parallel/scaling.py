"""Weak-scaling efficiency harness.

The reference is single-process (SURVEY.md §2.3); its only scaling story is
rayon splitting cells across threads (`generate/grid.rs:318-339`). Weak
scaling here grows the grid's sweep axis with the device count so every
device owns a constant slab of cells, and measures how far the per-step
wall time drifts from the 1-device time.

The harness runs the full x-slab-sharded CPT pipeline
(`parallel.grid_sharded.generate_grid_sdf_sharded_cpt`: binned seeds →
slab-local sweeps → `ppermute` halo exchange → slab-local parity), so the
measured overhead IS the collective overhead (halo exchange + replicated
triangle broadcast), not a synthetic all-reduce.

On the CPU virtual mesh (`--xla_force_host_platform_device_count`) the
numbers validate *plumbing only* — all "devices" share one socket's memory
bandwidth, so efficiency is pessimistic and results carry
``non_predictive: true``. On the GPUs of one host the same entry point
produces the real number:

    python -m mesh_to_sdf_tpu bench --scaling
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

import jax

from ..grid import Grid
from ..types import SignMethod
from . import mesh as pmesh
from .grid_sharded import generate_grid_sdf_sharded_cpt

__all__ = ["measure_weak_scaling", "format_report"]


def _pow2_counts(n: int) -> list[int]:
    out, c = [], 1
    while c <= n:
        out.append(c)
        c *= 2
    if out[-1] != n:
        out.append(n)
    return out


def measure_weak_scaling(
    *,
    base_nx: int = 64,
    ny: int = 128,
    nz: int = 128,
    subdiv: int = 3,
    repeats: int = 3,
    device_counts: Optional[Sequence[int]] = None,
    sign_method: SignMethod = SignMethod.RAYCAST,
) -> dict:
    """Time the sharded grid pipeline at ``nx = base_nx × n`` for growing
    device counts ``n`` (constant ``base_nx·ny·nz`` cells per device).

    Returns a report dict::

        {"platform": "gpu", "non_predictive": False,
         "cells_per_device": 1048576, "tris": ...,
         "rows": [{"devices": n, "nx": nx, "median_ms": ..., "min_ms": ...,
                   "cells_per_s_per_device": ..., "efficiency_pct": ...}]}

    ``efficiency_pct`` = t(1)/t(n)·100 (weak scaling: ideal is flat time).
    The first row (n=1) is the denominator and reads 100 by construction.
    """
    from ..utils.meshgen import icosphere

    devices = jax.devices()
    platform = devices[0].platform
    if device_counts is None:
        device_counts = _pow2_counts(len(devices))
    device_counts = [n for n in device_counts if n <= len(devices)]

    verts, faces = icosphere(subdiv=subdiv)
    rows = []
    t1 = None
    for n in device_counts:
        dmesh = pmesh.make_sdf_mesh(cells=n, tris=1, devices=devices[:n])
        nx = base_nx * n
        grid = Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [nx, ny, nz])

        def run():
            out = generate_grid_sdf_sharded_cpt(
                verts, faces, grid, dmesh, sign_method,
            )
            jax.block_until_ready(out)
            return out

        run()  # compile + seed-bin cache warmup
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
        med = float(np.median(times))
        if t1 is None:
            t1 = med
        rows.append(
            {
                "devices": n,
                "nx": nx,
                "median_ms": round(med * 1e3, 2),
                "min_ms": round(min(times) * 1e3, 2),
                "cells_per_s_per_device": round(base_nx * ny * nz / med, 1),
                "efficiency_pct": round(100.0 * t1 / med, 1),
            }
        )

    return {
        "platform": platform,
        # CPU virtual devices share one host's memory bandwidth: the
        # numbers exercise the collectives but predict no device scaling.
        "non_predictive": platform == "cpu",
        "cells_per_device": base_nx * ny * nz,
        "tris": int(len(faces)),
        "sign_method": sign_method.value,
        "repeats": repeats,
        "rows": rows,
    }


def format_report(report: dict) -> str:
    """One human line per device count, ≙ the reference's per-phase logs."""
    tag = " (plumbing only — CPU virtual mesh)" if report["non_predictive"] \
        else ""
    lines = [
        f"weak scaling on {report['platform']}{tag}: "
        f"{report['cells_per_device']} cells/device, "
        f"{report['tris']} tris, sign={report['sign_method']}"
    ]
    for r in report["rows"]:
        lines.append(
            f"  {r['devices']:>3} dev  nx={r['nx']:>5}  "
            f"{r['median_ms']:>9.2f} ms/shard-step  "
            f"{r['cells_per_s_per_device']:>12.0f} cells/s/dev  "
            f"eff {r['efficiency_pct']:>5.1f}%"
        )
    return "\n".join(lines)
