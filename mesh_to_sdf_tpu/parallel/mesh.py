"""Device-mesh construction.

The reference has no distributed anything (SURVEY.md §2.3): rayon threads in
one process. Here scaling is first-class: a 2-D logical mesh with axes

- ``cells``: data-parallel axis — query points / grid cells are sharded
  (the analog of the reference's rayon par_iter over queries,
  `default.rs:27`, and the split-heap cell partitioning, `grid.rs:318-339`).
- ``tris``: reduction axis — triangle blocks are sharded and champions
  min-reduced across shards (the analog of "the whole mesh visible to every
  thread" made scalable).

Within one host every GPU reaches every other over NVLink at the same rate,
so the axes follow the algorithm alone. Across hosts, keep ``tris`` inside
a host (the triangle all-gather is the bulk transfer) and let ``cells``
cross hosts (embarrassingly parallel).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.experimental import mesh_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CELL_AXIS = "cells"
TRI_AXIS = "tris"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Best-effort ``jax.distributed.initialize`` for multi-host runs.

    No-op when single-process (the common dev case); otherwise pass the
    coordinator address, process count and this process's id.
    """
    try:
        jax.distributed.initialize(coordinator, num_processes, process_id)
    except (RuntimeError, ValueError):
        pass  # already initialized or single-process


def make_sdf_mesh(
    cells: Optional[int] = None,
    tris: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Create a (cells, tris) mesh. Defaults: all devices on the cell axis."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if cells is None:
        cells = n // tris
    if cells * tris != n:
        raise ValueError(f"mesh {cells}x{tris} != {n} devices")
    arr = mesh_utils.create_device_mesh((cells, tris), devices=devices)
    return Mesh(arr, (CELL_AXIS, TRI_AXIS))


def cell_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(CELL_AXIS))


def tri_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(TRI_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_for_axis(n: int, mesh: Mesh, axis: str, multiple: int = 1) -> int:
    """Smallest padded size divisible by (axis size × multiple)."""
    div = mesh.shape[axis] * multiple
    return ((n + div - 1) // div) * div
