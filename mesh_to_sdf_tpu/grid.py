"""Regular 3-D grid abstraction.

Array re-design of the reference ``Grid`` (`mesh_to_sdf/src/grid.rs:30-173`):
- ``cell_count`` is static (Python ints) so every array shape is known to XLA.
- ``first_cell`` / ``cell_size`` are JAX arrays (differentiable, shardable).
- The flattened cell index is x-major / z-fastest
  (``idx = z + y*nz + x*ny*nz``, `grid.rs:122-124`) which is exactly the C-order
  flattening of an ``(nx, ny, nz)`` array — so SDF grids live naturally as
  3-D arrays and ``.reshape(-1)`` matches the reference layout bit-for-bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class Grid:
    """A regular grid of cell *centers*.

    - ``first_cell``: position of the center of cell (0,0,0). Shape (3,).
    - ``cell_size``: per-axis cell size (may differ per axis, may be negative,
      matching `grid.rs:25`). Shape (3,).
    - ``cell_count``: static (nx, ny, nz). Note: sampling x in 0..=10 needs 11
      cells (`grid.rs:24`).
    """

    first_cell: jax.Array
    cell_size: jax.Array
    cell_count: Tuple[int, int, int] = (1, 1, 1)

    # ------------------------------------------------------------------ ctor
    @staticmethod
    def new(first_cell, cell_size, cell_count) -> "Grid":
        """Mirror of ``Grid::new`` (`grid.rs:43-49`)."""
        return Grid(
            first_cell=jnp.asarray(first_cell, jnp.float32),
            cell_size=jnp.asarray(cell_size, jnp.float32),
            cell_count=tuple(int(c) for c in cell_count),
        )

    @staticmethod
    def from_bounding_box(bbox_min, bbox_max, cell_count) -> "Grid":
        """Mirror of ``Grid::from_bounding_box`` (`grid.rs:59-74`):
        ``cell_size = (max-min)/count``; first cell center offset half a cell.
        """
        bbox_min = jnp.asarray(bbox_min, jnp.float32)
        bbox_max = jnp.asarray(bbox_max, jnp.float32)
        counts = tuple(int(c) for c in cell_count)
        fcount = jnp.asarray(counts, jnp.float32)
        cell_size = (bbox_max - bbox_min) / fcount
        first_cell = bbox_min + cell_size * 0.5
        return Grid(first_cell=first_cell, cell_size=cell_size, cell_count=counts)

    # ------------------------------------------------------------- properties
    @property
    def total_cell_count(self) -> int:
        nx, ny, nz = self.cell_count
        return nx * ny * nz

    def last_cell(self) -> jax.Array:
        """Mirror of ``get_last_cell`` (`grid.rs:82-88`) — note the reference
        multiplies by ``cell_count`` (not ``cell_count - 1``); kept verbatim."""
        counts = jnp.asarray(self.cell_count, jnp.float32)
        return self.first_cell + counts * self.cell_size

    def bounding_box(self) -> Tuple[jax.Array, jax.Array]:
        """(min, max) corners (`grid.rs:110-119`)."""
        bmin = self.first_cell - self.cell_size * 0.5
        counts = jnp.asarray(self.cell_count, jnp.float32)
        return bmin, bmin + counts * self.cell_size

    # ------------------------------------------------------------ index math
    def cell_index(self, cell) -> jax.Array:
        """Flattened index, z-fastest (`grid.rs:122-124`)."""
        cell = jnp.asarray(cell)
        _, ny, nz = self.cell_count
        return cell[..., 2] + cell[..., 1] * nz + cell[..., 0] * ny * nz

    def cell_coordinates(self, idx) -> jax.Array:
        """Inverse of :meth:`cell_index` (`grid.rs:127-132`)."""
        idx = jnp.asarray(idx)
        _, ny, nz = self.cell_count
        z = idx % nz
        y = (idx // nz) % ny
        x = idx // (ny * nz)
        return jnp.stack([x, y, z], axis=-1)

    def cell_center(self, cell) -> jax.Array:
        """Center of a cell given integer coords (..., 3) (`grid.rs:135-141`)."""
        cell = jnp.asarray(cell, jnp.float32)
        return self.first_cell + cell * self.cell_size

    def all_cell_centers(self) -> jax.Array:
        """Cell centers as an ``(nx, ny, nz, 3)`` array (C order == reference
        flat layout)."""
        nx, ny, nz = self.cell_count
        ix = jnp.arange(nx, dtype=jnp.float32)[:, None, None]
        iy = jnp.arange(ny, dtype=jnp.float32)[None, :, None]
        iz = jnp.arange(nz, dtype=jnp.float32)[None, None, :]
        x = self.first_cell[0] + ix * self.cell_size[0]
        y = self.first_cell[1] + iy * self.cell_size[1]
        z = self.first_cell[2] + iz * self.cell_size[2]
        shape = (nx, ny, nz)
        return jnp.stack(
            [
                jnp.broadcast_to(x, shape),
                jnp.broadcast_to(y, shape),
                jnp.broadcast_to(z, shape),
            ],
            axis=-1,
        )

    # -------------------------------------------------------------- snapping
    def snap_point(self, point) -> Tuple[jax.Array, jax.Array]:
        """Snap a point to the grid (`grid.rs:145-170`).

        Returns ``(cell, inside)`` where ``cell`` is the clamped integer cell
        (..., 3) int32 and ``inside`` a bool mask (the reference's
        ``SnapResult::Inside`` / ``Outside``).
        """
        point = jnp.asarray(point, jnp.float32)
        bmin, _ = self.bounding_box()
        raw = jnp.floor((point - bmin) / self.cell_size).astype(jnp.int32)
        hi = jnp.asarray(self.cell_count, jnp.int32) - 1
        clamped = jnp.clip(raw, 0, hi)
        inside = jnp.all(raw == clamped, axis=-1)
        return clamped, inside


jax.tree_util.register_dataclass(
    Grid,
    data_fields=["first_cell", "cell_size"],
    meta_fields=["cell_count"],
)


def grid_shape(grid: Grid) -> Tuple[int, int, int]:
    return grid.cell_count


def np_grid_cell_centers(first_cell, cell_size, cell_count) -> np.ndarray:
    """NumPy twin of :meth:`Grid.all_cell_centers` for host-side baselines."""
    nx, ny, nz = cell_count
    ix, iy, iz = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    cells = np.stack([ix, iy, iz], axis=-1).astype(np.float32)
    return np.asarray(first_cell, np.float32) + cells * np.asarray(
        cell_size, np.float32
    )
