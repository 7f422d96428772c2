"""Grid raycast sign kernel: per-axis line parity.

Array replacement for the reference's BVH raycast phase
(`mesh_to_sdf/src/generate/grid.rs:560-684`): one ray per boundary cell of the
three negative grid faces, along +X/+Y/+Z. The reference traverses a BVH per
ray and bumps an atomic counter for every cell in front of each hit
(`grid.rs:601-618`); here each axis is a dense (lines × triangle-block) sweep.

Per hit at parameter t from the face cell, the reference increments cells
``0..=floor(t/cell_size)``; therefore cell i's count is the *suffix count*
``#{hits : floor(t/cs) ≥ i}``. Instead of materializing a (lines, block,
cells) comparison tensor (O(cells·T) bools), each block's hit buckets are
sorted per line and the suffix counts read off with a vectorized binary
search — O(lines · T · log block + lines · cells · log block · #blocks).

Final sign: a cell is inside iff ≥2 of the 3 axis parities are odd
(`grid.rs:622-639`, best-of-3 voting).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..grid import Grid
from . import geometry

# numpy, not jnp: a module-level jnp scalar materializes on the default
# device at IMPORT time, forcing backend initialization before the user
# (or the CLI's --help) can even choose one.
_INF = np.float32(np.inf)


@functools.partial(jax.jit, static_argnames=("tri_block", "line_chunk", "axes"))
def grid_inside_mask(
    grid: Grid,
    tri_a: jax.Array,  # (T, 3)
    tri_b: jax.Array,
    tri_c: jax.Array,
    tri_valid: jax.Array,  # (T,)
    *,
    tri_block: int = 512,
    line_chunk: int = 1024,
    axes: int = 3,
) -> jax.Array:
    """Boolean (nx, ny, nz) mask: True where the cell is inside the mesh.

    ``axes=3`` (default): best-of-3 voting (`grid.rs:622-639`); ``axes=1``:
    single +X parity (the reference default backend, `default.rs:34-37`).
    """
    from .brute import pad_tri_blocks

    tri_a, tri_b, tri_c, tri_valid, tri_block = pad_tri_blocks(
        tri_a, tri_b, tri_c, tri_valid, tri_block
    )
    odd = [
        _axis_parity(grid, axis, tri_a, tri_b, tri_c, tri_valid, tri_block, line_chunk)
        for axis in range(axes)
    ]
    if axes == 1:
        return odd[0]
    votes = sum(o.astype(jnp.int32) for o in odd)
    return votes >= 2


def face_origins(grid: Grid, axis: int):
    """Ray origins (centers of the index-0 cells along `axis`,
    `grid.rs:648-684`) and the transverse layout shape."""
    nx, ny, nz = grid.cell_count
    centers = grid.all_cell_centers()
    if axis == 0:
        return centers[0].reshape(-1, 3), (ny, nz)
    if axis == 1:
        return centers[:, 0].reshape(-1, 3), (nx, nz)
    return centers[:, :, 0].reshape(-1, 3), (nx, ny)


def unrotate_axis(arr, axis: int, lshape, n: int):
    """(L, n) per-line values back into (nx, ny, nz)."""
    a = arr.reshape(lshape + (n,))
    if axis == 0:
        return jnp.transpose(a, (2, 0, 1))
    if axis == 1:
        return jnp.transpose(a, (0, 2, 1))
    return a


def _axis_parity(grid, axis, tri_a, tri_b, tri_c, tri_valid, tri_block, line_chunk):
    """Odd-crossing parity per cell for rays along +axis. Returns (nx,ny,nz)."""
    n = grid.cell_count[axis]
    cs = grid.cell_size[axis]
    origins, lshape = face_origins(grid, axis)
    L = origins.shape[0]

    n_blocks = tri_a.shape[0] // tri_block
    blocks = jax.tree.map(
        lambda x: x.reshape((n_blocks, tri_block) + x.shape[1:]),
        (tri_a, tri_b, tri_c, tri_valid),
    )

    chunk = min(line_chunk, L)
    pad = (-L) % chunk
    origins_p = jnp.pad(origins, ((0, pad), (0, 0)))
    origins_p = origins_p.reshape(-1, chunk, 3)

    # Integer cell coordinates along the ray, as float bucket thresholds.
    cell_f = jnp.arange(n, dtype=jnp.float32)

    def line_chunk_counts(orig):  # orig: (chunk, 3)
        def body(counts, blk):
            a, b, c, valid = blk
            inside, t = geometry.ray_triangle_aligned_2d(
                orig[:, None, :], a[None], b[None], c[None], axis
            )
            hit = inside & (t > 0.0) & valid[None, :]
            # bucket = floor(t / cs); suffix count over buckets >= i.
            bucket = jnp.where(hit, jnp.floor(t / cs), _INF)
            srt = jnp.sort(bucket, axis=1)  # (chunk, B), +inf tail
            n_hits = jnp.sum(hit, axis=1).astype(jnp.int32)  # (chunk,)
            # #elements < i  (binary search over the sorted buckets)
            below = jax.vmap(
                lambda row: jnp.searchsorted(row, cell_f, side="left")
            )(srt).astype(jnp.int32)  # (chunk, n)
            return counts + (n_hits[:, None] - below), None

        init = jnp.zeros((chunk, n), jnp.int32)
        counts, _ = jax.lax.scan(body, init, blocks)
        return counts

    counts = jax.lax.map(line_chunk_counts, origins_p).reshape(-1, n)[:L]
    odd = counts % 2 == 1
    return unrotate_axis(odd, axis, lshape, n)
