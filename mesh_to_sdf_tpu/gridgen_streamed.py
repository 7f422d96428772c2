"""Slab-streamed grid SDF: very large grids on one chip, bounded memory.

The CPT engine's full per-cell state (2 triangles × 9 vertex coords + ids)
is ~88 B/cell — a 512³ grid would need ~12 GB of state plus transposes,
more than a card holds beside the sweep temporaries. This pipeline streams x-slabs through the device the
way the distributed version shards them (parallel/grid_sharded.py):

- pass 1, left→right: CPT per slab, merging the previous slab's outgoing
  boundary slice; record each slab's right-edge state and its +x ray hit
  totals (per transverse line);
- pass 2, right→left: CPT per slab again (recompute beats storing 88 B/cell),
  merging the stored left-edge and the successor's outgoing right-edge; sign
  with y/z parity locally and +x parity from in-slab suffix counts plus the
  pass-1 totals of all later slabs (exact);
- distances stream to a host numpy array slab by slab.

One compiled program per pass shape serves every slab (the slab grid differs
only in its ``first_cell``, which is traced data).

All host prep — subdivision and per-slab seed bins — is content-cached
per (mesh, grid, slab_nx) as DEVICE-resident arrays (``_STREAM_PREP_CACHE``),
boundary-edge states stay on device between the passes, and the per-slab
output fetch runs one slab BEHIND the compute so the device-to-host copy
overlaps the next slab's passes.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .grid import Grid
from .types import F32_MAX, SignMethod
from .ops import cpt as cpt_mod
from .ops import raycast as raycast_mod


def _empty_edge(ny, nz):
    return cpt_mod.CptState(
        jnp.full((ny, nz), F32_MAX, jnp.float32),
        jnp.full((ny, nz, 9), cpt_mod.PAD_COORD, jnp.float32),
        jnp.full((ny, nz), -1, jnp.int32),
        jnp.full((ny, nz), F32_MAX, jnp.float32),
        jnp.full((ny, nz, 9), cpt_mod.PAD_COORD, jnp.float32),
        jnp.full((ny, nz), -1, jnp.int32),
    )


def _state_from(dist, idx, ta, tb, tc):
    T = ta.shape[0]
    tv = jnp.concatenate([ta, tb, tc], axis=-1)
    tv = jnp.concatenate(
        [tv, jnp.full((1, 9), cpt_mod.PAD_COORD, jnp.float32)], axis=0
    )
    verts = tv[jnp.where(idx < 0, T, idx)]
    return cpt_mod.CptState(
        dist, verts, idx,
        jnp.full_like(dist, F32_MAX),
        jnp.full_like(verts, cpt_mod.PAD_COORD),
        jnp.full_like(idx, -1),
    )


def _x_sweeps(state, centers):
    out = cpt_mod._sweep_axis0(state, centers)
    rev = cpt_mod.CptState(*[getattr(out, n)[::-1] for n in out._fields])
    rev = cpt_mod._sweep_axis0(rev, centers[::-1])
    return cpt_mod.CptState(*[getattr(rev, n)[::-1] for n in rev._fields])


def _merge_edge(state, edge, position, centers_row):
    row = cpt_mod.CptState(*[getattr(state, n)[position] for n in state._fields])
    row = cpt_mod._merge_eval(row, edge.v1, edge.i1, centers_row)
    row = cpt_mod._merge_eval(row, edge.v2, edge.i2, centers_row)
    return cpt_mod.CptState(
        *[getattr(state, n).at[position].set(getattr(row, n))
          for n in state._fields]
    )


@functools.partial(jax.jit, static_argnames=("cell_count", "seed_rounds"))
def _slab_pass(first_cell, cell_size, cell_count, tris, left_edge, right_edge,
               seed_entry, seed_rows, seed_cellrow, seed_rounds: int):
    """CPT on one slab with optional incoming boundary states (pass INF edges
    for "none"). Seeds come from host-binned gather lists (exact AABB±1
    coverage, ≙ gridgen._cpt_grid_signed). Returns (state slab, right edge,
    left edge)."""
    slab = Grid(first_cell=first_cell, cell_size=cell_size,
                cell_count=cell_count)
    ta, tb, tc = tris[0], tris[1], tris[2]
    seed = cpt_mod.seed_from_bins(
        slab, ta, tb, tc,
        cpt_mod.SeedBins(seed_entry, seed_rows, seed_cellrow, seed_rounds),
    )
    dist, idx = cpt_mod.closest_point_grid(slab, ta, tb, tc, seed=seed)
    state = _state_from(dist, idx, ta, tb, tc)
    centers = slab.all_cell_centers()
    state = _merge_edge(state, left_edge, 0, centers[0])
    state = _merge_edge(state, right_edge, -1, centers[-1])
    state = _x_sweeps(state, centers)
    lo = cpt_mod.CptState(*[getattr(state, n)[0] for n in state._fields])
    hi = cpt_mod.CptState(*[getattr(state, n)[-1] for n in state._fields])
    return state, hi, lo


@functools.partial(jax.jit, static_argnames=("cell_count",))
def _slab_sign_raycast(first_cell, cell_size, cell_count, dist, orig):
    """Sign one slab. All three parities are slab-local: rays cast from this
    slab's faces see the whole (replicated) mesh, and each cell's count is
    the suffix count of hits beyond it — including hits past the slab — so
    no cross-slab bookkeeping is needed."""
    slab = Grid(first_cell=first_cell, cell_size=cell_size,
                cell_count=cell_count)
    oa, ob, oc = orig[0], orig[1], orig[2]
    valid = jnp.ones((oa.shape[0],), bool)
    inside = raycast_mod.grid_inside_mask(slab, oa, ob, oc, valid,
                                          tri_block=256)
    return jnp.where(inside, -dist, dist)


class _StreamPrep(NamedTuple):
    """Device-resident per-(mesh, grid, slab_nx) prep for the streamed run.

    tris: (3, Ts, 3) subdivided soup; orig: (3, T, 3) original soup;
    seeds: per-slab (entry (K, R), rows_cell (R,), cell_row (N_slab,))
    device tuples, all padded to one common R so ONE compiled program
    serves every slab; n_shift_rounds: shared merge-round count.
    """

    tris: object
    orig: object
    seeds: list
    n_shift_rounds: int


#: Content-keyed prep cache (≙ gridgen._CPT_PREP_CACHE): the host binning
#: and its upload happen once per (mesh, grid).
_STREAM_PREP_CACHE: dict = {}
_STREAM_PREP_CACHE_MAX = 2


def _stream_prep(grid: Grid, slab_nx: int, v_np, f_np) -> _StreamPrep:
    import zlib

    nx, ny, nz = grid.cell_count
    n_slabs = nx // slab_nx
    key = (
        zlib.adler32(v_np.tobytes()),
        zlib.adler32(f_np.tobytes()),
        tuple(np.asarray(grid.first_cell, np.float32).tolist()),
        tuple(np.asarray(grid.cell_size, np.float32).tolist()),
        tuple(int(c) for c in grid.cell_count),
        slab_nx,
    )
    hit = _STREAM_PREP_CACHE.get(key)
    if hit is not None:
        return hit

    cs = float(np.max(np.abs(np.asarray(grid.cell_size))))
    # Binned seeds have exact AABB±1 coverage for any triangle size; the
    # loose 8-cell cap only bounds the rasterized seed volume.
    ra, rb, rc = cpt_mod.subdivide_to_span(v_np, f_np, max_edge=8.0 * cs)
    tris = jnp.asarray(np.stack([ra, rb, rc]))
    orig = jnp.asarray(np.stack([v_np[f_np[:, k]] for k in range(3)]))

    # Per-slab seed bins, padded to a common row count and uploaded slab by
    # slab (NOT host-stacked like cpt.build_slab_seed_bins — at 512³ the
    # (n_slabs, …) assembly alone would copy ~1 GB twice).
    fc = np.asarray(grid.first_cell, np.float32)
    csv = np.asarray(grid.cell_size, np.float32)
    host_bins = []
    for i in range(n_slabs):
        slab = Grid(
            first_cell=fc + np.asarray([i * slab_nx, 0, 0], np.float32) * csv,
            cell_size=csv,
            cell_count=(slab_nx, ny, nz),
        )
        host_bins.append(cpt_mod.build_seed_bins(
            slab, ra, rb, rc, k=8, pad=cpt_mod.seed_pad_for(grid)
        ))
    T = ra.shape[0]
    N_slab = slab_nx * ny * nz
    R_max = max(b.entry_tri.shape[1] for b in host_bins)
    n_rounds = max(b.n_shift_rounds for b in host_bins)
    seeds = []
    while host_bins:
        b = host_bins.pop(0)  # free host memory as we upload
        r = b.entry_tri.shape[1]
        if r < R_max:
            entry = np.full((b.entry_tri.shape[0], R_max), T, np.int32)
            entry[:, :r] = b.entry_tri
            rows = np.full((R_max,), N_slab, np.int32)
            rows[:r] = b.rows_cell
        else:
            entry, rows = b.entry_tri, b.rows_cell
        seeds.append((
            jax.block_until_ready(jnp.asarray(entry)),
            jax.block_until_ready(jnp.asarray(rows)),
            jax.block_until_ready(jnp.asarray(b.cell_row)),
        ))

    prep = _StreamPrep(tris, orig, seeds, n_rounds)
    if len(_STREAM_PREP_CACHE) >= _STREAM_PREP_CACHE_MAX:
        _STREAM_PREP_CACHE.pop(next(iter(_STREAM_PREP_CACHE)))
    _STREAM_PREP_CACHE[key] = prep
    return prep


def generate_grid_sdf_streamed(
    vertices,
    faces,
    grid: Grid,
    sign_method: SignMethod = SignMethod.RAYCAST,
    *,
    slab_nx: Optional[int] = None,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """`generate_grid_sdf` for grids too large for one resident CPT state.

    Returns a host numpy array, flat reference layout. ``slab_nx`` defaults
    to ≤64 slices per slab. ``out``: optional preallocated (nx·ny·nz,) or
    (nx, ny, nz) float32 array to stream into (avoids one allocation).
    """
    nx, ny, nz = grid.cell_count
    if slab_nx is None:
        slab_nx = min(64, nx)
    if nx % slab_nx:
        raise ValueError(f"nx={nx} must be a multiple of slab_nx={slab_nx}")
    n_slabs = nx // slab_nx
    cell_count = (slab_nx, ny, nz)

    v_np = np.asarray(vertices, np.float32)
    f_np = np.asarray(faces, np.int64)
    prep = _stream_prep(grid, slab_nx, v_np, f_np)
    tris, orig = prep.tris, prep.orig

    def slab_first(i):
        return grid.first_cell + jnp.asarray(
            [i * slab_nx, 0, 0], jnp.float32
        ) * grid.cell_size

    empty = _empty_edge(ny, nz)

    # Pass 1 (left→right): propagate boundary state; the right-edge states
    # stay ON DEVICE (n_slabs × ~6·(ny, nz) slices).
    right_edges = []
    carry = empty
    for i in range(n_slabs):
        _, hi, _lo = _slab_pass(
            slab_first(i), grid.cell_size, cell_count, tris, carry, empty,
            *prep.seeds[i], prep.n_shift_rounds,
        )
        right_edges.append(hi)
        carry = hi

    # Pass 2 (right→left): final state per slab; sign IN the loop. The
    # fetch runs ONE SLAB BEHIND the compute: while slab i's passes
    # execute, the (i+1)-th signed slab streams to the host.
    out = (np.empty((nx, ny, nz), np.float32) if out is None
           else out.reshape(nx, ny, nz))
    carry = empty
    pending = None  # (slab index, signed device array)
    for i in reversed(range(n_slabs)):
        left = right_edges[i - 1] if i > 0 else empty
        state, _hi, lo = _slab_pass(
            slab_first(i), grid.cell_size, cell_count, tris, left, carry,
            *prep.seeds[i], prep.n_shift_rounds,
        )
        carry = lo

        if sign_method == SignMethod.RAYCAST:
            signed = _slab_sign_raycast(
                slab_first(i), grid.cell_size, cell_count, state.d1, orig,
            )
        else:
            signed = cpt_mod.normal_sign_from_idx(
                Grid(first_cell=slab_first(i), cell_size=grid.cell_size,
                     cell_count=cell_count),
                tris[0], tris[1], tris[2], state.d1, state.i1,
            )
        if pending is not None:
            j, prev = pending
            out[j * slab_nx : (j + 1) * slab_nx] = np.asarray(prev)
        pending = (i, signed)
    if pending is not None:
        j, prev = pending
        out[j * slab_nx : (j + 1) * slab_nx] = np.asarray(prev)

    return out.reshape(-1)
