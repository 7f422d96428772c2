"""Closest-point-transform grid engine: seed + sweep, O(cells + tris).

The array redesign of the reference grid generator's first two phases
(`mesh_to_sdf/src/generate/grid.rs:234-264`):

=====================================  =========================================
reference (CPU)                        here (device arrays)
=====================================  =========================================
preheap: rasterize every triangle's    **seed**: fixed-size cell window per
  grid-snapped AABB (±1 cell guard,      triangle (AABB ±1 guard), exact
  `grid.rs:410-426`), RwLock min        distances, `scatter-min` + argmin
  (`grid.rs:444-454`)                    scatter — no locks
propagation: split-heap Dijkstra BFS   **sweep**: 6 directional
  over 26-neighbors, shared RwLock       Danielsson-style passes (`lax.scan`
  grid (`grid.rs:495-558`)               along the axis); each cell inherits
                                         candidate triangles from a 3×3
                                         neighbor window of the previous
                                         slice and re-evaluates the EXACT
                                         point-triangle distance — the carry
                                         holds the triangle's 9 vertex coords,
                                         so no gathers in the hot loop
=====================================  =========================================

Both the reference BFS and these sweeps are propagation schemes made safe by
full distance re-evaluation. Single-candidate propagation (and the
reference's single-state-per-cell BFS) can stall where a triangle's nearest
region ("pencil") narrows below a cell — so each cell carries its **two best
distinct triangles**; the runner-up flows through tie regions and unblocks
the winner. The contract asserted in
tests/test_cpt.py: never undershoots; exact within the seed band (≤1.5
cells of the surface); ≤2%-relative deviation beyond (observed ≤1.3%). The
reference's BFS is the same algorithm class — its exact-equality test
(`grid.rs:692-724`) holds on its specific meshes/resolutions, not in
general.

Sign is handled separately (line-parity kernels / normal champions).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..grid import Grid
from ..types import F32_MAX
from . import geometry

#: Per-triangle seed window (cells per axis); triangles spanning more cells
#: should be pre-subdivided (see :func:`subdivide_to_span`).
SEED_SPAN = 4
#: Vertex sentinel for "no triangle" (distance recompute yields ~1e36).
PAD_COORD = 1.0e18


class CptState(NamedTuple):
    """Per-cell best + runner-up (distinct triangle) closest-point state."""

    d1: jax.Array  # (...,)
    v1: jax.Array  # (..., 9) triangle vertices
    i1: jax.Array  # (...,) int32 triangle id
    d2: jax.Array
    v2: jax.Array
    i2: jax.Array


def _merge(state: CptState, d, v, i) -> CptState:
    """Insert candidate (d, v, i) keeping the two best with distinct ids."""
    same1 = i == state.i1
    b1 = d < state.d1

    nd1 = jnp.where(b1, d, state.d1)
    nv1 = jnp.where(b1[..., None], v, state.v1)
    ni1 = jnp.where(b1, i, state.i1)

    promote = b1 & ~same1  # old best demotes to runner-up
    cand2 = ~b1 & ~same1 & (d < state.d2)  # candidate lands in slot 2
    nd2 = jnp.where(promote, state.d1, jnp.where(cand2, d, state.d2))
    nv2 = jnp.where(
        promote[..., None], state.v1, jnp.where(cand2[..., None], v, state.v2)
    )
    ni2 = jnp.where(promote, state.i1, jnp.where(cand2, i, state.i2))
    return CptState(nd1, nv1, ni1, nd2, nv2, ni2)


def _merge_eval(state: CptState, cand_v, cand_i, centers) -> CptState:
    """Evaluate a candidate triangle set exactly, then merge."""
    d = geometry.point_triangle_distance(
        centers, cand_v[..., 0:3], cand_v[..., 3:6], cand_v[..., 6:9]
    )
    return _merge(state, d, cand_v, cand_i)


def _top2_distinct(d_all, v_all, i_all) -> CptState:
    """Select the best + best-distinct-triangle candidates along axis 0.

    d_all (K, ...); v_all (K, ..., 9); i_all (K, ...). One stacked evaluation
    replaces K sequential merges — far less HLO, bigger fused ops.
    """
    b1 = jnp.argmin(d_all, axis=0)

    def take(a, idx):
        return jnp.take_along_axis(a, idx[None], axis=0)[0]

    d1 = take(d_all, b1)
    i1 = take(i_all, b1)
    v1 = jnp.take_along_axis(v_all, b1[None, ..., None], axis=0)[0]
    masked = jnp.where(i_all == i1[None], F32_MAX, d_all)
    b2 = jnp.argmin(masked, axis=0)
    d2 = take(masked, b2)
    i2 = take(i_all, b2)
    v2 = jnp.take_along_axis(v_all, b2[None, ..., None], axis=0)[0]
    return CptState(d1, v1, i1, d2, v2, i2)


def _seed(grid: Grid, ta, tb, tc, span: int, runner_up: bool = True):
    """Scatter exact per-cell seeds from triangle AABB windows.

    Returns (dist (N,), tri_idx (N,), second-best dist/idx (N,)).
    ``runner_up=False`` skips the slot-2 scatters (the sweeps repopulate the
    runner-up from neighbors; quality measured in tests).

    Coverage (PER-AXIS only): the AABB±1 range can span up to ``span + 2``
    cells per axis at the subdivision bound (max_edge = (span-1.5)·cs), so
    TWO span-sized windows are rasterized per triangle — one anchored at the
    low corner, one ending at the high corner. Their union covers each AXIS
    range up to 2·span cells, but NOT the full 3-D product: a cell mixing
    the low window on one axis with the high window on another (≥2 axes
    exceeding ``span`` cells) gets no direct seed and relies on the sweeps
    to repair its distance. Callers needing the exact preheap-coverage
    guarantee must use :func:`build_seed_bins` / :func:`seed_from_bins`
    (this fallback remains for in-jit differentiable seeding)."""
    nx, ny, nz = grid.cell_count
    N = nx * ny * nz
    T = ta.shape[0]

    lo, hi = geometry.triangle_bounding_box(ta, tb, tc)
    bmin, _ = grid.bounding_box()
    cs = grid.cell_size
    lo_cell = jnp.floor((lo - bmin) / cs).astype(jnp.int32) - 1  # ±1 guard
    hi_cell = jnp.floor((hi - bmin) / cs).astype(jnp.int32) + 1
    counts = jnp.asarray(grid.cell_count, jnp.int32)
    base_lo = jnp.clip(lo_cell, 0, jnp.maximum(counts - span, 0))
    base_hi = jnp.clip(
        hi_cell - (span - 1), 0, jnp.maximum(counts - span, 0)
    )

    r = jnp.arange(span, dtype=jnp.int32)
    offs = jnp.stack(
        jnp.meshgrid(r, r, r, indexing="ij"), axis=-1
    ).reshape(-1, 3)  # (S³, 3)
    cells = jnp.concatenate(
        [
            base_lo[:, None, :] + offs[None, :, :],
            base_hi[:, None, :] + offs[None, :, :],
        ],
        axis=1,
    )  # (T, 2·S³, 3)
    in_box = jnp.all(
        (cells >= jnp.maximum(lo_cell, 0)[:, None, :])
        & (cells <= jnp.minimum(hi_cell, counts - 1)[:, None, :]),
        axis=-1,
    )
    centers = grid.cell_center(cells)
    d = geometry.point_triangle_distance(
        centers, ta[:, None, :], tb[:, None, :], tc[:, None, :]
    )
    d = jnp.where(in_box, d, F32_MAX).reshape(-1)
    flat = grid.cell_index(jnp.clip(cells, 0, counts - 1)).reshape(-1)

    dist = jnp.full((N,), F32_MAX, jnp.float32).at[flat].min(d)
    # Argmin scatter (two-pass): any triangle achieving the min wins.
    dmin_at = dist[flat]
    tri_ids = jnp.broadcast_to(
        jnp.arange(T, dtype=jnp.int32)[:, None], (T, 2 * span**3)
    ).reshape(-1)
    winner = jnp.where(d <= dmin_at, tri_ids, -1)
    tri_idx = jnp.full((N,), -1, jnp.int32).at[flat].max(winner)

    if not runner_up:
        N_ = dist.shape[0]
        return (
            dist,
            tri_idx,
            jnp.full((N_,), F32_MAX, jnp.float32),
            jnp.full((N_,), -1, jnp.int32),
        )
    # Runner-up (distinct triangle): same scheme with the winner masked out.
    is_winner = tri_ids == tri_idx[flat]
    d_rest = jnp.where(is_winner, F32_MAX, d)
    dist2 = jnp.full((N,), F32_MAX, jnp.float32).at[flat].min(d_rest)
    dmin2_at = dist2[flat]
    winner2 = jnp.where(d_rest <= dmin2_at, tri_ids, -1)
    tri_idx2 = jnp.full((N,), -1, jnp.int32).at[flat].max(winner2)
    return dist, tri_idx, dist2, tri_idx2


class SeedBins(NamedTuple):
    """Host-precomputed seed gather lists (see :func:`build_seed_bins`).

    entry_tri: (K, R) int32 — triangle ids per row, K-major so the long R
    axis is minor (coalesced loads along the long axis); rows_cell: (R,) int32 — flat cell index per row
    (N = padding rows); cell_row: (N,) int32 — each cell's FIRST row
    (-1 = unseeded; the inverse map, so the device spreads rows → cells
    with a pure gather, no conflicting scatter); n_shift_rounds: int — log2 rounds
    needed to combine a cell's rows (rows of one cell are consecutive).
    """

    entry_tri: object
    rows_cell: object
    cell_row: object
    n_shift_rounds: int


def build_seed_bins(grid: Grid, ha, hb, hc, *, k: int = 8,
                    pad: int = 1) -> SeedBins:
    """Rasterize every triangle's grid-snapped AABB ±``pad`` into per-cell
    gather lists — the reference preheap's rasterization (`grid.rs:383-456`,
    windows `grid.rs:410-426`) done with host integer ops, so the device
    seed is a pure gather + min (no scatter, no fixed-size window, and
    therefore no coverage gap: the full AABB±pad is covered exactly).

    ``pad`` sets the EXACT band: every cell whose center lies within
    ``(pad - 0.5)·cell_size`` of a triangle is seeded by that triangle
    directly (distance to the triangle ≥ distance to its AABB). Coarse
    grids use pad=3: the two-slot sweeps' worst mis-propagation sits at
    |d| ≈ 2·cell_size (measured suzanne/knight @24³, 2.6-8.8%% relative),
    inside the ±3 band; at production resolutions the relative error of
    the sweeps at that range is already inside the ≤2%% contract and the
    ~pad³ seed-volume growth would not amortize.

    numpy in / numpy out. Row layout: a cell with c candidate triangles
    occupies ceil(c/k) consecutive rows; the device combines them with
    ``n_shift_rounds`` shifted merges (:func:`seed_from_bins`).
    """
    import numpy as np

    ha = np.asarray(ha, np.float32)
    hb = np.asarray(hb, np.float32)
    hc = np.asarray(hc, np.float32)
    T = len(ha)
    counts = np.asarray(grid.cell_count, np.int64)
    N = int(counts.prod())
    bmin = np.asarray(grid.first_cell, np.float32) - 0.5 * np.asarray(
        grid.cell_size, np.float32
    )
    cs = np.asarray(grid.cell_size, np.float32)

    lo = np.minimum(np.minimum(ha, hb), hc) - 1e-4  # AABB_EPSILON inflation
    hi = np.maximum(np.maximum(ha, hb), hc) + 1e-4
    lo_cell = np.floor((lo - bmin) / cs).astype(np.int32) - pad
    hi_cell = np.floor((hi - bmin) / cs).astype(np.int32) + pad
    counts32 = counts.astype(np.int32)
    lo_cell = np.clip(lo_cell, 0, counts32 - 1)
    hi_cell = np.clip(hi_cell, 0, counts32 - 1)
    w = np.maximum(hi_cell - lo_cell + 1, 0)  # (T, 3) window extents
    n_per = w.prod(axis=1, dtype=np.int64)
    E = int(n_per.sum())
    if E == 0:
        entry = np.full((k, 8), T, np.int32)
        rows_cell = np.full((8,), N, np.int32)
        return SeedBins(entry, rows_cell, np.full((N,), -1, np.int32), 0)

    if N >= 2**31 - 1:
        # The numpy fallback below computes flat cell indices in int32 and
        # the SeedBins dtypes cannot represent N — corrupt bins, not an
        # error. Grids this large must go through the streamed/sharded
        # pipelines (per-slab bins keep N small).
        raise ValueError(
            f"build_seed_bins: grid has {N} cells (≥ 2^31-1); "
            "use the streamed or sharded grid pipeline"
        )
    from .. import native

    if native.available():  # C++ fast path (same layout contract)
        entry, rows_cell, cell_row, n_rounds = native.seed_bins(
            lo_cell, hi_cell, np.asarray(grid.cell_count, np.uint32), k
        )
        return SeedBins(entry, rows_cell, cell_row, n_rounds)

    # Expand windows grouped by (wx, wy, wz): triangles sharing a window
    # shape rasterize with one broadcast add — no per-entry divisions (the
    # naive arange-divmod formulation is ~15× slower on one core).
    base = int(w.max()) + 1
    shape_key = (w[:, 0].astype(np.int64) * base + w[:, 1]) * base + w[:, 2]
    uniq, inv = np.unique(shape_key, return_inverse=True)
    flat_parts = []
    tri_parts = []
    tri_ids = np.arange(T, dtype=np.int32)
    for j, key in enumerate(uniq):
        wz = int(key % base)
        wy = int((key // base) % base)
        wx = int(key // (base * base))
        if wx * wy * wz == 0:
            continue
        sel = np.flatnonzero(inv == j).astype(np.int32)
        oz = np.arange(wz, dtype=np.int32)
        oy = np.arange(wy, dtype=np.int32) * counts32[2]
        ox = np.arange(wx, dtype=np.int32) * (counts32[1] * counts32[2])
        offs = (
            ox[:, None, None] + oy[None, :, None] + oz[None, None, :]
        ).reshape(-1)
        lc = lo_cell[sel]
        base_flat = (
            lc[:, 0] * counts32[1] + lc[:, 1]
        ) * counts32[2] + lc[:, 2]
        flat_parts.append(
            (base_flat[:, None] + offs[None, :]).reshape(-1)
        )
        tri_parts.append(np.repeat(tri_ids[sel], wx * wy * wz))
    flat = np.concatenate(flat_parts)  # x-major (`grid.rs:122`)
    tri_of = np.concatenate(tri_parts)
    E = flat.shape[0]

    order = np.argsort(flat, kind="stable")
    flat_s = flat[order]
    tri_s = tri_of[order]

    seg_start = np.empty(E, bool)
    seg_start[0] = True
    np.not_equal(flat_s[1:], flat_s[:-1], out=seg_start[1:])
    seg_id = np.cumsum(seg_start) - 1  # 0..U-1
    U = int(seg_id[-1]) + 1
    # Rank of each entry within its segment.
    seg_first = np.flatnonzero(seg_start)
    rank = np.arange(E, dtype=np.int64) - seg_first[seg_id]
    c = np.diff(np.append(seg_first, E))  # (U,) candidates per cell
    rows_per = (c + k - 1) // k
    row_start = np.zeros(U + 1, np.int64)
    np.cumsum(rows_per, out=row_start[1:])
    R = int(row_start[-1])

    row = row_start[seg_id] + rank // k
    col = rank % k
    # Pad the row count to a power of two: bounds the number of distinct
    # compiled shapes (jit keys on R) to log2 buckets.
    R_pad = 1 << max(int(R - 1).bit_length(), 3)
    entry = np.full((k, R_pad), T, np.int32)
    entry[col, row] = tri_s
    rows_cell = np.full(R_pad, N, np.int32)
    rows_cell[row] = flat_s  # every row of a segment gets its cell id

    cell_row = np.full((N,), -1, np.int32)
    cell_row[flat_s[seg_first]] = row_start[:U].astype(np.int32)

    d_max = int(rows_per.max())
    n_rounds = max(int(np.ceil(np.log2(d_max))), 0) if d_max > 1 else 0
    return SeedBins(entry, rows_cell, cell_row, n_rounds)


def seed_pad_for(grid: Grid) -> int:
    """Adaptive seed-band half-width: coarse grids get ±3 (exact to
    2.5·cell_size — covers the sweeps' worst mis-propagation range,
    measured at |d| ≈ 2·cs on suzanne/knight @24³); production grids
    keep ±1 (the sweeps meet ≤2%% relative beyond the band there and the
    ~pad³ seed-volume growth would dominate the phase)."""
    return 3 if max(grid.cell_count) <= 48 else 1


def build_slab_seed_bins(grid: Grid, n_slabs: int, ha, hb, hc, *,
                         k: int = 8) -> SeedBins:
    """Per-x-slab :func:`build_seed_bins`, padded to COMMON shapes and
    stacked on a leading (n_slabs,) axis — the host half of seeding the
    sharded (parallel/grid_sharded.py) and streamed (gridgen_streamed.py)
    pipelines with the exact binned seeds instead of the window scatter.
    One compiled device program serves
    every slab because all slabs share the padded row count.

    numpy in / numpy out. ``n_slabs`` must divide ``grid.cell_count[0]``.
    """
    import numpy as np

    nx, ny, nz = grid.cell_count
    if nx % n_slabs:
        raise ValueError(f"n_slabs={n_slabs} must divide nx={nx}")
    slab_nx = nx // n_slabs
    fc = np.asarray(grid.first_cell, np.float32)
    cs = np.asarray(grid.cell_size, np.float32)
    bins = []
    for i in range(n_slabs):
        slab = Grid(
            first_cell=fc + np.asarray([i * slab_nx, 0, 0], np.float32) * cs,
            cell_size=cs,
            cell_count=(slab_nx, ny, nz),
        )
        bins.append(build_seed_bins(slab, ha, hb, hc, k=k,
                                    pad=seed_pad_for(grid)))
    T = len(np.asarray(ha))
    N_slab = slab_nx * ny * nz
    R_max = max(b.entry_tri.shape[1] for b in bins)
    n_rounds = max(b.n_shift_rounds for b in bins)
    entry = np.full((n_slabs, k, R_max), T, np.int32)
    rows_cell = np.full((n_slabs, R_max), N_slab, np.int32)
    cell_row = np.empty((n_slabs, N_slab), np.int32)
    for i, b in enumerate(bins):
        r = b.entry_tri.shape[1]
        entry[i, :, :r] = b.entry_tri
        rows_cell[i, :r] = b.rows_cell
        cell_row[i] = b.cell_row
    return SeedBins(entry, rows_cell, cell_row, n_rounds)


def _combine_top2(d1a, i1a, d2a, i2a, d1b, i1b, d2b, i2b):
    """Merge two (best, runner-up-distinct) candidate pairs, branchless."""
    a_first = d1a <= d1b
    n_d1 = jnp.where(a_first, d1a, d1b)
    n_i1 = jnp.where(a_first, i1a, i1b)
    # Runner-up: best among {loser's d1, both d2} with a distinct id.
    cand_d = jnp.stack([jnp.where(a_first, d1b, d1a), d2a, d2b])
    cand_i = jnp.stack([jnp.where(a_first, i1b, i1a), i2a, i2b])
    cand_d = jnp.where(cand_i == n_i1[None], F32_MAX, cand_d)
    b = jnp.argmin(cand_d, axis=0)
    n_d2 = jnp.take_along_axis(cand_d, b[None], axis=0)[0]
    n_i2 = jnp.take_along_axis(cand_i, b[None], axis=0)[0]
    return n_d1, n_i1, n_d2, n_i2


def _pt_dist(cx, cy, cz, v):
    """Exact point-triangle distance from coordinate planes: point planes
    (cx, cy, cz), triangle vertex planes v (9, …) = (a, b, c) xyz."""
    ap = (cx - v[0], cy - v[1], cz - v[2])
    ab = (v[3] - v[0], v[4] - v[1], v[5] - v[2])
    ac = (v[6] - v[0], v[7] - v[1], v[8] - v[2])
    vw = geometry.closest_point_vw(*ap, *ab, *ac)
    return jnp.sqrt(geometry.dist2_vw(*ap, *vw))


def seed_from_bins(grid: Grid, ta, tb, tc, bins: SeedBins):
    """Exact per-cell seeds from host-precomputed gather lists.

    Device-side half of :func:`build_seed_bins`: one dense (K, R) distance
    evaluation + log2(D) shifted merges + a unique-index scatter — no
    conflicting scatter anywhere. Returns flat (N,) (d1, i1, d2, i2).

    All arrays are laid out K-major / coordinate-planes-separate, so every
    elementwise pass runs along the long R axis.
    """
    nx, ny, nz = grid.cell_count
    N = nx * ny * nz
    T = ta.shape[0]
    entry = jnp.asarray(bins.entry_tri)  # (K, R)
    rows_cell = jnp.asarray(bins.rows_cell)  # (R,)

    # ONE row-gather of 9-float payloads, then transpose the payload axis
    # major (one gather instead of nine scalar-table gathers).
    tv = jnp.concatenate([ta, tb, tc], axis=-1)  # (T, 9)
    tv = jnp.concatenate([tv, jnp.full((1, 9), PAD_COORD, jnp.float32)])
    v = jnp.transpose(tv[entry], (2, 0, 1))  # (9, K, R)

    safe_cell = jnp.minimum(rows_cell, N - 1)
    czi = safe_cell % nz
    cyi = (safe_cell // nz) % ny
    cxi = safe_cell // (ny * nz)
    fc = grid.first_cell
    cs = grid.cell_size
    cx = fc[0] + cxi.astype(jnp.float32) * cs[0]  # (R,) coordinate planes
    cy = fc[1] + cyi.astype(jnp.float32) * cs[1]
    cz = fc[2] + czi.astype(jnp.float32) * cs[2]

    d = _pt_dist(cx[None, :], cy[None, :], cz[None, :], v)  # (K, R)
    d = jnp.where(entry == T, F32_MAX, d)

    # Per-row top-2 distinct (reduce over the K axis 0).
    b1 = jnp.argmin(d, axis=0)
    d1 = jnp.take_along_axis(d, b1[None, :], axis=0)[0]
    i1 = jnp.take_along_axis(entry, b1[None, :], axis=0)[0]
    masked = jnp.where(entry == i1[None, :], F32_MAX, d)
    b2 = jnp.argmin(masked, axis=0)
    d2 = jnp.take_along_axis(masked, b2[None, :], axis=0)[0]
    i2 = jnp.take_along_axis(entry, b2[None, :], axis=0)[0]

    # Combine consecutive rows of the same cell (≤ 2^n_rounds rows/cell).
    for s_exp in range(bins.n_shift_rounds):
        s = 1 << s_exp
        same = jnp.concatenate(
            [rows_cell[s:] == rows_cell[:-s], jnp.zeros((s,), bool)]
        )
        sh = lambda a, fill: jnp.concatenate(
            [a[s:], jnp.full((s,) + a.shape[1:], fill, a.dtype)]
        )
        m_d1, m_i1, m_d2, m_i2 = _combine_top2(
            d1, i1, d2, i2, sh(d1, F32_MAX), sh(i1, T), sh(d2, F32_MAX),
            sh(i2, T),
        )
        d1 = jnp.where(same, m_d1, d1)
        i1 = jnp.where(same, m_i1, i1)
        d2 = jnp.where(same, m_d2, d2)
        i2 = jnp.where(same, m_i2, i2)

    # Empty slots: argmin over all-F32_MAX candidates returns an arbitrary
    # id — force the sentinel whenever the distance says "no candidate".
    i1 = jnp.where((i1 >= T) | (d1 >= F32_MAX), -1, i1)
    i2 = jnp.where((i2 >= T) | (d2 >= F32_MAX), -1, i2)

    # Spread rows → cells as ONE row-gather through the host-precomputed
    # inverse map (each cell's first — fully-combined — row) instead of an
    # N-target scatter or a searchsorted. Ints ride along bitcast to f32.
    cell_row = jnp.asarray(bins.cell_row)  # (N,)
    packed = jnp.stack(
        [
            d1,
            jax.lax.bitcast_convert_type(i1, jnp.float32),
            d2,
            jax.lax.bitcast_convert_type(i2, jnp.float32),
        ],
        axis=-1,
    )  # (R, 4)
    hit = cell_row >= 0
    pos = jnp.maximum(cell_row, 0)
    rows = packed[pos]  # (N, 4) row-gather
    out_d1 = jnp.where(hit, rows[:, 0], F32_MAX)
    out_i1 = jnp.where(
        hit, jax.lax.bitcast_convert_type(rows[:, 1], jnp.int32), -1
    )
    out_d2 = jnp.where(hit, rows[:, 2], F32_MAX)
    out_i2 = jnp.where(
        hit, jax.lax.bitcast_convert_type(rows[:, 3], jnp.int32), -1
    )
    return out_d1, out_i1, out_d2, out_i2


def _sweep_axis0(state: CptState, centers) -> CptState:
    """One forward sweep along axis 0 (flips/transposes cover the rest).

    Full 18-candidate schedule (best + runner-up from all 9 neighbor
    columns). A reduced runner-up window (``slot2_center``, round 3/4)
    measured ~0.04 s faster at 256³ but cost up to ~1% extra far-field
    relative error — half the ≤2% CPT contract's headroom — and was
    dropped (.campaign/phase256.log, ROADMAP.md)."""

    def step(carry: CptState, xs):
        row, centers_row = xs
        pad2 = lambda a: jnp.pad(a, ((1, 1), (1, 1)), constant_values=-1)
        padv = lambda a: jnp.pad(
            a, ((1, 1), (1, 1), (0, 0)), constant_values=PAD_COORD
        )
        pv1, pi1 = padv(carry.v1), pad2(carry.i1)
        pv2, pi2 = padv(carry.v2), pad2(carry.i2)
        n1, n2 = row.d1.shape
        cv, ci = [], []
        for dy in (0, 1, 2):
            for dz in (0, 1, 2):
                cv.append(pv1[dy : dy + n1, dz : dz + n2])
                ci.append(pi1[dy : dy + n1, dz : dz + n2])
                cv.append(pv2[dy : dy + n1, dz : dz + n2])
                ci.append(pi2[dy : dy + n1, dz : dz + n2])
        cv = jnp.stack(cv)
        ci = jnp.stack(ci)
        d = geometry.point_triangle_distance(
            centers_row[None], cv[..., 0:3], cv[..., 3:6], cv[..., 6:9]
        )
        d_all = jnp.concatenate([row.d1[None], row.d2[None], d], axis=0)
        v_all = jnp.concatenate([row.v1[None], row.v2[None], cv], axis=0)
        i_all = jnp.concatenate([row.i1[None], row.i2[None], ci], axis=0)
        row = _top2_distinct(d_all, v_all, i_all)
        return row, row

    n1, n2 = state.d1.shape[1:]
    init = CptState(
        jnp.full((n1, n2), F32_MAX, jnp.float32),
        jnp.full((n1, n2, 9), PAD_COORD, jnp.float32),
        jnp.full((n1, n2), -1, jnp.int32),
        jnp.full((n1, n2), F32_MAX, jnp.float32),
        jnp.full((n1, n2, 9), PAD_COORD, jnp.float32),
        jnp.full((n1, n2), -1, jnp.int32),
    )
    _, out = jax.lax.scan(step, init, (state, centers))
    return out


def _oriented(vol, axis, reverse, ch=False):
    """View with `axis` first and optionally reversed."""
    perm = {0: (0, 1, 2), 1: (1, 0, 2), 2: (2, 0, 1)}[axis]
    inv = {0: (0, 1, 2), 1: (1, 0, 2), 2: (1, 2, 0)}[axis]
    if ch:
        perm = perm + (3,)
        inv = inv + (3,)
    v = jnp.transpose(vol, perm)
    if reverse:
        v = v[::-1]
    return v, inv


def _unorient(vol, axis, reverse, ch=False):
    inv = {0: (0, 1, 2), 1: (1, 0, 2), 2: (1, 2, 0)}[axis]
    if ch:
        inv = inv + (3,)
    if reverse:
        vol = vol[::-1]
    return jnp.transpose(vol, inv)


_DIRS = [(axis, rev) for axis in (0, 1, 2) for rev in (False, True)]


def _sweep_batched(state: CptState, centers) -> CptState:
    """All 6 directional sweeps in ONE lax.scan (batched Jacobi step).

    Cuts sequential step count 6x vs running the sweeps one after another —
    scans at this slice size are latency-bound, not flop-bound. Each
    direction propagates independently from the same input state; results are
    merged afterwards. Two batched rounds reach the sequential fixed point
    (asserted in tests).
    """
    # Only cubic grids can batch all 6 views into one scan (equal axis
    # lengths). Non-cubic grids fall back to sequential sweeps.
    views = []
    cviews = []
    for axis, rev in _DIRS:
        fields = []
        for name in state._fields:
            vol = getattr(state, name)
            v0, _ = _oriented(vol, axis, rev, ch=vol.ndim == 4)
            fields.append(v0)
        views.append(CptState(*fields))
        c0, _ = _oriented(centers, axis, rev, ch=True)
        cviews.append(c0)

    stacked = CptState(
        *[jnp.stack([getattr(v, n) for v in views], axis=1)
          for n in CptState._fields]
    )  # each field: (n0, 6, n1, n2[, ch])
    cstack = jnp.stack(cviews, axis=1)

    # Chunk CHUNK slices per scan step: scans at this slice size are
    # launch-overhead bound, so amortize it across an unrolled inner loop.
    n0 = state.d1.shape[0]
    chunk = 1
    for c in (8, 4, 2):
        if n0 % c == 0:
            chunk = c
            break

    def regroup(a):
        return a.reshape((n0 // chunk, chunk) + a.shape[1:])

    stacked = CptState(*[regroup(getattr(stacked, n)) for n in CptState._fields])
    cstack = regroup(cstack)

    def update_row(carry, row, centers_row):
        pad2 = lambda a: jnp.pad(a, ((0, 0), (1, 1), (1, 1)), constant_values=-1)
        padv = lambda a: jnp.pad(
            a, ((0, 0), (1, 1), (1, 1), (0, 0)), constant_values=PAD_COORD
        )
        pv1, pi1 = padv(carry.v1), pad2(carry.i1)
        pv2, pi2 = padv(carry.v2), pad2(carry.i2)
        n1, n2 = row.d1.shape[1:]
        cv, ci = [], []
        for dy in (0, 1, 2):
            for dz in (0, 1, 2):
                cv.append(pv1[:, dy : dy + n1, dz : dz + n2])
                ci.append(pi1[:, dy : dy + n1, dz : dz + n2])
                cv.append(pv2[:, dy : dy + n1, dz : dz + n2])
                ci.append(pi2[:, dy : dy + n1, dz : dz + n2])
        cv = jnp.stack(cv)  # (18, 6, n1, n2, 9)
        ci = jnp.stack(ci)
        d = geometry.point_triangle_distance(
            centers_row[None], cv[..., 0:3], cv[..., 3:6], cv[..., 6:9]
        )
        d_all = jnp.concatenate([row.d1[None], row.d2[None], d], axis=0)
        v_all = jnp.concatenate([row.v1[None], row.v2[None], cv], axis=0)
        i_all = jnp.concatenate([row.i1[None], row.i2[None], ci], axis=0)
        return _top2_distinct(d_all, v_all, i_all)

    def step(carry: CptState, xs):
        block, centers_block = xs  # fields: (chunk, 6, n1, n2[, ch])
        outs = []
        for k in range(chunk):
            row = CptState(*[getattr(block, n)[k] for n in CptState._fields])
            carry = update_row(carry, row, centers_block[k])
            outs.append(carry)
        out = CptState(
            *[jnp.stack([getattr(o, n) for o in outs]) for n in CptState._fields]
        )
        return carry, out

    n1, n2 = state.d1.shape[1:]
    init = CptState(
        jnp.full((6, n1, n2), F32_MAX, jnp.float32),
        jnp.full((6, n1, n2, 9), PAD_COORD, jnp.float32),
        jnp.full((6, n1, n2), -1, jnp.int32),
        jnp.full((6, n1, n2), F32_MAX, jnp.float32),
        jnp.full((6, n1, n2, 9), PAD_COORD, jnp.float32),
        jnp.full((6, n1, n2), -1, jnp.int32),
    )
    _, out = jax.lax.scan(step, init, (stacked, cstack))
    out = CptState(
        *[getattr(out, n).reshape((n0,) + getattr(out, n).shape[2:])
          for n in CptState._fields]
    )

    # Un-orient each direction's result and merge into the input state.
    merged = state
    for k, (axis, rev) in enumerate(_DIRS):
        fields = {}
        for name in CptState._fields:
            vol = getattr(out, name)[:, k]
            fields[name] = _unorient(vol, axis, rev, ch=vol.ndim == 4)
        merged = _merge(merged, fields["d1"], fields["v1"], fields["i1"])
        merged = _merge(merged, fields["d2"], fields["v2"], fields["i2"])
    return merged


@functools.partial(
    jax.jit, static_argnames=("rounds", "span")
)
def closest_point_grid(
    grid: Grid,
    ta: jax.Array,  # (T, 3)
    tb: jax.Array,
    tc: jax.Array,
    *,
    rounds: int = 1,
    span: int = SEED_SPAN,
    seed=None,  # optional precomputed (d1, i1, d2, i2) flat seeds
) -> Tuple[jax.Array, jax.Array]:
    """Unsigned distance + nearest-triangle index for every cell.

    Returns (dist (nx, ny, nz) f32, tri_idx (nx, ny, nz) int32).
    """
    nx, ny, nz = grid.cell_count
    T = ta.shape[0]

    d1, i1, d2, i2 = seed if seed is not None else _seed(
        grid, ta, tb, tc, span
    )

    tv = jnp.concatenate([ta, tb, tc], axis=-1)  # (T, 9)
    tv = jnp.concatenate(
        [tv, jnp.full((1, 9), PAD_COORD, jnp.float32)], axis=0
    )
    shape = (nx, ny, nz)
    state = CptState(
        d1.reshape(shape),
        tv[jnp.where(i1 < 0, T, i1)].reshape(shape + (9,)),
        i1.reshape(shape),
        d2.reshape(shape),
        tv[jnp.where(i2 < 0, T, i2)].reshape(shape + (9,)),
        i2.reshape(shape),
    )
    centers = grid.all_cell_centers()  # (nx, ny, nz, 3)

    cubic = nx == ny == nz
    if cubic:
        # Batched Jacobi sweeps: 6 directions per scan; two batched rounds
        # reach the sequential fixed point (validated in tests).
        for _ in range(rounds + 1):
            state = _sweep_batched(state, centers)
    else:
        for _ in range(rounds):
            for axis in (0, 1, 2):
                for reverse in (False, True):
                    fields = []
                    inv = inv_ch = None
                    for name in state._fields:
                        vol = getattr(state, name)
                        is_ch = vol.ndim == 4
                        v0, ip = _oriented(vol, axis, reverse, ch=is_ch)
                        fields.append(v0)
                        if is_ch:
                            inv_ch = ip
                        else:
                            inv = ip
                    c0, _ = _oriented(centers, axis, reverse, ch=True)
                    out = _sweep_axis0(CptState(*fields), c0)
                    res = []
                    for name in out._fields:
                        vol = getattr(out, name)
                        if reverse:
                            vol = vol[::-1]
                        res.append(
                            jnp.transpose(vol, inv_ch if vol.ndim == 4 else inv)
                        )
                    state = CptState(*res)
    return state.d1, state.i1


def subdivide_to_span(vertices, faces, max_edge: float, max_tris: int = 4_000_000,
                      return_parents: bool = False):
    """Host-side longest-edge subdivision until every edge ≤ max_edge.

    Keeps the surface identical, so distances/signs are unchanged. Used to
    bound each triangle's AABB (and hence its rasterized seed volume /
    window coverage — a triangle's per-axis extent is at most its longest
    edge). numpy in/out. With
    ``return_parents`` also returns each output triangle's ORIGINAL face
    index (for gradient paths: the closest point on a sub-triangle lies on
    its parent, so barycentric gradients are taken w.r.t. the parent).
    """
    import numpy as np

    v = np.asarray(vertices, np.float32)
    tris = v[np.asarray(faces, np.int64)]  # (T, 3, 3) standalone soup
    parents = np.arange(len(tris), dtype=np.int64)
    while len(tris) < max_tris:
        e0 = np.linalg.norm(tris[:, 1] - tris[:, 0], axis=1)
        e1 = np.linalg.norm(tris[:, 2] - tris[:, 1], axis=1)
        e2 = np.linalg.norm(tris[:, 0] - tris[:, 2], axis=1)
        longest = np.stack([e0, e1, e2], 1)
        which = longest.argmax(1)
        lmax = longest.max(1)
        split = lmax > max_edge
        if not split.any():
            break
        keep = tris[~split]
        keep_p = parents[~split]
        s = tris[split]
        sp = parents[split]
        w = which[split]
        a, b, c = s[:, 0], s[:, 1], s[:, 2]
        # rotate so the longest edge is (a, b)
        a2 = np.where(w[:, None] == 1, b, np.where(w[:, None] == 2, c, a))
        b2 = np.where(w[:, None] == 1, c, np.where(w[:, None] == 2, a, b))
        c2 = np.where(w[:, None] == 1, a, np.where(w[:, None] == 2, b, c))
        m = (a2 + b2) / 2
        t1 = np.stack([a2, m, c2], 1)
        t2 = np.stack([m, b2, c2], 1)
        tris = np.concatenate([keep, t1, t2])
        parents = np.concatenate([keep_p, sp, sp])
    if return_parents:
        return tris[:, 0], tris[:, 1], tris[:, 2], parents
    return tris[:, 0], tris[:, 1], tris[:, 2]


def normal_sign_from_idx(grid: Grid, ta, tb, tc, dist, idx):
    """Sign unsigned CPT distances by the nearest triangle's normal side.

    The reference Rtree backend's semantics (`rtree.rs:96-126`): only the
    single nearest triangle decides the sign, which its own tests allow to
    disagree with the champion reduction on ~1% of cells near edges
    (`rtree.rs:171-242`). dot == 0 counts negative (`geo.rs:51-55`).
    """
    centers = grid.all_cell_centers().reshape(-1, 3)
    safe = jnp.maximum(idx.reshape(-1), 0)
    a = ta[safe]
    b = tb[safe]
    c = tc[safe]
    n = jnp.cross(b - a, c - a)
    d = jnp.sum((centers - a) * n, axis=-1)
    sign = jnp.where(d > 0.0, 1.0, -1.0)
    sign = jnp.where(idx.reshape(-1) < 0, 1.0, sign)
    return (dist.reshape(-1) * sign).reshape(grid.cell_count)
