"""Two-phase tile culling — the array analog of R-tree/BVH pruning.

The reference prunes per-query with trees (`rtree.rs:96-126`,
`bvh_ext.rs:59-168`). Here the equivalent is *coarse-to-fine tiling*:

Phase A (coarse): compute, for each spatial tile of queries/cells, the exact
min distance D from the tile center to all triangles (cheap: #tiles ≪ #queries).
Any triangle that can win for some point in a tile of half-diagonal r must
satisfy ``dist(center, tri) ≤ D + 2r`` (triangle-inequality bound). Select the
top-K nearest triangles per tile.

Phase B (fine): exact dense min over only the K candidates per tile.

Exactness: guaranteed when all triangles within the bound fit in K; the
selection records a per-tile ``overflow`` flag (k-th candidate still inside the
bound) so callers can widen K or fall back. This mirrors the reference's own
pragmatism (its Rtree sign is allowed ~1% mismatch, `rtree.rs:171-242`).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..grid import Grid
from ..types import F32_MAX, SignMethod
from . import block_index, brute, dense, geometry
from .keyed import combine_champions

#: Default candidate budget per tile.
DEFAULT_K = 512
#: Candidate-block budget per sub-tile for the gathered dense engine.
DEFAULT_KG = 32
#: Widened budget for the second gather round over certificate-flagged
#: queries (the R-tree descent's frontier expansion, `bvh_ext.rs:102-168`):
#: a sub-tile whose within-bound block count exceeds DEFAULT_KG re-runs at
#: this budget before any dense fallback.
DEFAULT_KG_WIDE = 128

#: Telemetry from the most recent fused CULLED pass (certificate flag
#: count, culled-work fraction, config) — the query-path analog of the
#: client's LastRunInfo (`sdf_program.rs:716-719`). Read-only for callers.
LAST_CULLED_STATS: dict = {}


def select_candidates(tile_centers, tile_radius, ta, tb, tc, valid, k):
    """Phase A: top-k nearest triangles per tile + exactness telemetry.

    tile_centers: (Nt, 3); tile_radius: scalar or (Nt,). Returns
    (idx (Nt, k) int32, overflow (Nt,) bool, n_within (Nt,) int32) where
    ``n_within`` counts triangles inside the conservative bound — when it
    exceeds k (``overflow``) the caller re-runs with k ≥ max(n_within),
    which is guaranteed exact.
    """
    d = geometry.point_triangle_distance(
        tile_centers[:, None, :], ta[None, :, :], tb[None, :, :], tc[None, :, :]
    )
    d = jnp.where(valid[None, :], d, F32_MAX)
    neg_d, idx = jax.lax.top_k(-d, k)  # k smallest distances
    dmin = -neg_d[:, 0]
    bound = dmin + 2.0 * tile_radius
    n_within = jnp.sum(d <= bound[:, None], axis=1).astype(jnp.int32)
    overflow = n_within > k
    return idx.astype(jnp.int32), overflow, n_within


#: Self-tuned routing decisions: (n_blocks, tb, log2-bucketed Q) → True
#: when a measured culled pass on that (mesh, batch-size) shape showed the
#: fused brute kernel is cheaper. First call per shape always runs culled
#: and records; repeated calls (the criterion benchmark pattern, and any
#: editing/optimization loop) get the winner. Keyed on block-structure
#: numbers rather than mesh content: a collision only costs performance,
#: never correctness (both engines are exact).
_ROUTE_CACHE: dict = {}


def _route_key(bi, Q: int):
    # content_key distinguishes meshes with equal block structure so one
    # mesh's measured routing never silently applies to another.
    return (bi.n_blocks, bi.tb, getattr(bi, "content_key", 0),
            max(int(Q) - 1, 1).bit_length())


def _route_to_brute(bi, Q: int) -> bool:
    return _ROUTE_CACHE.get(_route_key(bi, Q), False)


def _record_route(bi, Q: int, work_frac: float, *, st: int,
                  k_fix_frac: float) -> None:
    """Record whether culling paid on this workload shape.

    Predicted culled/brute cost ratio: kernel pair-work fraction + the
    always-paid static fix-up subset + phase-A/sort/certificate overhead
    (~5%). ≥0.85 ⇒ culling cannot beat the fused brute kernel — remember
    to route this shape straight to brute.
    """
    predicted = work_frac + k_fix_frac + 0.05
    _ROUTE_CACHE[_route_key(bi, Q)] = bool(predicted >= 0.85)


def query_sdf_culled(queries, ta, tb, tc, valid, *, sign_method, raycast_axes=3,
                     k: int = DEFAULT_K, tile: int = 1024, parity_bins=None,
                     n_valid_tris: Optional[int] = None, sign_grid=None,
                     block_index=None, st=None):
    """generate_sdf with Morton-ordered query tiling + candidate culling —
    the analog of the reference's Rtree/RtreeBvh backends (`rtree.rs:96-126`,
    `rtree_bvh.rs:123-173`). Exact: queries whose certificate fails are
    recomputed by the dense engine (:mod:`.dense`). Falls back to the dense
    engine when the triangle count is within ~2x of k (culling overhead
    wouldn't pay).

    With ``block_index`` and ``sign_grid`` (raycast sign), one gathered pass
    per query sub-tile yields distance AND sign (anchor-segment parity
    against the sub-tile's nearest blocks). Otherwise the top-k tile path
    computes distances and the sign comes from the sign-grid transfer
    (:func:`build_sign_grid` / :func:`signs_from_grid`) or, with
    ``parity_bins`` (a 3-tuple of :class:`ParityBins`), from full
    per-query tile-binned crossing counts.
    """
    T = int(ta.shape[0])
    n_valid = int(jnp.sum(valid)) if n_valid_tris is None else n_valid_tris
    if T <= 2 * k:
        return dense.signed_distance(
            queries, ta, tb, tc, valid, sign_method=sign_method,
            raycast_axes=raycast_axes, n_valid=n_valid,
        )
    if (block_index is not None and sign_method == SignMethod.RAYCAST
            and sign_grid is not None):
        return _query_culled_gather(
            queries, ta, tb, tc, block_index, sign_grid,
            n_valid=n_valid, raycast_axes=raycast_axes, st=st,
        )

    dist, q_overflow = _query_culled_dist(
        queries, ta, tb, tc, valid, sign_method=sign_method, k=k, tile=tile,
    )
    if q_overflow is not None:
        # Queries in tiles whose bound holds > k triangles (typically sparse
        # Morton tiles spanning a huge region): recompute JUST those with
        # the dense engine — per-tile adaptivity instead of a global retry
        # (one bad tile must not force O(Q·T) on everyone). Stays exact.
        bad_idx = jnp.asarray(np.flatnonzero(np.asarray(q_overflow)))
        sub = dense.signed_distance(
            queries[bad_idx], ta, tb, tc, valid, sign_method=sign_method,
            raycast_axes=0, n_valid=n_valid,
        )
        dist = dist.at[bad_idx].set(sub)

    if sign_method == SignMethod.RAYCAST:
        if parity_bins is not None and (
            sign_grid is None or queries.shape[0] <= PARITY_ALL_MAX
        ):
            # Small batches: exact tile-binned parity for EVERY query in
            # one fixed-shape pass — cheaper than sign-grid transfer plus
            # its data-dependent near-shell fallback (a host round trip).
            inside = _binned_inside(
                queries, ta, tb, tc, parity_bins, raycast_axes, n_valid,
            )
        else:
            sg = sign_grid if sign_grid is not None else build_sign_grid(
                ta, tb, tc, valid
            )
            inside = signs_from_grid(
                queries, dist, sg, ta, tb, tc, valid, raycast_axes,
                parity_bins=parity_bins,
            )
        dist = jnp.where(inside, -dist, dist)
    return dist


def _query_culled_gather(queries, ta, tb, tc, bi, sign_grid, *, n_valid,
                         raycast_axes, st=None):
    """The gathered CULLED path: phase A + per-sub-tile dense pass with
    fused anchor sign, widened retry and in-jit dense fix-up (one program),
    then a host fix-up only if the static fix-up budget overflowed."""
    Q = queries.shape[0]
    default_cfg = st is None
    if default_cfg and _route_to_brute(bi, Q):
        # Self-tuned route: a previous call on this mesh at this batch size
        # measured the culled work fraction high enough that the dense
        # engine is faster (small batches over few blocks — the sub-tiles'
        # candidate windows hold most of the soup). ≙ the reference docs
        # steering method choice by workload (`README.md:108-121`).
        return dense.signed_distance(
            queries, ta, tb, tc, sign_method=SignMethod.RAYCAST,
            raycast_axes=raycast_axes, n_valid=n_valid,
        )
    if st is None:
        # Measured on FlightHelmet: st=32 fastest for criterion-sized
        # batches, st=64 for ≥262k (flag counts are st-insensitive).
        st = 32 if Q < 262_144 else 64
    # The in-jit dense fix-up runs UNCONDITIONALLY at k_fix queries
    # (static shape): cap its pair budget (k_fix·T) so the always-paid
    # subset stays a few percent of the culled work even at millions of
    # triangles (the widen round leaves only a residue of flags).
    k_fix = min(max(4096, Q // 32), 65_536,
                max(4096, int(6e9) // max(n_valid, 1)))
    ra, rb, rc = ta[:n_valid], tb[:n_valid], tc[:n_valid]
    signed, flag, n_flag, work_frac = _culled_signed_fixup_impl(
        queries, bi, sign_grid.inside, sign_grid.grid, ra, rb, rc,
        st=st, kg=DEFAULT_KG, k_fix=k_fix, raycast_axes=raycast_axes,
    )
    if default_cfg:
        _record_route(bi, Q, float(work_frac), st=st,
                      k_fix_frac=k_fix / max(Q, 1))
    # Telemetry for benchmarks/observability (≙ the client's LastRunInfo,
    # `sdf_program.rs:716-719`): certificate flag count, culled-work
    # fraction, and the shapes that produced them.
    LAST_CULLED_STATS.clear()
    LAST_CULLED_STATS.update(
        queries=int(Q), tris=int(n_valid),
        n_flagged=int(n_flag), flag_frac=round(int(n_flag) / max(Q, 1), 5),
        work_frac=round(float(work_frac), 5), k_fix=int(k_fix), st=int(st),
    )
    if int(n_flag) > k_fix:
        # Budget blown: the in-jit fix-up took the first k_fix flagged
        # queries; recompute the rest here — exactness never depends on
        # k_fix.
        bad_idx = jnp.asarray(np.flatnonzero(np.asarray(flag))[k_fix:])
        sub = dense.signed_distance(
            queries[bad_idx], ra, rb, rc, sign_method=SignMethod.RAYCAST,
            raycast_axes=raycast_axes,
        )
        signed = signed.at[bad_idx].set(sub)
    return signed


#: Below this many queries, exact binned parity on ALL queries beats the
#: sign-grid transfer + near-shell fallback (fewer dispatches, no subset
#: round-trip).
PARITY_ALL_MAX = 131_072


@functools.partial(jax.jit, static_argnames=("raycast_axes", "n_valid"))
def _binned_inside(queries, ta, tb, tc, parity_bins, raycast_axes, n_valid):
    counts = binned_parity_counts(
        queries, ta, tb, tc, parity_bins[:raycast_axes], n_valid=n_valid
    )
    odd = counts % 2 == 1
    if raycast_axes == 1:
        return odd[:, 0]
    return jnp.sum(odd, axis=1) >= 2


# ---------------------------------------------------------------- internals
def _morton_order(points):
    """Sort order by 21-bit-per-axis Morton code (spatial coherence for tiles)."""
    p = points
    lo = jnp.min(p, axis=0)
    hi = jnp.max(p, axis=0)
    scale = jnp.where(hi > lo, 1024.0 / (hi - lo), 0.0)
    q = jnp.clip(((p - lo) * scale), 0, 1023).astype(jnp.uint32)

    def spread(x):  # interleave 10 bits with 2-bit gaps
        x = (x | (x << 16)) & jnp.uint32(0x030000FF)
        x = (x | (x << 8)) & jnp.uint32(0x0300F00F)
        x = (x | (x << 4)) & jnp.uint32(0x030C30C3)
        x = (x | (x << 2)) & jnp.uint32(0x09249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return jnp.argsort(code)


def _ceil_pow2(n: int) -> int:
    k = 1
    while k < n:
        k *= 2
    return k


def _sign_epilogue(qs, cellq, anch, bmin, bmax, inside3, dist, cnt, cert):
    """Anchor-transfer sign + certificate logic of the gathered pass.

    Every query's sign anchor is its sign-grid cell center; the pass counts
    query→anchor segment crossings against the SAME candidate blocks it
    reduces distances over. Transferable queries (``dist > |q−anchor|`` —
    the segment provably cannot cross the surface) copy the anchor's sign;
    shell queries XOR it with the segment parity. Flags per query: the
    distance certificate plus a segment certificate ``cert ≥ |q−anchor|``
    (an excluded triangle crossing the segment would be nearer than cert —
    contradiction). qs/anch: (Q, 3) queries and their sign-grid anchors; cellq:
    (Q, 3) anchor cells; dist/cnt: kernel outputs; cert: per-query excluded
    lower bound. Returns (inside, flag)."""
    out_of_box = jnp.any((qs < bmin[None]) | (qs > bmax[None]), axis=-1)
    reach = jnp.linalg.norm(qs - anch, axis=-1)
    transferable = out_of_box | (dist > reach * (1.0 + 1e-5))
    center_inside = inside3[cellq[:, 0], cellq[:, 1], cellq[:, 2]]
    parity_inside = center_inside ^ (cnt % 2 == 1)
    inside_q = jnp.where(
        out_of_box, False,
        jnp.where(transferable, center_inside, parity_inside),
    )
    dist_fail = dist > cert * (1.0 - 1e-6)
    seg_fail = (~transferable) & (cert < reach * (1.0 + 1e-6))
    return inside_q, dist_fail | seg_fail


def _anchor_cells(q, grid):
    """Sign-grid cell, cell center, and box bounds for each query."""
    counts_g = jnp.asarray(grid.cell_count, jnp.int32)
    fc = jnp.asarray(grid.first_cell)
    cs = jnp.asarray(grid.cell_size)
    bmin = fc - 0.5 * cs
    bmax = fc + (counts_g.astype(jnp.float32) - 0.5) * cs
    cell = jnp.clip(
        jnp.floor((q - bmin) / cs).astype(jnp.int32), 0, counts_g - 1
    )
    return cell, grid.cell_center(cell), bmin, bmax


@functools.partial(jax.jit, static_argnames=("st", "kg", "chunk"))
def _culled_gather_signed_impl(queries, bi, inside3, grid, *, st, kg,
                               chunk=64):
    """Per-SUB-TILE gathered dense pass: distance + fused anchor sign.

    Each ``st``-query sub-tile evaluates ONLY its own ≤``kg`` nearest
    blocks (phase A, :func:`.block_index.phase_a_topk`), row-gathered per
    sub-tile chunk: the work is Σ_s kg·st·tb pairs instead of Q·T — the
    analog of the reference's per-query R-tree descent (`rtree.rs:96-126`).
    Per-query distance + segment certificates against the excluded bound
    (:func:`_sign_epilogue`); flagged queries are recomputed by the
    caller. Returns (signed, flag, work_frac) in input order.
    """
    Q = queries.shape[0]
    B = bi.n_blocks
    tb = bi.tb
    order = _morton_order(queries)
    q_sorted = queries[order]
    pad = (-Q) % (st * chunk)
    q_pad = jnp.pad(q_sorted, ((0, pad), (0, 0)), mode="edge")
    n_sub = q_pad.shape[0] // st

    subs = q_pad.reshape(n_sub, st, 3)
    smin = jnp.min(subs, axis=1)
    smax = jnp.max(subs, axis=1)
    centers = (smin + smax) * 0.5
    r_s = jnp.linalg.norm((smax - smin) * 0.5, axis=-1)

    idx_kg, lb_excl = block_index.phase_a_topk(centers, bi, kg=kg)

    cell, anchors, bmin, bmax = _anchor_cells(q_pad, grid)

    # Pad block at index B: PAD_COORD vertices (far degenerate point —
    # huge distance, zero-area ⇒ det == 0 ⇒ no segment hit).
    planes = jnp.concatenate(
        [
            bi.planes9.reshape(9, B, tb),
            jnp.full((9, 1, tb), block_index.PAD_COORD, jnp.float32),
        ],
        axis=1,
    )

    def body(args):
        qc, ac, ixc = args  # (chunk, st, 3), (chunk, st, 3), (chunk, kg)
        g = planes[:, ixc].reshape(9, chunk, 1, kg * tb)
        ax, ay, az, bx, by, bz, cx, cy, cz = g
        qx = qc[..., 0][..., None]
        qy = qc[..., 1][..., None]
        qz = qc[..., 2][..., None]
        apx, apy, apz = qx - ax, qy - ay, qz - az
        abx, aby, abz = bx - ax, by - ay, bz - az
        acx, acy, acz = cx - ax, cy - ay, cz - az
        v, w, d1, d2_, A, B_, C = geometry.closest_point_vw(
            apx, apy, apz, abx, aby, abz, acx, acy, acz
        )
        d2pair = geometry.dist2_vw(apx, apy, apz, v, w, d1, d2_, A, B_, C)
        dmin2 = jnp.min(d2pair, axis=-1)  # (chunk, st)
        # Möller–Trumbore query→anchor segment crossings (strict interior,
        # the reference's shared-edge blind spot too, `geo.rs:156-216`).
        dxx = ac[..., 0][..., None] - qx
        dyy = ac[..., 1][..., None] - qy
        dzz = ac[..., 2][..., None] - qz
        pvx = dyy * acz - dzz * acy
        pvy = dzz * acx - dxx * acz
        pvz = dxx * acy - dyy * acx
        det = abx * pvx + aby * pvy + abz * pvz
        inv = jnp.where(det == 0.0, 0.0, 1.0 / jnp.where(det == 0.0, 1.0, det))
        u = (apx * pvx + apy * pvy + apz * pvz) * inv
        qvx = apy * abz - apz * aby
        qvy = apz * abx - apx * abz
        qvz = apx * aby - apy * abx
        vv = (dxx * qvx + dyy * qvy + dzz * qvz) * inv
        tt = (acx * qvx + acy * qvy + acz * qvz) * inv
        hit = (
            (det != 0.0) & (u > 0.0) & (vv > 0.0)
            & (u + vv < 1.0) & (tt > 0.0) & (tt < 1.0)
        )
        cnt = jnp.sum(hit, axis=-1, dtype=jnp.int32)  # (chunk, st)
        return dmin2, cnt

    n_chunks = n_sub // chunk
    dmin2, cnt = jax.lax.map(
        body,
        (
            subs.reshape(n_chunks, chunk, st, 3),
            anchors.reshape(n_chunks, chunk, st, 3),
            idx_kg.reshape(n_chunks, chunk, kg),
        ),
    )
    dist = jnp.sqrt(dmin2.reshape(-1))[:Q]
    cnt = cnt.reshape(-1)[:Q]

    qs = q_sorted[:Q]
    c_q = jnp.repeat(centers, st, axis=0)[:Q]
    cert = jnp.repeat(lb_excl, st)[:Q] - jnp.linalg.norm(qs - c_q, axis=-1)
    inside_q, flag = _sign_epilogue(
        qs, cell[:Q], anchors[:Q], bmin, bmax, inside3, dist, cnt, cert
    )
    signed = jnp.where(inside_q, -dist, dist)
    inv_ord = jnp.zeros_like(order).at[order].set(jnp.arange(Q))
    work_frac = jnp.sum(idx_kg != B) / (idx_kg.shape[0] * B)
    return signed[inv_ord], flag[inv_ord], work_frac


def _gather_widened(queries, bi, inside3, grid, *, st, kg):
    """Gathered pass, then a WIDENED second pass over its flagged queries.

    Flagged queries (mostly sub-tiles whose within-bound block count
    exceeded ``kg`` — far-field shells legitimately graze many blocks)
    re-run through the SAME gather engine at ``DEFAULT_KG_WIDE`` before any
    dense fallback. ≙ the R-tree descent widening its frontier until the
    bound certifies (`bvh_ext.rs:102-168`). Returns (signed, flag,
    work_frac) with ``flag`` the queries still uncertified."""
    Q = queries.shape[0]
    signed, flag, work_frac = _culled_gather_signed_impl(
        queries, bi, inside3, grid, st=st, kg=kg,
    )
    k_wide = min(max(16_384, Q // 3), 393_216)
    idxw = jnp.nonzero(flag, size=k_wide, fill_value=Q)[0]
    subw = queries[jnp.minimum(idxw, Q - 1)]
    s2, f2, _ = _culled_gather_signed_impl(
        subw, bi, inside3, grid, st=16, kg=DEFAULT_KG_WIDE,
    )
    signed = signed.at[idxw].set(s2, mode="drop")
    rank = jnp.cumsum(flag)
    widened = flag & (rank <= k_wide)
    newf = jnp.zeros_like(flag).at[idxw].set(f2, mode="drop")
    return signed, jnp.where(widened, newf, flag), work_frac


@functools.partial(
    jax.jit, static_argnames=("st", "kg", "k_fix", "raycast_axes"),
)
def _culled_signed_fixup_impl(queries, bi, inside3, grid, ra, rb, rc, *,
                              st, kg, k_fix, raycast_axes):
    """Widened gathered pass + IN-JIT dense fix-up of up to ``k_fix``
    flagged queries, all in ONE program: the flagged indices are extracted
    with a static budget (`jnp.nonzero(size=k_fix)`), recomputed by the
    dense engine with per-query parity, and scattered back. Returns
    (signed, flag, n_flagged, work_frac) — the caller recomputes the
    flagged queries beyond the first k_fix on its own.
    """
    signed, flag, work_frac = _gather_widened(
        queries, bi, inside3, grid, st=st, kg=kg,
    )
    n_flag = jnp.sum(flag)
    # Pad slots get an OUT-OF-RANGE index and are dropped by the scatter:
    # an in-range fill (e.g. 0) would collide with a genuinely-flagged
    # query 0 — duplicate scatter indices with different payloads are
    # nondeterministic in XLA.
    Q = queries.shape[0]
    idx = jnp.nonzero(flag, size=k_fix, fill_value=Q)[0]
    sub = dense.signed_distance(
        queries[jnp.minimum(idx, Q - 1)], ra, rb, rc,
        sign_method=SignMethod.RAYCAST, raycast_axes=raycast_axes,
    )
    return signed.at[idx].set(sub, mode="drop"), flag, n_flag, work_frac


def _query_culled_dist(queries, ta, tb, tc, valid, *, sign_method, k, tile):
    """Distance pass (no raycast sign). Returns (dist, q_overflow):
    ``q_overflow`` is None when the pass is certified exact everywhere,
    else a (Q,) bool mask of queries whose tile overflowed the candidate
    budget (their ``dist`` may be wrong — recompute them densely)."""
    dist, q_overflow = _query_culled_dist_impl(
        queries, ta, tb, tc, valid, sign_method=sign_method, k=k, tile=tile
    )
    if bool(jnp.any(q_overflow)):
        return dist, q_overflow
    return dist, None


@functools.partial(
    jax.jit, static_argnames=("sign_method", "k", "tile")
)
def _query_culled_dist_impl(queries, ta, tb, tc, valid, *, sign_method, k,
                            tile):
    Q = queries.shape[0]
    order = _morton_order(queries)
    q_sorted = queries[order]

    pad = (-Q) % tile
    q_pad = jnp.pad(q_sorted, ((0, pad), (0, 0)))
    n_tiles = q_pad.shape[0] // tile
    q_tiles = q_pad.reshape(n_tiles, tile, 3)

    centers = (jnp.max(q_tiles, axis=1) + jnp.min(q_tiles, axis=1)) * 0.5
    radius = jnp.linalg.norm(
        (jnp.max(q_tiles, axis=1) - jnp.min(q_tiles, axis=1)) * 0.5, axis=-1
    )

    idx, overflow, n_within = _select_candidates_chunked(
        centers, radius, ta, tb, tc, valid, k
    )

    def tile_body(args):
        qt, cand = args
        a = ta[cand]
        b = tb[cand]
        c = tc[cand]
        v = valid[cand]
        if sign_method == SignMethod.NORMAL:
            sd = geometry.point_triangle_signed_distance(
                qt[:, None, :], a[None], b[None], c[None]
            )
            neg = jnp.signbit(sd)
            minpos = jnp.min(jnp.where(v[None] & ~neg, sd, F32_MAX), axis=1)
            minneg = jnp.min(jnp.where(v[None] & neg, -sd, F32_MAX), axis=1)
            return combine_champions(minpos, minneg)
        d = geometry.point_triangle_distance(qt[:, None, :], a[None], b[None], c[None])
        return jnp.min(jnp.where(v[None], d, F32_MAX), axis=1)

    dist = jax.lax.map(tile_body, (q_tiles, idx)).reshape(-1)[: Q]
    q_overflow = jnp.repeat(overflow, tile)[:Q]

    # Undo the Morton sort.
    inv = jnp.zeros_like(order).at[order].set(jnp.arange(Q))
    return dist[inv], q_overflow[inv]


class ParityBins(NamedTuple):
    """Host-precomputed 2D triangle bins for one ray axis.

    The array analog of the reference's BVH ray traversal
    (`bvh.rs:62-144`): triangles binned by their transverse (to the ray
    axis) 2D AABB over a G×G tile grid; a +axis ray from any point only
    needs the triangles listed in its (y, z) tile — exact, because a hit
    requires the triangle's 2D AABB to contain the ray's transverse point.

    table: (G*G, K) int32 triangle ids (T = empty); lo2/inv_ts: (2,) f32
    grid transform; g: int tiles per side.
    """

    table: object
    lo2: object
    inv_ts: object
    g: int


def build_parity_bins(ta, tb, tc, axis: int, *, g: int = 64,
                      n_valid: Optional[int] = None) -> ParityBins:
    """Bin triangles by transverse 2D AABB for +``axis`` rays (host numpy)."""
    ta = np.asarray(ta, np.float32)
    tb = np.asarray(tb, np.float32)
    tc = np.asarray(tc, np.float32)
    T = len(ta) if n_valid is None else int(n_valid)
    ta, tb, tc = ta[:T], tb[:T], tc[:T]
    iy, iz = (axis + 1) % 3, (axis + 2) % 3
    tv2 = np.stack(
        [ta[:, [iy, iz]], tb[:, [iy, iz]], tc[:, [iy, iz]]], axis=1
    )  # (T, 3, 2)
    eps = 1e-5
    lo = tv2.min(axis=1) - eps
    hi = tv2.max(axis=1) + eps
    if T == 0:
        return ParityBins(
            np.zeros((g * g, 1), np.int32), np.zeros(2, np.float32),
            np.ones(2, np.float32), g,
        )
    gl = lo.min(axis=0)
    gh = hi.max(axis=0)
    ts = np.maximum((gh - gl) / g, 1e-12)
    lo_t = np.clip(np.floor((lo - gl) / ts).astype(np.int64), 0, g - 1)
    hi_t = np.clip(np.floor((hi - gl) / ts).astype(np.int64), 0, g - 1)
    w = hi_t - lo_t + 1
    n_per = w[:, 0] * w[:, 1]
    starts = np.zeros(T + 1, np.int64)
    np.cumsum(n_per, out=starts[1:])
    E = int(starts[-1])
    tri_of = np.repeat(np.arange(T, dtype=np.int64), n_per)
    within = np.arange(E, dtype=np.int64) - starts[tri_of]
    dy = within // w[tri_of, 1]
    dz = within % w[tri_of, 1]
    tile = (lo_t[tri_of, 0] + dy) * g + (lo_t[tri_of, 1] + dz)

    order = np.argsort(tile, kind="stable")
    tile_s = tile[order]
    tri_s = tri_of[order].astype(np.int32)
    seg_start = np.empty(E, bool)
    seg_start[0] = True
    np.not_equal(tile_s[1:], tile_s[:-1], out=seg_start[1:])
    seg_first = np.flatnonzero(seg_start)
    seg_id = np.cumsum(seg_start) - 1
    rank = np.arange(E, dtype=np.int64) - seg_first[seg_id]
    counts = np.diff(np.append(seg_first, E))
    K = int(counts.max())
    table = np.full((g * g, K), T, np.int32)
    table[tile_s, rank] = tri_s
    return ParityBins(
        table, gl.astype(np.float32), (1.0 / ts).astype(np.float32), g
    )


def binned_parity_counts(queries, ta, tb, tc, bins3, *,
                         n_valid: Optional[int] = None, chunk: int = 2048):
    """Crossing counts (Q, axes) using per-axis 2D tile bins.

    Exact replacement for :func:`_ray_parity_counts` (same float ops as
    :func:`..geometry.ray_triangle_aligned`, so counts match bit-for-bit):
    each query gathers only its tile's triangle list (typically 100-1000×
    smaller than the soup). ``n_valid``: real triangle count (= the bins'
    empty-slot sentinel) when ``ta`` carries padded rows.

    Layout: the per-axis triangle data is a 9-component ROW table gathered
    in one op and transposed component-major — per-component math on
    (chunk, K) planes instead of ``ta[lists]`` + (…, 3) gathers.
    """
    Q = queries.shape[0]
    T = int(ta.shape[0]) if n_valid is None else int(n_valid)
    chunk = min(chunk, max(Q, 1))
    pad = (-Q) % chunk
    qp = jnp.pad(queries, ((0, pad), (0, 0))).reshape(-1, chunk, 3)

    tables = [jnp.asarray(b.table) for b in bins3]
    los = [jnp.asarray(b.lo2) for b in bins3]
    invs = [jnp.asarray(b.inv_ts) for b in bins3]
    # Per-axis rotated 9-plane row tables (T+1, 9); the pad row is all-zero
    # (degenerate triangle: every edge weight 0 ⇒ never inside).
    planes = []
    for axis in range(len(bins3)):
        ix, iy, iz = axis, (axis + 1) % 3, (axis + 2) % 3
        p9 = jnp.stack(
            [ta[:T, ix], ta[:T, iy], ta[:T, iz],
             tb[:T, ix], tb[:T, iy], tb[:T, iz],
             tc[:T, ix], tc[:T, iy], tc[:T, iz]],
            axis=-1,
        )
        planes.append(jnp.concatenate([p9, jnp.zeros((1, 9), jnp.float32)]))

    def chunk_body(qc):
        outs = []
        for axis, b in enumerate(bins3):
            iy, iz = (axis + 1) % 3, (axis + 2) % 3
            q2 = jnp.stack([qc[:, iy], qc[:, iz]], axis=-1)
            t2 = jnp.clip(
                jnp.floor((q2 - los[axis]) * invs[axis]).astype(jnp.int32),
                0, b.g - 1,
            )
            lists = tables[axis][t2[:, 0] * b.g + t2[:, 1]]  # (chunk, K)
            v = lists < jnp.int32(T)
            safe = jnp.minimum(lists, T)
            g9 = jnp.transpose(planes[axis][safe], (2, 0, 1))  # (9, chunk, K)
            axc, ayc, azc, bxc, byc, bzc, cxc, cyc, czc = g9
            ox = qc[:, axis][:, None]
            oy = qc[:, iy][:, None]
            oz = qc[:, iz][:, None]
            # Identical float ops to geometry.ray_triangle_aligned (which
            # mirrors `geo.rs:165-216`): edge weights from e01/e12/e20.
            e12y, e12z = cyc - byc, czc - bzc
            e20y, e20z = ayc - cyc, azc - czc
            e01y, e01z = byc - ayc, bzc - azc
            p0y, p0z = oy - ayc, oz - azc
            p1y, p1z = oy - byc, oz - bzc
            p2y, p2z = oy - cyc, oz - czc
            w0 = p1z * e12y - p1y * e12z
            w1 = p2z * e20y - p2y * e20z
            w2 = p0z * e01y - p0y * e01z
            inside = ((w0 < 0.0) & (w1 < 0.0) & (w2 < 0.0)) | (
                (w0 > 0.0) & (w1 > 0.0) & (w2 > 0.0)
            )
            wsum = w0 + w1 + w2
            num = w0 * (ox - axc) + w2 * (ox - cxc) + w1 * (ox - bxc)
            t = -num / jnp.where(wsum == 0.0, 1.0, wsum)
            hit = inside & (t > 0.0) & v
            outs.append(jnp.sum(hit, axis=1, dtype=jnp.int32))
        return jnp.stack(outs, axis=-1)

    return jax.lax.map(chunk_body, qp).reshape(-1, len(bins3))[:Q]


class SignGrid(NamedTuple):
    """Coarse exact inside/outside mask used to sign scattered queries.

    The line parity (:mod:`.raycast`) builds a RES³ parity grid once per
    mesh (O(lines·T)); a query q whose exact unsigned distance exceeds its distance to the
    nearest cell center provably lies in the same connected component of
    ℝ³∖surface as that center (no surface point inside the ball of radius
    d(q) around q ⊇ the segment q→center), so the center's sign transfers
    EXACTLY. Only the thin near-surface shell falls back to per-query
    parity. Semantics assume a watertight mesh — the raycast sign's own
    documented precondition (`lib.rs:204-216`).
    """

    inside: object  # (res, res, res) bool
    grid: object  # Grid


def build_sign_grid(ta, tb, tc, valid, *, res: int = 128,
                    margin: float = 0.02) -> SignGrid:
    """Exact parity grid over the mesh bbox (+margin)."""
    from ..grid import Grid
    from . import raycast as raycast_mod

    lo = np.asarray(jnp.min(jnp.minimum(jnp.minimum(
        jnp.where(valid[:, None], ta, jnp.inf),
        jnp.where(valid[:, None], tb, jnp.inf)),
        jnp.where(valid[:, None], tc, jnp.inf)), axis=0))
    hi = np.asarray(jnp.max(jnp.maximum(jnp.maximum(
        jnp.where(valid[:, None], ta, -jnp.inf),
        jnp.where(valid[:, None], tb, -jnp.inf)),
        jnp.where(valid[:, None], tc, -jnp.inf)), axis=0))
    pad = (hi - lo) * margin + 1e-6
    grid = Grid.from_bounding_box(lo - pad, hi + pad, [res] * 3)

    inside = raycast_mod.grid_inside_mask(
        grid, ta, tb, tc, valid, tri_block=256
    )
    return SignGrid(inside=inside, grid=grid)


@jax.jit
def _grid_transfer(queries, dist_unsigned, inside, grid):
    counts = jnp.asarray(grid.cell_count, jnp.int32)
    fc = jnp.asarray(grid.first_cell)
    cs = jnp.asarray(grid.cell_size)
    bmin = fc - 0.5 * cs
    bmax = fc + (counts.astype(jnp.float32) - 0.5) * cs
    # The sign grid spans the mesh bbox (+margin): any query beyond it is in
    # the unbounded exterior component — outside, exactly (no lookup, no
    # fallback; for scattered query sets this is most of them).
    out_of_box = jnp.any(
        (queries < bmin[None]) | (queries > bmax[None]), axis=-1
    )
    cell = jnp.clip(
        jnp.floor((queries - bmin) / cs).astype(jnp.int32), 0, counts - 1
    )
    centers = grid.cell_center(cell)
    reach = jnp.linalg.norm(queries - centers, axis=-1)
    transferable = out_of_box | (dist_unsigned > reach * (1.0 + 1e-5))
    inside_q = jnp.where(
        out_of_box, False, inside[cell[:, 0], cell[:, 1], cell[:, 2]]
    )
    return inside_q, transferable


def signs_from_grid(queries, dist_unsigned, sg: SignGrid, ta, tb, tc, valid,
                    raycast_axes: int = 3, parity_bins=None):
    """Inside mask for queries: sign-grid transfer + exact near-surface
    fallback. Returns (Q,) bool.

    ``parity_bins``: when available, the near-shell subset is signed by the
    tile-binned exact parity (O(subset·bin) — ~10× cheaper than the
    O(subset·T) fused parity sweep it replaces)."""
    inside_q, transferable = _grid_transfer(
        queries, dist_unsigned, sg.inside, sg.grid
    )

    n_bad = int(jnp.sum(~transferable))
    if n_bad == 0:
        return inside_q
    # Near-surface shell: exact per-query parity on the (small) subset.
    bad_idx = np.flatnonzero(~np.asarray(transferable))
    pad = (-len(bad_idx)) % 1024
    bad_pad = np.concatenate([bad_idx, np.zeros(pad, np.int64)])
    subset = queries[jnp.asarray(bad_pad)]
    if parity_bins is not None:
        n_valid = int(jnp.sum(valid))
        sub_inside = _binned_inside(
            subset, ta, tb, tc, parity_bins, raycast_axes, n_valid
        )
        return inside_q.at[jnp.asarray(bad_idx)].set(
            sub_inside[: len(bad_idx)]
        )
    sub_counts = dense.crossing_counts(
        subset, ta, tb, tc, valid, raycast_axes=raycast_axes,
        n_valid=int(jnp.sum(valid)),
    )
    odd = sub_counts % 2 == 1
    if raycast_axes == 1:
        sub_inside = odd[:, 0]
    else:
        sub_inside = jnp.sum(odd, axis=1) >= 2
    return inside_q.at[jnp.asarray(bad_idx)].set(
        sub_inside[: len(bad_idx)]
    )


@functools.partial(
    jax.jit, static_argnames=("raycast_axes", "tri_block", "chunk")
)
def _ray_parity_counts(queries, ta, tb, tc, valid, raycast_axes,
                       tri_block=512, chunk=2048):
    Q = queries.shape[0]
    chunk = min(chunk, max(Q, 1))
    pad = (-Q) % chunk
    qp = jnp.pad(queries, ((0, pad), (0, 0))).reshape(-1, chunk, 3)
    ta, tb, tc, valid, tri_block = brute.pad_tri_blocks(ta, tb, tc, valid, tri_block)
    n_blocks = ta.shape[0] // tri_block
    blocks = jax.tree.map(
        lambda x: x.reshape((n_blocks, tri_block) + x.shape[1:]),
        (ta, tb, tc, valid),
    )

    def chunk_body(qc):
        def body(counts, blk):
            a, b, c, v = blk
            hits = []
            for axis in range(raycast_axes):
                hit, _ = geometry.ray_triangle_aligned(
                    qc[:, None, :], a[None], b[None], c[None], axis
                )
                hits.append(hit)
            h = jnp.stack(hits, axis=-1) & v[None, :, None]
            return counts + jnp.sum(h, axis=1, dtype=jnp.int32), None

        init = jnp.zeros((chunk, raycast_axes), jnp.int32)
        counts, _ = jax.lax.scan(body, init, blocks)
        return counts

    return jax.lax.map(chunk_body, qp).reshape(-1, raycast_axes)[:Q]


#: Tile edge (cells) for grid culling; 8^3 = 512 cells per tile.
GRID_TILE = 8
#: Tiles per selection chunk (bounds the (chunk, T) distance matrix).
SELECT_CHUNK = 512


def _select_candidates_chunked(tile_centers, tile_radius, ta, tb, tc, valid, k,
                               chunk: int = SELECT_CHUNK):
    """:func:`select_candidates` over tile chunks (bounded memory)."""
    Nt = tile_centers.shape[0]
    chunk = min(chunk, Nt)
    pad = (-Nt) % chunk
    c_p = jnp.pad(tile_centers, ((0, pad), (0, 0)))
    r_p = jnp.pad(jnp.broadcast_to(tile_radius, (Nt,)), (0, pad))

    def body(args):
        c, r = args
        return select_candidates(c, r, ta, tb, tc, valid, k)

    idx, ovf, n_within = jax.lax.map(
        body, (c_p.reshape(-1, chunk, 3), r_p.reshape(-1, chunk))
    )
    return (
        idx.reshape(-1, k)[:Nt],
        ovf.reshape(-1)[:Nt],
        n_within.reshape(-1)[:Nt],
    )


@functools.partial(jax.jit, static_argnames=("sign", "k", "tile"))
def _grid_culled_impl(grid: Grid, ta, tb, tc, valid, *, sign, k, tile):
    """One culled pass over the grid. Returns (dist3, overflow (n_tiles,))."""
    nx, ny, nz = grid.cell_count
    t = tile
    px, py, pz = (-nx) % t, (-ny) % t, (-nz) % t
    centers = grid.all_cell_centers()
    # Edge-pad so every axis divides the tile edge; padded cells reuse edge
    # centers (valid geometry, sliced away at the end).
    centers = jnp.pad(
        centers, ((0, px), (0, py), (0, pz), (0, 0)), mode="edge"
    )
    X, Y, Z = nx + px, ny + py, nz + pz
    tiles = (
        centers.reshape(X // t, t, Y // t, t, Z // t, t, 3)
        .transpose(0, 2, 4, 1, 3, 5, 6)
        .reshape(-1, t * t * t, 3)
    )
    tmin = jnp.min(tiles, axis=1)
    tmax = jnp.max(tiles, axis=1)
    tile_c = (tmin + tmax) * 0.5
    radius = jnp.linalg.norm((tmax - tmin) * 0.5, axis=-1)

    idx, overflow, n_within = _select_candidates_chunked(
        tile_c, radius, ta, tb, tc, valid, k
    )

    def tile_body(args):
        qt, cand = args
        a = ta[cand]
        b = tb[cand]
        c = tc[cand]
        v = valid[cand]
        if sign == SignMethod.NORMAL:
            sd = geometry.point_triangle_signed_distance(
                qt[:, None, :], a[None], b[None], c[None]
            )
            neg = jnp.signbit(sd)
            minpos = jnp.min(jnp.where(v[None] & ~neg, sd, F32_MAX), axis=1)
            minneg = jnp.min(jnp.where(v[None] & neg, -sd, F32_MAX), axis=1)
            return combine_champions(minpos, minneg)
        d = geometry.point_triangle_distance(
            qt[:, None, :], a[None], b[None], c[None]
        )
        return jnp.min(jnp.where(v[None], d, F32_MAX), axis=1)

    dist = jax.lax.map(tile_body, (tiles, idx))  # (n_tiles, t^3)
    dist3 = (
        dist.reshape(X // t, Y // t, Z // t, t, t, t)
        .transpose(0, 3, 1, 4, 2, 5)
        .reshape(X, Y, Z)[:nx, :ny, :nz]
    )
    return dist3, overflow, n_within


def grid_distance_culled(grid: Grid, ta, tb, tc, valid, *, sign,
                         k: int = DEFAULT_K, tile: int = GRID_TILE):
    """Grid unsigned/normal-signed distances via per-tile candidate culling —
    the array analog of the reference's R-tree grid backend
    (`rtree.rs:96-126`): exact by construction.

    Phase A selects, per 8^3-cell tile, the top-k triangles by distance to
    the tile center; the triangle-inequality bound ``d(center, tri) ≤ dmin +
    2·radius`` certifies when k candidates suffice. If any tile's bound
    holds more than k triangles (``overflow``), one retry at the measured
    count runs — so the result equals the full reduction, always.
    Phase B evaluates the exact (cells × k) distance block per tile.
    (Raycast sign is handled by the caller's line-parity pass.)
    """
    T = int(ta.shape[0])
    n_valid = int(jnp.sum(valid)) if T else 0
    if k < n_valid:
        dist3, overflow, n_within = _grid_culled_impl(
            grid, ta, tb, tc, valid, sign=sign, k=k, tile=tile
        )
        if not bool(jnp.any(overflow)):
            return dist3
        k = _ceil_pow2(int(jnp.max(n_within)))
        if k < n_valid:
            dist3, overflow, _ = _grid_culled_impl(
                grid, ta, tb, tc, valid, sign=sign, k=k, tile=tile
            )
            assert not bool(jnp.any(overflow))
            return dist3

    # Candidate budget ≥ triangle count: culling cannot pay — dense sweep.
    dist = dense.signed_distance(
        grid.all_cell_centers().reshape(-1, 3), ta, tb, tc, valid,
        sign_method=sign, raycast_axes=0, n_valid=n_valid,
    )
    return dist.reshape(grid.cell_count)
