"""Morton block index: the per-mesh spatial structure of the CULLED engine.

The analog of the reference's R-tree branch-and-bound (`bvh_ext.rs:59-168`,
`rtree.rs:96-126`): triangles are Morton-sorted into spatially coherent
BLOCKS of ``TB`` triangles (built once per mesh on the host, like
`RTree::bulk_load`). Phase A (:func:`phase_a_topk`) picks, per sub-tile of
Morton-sorted queries, the nearest ``kg`` blocks by a per-triangle lower
bound, plus a lower bound on every block it leaves out; the gathered dense
pass in :mod:`.culling` then evaluates only those blocks, and the excluded
bound certifies each query's result post hoc (flagged queries are
recomputed densely).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..types import F32_MAX

#: Padding coordinate for triangle tail rows (a far degenerate point: huge
#: distance, zero area ⇒ no segment crossing).
PAD_COORD = 1.0e18
#: Triangles per Morton block.
TB = 256
#: Fine-level candidate window per sub-tile for large meshes (coarse block
#: AABB pruning → per-triangle bounds on the nearest HIER_C blocks only).
#: Blocks the coarse level prunes contribute their (coarse) AABB bound to
#: the certificate, so exactness never depends on the window size.
HIER_C = 96


@dataclass(frozen=True)
class BlockIndex:
    """Per-mesh spatial block structure (host-built, device-resident).

    planes9: (9, B·tb) f32 vertex coordinate planes (ax ay az bx by bz cx
    cy cz, PAD_COORD tail) in Morton order — phase A computes per-triangle
    lower bounds from them and the gathered dense pass row-gathers whole
    blocks. lo/hi: (B, 3) block AABBs over REAL triangles; n_blocks: B; tb:
    triangles per block.
    """

    planes9: object
    lo: object
    hi: object
    n_blocks: int
    tb: int
    #: Cheap mesh-content hash (adler32 of the block AABBs) — distinguishes
    #: meshes with equal block counts in host-side caches (route cache).
    content_key: int = 0


jax.tree_util.register_pytree_node(
    BlockIndex,
    lambda b: ((b.planes9, b.lo, b.hi), (b.n_blocks, b.tb, b.content_key)),
    lambda aux, ch: BlockIndex(
        planes9=ch[0], lo=ch[1], hi=ch[2],
        n_blocks=aux[0], tb=aux[1], content_key=aux[2],
    ),
)


def build_block_index(ta, tb, tc, *, block: int = TB) -> BlockIndex:
    """Morton-sort triangles into ``block``-sized rows (host numpy in →
    device arrays out). ≙ the reference's `RTree::bulk_load`
    (`rtree.rs:96-126`) — a spatial index built once per mesh."""
    ta = np.asarray(ta, np.float32)
    tb = np.asarray(tb, np.float32)
    tc = np.asarray(tc, np.float32)
    T = len(ta)
    cent = (ta + tb + tc) / 3.0
    lo = cent.min(axis=0)
    hi = cent.max(axis=0)
    scale = np.where(hi > lo, 1024.0 / (hi - lo), 0.0)
    q = np.clip((cent - lo) * scale, 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2)
    )
    order = np.argsort(code, kind="stable")
    ta, tb, tc = ta[order], tb[order], tc[order]

    pad = (-T) % block
    if pad:
        far = np.full((pad, 3), PAD_COORD, np.float32)
        ta_p, tb_p, tc_p = (np.concatenate([x, far]) for x in (ta, tb, tc))
    else:
        ta_p, tb_p, tc_p = ta, tb, tc
    B = len(ta_p) // block

    # Block AABBs over REAL triangles only.
    tri_lo = np.minimum(np.minimum(ta, tb), tc)
    tri_hi = np.maximum(np.maximum(ta, tb), tc)
    blk_of = np.arange(T) // block
    lo_b = np.full((B, 3), np.inf, np.float32)
    hi_b = np.full((B, 3), -np.inf, np.float32)
    np.minimum.at(lo_b, blk_of, tri_lo)
    np.maximum.at(hi_b, blk_of, tri_hi)

    planes9 = np.concatenate([ta_p.T, tb_p.T, tc_p.T])
    return BlockIndex(
        planes9=jnp.asarray(planes9),
        lo=jnp.asarray(lo_b),
        hi=jnp.asarray(hi_b),
        n_blocks=B,
        tb=block,
        content_key=zlib.adler32(lo_b.tobytes() + hi_b.tobytes()),
    )


def _csphere(p9):
    """Per-triangle centroid (3, …) and circumradius bound (…) from the
    vertex planes: ``|c − centroid| − r ≤ d(c, tri)`` for any point c."""
    cen = (p9[0:3] + p9[3:6] + p9[6:9]) * (1.0 / 3.0)
    rad = jnp.sqrt(
        jnp.maximum(
            jnp.sum((p9[0:3] - cen) ** 2, axis=0),
            jnp.maximum(
                jnp.sum((p9[3:6] - cen) ** 2, axis=0),
                jnp.sum((p9[6:9] - cen) ** 2, axis=0),
            ),
        )
    )
    return cen, rad


def _phase_a_hier(centers, bi: BlockIndex, *, c: int):
    """Coarse→fine phase A for large meshes.

    Coarse level: box distance from each sub-tile center to every block
    AABB — O(n_sub·B), the Morton-block analog of descending the R-tree's
    upper levels (`bvh_ext.rs:102-168`) — keeps only the ``c`` nearest
    blocks per center. Fine level: per-triangle centroid−circumradius
    bounds over ONLY the windowed blocks' triangles — O(n_sub·c·tb)
    instead of the flat path's O(n_sub·T).

    Returns ``(lb_c, idx_c, lb_rest)``: fine bounds sorted ascending
    (n_sub, c); the block ids in that order; and the coarse bound on the
    nearest block OUTSIDE the window (n_sub,). Both bound kinds are true
    lower bounds on d(center, any triangle of the block), so the caller's
    certificate stays sound; near-surface centers where more than ``c``
    block AABBs overlap merely degrade ``lb_rest`` toward 0 (raising
    recompute-flag rates, never breaking exactness).
    """
    B = bi.n_blocks
    n_sub = centers.shape[0]
    tb = bi.tb
    cc = min(c, B - 1)

    gap = jnp.maximum(
        jnp.maximum(bi.lo[None] - centers[:, None],
                    centers[:, None] - bi.hi[None]),
        0.0,
    )
    dbox = jnp.sqrt(jnp.sum(gap * gap, axis=-1))  # (n_sub, B)
    neg, idx = jax.lax.top_k(-dbox, cc + 1)
    lb_rest = -neg[:, cc]
    idx_c = idx[:, :cc]

    # Fine: csphere bounds over the windowed blocks' triangles, row-gathered
    # per candidate block, chunked over sub-tiles to bound the
    # (chunk, cc, tb) intermediate.
    cen, rad = _csphere(bi.planes9.reshape(9, B, tb))

    chunk = max(1, min(256, n_sub))
    pad_rows = (-n_sub) % chunk
    c_pad = jnp.pad(centers, ((0, pad_rows), (0, 0)), mode="edge")
    i_pad = jnp.pad(idx_c, ((0, pad_rows), (0, 0)), mode="edge")

    def body(arg):
        cs, ix = arg  # (chunk, 3), (chunk, cc)
        dx = cs[:, 0][:, None, None] - cen[0][ix]
        dy = cs[:, 1][:, None, None] - cen[1][ix]
        dz = cs[:, 2][:, None, None] - cen[2][ix]
        d = jnp.sqrt(dx * dx + dy * dy + dz * dz) - rad[ix]
        return jnp.min(jnp.maximum(d, 0.0), axis=2)  # (chunk, cc)

    lbf = jax.lax.map(
        body,
        (c_pad.reshape(-1, chunk, 3), i_pad.reshape(-1, chunk, cc)),
    ).reshape(-1, cc)[:n_sub]

    ord_ = jnp.argsort(lbf, axis=1)
    lb_c = jnp.take_along_axis(lbf, ord_, axis=1)
    idx_sorted = jnp.take_along_axis(idx_c, ord_, axis=1)
    return lb_c, idx_sorted, lb_rest


def _phase_a_flat_lb(centers, bi: BlockIndex):
    """Per-block csphere lower bounds from each center — (n_sub, B).

    One fused (chunk × T) centroid−circumradius sweep segment-min'd per
    block."""
    B = bi.n_blocks
    Tp = bi.planes9.shape[1]
    n_sub = centers.shape[0]
    chunk = min(256, n_sub)
    pad_rows = (-n_sub) % chunk
    c_pad = jnp.pad(centers, ((0, pad_rows), (0, 0)), mode="edge")
    cen, rad = _csphere(bi.planes9)

    def body(c_chunk):
        dx = c_chunk[:, 0][:, None] - cen[0][None, :]
        dy = c_chunk[:, 1][:, None] - cen[1][None, :]
        dz = c_chunk[:, 2][:, None] - cen[2][None, :]
        d = jnp.sqrt(dx * dx + dy * dy + dz * dz) - rad[None, :]
        d = jnp.maximum(d, 0.0)
        return jnp.min(d.reshape(chunk, B, Tp // B), axis=2)

    return jax.lax.map(body, c_pad.reshape(-1, chunk, 3)).reshape(-1, B)[
        :n_sub
    ]


def phase_a_topk(centers, bi: BlockIndex, *, kg: int):
    """Per-sub-tile ``kg`` nearest blocks + excluded lower bound.

    The phase-A front end of the gathered dense engine
    (culling._culled_gather_signed_impl). Returns (idx (n_sub, kg) int32;
    lb_excl (n_sub,) f32 — a true lower bound on d(center, tri) over every
    triangle of every NON-selected block). Small meshes rank all blocks by
    the fine csphere bound; large ones go coarse (block-AABB box distance)
    → fine over a ``max(kg+1, HIER_C)`` window (≙ R-tree descent,
    `bvh_ext.rs:102-168`).

    The window is always FILLED: all ``kg`` nearest blocks are kept. The
    dense body's cost is static (kg·tb pairs per query either way — unused
    slots would evaluate the pad block), so keeping fewer blocks could only
    weaken both the distance and the certificate. The caller applies the
    per-query slack (``cert = lb_excl − |q − c_s|``).
    """
    B = bi.n_blocks
    n_sub = centers.shape[0]
    if B <= kg:
        idx = jnp.broadcast_to(
            jnp.arange(kg, dtype=jnp.int32)[None, :], (n_sub, kg)
        )
        idx = jnp.where(idx < B, idx, B)
        return idx, jnp.full((n_sub,), F32_MAX, jnp.float32)

    c_win = max(kg + 1, HIER_C)
    if B > 2 * c_win:
        lb_s, idx_s, lb_rest = _phase_a_hier(centers, bi, c=c_win)
    else:
        lb = _phase_a_flat_lb(centers, bi)
        m = min(B, c_win)
        neg, idx_s = jax.lax.top_k(-lb, m)
        lb_s = -neg
        lb_rest = (
            -jax.lax.top_k(-lb, m + 1)[0][:, m]
            if m < B else jnp.full((n_sub,), F32_MAX, jnp.float32)
        )

    idx_kg = idx_s[:, :kg].astype(jnp.int32)
    # First excluded bound: the (kg+1)-th in-window bound, floored by the
    # out-of-window bound (kg < m always, since m = max(kg+1, HIER_C)).
    lb_excl = jnp.minimum(lb_s[:, kg], lb_rest)
    return idx_kg, lb_excl
