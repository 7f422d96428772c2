"""Fused Pallas kernel (Triton route): point→mesh distance, sign counts.

The GPU replacement for the reference's hot loops
(`mesh_to_sdf/src/generate/generic/*.rs` per-query tree traversals): each
program owns one tile of ``tq`` queries and walks the whole triangle soup in
``tb``-sized blocks with a ``lax.fori_loop``, keeping the running minimum
(and the per-axis crossing counts) in registers. The result is stored once
at the end — there is no accumulation across programs, which run in no
order. The XLA engine (:mod:`..brute`) it competes with is a ``lax.map``
over query chunks of a ``lax.scan`` over triangle blocks.

The pair math is the plane-form closest-point ladder of
:func:`..geometry.closest_point_vw` (mul/add/select only; the divides are
per-triangle constants).

Padding triangles use
``a=(PAD,PAD,PAD)`` with zero edges, which yields a huge distance and no ray
crossings — no validity mask is needed in the kernel.

Raycast crossing parity (`geo.rs:156-216`) is fused into the same pass: the
2-D edge weights are built from ap and the (ab, ac) planes already loaded, so
the triangle block is read once for both distance and sign.

Numerics: the pair math is elementwise fp32; Triton contracts mul+add into
FMAs in another order than XLA's CPU backend, so distances agree with
:mod:`..brute` to a few ulps (tests compare with ``rtol=1e-5``), not bitwise.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...types import F32_MAX
from ..geometry import closest_point_vw, dist2_vw

#: Padding coordinate for triangle tail blocks (|q - PAD|² stays finite f32).
PAD_COORD = 1.0e18
#: Queries per program and triangles per inner-loop step (powers of two, as
#: the Triton route requires), with the warps per program. Chosen by a sweep
#: on the H100 (PERF.md, "Kernel decisions on the H100").
DEFAULT_TQ = 32
DEFAULT_TB = 32
DEFAULT_WARPS = 4


def _axis_crossings(axis, ap, ab, ac):
    """Strict axis-aligned crossing test (`geo.rs:165-216`) for +axis rays.

    ap/ab/ac: 3-tuples of the (x, y, z) planes. Returns a (TQ, B) bool mask
    of crossings with t > 0.
    """
    ix = axis
    iy = (axis + 1) % 3
    iz = (axis + 2) % 3
    apx, apy, apz = ap[ix], ap[iy], ap[iz]
    aby, abz = ab[iy], ab[iz]
    acy, acz = ac[iy], ac[iz]

    # p0 = ap; p1 = ap - ab; p2 = ap - ac. Edges: e01 = ab, e12 = ac - ab,
    # e20 = -ac (projected to the (iy, iz) plane).
    p1y = apy - aby
    p1z = apz - abz
    p2y = apy - acy
    p2z = apz - acz
    e12y = acy - aby
    e12z = acz - abz

    w0 = p1z * e12y - p1y * e12z
    w1 = p2z * (-acy) - p2y * (-acz)
    w2 = apz * aby - apy * abz

    inside = ((w0 < 0.0) & (w1 < 0.0) & (w2 < 0.0)) | (
        (w0 > 0.0) & (w1 > 0.0) & (w2 > 0.0)
    )
    p1x = apx - ab[ix]
    p2x = apx - ac[ix]
    num = w0 * apx + w1 * p1x + w2 * p2x
    den = w0 + w1 + w2
    # t = -num/den > 0  ⇔  num·den < 0 (den ≠ 0 whenever `inside`).
    return inside & (num * den < 0.0)


def _pairs(q, t_refs, j, tb):
    """(ap, ab, ac) plane triples for triangle block ``j`` vs the query tile."""
    sl = pl.ds(j * tb, tb)
    p = [r[sl][None, :] for r in t_refs]
    ap = (q[0] - p[0], q[1] - p[1], q[2] - p[2])
    return ap, (p[3], p[4], p[5]), (p[6], p[7], p[8])


def _kernel_raycast(*refs, raycast_axes: int, tb: int, n_tb: int):
    """3 query planes + 9 tri planes → min dist² + per-axis crossing counts."""
    q_refs, t_refs = refs[0:3], refs[3:12]
    d2_ref, cnt_refs = refs[12], refs[13:]
    q = [r[...][:, None] for r in q_refs]
    tq = q_refs[0].shape[0]

    def body(j, carry):
        run_min, cnts = carry
        ap, ab, ac = _pairs(q, t_refs, j, tb)
        v, w, d1, d2_, A, B_, C = closest_point_vw(*ap, *ab, *ac)
        d2pair = dist2_vw(*ap, v, w, d1, d2_, A, B_, C)
        run_min = jnp.minimum(run_min, jnp.min(d2pair, axis=1))
        cnts = tuple(
            c + jnp.sum(_axis_crossings(k, ap, ab, ac).astype(jnp.int32),
                        axis=1)
            for k, c in enumerate(cnts)
        )
        return run_min, cnts

    init = (
        jnp.full((tq,), F32_MAX, jnp.float32),
        tuple(jnp.zeros((tq,), jnp.int32) for _ in range(raycast_axes)),
    )
    run_min, cnts = jax.lax.fori_loop(0, n_tb, body, init)
    d2_ref[...] = run_min
    for r, c in zip(cnt_refs, cnts):
        r[...] = c


def _kernel_normal(*refs, tb: int, n_tb: int):
    """Normal-sign mode: two champions (min pos², min neg²) per query."""
    q_refs, t_refs = refs[0:3], refs[3:12]
    pos_ref, neg_ref = refs[12], refs[13]
    q = [r[...][:, None] for r in q_refs]
    tq = q_refs[0].shape[0]

    def body(j, carry):
        run_pos, run_neg = carry
        ap, ab, ac = _pairs(q, t_refs, j, tb)
        v, w, d1, d2_, A, B_, C = closest_point_vw(*ap, *ab, *ac)
        d2pair = dist2_vw(*ap, v, w, d1, d2_, A, B_, C)
        # Normal side test (`geo.rs:51-55`): ap·(ab×ac) > 0 ⇒ positive.
        nx = ab[1] * ac[2] - ab[2] * ac[1]
        ny = ab[2] * ac[0] - ab[0] * ac[2]
        nz = ab[0] * ac[1] - ab[1] * ac[0]
        posmask = ap[0] * nx + ap[1] * ny + ap[2] * nz > 0.0
        run_pos = jnp.minimum(
            run_pos, jnp.min(jnp.where(posmask, d2pair, F32_MAX), axis=1)
        )
        run_neg = jnp.minimum(
            run_neg, jnp.min(jnp.where(posmask, F32_MAX, d2pair), axis=1)
        )
        return run_pos, run_neg

    init = (jnp.full((tq,), F32_MAX, jnp.float32),) * 2
    run_pos, run_neg = jax.lax.fori_loop(0, n_tb, body, init)
    pos_ref[...] = run_pos
    neg_ref[...] = run_neg


def _pad_rows(x: jnp.ndarray, mult: int, value: float):
    rem = (-x.shape[0]) % mult
    if rem:
        x = jnp.concatenate([x, jnp.full((rem,), value, x.dtype)])
    return x


def _prep(queries, ta, tb, tc, tq, tb_block):
    """SoA planes, padded flat: q planes (Qp,); tri planes (Tp,)."""
    qplanes = [_pad_rows(queries[:, k], tq, 0.0) for k in range(3)]
    planes = []
    for arr, padval in ((ta, PAD_COORD), (tb - ta, 0.0), (tc - ta, 0.0)):
        for k in range(3):
            planes.append(_pad_rows(arr[:, k], tb_block, padval))
    return qplanes, planes


def _call(kernel, queries, ta, tb, tc, out_dtypes, *, tq, tb_block,
          num_warps, interpret, name):
    """One program per ``tq``-query tile; every program reads the whole soup."""
    qplanes, tplanes = _prep(queries, ta, tb, tc, tq, tb_block)
    Qp = qplanes[0].shape[0]
    Tp = tplanes[0].shape[0]
    qspec = pl.BlockSpec((tq,), lambda i: (i,))
    tspec = pl.BlockSpec((Tp,), lambda i: (0,))
    return pl.pallas_call(
        functools.partial(kernel, tb=tb_block, n_tb=Tp // tb_block),
        grid=(Qp // tq,),
        in_specs=[qspec] * 3 + [tspec] * 9,
        out_specs=[qspec] * len(out_dtypes),
        out_shape=[jax.ShapeDtypeStruct((Qp,), d) for d in out_dtypes],
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name=name,
    )(*qplanes, *tplanes)


_STATIC = ("tq", "tb_block", "num_warps", "interpret")


def _raycast_raw(queries, ta, tb, tc, *, raycast_axes, tq, tb_block,
                 num_warps, interpret):
    return _call(
        functools.partial(_kernel_raycast, raycast_axes=raycast_axes),
        queries, ta, tb, tc,
        [jnp.float32] + [jnp.int32] * raycast_axes,
        tq=tq, tb_block=tb_block, num_warps=num_warps, interpret=interpret,
        name="m2s_sdf_raycast",
    )


@functools.partial(jax.jit, static_argnames=("raycast_axes",) + _STATIC)
def sdf_raycast_pallas(
    queries: jax.Array,  # (Q, 3) f32
    ta: jax.Array,  # (T, 3)
    tb: jax.Array,
    tc: jax.Array,
    *,
    raycast_axes: int = 3,
    tq: int = DEFAULT_TQ,
    tb_block: int = DEFAULT_TB,
    num_warps: int = DEFAULT_WARPS,
    interpret: bool = False,
) -> jax.Array:
    """Signed distances, raycast parity sign. Returns (Q,) f32.

    ``raycast_axes=0`` returns the unsigned min distance only (grid mode —
    sign comes from the line-parity pass). 1 = +X only (`default.rs:36`),
    3 = best-of-3 voting (`bvh.rs:133-139`).
    """
    Q = queries.shape[0]
    outs = _raycast_raw(
        queries, ta, tb, tc, raycast_axes=raycast_axes, tq=tq,
        tb_block=tb_block, num_warps=num_warps, interpret=interpret,
    )
    dist = jnp.sqrt(outs[0][:Q])
    if raycast_axes == 0:
        return dist
    odd = [o[:Q] % 2 == 1 for o in outs[1:]]
    if raycast_axes == 1:
        inside = odd[0]
    else:
        inside = sum(o.astype(jnp.int32) for o in odd) >= 2
    return jnp.where(inside, -dist, dist)


@functools.partial(jax.jit, static_argnames=("raycast_axes",) + _STATIC)
def sdf_raycast_parts_pallas(
    queries, ta, tb, tc, *, raycast_axes: int = 3, tq: int = DEFAULT_TQ,
    tb_block: int = DEFAULT_TB, num_warps: int = DEFAULT_WARPS,
    interpret: bool = False,
):
    """Pre-vote kernel outputs: (unsigned dist (Q,), crossing counts
    (Q, axes) int32). For sharded reductions: per-shard counts are ``psum``ed
    over the triangle axis and distances min-reduced BEFORE the parity vote
    (parallel/sharding.py)."""
    Q = queries.shape[0]
    outs = _raycast_raw(
        queries, ta, tb, tc, raycast_axes=max(raycast_axes, 1), tq=tq,
        tb_block=tb_block, num_warps=num_warps, interpret=interpret,
    )
    dist = jnp.sqrt(outs[0][:Q])
    counts = jnp.stack([o[:Q] for o in outs[1:]], axis=-1)
    return dist, counts


@functools.partial(jax.jit, static_argnames=_STATIC)
def sdf_normal_champions_pallas(queries, ta, tb, tc, *, tq: int = DEFAULT_TQ,
                                tb_block: int = DEFAULT_TB,
                                num_warps: int = DEFAULT_WARPS,
                                interpret: bool = False):
    """Pre-combination champions (min positive, min |negative|) per query —
    for sharded reductions where champions are min-combined across triangle
    shards before the single `compare_distances` tie-break."""
    Q = queries.shape[0]
    pos2, neg2 = _call(
        _kernel_normal, queries, ta, tb, tc, [jnp.float32] * 2,
        tq=tq, tb_block=tb_block, num_warps=num_warps, interpret=interpret,
        name="m2s_sdf_normal",
    )
    minpos = jnp.sqrt(jnp.minimum(pos2[:Q], F32_MAX))
    minneg = jnp.sqrt(jnp.minimum(neg2[:Q], F32_MAX))
    return minpos, minneg


@functools.partial(jax.jit, static_argnames=_STATIC)
def sdf_normal_pallas(queries, ta, tb, tc, *, tq: int = DEFAULT_TQ,
                      tb_block: int = DEFAULT_TB,
                      num_warps: int = DEFAULT_WARPS,
                      interpret: bool = False) -> jax.Array:
    """Signed distances with the normal sign method. Returns (Q,) f32.

    Champion semantics match :mod:`..keyed`: the kernel reduces (min pos²,
    min neg²); the fuzzy prefer-positive `compare_distances` rule
    (`lib.rs:242-259`) is applied once between the two champions.
    """
    from ..keyed import combine_champions

    minpos, minneg = sdf_normal_champions_pallas(
        queries, ta, tb, tc, tq=tq, tb_block=tb_block, num_warps=num_warps,
        interpret=interpret,
    )
    return combine_champions(minpos, minneg)
