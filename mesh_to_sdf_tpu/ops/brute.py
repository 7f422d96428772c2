"""Fused XLA brute-force SDF engine: query blocks × triangle blocks.

The array replacement for the reference's tree-based generators
(`mesh_to_sdf/src/generate/generic/{default,bvh,rtree,rtree_bvh}.rs`): a
dense tiled sweep of all triangle blocks with an associative reduction. XLA
fuses the per-pair geometry (≈80 flops) into the block reduction, so the
(chunk × block) pair tensor is not written to device memory. The reference
engine for the GPU kernel (:mod:`.kernels.pallas_sdf`) and the CPU route of
:mod:`.dense`.

Shapes are static everywhere: queries are padded to a multiple of the chunk
size, triangles to a multiple of the block size, with validity masks.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..types import F32_MAX, SignMethod
from . import geometry
from .keyed import combine_champions

# Default tile sizes: a (CHUNK, BLOCK) f32 intermediate is 4 MB.
DEFAULT_QUERY_CHUNK = 2048
DEFAULT_TRI_BLOCK = 512


def pad_tri_blocks(ta, tb, tc, valid, block: int):
    """Pad triangle arrays so their length divides ``block`` (pad = invalid).
    Returns (ta, tb, tc, valid, block) with block clamped to the padded size."""
    T = ta.shape[0]
    block = max(1, min(block, T)) if T > 0 else block
    rem = (-T) % block
    if rem:
        zero = jnp.zeros((rem, 3), ta.dtype)
        ta = jnp.concatenate([ta, zero])
        tb = jnp.concatenate([tb, zero])
        tc = jnp.concatenate([tc, zero])
        valid = jnp.concatenate([valid, jnp.zeros((rem,), bool)])
    return ta, tb, tc, valid, block


def pad_to_multiple(arr: jax.Array, multiple: int, axis: int = 0, value=0.0):
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, rem)
    return jnp.pad(arr, widths, constant_values=value)


def _pair_payload(queries, ta, tb, tc, sign_method: SignMethod, raycast_axes: int):
    """Per-pair payload for one (chunk, block) tile.

    queries: (C, 3); ta/tb/tc: (B, 3). Returns:
    - RAYCAST: (dist (C,B), crossings (C,B,axes) bool)
    - NORMAL:  (signed_dist (C,B), None)
    """
    q = queries[:, None, :]
    a = ta[None, :, :]
    b = tb[None, :, :]
    c = tc[None, :, :]
    if sign_method == SignMethod.NORMAL:
        return geometry.point_triangle_signed_distance(q, a, b, c), None
    dist = geometry.point_triangle_distance(q, a, b, c)
    if raycast_axes == 0:
        return dist, None
    hits = []
    for axis in range(raycast_axes):
        hit, _ = geometry.ray_triangle_aligned(q, a, b, c, axis)
        hits.append(hit)
    return dist, jnp.stack(hits, axis=-1)


@functools.partial(
    jax.jit, static_argnames=("sign_method", "raycast_axes", "tri_block")
)
def sdf_chunk(
    queries: jax.Array,  # (C, 3)
    tri_a: jax.Array,  # (T, 3) padded to tri_block multiple
    tri_b: jax.Array,
    tri_c: jax.Array,
    tri_valid: jax.Array,  # (T,) bool
    *,
    sign_method: SignMethod,
    raycast_axes: int,
    tri_block: int,
) -> jax.Array:
    """Signed distances for one chunk of queries against all triangles."""
    n_blocks = tri_a.shape[0] // tri_block
    C = queries.shape[0]

    blocks = jax.tree.map(
        lambda x: x.reshape((n_blocks, tri_block) + x.shape[1:]),
        (tri_a, tri_b, tri_c, tri_valid),
    )

    if sign_method == SignMethod.NORMAL:
        init = (
            jnp.full((C,), F32_MAX, jnp.float32),  # min positive magnitude
            jnp.full((C,), F32_MAX, jnp.float32),  # min negative magnitude
        )

        def body(carry, blk):
            a, b, c, valid = blk
            minpos, minneg = carry
            sd, _ = _pair_payload(queries, a, b, c, sign_method, raycast_axes)
            neg = jnp.signbit(sd)
            pos_vals = jnp.where(valid[None, :] & ~neg, sd, F32_MAX)
            neg_vals = jnp.where(valid[None, :] & neg, -sd, F32_MAX)
            minpos = jnp.minimum(minpos, jnp.min(pos_vals, axis=1))
            minneg = jnp.minimum(minneg, jnp.min(neg_vals, axis=1))
            return (minpos, minneg), None

        (minpos, minneg), _ = jax.lax.scan(body, init, blocks)
        return combine_champions(minpos, minneg)

    # RAYCAST (raycast_axes == 0 means unsigned-distance-only — used by the
    # grid generator whose sign comes from the separate line-parity kernel).
    init = (
        jnp.full((C,), F32_MAX, jnp.float32),
        jnp.zeros((C, max(raycast_axes, 1)), jnp.int32),
    )

    def body(carry, blk):
        a, b, c, valid = blk
        mind, counts = carry
        dist, hits = _pair_payload(queries, a, b, c, sign_method, raycast_axes)
        dist = jnp.where(valid[None, :], dist, F32_MAX)
        mind = jnp.minimum(mind, jnp.min(dist, axis=1))
        if raycast_axes > 0:
            counts = counts + jnp.sum(
                hits & valid[None, :, None], axis=1, dtype=jnp.int32
            )
        return (mind, counts), None

    (mind, counts), _ = jax.lax.scan(body, init, blocks)
    if raycast_axes == 0:
        return mind
    odd = counts % 2 == 1
    if raycast_axes == 1:
        # Reference default backend: single +X ray (`default.rs:34-37,65-72`).
        inside = odd[:, 0]
    else:
        # Best-of-3 voting (`bvh.rs:133-139`, `rtree_bvh.rs:161-171`,
        # `grid.rs:633-638`): inside iff at least two axes are odd.
        inside = jnp.sum(odd, axis=1) >= 2
    return jnp.where(inside, -mind, mind)


@functools.partial(
    jax.jit,
    static_argnames=("sign_method", "raycast_axes", "tri_block", "query_chunk"),
)
def sdf_brute(
    queries: jax.Array,  # (Q, 3) padded to query_chunk multiple
    tri_a: jax.Array,
    tri_b: jax.Array,
    tri_c: jax.Array,
    tri_valid: jax.Array,
    *,
    sign_method: SignMethod,
    raycast_axes: int = 3,
    tri_block: int = DEFAULT_TRI_BLOCK,
    query_chunk: int = DEFAULT_QUERY_CHUNK,
) -> jax.Array:
    """Brute-force SDF over all (query, triangle) pairs, chunked 2-D."""
    Q = queries.shape[0]
    chunk = min(query_chunk, Q)
    if Q % chunk != 0:
        raise ValueError(f"queries ({Q}) must be padded to a multiple of {chunk}")
    chunked = queries.reshape(Q // chunk, chunk, 3)
    fn = functools.partial(
        sdf_chunk,
        tri_a=tri_a,
        tri_b=tri_b,
        tri_c=tri_c,
        tri_valid=tri_valid,
        sign_method=sign_method,
        raycast_axes=raycast_axes,
        tri_block=tri_block,
    )
    out = jax.lax.map(fn, chunked)
    return out.reshape(Q)
