"""Sharded SDF generation and training: shard_map over the (cells, tris) mesh.

Collective layout (SURVEY.md §2.3):

- query points / grid cells sharded on ``cells`` (pure data parallelism);
- triangles sharded on ``tris``; per-shard champions are combined by a tiny
  ``all_gather`` over ``tris`` (n_shards floats per query) followed by a local
  min — differentiable, unlike ``pmin``, so the same code path serves
  training. The raycast crossing counts use ``psum`` (sign is stop-grad);
- vertex gradients: vertices enter replicated; shard_map's transpose inserts
  the ``psum`` over both axes automatically, overlapped by XLA with the
  backward compute.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..grid import Grid
from ..types import SignMethod, Strategy
from ..ops import autodiff, dense
from ..ops.keyed import combine_champions
from ..ops import geometry
from .mesh import CELL_AXIS, TRI_AXIS, pad_for_axis


def _shard_ray_counts(queries, vertices, tri_idx, raycast_axes):
    """Crossing counts over the local triangle shard (stop-grad)."""
    v = jax.lax.stop_gradient(vertices)
    q = jax.lax.stop_gradient(queries)
    ta = v[jnp.maximum(tri_idx[:, 0], 0)]
    tb = v[jnp.maximum(tri_idx[:, 1], 0)]
    tc = v[jnp.maximum(tri_idx[:, 2], 0)]
    valid = tri_idx[:, 0] >= 0
    counts = []
    for axis in range(raycast_axes):
        hit, _ = geometry.ray_triangle_aligned(
            q[:, None, :], ta[None], tb[None], tc[None], axis
        )
        counts.append(jnp.sum(hit & valid[None, :], axis=1, dtype=jnp.int32))
    return jnp.stack(counts, axis=-1)


#: Vertex sentinel neutralizing padded (-1) triangle rows in the Triton
#: kernel: distance ~1e18 (never wins), no ray hits.
_FAR = 1.0e18


def _pallas_safe_tris(vertices, tri_idx):
    """Gather triangle vertices; move invalid (pad) rows far away."""
    v = jax.lax.stop_gradient(vertices)
    valid = (tri_idx[:, 0] >= 0)[:, None]
    ta = jnp.where(valid, v[jnp.maximum(tri_idx[:, 0], 0)], _FAR)
    tb = jnp.where(valid, v[jnp.maximum(tri_idx[:, 1], 0)], _FAR)
    tc = jnp.where(valid, v[jnp.maximum(tri_idx[:, 2], 0)], _FAR)
    return ta, tb, tc


def _make_champions_fn(block: int):
    """(vertices, tri_idx, queries) -> (minpos, minneg): the dense engine's
    kernel as the primal where it runs (serving / inference speed), scan
    engine + envelope VJP under differentiation (the kernel does not expose
    argmin residuals)."""
    if dense.dense_strategy() != Strategy.PALLAS:
        return lambda v, t, q: autodiff.signed_champion_distances(v, t, q, block)

    from ..ops.kernels import pallas_sdf

    @jax.custom_vjp
    def champs(vertices, tri_idx, queries):
        ta, tb, tc = _pallas_safe_tris(vertices, tri_idx)
        return pallas_sdf.sdf_normal_champions_pallas(queries, ta, tb, tc)

    def fwd(vertices, tri_idx, queries):
        return autodiff._champ_fwd(vertices, tri_idx, queries, block)

    def bwd(res, gs):
        return autodiff._champ_bwd(block, res, gs)

    champs.defvjp(fwd, bwd)
    return champs


def _make_dist_counts_fn(block: int, raycast_axes: int):
    """(vertices, tri_idx, queries) -> (dist, counts (Q, axes)). The kernel
    primal fuses distance + 3-axis parity in ONE triangle pass; counts are
    stop-grad (piecewise constant sign)."""
    if dense.dense_strategy() != Strategy.PALLAS:
        def fn(vertices, tri_idx, queries):
            d = autodiff.unsigned_min_distance(vertices, tri_idx, queries, block)
            counts = _shard_ray_counts(queries, vertices, tri_idx, raycast_axes)
            return d, counts

        return fn

    from ..ops.kernels import pallas_sdf

    @jax.custom_vjp
    def dist_counts(vertices, tri_idx, queries):
        ta, tb, tc = _pallas_safe_tris(vertices, tri_idx)
        return pallas_sdf.sdf_raycast_parts_pallas(
            queries, ta, tb, tc, raycast_axes=raycast_axes
        )

    def fwd(vertices, tri_idx, queries):
        d, res = autodiff._min_fwd(vertices, tri_idx, queries, block)
        counts = _shard_ray_counts(queries, vertices, tri_idx, raycast_axes)
        return (d, counts), res

    def bwd(res, gs):
        gd, _gcounts = gs
        return autodiff._min_bwd(block, res, gd)

    dist_counts.defvjp(fwd, bwd)
    return dist_counts


def sharded_sdf_fn(mesh: Mesh, sign_method: SignMethod, *, raycast_axes: int = 3,
                   block: int = 256):
    """Build a differentiable sharded SDF function
    ``f(vertices (V,3) replicated, tri_idx (M,3) sharded[tris], queries (Q,3)
    sharded[cells]) -> (Q,) sharded[cells]``.

    M must divide mesh.shape[tris]; Q must divide mesh.shape[cells].

    Each shard's forward runs the dense engine of :mod:`..ops.dense` (the
    same kernel the unsharded path uses on the GPU); under differentiation
    the scan engine + envelope VJP run instead.
    """
    champs_fn = _make_champions_fn(block)
    dist_counts_fn = _make_dist_counts_fn(block, raycast_axes)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(TRI_AXIS), P(CELL_AXIS)),
        out_specs=P(CELL_AXIS),
        # scan carries are initialized per-shard; skip the varying-axes check
        check_vma=False,
    )
    def fn(vertices, tri_idx, queries):
        if sign_method == SignMethod.NORMAL:
            mp, mn = champs_fn(vertices, tri_idx, queries)
            # champions across triangle shards: tiny all_gather + min
            mp = jnp.min(jax.lax.all_gather(mp, TRI_AXIS, axis=0), axis=0)
            mn = jnp.min(jax.lax.all_gather(mn, TRI_AXIS, axis=0), axis=0)
            return combine_champions(mp, mn)

        dist, counts = dist_counts_fn(vertices, tri_idx, queries)
        dist = jnp.min(jax.lax.all_gather(dist, TRI_AXIS, axis=0), axis=0)
        counts = jax.lax.psum(counts, TRI_AXIS)
        odd = counts % 2 == 1
        if raycast_axes == 1:
            inside = odd[:, 0]
        else:
            inside = jnp.sum(odd, axis=1) >= 2
        return jnp.where(inside, -dist, dist)

    return fn


def generate_sdf_sharded(
    vertices,
    tri_idx,
    query_points,
    mesh: Mesh,
    sign_method: SignMethod = SignMethod.RAYCAST,
    *,
    raycast_axes: int = 3,
    block: int = 256,
) -> jax.Array:
    """Multi-device `generate_sdf`. Host-pads inputs, places shards, computes.

    Inputs are host arrays; tri_idx is (M,3) int (padded rows = -1).
    """
    vertices = jnp.asarray(vertices, jnp.float32)
    tri_np = np.asarray(tri_idx, np.int32)
    q_np = np.asarray(query_points, np.float32)
    Q = q_np.shape[0]

    Mpad = pad_for_axis(max(tri_np.shape[0], 1), mesh, TRI_AXIS, block)
    tri_np = np.concatenate(
        [tri_np, np.full((Mpad - tri_np.shape[0], 3), -1, np.int32)]
    )
    Qpad = pad_for_axis(max(Q, 1), mesh, CELL_AXIS, 8)
    q_np = np.concatenate([q_np, np.zeros((Qpad - Q, 3), np.float32)])

    fn = sharded_sdf_fn(mesh, sign_method, raycast_axes=raycast_axes,
                        block=block)
    v = jax.device_put(vertices, NamedSharding(mesh, P()))
    t = jax.device_put(jnp.asarray(tri_np), NamedSharding(mesh, P(TRI_AXIS)))
    q = jax.device_put(jnp.asarray(q_np), NamedSharding(mesh, P(CELL_AXIS)))
    out = jax.jit(fn)(v, t, q)
    return out[:Q]


def generate_sdf_sharded_culled(
    vertices,
    faces,
    query_points,
    mesh: Mesh,
    *,
    raycast_axes: int = 3,
    st: Optional[int] = None,
) -> jax.Array:
    """Multi-device CULLED `generate_sdf` (raycast sign): queries sharded on
    ``cells``; the Morton block index and sign grid are built once on the
    host and replicated (≙ the reference building one R-tree + BVH shared
    by all rayon workers, `rtree_bvh.rs:108-119`). Each shard runs the
    gathered pass (distance + anchor-segment sign) with its widened retry;
    the few certificate-failed queries re-route through the exact sharded
    dense path — so the result is exact everywhere.
    """
    from ..ops import culling
    from ..query import (
        _block_index_cached, _sign_grid_cached, prepare_triangles,
    )
    from ..topology import Topology as _T

    n_dev = mesh.shape[CELL_AXIS]
    f_np = np.asarray(faces, np.int64).reshape(-1, 3)
    topo = _T.triangle_list(f_np.reshape(-1))
    ta, tb, tc, valid, n_tris = prepare_triangles(vertices, topo, 1024)
    bi = _block_index_cached(ta, tb, tc, n_tris)
    sg = _sign_grid_cached(ta, tb, tc, valid, n_tris)

    q_np = np.asarray(query_points, np.float32)
    Q = q_np.shape[0]
    if st is None:
        st = 64 if Q >= 262_144 * n_dev else 32
    Qpad = pad_for_axis(max(Q, 1), mesh, CELL_AXIS, st * 64)
    # Edge-pad (repeat the last real query), NOT zeros: origin-point padding
    # would join Morton sub-tiles, inflate their radii and loosen every
    # certificate sharing a sub-tile.
    if Q > 0:
        fill = np.repeat(q_np[-1:], Qpad - Q, axis=0)
    else:
        fill = np.zeros((Qpad, 3), np.float32)
    q_np = np.concatenate([q_np, fill])

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(CELL_AXIS)),
        out_specs=(P(CELL_AXIS), P(CELL_AXIS)),
        check_vma=False,
    )
    def run(bi_r, sg_inside, q_shard):
        signed, flag, _work = culling._gather_widened(
            q_shard, bi_r, sg_inside, sg.grid, st=st, kg=culling.DEFAULT_KG,
        )
        return signed, flag

    bi_r = jax.device_put(bi, NamedSharding(mesh, P()))
    ins = jax.device_put(sg.inside, NamedSharding(mesh, P()))
    q = jax.device_put(jnp.asarray(q_np), NamedSharding(mesh, P(CELL_AXIS)))
    signed, flag = jax.jit(run)(bi_r, ins, q)
    signed = signed[:Q]
    flag = np.asarray(flag[:Q])
    bad = np.flatnonzero(flag)
    if len(bad):
        sub = generate_sdf_sharded(
            vertices, f_np.astype(np.int32), q_np[bad], mesh,
            SignMethod.RAYCAST, raycast_axes=raycast_axes,
        )
        signed = signed.at[jnp.asarray(bad)].set(sub)
    return signed


def generate_grid_sdf_sharded(
    vertices,
    tri_idx,
    grid: Grid,
    mesh: Mesh,
    sign_method: SignMethod = SignMethod.RAYCAST,
    *,
    block: int = 256,
) -> jax.Array:
    """Multi-device grid SDF: cells flattened and sharded on ``cells``.

    Raycast sign uses per-cell 3-axis parity (equivalent to the line-based
    kernel but shardable cell-wise; the counts are psummed over ``tris``).
    """
    centers = np.asarray(grid.all_cell_centers()).reshape(-1, 3)
    out = generate_sdf_sharded(
        vertices, tri_idx, centers, mesh, sign_method, block=block
    )
    return out.reshape(-1)


def sharded_fit_step_fn(mesh: Mesh, tri_idx, grid: Grid, optimizer,
                        sign_method=SignMethod.NORMAL, block: int = 256):
    """Build a jitted sharded training step for the DifferentiableSDF model.

    Cells (and the target grid) are sharded on ``cells``; triangles on
    ``tris``; vertices and optimizer state replicated. The vertex-gradient
    all-reduce is inserted by shard_map's transpose and overlaps backward.
    """
    centers = np.asarray(grid.all_cell_centers()).reshape(-1, 3)
    N = centers.shape[0]
    Npad = pad_for_axis(N, mesh, CELL_AXIS, 8)
    centers = np.concatenate([centers, np.zeros((Npad - N, 3), np.float32)])
    centers = jax.device_put(
        jnp.asarray(centers), NamedSharding(mesh, P(CELL_AXIS))
    )
    tri_np = np.asarray(tri_idx, np.int32)
    Mpad = pad_for_axis(max(tri_np.shape[0], 1), mesh, TRI_AXIS, block)
    tri_np = np.concatenate(
        [tri_np, np.full((Mpad - tri_np.shape[0], 3), -1, np.int32)]
    )
    tri = jax.device_put(
        jnp.asarray(tri_np), NamedSharding(mesh, P(TRI_AXIS))
    )
    sdf_fn = sharded_sdf_fn(mesh, sign_method, block=block)
    valid_mask = jnp.arange(Npad) < N

    def loss_fn(vertices, target):
        pred = sdf_fn(vertices, tri, centers)
        err = jnp.where(valid_mask, pred - target, 0.0)
        return jnp.sum(err * err) / N

    @jax.jit
    def step(vertices, opt_state, target):
        loss, grads = jax.value_and_grad(loss_fn)(vertices, target)
        updates, opt_state = optimizer.update(grads, opt_state, vertices)
        vertices = jax.tree.map(lambda p, u: p + u, vertices, updates)
        return vertices, opt_state, loss

    def pad_target(target_flat):
        t = np.asarray(target_flat, np.float32).reshape(-1)
        t = np.concatenate([t, np.zeros(Npad - N, np.float32)])
        return jax.device_put(jnp.asarray(t), NamedSharding(mesh, P(CELL_AXIS)))

    return step, pad_target
