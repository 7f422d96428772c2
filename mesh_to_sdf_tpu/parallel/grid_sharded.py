"""Multi-device grid SDF: CPT sharded over x-slabs of the grid.

The distributed redesign of the flagship pipeline (SURVEY.md §2.3; BASELINE
config 5 — big grids sharded across the GPUs of a host). Layout: the grid's x axis
is split into equal slabs across the mesh axis ``cells``; triangles are
replicated (the soup is tiny next to a big grid; a ``tris``-sharded variant
all-gathers first).

Per device (shard_map):
1. **seed + local sweeps** — the ordinary CPT engine on the slab's sub-grid
   (same static shape per device, shifted ``first_cell``);
2. **halo exchange** — boundary slices of the CPT state ``ppermute``d to the
   x-neighbors, merged as candidates, then ±x sweeps re-run locally; repeated
   ``halo_rounds`` times (distance information decays with distance, and the
   contract's far-field tolerance absorbs multi-slab tails; near-surface
   cells are seeded locally and unaffected);
3. **sign** — all three parities are slab-local and exact: triangles are
   replicated, so a +x ray cast from a slab's face counts every crossing to
   +infinity; the per-cell suffix count needs no cross-device exchange.

Vote semantics unchanged (≥2 of 3 odd ⇒ inside, `grid.rs:622-639`).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..grid import Grid
from ..types import F32_MAX, SignMethod
from ..ops import cpt as cpt_mod
from ..ops import raycast as raycast_mod
from .mesh import CELL_AXIS


def _slab_grid(grid: Grid, n_dev: int, slab_idx):
    nx, ny, nz = grid.cell_count
    slab_nx = nx // n_dev
    first = grid.first_cell + jnp.asarray(
        [slab_idx * slab_nx, 0, 0], jnp.float32
    ) * grid.cell_size
    return Grid(first_cell=first, cell_size=grid.cell_size,
                cell_count=(slab_nx, ny, nz))


def _merge_boundary(state: cpt_mod.CptState, nb, position: int, centers):
    """Merge a neighbor's boundary slice (fields of one x-slice) as candidates
    for our boundary cells at ``position`` (0 or -1)."""
    row = cpt_mod.CptState(*[getattr(state, n)[position] for n in state._fields])
    row = cpt_mod._merge_eval(row, nb.v1, nb.i1, centers)
    row = cpt_mod._merge_eval(row, nb.v2, nb.i2, centers)
    out = []
    for n in state._fields:
        vol = getattr(state, n)
        out.append(vol.at[position].set(getattr(row, n)))
    return cpt_mod.CptState(*out)


def _x_sweeps(state, centers):
    """±x sweeps only (local; the full candidate window for halo repair)."""
    out = cpt_mod._sweep_axis0(state, centers)
    rev = cpt_mod.CptState(*[getattr(out, n)[::-1] for n in out._fields])
    rev = cpt_mod._sweep_axis0(rev, centers[::-1])
    return cpt_mod.CptState(*[getattr(rev, n)[::-1] for n in rev._fields])


def _slice_state(state, position: int):
    return cpt_mod.CptState(
        *[getattr(state, n)[position] for n in state._fields]
    )


def generate_grid_sdf_sharded_cpt(
    vertices,
    faces,
    grid: Grid,
    mesh: Mesh,
    sign_method: SignMethod = SignMethod.RAYCAST,
    *,
    halo_rounds: int = 2,
) -> jax.Array:
    """Distributed `generate_grid_sdf` (CPT engine), x-slab sharded.

    vertices (V,3)/faces (M,3) host arrays; grid.cell_count[0] must divide
    the mesh's ``cells`` axis size. Returns the full (nx*ny*nz,) f32 SDF
    (x-sharded across devices until materialized).
    """
    n_dev = mesh.shape[CELL_AXIS]
    nx, ny, nz = grid.cell_count
    if nx % n_dev:
        raise ValueError(f"nx={nx} must divide devices={n_dev}")
    slab_nx = nx // n_dev

    v_np = np.asarray(vertices, np.float32)
    f_np = np.asarray(faces, np.int64)
    cs = float(np.max(np.abs(np.asarray(grid.cell_size))))
    # Binned seeds carry exact AABB±1 coverage regardless of triangle size,
    # so the loose 8-cell subdivision cap suffices (≙ gridgen._cpt_prep;
    # the tight SEED_SPAN window bound was a round-1 scatter-seed artifact).
    ra, rb, rc = cpt_mod.subdivide_to_span(v_np, f_np, max_edge=8.0 * cs)
    tris = jnp.asarray(np.stack([ra, rb, rc]))  # (3, T, 3) replicated
    orig = jnp.asarray(
        np.stack([v_np[f_np[:, 0]], v_np[f_np[:, 1]], v_np[f_np[:, 2]]])
    )
    # Per-slab host-binned seeds (exact preheap coverage, no scatter),
    # sharded so each device receives only its slab's gather lists.
    slab_bins = cpt_mod.build_slab_seed_bins(grid, n_dev, ra, rb, rc)
    seed_rounds = slab_bins.n_shift_rounds

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(CELL_AXIS), P(CELL_AXIS), P(CELL_AXIS)),
        out_specs=P(CELL_AXIS),
        check_vma=False,
    )
    def run(tris, orig, seed_entry, seed_rows, seed_cellrow):
        idx = jax.lax.axis_index(CELL_AXIS)
        slab = _slab_grid(grid, n_dev, idx)
        ta, tb, tc = tris[0], tris[1], tris[2]

        seed = cpt_mod.seed_from_bins(
            slab, ta, tb, tc,
            cpt_mod.SeedBins(
                seed_entry[0], seed_rows[0], seed_cellrow[0], seed_rounds
            ),
        )
        # Slab-local
        # sweeps + halo exchange already see less propagation than global
        # sweeps — the reduced runner-up schedule on top pushes far-field
        # divergence from the single-device engine past the 3e-3
        # consistency budget (tests/test_grid_sharded.py).
        dist, tri_idx = cpt_mod.closest_point_grid(
            slab, ta, tb, tc, seed=seed
        )

        # Rebuild the full CPT state for halo exchange: re-seed + re-derive
        # vertex volumes from the final indices (cheaper than carrying state
        # out of closest_point_grid: gradients/ids suffice).
        T = ta.shape[0]
        tv = jnp.concatenate([ta, tb, tc], axis=-1)
        tv = jnp.concatenate(
            [tv, jnp.full((1, 9), cpt_mod.PAD_COORD, jnp.float32)], axis=0
        )
        verts = tv[jnp.where(tri_idx < 0, T, tri_idx)]
        state = cpt_mod.CptState(
            dist, verts, tri_idx,
            jnp.full_like(dist, F32_MAX), jnp.full_like(verts, cpt_mod.PAD_COORD),
            jnp.full_like(tri_idx, -1),
        )
        centers = slab.all_cell_centers()

        left = (idx - 1) % n_dev
        right = (idx + 1) % n_dev
        for _ in range(halo_rounds):
            # Send my low-x boundary to the left neighbor (their high side)
            # and my high-x boundary to the right neighbor (their low side).
            lo = _slice_state(state, 0)
            hi = _slice_state(state, -1)
            from_right = cpt_mod.CptState(*[
                jax.lax.ppermute(
                    getattr(lo, n), CELL_AXIS,
                    [(i, (i - 1) % n_dev) for i in range(n_dev)],
                ) for n in lo._fields
            ])
            from_left = cpt_mod.CptState(*[
                jax.lax.ppermute(
                    getattr(hi, n), CELL_AXIS,
                    [(i, (i + 1) % n_dev) for i in range(n_dev)],
                ) for n in hi._fields
            ])
            # Wrap-around neighbors are not real neighbors: mask them out.
            is_first = idx == 0
            is_last = idx == n_dev - 1
            def masknb(nb, is_edge):
                return cpt_mod.CptState(
                    jnp.where(is_edge, F32_MAX, nb.d1),
                    jnp.where(is_edge, cpt_mod.PAD_COORD, nb.v1),
                    jnp.where(is_edge, -1, nb.i1),
                    jnp.where(is_edge, F32_MAX, nb.d2),
                    jnp.where(is_edge, cpt_mod.PAD_COORD, nb.v2),
                    jnp.where(is_edge, -1, nb.i2),
                )
            from_left = masknb(from_left, is_first)
            from_right = masknb(from_right, is_last)
            state = _merge_boundary(state, from_left, 0, centers[0])
            state = _merge_boundary(state, from_right, -1, centers[-1])
            state = _x_sweeps(state, centers)

        dist = state.d1

        if sign_method == SignMethod.RAYCAST:
            # All three parities are slab-local and exact: triangles are
            # replicated, so a ray cast from this slab's face sees every
            # crossing to +inf — each cell's suffix count needs no
            # cross-device exchange.
            oa, ob, oc = orig[0], orig[1], orig[2]
            valid = jnp.ones((oa.shape[0],), bool)
            inside = raycast_mod.grid_inside_mask(
                slab, oa, ob, oc, valid, tri_block=256
            )
            dist = jnp.where(inside, -dist, dist)
        else:
            dist = cpt_mod.normal_sign_from_idx(
                slab, tris[0], tris[1], tris[2], dist, state.i1
            )

        return dist.reshape(-1)

    t = jax.device_put(tris, NamedSharding(mesh, P()))
    o = jax.device_put(orig, NamedSharding(mesh, P()))
    slab_shard = NamedSharding(mesh, P(CELL_AXIS))
    se = jax.device_put(jnp.asarray(slab_bins.entry_tri), slab_shard)
    sr = jax.device_put(jnp.asarray(slab_bins.rows_cell), slab_shard)
    sc = jax.device_put(jnp.asarray(slab_bins.cell_row), slab_shard)
    return jax.jit(run)(t, o, se, sr, sc)
