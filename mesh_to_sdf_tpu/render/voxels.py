"""True voxel rendering: exact ray-cast of the iso-band cell cubes.

The array analog of the client's instanced-cube voxel pass
(`mesh_to_sdf_client/src/passes/voxel_render_pass.rs:280-310`,
`shaders/draw_voxels.wgsl:100-227`): the GPU rasterizes one cube per
ordered-index cell inside ``iso ± cell_width``; here every pixel ray walks
the grid with a fixed-iteration Amanatides–Woo DDA over the same band
occupancy mask — exact cube hits (entering-face position + flat face
normal), no rasterizer. All control flow is `lax.fori_loop` with static
trip count (nx+ny+nz+2, a straight line can cross at most that many
cells), so the whole render is one compiled program.

Behavioral parity, cited into the shader:
- the cube set is exactly the `ordered_indices[lo..hi]` slice around
  ``iso ± cell_width`` (`voxel_render_pass.rs:280-310`, here the
  equivalent membership test `|d - iso| ≤ cell_width`);
- cubes are centered on cell centers with cell_size extents
  (`draw_voxels.wgsl:100-117` `cell + vertex·cell_size·0.5`);
- ONE flat color per cell, sampled at the CELL CENTER (`draw_voxels.wgsl
  :178` "We send the cell center because we want a single color per
  cell"): cubemap albedo when a material is given, else the 0.5 grey mix;
- lighting `ambient 0.2 + (diffuse + 0.5·specular)·shadow` with the same
  per-channel exponential attenuation (`draw_voxels.wgsl:216-227`);
- shadows: the client samples a PCF'd shadow map of the same voxel scene
  (`draw_voxels.wgsl:188-214`); offline we re-walk the DDA toward the
  light through the same occupancy — the same geometry casting hard
  shadows.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..grid import Grid
from .raymarch import Camera


def band_occupancy(dist: jax.Array, grid: Grid, iso: float = 0.0,
                   width_scale: float = 1.0) -> jax.Array:
    """(nx, ny, nz) bool — cells the voxel pass instances as cubes: distance
    within ``iso ± cell_width`` (`voxel_render_pass.rs:280-310`)."""
    w = width_scale * jnp.max(jnp.abs(grid.cell_size))
    d = dist.reshape(grid.cell_count)
    return (d >= iso - w) & (d <= iso + w)


def dda_trace(occ: jax.Array, grid: Grid, origins, directions):
    """Walk rays cell-by-cell through ``occ`` until an occupied cube is hit.

    occ: (nx, ny, nz) bool. origins/directions: (..., 3) world space.
    Returns (hit (...,) bool, t_hit (...,) f32 — world ray parameter of the
    entering-face intersection, cell (..., 3) int32, normal (..., 3) f32 —
    the entered face's outward world normal).
    """
    nx, ny, nz = grid.cell_count
    counts = jnp.asarray((nx, ny, nz), jnp.int32)
    occ_flat = occ.reshape(-1)

    # u-space: cell i's cube spans u ∈ [i-0.5, i+0.5] on each axis — the
    # grid becomes a unit lattice regardless of per-axis (even negative)
    # cell sizes (`grid.rs:135-141` center convention).
    cs = grid.cell_size
    o_u = (origins - grid.first_cell) / cs
    d_u = directions / cs
    d_safe = jnp.where(d_u == 0.0, 1e-12, d_u)

    lo = -0.5
    hi = counts.astype(jnp.float32) - 0.5
    t1 = (lo - o_u) / d_safe
    t2 = (hi - o_u) / d_safe
    t_lo = jnp.minimum(t1, t2)
    t_hi = jnp.maximum(t1, t2)
    t_near = jnp.max(t_lo, axis=-1)
    t_far = jnp.min(t_hi, axis=-1)
    miss = (t_near > t_far) | (t_far < 0.0)

    eps = 1e-4
    t0 = jnp.maximum(t_near, 0.0) + eps
    inside = jnp.all((o_u > lo) & (o_u < hi), axis=-1)
    t0 = jnp.where(inside, 0.0, t0)
    p0 = o_u + t0[..., None] * d_u
    cell0 = jnp.clip(
        jnp.floor(p0 + 0.5).astype(jnp.int32), 0, counts - 1
    )
    # Face by which the ray ENTERED its first cell: the slab that decided
    # t_near (for rays starting inside a cube any face is acceptable —
    # the dominant direction axis is used).
    enter_axis0 = jnp.argmax(t_lo, axis=-1).astype(jnp.int32)
    dom_axis = jnp.argmax(jnp.abs(d_u), axis=-1).astype(jnp.int32)
    enter_axis0 = jnp.where(inside, dom_axis, enter_axis0)

    step = jnp.where(d_u >= 0.0, 1, -1).astype(jnp.int32)
    # Ray parameter at which the ray crosses the current cell's boundary
    # on each axis, and the per-axis crossing period.
    bound = cell0.astype(jnp.float32) + 0.5 * step.astype(jnp.float32)
    tmax = t0[..., None] + (bound - p0) / d_safe
    tmax = jnp.where(d_u == 0.0, jnp.inf, tmax)
    tdelta = jnp.abs(1.0 / d_safe)

    n_steps = nx + ny + nz + 2
    N = nx * ny * nz

    def flat_of(cell):
        return cell[..., 0] * (ny * nz) + cell[..., 1] * nz + cell[..., 2]

    def body(_, st):
        cell, tmax, t, enter_axis, done, hit, t_hit, hit_cell, hit_axis = st
        in_b = jnp.all((cell >= 0) & (cell < counts), axis=-1)
        occ_here = occ_flat[jnp.clip(flat_of(cell), 0, N - 1)] & in_b
        new_hit = occ_here & ~done
        hit = hit | new_hit
        t_hit = jnp.where(new_hit, t, t_hit)
        hit_cell = jnp.where(new_hit[..., None], cell, hit_cell)
        hit_axis = jnp.where(new_hit, enter_axis, hit_axis)
        done = done | new_hit

        axis = jnp.argmin(tmax, axis=-1).astype(jnp.int32)
        t_new = jnp.min(tmax, axis=-1)
        onehot = axis[..., None] == jnp.arange(3)
        cell_n = cell + jnp.where(onehot, step, 0)
        tmax_n = tmax + jnp.where(onehot, tdelta, 0.0)
        exited = t_new > t_far  # left the lattice — no more cubes ahead
        adv = ~done
        cell = jnp.where(adv[..., None], cell_n, cell)
        tmax = jnp.where(adv[..., None], tmax_n, tmax)
        t = jnp.where(adv, t_new, t)
        enter_axis = jnp.where(adv, axis, enter_axis)
        done = done | (exited & adv)
        return cell, tmax, t, enter_axis, done, hit, t_hit, hit_cell, hit_axis

    shape = t0.shape
    st = (
        cell0, tmax, t0, enter_axis0, miss,
        jnp.zeros(shape, bool), jnp.zeros(shape, jnp.float32),
        jnp.zeros(shape + (3,), jnp.int32), jnp.zeros(shape, jnp.int32),
    )
    st = jax.lax.fori_loop(0, n_steps, body, st)
    _, _, _, _, _, hit, t_hit, hit_cell, hit_axis = st

    # World-space outward normal of the entered face: -sign(direction)
    # along the hit axis (u-space step and cell-size sign cancel).
    onehot = hit_axis[..., None] == jnp.arange(3)
    normal = jnp.where(
        onehot, -jnp.sign(directions), 0.0
    ).astype(jnp.float32)
    return hit, t_hit, hit_cell, normal


@functools.partial(
    jax.jit,
    static_argnames=("camera", "iso", "width_scale", "shadows"),
)
def render_voxels(
    dist: jax.Array,
    grid: Grid,
    camera: Camera,
    iso: float = 0.0,
    *,
    width_scale: float = 1.0,
    material=None,
    light_pos: Optional[Tuple[float, float, float]] = None,
    base_color: Tuple[float, float, float] = (0.5, 0.5, 0.5),
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    shadows: bool = True,
) -> jax.Array:
    """Render the iso-band cells as shaded cubes to an (H, W, 3) image.

    The offline equivalent of RenderMode::Voxels (`sdf_program.rs:38-45`,
    `draw_voxels.wgsl`): exact DDA cube intersection standing in for the
    instanced rasterizer, the same per-cell flat color, Blinn lighting and
    attenuation, and occlusion by the same voxel set instead of the PCF
    shadow map.
    """
    occ = band_occupancy(dist, grid, iso, width_scale)
    origins, directions = camera.rays()
    hit, t_hit, hit_cell, normal = dda_trace(occ, grid, origins, directions)
    pos = origins + t_hit[..., None] * directions
    centers = grid.cell_center(hit_cell)

    if light_pos is None:
        bmin, bmax = grid.bounding_box()
        ext = jnp.max(bmax - bmin)
        light = jnp.asarray(camera.eye, jnp.float32) + ext * jnp.asarray(
            [0.0, 1.0, 0.0], jnp.float32
        )
    else:
        light = jnp.asarray(light_pos, jnp.float32)

    light_dir = light - pos
    light_dir = light_dir / jnp.linalg.norm(light_dir, axis=-1, keepdims=True)
    diffuse = jnp.maximum(0.0, jnp.sum(normal * light_dir, axis=-1))

    view_dir = jnp.asarray(camera.eye, jnp.float32) - pos
    view_dir = view_dir / jnp.linalg.norm(view_dir, axis=-1, keepdims=True)
    half = light_dir + view_dir
    half = half / jnp.linalg.norm(half, axis=-1, keepdims=True)
    specular = jnp.maximum(0.0, jnp.sum(normal * half, axis=-1))

    if shadows:
        # Start just off the lit face and re-walk the same occupancy toward
        # the light (`draw_voxels.wgsl:188-214`'s shadow map, hard).
        nudge = 0.6 * jnp.max(jnp.abs(grid.cell_size))
        s_hit, _, _, _ = dda_trace(
            occ, grid, pos + normal * nudge, light_dir
        )
        lit = jnp.where(s_hit, 0.0, 1.0)
    else:
        lit = jnp.ones_like(diffuse)

    if material is not None:
        from .cubemap import sample_cubemap

        color = sample_cubemap(material, centers, normal)
    else:
        color = jnp.broadcast_to(
            jnp.asarray(base_color, jnp.float32), pos.shape
        )
    brightness = 0.2 + (diffuse + 0.5 * specular) * lit
    atten = jnp.stack(
        [
            jnp.exp(-1.8 * (1.0 - brightness)),
            jnp.exp(-1.9 * (1.0 - brightness)),
            jnp.exp(-1.9 * (1.0 - brightness)),
        ],
        axis=-1,
    )
    shaded = jnp.clip(color * atten, 0.0, 1.0)
    bg = jnp.broadcast_to(jnp.asarray(background, jnp.float32), pos.shape)
    return jnp.where(hit[..., None], shaded, bg)
