"""Offline raymarch renderer: sphere-trace an SDF grid to an image.

The array analog of the client's raymarch pass + shading
(`mesh_to_sdf_client/src/passes/raymarch_pass.rs`,
`shaders/draw_raymarching.wgsl:202-357`): instead of a per-fragment GPU loop,
every pixel is a lane of a fixed-iteration vectorized trace (static shapes,
no data-dependent control flow — XLA-friendly).

Behavioral parity, cited into the shader:
- AABB entry (`:245-253` intersectAABB, entry nudge `:268`);
- sphere trace, MAX_STEPS=100, stop at EPSILON·max(cell_size) (`:89-90,
  255-287`);
- central-difference normals at the same epsilon (`:202-209`);
- Blinn-Phong-ish shading: ambient 0.2 + diffuse + specular, exponential
  attenuation (`:312-357`);
- shadows: the client samples a shadow map; offline we march a second ray
  toward the light through the same grid (same visual contract — hard shadow
  with the grid's own geometry).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..grid import Grid
from .sampler import RaymarchMode, sample, OUT_OF_BOUNDS_DISTANCE

#: `draw_raymarching.wgsl:90` — relative to max cell size.
EPSILON = 0.01
MAX_STEPS = 100


@dataclass(frozen=True)
class Camera:
    """Perspective look-at camera (≙ `camera.rs:18-95`, minus reverse-z which
    only matters for rasterizer depth buffers)."""

    eye: Tuple[float, float, float]
    target: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    fov_y_deg: float = 45.0
    width: int = 512
    height: int = 512

    def rays(self) -> Tuple[jax.Array, jax.Array]:
        """Returns (origins (H,W,3), directions (H,W,3))."""
        eye = jnp.asarray(self.eye, jnp.float32)
        target = jnp.asarray(self.target, jnp.float32)
        up = jnp.asarray(self.up, jnp.float32)
        fwd = target - eye
        fwd = fwd / jnp.linalg.norm(fwd)
        right = jnp.cross(fwd, up)
        right = right / jnp.linalg.norm(right)
        cup = jnp.cross(right, fwd)

        aspect = self.width / self.height
        tan_half = np.tan(np.radians(self.fov_y_deg) * 0.5)
        ys = jnp.linspace(1.0, -1.0, self.height) * tan_half
        xs = jnp.linspace(-1.0, 1.0, self.width) * tan_half * aspect
        d = (
            fwd[None, None]
            + xs[None, :, None] * right[None, None]
            + ys[:, None, None] * cup[None, None]
        )
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        o = jnp.broadcast_to(eye, d.shape)
        return o, d

    @staticmethod
    def orbit(grid: Grid, azimuth_deg=30.0, elevation_deg=25.0, distance=None,
              width=512, height=512) -> "Camera":
        """Frame the grid bbox like the client's camera auto-fit
        (`sdf_program.rs:651-658`)."""
        bmin, bmax = grid.bounding_box()
        bmin = np.asarray(bmin)
        bmax = np.asarray(bmax)
        center = (bmin + bmax) * 0.5
        radius = float(np.linalg.norm(bmax - bmin)) * 0.5
        if distance is None:
            distance = radius * 2.8
        az = np.radians(azimuth_deg)
        el = np.radians(elevation_deg)
        eye = center + distance * np.asarray(
            [np.cos(el) * np.sin(az), np.sin(el), np.cos(el) * np.cos(az)]
        )
        return Camera(
            eye=tuple(eye.tolist()),
            target=tuple(center.tolist()),
            width=width,
            height=height,
        )


def _intersect_aabb(origin, direction, bmin, bmax):
    """Slab test (`draw_raymarching.wgsl:245-253`). Returns (t_near, t_far)."""
    inv = 1.0 / jnp.where(direction == 0.0, 1e-12, direction)
    t_min = (bmin - origin) * inv
    t_max = (bmax - origin) * inv
    t1 = jnp.minimum(t_min, t_max)
    t2 = jnp.maximum(t_min, t_max)
    return jnp.max(t1, axis=-1), jnp.min(t2, axis=-1)


def _grid_epsilon(grid: Grid):
    """`get_grid_epsilon` (`draw_raymarching.wgsl:255-257`)."""
    return EPSILON * jnp.max(jnp.abs(grid.cell_size))


def trace(dist, grid: Grid, origins, directions, iso=0.0,
          mode: RaymarchMode = RaymarchMode.TRILINEAR,
          max_steps: int = MAX_STEPS):
    """Sphere-trace rays against the SDF grid (`sdf_3d`, wgsl `:260-287`).

    Returns (position (...,3), last_distance (...,), hit (...,)).
    """
    eps = _grid_epsilon(grid)
    start = grid.first_cell
    counts = jnp.asarray(grid.cell_count, jnp.float32)
    end = start + (counts - 1.0) * grid.cell_size
    bmin = jnp.minimum(start, end)
    bmax = jnp.maximum(start, end)

    t_near, t_far = _intersect_aabb(origins, directions, bmin, bmax)
    outside_box = t_near > t_far
    inside_start = jnp.all((origins >= bmin) & (origins <= bmax), axis=-1)
    t0 = jnp.where(inside_start, 0.0, jnp.maximum(t_near, 0.0) + eps)
    pos = origins + t0[..., None] * directions

    def sdf(p):
        return sample(dist, grid, p, mode) - iso

    def body(_, state):
        pos, d, done = state
        d_new = sdf(pos)
        done_new = done | (d_new < eps)
        step = jnp.where(done_new, 0.0, d_new)
        pos_new = pos + step[..., None] * directions
        d = jnp.where(done, d, d_new)
        return pos_new, d, done_new

    d0 = jnp.full(pos.shape[:-1], jnp.float32(OUT_OF_BOUNDS_DISTANCE))
    done0 = outside_box  # rays missing the box never start
    pos, d, done = jax.lax.fori_loop(0, max_steps, body, (pos, d0, done0))
    hit = (d < eps) & ~outside_box
    return pos, d, hit


def estimate_normal(dist, grid: Grid, p, iso=0.0,
                    mode: RaymarchMode = RaymarchMode.TRILINEAR):
    """6-tap central differences (`draw_raymarching.wgsl:202-209`)."""
    eps = _grid_epsilon(grid)
    def s(q):
        return sample(dist, grid, q, mode) - iso

    ex = jnp.asarray([1.0, 0, 0]) * eps
    ey = jnp.asarray([0, 1.0, 0]) * eps
    ez = jnp.asarray([0, 0, 1.0]) * eps
    n = jnp.stack(
        [s(p + ex) - s(p - ex), s(p + ey) - s(p - ey), s(p + ez) - s(p - ez)],
        axis=-1,
    )
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    return n / jnp.where(norm == 0.0, 1.0, norm)


def _phong_stylized(dist, grid: Grid, pos, eye, iso,
                    k_d=0.8, k_s=0.5, alpha=50.0,
                    light_pos=(-5.0, 5.0, 5.0),
                    light_intensity=(0.4, 1.0, 0.4)):
    """`phong_lighting` (`draw_raymarching.wgsl:211-231`), branchless: the
    shader's early returns become a where-ladder (light-behind-surface →
    2% ambient; reflection away from viewer → diffuse only)."""
    li = jnp.asarray(light_intensity, jnp.float32)
    n = estimate_normal(dist, grid, pos, iso, RaymarchMode.SNAP_STYLIZED)
    l_dir = jnp.asarray(light_pos, jnp.float32) - pos
    l_dir = l_dir / jnp.linalg.norm(l_dir, axis=-1, keepdims=True)
    v = eye - pos
    v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
    # reflect(-L, N) = -L - 2*dot(-L, N)*N = 2*dot(L,N)*N - L.
    dot_ln = jnp.sum(l_dir * n, axis=-1)
    r = 2.0 * dot_ln[..., None] * n - l_dir
    r = r / jnp.where(
        (rn := jnp.linalg.norm(r, axis=-1, keepdims=True)) == 0.0, 1.0, rn
    )
    dot_rv = jnp.sum(r * v, axis=-1)
    full = k_d * dot_ln + k_s * jnp.power(jnp.maximum(dot_rv, 0.0), alpha)
    strength = jnp.where(
        dot_ln < 0.0, 0.02,
        jnp.where(dot_rv < 0.0, k_d * dot_ln, full),
    )
    return li * strength[..., None]


@functools.partial(
    jax.jit, static_argnames=("camera", "mode", "max_steps", "shadows")
)
def render(
    dist: jax.Array,
    grid: Grid,
    camera: Camera,
    iso: float = 0.0,
    *,
    mode: RaymarchMode = RaymarchMode.TRILINEAR,
    light_pos: Optional[Tuple[float, float, float]] = None,
    base_color: Tuple[float, float, float] = (0.5, 0.5, 0.5),
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    max_steps: int = MAX_STEPS,
    shadows: bool = True,
    material=None,
) -> jax.Array:
    """Render the SDF grid to an (H, W, 3) float image in [0, 1].

    Shading follows `sdf_scene` (`draw_raymarching.wgsl:289-357`): grey base
    color (the client's no-material mix), ambient 0.2, diffuse + Blinn
    specular, per-channel exponential attenuation; hard shadows by re-tracing
    toward the light (offline stand-in for the shadow map + PCF).

    ``material``: optional :class:`.cubemap.Cubemap` — surface albedo from
    6-direction visibility-weighted projection instead of ``base_color``
    (`draw_raymarching.wgsl:364-441`).
    """
    origins, directions = camera.rays()
    pos, d, hit = trace(dist, grid, origins, directions, iso, mode, max_steps)

    if mode == RaymarchMode.SNAP_STYLIZED:
        # Stylized branch (`draw_raymarching.wgsl:302-306`): fixed-light
        # green Phong with NO material mapping, shadows, or attenuation —
        # the snap grid's stepped gradient degenerates normals, so the
        # client shades this mode with phong_lighting(0.8, 0.5, 50,
        # light=(-5,5,5), intensity=(0.4,1.0,0.4)) (`wgsl:211-231`).
        shaded = _phong_stylized(dist, grid, pos,
                                 jnp.asarray(camera.eye, jnp.float32), iso)
        bg = jnp.broadcast_to(jnp.asarray(background, jnp.float32), pos.shape)
        return jnp.where(hit[..., None], jnp.clip(shaded, 0.0, 1.0), bg)

    if light_pos is None:
        bmin, bmax = grid.bounding_box()
        ext = jnp.max(bmax - bmin)
        light = jnp.asarray(camera.eye, jnp.float32) + ext * jnp.asarray(
            [0.0, 1.0, 0.0], jnp.float32
        )
    else:
        light = jnp.asarray(light_pos, jnp.float32)

    normal = estimate_normal(dist, grid, pos, iso, mode)
    light_dir = light - pos
    light_dir = light_dir / jnp.linalg.norm(light_dir, axis=-1, keepdims=True)
    diffuse = jnp.maximum(0.0, jnp.sum(normal * light_dir, axis=-1))

    view_dir = jnp.asarray(camera.eye, jnp.float32) - pos
    view_dir = view_dir / jnp.linalg.norm(view_dir, axis=-1, keepdims=True)
    half = light_dir + view_dir
    half = half / jnp.linalg.norm(half, axis=-1, keepdims=True)
    specular = jnp.maximum(0.0, jnp.sum(normal * half, axis=-1))

    if shadows:
        eps = _grid_epsilon(grid)
        shadow_origin = pos + normal * eps * 4.0
        _, sd, shadow_hit = trace(
            dist, grid, shadow_origin, light_dir, iso, mode, max_steps
        )
        lit = jnp.where(shadow_hit, 0.0, 1.0)
    else:
        lit = jnp.ones_like(diffuse)

    ambient = 0.2
    brightness = ambient + (diffuse + specular) * lit
    if material is not None:
        from .cubemap import sample_cubemap

        color = sample_cubemap(material, pos, normal)
    else:
        color = jnp.broadcast_to(
            jnp.asarray(base_color, jnp.float32), pos.shape
        )
    # Per-channel exponential attenuation (`draw_raymarching.wgsl:353-356`).
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
