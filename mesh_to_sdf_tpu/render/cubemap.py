"""Cubemap material projection — the offline analog of the client's
6-face orthographic albedo capture + SDF surface texturing.

Reference: `mesh_to_sdf_client/src/cubemap.rs:160-311` renders the source
models into six 2048² albedo+depth faces with per-face orthographic cameras
fit to the model bbox; the raymarcher then samples the six faces with
direction-visibility weights and a depth-based fallback
(`shaders/draw_raymarching.wgsl:364-441`) to texture SDF surface points.

Array redesign: no rasterizer — each face is an axis-aligned
ray-casting pass over its texel grid (the same `ray_triangle_aligned_2d`
primitive the sign kernels use). One pass per axis yields BOTH opposing
faces (nearest hit = the face seen from the negative side, farthest = the
positive side). Albedo at a hit is the barycentric blend of the mesh's
per-vertex colors (io/gltf.py ``load_scene(with_materials=True)``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import geometry

# numpy, not jnp: a module-level jnp scalar forces backend init at import.
_INF = np.float32(3.0e38)
#: Texel chunk per device step (bounds the (chunk, T) intermediates).
TEXEL_CHUNK = 4096
#: Default face resolution (the client uses 2048; 256 is plenty for the
#: vertex-resolution albedo this pipeline projects).
DEFAULT_RES = 256


@dataclass(frozen=True)
class Cubemap:
    """Six orthographic albedo+depth faces around a mesh.

    Face order: [-x, +x, -y, +y, -z, +z] (face ``2a`` views the mesh from
    the negative ``a`` side). ``depth`` stores the world coordinate along
    the face axis of the first visible surface (+/-inf where empty).
    """

    albedo: jax.Array  # (6, R, R, 3) f32
    depth: jax.Array  # (6, R, R) f32
    center: Tuple[float, float, float]
    half: Tuple[float, float, float]

    @property
    def resolution(self) -> int:
        return self.albedo.shape[1]


jax.tree_util.register_pytree_node(
    Cubemap,
    lambda cm: ((cm.albedo, cm.depth), (cm.center, cm.half)),
    lambda aux, ch: Cubemap(
        albedo=ch[0], depth=ch[1], center=aux[0], half=aux[1]
    ),
)


def _face_texels(center, half, axis: int, res: int):
    """(res*res, 3) ray origins on the negative side of `axis` + (u, v) ids."""
    iy, iz = (axis + 1) % 3, (axis + 2) % 3
    u = (jnp.arange(res, dtype=jnp.float32) + 0.5) / res * 2.0 - 1.0  # [-1, 1]
    uu, vv = jnp.meshgrid(u, u, indexing="ij")
    o = jnp.zeros((res, res, 3), jnp.float32)
    o = o.at[..., iy].set(center[iy] + uu * half[iy])
    o = o.at[..., iz].set(center[iz] + vv * half[iz])
    o = o.at[..., axis].set(center[axis] - half[axis] * 1.5)
    return o.reshape(-1, 3)


@functools.partial(jax.jit, static_argnames=("axis", "res", "tri_block"))
def _axis_faces(center, half, ta, tb, tc, ca, cb, cc, *, axis: int, res: int,
                tri_block: int = 512):
    """Both faces along `axis`: ((albedo-, depth-), (albedo+, depth+))."""
    origins = _face_texels(center, half, axis, res)
    Q = origins.shape[0]
    T = ta.shape[0]
    pad = (-T) % tri_block
    padv = lambda x: jnp.pad(x, ((0, pad), (0, 0)), constant_values=1e18)
    blocks = jax.tree.map(
        lambda x: padv(x).reshape(-1, tri_block, 3), (ta, tb, tc)
    )
    n_blocks = blocks[0].shape[0]

    chunk = min(TEXEL_CHUNK, Q)
    qpad = (-Q) % chunk  # res² need not divide the chunk (e.g. res=100)
    o_chunks = jnp.pad(origins, ((0, qpad), (0, 0))).reshape(-1, chunk, 3)

    def chunk_body(o):
        def scan_body(carry, inp):
            bidx, (a, b, c) = inp
            tmin, imin, tmax, imax = carry
            inside, t = geometry.ray_triangle_aligned_2d(
                o[:, None, :], a[None], b[None], c[None], axis
            )
            tt = jnp.where(inside, t, _INF)
            arg = jnp.argmin(tt, axis=1).astype(jnp.int32)
            tbest = jnp.take_along_axis(tt, arg[:, None], 1)[:, 0]
            better = tbest < tmin
            tmin = jnp.where(better, tbest, tmin)
            imin = jnp.where(better, bidx * tri_block + arg, imin)
            tt2 = jnp.where(inside, t, -_INF)
            arg2 = jnp.argmax(tt2, axis=1).astype(jnp.int32)
            tbest2 = jnp.take_along_axis(tt2, arg2[:, None], 1)[:, 0]
            better2 = tbest2 > tmax
            tmax = jnp.where(better2, tbest2, tmax)
            imax = jnp.where(better2, bidx * tri_block + arg2, imax)
            return (tmin, imin, tmax, imax), None

        init = (
            jnp.full((chunk,), _INF, jnp.float32),
            jnp.zeros((chunk,), jnp.int32),
            jnp.full((chunk,), -_INF, jnp.float32),
            jnp.zeros((chunk,), jnp.int32),
        )
        (tmin, imin, tmax, imax), _ = jax.lax.scan(
            scan_body, init,
            (jnp.arange(n_blocks, dtype=jnp.int32), blocks),
        )
        return tmin, imin, tmax, imax

    tmin, imin, tmax, imax = jax.lax.map(chunk_body, o_chunks)
    tmin = tmin.reshape(-1)[:Q]
    imin = imin.reshape(-1)[:Q]
    tmax = tmax.reshape(-1)[:Q]
    imax = imax.reshape(-1)[:Q]

    ta_p = jnp.pad(ta, ((0, pad), (0, 0)), constant_values=1e18)
    tb_p = jnp.pad(tb, ((0, pad), (0, 0)), constant_values=1e18)
    tc_p = jnp.pad(tc, ((0, pad), (0, 0)), constant_values=1e18)
    ca_p = jnp.pad(ca, ((0, pad), (0, 0)))
    cb_p = jnp.pad(cb, ((0, pad), (0, 0)))
    cc_p = jnp.pad(cc, ((0, pad), (0, 0)))

    def shade(t, idx, hit):
        p = origins.at[:, axis].add(jnp.where(hit, t, 0.0))
        bary = geometry.closest_point_barycentric(
            p, ta_p[idx], tb_p[idx], tc_p[idx]
        )
        col = (
            bary[:, 0:1] * ca_p[idx]
            + bary[:, 1:2] * cb_p[idx]
            + bary[:, 2:3] * cc_p[idx]
        )
        col = jnp.where(hit[:, None], col, 0.0)
        depth = jnp.where(hit, origins[:, axis] + t, _INF)
        return col.reshape(res, res, 3), depth.reshape(res, res)

    hit_min = tmin < _INF
    hit_max = tmax > -_INF
    alb_n, dep_n = shade(tmin, imin, hit_min)
    alb_p, dep_p = shade(tmax, imax, hit_max)
    dep_p = jnp.where(hit_max.reshape(res, res), dep_p, -_INF)
    return alb_n, dep_n, alb_p, dep_p


def generate_cubemap(vertices, faces, vertex_colors, *, res: int = DEFAULT_RES,
                     pad: float = 1.05) -> Cubemap:
    """Project per-vertex albedo into six orthographic faces
    (≙ `cubemap.rs:160-311` + the generation pass)."""
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int64)
    col = np.asarray(vertex_colors, np.float32)
    lo = v.min(axis=0)
    hi = v.max(axis=0)
    center = (lo + hi) / 2
    half = np.maximum((hi - lo) / 2 * pad, 1e-6)

    ta, tb, tc = (jnp.asarray(v[f[:, k]]) for k in range(3))
    ca, cb, cc = (jnp.asarray(col[f[:, k]]) for k in range(3))
    c_j = jnp.asarray(center)
    h_j = jnp.asarray(half)

    albedo = []
    depth = []
    for axis in range(3):
        alb_n, dep_n, alb_p, dep_p = _axis_faces(
            c_j, h_j, ta, tb, tc, ca, cb, cc, axis=axis, res=res
        )
        albedo += [alb_n, alb_p]
        depth += [dep_n, dep_p]
    return Cubemap(
        albedo=jnp.stack(albedo),
        depth=jnp.stack(depth),
        center=tuple(float(x) for x in center),
        half=tuple(float(x) for x in half),
    )


def sample_cubemap(cm: Cubemap, pos, normal, *, depth_tolerance: float = None):
    """Albedo at surface points: 6-direction visibility-weighted blend with a
    depth-occlusion falloff (`draw_raymarching.wgsl:364-441` semantics).

    pos/normal: (..., 3). Returns (..., 3) linear albedo (grey 0.6 where no
    face sees the point).
    """
    res = cm.resolution
    center = jnp.asarray(cm.center, jnp.float32)
    half = jnp.asarray(cm.half, jnp.float32)
    if depth_tolerance is None:
        depth_tolerance = 4.0 * float(max(cm.half)) * 2.0 / res

    total_w = None
    total_c = None
    for axis in range(3):
        iy, iz = (axis + 1) % 3, (axis + 2) % 3
        u = (pos[..., iy] - (center[iy] - half[iy])) / (2 * half[iy])
        v = (pos[..., iz] - (center[iz] - half[iz])) / (2 * half[iz])
        ui = jnp.clip((u * res).astype(jnp.int32), 0, res - 1)
        vi = jnp.clip((v * res).astype(jnp.int32), 0, res - 1)
        for s, face in ((-1.0, 2 * axis), (1.0, 2 * axis + 1)):
            # A face captured from side s sees surfaces whose normal points
            # toward s (squared falloff like the shader's pow(dot, …)).
            w = jnp.maximum(0.0, s * normal[..., axis]) ** 2
            alb = cm.albedo[face][ui, vi]
            dep = cm.depth[face][ui, vi]
            occ = jnp.abs(pos[..., axis] - dep)
            vis = jnp.where(occ < depth_tolerance, 1.0, 0.05)
            w = w * vis
            c = alb * w[..., None]
            total_w = w if total_w is None else total_w + w
            total_c = c if total_c is None else total_c + c
    grey = jnp.full(pos.shape, 0.6, jnp.float32)
    ok = total_w > 1e-6
    return jnp.where(
        ok[..., None], total_c / jnp.maximum(total_w, 1e-6)[..., None], grey
    )
