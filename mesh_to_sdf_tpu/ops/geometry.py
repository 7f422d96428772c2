"""Branchless triangle geometry kernels (vmappable, XLA/Pallas-friendly).

Array re-design of the reference geometry layer
(`mesh_to_sdf/src/geo.rs`). Every function here is:

- **branchless** — the reference's early-return ladders (Embree region tests,
  degenerate-triangle guards) become ``jnp.where`` selection ladders so the
  whole thing vectorizes with static shapes;
- **broadcasting** — all functions accept arbitrary leading batch dims, so the
  same code runs per-pair inside a Pallas tile or over a full (Q, T) block;
- **division-safe** — every divisor is guarded so no branch ever produces
  NaN/Inf (required both for ``where``-ladder correctness and for autodiff).

Semantics parity notes (cited into /root/reference):
- closest point on triangle: Embree case analysis + degenerate guards
  (`geo.rs:70-138`), segment projection (`geo.rs:141-151`).
- AABB epsilon inflation of 1e-4 (`geo.rs:5,20-21`).
- signed distance normal test is *strictly greater* ⇒ positive
  (`geo.rs:51-55`, dot == 0 is negative).
- axis-aligned ray/triangle: 2-D edge cross products, same-strict-sign test,
  ``t > 0`` strictly (`geo.rs:165-216`); axis rotation (x,y,z) → (k, k+1, k+2)
  mod 3 (`geo.rs:181-195`).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

#: AABB inflation epsilon (`geo.rs:5`).
AABB_EPSILON = 1e-4


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _safe_div(num, den):
    """num/den with den==0 treated as 1 (branch never selected downstream)."""
    safe = jnp.where(den == 0.0, 1.0, den)
    return num / safe


def _safe_recip(x):
    return jnp.where(x == 0.0, 0.0, 1.0 / jnp.where(x == 0.0, 1.0, x))


def closest_point_vw(apx, apy, apz, abx, aby, abz, acx, acy, acz):
    """Plane-form closest-point ladder: barycentric (v, w) of the closest
    point (u = 1-v-w) from the separate coordinate planes of ap = p − a,
    ab and ac (any broadcastable shapes).

    Algebraically restructured Embree ladder (`geo.rs:70-138`) whose
    per-pair work is mul/add/select only: the edge parameters and the
    interior denominator ``|ab×ac|²`` are per-triangle. Degenerate
    triangles take the reference's segment/vertex fallbacks
    (`geo.rs:73-88`). Returns (v, w, d1, d2, A, B_, C) — the latter reused
    by :func:`dist2_vw` and the normal-sign test. Shared by the Triton
    kernel, the CULLED gather pass and the CPT sweeps.
    """
    d1 = abx * apx + aby * apy + abz * apz
    d2 = acx * apx + acy * apy + acz * apz

    A = abx * abx + aby * aby + abz * abz  # |ab|²      (1, B)
    B_ = abx * acx + aby * acy + abz * acz  # ab·ac
    C = acx * acx + acy * acy + acz * acz  # |ac|²

    d3 = d1 - A
    d4 = d2 - B_
    d5 = d1 - B_
    d6 = d2 - C

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    inv_A = _safe_recip(A)
    inv_C = _safe_recip(C)
    inv_bc = _safe_recip(A - 2.0 * B_ + C)  # 1/|b-c|²
    inv_den = _safe_recip(A * C - B_ * B_)  # 1/|ab×ac|²

    t_ab = d1 * inv_A
    t_ac = d2 * inv_C
    t_bc = (d4 - d3) * inv_bc

    # Lowest priority: interior (`geo.rs:130-137`), then edges, then vertices.
    v = vb * inv_den
    w = vc * inv_den

    on_bc = (va <= 0.0) & (d4 - d3 >= 0.0) & (d5 - d6 >= 0.0)
    v = jnp.where(on_bc, 1.0 - t_bc, v)
    w = jnp.where(on_bc, t_bc, w)

    on_ac = (vb <= 0.0) & (d2 >= 0.0) & (d6 <= 0.0)
    v = jnp.where(on_ac, 0.0, v)
    w = jnp.where(on_ac, t_ac, w)

    on_ab = (vc <= 0.0) & (d1 >= 0.0) & (d3 <= 0.0)
    v = jnp.where(on_ab, t_ab, v)
    w = jnp.where(on_ab, 0.0, w)

    in_c = (d6 >= 0.0) & (d5 <= d6)
    v = jnp.where(in_c, 0.0, v)
    w = jnp.where(in_c, 1.0, w)

    in_b = (d3 >= 0.0) & (d4 <= d3)
    v = jnp.where(in_b, 1.0, v)
    w = jnp.where(in_b, 0.0, w)

    in_a = (d1 <= 0.0) & (d2 <= 0.0)
    v = jnp.where(in_a, 0.0, v)
    w = jnp.where(in_a, 0.0, w)

    # Degenerate guards (`geo.rs:73-88`): per-triangle masks, highest priority.
    eq_ab = (abx == 0.0) & (aby == 0.0) & (abz == 0.0)  # b == a
    eq_ac = (acx == 0.0) & (acy == 0.0) & (acz == 0.0)  # c == a
    eq_bc = (abx == acx) & (aby == acy) & (abz == acz)  # b == c
    s_ab = jnp.clip(t_ab, 0.0, 1.0)
    s_ac = jnp.clip(t_ac, 0.0, 1.0)
    seg_ab = eq_bc | eq_ac  # degenerate → segment [a, b]
    v = jnp.where(seg_ab, s_ab, v)
    w = jnp.where(seg_ab, 0.0, w)
    v = jnp.where(eq_ab, 0.0, v)  # degenerate → segment [a, c]
    w = jnp.where(eq_ab, s_ac, w)
    all_eq = eq_ab & eq_bc
    v = jnp.where(all_eq, 0.0, v)
    w = jnp.where(all_eq, 0.0, w)
    return v, w, d1, d2, A, B_, C


def dist2_vw(apx, apy, apz, v, w, d1, d2, A, B_, C):
    """Squared distance |ap − v·ab − w·ac|², expanded (clamped at 0)."""
    ap2 = apx * apx + apy * apy + apz * apz
    d2out = ap2 + v * (v * A - 2.0 * d1 + 2.0 * w * B_) + w * (w * C - 2.0 * d2)
    return jnp.maximum(d2out, 0.0)


def triangle_bounding_box(a, b, c):
    """Per-triangle AABB inflated by ``AABB_EPSILON`` (`geo.rs:4-22`).

    Args are (..., 3); returns (min, max) each (..., 3).
    """
    lo = jnp.minimum(a, jnp.minimum(b, c)) - AABB_EPSILON
    hi = jnp.maximum(a, jnp.maximum(b, c)) + AABB_EPSILON
    return lo, hi


def triangle_normal(a, b, c):
    """Unnormalized triangle normal ``(b-a)×(c-a)`` (`geo.rs:60-64`)."""
    return jnp.cross(b - a, c - a)


def closest_point_barycentric(p, a, b, c):
    """Barycentric coords (u, v, w) of the point of triangle abc closest to p.

    Branchless port of the Embree region ladder (`geo.rs:70-138`) including the
    degenerate-triangle guards (`geo.rs:73-88`). The closest point is
    ``u*a + v*b + w*c``. Returned shape: (..., 3) with u+v+w == 1.

    Priority of the reference's sequential early returns is reproduced by
    applying ``where`` overrides in *reverse* order (later override wins).
    """
    p = jnp.asarray(p, jnp.float32)
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    c = jnp.asarray(c, jnp.float32)

    ab = b - a
    ac = c - a
    ap = p - a
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)

    bp = p - b
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)

    cp = p - c
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    # Region conditions in the reference's order (geo.rs:97-137). Earlier
    # conditions have priority.
    in_a = (d1 <= 0.0) & (d2 <= 0.0)
    in_b = (d3 >= 0.0) & (d4 <= d3)
    in_c = (d6 >= 0.0) & (d5 <= d6)
    on_ab = (vc <= 0.0) & (d1 >= 0.0) & (d3 <= 0.0)
    on_ac = (vb <= 0.0) & (d2 >= 0.0) & (d6 <= 0.0)
    on_bc = (va <= 0.0) & (d4 - d3 >= 0.0) & (d5 - d6 >= 0.0)

    t_ab = _safe_div(d1, d1 - d3)
    t_ac = _safe_div(d2, d2 - d6)
    t_bc = _safe_div(d4 - d3, (d4 - d3) + (d5 - d6))

    denom_in = va + vb + vc
    v_in = _safe_div(vb, denom_in)
    w_in = _safe_div(vc, denom_in)

    def bary(u, v, w):
        return jnp.stack(jnp.broadcast_arrays(u, v, w), axis=-1)

    zero = jnp.zeros_like(d1)
    one = jnp.ones_like(d1)

    # Start from the lowest-priority region (interior), then override upward.
    out = bary(1.0 - v_in - w_in, v_in, w_in)
    out = jnp.where(on_bc[..., None], bary(zero, 1.0 - t_bc, t_bc), out)
    out = jnp.where(on_ac[..., None], bary(1.0 - t_ac, zero, t_ac), out)
    out = jnp.where(on_ab[..., None], bary(1.0 - t_ab, t_ab, zero), out)
    out = jnp.where(in_c[..., None], bary(zero, zero, one), out)
    out = jnp.where(in_b[..., None], bary(zero, one, zero), out)
    out = jnp.where(in_a[..., None], bary(one, zero, zero), out)

    # Degenerate guards (`geo.rs:73-88`) — exact vertex equality, highest
    # priority. a==b → segment [a,c]; b==c or a==c → segment [a,b];
    # all equal → vertex a.
    eq_ab = jnp.all(a == b, axis=-1)
    eq_bc = jnp.all(b == c, axis=-1)
    eq_ac = jnp.all(a == c, axis=-1)

    s_ac = _segment_param(p, a, c)  # on [a, c]
    s_ab = _segment_param(p, a, b)  # on [a, b]

    out = jnp.where(
        (eq_bc | eq_ac)[..., None], bary(1.0 - s_ab, s_ab, zero), out
    )
    out = jnp.where(eq_ab[..., None], bary(1.0 - s_ac, zero, s_ac), out)
    out = jnp.where(
        (eq_ab & eq_bc & eq_ac)[..., None], bary(one, zero, zero), out
    )
    return out


def _segment_param(p, a, b):
    """Clamped projection parameter of p onto segment [a,b] (`geo.rs:141-151`)."""
    ab = b - a
    m = _dot(ab, ab)
    s = _safe_div(_dot(ab, p - a), m)
    return jnp.clip(s, 0.0, 1.0)


def closest_point_on_triangle(p, a, b, c):
    """Closest point of triangle abc to p (`geo.rs:70-138`)."""
    bc = closest_point_barycentric(p, a, b, c)
    return (
        bc[..., 0:1] * a + bc[..., 1:2] * b + bc[..., 2:3] * c
    )


def point_triangle_distance2(p, a, b, c):
    """Squared unsigned point→triangle distance (`geo.rs:33-37`)."""
    q = closest_point_on_triangle(p, a, b, c)
    d = p - q
    return _dot(d, d)


def point_triangle_distance(p, a, b, c):
    """Unsigned point→triangle distance (`geo.rs:26-30`)."""
    return jnp.sqrt(point_triangle_distance2(p, a, b, c))


def point_triangle_sign(p, q, a, b, c):
    """+1 if p is on the outer (normal) side of the triangle, else -1.

    Mirrors `geo.rs:51-55`: ``direction·normal > 0`` ⇒ positive, else negative
    (a zero dot product is *negative*).
    """
    n = triangle_normal(a, b, c)
    d = _dot(p - q, n)
    return jnp.where(d > 0.0, 1.0, -1.0)


def point_triangle_signed_distance(p, a, b, c):
    """Normal-signed point→triangle distance (`geo.rs:43-56`)."""
    bc = closest_point_barycentric(p, a, b, c)
    q = bc[..., 0:1] * a + bc[..., 1:2] * b + bc[..., 2:3] * c
    d = p - q
    dist = jnp.sqrt(_dot(d, d))
    return dist * point_triangle_sign(p, q, a, b, c)


# --------------------------------------------------------------------- rays
def ray_triangle_aligned(origin, a, b, c, axis: int):
    """Axis-aligned ray/triangle test (`geo.rs:165-216`).

    The ray points along +``axis`` (0=X, 1=Y, 2=Z). Returns ``(hit, t)`` where
    ``hit`` is a bool mask and ``t`` the (positive) hit parameter, valid only
    where ``hit``. All inputs broadcast; shapes (...,).

    Axis rotation: for alignment k the reference reads components
    ``x←k, y←(k+1)%3, z←(k+2)%3`` (`geo.rs:181-195`).
    """
    hit2d, t = ray_triangle_aligned_2d(origin, a, b, c, axis)
    return hit2d & (t > 0.0), t


def ray_triangle_aligned_2d(origin, a, b, c, axis: int):
    """The 2-D part of :func:`ray_triangle_aligned`: returns ``(inside, t)``
    where ``inside`` is the projected point-in-triangle test (strict same-sign
    edge weights) and ``t`` the *unclamped* line parameter. ``t > 0`` must be
    applied by the caller — the grid raycast kernel wants the raw ``t`` so it
    can count cells along the line (`generate/grid.rs:601-618`).
    """
    ix = axis
    iy = (axis + 1) % 3
    iz = (axis + 2) % 3

    e01 = b - a
    e12 = c - b
    e20 = a - c

    p0 = origin - a
    p1 = origin - b
    p2 = origin - c

    w0 = p1[..., iz] * e12[..., iy] - p1[..., iy] * e12[..., iz]
    w1 = p2[..., iz] * e20[..., iy] - p2[..., iy] * e20[..., iz]
    w2 = p0[..., iz] * e01[..., iy] - p0[..., iy] * e01[..., iz]

    inside = ((w0 < 0.0) & (w1 < 0.0) & (w2 < 0.0)) | (
        (w0 > 0.0) & (w1 > 0.0) & (w2 > 0.0)
    )
    wsum = w0 + w1 + w2
    t = -_safe_div(
        w0 * p0[..., ix] + w2 * p2[..., ix] + w1 * p1[..., ix], wsum
    )
    return inside, t
