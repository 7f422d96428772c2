"""Order-independent replacement for the reference's ``compare_distances`` fold.

The reference reduces signed distances sequentially with a fuzzy comparator
(`mesh_to_sdf/src/lib.rs:242-259`): if two distances have (approximately, 2
ulps / 1e-6) equal magnitude, the **positive** one wins (a point is inside only
if it is inside *all* nearest triangles); otherwise the smaller magnitude wins.

A sequential fuzzy fold is order-dependent and hostile to parallel reduction.
The array formulation keeps **two champions** — the smallest positive
magnitude and the smallest negative magnitude — both plain ``min`` reductions
(associative, shardable via ``psum``-min), and applies the fuzzy
prefer-positive rule once, between the two champions. This is exactly the
pairwise ``compare_distances`` decision applied to the only two candidates
that can win, and is *more* deterministic than the reference (whose own
split-heap parallelism already makes tie-breaking order-dependent).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..types import F32_MAX

#: ``float_cmp::approx_eq!`` parameters used by the reference (`lib.rs:248`).
ULPS = 2
EPSILON = 1e-6


def approx_eq_f32(a, b):
    """``float_cmp::approx_eq!(f32, a, b, ulps=2, epsilon=1e-6)`` for
    non-negative finite floats: true if |a-b| <= eps OR the values are within
    2 representable steps of each other."""
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    eps_ok = jnp.abs(a - b) <= EPSILON
    ai = a.view(jnp.int32)
    bi = b.view(jnp.int32)
    ulp_ok = jnp.abs(ai - bi) <= ULPS
    return eps_ok | ulp_ok


def signed_champions(signed_dist, axis=None, where=None):
    """Reduce signed distances to the two champions ``(min_pos, min_neg)``.

    ``min_pos`` is the smallest distance among non-negative entries,
    ``min_neg`` the smallest magnitude among negative entries. Missing side
    yields ``F32_MAX`` (the reference's fold init, `default.rs:45`).
    """
    signed_dist = jnp.asarray(signed_dist, jnp.float32)
    neg = jnp.signbit(signed_dist)
    pos_vals = jnp.where(neg, F32_MAX, signed_dist)
    neg_vals = jnp.where(neg, -signed_dist, F32_MAX)
    if where is not None:
        pos_vals = jnp.where(where, pos_vals, F32_MAX)
        neg_vals = jnp.where(where, neg_vals, F32_MAX)
    if axis is None:
        return pos_vals, neg_vals
    return jnp.min(pos_vals, axis=axis), jnp.min(neg_vals, axis=axis)


def combine_champions(min_pos, min_neg):
    """Final ``compare_distances`` decision between the two champions
    (`lib.rs:248-258`): approximately equal ⇒ positive wins; otherwise the
    smaller magnitude wins (with its sign)."""
    prefer_pos = approx_eq_f32(min_pos, min_neg) | (min_pos <= min_neg)
    return jnp.where(prefer_pos, min_pos, -min_neg)


def merge_champion_pairs(pos_a, neg_a, pos_b, neg_b):
    """Associative merge of two champion pairs (for tree/shard reductions)."""
    return jnp.minimum(pos_a, pos_b), jnp.minimum(neg_a, neg_b)


def compare_distances(a, b):
    """Pairwise reference `compare_distances` (`lib.rs:242-259`): returns the
    winner of the two signed distances — approximately equal magnitudes prefer
    the positive one, otherwise the smaller magnitude wins."""
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    eq = approx_eq_f32(jnp.abs(a), jnp.abs(b))
    pick_a = jnp.where(
        eq,
        a >= b,                      # equal magnitude: positive wins
        jnp.abs(a) < jnp.abs(b),     # else: smaller magnitude wins
    )
    return jnp.where(pick_a, a, b)
