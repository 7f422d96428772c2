"""The dense engine: one route per platform for every all-pairs pass.

Every path that evaluates all (query, triangle) pairs — ``generate_sdf``'s
dense strategies, the dense grid, CULLED's fix-ups and its route to brute
force, the sharded forwards — chooses its engine here and nowhere else:

- ``gpu``: the fused Triton kernel (:mod:`.kernels.pallas_sdf`), which
  beat the XLA engine on the H100 at the benchmark shapes (PERF.md);
- ``cpu``: the fused XLA engine (:mod:`.brute`), the platform the tests use
  and the reference the kernel is tested against.

Any other platform raises: there is no silent fallback.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..types import SignMethod, Strategy
from . import brute


def dense_strategy() -> Strategy:
    """The dense engine for the default backend (see module docstring)."""
    platform = jax.default_backend()
    if platform == "gpu":
        return Strategy.PALLAS
    if platform == "cpu":
        return Strategy.XLA
    raise RuntimeError(
        f"no dense engine for platform {platform!r}: mesh_to_sdf_tpu runs on "
        "'gpu' (Triton kernel) or 'cpu' (XLA engine)"
    )


def require_kernel() -> None:
    """Raise for an explicit ``Strategy.PALLAS`` where the kernel does not
    run (it is compiled for the GPU only; tests reach it in interpret mode
    through :mod:`.kernels.pallas_sdf` directly)."""
    if dense_strategy() != Strategy.PALLAS:
        raise ValueError(
            "Strategy.PALLAS runs the Triton kernel, which needs a GPU; on "
            f"{jax.default_backend()!r} use Strategy.XLA or Strategy.AUTO"
        )


def _valid_mask(T, valid, n_valid):
    if valid is not None:
        return valid
    return jnp.arange(T) < (T if n_valid is None else n_valid)


def signed_distance(queries, ta, tb, tc, valid=None, *, sign_method,
                    raycast_axes: int = 3, n_valid=None):
    """(Q,) signed distances of ``queries`` against every triangle.

    ``ta/tb/tc`` may carry zero padding rows after the first ``n_valid``
    (static int; default all) or be masked by ``valid``. RAYCAST with
    ``raycast_axes=0`` returns unsigned distances. Traceable: callers may
    run it inside ``jit``.
    """
    Q = queries.shape[0]
    T = ta.shape[0]
    n = T if n_valid is None else int(n_valid)
    if dense_strategy() == Strategy.PALLAS:
        from .kernels import pallas_sdf

        ra, rb, rc = ta[:n], tb[:n], tc[:n]
        if sign_method == SignMethod.NORMAL:
            return pallas_sdf.sdf_normal_pallas(queries, ra, rb, rc)
        return pallas_sdf.sdf_raycast_pallas(
            queries, ra, rb, rc, raycast_axes=raycast_axes
        )
    ta, tb, tc, valid, block = brute.pad_tri_blocks(
        ta, tb, tc, _valid_mask(T, valid, n_valid), brute.DEFAULT_TRI_BLOCK
    )
    chunk = min(brute.DEFAULT_QUERY_CHUNK, max(Q, 1))
    return brute.sdf_brute(
        brute.pad_to_multiple(queries, chunk), ta, tb, tc, valid,
        sign_method=sign_method,
        raycast_axes=raycast_axes if sign_method == SignMethod.RAYCAST else 0,
        tri_block=block,
        query_chunk=chunk,
    )[:Q]


def crossing_counts(queries, ta, tb, tc, valid=None, *, raycast_axes: int,
                    n_valid=None):
    """(Q, raycast_axes) int32 +axis ray crossing counts (stop-grad sign
    input for sharded votes and near-surface sign fallbacks)."""
    T = ta.shape[0]
    n = T if n_valid is None else int(n_valid)
    if dense_strategy() == Strategy.PALLAS:
        from .kernels import pallas_sdf

        return pallas_sdf.sdf_raycast_parts_pallas(
            queries, ta[:n], tb[:n], tc[:n], raycast_axes=raycast_axes
        )[1]
    from .culling import _ray_parity_counts

    return _ray_parity_counts(
        queries, ta, tb, tc, _valid_mask(T, valid, n_valid), raycast_axes
    )
