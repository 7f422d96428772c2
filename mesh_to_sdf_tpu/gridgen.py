"""`generate_grid_sdf` — signed distance field on a regular grid.

Capability parity with the reference flagship (`mesh_to_sdf/src/generate/grid.rs:265-378`),
re-designed for arrays. The reference's three CPU phases map as:

=====================================  =========================================
reference (grid.rs)                    here
=====================================  =========================================
preheap: per-triangle AABB rasterize   (subsumed) dense/tiled min over triangle
  + RwLock min (`grid.rs:383-456`)       blocks — exact by construction
propagation: split-heap parallel BFS   (not replicated — a sparse-CPU
  (`grid.rs:495-558`)                    optimization; exactness comes from the
                                         full reduction; see SURVEY §7)
raycast sign: BVH rays + atomic        per-axis line-parity sweep
  prefix counters (`grid.rs:568-641`)    (:mod:`mesh_to_sdf_tpu.ops.raycast`)
=====================================  =========================================

The reference asserts its grid output equals brute-force `generate_sdf` at the
cell centers (`grid.rs:692-724`), which is exactly what this computes.
"""
from __future__ import annotations

from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from .grid import Grid
from .topology import Topology
from .types import AccelerationMethod, SignMethod, Strategy
import functools

from .ops import brute, dense, raycast
from .ops import raycast as raycast_mod
from .query import prepare_triangles, _resolve

#: AUTO-strategy cost model: dense-engine pair throughput, CPT fixed
#: overhead, CPT cell throughput, per backend. The "gpu" entry is
#: ``calibrate_auto(force=True)`` on an NVIDIA H100 (CHANGES.md); the "cpu"
#: entry is a coarse single-core XLA scale. Overridable by env
#: (M2S_AUTO_DENSE_PAIRS_PER_S / M2S_AUTO_CPT_OVERHEAD_S /
#: M2S_AUTO_CPT_CELLS_PER_S) or by a cached one-shot on-device calibration
#: (:func:`calibrate_auto`, opt-in via M2S_AUTO_CALIBRATE=1).
_AUTO_DEFAULTS = {
    "gpu": (1.1915277e10, 0.03942356, 1.5753921e7),
    "cpu": (2.0e8, 0.05, 5.0e6),
}

_AUTO_CAL_CACHE: dict = {}


def _auto_cal_path():
    import os

    root = os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache")
    return os.path.join(root, "mesh_to_sdf_tpu", "auto_cal.json")


def _device_key() -> str:
    try:
        d = jax.devices()[0]
        return f"{jax.default_backend()}:{getattr(d, 'device_kind', '?')}"
    except Exception:
        return jax.default_backend()


def calibrate_auto(force: bool = False):
    """One-shot on-device measurement of the AUTO cost-model constants.

    Times the dense engine (pairs/s) on a 48³×2048 synthetic workload and
    the CPT engine at two grid sizes (48³, 96³) to split fixed overhead from
    per-cell throughput. Results persist to ``~/.cache/mesh_to_sdf_tpu/``
    keyed by backend+device kind, so the cost is paid once per machine.
    Returns (dense_pairs_per_s, cpt_overhead_s, cpt_cells_per_s).
    """
    import json
    import os
    import time

    from .utils.meshgen import icosphere

    key = _device_key()
    path = _auto_cal_path()
    if not force:
        if key in _AUTO_CAL_CACHE:
            return _AUTO_CAL_CACHE[key]
        try:
            with open(path) as f:
                disk = json.load(f)
            if key in disk:
                _AUTO_CAL_CACHE[key] = tuple(disk[key])
                return _AUTO_CAL_CACHE[key]
        except (OSError, ValueError):
            pass

    v, f = icosphere(4)  # 5120 tris
    topo = Topology.triangle_list(f.reshape(-1))
    n_t = len(f)
    lo, hi = v.min(axis=0) - 0.3, v.max(axis=0) + 0.3
    dense_strategy = dense.dense_strategy()

    def timed(strategy, cells):
        g = Grid.from_bounding_box(lo, hi, [cells] * 3)
        def run():
            d = generate_grid_sdf(v, topo, g, SignMethod.RAYCAST,
                                  strategy=strategy)
            jax.block_until_ready(d)
        run()  # compile
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0

    t_dense = timed(dense_strategy, 48)
    dense_pairs = 48**3 * n_t / max(t_dense, 1e-4)
    t_cpt_a = timed(Strategy.CPT, 48)
    t_cpt_b = timed(Strategy.CPT, 96)
    cells_a, cells_b = 48**3, 96**3
    slope = max((t_cpt_b - t_cpt_a) / (cells_b - cells_a), 1e-12)
    cpt_cells = 1.0 / slope
    cpt_overhead = max(t_cpt_a - cells_a * slope, 0.0)

    out = (float(dense_pairs), float(cpt_overhead), float(cpt_cells))
    _AUTO_CAL_CACHE[key] = out
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        disk = {}
        if os.path.exists(path):
            with open(path) as fh:
                disk = json.load(fh)
        disk[key] = list(out)
        with open(path, "w") as fh:
            json.dump(disk, fh)
    except OSError:
        pass
    return out


def _auto_constants():
    """(dense_pairs_per_s, cpt_overhead_s, cpt_cells_per_s) for this
    backend: env override > cached calibration > per-backend defaults."""
    import os

    backend = jax.default_backend()
    if backend not in _AUTO_DEFAULTS:
        raise RuntimeError(f"no AUTO cost constants for platform {backend!r}")
    base = _AUTO_DEFAULTS[backend]
    if os.environ.get("M2S_AUTO_CALIBRATE") == "1":
        try:
            base = calibrate_auto()
        except Exception:
            pass
    else:
        cached = _AUTO_CAL_CACHE.get(_device_key())
        if cached is not None:
            base = cached
    env = os.environ
    return (
        float(env.get("M2S_AUTO_DENSE_PAIRS_PER_S", base[0])),
        float(env.get("M2S_AUTO_CPT_OVERHEAD_S", base[1])),
        float(env.get("M2S_AUTO_CPT_CELLS_PER_S", base[2])),
    )

#: Content-hashed cache of CPT host prep (subdivision + seed bins): repeated
#: calls on the same mesh/grid skip the host rasterization (~0.2-0.35 s at
#: 256³). Keyed by (vertex bytes, face bytes, grid, max_edge); tiny FIFO.
_CPT_PREP_CACHE: dict = {}
_CPT_PREP_CACHE_MAX = 4


def _cpt_prep(grid: Grid, ha, hb, hc):
    """(stacked device soup (3,T,3), device SeedBins) — cached by content."""
    import zlib

    from .ops import cpt as cpt_mod

    cs = float(np.max(np.abs(np.asarray(grid.cell_size))))
    max_edge = 8.0 * cs
    tris_np = np.ascontiguousarray(np.stack([ha, hb, hc], axis=1))  # (T,3,3)
    key = (
        zlib.adler32(tris_np.tobytes()),
        tris_np.shape[0],
        tuple(np.asarray(grid.first_cell, np.float32).tolist()),
        tuple(np.asarray(grid.cell_size, np.float32).tolist()),
        tuple(int(c) for c in grid.cell_count),
    )
    hit = _CPT_PREP_CACHE.get(key)
    if hit is not None:
        return hit
    edges = np.linalg.norm(tris_np - np.roll(tris_np, 1, axis=1), axis=2)
    if float(edges.max()) > max_edge:
        # Bound a giant triangle's rasterized seed volume (loose 8-cell cap;
        # surface-identical ⇒ distances/sign unchanged).
        ra, rb, rc = cpt_mod.subdivide_to_span(
            tris_np.reshape(-1, 3),
            np.arange(3 * len(ha), dtype=np.int64).reshape(-1, 3),
            max_edge=max_edge,
        )
    else:
        ra, rb, rc = tris_np[:, 0], tris_np[:, 1], tris_np[:, 2]
    bins = cpt_mod.build_seed_bins(grid, ra, rb, rc,
                                   pad=cpt_mod.seed_pad_for(grid))
    # Cache DEVICE arrays: the big cell_row map uploads once per mesh/grid.
    out = (
        jnp.asarray(np.stack([ra, rb, rc])),
        cpt_mod.SeedBins(
            jnp.asarray(bins.entry_tri),
            jnp.asarray(bins.rows_cell),
            jnp.asarray(bins.cell_row),
            bins.n_shift_rounds,
        ),
    )
    if len(_CPT_PREP_CACHE) >= _CPT_PREP_CACHE_MAX:
        _CPT_PREP_CACHE.pop(next(iter(_CPT_PREP_CACHE)))
    _CPT_PREP_CACHE[key] = out
    return out


@functools.partial(
    jax.jit,
    static_argnames=("raycast", "flat", "raycast_axes", "seed_rounds",
                     "sweep_rounds"),
)
def _cpt_grid_signed(grid, tris, tris_orig, seed_entry, seed_rows,
                     seed_cellrow, raycast: bool, flat: bool,
                     raycast_axes: int = 3, seed_rounds: int = 0,
                     sweep_rounds: int = 1):
    """Fused CPT distance + sign for one grid (single dispatch).

    tris: (3, T, 3) stacked triangles (subdivided only to bound the seed
    rasterization volume); seed_entry/seed_rows/seed_rounds: host-binned
    seed gather lists (cpt.build_seed_bins — exact AABB±1 coverage);
    tris_orig: (3, T0, 3) original triangles — raycast parity is
    subdivision-invariant, so the sign pass uses the smaller soup.
    """
    from .ops import cpt as cpt_mod

    ra, rb, rc = tris[0], tris[1], tris[2]
    seed = cpt_mod.seed_from_bins(
        grid, ra, rb, rc,
        cpt_mod.SeedBins(seed_entry, seed_rows, seed_cellrow, seed_rounds),
    )
    dist3, idx3 = cpt_mod.closest_point_grid(
        grid, ra, rb, rc, seed=seed, rounds=sweep_rounds
    )
    if not raycast:
        # Normal sign from the nearest triangle — the reference Rtree
        # backend's semantics (`rtree.rs:96-126`, ~1% of near-edge cells may
        # differ from the champion reduction, as its own tests allow).
        dist3 = cpt_mod.normal_sign_from_idx(grid, ra, rb, rc, dist3, idx3)
    else:
        oa, ob, oc = tris_orig[0], tris_orig[1], tris_orig[2]
        valid = jnp.ones((oa.shape[0],), bool)
        inside = raycast_mod.grid_inside_mask(
            grid, oa, ob, oc, valid, tri_block=256, axes=raycast_axes
        )
        dist3 = jnp.where(inside, -dist3, dist3)
    return dist3.reshape(-1) if flat else dist3


def _count_triangles(vertices, topology) -> int:
    from .topology import as_points, expand_triangles, Topology as _T

    topo = topology if topology is not None else _T.triangle_list(None)
    if topo.indices is not None:
        n = topo.indices.size
    else:
        n = len(as_points(vertices))
    return n // 3 if topo.kind == "list" else max(n - 2, 0)


def generate_grid_sdf(
    vertices,
    topology: Optional[Topology],
    grid: Grid,
    sign_method: SignMethod = SignMethod.RAYCAST,
    *,
    strategy: Union[Strategy, AccelerationMethod, None] = None,
    raycast_axes: int = 3,
    tri_block: int = brute.DEFAULT_TRI_BLOCK,
    query_chunk: int = brute.DEFAULT_QUERY_CHUNK,
    flat: bool = True,
    exact: bool = False,
) -> jax.Array:
    """SDF at every cell center of ``grid``.

    Returns float32 distances, flattened in the reference's x-major/z-fastest
    layout (`grid.rs:122-124`) when ``flat=True``, else shaped (nx, ny, nz).
    Positive outside, negative inside (`grid.rs:199-232`).

    ``raycast_axes``: 3 (default) = best-of-3 axis parity voting
    (`grid.rs:622-639`); 1 = single +X parity (the reference ``None``
    backend's semantics, `default.rs:34-37` — cheaper, less robust near
    shared edges).

    ``exact=True`` guarantees the reference's grid == brute-at-centers bar
    (`grid.rs:692-724`) regardless of grid size: AUTO's approximate CPT
    route is replaced by the exact tile-culled engine (the XLA / PALLAS /
    CULLED strategies are exact either way; CPT trades ≤2% far-field error
    for O(cells) cost).
    """
    strategy, sign = _resolve(
        strategy if strategy is not None else Strategy.AUTO, sign_method
    )
    if exact and strategy in (Strategy.AUTO, Strategy.CPT):
        strategy = Strategy.CULLED
    if strategy == Strategy.AUTO:
        # Cost model: the dense engine is O(cells·tris); CPT is O(cells)
        # sweeps plus a fixed overhead. Below the crossover the dense sweep
        # wins outright. Constants are per platform (_AUTO_DEFAULTS).
        n_cells = grid.total_cell_count
        n_t = _count_triangles(vertices, topology)
        dense_pairs, cpt_overhead, cpt_cells = _auto_constants()
        dense_cost = n_cells * max(n_t, 1) / dense_pairs
        cpt_cost = cpt_overhead + n_cells / cpt_cells
        strategy = (Strategy.CPT if cpt_cost < dense_cost
                    else dense.dense_strategy())
    if strategy == Strategy.PALLAS:
        dense.require_kernel()

    if strategy == Strategy.CPT:
        # Host-side triangle prep only — no intermediate device round-trips.
        from .topology import as_points, gather_triangle_vertices
        from .topology import Topology as _T
        from .ops import cpt as cpt_mod

        v_host = as_points(vertices)
        topo = topology if topology is not None else _T.triangle_list(None)
        ha, hb, hc = gather_triangle_vertices(v_host, topo)
        if len(ha) > 0:
            # Seeds come from host-binned AABB±1 rasterization (exact
            # coverage, no fixed window), cached by mesh/grid content.
            tris_dev, bins = _cpt_prep(grid, ha, hb, hc)
            # One upload + one jitted program for the whole device pipeline.
            return _cpt_grid_signed(
                grid,
                tris_dev,
                jnp.asarray(np.stack([ha, hb, hc])),
                bins.entry_tri,
                bins.rows_cell,
                bins.cell_row,
                raycast=sign == SignMethod.RAYCAST,
                flat=flat,
                raycast_axes=raycast_axes,
                seed_rounds=bins.n_shift_rounds,
                # Coarse grids stress far-field propagation (thin features
                # vs cell size — 2.6% observed on knight@24³, breaching the
                # ≤2% contract); a second sweep round costs O(cells), which
                # is negligible exactly where it is needed. Fine grids keep
                # one round (the sweep phase dominates 256³ wall time).
                sweep_rounds=2 if max(grid.cell_count) <= 128 else 1,
            )

    ta, tb, tc, valid, n_tris = prepare_triangles(vertices, topology, tri_block)

    if strategy == Strategy.PALLAS and n_tris > 0:
        from .ops.kernels import pallas_sdf

        centers = grid.all_cell_centers().reshape(-1, 3)
        ra, rb, rc = ta[:n_tris], tb[:n_tris], tc[:n_tris]
        if sign == SignMethod.NORMAL:
            dist = pallas_sdf.sdf_normal_pallas(centers, ra, rb, rc)
        else:
            # Unsigned distance only; sign comes from the line parity below.
            dist = pallas_sdf.sdf_raycast_pallas(
                centers, ra, rb, rc, raycast_axes=0
            )
        dist3 = dist.reshape(grid.cell_count)
    elif strategy == Strategy.CULLED and n_tris > 0:
        from .ops import culling

        dist3 = culling.grid_distance_culled(grid, ta, tb, tc, valid, sign=sign)
    else:
        centers = grid.all_cell_centers().reshape(-1, 3)
        N = centers.shape[0]
        chunk = min(query_chunk, N)
        pad = (-N) % chunk
        if pad:
            centers = jnp.pad(centers, ((0, pad), (0, 0)))
        dist = brute.sdf_brute(
            centers, ta, tb, tc, valid,
            sign_method=sign,
            # Grid raycast sign comes from the line-parity kernel below, not
            # from per-cell rays — ask the brute pass for unsigned min only.
            raycast_axes=0,
            tri_block=tri_block,
            query_chunk=chunk,
        )[:N]
        dist3 = dist.reshape(grid.cell_count)

    if sign == SignMethod.RAYCAST:
        inside = raycast.grid_inside_mask(
            grid, ta, tb, tc, valid, tri_block=min(tri_block, 256),
            axes=raycast_axes,
        )
        dist3 = jnp.where(inside, -dist3, dist3)

    return dist3.reshape(-1) if flat else dist3
