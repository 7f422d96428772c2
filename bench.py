#!/usr/bin/env python
"""Headline benchmark: grid cells/s/chip, raycast sign (BASELINE.json north star).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.

Primary workload mirrors the reference's big criterion config scaled to the
north star: a 20 480-triangle watertight mesh, 256^3 grid (--quick: 128^3),
`generate_grid_sdf` with SignMethod::Raycast
(reference: mesh_to_sdf/benches/generate_grid_sdf.rs:94-122 at 100^3).

"extra" carries the reference's own criterion workloads on its real assets
(mesh_to_sdf/benches/generate_sdf.rs:12-58,185-236 — knight.glb query grids,
FlightHelmet.glb big_big; generate_grid_sdf.rs:68-96 — knight 100^3 grid)
plus the 1M-query fused-kernel rate. Each extra is individually guarded: a
failure is recorded as a string, never kills the primary metric.

`vs_baseline`: the reference publishes no absolute numbers (BASELINE.md);
the constant below estimates the Rust crate's multithreaded propagation
pipeline on a high-end desktop CPU (~16 threads) at ~2e6 cells/s.
vs_baseline = measured / BASELINE_CELLS_PER_S.
"""
import json
import os
import sys
import time

import numpy as np

BASELINE_CELLS_PER_S = 2.0e6
#: Estimated single-core Rust RtreeBvh query rate at ~100k tris (BASELINE.md
#: relative claims); the >10x north star divides by this.
BASELINE_QUERIES_PER_S = 1.0e5

ASSETS = "/root/reference/mesh_to_sdf/assets"


def _timeit(fn, repeats):
    """Sampled timing (n/median/spread, not min-of-2).

    Returns the MEDIAN wall time; the per-sample spread is recorded in
    module-level ``TIMING_STATS`` (keyed by the current workload, see
    ``_stats_scope``) and surfaced in the bench JSON so a single jittery
    sample cannot make the headline number.
    """
    fn()  # compile + warmup
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    ts = sorted(times)
    med = ts[len(ts) // 2] if len(ts) % 2 else 0.5 * (
        ts[len(ts) // 2 - 1] + ts[len(ts) // 2]
    )
    if _STATS_KEY[0] is not None:
        TIMING_STATS[_STATS_KEY[0]] = {
            "n": len(ts),
            "median_s": round(med, 4),
            "min_s": round(ts[0], 4),
            "max_s": round(ts[-1], 4),
        }
    return med


#: Per-workload timing spread, keyed by workload name (filled by _timeit).
TIMING_STATS = {}
_STATS_KEY = [None]


class _stats_scope:
    """Route _timeit spread recording to TIMING_STATS[name] while active."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _STATS_KEY[0] = self.name

    def __exit__(self, *exc):
        _STATS_KEY[0] = None


def _query_grid(verts, cell_radius, scale=1.0):
    """The reference bench's query grid: lattice points stepped by
    ``cell_radius`` over the mesh bbox (`benches/generate_sdf.rs:34-49` —
    the loop literally increments coordinates by cell_radius)."""
    from mesh_to_sdf_tpu import Grid

    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    cs = cell_radius * scale
    counts = np.maximum(np.ceil((hi - lo) / cs).astype(int), 1)
    g = Grid.from_bounding_box(lo, hi, [int(c) for c in counts])
    return np.asarray(g.all_cell_centers()).reshape(-1, 3)


def main():
    import jax

    from mesh_to_sdf_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()

    from mesh_to_sdf_tpu import (
        Grid, SignMethod, Strategy, Topology, generate_grid_sdf, generate_sdf,
    )
    from mesh_to_sdf_tpu.utils.meshgen import icosphere

    quick = "--quick" in sys.argv
    n = 128 if quick else 256

    verts, faces = icosphere(subdiv=5)  # 20480 triangles
    topo = Topology.triangle_list(faces.reshape(-1))
    grid = Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, [n, n, n])

    def run():
        return jax.block_until_ready(
            generate_grid_sdf(verts, topo, grid, SignMethod.RAYCAST)
        )

    out = run()  # compile + warmup
    # Sanity: watertight unit sphere in a 2.2-box → inside fraction ≈ 0.393.
    inside = float((np.asarray(out) < 0).mean())
    assert 0.37 < inside < 0.42, f"bad sign fraction {inside}"

    with _stats_scope("primary_grid"):
        med = _timeit(run, 3 if quick else 5)
    cells_per_s = n**3 / med

    extra = {}

    # Roofline accounting: count the work actually scheduled — seed pairs
    # from the cached gather lists, sweep evals/cell, parity pairs — and
    # judge the wall time against the device's peaks (utils/roofline.py).
    kind = jax.devices()[0].device_kind
    try:
        from mesh_to_sdf_tpu import gridgen
        from mesh_to_sdf_tpu.utils import roofline

        _, seed_bins = list(gridgen._CPT_PREP_CACHE.values())[-1]
        model = roofline.grid_total_flops((n, n, n), len(faces), seed_bins)
        extra["roofline_primary_grid"] = roofline.account(
            med, **model, device_kind=kind)
    except Exception as e:  # noqa: BLE001
        extra["roofline_primary_grid"] = f"error: {type(e).__name__}: {e}"

    def guarded(name, fn):
        try:
            with _stats_scope(name):
                extra[name] = fn()
        except Exception as e:  # noqa: BLE001 — record, never kill the bench
            extra[name] = f"error: {type(e).__name__}: {e}"

    def load(asset):
        from mesh_to_sdf_tpu.io import gltf

        scene = gltf.load_scene(f"{ASSETS}/{asset}.glb")
        return scene.merge()

    # 1M scattered queries × 20k tris through the dense kernel.
    def q_1m():
        rng = np.random.default_rng(0)
        q = rng.uniform(-1.3, 1.3, (1_000_000, 3)).astype(np.float32)

        def f():
            jax.block_until_ready(generate_sdf(
                verts, topo, q, Strategy.PALLAS,
                sign_method=SignMethod.RAYCAST))

        t = _timeit(f, 3)
        from mesh_to_sdf_tpu.utils import roofline

        m = roofline.pairs_query_flops(len(q), len(faces), raycast_axes=3,
                                       chunk=1024, block=1024)
        return {"queries_per_s": round(len(q) / t, 1),
                "roofline": roofline.account(t, m["flops"], m["hbm_bytes"],
                                             device_kind=kind)}

    # Out-of-core streamed pipeline at 512^3 (BASELINE config-5 scale on
    # ONE chip): x-slabs through the binned-seed + XLA-sweep engine
    # (gridgen_streamed.py). Done-bar: >= the single-chip 256^3 cells/s
    # rate. Needs no reference assets.
    def streamed_512():
        from mesh_to_sdf_tpu.gridgen_streamed import (
            generate_grid_sdf_streamed,
        )

        g512 = Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, [512] * 3)

        def f():
            out = generate_grid_sdf_streamed(
                verts, faces, g512, SignMethod.RAYCAST
            )
            return out

        out = f()  # compile + warm (one program serves every slab)
        inside = float((out < 0).mean())
        assert 0.37 < inside < 0.42, f"bad sign fraction {inside}"
        t0 = time.perf_counter()
        f()
        t = time.perf_counter() - t0
        return {"cells_per_s": round(512**3 / t, 1), "seconds": round(t, 2)}

    # MEASURED single-core baseline (native/baseline_rtree_bvh.cpp — the
    # reference's RtreeBvh backend + 3-phase grid generator in C++, one
    # core): turns every "vs reference" multiplier into a measurement
    # Checksums are cross-validated against our exact engines in
    # tests/test_native_baseline.py. Only the knight/helmet sub-workloads
    # need the reference assets; the primary-workload baseline always
    # runs.
    def measured_baseline():
        from mesh_to_sdf_tpu.utils import baseline as bl

        if not bl.available(build=True):
            return "binary unavailable"
        out = {}

        # Primary workload mesh at the bench resolution.
        p_tri = (verts[faces[:, 0]], verts[faces[:, 1]],
                 verts[faces[:, 2]])
        r = bl.run_grid(*p_tri, grid)
        out[f"grid_{n}^3_cells_per_s_1core"] = r["cells_per_s"]

        if os.path.isdir(ASSETS):
            hv, hf = load("FlightHelmet")
            h_tri = (hv[hf[:, 0]], hv[hf[:, 1]], hv[hf[:, 2]])

            # FlightHelmet query grid (the crate's big_big criterion).
            qg = _query_grid(hv, 0.01)
            r = bl.run_query(*h_tri, qg)
            out["helmet_query_grid_qps_1core"] = r["queries_per_s"]

            # FlightHelmet scattered (subsampled ×10, same distribution).
            rng = np.random.default_rng(1)
            lo, hi = hv.min(0), hv.max(0)
            c, half = (lo + hi) / 2, (hi - lo) * 0.65
            qs = (c + rng.uniform(-1, 1, (100_000, 3)) * half).astype(
                np.float32
            )
            r = bl.run_query(*h_tri, qs)
            out["helmet_scattered_qps_1core"] = r["queries_per_s"]

            kv, kf = load("knight")
            k_tri = (kv[kf[:, 0]], kv[kf[:, 1]], kv[kf[:, 2]])
            ext = (kv.max(0) - kv.min(0)).astype(np.float64)
            cr = float((ext.prod() / 32_768) ** (1.0 / 3.0)) / 2.0
            r = bl.run_query(*k_tri, _query_grid(kv, cr))
            out["knight_query_grid_qps_1core"] = r["queries_per_s"]

            lo, hi = kv.min(0), kv.max(0)
            pad = 0.05 * (hi - lo)
            g100 = Grid.from_bounding_box(lo - pad, hi + pad, [100] * 3)
            r = bl.run_grid(*k_tri, g100)
            out["knight_grid_100^3_cells_per_s_1core"] = r["cells_per_s"]
        return out

    # BASELINE config-5 scale on ONE chip: a ~1.3M-triangle
    # procedural mesh through CULLED scattered queries — 13.8× the
    # reference's largest criterion mesh (94,722 tris,
    # `benches/generate_sdf.rs:216-236`). Reports the certificate flag
    # rate (exactness telemetry) and the measured 1-core multiplier on the
    # same workload (100k-query subsample through the C++ baseline).
    def tris_1m_scattered():
        from mesh_to_sdf_tpu.ops import culling
        from mesh_to_sdf_tpu.utils import baseline as bl

        mv, mf = icosphere(subdiv=8)  # 1,310,720 triangles
        mtopo = Topology.triangle_list(mf.reshape(-1))
        rng = np.random.default_rng(2)
        q = rng.uniform(-1.3, 1.3, (1_000_000, 3)).astype(np.float32)

        def f():
            jax.block_until_ready(generate_sdf(
                mv, mtopo, q, Strategy.CULLED,
                sign_method=SignMethod.RAYCAST))

        t = _timeit(f, 3)
        out = {
            "tris": int(len(mf)),
            "queries_per_s": round(len(q) / t, 1),
            "culled_stats": dict(culling.LAST_CULLED_STATS),
        }
        if bl.available(build=True):
            tri = (mv[mf[:, 0]], mv[mf[:, 1]], mv[mf[:, 2]])
            r = bl.run_query(*tri, q[:100_000])
            out["qps_1core_measured"] = r["queries_per_s"]
            out["vs_rtree_bvh_1core_measured"] = round(
                out["queries_per_s"] / r["queries_per_s"], 2
            )
        return out

    if not quick:
        guarded("queries_per_s_1M_20k_pallas", q_1m)
        guarded("sdf_1.3M_tris_1M_scattered_culled", tris_1m_scattered)
        guarded("streamed_grid_512^3_raycast", streamed_512)
        guarded("baseline_1core_measured", measured_baseline)

    if os.path.isdir(ASSETS) and not quick:
        # Reference criterion: knight.glb, query grid at cell_radius 0.01
        # (`generate_sdf.rs:12-58`) — ~30k queries × 11,184 tris.
        def knight_queries():
            kv, kf = load("knight")
            ktopo = Topology.triangle_list(kf.reshape(-1))
            # criterion's cell_radius=0.01 is in easy-gltf's untransformed
            # primitive units and yields ~34k query points; our loader
            # applies node transforms, so reproduce the COUNT: pick the
            # cell radius that tiles the merged bbox into ~32k cells.
            ext = (kv.max(0) - kv.min(0)).astype(np.float64)
            cell_radius = float((ext.prod() / 32_768) ** (1.0 / 3.0)) / 2.0
            q = _query_grid(kv, cell_radius)
            def f():
                jax.block_until_ready(generate_sdf(
                    kv, ktopo, q, Strategy.PALLAS,
                    sign_method=SignMethod.RAYCAST))
            t = _timeit(f, 3)
            from mesh_to_sdf_tpu.utils import roofline

            m = roofline.pairs_query_flops(len(q), len(kf), raycast_axes=3,
                                           chunk=1024, block=1024)
            return {"queries": int(len(q)),
                    "queries_per_s": round(len(q) / t, 1),
                    "roofline": roofline.account(t, m["flops"],
                                                 m["hbm_bytes"],
                                                 device_kind=kind)}

        guarded("knight_query_grid_r0.01_pallas", knight_queries)

        # Reference criterion big_big: FlightHelmet merged (94,722 tris),
        # query grid at cell_radius 0.01 over the bbox — the crate's literal
        # workload (`generate_sdf.rs:216-236`). CULLED ≙ Rtree/RtreeBvh.
        def helmet_query_grid():
            hv, hf = load("FlightHelmet")
            htopo = Topology.triangle_list(hf.reshape(-1))
            q = _query_grid(hv, 0.01)
            def f():
                d = generate_sdf(hv, htopo, q, Strategy.CULLED,
                                 sign_method=SignMethod.RAYCAST)
                jax.block_until_ready(d)
            t = _timeit(f, 3)
            qps = len(q) / t
            return {
                "tris": int(len(hf)),
                "queries": int(len(q)),
                "queries_per_s": round(qps, 1),
                "vs_rtree_bvh_1core": round(qps / BASELINE_QUERIES_PER_S, 2),
                # CULLED does data-dependent work; report the dense-pair
                # rate an uncropped sweep would need to match this time.
                "effective_dense_pairs_per_s": round(
                    len(q) * len(hf) / t, 1),
            }

        guarded("flighthelmet_query_grid_culled", helmet_query_grid)

        # Worst case for tile culling: 1M uniformly scattered queries.
        def helmet_scattered():
            hv, hf = load("FlightHelmet")
            htopo = Topology.triangle_list(hf.reshape(-1))
            rng = np.random.default_rng(1)
            lo, hi = hv.min(0), hv.max(0)
            c, half = (lo + hi) / 2, (hi - lo) * 0.65
            q = (c + rng.uniform(-1, 1, (1_000_000, 3)) * half).astype(
                np.float32
            )
            def f():
                d = generate_sdf(hv, htopo, q, Strategy.CULLED,
                                 sign_method=SignMethod.RAYCAST)
                jax.block_until_ready(d)
            t = _timeit(f, 3)
            qps = len(q) / t
            return {
                "queries_per_s": round(qps, 1),
                "vs_rtree_bvh_1core": round(qps / BASELINE_QUERIES_PER_S, 2),
                "effective_dense_pairs_per_s": round(
                    len(q) * len(hf) / t, 1),
            }

        guarded("flighthelmet_1M_scattered_culled", helmet_scattered)

        # Reference criterion: knight grid at 100^3 raycast
        # (`generate_grid_sdf.rs:68-96`).
        def knight_grid():
            kv, kf = load("knight")
            ktopo = Topology.triangle_list(kf.reshape(-1))
            lo, hi = kv.min(0), kv.max(0)
            pad = 0.05 * (hi - lo)
            g = Grid.from_bounding_box(lo - pad, hi + pad, [100, 100, 100])
            def f():
                d = generate_grid_sdf(kv, ktopo, g, SignMethod.RAYCAST)
                jax.block_until_ready(d)
            t = _timeit(f, 3)
            return {"cells_per_s": round(100**3 / t, 1)}

        guarded("knight_grid_100^3_raycast", knight_grid)

    if not quick:
        # Re-state the headline multipliers against the MEASURED 1-core
        # baseline where both sides ran the same workload.
        bl_m = extra.get("baseline_1core_measured")
        if isinstance(bl_m, dict):
            hq = extra.get("flighthelmet_query_grid_culled")
            if isinstance(hq, dict):
                hq["vs_rtree_bvh_1core_measured"] = round(
                    hq["queries_per_s"] / bl_m["helmet_query_grid_qps_1core"],
                    2,
                )
            hs = extra.get("flighthelmet_1M_scattered_culled")
            if isinstance(hs, dict):
                hs["vs_rtree_bvh_1core_measured"] = round(
                    hs["queries_per_s"] / bl_m["helmet_scattered_qps_1core"],
                    2,
                )
            kq = extra.get("knight_query_grid_r0.01_pallas")
            if isinstance(kq, dict):
                kq["vs_rtree_bvh_1core_measured"] = round(
                    kq["queries_per_s"] / bl_m["knight_query_grid_qps_1core"],
                    2,
                )
            kg = extra.get("knight_grid_100^3_raycast")
            if isinstance(kg, dict):
                kg["vs_1core_measured"] = round(
                    kg["cells_per_s"]
                    / bl_m["knight_grid_100^3_cells_per_s_1core"],
                    2,
                )
            extra["vs_1core_grid_measured"] = round(
                cells_per_s / bl_m[f"grid_{n}^3_cells_per_s_1core"], 2
            )

    if TIMING_STATS:
        extra["timing_stats"] = TIMING_STATS

    print(
        json.dumps(
            {
                "metric": f"grid_cells_per_s_{n}^3_raycast",
                "value": round(cells_per_s, 1),
                "unit": "cells/s",
                "vs_baseline": round(cells_per_s / BASELINE_CELLS_PER_S, 3),
                "extra": extra,
            }
        )
    )


if __name__ == "__main__":
    main()
