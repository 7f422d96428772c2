#!/usr/bin/env python
"""Smoke run of mesh_to_sdf_tpu's main path on one NVIDIA GPU.

    python chip_smoke.py           # every one-card phase
    python chip_smoke.py --four    # only the four-card sharded phase

Each phase drives the public entry points at the sizes users run, compares
the result with a plain reference (the XLA engine, brute force, the
analytic sphere) and prints one JSON line with its cold (compile included)
and warm wall times, its errors and their tolerances. The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

printed only when every phase passed. The script exits non-zero, printing
no result, when JAX finds no GPU or any phase fails. It builds
``native/libm2s.so`` (``make -C native``) and fails if it does not load.
Everything runs in this one process: a second JAX process could not get the
card's memory.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Tolerances (each with its reason):
#: Distance agreement between two exact engines (Triton kernel vs XLA). Both
#: evaluate |ap − v·ab − w·ac|² in fp32; FMA contraction differs, and the
#: expanded form cancels near the surface, so |d| differs by up to ~1e-5
#: there (measured 1.3e-5 at 1M × 20,480 on the H100).
DIST_ATOL = 1e-4
DIST_RTOL = 1e-5
#: Raycast sign disagreement between exact engines: rays grazing a shared
#: edge or vertex, where reordered edge weights land on the other side of
#: the strict-sign test (measured 8 per 1M queries on the H100), and cells
#: within ~6e-6 of the surface whose distance rounds to 0 in one engine
#: (np.sign(0) == 0; 31 of 128³ cells on the H100).
RAY_SIGN_BUDGET = 1e-4
#: CPT contract (tests/test_cpt.py): never undershoots the exact distance
#: beyond float noise, ≤2% relative deviation in the far field.
CPT_UNDERSHOOT = 1e-4
CPT_REL = 0.02
#: NORMAL sign from the nearest triangle vs the champion reduction: the
#: reference's own Rtree test allows ~1% of cells (tests/test_cpt.py).
NORMAL_SIGN_BUDGET = 0.01
#: Inside fraction of the unit sphere in a 2.2-box: (4/3)π/2.2³ = 0.3934.
INSIDE_RANGE = (0.37, 0.42)


def emit(**kw):
    print(json.dumps(kw), flush=True)


def timed(fn):
    """(cold seconds, warm seconds, output): the second call is warm."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return cold, time.perf_counter() - t0, out


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def compare_exact(got, want, name, sign_budget=RAY_SIGN_BUDGET):
    """Two exact engines: distances within DIST_ATOL/RTOL, signs within
    the budget. Returns the error summary."""
    got, want = np.asarray(got), np.asarray(want)
    check(got.shape == want.shape, f"{name}: shape {got.shape} != {want.shape}")
    check(np.isfinite(got).all(), f"{name}: non-finite output")
    err = np.abs(np.abs(got) - np.abs(want))
    lim = DIST_ATOL + DIST_RTOL * np.abs(want)
    sign_frac = float(np.mean(np.sign(got) != np.sign(want)))
    out = {"max_abs_err": float(err.max()), "dist_atol": DIST_ATOL,
           "sign_mismatch_frac": sign_frac, "sign_budget": sign_budget}
    check((err <= lim).all(), f"{name}: distance error {out}")
    check(sign_frac <= sign_budget, f"{name}: sign mismatch {out}")
    return out


def cpt_contract(got, exact, name):
    """CPT vs the exact engine: never undershoots, ≤2% far field, same
    signs (raycast)."""
    got, exact = np.asarray(got), np.asarray(exact)
    under = float((np.abs(exact) - np.abs(got)).max())
    rel = float((np.abs(np.abs(got) - np.abs(exact))
                 / np.maximum(np.abs(exact), 1e-3)).max())
    sign_frac = float(np.mean(np.sign(got) != np.sign(exact)))
    out = {"max_undershoot": under, "undershoot_tol": CPT_UNDERSHOOT,
           "max_rel_err": rel, "rel_tol": CPT_REL,
           "sign_mismatch_frac": sign_frac}
    check(under <= CPT_UNDERSHOOT, f"{name}: undershoot {out}")
    check(rel <= CPT_REL, f"{name}: far-field error {out}")
    return out


def sphere(subdiv):
    from mesh_to_sdf_tpu import Topology
    from mesh_to_sdf_tpu.utils.meshgen import icosphere

    v, f = icosphere(subdiv)
    return v, f, Topology.triangle_list(f.reshape(-1))


def scattered(n, seed, half=1.5):
    rng = np.random.default_rng(seed)
    return rng.uniform(-half, half, (n, 3)).astype(np.float32)


def xla_exact(v, topo, q, sign=None):
    import mesh_to_sdf_tpu as m

    return np.asarray(m.generate_sdf(
        v, topo, q, m.Strategy.XLA, sign_method=sign or m.SignMethod.RAYCAST))


# ------------------------------------------------------------------ phases
def phase_grid():
    """generate_grid_sdf AUTO (→ CPT) at 256³ on 20,480 triangles, RAYCAST;
    exact=True at 128³."""
    import mesh_to_sdf_tpu as m

    v, f, topo = sphere(5)
    g = m.Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, [256] * 3)
    cold, warm, out = timed(
        lambda: m.generate_grid_sdf(v, topo, g, m.SignMethod.RAYCAST))
    sdf = np.asarray(out)
    centers = np.asarray(g.all_cell_centers()).reshape(-1, 3)
    inside = float((sdf < 0).mean())
    check(INSIDE_RANGE[0] < inside < INSIDE_RANGE[1], f"inside {inside}")
    # Analytic sphere: the inscribed icosphere sits ≤1.7e-4 inside the unit
    # sphere (face sagitta at subdiv 5); CPT adds ≤2% far-field error.
    ana = np.linalg.norm(centers, axis=1) - 1.0
    ana_err = np.abs(sdf - ana)
    check((ana_err <= 5e-4 + CPT_REL * np.abs(ana)).all(),
          f"analytic sphere error {ana_err.max()}")
    rng = np.random.default_rng(11)
    pick = rng.choice(len(centers), 200_000, replace=False)
    exact = xla_exact(v, topo, centers[pick])
    contract = cpt_contract(sdf[pick], exact, "grid 256^3")
    check(contract["sign_mismatch_frac"] <= RAY_SIGN_BUDGET,
          f"grid signs {contract}")

    g128 = m.Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, [128] * 3)
    cold_e, warm_e, ex = timed(lambda: m.generate_grid_sdf(
        v, topo, g128, m.SignMethod.RAYCAST, exact=True))
    ref = m.generate_grid_sdf(v, topo, g128, m.SignMethod.RAYCAST,
                              strategy=m.Strategy.XLA)
    exact_err = compare_exact(ex, ref, "exact grid 128^3")
    return {"cells": 256**3, "tris": len(f), "cold_s": cold, "warm_s": warm,
            "inside_frac": inside, "analytic_max_err": float(ana_err.max()),
            "cpt_contract_200k": contract,
            "exact_128": {"cold_s": cold_e, "warm_s": warm_e, **exact_err}}


def phase_dense():
    """generate_sdf, 1M scattered queries × 20,480 triangles: AUTO and the
    kernel vs the XLA engine."""
    import mesh_to_sdf_tpu as m

    v, f, topo = sphere(5)
    q = scattered(1_000_000, 0)
    t_x = time.perf_counter()
    ref = xla_exact(v, topo, q)
    t_x = time.perf_counter() - t_x
    res = {"queries": len(q), "tris": len(f), "xla_s": t_x}
    for strat in (m.Strategy.AUTO, m.Strategy.PALLAS):
        cold, warm, out = timed(lambda s=strat: m.generate_sdf(v, topo, q, s))
        res[strat.value] = {"cold_s": cold, "warm_s": warm,
                            **compare_exact(out, ref, strat.value)}
    return res


def phase_culled():
    """Strategy.CULLED, 1M scattered queries × 1,310,720 triangles, vs the
    XLA engine on a 65,536-query subsample."""
    import mesh_to_sdf_tpu as m
    from mesh_to_sdf_tpu.ops import culling

    v, f, topo = sphere(8)
    q = scattered(1_000_000, 1)
    cold, warm, out = timed(
        lambda: m.generate_sdf(v, topo, q, m.Strategy.CULLED))
    stats = dict(culling.LAST_CULLED_STATS)
    sub = np.random.default_rng(3).choice(len(q), 65_536, replace=False)
    t_x = time.perf_counter()
    ref = xla_exact(v, topo, q[sub])
    t_x = time.perf_counter() - t_x
    err = compare_exact(np.asarray(out)[sub], ref, "culled")
    return {"queries": len(q), "tris": len(f), "cold_s": cold, "warm_s": warm,
            "xla_65536_s": t_x, "LAST_CULLED_STATS": stats, **err}


def phase_normal():
    """SignMethod.NORMAL: a 128³ grid (AUTO → CPT) and 1M queries (AUTO)
    against the XLA champion reduction."""
    import mesh_to_sdf_tpu as m

    v, f, topo = sphere(5)
    N = m.SignMethod.NORMAL
    g = m.Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, [128] * 3)
    cold, warm, out = timed(lambda: m.generate_grid_sdf(v, topo, g, N))
    ref = m.generate_grid_sdf(v, topo, g, N, strategy=m.Strategy.XLA)
    grid = cpt_contract(out, ref, "normal grid")
    check(grid["sign_mismatch_frac"] <= NORMAL_SIGN_BUDGET, f"signs {grid}")
    q = scattered(1_000_000, 2)
    cold_q, warm_q, outq = timed(lambda: m.generate_sdf(v, topo, q,
                                                        sign_method=N))
    qerr = compare_exact(outq, xla_exact(v, topo, q, N), "normal queries",
                         sign_budget=NORMAL_SIGN_BUDGET)
    return {"grid_128": {"cold_s": cold, "warm_s": warm,
                         "sign_budget": NORMAL_SIGN_BUDGET, **grid},
            "queries_1M": {"cold_s": cold_q, "warm_s": warm_q, **qerr}}


def phase_streamed():
    """generate_grid_sdf_streamed at 512³ on 20,480 triangles; one slab
    checked against the exact engine (CPT contract, equal signs)."""
    import mesh_to_sdf_tpu as m
    from mesh_to_sdf_tpu.gridgen_streamed import generate_grid_sdf_streamed

    v, f, topo = sphere(5)
    g = m.Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, [512] * 3)
    cold, warm, out = timed(
        lambda: generate_grid_sdf_streamed(v, f, g, m.SignMethod.RAYCAST))
    out = np.asarray(out).reshape(512, 512, 512)
    inside = float((out < 0).mean())
    check(INSIDE_RANGE[0] < inside < INSIDE_RANGE[1], f"inside {inside}")
    # One 64-slice slab (the 4th), exact engine at its 16.7M cell centers.
    lo = 192
    centers = np.asarray(g.all_cell_centers()[lo:lo + 64]).reshape(-1, 3)
    exact = np.asarray(m.generate_sdf(v, topo, centers))
    slab = cpt_contract(out[lo:lo + 64].reshape(-1), exact, "streamed slab")
    check(slab["sign_mismatch_frac"] <= RAY_SIGN_BUDGET, f"signs {slab}")
    return {"cells": 512**3, "cold_s": cold, "warm_s": warm,
            "inside_frac": inside, "slab_192_256": slab}


def phase_differentiable():
    """DifferentiableSDF (CPT engine) fitting a 5,120-triangle template to
    a scaled target on a 128³ grid: finite, decreasing loss."""
    import jax.numpy as jnp

    import mesh_to_sdf_tpu as m
    from mesh_to_sdf_tpu.models.sdf_layer import DifferentiableSDF

    v, f, topo = sphere(4)
    g = m.Grid.from_bounding_box([-1.4] * 3, [1.4] * 3, [128] * 3)
    target = jnp.asarray(np.abs(np.asarray(m.generate_grid_sdf(
        v * 1.15, topo, g, m.SignMethod.NORMAL, flat=False))))
    model = DifferentiableSDF(f.astype(np.int32), g, m.SignMethod.NORMAL,
                              learning_rate=1e-2, engine="cpt",
                              vertices_example=v)
    state = model.init(v)
    losses, times = [], []
    for _ in range(6):
        t0 = time.perf_counter()
        state, loss = model.train_step(state, target)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    check(np.isfinite(losses).all(), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss not decreasing {losses}")
    return {"cells": 128**3, "tris": len(f), "losses": losses,
            "cold_s": times[0], "warm_s": float(np.median(times[1:]))}


def phase_cli():
    """CLI: icosphere GLB → ``generate --cells 128`` → ``info``, run
    in-process (exactly what ``python -m mesh_to_sdf_tpu`` calls)."""
    import contextlib
    import io

    from mesh_to_sdf_tpu import cli
    from mesh_to_sdf_tpu.io import gltf, serde

    v, f, _ = sphere(5)
    with tempfile.TemporaryDirectory() as tmp:
        glb = os.path.join(tmp, "ico.glb")
        sdf = os.path.join(tmp, "out.sdf")
        gltf.save_glb(glb, v, f)
        t0 = time.perf_counter()
        rc = cli.main(["generate", glb, "--cells", "128", "-o", sdf])
        t_gen = time.perf_counter() - t0
        check(rc == 0, f"generate rc {rc}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["info", sdf])
        check(rc == 0, f"info rc {rc}")
        back = serde.read_from_file(sdf)
        d = np.asarray(back.distances)
        check(d.size == 128**3 and np.isfinite(d).all(), "sdf file content")
        inside = float((d < 0).mean())
        # --extent-scale 1.1 around the unit sphere: (4/3)π/2.2³ = 0.3934.
        check(INSIDE_RANGE[0] < inside < INSIDE_RANGE[1], f"inside {inside}")
    return {"generate_s": t_gen, "inside_frac": inside,
            "info": buf.getvalue().strip()[:200]}


def peak_bytes(devs):
    """Each device's high-water mark of bytes in use (None where the
    platform keeps no statistics)."""
    return [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in devs]


def phase_four():
    """The sharded paths on four cards: x-slab CPT at 512³ vs one card,
    sharded CULLED at 1M queries vs the one-card exact engine, and one
    sharded fit step."""
    import jax
    import jax.numpy as jnp
    import optax

    import mesh_to_sdf_tpu as m
    from mesh_to_sdf_tpu.gridgen_streamed import generate_grid_sdf_streamed
    from mesh_to_sdf_tpu.parallel import mesh as pmesh
    from mesh_to_sdf_tpu.parallel.grid_sharded import (
        generate_grid_sdf_sharded_cpt,
    )
    from mesh_to_sdf_tpu.parallel.sharding import (
        generate_sdf_sharded_culled, sharded_fit_step_fn,
    )

    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 GPUs, found {len(devs)}")
    mesh = pmesh.make_sdf_mesh(cells=4, tris=1, devices=devs)
    v, f, topo = sphere(5)
    g = m.Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, [512] * 3)
    cold, warm, sh = timed(lambda: generate_grid_sdf_sharded_cpt(
        v, f, g, mesh, m.SignMethod.RAYCAST))
    # High-water marks before anything else runs: the slabs' share per card.
    peak_grid = peak_bytes(devs)
    sh = np.asarray(sh).reshape(512, 512, 512)
    # The one-card reference at 512³ is the streamed pipeline (same CPT
    # engine, slab by slab, on slabs of the shards' width so both sign
    # passes see identical slab origins); tolerances of
    # tests/test_grid_sharded.py.
    one = np.asarray(generate_grid_sdf_streamed(
        v, f, g, m.SignMethod.RAYCAST, slab_nx=512 // len(devs),
    )).reshape(512, 512, 512)
    sign_frac = float(np.mean(np.sign(sh) != np.sign(one)))
    diff = float(np.abs(sh - one).max())
    check(sign_frac == 0.0, f"sharded vs one-card signs {sign_frac}")
    check(diff <= 3e-3, f"sharded vs one-card max diff {diff}")

    vq, fq, topoq = sphere(8)
    q = scattered(1_000_000, 4)
    cold_c, warm_c, sc = timed(
        lambda: generate_sdf_sharded_culled(vq, fq, q, mesh))
    with jax.default_device(devs[0]):
        ref = np.asarray(m.generate_sdf(vq, topoq, q, m.Strategy.PALLAS))
    culled = compare_exact(sc, ref, "sharded culled")

    vs, fs, _ = sphere(3)
    gs = m.Grid.from_bounding_box([-1.4] * 3, [1.4] * 3, [64] * 3)
    tx = optax.adam(1e-2)
    step, pad_target = sharded_fit_step_fn(
        mesh, fs.astype(np.int32), gs, tx, m.SignMethod.NORMAL, block=256)
    target = pad_target(np.asarray(m.generate_grid_sdf(
        vs * 1.15, m.Topology.triangle_list(fs.reshape(-1)), gs,
        m.SignMethod.NORMAL, strategy=m.Strategy.XLA)))
    vv = jax.device_put(jnp.asarray(vs), pmesh.replicated(mesh))
    opt = tx.init(vv)
    t0 = time.perf_counter()
    vv, opt, loss = step(vv, opt, target)
    loss = float(jax.block_until_ready(loss))
    t_step = time.perf_counter() - t0
    check(np.isfinite(loss), f"fit loss {loss}")
    return {"grid_512_sharded": {"cold_s": cold, "warm_s": warm,
                                 "max_diff_vs_one_card": diff,
                                 "diff_tol": 3e-3,
                                 "sign_mismatch_frac": sign_frac,
                                 "peak_bytes_per_card": peak_grid},
            "culled_1M_x_1310720": {"cold_s": cold_c, "warm_s": warm_c,
                                    **culled},
            "fit_step": {"seconds": t_step, "loss": loss},
            "peak_bytes_per_card": peak_bytes(devs)}


ONE_CARD = [phase_grid, phase_dense, phase_culled, phase_normal,
            phase_streamed, phase_differentiable, phase_cli]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    platform = devs[0].platform
    if platform != "gpu":
        print(f"no GPU: JAX reports platform {platform!r}", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from mesh_to_sdf_tpu import native
    from mesh_to_sdf_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    make = subprocess.run(["make", "-C", os.path.join(HERE, "native")],
                          capture_output=True, text=True)
    loaded = make.returncode == 0 and native.available()
    emit(phase="native", make_rc=make.returncode, loaded=loaded)
    if not loaded:
        print(make.stdout[-2000:] + make.stderr[-2000:], file=sys.stderr)
        return 1

    failed = []
    with jax.default_matmul_precision("highest"):
        for phase in [phase_four] if args.four else ONE_CARD:
            name = phase.__name__[len("phase_"):]
            t0 = time.perf_counter()
            try:
                res = phase()
            except Exception:  # noqa: BLE001 — reported, and fails the run
                traceback.print_exc()
                emit(phase=name, ok=False, seconds=time.perf_counter() - t0)
                failed.append(name)
                continue
            emit(phase=name, ok=True, seconds=time.perf_counter() - t0,
                 **res)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
