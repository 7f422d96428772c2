"""Time the hand-written kernel against the XLA engines on the GPU.

Each phase prints one JSON line. Run on a machine with a GPU:

    python scripts/kernel_decisions.py sweep dense parity auto culled

Phases:
  sweep   tile/warp sweep of the Triton distance kernel at 1M x 20,480
  dense   kernel vs ``brute.sdf_brute`` at 1M x 20,480 (RAYCAST, 3 axes)
          and at the 128^3 dense-grid shape (unsigned)
  parity  XLA grid line parity at 256^3 x 20,480 and the 128^3 sign grid
          of the 1,310,720-triangle mesh
  auto    ``gridgen.calibrate_auto(force=True)`` (the AUTO constants)
  culled  dense vs CULLED at 1M queries x 20,480 and x 1,310,720 triangles
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def _emit(**kw):
    print(json.dumps(kw), flush=True)


def _time(fn, reps=3):
    """(cold seconds, median warm seconds, output)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    cold = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return cold, float(np.median(ts)), out


def _soup(subdiv):
    from mesh_to_sdf_tpu.utils.meshgen import icosphere

    v, f = icosphere(subdiv)
    return v, f, [jnp.asarray(v[f[:, k]]) for k in range(3)]


def _queries(n, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32))


def _brute(q, ta, tb, tc, axes, sign=None):
    from mesh_to_sdf_tpu.ops import brute
    from mesh_to_sdf_tpu.types import SignMethod

    valid = jnp.ones((ta.shape[0],), bool)
    return brute.sdf_brute(
        q, ta, tb, tc, valid, sign_method=sign or SignMethod.RAYCAST,
        raycast_axes=axes,
    )


def phase_sweep():
    from mesh_to_sdf_tpu.ops.kernels import pallas_sdf as ps

    _, _, (ta, tb, tc) = _soup(5)
    q = _queries(1 << 20)
    ref = None
    for tq, tbk, nw in [(32, 32, 4), (64, 32, 4), (64, 64, 4), (128, 32, 4),
                        (64, 32, 8), (128, 64, 8), (128, 32, 8),
                        (32, 64, 2), (64, 16, 4), (256, 32, 8)]:
        fn = lambda: ps.sdf_raycast_pallas(  # noqa: E731
            q, ta, tb, tc, raycast_axes=3, tq=tq, tb_block=tbk, num_warps=nw)
        try:
            cold, warm, out = _time(fn, reps=2)
        except Exception as e:  # a config the compiler refuses is a result
            _emit(phase="sweep", tq=tq, tb=tbk, warps=nw, error=str(e)[:300])
            continue
        out = np.asarray(out)
        if ref is None:
            ref = out
        _emit(phase="sweep", tq=tq, tb=tbk, warps=nw, cold_s=cold,
              warm_s=warm, max_diff_vs_first=float(np.abs(out - ref).max()))


def phase_dense():
    from mesh_to_sdf_tpu.grid import Grid
    from mesh_to_sdf_tpu.ops.kernels import pallas_sdf as ps

    _, _, (ta, tb, tc) = _soup(5)
    q = _queries(1 << 20)
    g = Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [128] * 3)
    centers = g.all_cell_centers().reshape(-1, 3)
    for name, pts, axes in [("queries_1M_raycast3", q, 3),
                            ("grid_128cubed_unsigned", centers, 0)]:
        ck, wk, ok = _time(lambda: ps.sdf_raycast_pallas(  # noqa: B023
            pts, ta, tb, tc, raycast_axes=axes))
        cx, wx, ox = _time(lambda: _brute(pts, ta, tb, tc, axes))  # noqa: B023
        ok, ox = np.asarray(ok), np.asarray(ox)
        _emit(phase="dense", shape=name, n_points=int(pts.shape[0]),
              n_tris=int(ta.shape[0]), kernel_cold_s=ck, kernel_warm_s=wk,
              xla_cold_s=cx, xla_warm_s=wx,
              max_abs_diff=float(np.abs(np.abs(ok) - np.abs(ox)).max()),
              sign_mismatch=int(np.sum(np.sign(ok) != np.sign(ox))))


def phase_parity():
    from mesh_to_sdf_tpu.grid import Grid
    from mesh_to_sdf_tpu.ops import culling, raycast

    _, _, (ta, tb, tc) = _soup(5)
    valid = jnp.ones((ta.shape[0],), bool)
    g = Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [256] * 3)
    c, w, out = _time(lambda: raycast.grid_inside_mask(
        g, ta, tb, tc, valid, tri_block=256))
    _emit(phase="parity", shape="256cubed_x_20480", cold_s=c, warm_s=w,
          inside_frac=float(np.asarray(out).mean()))
    _, _, (ta, tb, tc) = _soup(8)
    valid = jnp.ones((ta.shape[0],), bool)
    c, w, sg = _time(lambda: culling.build_sign_grid(ta, tb, tc, valid),
                     reps=1)
    _emit(phase="parity", shape="sign_grid_128cubed_x_1310720", cold_s=c,
          warm_s=w, inside_frac=float(np.asarray(sg.inside).mean()))


def phase_auto():
    from mesh_to_sdf_tpu import gridgen

    t0 = time.perf_counter()
    consts = gridgen.calibrate_auto(force=True)
    _emit(phase="auto", dense_pairs_per_s=consts[0],
          cpt_overhead_s=consts[1], cpt_cells_per_s=consts[2],
          seconds=time.perf_counter() - t0)


def phase_culled():
    import mesh_to_sdf_tpu as m
    from mesh_to_sdf_tpu.ops import culling

    q = np.asarray(_queries(1 << 20, seed=1))
    for subdiv in (5, 8):
        v, f, _ = _soup(subdiv)
        topo = m.Topology.triangle_list(f.reshape(-1))
        row = {"phase": "culled", "n_tris": int(len(f)), "queries": len(q)}
        for strat in (m.Strategy.XLA, m.Strategy.PALLAS, m.Strategy.CULLED):
            if strat == m.Strategy.XLA and subdiv == 8:
                continue  # minutes per call at 1.3M triangles
            try:
                cold, warm, _ = _time(
                    lambda s=strat: m.generate_sdf(v, topo, q, s), reps=2)
            except ValueError as e:
                row[strat.value] = str(e)[:120]
                continue
            row[strat.value + "_cold_s"] = cold
            row[strat.value + "_warm_s"] = warm
        row["culled_stats"] = dict(culling.LAST_CULLED_STATS)
        _emit(**row)


def main(argv):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    d = jax.devices()[0]
    _emit(platform=d.platform, kind=d.device_kind, count=len(jax.devices()),
          jax=jax.__version__)
    if d.platform != "gpu":
        sys.exit("no GPU")
    phases = {"sweep": phase_sweep, "dense": phase_dense,
              "parity": phase_parity, "auto": phase_auto,
              "culled": phase_culled}
    for name in argv or ["dense"]:
        phases[name]()


if __name__ == "__main__":
    main(sys.argv[1:])
