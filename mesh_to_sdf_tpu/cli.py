"""Command-line interface: generate / render / info / bench.

The reference client has an explicit TODO for a CLI (`README.md:173` "Add a
CLI"); this delivers it, wrapping the same flows its UI drives: load a glTF
scene (`ui.rs:66-99` → `sdf_program.rs:597-677`), generate a grid SDF, save
it (serde), and render it offline.

Usage:
    python -m mesh_to_sdf_tpu generate model.glb --cells 64 --sign raycast -o out.sdf
    python -m mesh_to_sdf_tpu render out.sdf -o out.png [--mode trilinear]
    python -m mesh_to_sdf_tpu render model.glb --cells 64 -o out.png
    python -m mesh_to_sdf_tpu info out.sdf
    python -m mesh_to_sdf_tpu bench --cells 128 --tris 20480
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _build_grid(vmin, vmax, cells: int, extent_scale: float):
    """Grid from a mesh bbox, scaled about its center — the client's bbox
    extent slider (`sdf_program.rs:679-722`, scale ∈ [1, 3])."""
    from .grid import Grid

    center = (vmin + vmax) * 0.5
    half = (vmax - vmin) * 0.5 * extent_scale
    return Grid.from_bounding_box(center - half, center + half, [cells] * 3)


def _load_mesh_arg(path):
    from .io import gltf

    try:
        verts, faces = gltf.load_mesh(path)
    except gltf.GltfError as e:
        # The reference surfaces load failures as UI alerts (`ui.rs:76-97`);
        # the CLI analog is a clean error exit.
        raise SystemExit(f"error: {e}") from e
    if len(faces) == 0:
        raise SystemExit(f"error: {path} contains no triangles")
    return verts, faces


def cmd_generate(args) -> int:
    import jax

    from . import SignMethod, Topology, generate_grid_sdf
    from .io import serde
    from .utils.profiling import PhaseTimer

    if args.distributed:
        # Multi-host wiring (SURVEY §2.3): every process runs the same
        # command; jax.distributed stitches the hosts together. Launch
        # recipe (2 hosts):
        #   host0: m2s generate in.glb -o out.bin --distributed \
        #            --coordinator host0:1234 --num-processes 2 --process-id 0
        #   host1: same with --process-id 1
        from .parallel.mesh import initialize_distributed

        initialize_distributed(
            args.coordinator, args.num_processes, args.process_id
        )

    verts, faces = _load_mesh_arg(args.input)
    sign = SignMethod(args.sign)
    grid = _build_grid(
        verts.min(axis=0), verts.max(axis=0), args.cells, args.extent_scale
    )
    topo = Topology.triangle_list(faces.reshape(-1))

    n_dev = len(jax.devices()) if (args.distributed or args.devices > 1) else 1
    if args.devices > 1:
        n_dev = args.devices

    timer = PhaseTimer()
    with timer.phase("generate"):
        if n_dev > 1:
            from .parallel.grid_sharded import generate_grid_sdf_sharded_cpt
            from .parallel.mesh import make_sdf_mesh

            mesh = make_sdf_mesh(cells=n_dev, devices=jax.devices()[:n_dev])
            dist = generate_grid_sdf_sharded_cpt(
                verts, faces, grid, mesh, sign
            )
        else:
            dist = generate_grid_sdf(verts, topo, grid, sign, exact=args.exact)
        dist = np.asarray(jax.block_until_ready(dist))
    n = grid.total_cell_count
    secs = timer.times["generate"]
    print(
        f"generated {args.cells}^3 grid ({n} cells, {len(faces)} tris, "
        f"{sign.value}{', exact' if args.exact else ''}"
        f"{f', {n_dev} devices' if n_dev > 1 else ''}) in {secs:.3f}s — "
        f"{n / secs:,.0f} cells/s",
        file=sys.stderr,
    )
    serde.save_to_file(
        args.output, serde.GridSdf(grid=grid, distances=dist),
        format=args.format,
    )
    print(f"wrote {args.output}", file=sys.stderr)
    return 0


def cmd_render(args) -> int:
    from . import SignMethod, Topology, generate_grid_sdf
    from .io import serde
    from .render import Camera, RaymarchMode, render, save_png

    view = getattr(args, "view", "sdf")
    material = None
    if view not in ("sdf", "voxels") and not args.input.endswith(
        (".glb", ".gltf")
    ):
        raise SystemExit(
            f"error: --view {view} renders the source mesh and needs a "
            ".glb/.gltf input, not a baked SDF"
        )
    if args.input.endswith((".glb", ".gltf")):
        if args.material:
            from .io import gltf as gltf_mod
            from .render import generate_cubemap

            try:
                scene = gltf_mod.load_scene(args.input, with_materials=True)
            except gltf_mod.GltfError as e:
                raise SystemExit(f"error: {e}") from e
            verts, faces = scene.merge()
            if len(faces) == 0:
                raise SystemExit(f"error: {args.input} contains no triangles")
            material = generate_cubemap(verts, faces, scene.merge_colors())
        else:
            verts, faces = _load_mesh_arg(args.input)
        grid = _build_grid(
            verts.min(axis=0), verts.max(axis=0), args.cells, args.extent_scale
        )
        dist = np.asarray(
            generate_grid_sdf(
                verts,
                Topology.triangle_list(faces.reshape(-1)),
                grid,
                SignMethod(args.sign),
                flat=False,
            )
        )
    else:
        if args.material:
            raise SystemExit(
                "error: --material needs a mesh input (.glb/.gltf), not a "
                "baked SDF"
            )
        sdf = serde.read_from_file(args.input)
        if not isinstance(sdf, serde.GridSdf):
            raise SystemExit("error: render needs a grid SDF (kind=grid)")
        grid = sdf.grid
        dist = sdf.distances.reshape(grid.cell_count)

    cam = Camera.orbit(
        grid,
        azimuth_deg=args.azimuth,
        elevation_deg=args.elevation,
        width=args.width,
        height=args.height,
    )
    if view == "model":
        # ≙ RenderMode::Model (`model_render_pass.rs:22-84`).
        from .render import render_model

        img = render_model(verts, faces, cam, shadows=not args.no_shadows)
    elif view == "model+sdf":
        # ≙ RenderMode::ModelAndSdf (`sdf_program.rs:38-45`).
        from .render import render_model_and_sdf

        img = render_model_and_sdf(
            verts, faces, dist, grid, cam, iso=args.iso,
            mode=RaymarchMode(args.mode), shadows=not args.no_shadows,
        )
    elif view == "voxels":
        # ≙ RenderMode::Voxels (`draw_voxels.wgsl`, instanced iso-band
        # cubes) — exact DDA cube-cast, works on baked SDFs too.
        from .render import render_voxels

        img = render_voxels(
            dist, grid, cam, iso=args.iso,
            shadows=not args.no_shadows, material=material,
        )
    else:
        img = render(
            dist, grid, cam, iso=args.iso, mode=RaymarchMode(args.mode),
            shadows=not args.no_shadows, material=material,
        )
    save_png(args.output, np.asarray(img))
    print(f"wrote {args.output}", file=sys.stderr)
    return 0


def cmd_info(args) -> int:
    from .io import serde
    from .render import iso_limits

    if args.input.endswith((".glb", ".gltf")):
        verts, faces = _load_mesh_arg(args.input)
        print(
            json.dumps(
                {
                    "kind": "mesh",
                    "vertices": int(len(verts)),
                    "triangles": int(len(faces)),
                    "bbox_min": verts.min(axis=0).tolist(),
                    "bbox_max": verts.max(axis=0).tolist(),
                }
            )
        )
        return 0
    sdf = serde.read_from_file(args.input)
    if isinstance(sdf, serde.GridSdf):
        lo, hi = iso_limits(sdf.distances)
        g = sdf.grid
        print(
            json.dumps(
                {
                    "kind": "grid",
                    "cell_count": list(g.cell_count),
                    "first_cell": np.asarray(g.first_cell).tolist(),
                    "cell_size": np.asarray(g.cell_size).tolist(),
                    "iso_limits": [float(lo), float(hi)],
                    "inside_fraction": float((sdf.distances < 0).mean()),
                }
            )
        )
    else:
        print(
            json.dumps(
                {
                    "kind": "generic",
                    "points": int(len(sdf.distances)),
                    "iso_limits": [
                        float(sdf.distances.min()),
                        float(sdf.distances.max()),
                    ],
                }
            )
        )
    return 0


def cmd_bench(args) -> int:
    import jax

    from . import Grid, SignMethod, Topology, generate_grid_sdf, generate_sdf
    from .utils.meshgen import icosphere

    if args.scaling:
        # Weak-scaling efficiency across all visible devices (BASELINE
        # north star: ≥80% at 1→N). One command per host on a cluster.
        if args.distributed:
            from .parallel.mesh import initialize_distributed

            initialize_distributed(
                args.coordinator, args.num_processes, args.process_id
            )
        from .parallel.scaling import format_report, measure_weak_scaling

        report = measure_weak_scaling(
            base_nx=args.cells // 2,
            ny=args.cells, nz=args.cells,
            sign_method=SignMethod(args.sign),
            repeats=args.repeats,
        )
        print(format_report(report))
        print(json.dumps({"metric": "weak_scaling", **report}))
        return 0

    subdiv = max(1, int(np.ceil(np.log(max(args.tris, 20) / 20) / np.log(4))))
    verts, faces = icosphere(subdiv=subdiv)
    topo = Topology.triangle_list(faces.reshape(-1))
    sign = SignMethod(args.sign)

    if args.mode == "query":
        # Scattered-query throughput (BASELINE config 4; reference criterion
        # `benches/generate_sdf.rs`).
        rng = np.random.default_rng(0)
        q = rng.uniform(-1.2, 1.2, (args.queries, 3)).astype(np.float32)

        def run():
            out = generate_sdf(verts, topo, q, sign_method=sign)
            jax.block_until_ready(out)

        label = f"queries_per_s_{args.queries}q_{len(faces)}t_{sign.value}"
        n = args.queries
    else:
        grid = Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, [args.cells] * 3)

        def run():
            out = generate_grid_sdf(verts, topo, grid, sign)
            jax.block_until_ready(out)

        label = f"grid_cells_per_s_{args.cells}^3_{sign.value}"
        n = grid.total_cell_count

    run()
    times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    best = min(times)
    print(
        json.dumps(
            {
                "metric": label,
                "value": round(n / best, 1),
                "unit": "queries/s" if args.mode == "query" else "cells/s",
                "tris": int(len(faces)),
                "seconds": round(best, 4),
            }
        )
    )
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="mesh_to_sdf_tpu", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = p.add_subparsers(dest="command", required=True)

    g = sub.add_parser("generate", help="mesh → grid SDF file")
    g.add_argument("input")
    g.add_argument("-o", "--output", required=True)
    g.add_argument("--cells", type=int, default=64, help="grid resolution per axis")
    g.add_argument("--sign", choices=["raycast", "normal"], default="raycast")
    g.add_argument(
        "--extent-scale", type=float, default=1.1,
        help="bbox scale around the mesh (client slider range 1..3)",
    )
    g.add_argument(
        "--exact", action="store_true",
        help="guarantee grid == brute-at-centers (replaces the approximate "
             "CPT route with the exact tile-culled engine)",
    )
    g.add_argument(
        "--format", choices=["native", "reference"], default="native",
        help="output container: this framework's zero-copy format, or the "
             "Rust crate's rmp-serde V1 for interchange",
    )
    g.add_argument(
        "--devices", type=int, default=1,
        help="shard the grid across N local devices (x-slab CPT pipeline)",
    )
    g.add_argument(
        "--distributed", action="store_true",
        help="initialize jax.distributed for multi-host clusters (see "
             "--coordinator / --num-processes / --process-id)",
    )
    g.add_argument("--coordinator", default=None,
                   help="coordinator address host:port (multi-host)")
    g.add_argument("--num-processes", type=int, default=None)
    g.add_argument("--process-id", type=int, default=None)
    g.set_defaults(fn=cmd_generate)

    r = sub.add_parser("render", help="SDF file or mesh → PNG")
    r.add_argument("input")
    r.add_argument("-o", "--output", required=True)
    r.add_argument("--cells", type=int, default=64)
    r.add_argument("--sign", choices=["raycast", "normal"], default="raycast")
    r.add_argument("--extent-scale", type=float, default=1.1)
    r.add_argument(
        "--mode",
        choices=[m.value for m in __import__(
            "mesh_to_sdf_tpu.render", fromlist=["RaymarchMode"]
        ).RaymarchMode],
        default="trilinear",
    )
    r.add_argument("--iso", type=float, default=0.0)
    r.add_argument("--width", type=int, default=512)
    r.add_argument("--height", type=int, default=512)
    r.add_argument("--azimuth", type=float, default=30.0)
    r.add_argument("--elevation", type=float, default=25.0)
    r.add_argument("--no-shadows", action="store_true")
    r.add_argument(
        "--material", action="store_true",
        help="project the mesh's glTF base-color materials onto the SDF via "
             "a 6-face cubemap (mesh inputs only)",
    )
    r.add_argument(
        "--view", choices=["sdf", "voxels", "model", "model+sdf"],
        default="sdf",
        help="what to draw (RenderMode, `sdf_program.rs:38-45`): the "
             "raymarched SDF, the source mesh (Blinn-Phong + shadows), or "
             "both composited by depth (mesh inputs only for model views)",
    )
    r.set_defaults(fn=cmd_render)

    i = sub.add_parser("info", help="describe a mesh or SDF file")
    i.add_argument("input")
    i.set_defaults(fn=cmd_info)

    b = sub.add_parser("bench", help="grid/query throughput")
    b.add_argument("--mode", choices=["grid", "query"], default="grid")
    b.add_argument("--cells", type=int, default=128)
    b.add_argument("--queries", type=int, default=1_000_000)
    b.add_argument("--tris", type=int, default=20480)
    b.add_argument("--sign", choices=["raycast", "normal"], default="raycast")
    b.add_argument("--repeats", type=int, default=3)
    b.add_argument(
        "--scaling", action="store_true",
        help="measure weak-scaling efficiency across all visible devices "
             "(grid nx grows with device count). Combine with --distributed "
             "on multi-host clusters.",
    )
    b.add_argument(
        "--distributed", action="store_true",
        help="initialize jax.distributed before the scaling sweep",
    )
    b.add_argument("--coordinator", default=None)
    b.add_argument("--num-processes", type=int, default=None)
    b.add_argument("--process-id", type=int, default=None)
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    if args.command in ("generate", "bench"):
        from .utils.compile_cache import configure_compile_cache

        configure_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
