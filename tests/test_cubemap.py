"""Cubemap material projection tests (≙ `cubemap.rs:160-311`,
`draw_raymarching.wgsl:364-441`) + glTF material ingestion."""
import base64
import io as _io
import json

import numpy as np
import pytest

from baselines import make_icosphere
from mesh_to_sdf_tpu.io import gltf
from mesh_to_sdf_tpu.render.cubemap import (
    Cubemap, generate_cubemap, sample_cubemap,
)
from mesh_to_sdf_tpu.utils.meshgen import box

RED = np.array([1.0, 0.0, 0.0], np.float32)
BLUE = np.array([0.0, 0.0, 1.0], np.float32)


@pytest.fixture(scope="module")
def colored_box():
    """Unit box: +x-side vertices red, everything else blue."""
    v, f = box()
    colors = np.where((v[:, 0] > 0)[:, None], RED, BLUE).astype(np.float32)
    return v, f, colors


def test_cubemap_faces_and_depth(colored_box):
    v, f, colors = colored_box
    cm = generate_cubemap(v, f, colors, res=32)
    assert cm.albedo.shape == (6, 32, 32, 3)

    # Probe an off-diagonal texel: the box's quad diagonals project onto
    # u == v, where the strict edge test misses by design (the reference's
    # aligned test has the same shared-edge blind spot, `geo.rs:156-216`).
    px = (16, 8)
    # Face 1 views from +x: it sees the x=+max quad (red).
    np.testing.assert_allclose(np.asarray(cm.albedo[1][px]), RED, atol=1e-5)
    # Face 0 views from -x: blue.
    np.testing.assert_allclose(np.asarray(cm.albedo[0][px]), BLUE, atol=1e-5)
    # Depth = world x of the first surface from each side.
    hx = float(np.max(v[:, 0]))
    assert abs(float(cm.depth[1][px]) - hx) < 1e-4
    assert abs(float(cm.depth[0][px]) + hx) < 1e-4
    # Face means: mostly red from +x, mostly blue from -x.
    assert np.asarray(cm.albedo[1]).mean(axis=(0, 1))[0] > 0.7
    assert np.asarray(cm.albedo[0]).mean(axis=(0, 1))[2] > 0.7


def test_sample_cubemap_visibility(colored_box):
    import jax.numpy as jnp

    v, f, colors = colored_box
    cm = generate_cubemap(v, f, colors, res=32)
    hx = float(np.max(v[:, 0]))
    # Offset from the face center to avoid the projected diagonal.
    pos = jnp.asarray([[hx, 0.2, -0.4], [-hx, 0.2, -0.4]])
    nrm = jnp.asarray([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]])
    out = np.asarray(sample_cubemap(cm, pos, nrm))
    np.testing.assert_allclose(out[0], RED, atol=0.05)
    np.testing.assert_allclose(out[1], BLUE, atol=0.05)

    # A normal facing nowhere the cubemap saw → grey fallback.
    inside = np.asarray(
        sample_cubemap(cm, jnp.zeros((1, 3)), jnp.zeros((1, 3)))
    )
    np.testing.assert_allclose(inside[0], [0.6, 0.6, 0.6], atol=1e-5)


# ---------------------------------------------------------------------------
# glTF material ingestion
# ---------------------------------------------------------------------------
def _gltf_with_material(tmp_path, base_color, png_rgb=None):
    """Minimal single-triangle .gltf with a material (optionally textured)."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    uv = np.array([[0.25, 0.25], [0.75, 0.25], [0.25, 0.75]], np.float32)
    idx = np.array([0, 1, 2], np.uint32)
    blob = pos.tobytes() + uv.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{
            "uri": "data:application/octet-stream;base64,"
                   + base64.b64encode(blob).decode(),
            "byteLength": len(blob),
        }],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 24},
            {"buffer": 0, "byteOffset": 60, "byteLength": 12},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 3,
             "type": "VEC2"},
            {"bufferView": 2, "componentType": 5125, "count": 3,
             "type": "SCALAR"},
        ],
        "materials": [{
            "pbrMetallicRoughness": {"baseColorFactor": list(base_color)},
        }],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "TEXCOORD_0": 1},
            "indices": 2,
            "material": 0,
        }]}],
        "nodes": [{"mesh": 0}],
        "scenes": [{"nodes": [0]}],
        "scene": 0,
    }
    if png_rgb is not None:
        from PIL import Image

        img = Image.fromarray(
            np.broadcast_to(
                np.asarray(png_rgb, np.uint8), (4, 4, 3)
            ).copy()
        )
        buf = _io.BytesIO()
        img.save(buf, format="PNG")
        doc["images"] = [{
            "uri": "data:image/png;base64,"
                   + base64.b64encode(buf.getvalue()).decode(),
        }]
        doc["textures"] = [{"source": 0}]
        doc["materials"][0]["pbrMetallicRoughness"]["baseColorTexture"] = {
            "index": 0
        }
    p = tmp_path / "mat.gltf"
    p.write_text(json.dumps(doc))
    return p


def test_material_base_color_factor(tmp_path):
    p = _gltf_with_material(tmp_path, [0.2, 0.4, 0.8, 1.0])
    scene = gltf.load_scene(p, with_materials=True)
    colors = scene.merge_colors()
    assert colors.shape == (3, 3)
    np.testing.assert_allclose(colors, [[0.2, 0.4, 0.8]] * 3, atol=1e-6)


def test_material_texture_sampling(tmp_path):
    # Uniform (200, 100, 50) texture → linear = (v/255)^2.2, times factor 1.
    p = _gltf_with_material(tmp_path, [1.0, 1.0, 1.0, 1.0],
                            png_rgb=[200, 100, 50])
    scene = gltf.load_scene(p, with_materials=True)
    colors = scene.merge_colors()
    want = (np.array([200, 100, 50]) / 255.0) ** 2.2
    np.testing.assert_allclose(colors, [want] * 3, rtol=1e-3)


def test_materials_off_by_default(tmp_path):
    p = _gltf_with_material(tmp_path, [0.2, 0.4, 0.8, 1.0])
    scene = gltf.load_scene(p)
    assert scene.meshes[0].colors is None
    # merge_colors falls back to the client's grey albedo.
    np.testing.assert_allclose(scene.merge_colors(), [[0.6] * 3] * 3)


@pytest.mark.skipif(
    not __import__("os").path.isdir("/root/reference/mesh_to_sdf/assets"),
    reason="reference assets not mounted",
)
def test_real_asset_materials_load():
    """knight.glb carries a real baseColor texture; FlightHelmet.glb in the
    reference repo is geometry-only (no materials key) → white factor."""
    scene = gltf.load_scene(
        "/root/reference/mesh_to_sdf/assets/knight.glb", with_materials=True,
    )
    colors = scene.merge_colors()
    verts, _ = scene.merge()
    assert colors.shape == verts.shape
    assert np.isfinite(colors).all()
    assert colors.min() >= 0.0 and colors.max() <= 1.0 + 1e-6
    assert colors.std() > 0.02, "textured asset should have varied albedo"

    plain = gltf.load_scene(
        "/root/reference/mesh_to_sdf/assets/FlightHelmet.glb",
        with_materials=True,
    )
    np.testing.assert_allclose(plain.merge_colors(), 1.0)


def test_render_with_material(colored_box):
    """End-to-end: raymarch an SDF with cubemap albedo — +x-facing pixels
    pick up the red face."""
    import jax.numpy as jnp

    import mesh_to_sdf_tpu as m
    from mesh_to_sdf_tpu.render import Camera, render

    v, f, colors = colored_box
    grid = m.Grid.from_bounding_box([-1.4] * 3, [1.4] * 3, [24] * 3)
    dist = m.generate_grid_sdf(
        v, m.Topology.triangle_list(f.reshape(-1)), grid,
        m.SignMethod.RAYCAST, strategy=m.Strategy.XLA, flat=False,
    )
    cm = generate_cubemap(v, f, colors, res=32)
    # Pick the orbit azimuth whose eye is most x-dominant
    # (convention-agnostic), so the camera stares at one colored face.
    cams = [
        Camera.orbit(grid, azimuth_deg=az, elevation_deg=0.0,
                     width=48, height=48)
        for az in (0.0, 90.0, 180.0, 270.0)
    ]
    cam = max(cams, key=lambda c: abs(float(np.asarray(c.eye)[0])))
    img = np.asarray(render(dist, grid, cam, material=cm, shadows=False))
    assert img.shape == (48, 48, 3)
    hit = img.sum(-1) > 0.01
    assert hit.any()
    # Whichever x side the orbit camera looks at dominates the albedo.
    mean = img[hit].mean(axis=0)
    if float(np.asarray(cam.eye)[0]) > 0:
        assert mean[0] > mean[2] + 0.1, mean
    else:
        assert mean[2] > mean[0] + 0.1, mean


def test_cubemap_odd_resolution(colored_box):
    """res² not a multiple of TEXEL_CHUNK (e.g. res=100) must not raise —
    the texel chunking pads and slices back."""
    v, f, colors = colored_box
    cm = generate_cubemap(v, f, colors, res=100)
    assert cm.albedo.shape == (6, 100, 100, 3)
    assert np.asarray(cm.albedo[1]).mean(axis=(0, 1))[0] > 0.7
