"""`.crtscene` JSON scene loader.

Replicates the reference loader's semantics (reference:
include/raytracer/io/json/loader.hpp:236-265 and helpers), including its
quirks:

- `bucket_size` is optional with default 64 (loader.hpp:47-60).
- A `diffuse` material whose `albedo` is a *string* is promoted to a
  texture material referencing the named texture (loader.hpp:120-125).
- UV arrays are consumed three floats per vertex but only x,y are stored
  (loader.hpp:176-187).
- `lights`, `materials`, `objects`, and per-object `material_index` /
  `vertices` / `triangles` are mandatory; malformed input raises ValueError
  (mirroring the std::invalid_argument throws at loader.hpp:104-224).
- Bitmap textures decode their `file_path` image to float RGB in [0,1]
  (texture/bitmap.hpp:12-37); paths resolve relative to the scene file's
  directory, falling back to the process CWD (the reference resolves via
  CWD only, since stbi_load gets the raw string).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np

from ..utils.ppm import read_ppm
from .scene import (MAT_CONSTANT, MAT_DIFFUSE, MAT_REFLECTIVE, MAT_REFRACTIVE,
                    MAT_TEXTURE, TEX_ALBEDO, TEX_BITMAP, TEX_CHECKER,
                    TEX_EDGES, Scene, build_scene)


def _load_bitmap(path: str) -> np.ndarray:
    """Decode an image file to (H, W, 3) float32 in [0, 1].

    Matches load_bitmap (texture/bitmap.hpp:12-37): channels beyond RGB are
    dropped, values scaled by 1/255.  PPM (P3/P6) is decoded here; other
    formats need Pillow.
    """
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic in (b"P3", b"P6"):
        arr = read_ppm(path).astype(np.float32)
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(f"bitmap {path!r} is not a PPM; decoding it "
                              "needs Pillow, which is not installed") from e
        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGB"), dtype=np.float32)
    return arr * np.float32(1.0 / 255.0)


def _require(obj: Dict[str, Any], key: str, ctx: str):
    if key not in obj:
        raise ValueError(f"missing required key {key!r} in {ctx}")
    return obj[key]


def _resolve_bitmap_path(fp: str, base_dir: str) -> str:
    """The reference passes the raw string to stbi_load, resolving against
    the process CWD.  Scene files use repo-root-relative paths
    ("scenes/.../x.jpg"), so also try every path suffix against the scene
    file's directory."""
    parts = fp.replace("\\", "/").split("/")
    candidates = [fp] + [os.path.join(base_dir, *parts[i:])
                         for i in range(len(parts))]
    return next((c for c in candidates if os.path.exists(c)), fp)


def parse_scene_dict(doc: Dict[str, Any], base_dir: str = ".") -> Scene:
    settings = _require(doc, "settings", "scene")
    image_settings = _require(settings, "image_settings", "settings")
    background = _require(settings, "background_color", "settings")
    height = int(_require(image_settings, "height", "image_settings"))
    width = int(_require(image_settings, "width", "image_settings"))
    bucket_size = int(image_settings.get("bucket_size", 64))

    cam = _require(doc, "camera", "scene")
    cam_pos = np.asarray(_require(cam, "position", "camera"), np.float32)
    cam_mat = np.asarray(_require(cam, "matrix", "camera"), np.float32)

    lights = [(np.asarray(l["position"], np.float32), float(l["intensity"]))
              for l in _require(doc, "lights", "scene")]

    # Textures: optional array keyed by name (loader.hpp:250-254).
    tex_by_name: Dict[str, int] = {}
    textures = []
    for tj in doc.get("textures", []):
        name = _require(tj, "name", "texture")
        ttype = _require(tj, "type", "texture")
        if ttype == "albedo":
            td = {"tag": TEX_ALBEDO, "color_a": tj["albedo"]}
        elif ttype == "edges":
            td = {"tag": TEX_EDGES, "color_a": tj["edge_color"],
                  "color_b": tj["inner_color"],
                  "param": float(tj["edge_width"])}
        elif ttype == "checker":
            td = {"tag": TEX_CHECKER, "color_a": tj["color_A"],
                  "color_b": tj["color_B"],
                  "param": float(tj["square_size"])}
        elif ttype == "bitmap":
            path = _resolve_bitmap_path(tj["file_path"], base_dir)
            td = {"tag": TEX_BITMAP, "bitmap": _load_bitmap(path)}
        else:
            raise ValueError(f"texture type unknown: {ttype!r}")
        tex_by_name[name] = len(textures)
        textures.append(td)

    materials = []
    for mj in _require(doc, "materials", "scene"):
        mtype = _require(mj, "type", "material")
        if mtype == "diffuse":
            albedo = _require(mj, "albedo", "diffuse material")
            if isinstance(albedo, str):
                # String albedo promotes to texture material
                # (loader.hpp:120-125).
                if albedo not in tex_by_name:
                    raise ValueError(f"unknown texture name {albedo!r}")
                materials.append({"tag": MAT_TEXTURE,
                                  "tex": tex_by_name[albedo],
                                  "smooth": bool(mj["smooth_shading"])})
            elif isinstance(albedo, (list, tuple)):
                materials.append({"tag": MAT_DIFFUSE, "albedo": albedo,
                                  "smooth": bool(mj["smooth_shading"])})
            else:
                raise ValueError("albedo neither array nor string")
        elif mtype == "reflective":
            materials.append({"tag": MAT_REFLECTIVE, "albedo": mj["albedo"],
                              "smooth": bool(mj["smooth_shading"])})
        elif mtype == "refractive":
            materials.append({"tag": MAT_REFRACTIVE,
                              "ior": float(mj["ior"]),
                              "smooth": bool(mj["smooth_shading"])})
        elif mtype == "constant":
            materials.append({"tag": MAT_CONSTANT, "albedo": mj["albedo"],
                              "smooth": bool(mj["smooth_shading"])})
        else:
            raise ValueError(f"material type unknown: {mtype!r}")

    mesh_vertices, mesh_tri_vidx, mesh_uvs, mesh_material = [], [], [], []
    for obj in _require(doc, "objects", "scene"):
        mesh_material.append(int(_require(obj, "material_index", "object")))
        verts = np.asarray(_require(obj, "vertices", "object"), np.float32)
        if verts.size % 3 != 0:
            raise ValueError("vertex coordinates not multiple of 3")
        mesh_vertices.append(verts.reshape(-1, 3))

        uvs = None
        if "uvs" in obj:
            uv_raw = np.asarray(obj["uvs"], np.float32)
            if uv_raw.size % 3 != 0:
                raise ValueError("uv coordinates not multiple of 3")
            # Groups of 3 floats, third component dropped
            # (loader.hpp:176-187).
            uvs = uv_raw.reshape(-1, 3)[:, :2]
        mesh_uvs.append(uvs)

        tris = np.asarray(_require(obj, "triangles", "object"), np.int64)
        if tris.size % 3 != 0:
            raise ValueError("triangle indices not multiple of 3")
        mesh_tri_vidx.append(tris.reshape(-1, 3))

    return build_scene(
        mesh_vertices=mesh_vertices, mesh_tri_vidx=mesh_tri_vidx,
        mesh_uvs=mesh_uvs, mesh_material=mesh_material,
        materials=materials, textures=textures, lights=lights,
        cam_pos=cam_pos, cam_mat=cam_mat, background=background,
        height=height, width=width, bucket_size=bucket_size,
    )


def _scene_from_native(raw: Dict[str, Any], base_dir: str) -> Scene:
    """Assemble a Scene from the C++ loader's raw arrays (native.py)."""
    textures = []
    for td in raw["textures"]:
        entry = {"tag": td["tag"], "color_a": td["color_a"],
                 "color_b": td["color_b"], "param": td["param"]}
        if td["tag"] == TEX_BITMAP:
            entry["bitmap"] = _load_bitmap(
                _resolve_bitmap_path(td["file_path"], base_dir))
        textures.append(entry)
    return build_scene(
        mesh_vertices=[o["vertices"] for o in raw["objects"]],
        mesh_tri_vidx=[o["triangles"] for o in raw["objects"]],
        mesh_uvs=[o["uvs"] for o in raw["objects"]],
        mesh_material=[o["material_index"] for o in raw["objects"]],
        materials=raw["materials"], textures=textures,
        lights=list(zip(raw["light_pos"],
                        raw["light_intensity"].tolist())),
        cam_pos=raw["cam_pos"], cam_mat=raw["cam_mat"],
        background=raw["background"],
        height=raw["height"], width=raw["width"],
        bucket_size=raw["bucket_size"],
    )


def parse_scene_file(path: str, use_native: bool = None) -> Scene:
    """Parse a `.crtscene` file (loader.hpp:236-265 equivalent).

    use_native: force the C++ loader (native/loader.cpp) on/off; None
    auto-selects it when the shared library is built.  Both paths produce
    identical Scenes (tested in tests/test_native.py).
    """
    base_dir = os.path.dirname(os.path.abspath(path))
    if use_native is None or use_native:
        from ..native import native_parse_scene
        raw = native_parse_scene(path)
        if raw is not None:
            return _scene_from_native(raw, base_dir)
        if use_native:
            raise RuntimeError("native loader requested but the shared "
                               "library is not built; run `make -C native`")
    with open(path, "r") as f:
        doc = json.load(f)
    return parse_scene_dict(doc, base_dir=base_dir)
