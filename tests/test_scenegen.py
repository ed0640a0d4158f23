"""Stand-in scene generator (models/scenegen.py): the written files load
through the normal loader, keep the corpus shape facts, and are closed,
outward-facing meshes; PPM bitmaps decode without Pillow."""

import builtins
import json

import jax
import numpy as np
import pytest

from simd_raytracer import parse_scene_file
from simd_raytracer.models import scenegen
from simd_raytracer.models.scene import MAT_TEXTURE, TEX_BITMAP


def test_written_vertices_round_trip_bit_exact(tmp_path):
    doc, _ = scenegen.scene_doc("dragon")
    scene = parse_scene_file(scenegen.write_scene("dragon", str(tmp_path)))
    want = np.asarray(doc["objects"][0]["vertices"], np.float32)
    got = np.asarray(scene.vertices)[:len(want) // 3].reshape(-1)
    np.testing.assert_array_equal(got, want)


def test_same_seed_same_scene_other_seed_differs(tmp_path):
    a = scenegen.scene_doc("dragon", seed=0)[0]
    b = scenegen.scene_doc("dragon", seed=0)[0]
    c = scenegen.scene_doc("dragon", seed=1)[0]
    assert json.dumps(a) == json.dumps(b)
    assert json.dumps(a) != json.dumps(c)


@pytest.mark.parametrize("name,tris,size", [
    ("room", 2012, (1920, 1920)), ("dragon", 4014, (1080, 1920)),
    ("dragon_glass", 4022, (1080, 1920)), ("textures", 8, (1080, 1920))])
def test_corpus_shape_facts(scenes, name, tris, size):
    s = parse_scene_file(str(scenes / f"{name}.crtscene"))
    assert int(np.asarray(s.tri_valid).sum()) == tris
    assert (s.height, s.width) == size


def test_terrain_triangle_count():
    doc, _ = scenegen.scene_doc("terrain")
    assert len(doc["objects"][0]["triangles"]) // 3 == 2 * 354 ** 2


@pytest.mark.parametrize("n_lon,n_lat,displace", [(12, 8, False),
                                                  (59, 35, True)])
def test_sphere_is_closed_and_outward(n_lon, n_lat, displace):
    blob = scenegen._blob(np.random.default_rng(0)) if displace else None
    v, t = scenegen._sphere((0.0, 0.0, 0.0), 1.0, n_lon, n_lat, blob)
    assert len(t) == 2 * n_lon * (n_lat - 1)
    # closed 2-manifold: every edge is shared by exactly two triangles,
    # once in each direction (consistent winding)
    edges = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])
    assert len({tuple(e) for e in edges}) == len(edges)
    assert {tuple(e) for e in edges} == {tuple(e[::-1]) for e in edges}
    # outward: positive signed volume
    p = v[t].astype(np.float64)
    vol = np.einsum("ij,ij->i", p[:, 0], np.cross(p[:, 1], p[:, 2])).sum()
    assert vol > 0


def test_box_faces_point_outward_and_inward():
    for inward in (False, True):
        v, t = scenegen._box((1.0, 2.0, 3.0), (0.5, 1.0, 2.0), inward)
        p = v[t].astype(np.float64)
        n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        out = np.einsum("ij,ij->i", n, p.mean(axis=1) - [1.0, 2.0, 3.0])
        assert ((out < 0) if inward else (out > 0)).all()


def test_bitmap_loads_without_pillow(scenes, monkeypatch):
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    s = parse_scene_file(str(scenes / "textures.crtscene"), use_native=False)
    tags = np.asarray(s.tex_tag)
    assert TEX_BITMAP in tags and (np.asarray(s.mat_tag) == MAT_TEXTURE).all()
    i = int(np.flatnonzero(tags == TEX_BITMAP)[0])
    _, bitmaps = scenegen.scene_doc("textures")
    bmp = next(iter(bitmaps.values()))
    w, h = int(s.tex_width[i]), int(s.tex_height[i])
    assert (h, w) == bmp.shape[:2]
    atlas = np.asarray(s.atlas)[int(s.tex_offset[i]):][:h * w]
    np.testing.assert_array_equal(
        atlas, bmp.reshape(-1, 3).astype(np.float32) * np.float32(1 / 255))


def test_non_ppm_bitmap_without_pillow_is_a_clear_error(tmp_path,
                                                        monkeypatch):
    from simd_raytracer.models.loader import _load_bitmap
    path = tmp_path / "x.png"
    path.write_bytes(b"\x89PNG\r\n")
    real_import = builtins.__import__
    monkeypatch.setattr(builtins, "__import__", lambda n, *a, **k: (
        (_ for _ in ()).throw(ImportError(n)) if n == "PIL"
        else real_import(n, *a, **k)))
    with pytest.raises(ImportError, match="Pillow"):
        _load_bitmap(str(path))


def test_pytree_dataclass_static_fields_and_replace(scenes):
    s = parse_scene_file(str(scenes / "tiny.crtscene"))
    leaves, treedef = jax.tree_util.tree_flatten(s)
    assert all(hasattr(x, "shape") for x in leaves)   # ints are static
    s2 = s.replace(height=3)
    assert s2.height == 3 and s.height == 16
    assert jax.tree_util.tree_structure(s2) != treedef  # part of treedef
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.width == s.width


def test_cli_main_writes_scenes(tmp_path, capsys):
    assert scenegen.main([str(tmp_path), "tiny", "prism"]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "prism.crtscene", "tiny.crtscene"]
