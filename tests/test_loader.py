"""Scene loader tests (semantics per reference io/json/loader.hpp)."""

import numpy as np
import pytest

from simd_raytracer import parse_scene_dict, parse_scene_file
from simd_raytracer.models.scene import (MAT_CONSTANT, MAT_DIFFUSE,
                                         MAT_REFLECTIVE, MAT_REFRACTIVE,
                                         MAT_TEXTURE, TEX_BITMAP)



def minimal_doc(**overrides):
    doc = {
        "settings": {"background_color": [0.1, 0.2, 0.3],
                     "image_settings": {"width": 8, "height": 6}},
        "camera": {"position": [0, 0, 0],
                   "matrix": [1, 0, 0, 0, 1, 0, 0, 0, 1]},
        "lights": [],
        "materials": [{"type": "diffuse", "albedo": [1, 0, 0],
                       "smooth_shading": False}],
        "objects": [{"material_index": 0,
                     "vertices": [-1, -1, -5, 1, -1, -5, 0, 1, -5],
                     "triangles": [0, 1, 2]}],
    }
    doc.update(overrides)
    return doc


def test_hw15_scene2_counts(scenes):
    s = parse_scene_file(str(scenes / "room.crtscene"))
    assert int(s.tri_valid.sum()) == 2012
    assert s.height == 1920 and s.width == 1920
    assert s.bucket_size == 24
    assert s.mat_tag.shape[0] == 12
    tags = np.asarray(s.mat_tag)
    assert tags[2] == MAT_REFRACTIVE and np.isclose(
        np.asarray(s.mat_ior)[2], 1.5)
    assert tags[7] == MAT_CONSTANT
    assert tags[10] == MAT_REFLECTIVE
    assert s.light_pos.shape == (1, 3)
    assert np.allclose(np.asarray(s.light_intensity), [75.0])


def test_bucket_size_default_64():
    s = parse_scene_dict(minimal_doc())
    assert s.bucket_size == 64   # loader.hpp:47-49


def test_string_albedo_promotes_to_texture_material():
    doc = minimal_doc(
        textures=[{"name": "tex0", "type": "albedo", "albedo": [0, 1, 0]}],
        materials=[{"type": "diffuse", "albedo": "tex0",
                    "smooth_shading": True}],
    )
    s = parse_scene_dict(doc)
    assert int(np.asarray(s.mat_tag)[0]) == MAT_TEXTURE
    assert int(np.asarray(s.mat_tex)[0]) == 0
    assert bool(np.asarray(s.mat_smooth)[0])


def test_uv_triples_truncated_to_vec2():
    # UVs come as 3 floats per vertex; third is dropped (loader.hpp:176-187).
    doc = minimal_doc()
    doc["objects"][0]["uvs"] = [0.1, 0.2, 9.0, 0.3, 0.4, 9.0, 0.5, 0.6, 9.0]
    s = parse_scene_dict(doc)
    uv = np.asarray(s.uv)[0]
    assert np.allclose(uv, [[0.1, 0.2], [0.3, 0.4], [0.5, 0.6]])


def test_malformed_raises():
    doc = minimal_doc()
    doc["objects"][0]["vertices"] = [0, 0, 0, 1]   # not multiple of 3
    with pytest.raises(ValueError):
        parse_scene_dict(doc)
    doc = minimal_doc(materials=[{"type": "weird", "albedo": [1, 1, 1]}])
    with pytest.raises(ValueError):
        parse_scene_dict(doc)
    doc = minimal_doc()
    doc["objects"][0]["triangles"] = [0, 1]
    with pytest.raises(ValueError):
        parse_scene_dict(doc)
    doc = minimal_doc()
    del doc["lights"]   # lights key mandatory (loader.hpp:246-248)
    with pytest.raises(ValueError):
        parse_scene_dict(doc)


def test_bitmap_texture_atlas(scenes):
    s = parse_scene_file(str(scenes / "textures.crtscene"))
    tags = np.asarray(s.tex_tag)
    assert TEX_BITMAP in tags
    bi = int(np.where(tags == TEX_BITMAP)[0][0])
    w = int(np.asarray(s.tex_width)[bi])
    h = int(np.asarray(s.tex_height)[bi])
    assert w > 1 and h > 1
    assert s.atlas.shape[0] >= w * h
    atlas = np.asarray(s.atlas)
    assert atlas.min() >= 0.0 and atlas.max() <= 1.0
    # All four materials promoted to texture materials.
    assert (np.asarray(s.mat_tag) == MAT_TEXTURE).all()


def test_vertex_normal_computation():
    # Two triangles sharing an edge: shared vertices average face normals
    # (mesh.hpp:33-43).
    from simd_raytracer.models.scene import derive_geometry
    doc = minimal_doc()
    doc["objects"][0]["vertices"] = [
        0, 0, 0, 1, 0, 0, 0, 0, -1,   # tri 0 in y=0 plane, normal +y
        0, 1, 0]                       # apex for tri 1
    doc["objects"][0]["triangles"] = [0, 1, 2, 0, 2, 3]
    s = parse_scene_dict(doc)
    g = derive_geometry(s)
    fn = np.asarray(g.face_n)[:2]
    assert np.allclose(fn[0], [0, 1, 0], atol=1e-6)
    vn = np.asarray(g.vn)
    # Vertex 1 belongs only to tri 0 -> its normal is tri 0's face normal.
    assert np.allclose(vn[0, 1], [0, 1, 0], atol=1e-6)
    # Vertex 0 is shared -> normalized sum of both face normals.
    expect = fn[0] + fn[1]
    expect = expect / np.linalg.norm(expect)
    assert np.allclose(vn[0, 0], expect, atol=1e-6)
