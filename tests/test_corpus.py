"""Stand-in corpus smoke test: every generated scene parses and renders
finite, non-degenerate output at tiny resolution, and scene files that
lack a key the reference loader requires are rejected.

The reference rejects scenes missing any of settings/camera/lights/
materials/objects: simdjson DOM iteration over a missing field throws
(loader.hpp:246,256,260); scenes before hw09 predate materials."""

import json

import numpy as np
import pytest

from simd_raytracer import RenderConfig, parse_scene_file, render_frame
from simd_raytracer.models.scenegen import SMALL, scene_doc

REQUIRED = ("settings", "camera", "lights", "materials", "objects")


@pytest.mark.parametrize("name", SMALL)
def test_scene_loads_and_renders(scenes, name):
    scene = parse_scene_file(str(scenes / f"{name}.crtscene"))
    assert scene.num_triangles >= 1
    assert scene.height > 0 and scene.width > 0
    small = scene.replace(height=6, width=8)
    # depth 1 keeps compile fast; one shared config -> one compile for
    # all same-shaped scenes.
    cfg = RenderConfig(chunk_size=64, max_ray_depth=1)
    img = np.asarray(render_frame(small, cfg))
    assert np.isfinite(img).all(), name
    assert (img >= 0).all(), name
    assert img.std() > 0, name


def _without(tmp_path, key):
    doc, _ = scene_doc("diffuse")
    del doc[key]
    path = tmp_path / f"no_{key}.crtscene"
    path.write_text(json.dumps(doc))
    return str(path)


def test_pre_material_scenes_rejected(tmp_path):
    # hw07/hw08-style scenes lack `materials` -> the loader must raise
    # like the reference (simdjson DOM throw at loader.hpp:256).
    with pytest.raises(ValueError):
        parse_scene_file(_without(tmp_path, "materials"))


@pytest.mark.parametrize("key", REQUIRED)
def test_incomplete_scenes_rejected(tmp_path, key):
    with pytest.raises(ValueError):
        parse_scene_file(_without(tmp_path, key))
