"""Native (C++) runtime components vs their Python oracles.

The kd-tree builder, scene loader, and PPM encoder in native/ must produce
bit-identical output to the Python implementations (SURVEY.md §2: every
reference component is native C++; ours keep native implementations with
Python fallbacks).  Skipped when the shared library isn't built.
"""

import numpy as np
import pytest

from simd_raytracer import native as native_mod


def _ensure_lib():
    if not native_mod.native_available():
        if not native_mod.build_native():
            pytest.skip("native toolchain unavailable")


def test_native_kdtree_matches_numpy(scenes):
    _ensure_lib()
    from simd_raytracer import parse_scene_file
    from simd_raytracer.accel.build import (build_kdtree,
                                            triangle_aabbs)
    from simd_raytracer.native import native_build_kdtree

    for rel in ("dragon_glass.crtscene", "room.crtscene"):
        scene = parse_scene_file(str(scenes / rel))
        tri_min, tri_max = triangle_aabbs(np.asarray(scene.vertices),
                                          np.asarray(scene.tri_vidx))
        valid = np.asarray(scene.tri_valid)
        py = build_kdtree(tri_min, tri_max, valid)
        cc = native_build_kdtree(tri_min, tri_max, valid, 8, 64,
                                 required=True)
        for field in ("node_min", "node_max", "child0", "child1",
                      "leaf_id", "leaf_tris"):
            a = np.asarray(getattr(py, field))
            b = np.asarray(getattr(cc, field))
            assert a.shape == b.shape, (rel, field, a.shape, b.shape)
            assert np.array_equal(a, b), (rel, field)


def test_native_loader_matches_python(scenes):
    _ensure_lib()
    from simd_raytracer import parse_scene_file
    import jax

    for rel in ("dragon_glass.crtscene", "textures.crtscene",
                "room.crtscene"):
        py = parse_scene_file(str(scenes / rel), use_native=False)
        cc = parse_scene_file(str(scenes / rel), use_native=True)
        leaves_py, treedef_py = jax.tree_util.tree_flatten(py)
        leaves_cc, treedef_cc = jax.tree_util.tree_flatten(cc)
        assert treedef_py == treedef_cc
        for a, b in zip(leaves_py, leaves_cc):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        assert (py.height, py.width, py.bucket_size) == \
               (cc.height, cc.width, cc.bucket_size)


def test_native_loader_error_on_malformed(tmp_path):
    _ensure_lib()
    from simd_raytracer import parse_scene_file

    bad = tmp_path / "bad.crtscene"
    bad.write_text('{"settings": {"image_settings": {"height": 4}}}')
    with pytest.raises(ValueError):
        parse_scene_file(str(bad), use_native=True)


def test_native_ppm_matches_python():
    _ensure_lib()
    from simd_raytracer.native import native_ppm_encode
    from simd_raytracer.utils.ppm import ppm_bytes

    rng = np.random.default_rng(3)
    img = rng.uniform(-0.2, 1.2, size=(17, 23, 3)).astype(np.float32)
    py = ppm_bytes(img, use_native=False)
    cc = native_ppm_encode(img)
    assert cc == py
