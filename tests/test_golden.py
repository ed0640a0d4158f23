"""Golden-image tests: the wavefront renderer vs the scalar NumPy oracle
(tests/oracle.py replicates the C++ reference semantics; SURVEY.md §4).

Rendered at tiny resolutions so the per-pixel recursive oracle stays cheap.
Comparison is in linear color with an fp32-reassociation tolerance plus an
escape hatch for a few silhouette pixels where the discrete winner triangle
differs between implementations (SURVEY.md §7 hard part (d))."""

import numpy as np
import pytest

import oracle
from simd_raytracer import RenderConfig, parse_scene_file, render_frame


def compare(scenes, name, h, w, cfg=None, max_bad_frac=0.02, atol=2e-3):
    cfg = cfg or RenderConfig(chunk_size=1024)
    scene = parse_scene_file(str(scenes / f"{name}.crtscene"))
    scene = scene.replace(height=h, width=w)
    got = np.asarray(render_frame(scene, cfg))
    want = oracle.render(scene, cfg, res=(h, w))
    # tolerance relative to local magnitude (direct light can be >> 1)
    scale = np.maximum(1.0, np.abs(want))
    bad = np.abs(got - want) > (atol * scale)
    bad_frac = bad.any(axis=-1).mean()
    assert bad_frac <= max_bad_frac, (
        f"{name}: {bad_frac:.3%} pixels differ; "
        f"max abs diff {np.abs(got - want).max():.4f}")


def test_diffuse_simple(scenes):
    compare(scenes, "diffuse", 24, 32)


def test_diffuse_room(scenes):
    compare(scenes, "diffuse_room", 24, 32)


def test_refractive_simple(scenes):
    # 3% budget: refraction amplifies sub-ulp direction differences into
    # discrete winner flips at the sphere silhouette (17/768 pixels on
    # CPU, all background-vs-object or swapped refraction targets).
    compare(scenes, "glass", 24, 32, max_bad_frac=0.03)


def test_refractive_mid(scenes):
    compare(scenes, "prism", 20, 26)


def test_textures_all_four(scenes):
    compare(scenes, "textures", 24, 40)


def test_hw15_scene2_full_materials(scenes):
    compare(scenes, "room", 24, 24)


def test_reflective(scenes):
    compare(scenes, "mirror", 20, 26)


def test_march_occlusion_matches_fast(scenes):
    cfg_fast = RenderConfig(chunk_size=1024, occlusion_mode="fast")
    cfg_march = RenderConfig(chunk_size=1024, occlusion_mode="march")
    scene = parse_scene_file(str(scenes / "glass.crtscene"))
    scene = scene.replace(height=20, width=26)
    a = np.asarray(render_frame(scene, cfg_fast))
    b = np.asarray(render_frame(scene, cfg_march))
    scale = np.maximum(1.0, np.abs(b))
    assert (np.abs(a - b) <= 2e-3 * scale).mean() > 0.99


def test_determinism(scenes):
    cfg = RenderConfig(chunk_size=512)
    scene = parse_scene_file(str(scenes / "mixed.crtscene"))
    scene = scene.replace(height=16, width=16)
    a = np.asarray(render_frame(scene, cfg))
    b = np.asarray(render_frame(scene, cfg))
    assert (a == b).all()
