"""Animation rendering: camera paths -> frame sequences
(utils/animation.py; the capability behind the reference's published
orbit video, reference README.md:60-65)."""

import numpy as np
import pytest

from simd_raytracer import RenderConfig, parse_scene_file
from simd_raytracer.utils.animation import (dolly_path, orbit_path,
                                            render_animation)


@pytest.fixture
def scene(scenes):
    return parse_scene_file(str(scenes / "mixed.crtscene")).replace(
        height=10, width=12)


def test_orbit_path_preserves_distance_and_closes(scene):
    center = np.asarray(scene.vertices).mean(axis=0)
    frames = list(orbit_path(scene, n_frames=8))
    assert len(frames) == 8
    r0 = np.linalg.norm(np.asarray(scene.cam_pos) - center)
    for f in frames:
        # turntable: distance to the centroid is invariant
        r = np.linalg.norm(np.asarray(f.cam_pos) - center)
        np.testing.assert_allclose(r, r0, rtol=1e-5)
        # orientation stays orthonormal
        m = np.asarray(f.cam_mat)
        np.testing.assert_allclose(m @ m.T, np.eye(3), atol=1e-5)
    # frame 0 is the original camera
    np.testing.assert_allclose(np.asarray(frames[0].cam_pos),
                               np.asarray(scene.cam_pos), atol=1e-6)


def test_render_animation_writes_distinct_frames(tmp_path, scene):
    cfg = RenderConfig(chunk_size=256, max_ray_depth=1)
    frames = render_animation(orbit_path(scene, n_frames=3), cfg,
                              out_dir=str(tmp_path), prefix="orbit")
    assert len(frames) == 3
    assert all(f.shape == (10, 12, 3) for f in frames)
    # the camera moved, so the rendered images differ
    assert not np.array_equal(frames[0], frames[1])
    ppms = sorted(p.name for p in tmp_path.iterdir())
    assert ppms == ["orbit_0000.ppm", "orbit_0001.ppm", "orbit_0002.ppm"]
    # frames are valid P3 PPMs at the scene resolution
    head = (tmp_path / "orbit_0000.ppm").read_text().split()
    assert head[0] == "P3" and head[1] == "12" and head[2] == "10"


def test_dolly_path_moves_along_view_axis(scene):
    frames = list(dolly_path(scene, n_frames=3, total_dist=1.0))
    p0 = np.asarray(frames[0].cam_pos)
    p2 = np.asarray(frames[2].cam_pos)
    assert np.linalg.norm(p2 - p0) > 0.49   # moved ~2 steps of 0.5
    # movement is purely along the camera's view axis (third row of the
    # orientation matrix, models/camera.py dolly semantics)
    step = p2 - p0
    view = np.asarray(scene.cam_mat)[2]
    cos = abs(step @ view) / (np.linalg.norm(step) * np.linalg.norm(view))
    np.testing.assert_allclose(cos, 1.0, atol=1e-5)
