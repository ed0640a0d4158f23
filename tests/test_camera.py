"""Camera movement API (reference scene/camera.hpp:13-66) + animation."""

import numpy as np
import pytest

from simd_raytracer import RenderConfig, parse_scene_file, render_frame
from simd_raytracer.models import camera as cam


@pytest.fixture(scope="module")
def scene(scenes):
    return parse_scene_file(str(scenes / "mixed.crtscene")).replace(
        height=10, width=12)


def test_translate_is_camera_frame(scene):
    # translation expressed in camera space: moving right follows the
    # camera's first basis row.
    s2 = cam.truck(scene, 2.0)
    delta = np.asarray(s2.cam_pos) - np.asarray(scene.cam_pos)
    expected = 2.0 * np.asarray(scene.cam_mat)[0]
    np.testing.assert_allclose(delta, expected, atol=1e-6)


def test_pan_tilt_roll_preserve_orthonormality(scene):
    s2 = cam.roll(cam.tilt(cam.pan(scene, 33.0), -20.0), 7.0)
    m = np.asarray(s2.cam_mat)
    np.testing.assert_allclose(m @ m.T, np.eye(3), atol=1e-5)


def test_pan_changes_render(scene):
    cfg = RenderConfig(chunk_size=128, max_ray_depth=1)
    a = np.asarray(render_frame(scene, cfg))
    b = np.asarray(render_frame(cam.pan(scene, 30.0), cfg))
    assert not np.array_equal(a, b)


def test_dolly_moves_along_view_axis(scene):
    s2 = cam.dolly(scene, -1.0)
    delta = np.asarray(s2.cam_pos) - np.asarray(scene.cam_pos)
    expected = -1.0 * np.asarray(scene.cam_mat)[2]
    np.testing.assert_allclose(delta, expected, atol=1e-6)


def test_orbit_animation_renders(tmp_path, scene):
    from simd_raytracer.utils.animation import (orbit_path,
                                                render_animation)

    cfg = RenderConfig(chunk_size=128, max_ray_depth=1)
    frames = render_animation(orbit_path(scene, 3), cfg,
                              out_dir=str(tmp_path))
    assert len(frames) == 3
    assert (tmp_path / "frame_0002.ppm").exists()
    # orbiting actually moves the viewpoint
    assert not np.array_equal(frames[0], frames[1])
