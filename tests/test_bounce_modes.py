"""Roulette bounce mode (unbiased single-child sampling) vs the exact
split path."""

import numpy as np

from simd_raytracer import RenderConfig, parse_scene_file, render_frame


def test_roulette_matches_split_in_expectation(scenes):
    # hw11/scene2 has a refractive sphere: roulette stochastically picks
    # reflect/refract per bounce; averaged over many spp the image must
    # converge to the deterministic split render (unbiased estimator).
    # Both renders use the SAME spp/chunking so the pixel jitter sequence
    # is identical — the only difference is the roulette coin.
    scene = parse_scene_file(str(scenes / "glass.crtscene")).replace(
        height=12, width=16)
    spp = 64
    split = np.asarray(render_frame(
        scene, RenderConfig(chunk_size=4096, max_ray_depth=3,
                            samples_per_pixel=spp)))
    rr = np.asarray(render_frame(
        scene, RenderConfig(chunk_size=4096, max_ray_depth=3,
                            samples_per_pixel=spp,
                            bounce_mode="roulette")))
    # Monte-Carlo tolerance: refractive paths carry weight <= 1 and the
    # coin variance shrinks as 1/sqrt(spp); direct-light pixels are exact.
    scale = np.maximum(1.0, np.abs(split))
    err = np.abs(rr - split) / scale
    assert np.median(err) < 0.01, float(np.median(err))
    assert err.mean() < 0.03, float(err.mean())


def test_roulette_identical_when_no_branching(scenes):
    # All-diffuse scene with gi=0: every ray has at most one child, so
    # roulette IS split (no coin ever matters) -> bitwise identical.
    scene = parse_scene_file(str(scenes / "diffuse.crtscene")).replace(
        height=16, width=20)
    a = np.asarray(render_frame(
        scene, RenderConfig(chunk_size=512, max_ray_depth=3)))
    b = np.asarray(render_frame(
        scene, RenderConfig(chunk_size=512, max_ray_depth=3,
                            bounce_mode="roulette")))
    assert np.array_equal(a, b)
