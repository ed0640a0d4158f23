"""Tile schedules (reference tile/*.hpp parity) + progressive checkpoint
rendering (SURVEY.md §5 checkpoint/resume)."""

import numpy as np
import pytest

from simd_raytracer import RenderConfig, parse_scene_file, render_frame
from simd_raytracer.parallel.tiles import (RenderTile, SchedulingType,
                                           bucket_schedule,
                                           make_schedule,
                                           region_schedule,
                                           single_schedule,
                                           schedule_to_chunks,
                                           tile_ray_ids)


def test_single_schedule_is_whole_image():
    tiles = single_schedule(13, 29)
    assert tiles == [RenderTile(0, 0, 29, 13)]


def test_bucket_schedule_covers_image_exactly_once():
    h, w, b = 50, 70, 24    # hw15/scene2 uses bucket 24
    tiles = bucket_schedule(h, w, b)
    cover = np.zeros((h, w), np.int32)
    for t in tiles:
        cover[t.y0:t.y1, t.x0:t.x1] += 1
    assert (cover == 1).all()
    # interior tiles are bucket-sized
    assert tiles[0] == RenderTile(0, 0, 24, 24)


def test_region_schedule_covers_image_exactly_once():
    tiles = region_schedule(33, 47, workers=9)
    cover = np.zeros((33, 47), np.int32)
    for t in tiles:
        cover[t.y0:t.y1, t.x0:t.x1] += 1
    assert (cover == 1).all()


def test_schedule_to_chunks_is_a_permutation():
    h, w, spp, chunk = 16, 24, 2, 64
    total = h * w * spp
    tiles = make_schedule(SchedulingType.BUCKET_TILES, h, w, bucket=10)
    ids = schedule_to_chunks(tiles, w, spp, chunk, total)
    flat = ids.reshape(-1)
    real = np.sort(flat[flat < total])
    assert np.array_equal(real, np.arange(total))


def test_tile_ray_ids_match_convention():
    ids = tile_ray_ids(RenderTile(2, 1, 4, 2), width=8, spp=2)
    # pixels (y=1,x=2)->10 and (y=1,x=3)->11; ids = pix*2 + s
    assert ids.tolist() == [20, 21, 22, 23]


def test_bucket_render_matches_linear(scenes):
    scene = parse_scene_file(str(scenes / "mixed.crtscene")).replace(
        height=16, width=20)
    cfg = RenderConfig(chunk_size=128, max_ray_depth=2)
    a = np.asarray(render_frame(scene, cfg))
    b = np.asarray(render_frame(scene, cfg,
                                scheduling=SchedulingType.BUCKET_TILES))
    assert np.array_equal(a, b)     # spp=1 is jitter-free -> identical


def test_progressive_checkpoint_resume(scenes, tmp_path):
    from simd_raytracer.utils.checkpoint import render_progressive

    scene = parse_scene_file(str(scenes / "mixed.crtscene")).replace(
        height=10, width=12)
    cfg = RenderConfig(chunk_size=256, max_ray_depth=2,
                       samples_per_pixel=1)
    ck = str(tmp_path / "render.ckpt.npz")

    full = render_progressive(scene, cfg, total_spp=4, spp_per_batch=2)

    # run 1: interrupt after the first batch via the progress hook
    class Stop(Exception):
        pass

    def interrupt(done, _img):
        if done >= 2:
            raise Stop

    with pytest.raises(Stop):
        render_progressive(scene, cfg, total_spp=4, spp_per_batch=2,
                           checkpoint_path=ck, on_batch=interrupt)
    state = np.load(ck)
    assert int(state["samples_done"]) == 2

    # run 2: resumes batch 1 and produces the identical final image
    resumed = render_progressive(scene, cfg, total_spp=4, spp_per_batch=2,
                                 checkpoint_path=ck)
    np.testing.assert_allclose(resumed, full, rtol=0, atol=1e-7)

    # run 3: a config change invalidates the fingerprint — the restart
    # must WARN instead of silently discarding the buffer.
    other = RenderConfig(chunk_size=256, max_ray_depth=1,
                         samples_per_pixel=1)
    with pytest.warns(UserWarning, match="different scene/config"):
        render_progressive(scene, other, total_spp=2, spp_per_batch=2,
                           checkpoint_path=ck)
