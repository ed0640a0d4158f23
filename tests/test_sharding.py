"""Sharding tests on the 8-device virtual CPU mesh (conftest sets
xla_force_host_platform_device_count=8; SURVEY.md §4d)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from simd_raytracer import RenderConfig, parse_scene_file, render_frame
from simd_raytracer.ops.grad import split_params
from simd_raytracer.parallel.sharding import (make_mesh,
                                              render_frame_sharded,
                                              train_step_sharded)


def test_eight_virtual_devices():
    assert len(jax.devices()) >= 8


def test_sharded_render_matches_single_device(scenes):
    scene = parse_scene_file(str(scenes / "mixed.crtscene")).replace(
        height=16, width=24)
    cfg = RenderConfig(chunk_size=64, max_ray_depth=3)
    ref = np.asarray(render_frame(scene, cfg))
    mesh = make_mesh(8)
    got = np.asarray(render_frame_sharded(scene, cfg, mesh))
    # Sharding must not change the image (determinism across shardings —
    # the analog of the reference's disjoint-tile race freedom,
    # SURVEY.md §5 race detection).
    assert np.allclose(ref, got, atol=1e-6), np.abs(ref - got).max()


def test_sharded_render_various_mesh_sizes(scenes):
    scene = parse_scene_file(str(scenes / "diffuse_room.crtscene")).replace(
        height=8, width=8)
    cfg = RenderConfig(chunk_size=16, max_ray_depth=2)
    imgs = []
    for nd in (1, 2, 4, 8):
        mesh = make_mesh(nd)
        imgs.append(np.asarray(render_frame_sharded(scene, cfg, mesh)))
    for im in imgs[1:]:
        assert np.allclose(imgs[0], im, atol=1e-6)


def test_sharded_train_step_runs_and_agrees(scenes):
    scene = parse_scene_file(str(scenes / "diffuse_room.crtscene")).replace(
        height=8, width=8)
    cfg = RenderConfig(chunk_size=8, max_ray_depth=2)
    params, skeleton = split_params(scene)
    nd = 8
    per_dev = 8
    mesh = make_mesh(nd)
    ids = jnp.arange(nd * per_dev, dtype=jnp.int32).reshape(nd, per_dev)
    target = jnp.zeros((nd, per_dev, 3), jnp.float32)
    seeds = jnp.zeros((nd, 1), jnp.uint32)
    new_params, loss = train_step_sharded(
        params, skeleton, cfg, mesh, ids, target, seeds, lr=1e-3)
    assert np.isfinite(float(loss))
    # params actually moved
    moved = any(
        not np.allclose(np.asarray(params[k]), np.asarray(new_params[k]))
        for k in params)
    assert moved
