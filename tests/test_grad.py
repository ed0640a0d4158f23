"""Gradient tests: analytic pixel gradients vs finite differences
(BASELINE.json correctness bar; SURVEY.md §7 step 5).

The render is dtype-polymorphic (compute dtype follows scene.vertices), so
the FD comparison runs in float64 under jax.experimental.enable_x64 —
float32 losses cannot resolve gradients this small against FD noise.
Visibility is piecewise constant and argmin winners are stop-gradiented,
so gradients are exact only where the winner set is FD-stable; interior
configurations are used throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import enable_x64

from simd_raytracer import RenderConfig, parse_scene_file
from simd_raytracer.ops.grad import (merge_params, pixel_loss,
                                     split_params, train_step)


def to_x64(tree):
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x,
        tree)


def setup(scenes, name="mixed", h=12, w=16, cfg=None):
    cfg = cfg or RenderConfig(chunk_size=h * w, max_ray_depth=3)
    scene = parse_scene_file(str(scenes / f"{name}.crtscene")).replace(
        height=h, width=w)
    scene = to_x64(scene)
    params, skeleton = split_params(scene)
    ids = jnp.arange(h * w, dtype=jnp.int32)
    key = jax.random.PRNGKey(7)
    return params, skeleton, cfg, ids, key


def fd_check(params, skeleton, cfg, ids, target, key, name, flat_index,
             h=1e-5, rtol=5e-4, atol=1e-9):
    loss = jax.jit(lambda p: pixel_loss(p, skeleton, cfg, ids, target, key))
    g = jax.jit(jax.grad(lambda p: pixel_loss(
        p, skeleton, cfg, ids, target, key)))(params)[name]
    g_val = float(np.asarray(g).ravel()[flat_index])

    def perturbed(delta):
        p = dict(params)
        arr = np.asarray(params[name]).copy()
        arr.ravel()[flat_index] += delta
        p[name] = jnp.asarray(arr)
        return float(loss(p))

    fd = (perturbed(h) - perturbed(-h)) / (2 * h)
    assert np.isclose(g_val, fd, rtol=rtol, atol=max(atol, abs(fd) * rtol)), (
        f"{name}[{flat_index}]: analytic {g_val:.6g} vs fd {fd:.6g}")
    return g_val


def test_albedo_gradient_matches_fd(scenes):
    with enable_x64():
        params, skeleton, cfg, ids, key = setup(scenes)
        target = jnp.zeros((ids.shape[0], 3))
        # albedo of material 0 (diffuse), red channel
        fd_check(params, skeleton, cfg, ids, target, key, "mat_albedo", 0)


def test_light_intensity_gradient_matches_fd(scenes):
    with enable_x64():
        params, skeleton, cfg, ids, key = setup(scenes)
        target = jnp.zeros((ids.shape[0], 3))
        fd_check(params, skeleton, cfg, ids, target, key,
                 "light_intensity", 0, h=1e-4)


def test_light_position_gradient_matches_fd(scenes):
    with enable_x64():
        params, skeleton, cfg, ids, key = setup(scenes)
        target = jnp.zeros((ids.shape[0], 3))
        fd_check(params, skeleton, cfg, ids, target, key, "light_pos", 1)


def test_vertex_gradient_matches_fd(scenes):
    with enable_x64():
        params, skeleton, cfg, ids, key = setup(scenes)
        target = jnp.zeros((ids.shape[0], 3))
        # Nudge a vertex along z (depth).  FD step must dodge discrete
        # boundaries: at h=1e-5 this scene crosses an argmin-winner flip
        # (visibility is piecewise constant under stop_gradient) and FD
        # reads the jump, while h=1e-4 and h=1e-6 both agree with the
        # analytic value to ~1e-7 relative.
        fd_check(params, skeleton, cfg, ids, target, key, "vertices", 2,
                 h=1e-4, rtol=2e-3)


def test_background_gradient_matches_fd(scenes):
    with enable_x64():
        params, skeleton, cfg, ids, key = setup(scenes)
        target = jnp.zeros((ids.shape[0], 3))
        fd_check(params, skeleton, cfg, ids, target, key, "background", 1)


def test_ior_gradient_matches_fd(scenes):
    # hw11/scene1 has a refractive material; IOR gradients flow through
    # the Snell/Fresnel math (render.hpp:252-301 equivalents).
    with enable_x64():
        params, skeleton, cfg, ids, key = setup(scenes)
        target = jnp.zeros((ids.shape[0], 3))
        mat_tags = np.asarray(skeleton.mat_tag)
        refr = int(np.where(mat_tags == 2)[0][0])
        fd_check(params, skeleton, cfg, ids, target, key, "mat_ior", refr,
                 rtol=2e-3)


def test_texture_param_gradients_flow(scenes):
    # hw12/scene4 exercises all four texture types; texel/uv/color grads.
    with enable_x64():
        params, skeleton, cfg, ids, key = setup(scenes, "textures",
                                                h=10, w=16)
        target = jnp.zeros((ids.shape[0], 3))
        g = jax.jit(jax.grad(lambda p: pixel_loss(
            p, skeleton, cfg, ids, target, key)))(params)
        assert float(np.abs(np.asarray(g["tex_color_a"])).max()) > 0
        assert float(np.abs(np.asarray(g["atlas"])).max()) > 0
        fd_check(params, skeleton, cfg, ids, target, key, "tex_color_a", 0)


def test_train_step_reduces_loss(scenes):
    params, skeleton, cfg, ids, key = setup(scenes)
    # target: the same scene with darker albedo -> recoverable by SGD
    bright = dict(params)
    bright["mat_albedo"] = params["mat_albedo"] * 0.5
    from simd_raytracer.ops.grad import render_ids
    target = render_ids(merge_params(bright, skeleton), cfg, ids, key)

    p = params
    losses = []
    for step in range(5):
        p, loss = train_step(p, skeleton, cfg, ids, target, key, lr=2e-3)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


def test_train_steps_matches_unrolled_single_steps(scenes):
    # The pipelined scan (one executable, donated params) must walk the
    # exact same optimization trajectory as n composed single steps fed
    # the same per-step keys.
    from simd_raytracer.ops.grad import train_steps

    params, skeleton, cfg, ids, key = setup(scenes)
    bright = dict(params)
    bright["mat_albedo"] = params["mat_albedo"] * 0.5
    from simd_raytracer.ops.grad import render_ids
    target = render_ids(merge_params(bright, skeleton), cfg, ids, key)

    n_steps = 3
    keys = jax.random.split(key, n_steps)
    p_ref = params
    ref_losses = []
    for i in range(n_steps):
        p_ref, loss = train_step(p_ref, skeleton, cfg, ids, target,
                                 keys[i], lr=2e-3)
        ref_losses.append(float(loss))

    p0 = jax.tree_util.tree_map(jnp.array, params)   # donation-safe copy
    p_scan, losses = train_steps(p0, skeleton, cfg, ids, target, key,
                                 lr=2e-3, n_steps=n_steps)
    np.testing.assert_allclose(np.asarray(losses), ref_losses, rtol=1e-6)
    for k in p_ref:
        np.testing.assert_allclose(np.asarray(p_scan[k]),
                                   np.asarray(p_ref[k]), rtol=1e-6,
                                   atol=1e-12)
