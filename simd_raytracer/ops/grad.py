"""Differentiable rendering API: losses and inverse-rendering steps.

The reference has no gradients at all; this is the capability extension
demanded by BASELINE.json's north star: pixel gradients w.r.t.
vertices, albedo, IOR, texture texels, lights and background, obtained by
jax.grad through the wavefront render (visibility/argmin treated as
piecewise constant via stop_gradient — see ops/intersect.py).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..models.scene import Scene, derive_geometry
from .render import render_chunk

# Scene leaves that make sense to differentiate.
DIFF_PARAM_NAMES = (
    "vertices", "uv", "mat_albedo", "mat_ior",
    "tex_color_a", "tex_color_b", "tex_param", "atlas",
    "light_pos", "light_intensity", "background",
)


def split_params(scene: Scene) -> Tuple[Dict[str, jnp.ndarray], Scene]:
    """Split a scene into (differentiable params dict, scene skeleton)."""
    params = {k: getattr(scene, k) for k in DIFF_PARAM_NAMES}
    return params, scene


def merge_params(params: Dict[str, jnp.ndarray], skeleton: Scene) -> Scene:
    return skeleton.replace(**params)


def render_ids(scene: Scene, cfg: RenderConfig, ids: jnp.ndarray,
               key: jax.Array, accel=None) -> jnp.ndarray:
    """Differentiable colors for a flat batch of ray ids: (N,) -> (N, 3)."""
    geom = derive_geometry(scene)
    return render_chunk(scene, geom, cfg, ids, key, accel)


def pixel_loss(params: Dict[str, jnp.ndarray], skeleton: Scene,
               cfg: RenderConfig, ids: jnp.ndarray, target: jnp.ndarray,
               key: jax.Array, accel=None) -> jnp.ndarray:
    """Mean squared error between rendered ray colors and target colors.

    With cfg.intersector == "kdtree", pass the (host-built) accel; its
    topology is frozen — gradients flow through the winning triangles'
    intersection math, not the tree (SURVEY.md §7 hard part (b)).
    """
    scene = merge_params(params, skeleton)
    colors = render_ids(scene, cfg, ids, key, accel)
    return jnp.mean((colors - target) ** 2)


@functools.partial(jax.jit, static_argnames=("cfg",))
def loss_and_grad(params, skeleton: Scene, cfg: RenderConfig,
                  ids, target, key, accel=None):
    return jax.value_and_grad(pixel_loss)(
        params, skeleton, cfg, ids, target, key, accel)


@functools.partial(jax.jit, static_argnames=("cfg", "lr"))
def train_step(params, skeleton: Scene, cfg: RenderConfig,
               ids, target, key, lr: float = 1e-2, accel=None):
    """One SGD inverse-rendering step on the differentiable scene params."""
    loss, grads = jax.value_and_grad(pixel_loss)(
        params, skeleton, cfg, ids, target, key, accel)
    params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
    return params, loss


@functools.partial(jax.jit, static_argnames=("cfg", "lr", "n_steps"),
                   donate_argnums=(0,))
def train_steps(params, skeleton: Scene, cfg: RenderConfig,
                ids, target, key, lr: float = 1e-2, n_steps: int = 8,
                accel=None):
    """n_steps SGD steps inside ONE executable -> (params, losses).

    A lax.scan over steps with the param buffers donated: one dispatch
    and one readback for all steps.  Step i draws its estimator
    randomness from split(key)[i].
    """
    keys = jax.random.split(key, n_steps)

    def one(params, k):
        loss, grads = jax.value_and_grad(pixel_loss)(
            params, skeleton, cfg, ids, target, k, accel)
        params = jax.tree_util.tree_map(lambda p, g: p - lr * g,
                                        params, grads)
        return params, loss

    return jax.lax.scan(one, params, keys)
