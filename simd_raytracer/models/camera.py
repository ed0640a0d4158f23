"""Camera ray generation.

Vectorized version of the reference's per-pixel raster -> NDC -> screen
transform (reference: include/raytracer/render/render.hpp:36-62): center
offset (or jitter when spp > 1), aspect-ratio on x, fov scaling, then
direction = normalized(transpose(camera.matrix) * [sx, sy, -1]).

With the reference's row-major mat3 and `mat * vec` = rows-dot-vec
(core/math/mat3.hpp:53-60), transpose(M) * v == v @ M, computed here as
an explicit float32 multiply-add over the wavefront (see primary_rays).

Also carries the camera movement API (truck/pedestal/dolly/pan/tilt/roll)
from scene/camera.hpp:13-66.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from .scene import Scene


def primary_rays(scene: Scene, fov_degrees: float,
                 pix_x: jnp.ndarray, pix_y: jnp.ndarray,
                 jitter_x: jnp.ndarray, jitter_y: jnp.ndarray):
    """Generate camera rays for pixel coords (N,) + subpixel jitter (N,).

    Returns (origins (N,3), directions (N,3) normalized).
    """
    h, w = scene.height, scene.width
    dtype = scene.vertices.dtype  # f32 normally; f64 in FD-check harnesses
    aspect = jnp.asarray(w / h, dtype)
    tan_half = jnp.asarray(math.tan(math.radians(fov_degrees) / 2.0), dtype)

    raster_x = pix_x.astype(dtype) + jitter_x
    raster_y = pix_y.astype(dtype) + jitter_y
    ndc_x = raster_x / w
    ndc_y = raster_y / h
    screen_x = (2.0 * ndc_x - 1.0) * aspect * tan_half
    screen_y = (1.0 - 2.0 * ndc_y) * tan_half

    # transpose(M) @ v per ray, written as an explicit f32 multiply-add:
    # a (N,3)@(3,3) jnp.dot at default precision may run on the GPU's
    # tensor cores in TF32 (~1e-3 relative), and the 1/r^2 light falloff
    # amplifies that direction error past 1%.
    m = scene.cam_mat
    dirs = jnp.stack([
        screen_x * m[0, 0] + screen_y * m[1, 0] - m[2, 0],
        screen_x * m[0, 1] + screen_y * m[1, 1] - m[2, 1],
        screen_x * m[0, 2] + screen_y * m[1, 2] - m[2, 2],
    ], axis=-1)
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = jnp.broadcast_to(scene.cam_pos, dirs.shape)
    return origins, dirs


# --- camera movement API (host-side, numpy; scene/camera.hpp:13-66) ---

def _rot(axis: str, degrees: float) -> np.ndarray:
    r = math.radians(degrees)
    c, s = math.cos(r), math.sin(r)
    if axis == "y":   # pan
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    if axis == "x":   # tilt
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    if axis == "z":   # roll
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    raise ValueError(axis)


def translate(scene: Scene, translation) -> Scene:
    """camera.hpp:13-15 — position += translation expressed in camera frame.

    (The reference's `vec3 * mat3` would not even compile if instantiated;
    the intended math is the row-vector product translation @ matrix.)
    """
    t = np.asarray(translation, np.float32)
    m = np.asarray(scene.cam_mat)
    return scene.replace(cam_pos=jnp.asarray(np.asarray(scene.cam_pos)
                                             + t @ m))


def truck(scene: Scene, dist: float) -> Scene:
    return translate(scene, [dist, 0, 0])


def pedestal(scene: Scene, dist: float) -> Scene:
    return translate(scene, [0, dist, 0])


def dolly(scene: Scene, dist: float) -> Scene:
    return translate(scene, [0, 0, dist])


# Rotations compose on the host in NumPy: a device matmul at default
# precision could run in TF32 (see primary_rays).
def _rotate(scene: Scene, axis: str, degrees: float) -> Scene:
    return scene.replace(cam_mat=jnp.asarray(
        _rot(axis, degrees) @ np.asarray(scene.cam_mat, np.float32)))


def pan(scene: Scene, degrees: float) -> Scene:
    return _rotate(scene, "y", degrees)


def tilt(scene: Scene, degrees: float) -> Scene:
    return _rotate(scene, "x", degrees)


def roll(scene: Scene, degrees: float) -> Scene:
    return _rotate(scene, "z", degrees)
