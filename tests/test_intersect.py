"""Moller-Trumbore intersection unit tests against hand-computed cases
(semantics per reference scene/primitive/triangle.hpp:32-67 and
kd_tree_simd.hpp:26-60)."""

import jax
import jax.numpy as jnp
import numpy as np

from simd_raytracer.ops.intersect import mt_refine, mt_select

EPS = 1e-6


def tri_arrays(tris):
    """tris: list of (v0, v1, v2) -> v0, e1, e2 arrays."""
    v0 = jnp.array([t[0] for t in tris], jnp.float32)
    v1 = jnp.array([t[1] for t in tris], jnp.float32)
    v2 = jnp.array([t[2] for t in tris], jnp.float32)
    return v0, v1 - v0, v2 - v0


def test_simple_hit():
    v0, e1, e2 = tri_arrays([([-1, -1, -5], [1, -1, -5], [0, 1, -5])])
    o = jnp.zeros((1, 3))
    d = jnp.array([[0.0, 0.0, -1.0]])
    idx, hit = mt_select(o, d, v0, e1, e2, EPS, cull=False)
    assert bool(hit[0]) and int(idx[0]) == 0
    t, u, v = mt_refine(o, d, v0[idx], e1[idx], e2[idx])
    assert np.isclose(float(t[0]), 5.0, atol=1e-5)
    # Barycentric of the centroid-ish point (0,0): u at v1, v at v2.
    assert 0.0 <= float(u[0]) <= 1.0 and 0.0 <= float(v[0]) <= 1.0


def test_miss_outside():
    v0, e1, e2 = tri_arrays([([-1, -1, -5], [1, -1, -5], [0, 1, -5])])
    o = jnp.array([[5.0, 5.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    _, hit = mt_select(o, d, v0, e1, e2, EPS, cull=False)
    assert not bool(hit[0])


def test_backface_culling():
    # Counter-clockwise triangle seen from +z: normal points toward +z.
    # A ray travelling -z sees the front face => det > 0 both modes hit.
    # Flip winding => back face => culled only with cull=True.
    front = [([-1, -1, -5], [1, -1, -5], [0, 1, -5])]
    back = [([-1, -1, -5], [0, 1, -5], [1, -1, -5])]
    o = jnp.zeros((1, 3))
    d = jnp.array([[0.0, 0.0, -1.0]])
    for tris, cull, expect in [(front, True, True), (front, False, True),
                               (back, True, False), (back, False, True)]:
        v0, e1, e2 = tri_arrays(tris)
        _, hit = mt_select(o, d, v0, e1, e2, EPS, cull=cull)
        assert bool(hit[0]) == expect, (tris, cull)


def test_closest_of_many():
    v0, e1, e2 = tri_arrays([
        ([-1, -1, -9], [1, -1, -9], [0, 1, -9]),
        ([-1, -1, -4], [1, -1, -4], [0, 1, -4]),
        ([-1, -1, -7], [1, -1, -7], [0, 1, -7]),
    ])
    o = jnp.zeros((1, 3))
    d = jnp.array([[0.0, 0.0, -1.0]])
    idx, hit = mt_select(o, d, v0, e1, e2, EPS, cull=False)
    assert bool(hit[0]) and int(idx[0]) == 1


def test_tri_mask_excludes():
    v0, e1, e2 = tri_arrays([
        ([-1, -1, -4], [1, -1, -4], [0, 1, -4]),
        ([-1, -1, -7], [1, -1, -7], [0, 1, -7]),
    ])
    o = jnp.zeros((1, 3))
    d = jnp.array([[0.0, 0.0, -1.0]])
    mask = jnp.array([False, True])
    idx, hit = mt_select(o, d, v0, e1, e2, EPS, cull=False, tri_mask=mask)
    assert bool(hit[0]) and int(idx[0]) == 1


def test_degenerate_triangle_never_hits():
    v0 = jnp.zeros((1, 3))
    e1 = jnp.zeros((1, 3))
    e2 = jnp.zeros((1, 3))
    o = jnp.zeros((1, 3))
    d = jnp.array([[0.0, 0.0, -1.0]])
    _, hit = mt_select(o, d, v0, e1, e2, EPS, cull=False)
    assert not bool(hit[0])


def test_t_epsilon_reject():
    # Triangle right at the origin: t ~ 0 < eps -> reject (t > eps test).
    v0, e1, e2 = tri_arrays([([-1, -1, 0], [1, -1, 0], [0, 1, 0])])
    o = jnp.zeros((1, 3))
    d = jnp.array([[0.0, 0.0, -1.0]])
    _, hit = mt_select(o, d, v0, e1, e2, EPS, cull=False)
    assert not bool(hit[0])


def test_refine_matches_select_and_is_differentiable():
    tris = [([-1.0, -1.0, -5.0], [1.0, -0.5, -5.5], [0.2, 1.0, -4.5])]
    v0, e1, e2 = tri_arrays(tris)
    o = jnp.array([[0.1, 0.05, 0.0]])
    d = jnp.array([[0.01, -0.02, -1.0]])
    d = d / jnp.linalg.norm(d)
    t, u, v = mt_refine(o, d, v0, e1, e2)
    # hit point on the triangle plane
    p = o + t[:, None] * d
    n = jnp.cross(e1[0], e2[0])
    assert abs(float(jnp.dot(p[0] - v0[0], n))) < 1e-5

    # d(t)/d(v0) via jax matches finite differences.
    def t_of_v0(v0x):
        vv = v0.at[0, 0].set(v0x)
        tt, _, _ = mt_refine(o, d, vv, e1, e2)
        return tt[0]

    g = jax.grad(t_of_v0)(v0[0, 0])
    h = 1e-3
    fd = (t_of_v0(v0[0, 0] + h) - t_of_v0(v0[0, 0] - h)) / (2 * h)
    assert np.isclose(float(g), float(fd), rtol=1e-2)
