"""Any-hit / t_max window contract across select backends (r5).

The occlusion predicate (reference render/render.hpp:110-131: first hit
with t <= max_t, inclusive) is implemented natively by every backend;
these tests pin all of them to the brute-force definition computed
straight from mt_pairs.
"""

import jax
import jax.numpy as jnp
import numpy as np

from simd_raytracer.ops.intersect import BIG, mt_pairs, mt_select

EPS = 1e-6


def _setup(seed=0, n_tri=96, n_ray=64):
    k = jax.random.split(jax.random.PRNGKey(seed), 6)
    v0 = jax.random.uniform(k[0], (n_tri, 3), minval=-3.0, maxval=3.0)
    e1 = jax.random.uniform(k[1], (n_tri, 3), minval=-2.0, maxval=2.0)
    e2 = jax.random.uniform(k[2], (n_tri, 3), minval=-2.0, maxval=2.0)
    o = jax.random.uniform(k[3], (n_ray, 3), minval=-1.0, maxval=1.0)
    o = o.at[:, 2].add(6.0)
    d = jax.random.normal(k[4], (n_ray, 3))
    d = d.at[:, 2].add(-2.0)
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    tmax = jax.random.uniform(k[5], (n_ray,), minval=0.5, maxval=12.0)
    mask = jnp.arange(n_tri) % 7 != 3          # exercise tri_mask too
    return o, d, v0, e1, e2, tmax, mask


def _brute(o, d, v0, e1, e2, tmax, mask):
    t, ok = mt_pairs(
        (o[:, 0:1], o[:, 1:2], o[:, 2:3]),
        (d[:, 0:1], d[:, 1:2], d[:, 2:3]),
        (v0[None, :, 0], v0[None, :, 1], v0[None, :, 2]),
        (e1[None, :, 0], e1[None, :, 1], e1[None, :, 2]),
        (e2[None, :, 0], e2[None, :, 1], e2[None, :, 2]),
        EPS, False)
    ok &= mask[None, :]
    okw = ok & (t <= tmax[:, None])
    occ = jnp.any(okw, axis=1)
    t_m = jnp.where(okw, t, BIG)
    idx = jnp.argmin(t_m, axis=1).astype(jnp.int32)
    return occ, idx


BACKENDS = {
    "jnp": mt_select,
}


def test_any_hit_matches_brute_every_backend():
    o, d, v0, e1, e2, tmax, mask = _setup()
    occ_ref, _ = _brute(o, d, v0, e1, e2, tmax, mask)
    assert 0 < int(occ_ref.sum()) < occ_ref.shape[0]   # non-trivial case
    for name, fn in BACKENDS.items():
        _, hit = fn(o, d, v0, e1, e2, EPS, False, tri_mask=mask,
                    t_max=tmax, any_hit=True)
        np.testing.assert_array_equal(np.asarray(hit),
                                      np.asarray(occ_ref), err_msg=name)


def test_windowed_closest_matches_brute():
    o, d, v0, e1, e2, tmax, mask = _setup(seed=1)
    occ_ref, idx_ref = _brute(o, d, v0, e1, e2, tmax, mask)
    for name in ("jnp",):               # the classic formulation
        idx, hit = BACKENDS[name](o, d, v0, e1, e2, EPS, False,
                                  tri_mask=mask, t_max=tmax)
        np.testing.assert_array_equal(np.asarray(hit),
                                      np.asarray(occ_ref), err_msg=name)
        np.testing.assert_array_equal(np.asarray(idx)[np.asarray(hit)],
                                      np.asarray(idx_ref)[np.asarray(hit)],
                                      err_msg=name)


def test_window_inclusive_and_zero():
    # One triangle square-on at t = 5: window 5 (inclusive) occludes,
    # window below 5 does not, zero-length window never does.
    v0 = jnp.array([[-1.0, -1.0, -5.0]])
    e1 = jnp.array([[2.0, 0.0, 0.0]])
    e2 = jnp.array([[1.0, 2.0, 0.0]])
    o = jnp.zeros((1, 3))
    d = jnp.array([[0.0, 0.0, -1.0]])
    for name, fn in BACKENDS.items():
        for w, expect in [(5.0, True), (4.999, False), (0.0, False)]:
            _, hit = fn(o, d, v0, e1, e2, EPS, False,
                        t_max=jnp.array([w]), any_hit=True)
            assert bool(hit[0]) == expect, (name, w)


def test_sweep_and_kdtree_any_hit_on_scene(scenes, tmp_path):
    # Backends that need an accel: drive them through occluded() on a
    # real scene and pin fast-mode occlusion to the jnp backend's.
    import dataclasses
    from simd_raytracer import RenderConfig, parse_scene_file
    from simd_raytracer.accel.build import build_kdtree_for_scene
    from simd_raytracer.accel.sweep import build_sweep_for_scene
    from simd_raytracer.models.scene import derive_geometry
    from simd_raytracer.ops.shade import occluded

    scene = parse_scene_file(str(scenes / "diffuse.crtscene"))
    geom = derive_geometry(scene)
    k = jax.random.split(jax.random.PRNGKey(2), 3)
    n = 256
    o = jax.random.uniform(k[0], (n, 3), minval=-2.0, maxval=2.0)
    d = jax.random.normal(k[1], (n, 3))
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    tmax = jax.random.uniform(k[2], (n,), minval=0.1, maxval=20.0)

    base = RenderConfig(occlusion_mode="fast", intersector="jnp")
    ref = occluded(o, d, tmax, scene, geom, base)
    for name, accel in [("sweep", build_sweep_for_scene(scene,
                                                        interpret=True)),
                        ("kdtree", build_kdtree_for_scene(scene))]:
        cfg = dataclasses.replace(base, intersector=name)
        got = occluded(o, d, tmax, scene, geom, cfg, accel=accel)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref),
                                      err_msg=name)
