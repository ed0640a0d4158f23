"""March-occlusion probe vs the scalar oracle (r5).

The r5 rework decides glass-free rays with a windowed any-hit probe and
runs the re-originating hop loop only for rays that cross a transmissive
surface inside their window (ops/shade.py::occluded).  This pins the
whole batched path — probe fast-out, glass-crossing march continuation,
hop cap, budget shrinking — to tests/oracle.py's literal scalar
replication of render.hpp:110-131, on a scene that actually contains
glass (hw11/scene2).
"""

import jax
import jax.numpy as jnp
import numpy as np

import oracle
from simd_raytracer import RenderConfig, parse_scene_file
from simd_raytracer.models.scene import derive_geometry
from simd_raytracer.ops.shade import occluded


def test_march_matches_oracle_on_glass_scene(scenes):
    scene = parse_scene_file(str(scenes / "glass.crtscene"))
    ns = oracle.NumpyScene(scene)
    geom = derive_geometry(scene)
    cfg = RenderConfig(occlusion_mode="march", intersector="jnp")

    k = jax.random.split(jax.random.PRNGKey(7), 3)
    n = 256
    # Origins spread through the scene volume, random directions, and
    # window lengths spanning well past the glass sphere so a healthy
    # fraction of rays cross it (glass-crossing is the path the probe
    # must hand to the real march).
    o = jax.random.uniform(k[0], (n, 3), minval=-3.0, maxval=3.0)
    o = o.at[:, 2].add(-2.0)
    d = jax.random.normal(k[1], (n, 3))
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    tmax = jax.random.uniform(k[2], (n,), minval=0.2, maxval=25.0)

    got = np.asarray(occluded(o, d, tmax, scene, geom, cfg))

    on, dn, tn = np.asarray(o), np.asarray(d), np.asarray(tmax)
    want = np.array([
        oracle.is_occluded(ns, on[i], dn[i], float(tn[i]), cfg)
        for i in range(n)])
    assert want.any() and not want.all()      # non-trivial mix
    np.testing.assert_array_equal(got, want)

    # The same rays through the glass-aware fast mode must agree with
    # march everywhere no transmissive surface interferes; spot-check
    # that fast never claims MORE occlusion than a solid-only oracle.
    cfg_fast = RenderConfig(occlusion_mode="fast", intersector="jnp")
    fast = np.asarray(occluded(o, d, tmax, scene, geom, cfg_fast))
    # any ray fast calls occluded must be occluded by a solid hit
    # somewhere in the window, which implies march-occluded too unless
    # a glass crossing re-originated past it: so fast => march except
    # for bias-scale window edges (none under this random draw).
    np.testing.assert_array_equal(fast & ~got, np.zeros(n, bool))
