"""Observability: per-bounce wavefront occupancy (SURVEY.md §5 metrics)."""

import jax.numpy as jnp
import numpy as np

from simd_raytracer import RenderConfig, parse_scene_file
from simd_raytracer.utils.profiling import (PhaseTimer,
                                            wavefront_occupancy)


def test_occupancy_counts_decay(scenes):
    scene = parse_scene_file(str(scenes / "glass.crtscene")).replace(
        height=16, width=20)
    cfg = RenderConfig(chunk_size=320, bounce_mode="roulette")
    ids = jnp.arange(320, dtype=jnp.int32)
    occ = wavefront_occupancy(scene, cfg, ids)
    assert len(occ) == cfg.max_ray_depth + 1
    assert occ[0] == 320                      # every primary ray is live
    assert occ[1] < 320                       # only refractive continue
    assert all(a >= b for a, b in zip(occ, occ[1:]))   # monotone decay


def test_phase_timer_accumulates():
    t = PhaseTimer()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    with t.phase("b"):
        pass
    assert set(t.seconds) == {"a", "b"}
    assert "a" in t.report()
