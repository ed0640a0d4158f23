"""Timing, device identification and wavefront counters.

The reference times exactly one thing: the whole frame, with
chrono::high_resolution_clock around render_still (reference:
src/main.cpp:16-21).  Here measurement scripts time compile and steady
state separately (every steady call ends in block_until_ready) and name
the device every number was taken on.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import time
from typing import Dict


class PhaseTimer:
    """Collects named wall-time phases; re-entering a name accumulates."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)

    def report(self) -> str:
        width = max((len(k) for k in self.seconds), default=0)
        return "\n".join(f"{k.ljust(width)}  {v:10.4f} s"
                         for k, v in self.seconds.items())


def device_info() -> Dict:
    """The device as JAX reports it, plus the card's name and power limit
    as nvidia-smi reports them (None where there is no nvidia-smi)."""
    import jax
    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        if out.returncode == 0:
            info["nvidia_smi"] = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return info


def require_gpu() -> Dict:
    """device_info(), or SystemExit when JAX's default device is no GPU:
    measurements never fall back to the CPU."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is "
                         f"{info['platform']} ({info['kind']})")
    return info


def time_call(fn, repeats: int = 3):
    """(compile_seconds, median steady seconds) of fn(); the first call
    (compile + run) and every steady call end in block_until_ready."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    steady = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        steady.append(time.perf_counter() - t0)
    return first, statistics.median(steady)


def peak_bytes() -> int:
    """peak_bytes_in_use of device 0 (0 where the backend keeps none)."""
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


def wavefront_occupancy(scene, cfg, ray_ids, key=None, accel=None):
    """Per-bounce live-ray counts for one chunk (SURVEY.md §5 metrics:
    'per-bounce wavefront occupancy counters').

    Returns a list of ints: entry d is how many rays enter bounce d with
    nonzero throughput.  Diagnoses when roulette compaction
    (config.compact_factor) will engage and how much of the depth budget
    a scene actually uses.
    """
    import jax
    import jax.numpy as jnp

    from ..models.scene import derive_geometry
    from ..ops.intersect import trace
    from ..ops.shade import shade

    if key is None:
        key = jax.random.PRNGKey(cfg.rng_seed or 0)

    @jax.jit
    def counts(ray_ids, key):
        geom = derive_geometry(scene)
        from ..models.camera import primary_rays

        r0 = ray_ids.shape[0]
        spp = cfg.samples_per_pixel
        total = scene.height * scene.width * spp
        valid = ray_ids < total
        ids = jnp.minimum(ray_ids, total - 1)
        pix = ids // spp
        jx = jnp.full((r0,), 0.5, jnp.float32)
        o, d = primary_rays(scene, cfg.fov_degrees, pix % scene.width,
                            pix // scene.width, jx, jx)
        weight = valid.astype(jnp.float32)
        out = []
        for depth in range(cfg.max_ray_depth + 1):
            out.append(jnp.sum(weight > 0.0))
            if depth == cfg.max_ray_depth:
                break
            hit = trace(o, d, scene, geom, cfg.epsilon, cull=(depth == 0),
                        intersector=cfg.intersector, accel=accel)
            _, (o, d, weight, _) = shade(
                scene, geom, hit, d, weight, cfg,
                jax.random.fold_in(key, depth + 1), accel)
        return jnp.stack(out)

    return [int(c) for c in counts(ray_ids, key)]
