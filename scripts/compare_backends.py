"""Time the select backends on the card, end to end and as a select alone.

Cells (stand-ins from simd_raytracer/models/scenegen.py):
  dragon    1920x1080, spp 1, depth 5, roulette, 4,014 triangles
  room      960x960, spp 4, depth 5, roulette, 2,012 triangles
  terrain   512x512, spp 1, depth 1, roulette, 250,632 triangles
  refexact  room 960x960, spp 4, depth 5, split + march (exact estimator)

--frames times whole frames per (cell, backend); --select times the
primary-ray closest-hit select alone over the cell's full frame of rays,
in 16,384-ray chunks as the renderer issues them, and counts winners
that differ from `jnp`; --tune times sweep kernel shapes on that select.
Every line is JSON and names the device; steady times are medians, each
call ending in block_until_ready.  Exits non-zero without a GPU.

Usage: python scripts/compare_backends.py --frames --select \
           [--cells dragon,room] [--backends jnp,sweep] [--label L]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import tempfile

# appended, so that a PYTHONPATH copy of the package takes precedence
sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CELLS = {
    "dragon": dict(scene="dragon", size=None, spp=1, depth=5,
                   mode="roulette", occlusion="fast"),
    "room": dict(scene="room", size=(960, 960), spp=4, depth=5,
                 mode="roulette", occlusion="fast"),
    "terrain": dict(scene="terrain", size=None, spp=1, depth=1,
                    mode="roulette", occlusion="fast"),
    "refexact": dict(scene="room", size=(960, 960), spp=4, depth=5,
                     mode="split", occlusion="march"),
}
CHUNK = 16384


def _emit(rec, info, label, log):
    rec = dict(rec, label=label, device_kind=info["kind"],
               card=info["nvidia_smi"])
    line = json.dumps(rec)
    print(line, flush=True)
    if log:
        log.write(line + "\n")
        log.flush()


def _scene(cell, scene_dir):
    from simd_raytracer import parse_scene_file
    from simd_raytracer.models.scenegen import write_scene
    c = CELLS[cell]
    scene = parse_scene_file(write_scene(c["scene"], scene_dir))
    if c["size"]:
        scene = scene.replace(height=c["size"][0], width=c["size"][1])
    return scene


def _cfg(cell, backend):
    from simd_raytracer import RenderConfig
    c = CELLS[cell]
    return RenderConfig(samples_per_pixel=c["spp"], max_ray_depth=c["depth"],
                        bounce_mode=c["mode"], occlusion_mode=c["occlusion"],
                        intersector=backend, chunk_size=CHUNK)


def _accel(scene, backend, **kw):
    if backend == "sweep":
        from simd_raytracer.accel.sweep import build_sweep_for_scene
        return build_sweep_for_scene(scene, **kw)
    if backend == "kdtree":
        from simd_raytracer.accel.build import build_kdtree_for_scene
        return build_kdtree_for_scene(scene)
    return None


def frame_rays(scene, spp):
    """The frame's primary rays (centred samples) in the tiled ray order,
    as (C, CHUNK, 3) origins and directions."""
    import jax.numpy as jnp
    import numpy as np
    from simd_raytracer.models.camera import primary_rays
    from simd_raytracer.ops.render import _tiled_ids
    total = scene.height * scene.width * spp
    ids = _tiled_ids(scene.height, scene.width, spp)
    ids = np.minimum(ids[:len(ids) // CHUNK * CHUNK], total - 1)
    pix = jnp.asarray(ids // spp, jnp.int32)
    half = jnp.full(pix.shape, 0.5, jnp.float32)
    o, d = primary_rays(scene, 90.0, pix % scene.width, pix // scene.width,
                        half, half)
    return o.reshape(-1, CHUNK, 3), d.reshape(-1, CHUNK, 3)


def make_frame_select(select, geom, cull=True):
    """jit: (C, CHUNK, 3) rays -> per-chunk (idx, hit), lax.map over
    chunks like the renderer."""
    import jax

    @jax.jit
    def run(o, d):
        return jax.lax.map(lambda od: select(
            od[0], od[1], geom.v0, geom.e1, geom.e2, 1e-6, cull,
            geom.tri_valid), (o, d))
    return run


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="dragon,room,terrain,refexact")
    ap.add_argument("--backends", default="jnp,sweep")
    ap.add_argument("--frames", action="store_true")
    ap.add_argument("--select", action="store_true")
    ap.add_argument("--tune", action="store_true")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--label", default="")
    ap.add_argument("--log", default=None, help="also append lines here")
    args = ap.parse_args()

    import jax
    import numpy as np
    from simd_raytracer import render_frame
    from simd_raytracer.models.scene import derive_geometry
    from simd_raytracer.ops.intersect import make_select_fn
    from simd_raytracer.utils.compile_cache import enable
    from simd_raytracer.utils.profiling import (peak_bytes, require_gpu,
                                                time_call)

    enable()
    info = require_gpu()
    log = open(args.log, "a") if args.log else None
    backends = args.backends.split(",")
    scene_dir = tempfile.mkdtemp(prefix="scenes")
    print(json.dumps({"device": info}), flush=True)

    for cell in args.cells.split(","):
        c = CELLS[cell]
        scene = _scene(cell, scene_dir)
        rays = scene.height * scene.width * c["spp"]
        if args.frames:
            for b in backends:
                cfg = _cfg(cell, b)
                accel = _accel(scene, b)
                comp, steady = time_call(
                    lambda: render_frame(scene, cfg, accel=accel),
                    args.repeats)
                _emit({"what": "frame", "cell": cell, "backend": b,
                       "compile_s": comp, "steady_s": steady,
                       "rays_per_s": rays / steady,
                       "peak_bytes": peak_bytes()}, info, args.label, log)
        if not (args.select or args.tune) or c["mode"] == "split":
            continue
        geom = derive_geometry(scene)
        o, d = frame_rays(scene, c["spp"])
        n = o.shape[0] * o.shape[1]
        ref = make_frame_select(make_select_fn("jnp"), geom)(o, d)
        ref_idx, ref_hit = (np.asarray(a).ravel() for a in ref)

        def measure(name, select, **extra):
            run = make_frame_select(select, geom)
            comp, steady = time_call(lambda: run(o, d), args.repeats)
            idx, hit = (np.asarray(a).ravel() for a in run(o, d))
            differ = (hit != ref_hit) | (hit & (idx != ref_idx))
            _emit(dict({"what": "select", "cell": cell, "backend": name,
                        "rays": n, "compile_s": comp, "steady_s": steady,
                        "rays_per_s": n / steady,
                        "differ_frac": float(differ.mean())}, **extra),
                  info, args.label, log)

        if args.select:
            for b in backends:
                measure(b, make_select_fn(b, _accel(scene, b)))
        if args.tune:
            from simd_raytracer.ops.intersect_sweep import make_sweep_select
            shapes = ([(r, w, 4) for r, w in itertools.product(
                (16, 32, 64, 128), (32, 64, 128))]
                + [(r, 64, w) for r in (32, 64) for w in (2, 8)])
            for r_tile, width, warps in shapes:
                sweep = _accel(scene, "sweep", r_tile=r_tile,
                               slice_size=width, num_warps=warps)
                measure("sweep", make_sweep_select(sweep), r_tile=r_tile,
                        slice=width, num_warps=warps)
        jax.clear_caches()
    return 0


if __name__ == "__main__":
    sys.exit(main())
