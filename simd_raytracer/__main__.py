"""CLI driver — parity with the reference binary (reference:
src/main.cpp:27-46): `python -m simd_raytracer SCENE.crtscene` renders
the scene and writes image.ppm, printing the render wall time.  Extra flags
expose what the reference hardcodes as constexpr (config.hpp:6-17).
"""

from __future__ import annotations

import argparse
import sys
import time

from .config import DEFAULT_INTERSECTOR, INTERSECTORS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="simd_raytracer",
        description="differentiable wavefront path tracer")
    ap.add_argument("scene", help=".crtscene file")
    ap.add_argument("-o", "--output", default="image.ppm")
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--max-depth", type=int, default=5)
    ap.add_argument("--gi-rays", type=int, default=0,
                    help="diffuse_reflection_ray_count")
    ap.add_argument("--fov", type=float, default=90.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--width", type=int, default=None,
                    help="override scene width")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--intersector", default=DEFAULT_INTERSECTOR,
                    choices=INTERSECTORS)
    ap.add_argument("--bounce-mode", default="split",
                    choices=["split", "roulette"],
                    help="split = reference's full recursion tree; "
                         "roulette = unbiased single-child sampling "
                         "(flat wavefront, far faster at depth)")
    ap.add_argument("--occlusion", default="fast",
                    choices=["fast", "march"],
                    help="shadow query: march replicates the reference's "
                         "re-origined loop (render.hpp:110-131); fast is "
                         "one transmissive-aware closest-hit query")
    ap.add_argument("--ray-order", default="auto",
                    choices=["auto", "linear", "tiled"],
                    help="ray-id traversal order: tiled walks 32x32 "
                         "screen blocks (tight sweep-kernel tile boxes); "
                         "auto picks tiled for --intersector sweep.  "
                         "Reassigns all per-slot randomness (jitter, GI, "
                         "roulette): same estimator, different samples")
    ap.add_argument("--scheduling", default="linear",
                    choices=["linear", "single", "region", "bucket"],
                    help="tile order (reference tile/*.hpp; linear is the "
                         "default, bucket mirrors main.cpp:17)")
    ap.add_argument("--progressive-batch", type=int, default=0,
                    help="render spp in batches of this size with "
                         "checkpointing (0 = one shot)")
    ap.add_argument("--checkpoint", default=None,
                    help="accumulation checkpoint path for progressive mode")
    ap.add_argument("--profile", action="store_true",
                    help="print per-phase timings (load/build/compile/render)")
    args = ap.parse_args(argv)

    from simd_raytracer.utils.compile_cache import enable as _cc
    _cc()   # persistent XLA cache: re-renders of a config skip compiles
    from simd_raytracer import (RenderConfig, parse_scene_file,
                                render_frame, save_ppm)

    scene = parse_scene_file(args.scene)
    if args.width or args.height:
        scene = scene.replace(width=args.width or scene.width,
                              height=args.height or scene.height)
    cfg = RenderConfig(
        samples_per_pixel=args.spp, max_ray_depth=args.max_depth,
        diffuse_reflection_ray_count=args.gi_rays, fov_degrees=args.fov,
        rng_seed=args.seed, chunk_size=args.chunk,
        intersector=args.intersector, bounce_mode=args.bounce_mode,
        occlusion_mode=args.occlusion, ray_order=args.ray_order)

    import jax

    accel = None
    if args.intersector in ("kdtree", "sweep"):
        t0 = time.perf_counter()
        if args.intersector == "kdtree":
            from simd_raytracer.accel.build import build_kdtree_for_scene
            accel = build_kdtree_for_scene(scene)
        else:
            from simd_raytracer.accel.sweep import build_sweep_for_scene
            accel = build_sweep_for_scene(scene)
        if args.profile:
            print(f"accel build took {time.perf_counter() - t0} seconds.")

    scheduling = None
    if args.scheduling != "linear":
        from simd_raytracer.parallel.tiles import SchedulingType
        scheduling = {"single": SchedulingType.SINGLE,
                      "region": SchedulingType.REGION_GRID,
                      "bucket": SchedulingType.BUCKET_TILES}[args.scheduling]

    t0 = time.perf_counter()
    if args.progressive_batch:
        from simd_raytracer.utils.checkpoint import render_progressive
        img = render_progressive(
            scene, cfg, total_spp=args.spp,
            spp_per_batch=args.progressive_batch,
            checkpoint_path=args.checkpoint, accel=accel)
    else:
        img = render_frame(scene, cfg, accel=accel, scheduling=scheduling)
    jax.block_until_ready(img)
    dt = time.perf_counter() - t0
    print(f"Rendering took {dt} seconds.")

    import numpy as np
    save_ppm(np.asarray(img), args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
