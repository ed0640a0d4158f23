"""Benchmark driver: prints the headline metric as ONE JSON line.

Headline metric: primary rays/s on the `room` stand-in (the hw15/scene2
shape, simd_raytracer/models/scenegen.py) at 960x960, spp 4, depth 5,
roulette.  The reference anchor is ~21M primary rays/s derived from its
"<100 ms at 1920x1080" dragon figure on an AVX2 laptop (BASELINE.md);
vs_baseline is ours / 21e6.

Phases, in one process, in this order:

  headline   room 960x960 spp 4, roulette
  dragon     dragon stand-in at 1920x1080 spp 1 (the README "<100 ms"
             config)
  refexact   the headline frame with reference-exact semantics
             (bounce_mode=split, occlusion=march)
  backward   fwd+bwd throughput: train_steps, 8 SGD steps of 65,536 rays
  northstar  (--northstar only) 128-spp GI fwd+bwd + FD gradient check

Each phase times compile separately from steady state; every steady call
ends in block_until_ready.  The result line is reprinted after every
phase and names the device (JAX's platform and device_kind, the card's
name and power limit from nvidia-smi).  A phase is skipped once the time
budget is spent.  Without a GPU it fails unless the caller chose the CPU
(JAX_PLATFORMS=cpu), and then says so in every line.

Usage: python bench.py [--spp N] [--scale F] [--scene NAME|PATH] [--quick]
       python bench.py --mesh 4        # sharded scaling on 1..4 devices
       python bench.py --northstar     # 128-spp GI fwd+bwd + FD check
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

BASELINE = 21e6  # BASELINE.md derived reference anchor (primary rays/s)


def _load(scene, scale):
    from simd_raytracer import parse_scene_file
    from simd_raytracer.models.scenegen import STANDINS, write_scene
    if scene in STANDINS:
        scene = write_scene(scene, tempfile.mkdtemp(prefix="bench_scenes"))
    s = parse_scene_file(scene)
    return s.replace(height=max(8, int(s.height * scale)),
                     width=max(8, int(s.width * scale)))


def _build_accel(scene, intersector):
    if intersector == "kdtree":
        from simd_raytracer.accel.build import build_kdtree_for_scene
        return build_kdtree_for_scene(scene)
    if intersector == "sweep":
        from simd_raytracer.accel.sweep import build_sweep_for_scene
        return build_sweep_for_scene(scene)
    return None


def phase_forward(args, cfg_overrides=None, scene=None, scale=None,
                  spp=None):
    from simd_raytracer import RenderConfig, render_frame
    from simd_raytracer.utils.profiling import peak_bytes, time_call

    scene = _load(scene or args.scene,
                  args.scale if scale is None else scale)
    spp = args.spp if spp is None else spp
    kw = dict(samples_per_pixel=spp, chunk_size=args.chunk,
              intersector=args.intersector, bounce_mode=args.bounce_mode)
    kw.update(cfg_overrides or {})
    cfg = RenderConfig(**kw)
    accel = _build_accel(scene, cfg.intersector)
    compile_s, per_frame = time_call(
        lambda: render_frame(scene, cfg, accel=accel), args.repeats)
    rays = scene.height * scene.width * spp
    return {"rays_per_sec": rays / per_frame,
            "seconds_per_frame": per_frame, "compile_s": compile_s,
            "peak_bytes": peak_bytes(),
            "h": scene.height, "w": scene.width, "spp": spp,
            "intersector": cfg.intersector,
            "bounce_mode": cfg.bounce_mode}


def phase_refexact(args):
    out = phase_forward(args, cfg_overrides=dict(
        bounce_mode="split", occlusion_mode="march"))
    return {"refexact_" + k: v for k, v in out.items()}


def phase_dragon(args):
    out = phase_forward(args, scene="dragon", scale=1.0, spp=1)
    o = {"dragon_" + k: v for k, v in out.items()}
    o["dragon_vs_anchor"] = out["rays_per_sec"] / BASELINE
    return o


def phase_backward(args, spp=None, gi=0, fd_check=False):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from simd_raytracer import RenderConfig
    from simd_raytracer.ops.grad import (loss_and_grad, split_params,
                                         train_steps)
    from simd_raytracer.utils.profiling import peak_bytes

    scene = _load(args.scene, args.scale)
    spp = args.spp if spp is None else spp
    total = scene.height * scene.width * spp
    n = min(total, args.train_rays)
    cfg = RenderConfig(samples_per_pixel=spp, chunk_size=n,
                       intersector=args.intersector,
                       bounce_mode=args.bounce_mode,
                       diffuse_reflection_ray_count=gi)
    accel = _build_accel(scene, cfg.intersector)
    params, skeleton = split_params(scene)
    # interior rays: center rays exercise the real backward path
    ids = jnp.arange(n, dtype=jnp.int32) + (total - n) // 2
    target = jnp.zeros((n, 3), jnp.float32)
    pref = "northstar_" if gi else "fwd_bwd_"
    out = {}
    if fd_check:
        # d(loss)/d(intensity) vs a central difference (fixed key ->
        # deterministic estimator).
        _, g0 = loss_and_grad(params, skeleton, cfg, ids, target,
                              jax.random.PRNGKey(0), accel)

        def loss_at(di):
            p = dict(params)
            p["light_intensity"] = params["light_intensity"] + di
            loss, _ = loss_and_grad(p, skeleton, cfg, ids, target,
                                    jax.random.PRNGKey(0), accel)
            return float(loss)

        eps_fd = 0.05 * float(jnp.max(jnp.abs(
            params["light_intensity"]))) or 1.0
        fd = (loss_at(eps_fd) - loss_at(-eps_fd)) / (2 * eps_fd)
        an = float(jnp.sum(g0["light_intensity"]))
        rel = abs(fd - an) / max(abs(fd), abs(an), 1e-12)
        out[pref + "fd_rel_err"] = rel
        assert rel < 0.05, f"FD mismatch: analytic {an} vs FD {fd}"

    # n_steps SGD steps per executable call (lax.scan with donated
    # params).  Params are re-materialized as fresh buffers first;
    # split_params aliases the skeleton's arrays and an aliased donation
    # is refused.
    n_steps = 8
    p = jax.tree_util.tree_map(jnp.array, params)
    t0 = time.perf_counter()
    p, losses = train_steps(p, skeleton, cfg, ids, target,
                            jax.random.PRNGKey(0), n_steps=n_steps,
                            accel=accel)
    jax.block_until_ready(losses)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p, losses = train_steps(p, skeleton, cfg, ids, target,
                            jax.random.PRNGKey(1), n_steps=n_steps,
                            accel=accel)
    jax.block_until_ready(losses)
    per_step = (time.perf_counter() - t0) / n_steps
    assert np.isfinite(np.asarray(losses)).all()
    out.update({pref + "rays_per_sec": n / per_step,
                pref + "compile_s": compile_s, pref + "rays": n,
                pref + "spp": spp, pref + "steps_per_call": n_steps,
                pref + "peak_bytes": peak_bytes()})
    return out


def run_mesh(args):
    """Sharded frame throughput on 1, 2, 4, ... devices up to args.mesh."""
    import jax
    from simd_raytracer import RenderConfig
    from simd_raytracer.parallel.sharding import (make_mesh,
                                                  render_frame_sharded)
    from simd_raytracer.utils.profiling import time_call

    if args.mesh > len(jax.devices()):
        raise SystemExit(f"--mesh {args.mesh} > {len(jax.devices())} "
                         f"{jax.default_backend()} devices")
    scene = _load(args.scene, args.scale)
    cfg = RenderConfig(samples_per_pixel=args.spp, chunk_size=args.chunk,
                       intersector=args.intersector,
                       bounce_mode=args.bounce_mode)
    accel = _build_accel(scene, cfg.intersector)
    rays = scene.height * scene.width * args.spp
    rows = {}
    for nd in [s for s in (1, 2, 4, 8) if s <= args.mesh]:
        mesh = make_mesh(nd)
        _, dt = time_call(lambda: render_frame_sharded(scene, cfg, mesh,
                                                       accel=accel), 2)
        rows[nd] = rays / dt
    eff = {nd: v / (rows[1] * nd) for nd, v in rows.items()}
    top = max(rows)
    return {"metric": f"sharded_rays_per_sec_{top}dev", "value": rows[top],
            "unit": "rays/s", "vs_baseline": rows[top] / BASELINE,
            "detail": {"mesh_rays_per_sec": rows,
                       "mesh_scaling_efficiency": eff}}


PHASES = {
    "headline": phase_forward,
    "dragon": phase_dragon,
    "refexact": phase_refexact,
    "backward": phase_backward,
    "northstar": lambda a: phase_backward(a, spp=128, gi=1, fd_check=True),
}


def _result_line(headline, detail):
    value = headline["rays_per_sec"] if headline else 0
    return {"metric": "primary_rays_per_sec_room", "value": value,
            "unit": "rays/s", "vs_baseline": value / BASELINE,
            "detail": detail}


def main() -> int:
    from simd_raytracer.config import DEFAULT_INTERSECTOR, INTERSECTORS

    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="room",
                    help="stand-in name (scenegen.STANDINS) or a file")
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--scale", type=float, default=0.5,
                    help="resolution scale on the scene's native HxW")
    ap.add_argument("--chunk", type=int, default=16384)
    ap.add_argument("--train-rays", type=int, default=65536)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--intersector", default=DEFAULT_INTERSECTOR,
                    choices=INTERSECTORS)
    ap.add_argument("--bounce-mode", default="roulette",
                    choices=["split", "roulette"])
    ap.add_argument("--quick", action="store_true",
                    help="headline + backward phases only")
    ap.add_argument("--mesh", type=int, default=0,
                    help="run the sharded scaling harness up to N devices")
    ap.add_argument("--northstar", action="store_true",
                    help="run the 128-spp GI fwd+bwd + FD check phase")
    ap.add_argument("--budget", type=float, default=1500.0,
                    help="no phase starts after this many seconds")
    args = ap.parse_args()
    start = time.time()

    import jax
    from simd_raytracer.utils.compile_cache import enable
    from simd_raytracer.utils.profiling import device_info

    enable()
    info = device_info()
    if info["platform"] != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        print(json.dumps({"error": f"no GPU ({info['platform']}); set "
                          "JAX_PLATFORMS=cpu to measure the CPU"}))
        return 1

    if args.mesh:
        out = run_mesh(args)
        out["detail"]["device"] = info
        print(json.dumps(out))
        return 0

    if args.northstar:
        phases = ["northstar"]
    elif args.quick:
        phases = ["headline", "backward"]
    else:
        phases = ["headline", "dragon", "refexact", "backward"]

    detail = {"phases_done": [], "scene": args.scene, "device": info,
              "jax": jax.__version__,
              "xla_flags": os.environ.get("XLA_FLAGS", "")}
    headline = None
    for ph in phases:
        if time.time() - start > args.budget:
            sys.stderr.write(f"[phase {ph} skipped: budget spent]\n")
            continue
        out = PHASES[ph](args)
        if ph == "headline":
            headline = out
        detail.update(out)
        detail["phases_done"].append(ph)
        print(json.dumps(_result_line(headline, detail)), flush=True)
    return 0 if headline or phases == ["northstar"] else 1


if __name__ == "__main__":
    sys.exit(main())
