"""Smoke test of the render and train paths on one NVIDIA GPU.

Drives the normal entry points at full size on seeded stand-in scenes
(simd_raytracer/models/scenegen.py) and checks every result against the
repository's plain references:

  1 generate   write the stand-ins from seed 0
  2 dragon     `python -m simd_raytracer` main() in process: dragon,
               1920x1080, spp 1, default intersector; image not blank
  3 select     the dragon frame's 2,073,600 primary rays against all its
               triangles: every retained backend vs `jnp` (mt_select),
               closest hit, then t_max windows with any_hit (reference:
               jnp's closest unculled hit inside the window)
  4 room       room 960x960, spp 4, depth 5, roulette: sweep vs jnp
  5 refexact   the same frame with split + march (the exact estimator)
  6 oracle     small room and textures frames, default intersector,
               vs tests/oracle.py
  7 train      8 SGD steps of 65,536 rays on the room (train_steps),
               finite losses, finite nonzero gradients, finite
               differences on light_intensity and one vertex coordinate

Each phase prints one JSON line (compile and steady seconds, rays/s,
peak_bytes_in_use, device kind, card name and power limit).  The last
line is {"ok": true, "device": {...}}; any failure prints "ok": false and
exits 1.  Without a GPU it fails at once.

  python chip_smoke.py               # one GPU, phases 1-7
  python chip_smoke.py --four-gpus   # only: sharded render and train step
                                     # on 4 GPUs vs one card
  python chip_smoke.py --rehearse    # CPU dress rehearsal at tiny sizes,
                                     # kernels interpreted; times mean nothing
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "build", "smoke")

# Select agreement with `jnp`.  The contract is identical winners, but the
# compiled kernels may contract a*b+c into FMAs differently from XLA's
# fusion, which moves a last-ulp edge test; only such edge rays may
# differ.
SELECT_TOL = {"sweep": 1e-4, "kdtree": 1e-4}


class Smoke:
    def __init__(self, rehearse: bool):
        self.rehearse = rehearse
        from simd_raytracer.utils.profiling import device_info
        self.info = device_info()

    def emit(self, phase, **rec):
        from simd_raytracer.utils.profiling import peak_bytes
        rec = dict({"phase": phase}, **rec, peak_bytes=peak_bytes(),
                   device_kind=self.info["kind"],
                   card=self.info["nvidia_smi"])
        print(json.dumps(rec), flush=True)

    def check(self, cond, what):
        if not cond:
            raise AssertionError(what)


def _accel(scene, intersector, rehearse):
    if intersector == "sweep":
        from simd_raytracer.accel.sweep import build_sweep_for_scene
        return build_sweep_for_scene(scene, interpret=rehearse)
    if intersector == "kdtree":
        from simd_raytracer.accel.build import build_kdtree_for_scene
        return build_kdtree_for_scene(scene)
    return None


def _timed(fn, repeats=3):
    from simd_raytracer.utils.profiling import time_call
    return time_call(fn, repeats)


def phase_generate(sm, scene_dir):
    from simd_raytracer.models.scenegen import STANDINS, write_scene
    t0 = time.perf_counter()
    names = [n for n in STANDINS if not (sm.rehearse and n == "terrain")]
    paths = {n: write_scene(n, scene_dir, seed=0) for n in names}
    sm.emit("generate", ok=True, scenes=len(paths),
            seconds=time.perf_counter() - t0)
    return paths


def phase_dragon_cli(sm, paths):
    import numpy as np
    from simd_raytracer.__main__ import main as cli
    from simd_raytracer.config import DEFAULT_INTERSECTOR
    from simd_raytracer.utils.ppm import read_ppm

    out = os.path.join(OUT, "dragon.ppm")
    argv = [paths["dragon"], "-o", out, "--spp", "1"]
    if sm.rehearse:
        argv += ["--width", "48", "--height", "27"]
        if DEFAULT_INTERSECTOR == "sweep":
            argv += ["--intersector", "jnp"]    # CLI builds no interp accel
    walls = []
    for _ in range(2):                          # compile + run, then run
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli(argv)
        walls.append(time.perf_counter() - t0)
        sm.check(rc == 0, f"CLI exit code {rc}")
    render_s = float(re.search(r"Rendering took ([0-9.e-]+)",
                               buf.getvalue()).group(1))
    img = read_ppm(out)
    bg = img[0, 0]
    frac = float(np.any(img != bg, axis=-1).mean())
    sm.check(frac > 0.05, f"dragon image is {1 - frac:.1%} background")
    rays = img.shape[0] * img.shape[1]
    sm.emit("dragon_cli", ok=True, compile_s=walls[0], steady_s=render_s,
            cli_wall_s=walls[1], rays_per_s=rays / render_s,
            shape=list(img.shape), non_background=frac)


def _frame_rays(scene, chunk):
    """All primary rays of the frame (centred samples, tiled order),
    padded to whole chunks: ((C, chunk, 3) o, d, real ray count)."""
    import jax.numpy as jnp
    import numpy as np
    from simd_raytracer.models.camera import primary_rays
    from simd_raytracer.ops.render import _tiled_ids

    total = scene.height * scene.width
    ids = _tiled_ids(scene.height, scene.width, 1)
    ids = ids[ids < total]
    n = len(ids)
    ids = np.concatenate([ids, np.full(-n % chunk, ids[-1])])
    pix = jnp.asarray(ids, jnp.int32)
    half = jnp.full(pix.shape, 0.5, jnp.float32)
    o, d = primary_rays(scene, 90.0, pix % scene.width, pix // scene.width,
                        half, half)
    return o.reshape(-1, chunk, 3), d.reshape(-1, chunk, 3), n


def phase_select(sm, paths, backends):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from simd_raytracer import parse_scene_file
    from simd_raytracer.models.scene import derive_geometry
    from simd_raytracer.ops.intersect import make_select_fn, mt_refine

    scene = parse_scene_file(paths["dragon"])
    if sm.rehearse:
        scene = scene.replace(height=27, width=48)
    geom = derive_geometry(scene)
    chunk = 256 if sm.rehearse else 16384
    o, d, n = _frame_rays(scene, chunk)
    g = (geom.v0, geom.e1, geom.e2)

    def runner(select, cull, any_hit=False):
        @jax.jit
        def run(o, d, tmax):
            def one(args):
                oc, dc, tc = args
                return select(oc, dc, *g, 1e-6, cull, geom.tri_valid,
                              t_max=tc if any_hit else None,
                              any_hit=any_hit)
            return jax.lax.map(one, (o, d, tmax))
        return run

    def flat(x):
        return np.asarray(x).reshape(-1)[:n]

    of, df = o.reshape(-1, 3)[:n], d.reshape(-1, 3)[:n]

    def closest_t(idx, hit):
        t, _, _ = mt_refine(of, df, geom.v0[idx], geom.e1[idx],
                            geom.e2[idx])
        return np.where(hit, np.asarray(t), np.inf)

    # Closest hit as for primary rays (backface culling).
    ref_sel = make_select_fn("jnp")
    ref_idx, ref_hit = map(flat, runner(ref_sel, True)(o, d, o[..., 0]))
    ref_t = closest_t(ref_idx, ref_hit)
    # Any hit as for shadow rays: no culling, inclusive t_max window.  A
    # ray is occluded iff its closest unculled hit lies in the window, so
    # the reference is jnp's closest hit.  (XLA:GPU takes minutes to
    # compile jnp's boolean any-reduce over this frame; its any-hit path
    # runs in the room frames below.)
    rng = np.random.default_rng(0)
    tmax_flat = (np.where(ref_hit, ref_t, 5.0)
                 * rng.uniform(0.5, 1.5, n)).astype(np.float32)
    tmax = jnp.asarray(np.concatenate(
        [tmax_flat, np.zeros(o.shape[0] * chunk - n, np.float32)])
    ).reshape(o.shape[:2])
    nc_idx, nc_hit = map(flat, runner(ref_sel, False)(o, d, tmax))
    ref_occ = nc_hit & (closest_t(nc_idx, nc_hit) <= tmax_flat)
    sm.check(0.05 < ref_hit.mean() < 0.95 and 0 < ref_occ.mean() < 1,
             "degenerate select workload")

    for b in ["jnp"] + backends:
        sel = make_select_fn(b, _accel(scene, b, sm.rehearse))
        run_c = runner(sel, True)
        comp, steady = _timed(lambda: run_c(o, d, o[..., 0]))
        idx, hit = map(flat, run_c(o, d, o[..., 0]))
        differ = (hit != ref_hit) | (hit & (idx != ref_idx))
        both = np.flatnonzero(differ & hit & ref_hit)
        gap = (float(np.max(np.abs(closest_t(idx, hit)[both] - ref_t[both])
                            / ref_t[both])) if len(both) else 0.0)
        rec = dict(backend=b, rays=n,
                   triangles=int(scene.tri_valid.sum()), compile_s=comp,
                   steady_s=steady, rays_per_s=n / steady,
                   differ_frac=float(differ.mean()),
                   differ_hit_mask=int((hit != ref_hit).sum()),
                   max_rel_t_gap=gap)
        differ_a = np.zeros(1, bool)
        if b != "jnp":
            run_a = runner(sel, False, any_hit=True)
            comp_a, steady_a = _timed(lambda: run_a(o, d, tmax))
            differ_a = flat(run_a(o, d, tmax)[1]) != ref_occ
            rec.update(any_hit_compile_s=comp_a, any_hit_steady_s=steady_a,
                       any_hit_rays_per_s=n / steady_a,
                       any_hit_differ_frac=float(differ_a.mean()))
        tol = SELECT_TOL.get(b, 0.0)
        ok = bool(differ.mean() <= tol and differ_a.mean() <= tol)
        sm.emit("select", ok=ok, tolerance=tol, **rec)
        sm.check(ok, f"{b} select disagrees with jnp beyond {tol}")


def _room_cfg(sm, **kw):
    from simd_raytracer import RenderConfig
    base = dict(samples_per_pixel=4, max_ray_depth=5, bounce_mode="roulette",
                chunk_size=256 if sm.rehearse else 16384)
    base.update(kw)
    return RenderConfig(**base)


def _room(sm, paths):
    from simd_raytracer import parse_scene_file
    scene = parse_scene_file(paths["room"])
    size = 24 if sm.rehearse else 960
    return scene.replace(height=size, width=size)


def phase_room(sm, paths, backend):
    import numpy as np
    from simd_raytracer import render_frame

    scene = _room(sm, paths)
    rays = scene.height * scene.width * 4
    imgs = {}
    for b in dict.fromkeys([backend, "jnp"]):
        # one ray order for both, so both draw the same samples
        cfg = _room_cfg(sm, intersector=b, ray_order="tiled")
        accel = _accel(scene, b, sm.rehearse)
        comp, steady = _timed(lambda: render_frame(scene, cfg, accel=accel))
        imgs[b] = np.asarray(render_frame(scene, cfg, accel=accel))
        sm.check(np.isfinite(imgs[b]).all(), f"{b}: non-finite pixels")
        sm.emit("room", ok=True, backend=b, compile_s=comp, steady_s=steady,
                rays_per_s=rays / steady)
    a, ref = imgs[backend], imgs["jnp"]
    close = float((np.abs(a - ref) <= 2e-3 * np.maximum(1.0, np.abs(ref))
                   ).mean())
    sm.emit("room_compare", ok=close > 0.99, backend=backend,
            pixels_close=close, max_abs_diff=float(np.abs(a - ref).max()))
    sm.check(close > 0.99, f"room {backend} vs jnp: {close:.4f} close")
    return ref


def phase_refexact(sm, paths, backend, roulette_img):
    import numpy as np
    from simd_raytracer import render_frame

    scene = _room(sm, paths)
    cfg = _room_cfg(sm, intersector=backend, ray_order="tiled",
                    bounce_mode="split", occlusion_mode="march")
    accel = _accel(scene, backend, sm.rehearse)
    comp, steady = _timed(lambda: render_frame(scene, cfg, accel=accel))
    img = np.asarray(render_frame(scene, cfg, accel=accel))
    # roulette is an unbiased estimator of split over the same samples
    rel = float(abs(img.mean() - roulette_img.mean()) / img.mean())
    ok = bool(np.isfinite(img).all() and rel < 0.02)
    sm.emit("refexact", ok=ok, backend=backend, compile_s=comp,
            steady_s=steady, rays_per_s=scene.height * scene.width * 4
            / steady, mean_rel_diff_vs_roulette=rel)
    sm.check(ok, "exact-estimator frame disagrees with roulette")


def phase_oracle(sm, paths, backend):
    import numpy as np
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import oracle
    from simd_raytracer import RenderConfig, parse_scene_file, render_frame

    for name, (h, w) in [("room", (24, 32)), ("textures", (24, 40))]:
        scene = parse_scene_file(paths[name]).replace(height=h, width=w)
        want = oracle.render(scene, RenderConfig(chunk_size=1024),
                             res=(h, w))
        cfg = RenderConfig(chunk_size=1024, intersector=backend,
                           ray_order="linear")
        got = np.asarray(render_frame(
            scene, cfg, accel=_accel(scene, backend, sm.rehearse)))
        # tests/test_golden.py tolerances: 2e-3 of the local magnitude,
        # at most 2% of pixels off (silhouette winners)
        bad = np.abs(got - want) > 2e-3 * np.maximum(1.0, np.abs(want))
        frac = float(bad.any(axis=-1).mean())
        sm.emit("oracle", ok=frac <= 0.02, scene=name, backend=backend,
                bad_pixel_frac=frac)
        sm.check(frac <= 0.02, f"{name}/{backend}: {frac:.2%} pixels off")


def phase_train(sm, paths, backend):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from simd_raytracer.ops.grad import (loss_and_grad, merge_params,
                                         split_params, train_steps)

    scene = _room(sm, paths)
    n = 256 if sm.rehearse else 65536
    cfg = _room_cfg(sm, intersector=backend, chunk_size=n)
    accel = _accel(scene, backend, sm.rehearse)
    params, skeleton = split_params(scene)
    total = scene.height * scene.width * 4
    ids = jnp.arange(n, dtype=jnp.int32) + (total - n) // 2
    target = jnp.zeros((n, 3), jnp.float32)
    key = jax.random.PRNGKey(0)

    t0 = time.perf_counter()
    loss0, g = loss_and_grad(params, skeleton, cfg, ids, target, key, accel)
    jax.block_until_ready(g)
    grad_compile = time.perf_counter() - t0
    gstats = {}
    for k in ("vertices", "mat_albedo", "light_intensity", "light_pos"):
        a = np.asarray(g[k])
        gstats[k] = float(np.abs(a).max())
        sm.check(np.isfinite(a).all() and gstats[k] > 0,
                 f"gradient of {k} is not finite and nonzero")

    def loss_at(name, flat_index, delta):
        p = dict(params)
        arr = np.asarray(params[name]).copy()
        arr.reshape(-1)[flat_index] += delta
        p[name] = jnp.asarray(arr)
        # an accel packs geometry at build time: rebuild it for moved
        # vertices, or the select would still see the old triangles
        acc = (_accel(merge_params(p, skeleton), backend, sm.rehearse)
               if name == "vertices" else accel)
        return float(loss_and_grad(p, skeleton, cfg, ids, target, key,
                                   acc)[0])

    # light_intensity[0]; the vertex coordinate is the depth (z) of the
    # back wall's first corner: it tilts a large wall seen by many rays.
    vtx = 3 * int(np.asarray(scene.tri_vidx)[_back_wall_tri(scene), 0]) + 2
    fd = {}
    for name, idx, h in [("light_intensity", 0,
                          0.05 * float(params["light_intensity"][0])),
                         ("vertices", vtx, 0.02)]:
        num = (loss_at(name, idx, h) - loss_at(name, idx, -h)) / (2 * h)
        an = float(np.asarray(g[name]).reshape(-1)[idx])
        fd[name] = abs(num - an) / max(abs(num), abs(an), 1e-12)
        sm.check(fd[name] < 0.05, f"FD {name}: analytic {an} vs FD {num}")

    p = jax.tree_util.tree_map(jnp.array, params)
    t0 = time.perf_counter()
    p, losses = train_steps(p, skeleton, cfg, ids, target, key, n_steps=8,
                            accel=accel)
    jax.block_until_ready(losses)
    comp = time.perf_counter() - t0
    t0 = time.perf_counter()
    p, losses = train_steps(p, skeleton, cfg, ids, target,
                            jax.random.PRNGKey(1), n_steps=8, accel=accel)
    jax.block_until_ready(losses)
    steady = time.perf_counter() - t0
    sm.check(np.isfinite(np.asarray(losses)).all(), "non-finite losses")
    mem = train_steps.lower(p, skeleton, cfg, ids, target, key, n_steps=8,
                            accel=accel).compile().memory_analysis()
    memd = {k: getattr(mem, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if mem is not None and hasattr(mem, k)}
    sm.emit("train", ok=True, backend=backend, rays_per_step=n,
            grad_compile_s=grad_compile, compile_s=comp, steady_s=steady,
            rays_per_s=8 * n / steady, losses=np.asarray(losses).tolist(),
            grad_max_abs=gstats, fd_rel_err=fd, memory_analysis=memd)


def _back_wall_tri(scene):
    """Index of the first triangle of the room's back wall (the z = -5
    face)."""
    import numpy as np
    corners = np.asarray(scene.vertices)[np.asarray(scene.tri_vidx)]
    on_back = np.all(np.abs(corners[..., 2] + 5.0) < 1e-6, axis=1)
    return int(np.flatnonzero(on_back & np.asarray(scene.tri_valid))[0])


def phase_four_gpus(sm, paths, backend):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from simd_raytracer import RenderConfig, parse_scene_file, render_frame
    from simd_raytracer.ops.grad import loss_and_grad, split_params
    from simd_raytracer.parallel.sharding import (make_mesh,
                                                  render_frame_sharded,
                                                  train_step_sharded)

    sm.check(len(jax.devices()) >= 4, f"{len(jax.devices())} devices < 4")
    mesh = make_mesh(4)
    scene = parse_scene_file(paths["dragon"])
    if sm.rehearse:
        scene = scene.replace(height=27, width=48)
    chunk = 256 if sm.rehearse else 16384
    # deterministic: centred spp 1, split tree, no GI -> no randomness.
    # Depth 1: the mesh splits the chunk axis whatever the depth, and
    # every bounce adds compile time to each of the four programs here.
    cfg = RenderConfig(samples_per_pixel=1, bounce_mode="split",
                       max_ray_depth=1, intersector=backend,
                       chunk_size=chunk)
    accel = _accel(scene, backend, sm.rehearse)
    comp1, steady1 = _timed(lambda: render_frame(scene, cfg, accel=accel))
    ref = np.asarray(render_frame(scene, cfg, accel=accel))
    comp4, steady4 = _timed(
        lambda: render_frame_sharded(scene, cfg, mesh, accel=accel))
    got = np.asarray(render_frame_sharded(scene, cfg, mesh, accel=accel))
    diff = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    off = float((diff.max(axis=-1) > 1e-4).mean())
    rays = scene.height * scene.width
    # Same kernels on the same card type; only XLA's fusion of the chunk
    # body may differ (FMA contraction), so at most 1e-4 of pixels may
    # flip a last-ulp edge winner.
    ok = off <= 1e-4
    sm.emit("sharded_render", ok=ok, devices=4, backend=backend,
            compile_s=comp4, steady_s=steady4, rays_per_s=rays / steady4,
            single_compile_s=comp1, single_steady_s=steady1,
            single_rays_per_s=rays / steady1, pixels_off=off,
            max_rel_diff=float(diff.max()))
    sm.check(ok, f"sharded render differs on {off:.2e} of pixels")

    params, skeleton = split_params(scene)
    per_dev = 64 if sm.rehearse else 16384
    total = scene.height * scene.width
    ids = (jnp.arange(4 * per_dev, dtype=jnp.int32)
           + (total - 4 * per_dev) // 2)
    target = jnp.zeros((4 * per_dev, 3), jnp.float32)
    # The sharded step returns only p - lr * g.  A large lr lifts lr * g
    # far above the float32 spacing of the parameters, so the update
    # still resolves the gradient.
    lr = 10.0
    loss1, g1 = loss_and_grad(params, skeleton, cfg, ids, target,
                              jax.random.PRNGKey(0), accel)
    seeds = jnp.zeros((4, 1), jnp.uint32)
    t0 = time.perf_counter()
    new_p, loss4 = train_step_sharded(
        params, skeleton, cfg, mesh, ids.reshape(4, per_dev),
        target.reshape(4, per_dev, 3), seeds, lr=lr, accel=accel)
    jax.block_until_ready(new_p)
    comp_t = time.perf_counter() - t0
    loss_rel = abs(float(loss4) - float(loss1)) / abs(float(loss1))
    # Tolerance: per-shard means pmean'd in another order than one mean
    # over all rays -> f32 reassociation only, so gradients agree to 1e-3
    # of the largest one.  The update itself may round either way (an
    # FMA or not), hence one float32 spacing of the parameter each side.
    worst = 0.0
    for k in ("vertices", "mat_albedo", "light_intensity", "light_pos"):
        p = np.asarray(params[k], np.float32)
        gk = np.asarray(g1[k], np.float32)
        want = p - np.float32(lr) * gk
        slack = 2 * np.spacing(np.abs(p))
        err = np.maximum(np.abs(np.asarray(new_p[k]) - want) - slack, 0.0)
        scale = lr * max(float(np.abs(gk).max()), 1e-12)
        worst = max(worst, float(err.max()) / scale)
    ok = loss_rel < 1e-5 and worst < 1e-3
    # CPU meshes run the cond-free graph (parallel/sharding.py)
    skip = cfg.bounce_skip and mesh.devices.flat[0].platform != "cpu"
    sm.emit("sharded_train", ok=ok, devices=4, backend=backend,
            bounce_skip=skip, rays=4 * per_dev,
            compile_s=comp_t, loss_rel_diff=loss_rel,
            grad_max_rel_diff=worst)
    sm.check(ok, "sharded train step disagrees with one card")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true")
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args()
    device = None
    try:
        import jax
        from simd_raytracer.config import DEFAULT_INTERSECTOR
        from simd_raytracer.utils.compile_cache import enable

        enable()
        dev = jax.devices()[0]
        device = {"platform": dev.platform, "kind": dev.device_kind,
                  "count": len(jax.devices())}
        if dev.platform != "gpu" and not args.rehearse:
            raise RuntimeError(f"no GPU: JAX's default device is "
                               f"{dev.platform} ({dev.device_kind})")
        sm = Smoke(args.rehearse)
        print(sm.info["nvidia_smi"] or "nvidia-smi: not available",
              flush=True)
        print(json.dumps({"device_kind": dev.device_kind,
                          "jax": jax.__version__,
                          "xla_flags": os.environ.get("XLA_FLAGS", "")}),
              flush=True)
        os.makedirs(OUT, exist_ok=True)
        paths = phase_generate(sm, os.path.join(OUT, "scenes"))
        backend = DEFAULT_INTERSECTOR
        if args.four_gpus:
            phase_four_gpus(sm, paths, backend)
            device["count"] = 4
        else:
            phase_dragon_cli(sm, paths)
            phase_select(sm, paths, ["kdtree", "sweep"])
            roulette = phase_room(sm, paths, "sweep")
            phase_refexact(sm, paths, backend, roulette)
            phase_oracle(sm, paths, backend)
            phase_train(sm, paths, backend)
    except BaseException as e:  # noqa: BLE001 — report, then fail
        traceback.print_exc()
        print(json.dumps({"ok": False, "error": f"{type(e).__name__}: {e}",
                          "device": device}), flush=True)
        return 1
    line = {"ok": True, "device": device}
    if args.rehearse:
        line["rehearsal"] = True
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
