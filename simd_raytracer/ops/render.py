"""Frame rendering: chunked wavefront path tracing.

The reference renders by draining a mutex-protected queue of pixel tiles
with a jthread pool (reference: include/raytracer/render/render.hpp:79-105,
render/tile/bucket.hpp:7-21).  Here the equivalent is static
decomposition: (pixel, sample) pairs are flattened into one ray-id axis,
cut into fixed-size chunks (static shapes for XLA), and each chunk runs the
full bounce loop as one fused program via lax.map — and, when sharded, the
chunk axis is split across the device mesh with the scene replicated
(see parallel/sharding.py).

Per chunk, the bounce loop is unrolled max_ray_depth+1 times with the ray
buffer widening by the child-slot factor K each bounce; the contribution of
bounce d folds back to its primary ray by a reshape-sum (children of ray r
occupy the contiguous block [r*K^d, (r+1)*K^d)), which replaces scatter
with a dense reduction.

Sparsity (the reference gets it free from recursion — dead paths just
return) is recovered by SEGMENTED execution: each bounce past the first
sorts its wavefront alive-first and lax.maps one compiled cap-wide
bounce body over the segments, skipping all-dead ones with a cond.  Cost
then tracks live-ray count, XLA compiles a single body per depth (the
K^depth-wide graphs never exist), and per-slot RNG makes the gathers
bitwise invisible.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig
from ..models.camera import primary_rays
from ..models.scene import Geometry, Scene, derive_geometry
from .intersect import trace
from .shade import shade


def render_chunk(scene: Scene, geom: Geometry, cfg: RenderConfig,
                 ray_ids: jnp.ndarray, key: jax.Array,
                 accel=None) -> jnp.ndarray:
    """Render one chunk of (pixel, sample) ray ids -> (R0, 3) colors.

    ray_ids are global ids in [0, H*W*spp); ids >= total are padding and
    contribute zero.  Output is the per-ray color (the caller averages spp
    groups, render.hpp:72).
    """
    r0 = ray_ids.shape[0]
    spp = cfg.samples_per_pixel
    h, w = scene.height, scene.width
    total = h * w * spp
    dtype = scene.vertices.dtype

    valid = ray_ids < total
    ids = jnp.minimum(ray_ids, total - 1)
    pix = ids // spp
    pix_y = pix // w
    pix_x = pix % w

    if spp == 1:
        # Centered samples (render.hpp:39-41).
        jx = jnp.full((r0,), 0.5, dtype)
        jy = jx
    else:
        jit_key = jax.random.fold_in(key, 0)
        jxy = jax.random.uniform(jit_key, (r0, 2), dtype)
        jx, jy = jxy[:, 0], jxy[:, 1]

    o, d = primary_rays(scene, cfg.fov_degrees, pix_x, pix_y, jx, jy)
    weight = valid.astype(dtype)
    miss_bg = jnp.ones((r0,), bool)   # primary miss -> background
    accum = jnp.zeros((r0, 3), dtype)
    bg = scene.background

    for depth in range(cfg.max_ray_depth + 1):
        last = depth == cfg.max_ray_depth
        n_cur = weight.shape[0]
        bounce_key = jax.random.fold_in(key, depth + 1)

        # Per-slot uniforms drawn at the FULL wavefront width before any
        # compaction, so a ray's randomness follows its slot through
        # gathers — compaction/segmentation is bitwise invariant.
        rnds = ()
        if not last:
            if cfg.bounce_mode == "roulette":
                rnds += (jax.random.uniform(
                    jax.random.fold_in(bounce_key, 1), (n_cur,), dtype),)
            if cfg.diffuse_reflection_ray_count > 0:
                rnds += (jax.random.uniform(
                    bounce_key,
                    (n_cur, cfg.diffuse_reflection_ray_count, 2), dtype),)

        def bounce_body(args, depth=depth, last=last,
                        bounce_key=bounce_key):
            o, d, weight, miss_bg = args[:4]
            rnds_in = args[4:]
            hit = trace(o, d, scene, geom, cfg.epsilon, cull=(depth == 0),
                        intersector=cfg.intersector, accel=accel)
            live_w = weight
            miss_term = live_w * (~hit.mask & miss_bg)
            contrib = miss_term[:, None] * bg
            if last:
                # Depth cutoff returns background (render.hpp:138-139).
                contrib = contrib + (live_w * hit.mask)[:, None] * bg
                return contrib, args[:4]
            i = 0
            rnd_coin = rnd_gi = None
            if cfg.bounce_mode == "roulette":
                rnd_coin, i = rnds_in[i], i + 1
            if cfg.diffuse_reflection_ray_count > 0:
                rnd_gi = rnds_in[i]
            shade_contrib, children = shade(
                scene, geom, hit, d, weight, cfg, bounce_key, accel,
                rnd_coin=rnd_coin, rnd_gi=rnd_gi)
            return contrib + shade_contrib, children

        def bounce_skip(args):
            # Dead rays: no contribution, children stay dead.  The
            # reference's recursion simply does not recurse here; the flat
            # wavefront must skip explicitly or an all-diffuse scene pays
            # the full depth budget tracing zero-weight rays.  Outputs are
            # derived from the inputs (not fresh zeros) so that under
            # shard_map they inherit the same varying mesh axes as the
            # real bounce branch.
            o_, d_, w_, bgm = args[:4]
            contrib = jnp.zeros_like(o_)
            if last:
                return contrib, args[:4]
            k = cfg.child_slots
            return contrib, (
                jnp.tile(o_ * 0.0, (k, 1)),
                jnp.tile(d_ * 0.0, (k, 1)).at[:, 2].set(-1.0),
                jnp.tile(w_ * 0.0, k),
                jnp.tile(bgm & False, k))

        def _scatter3(n, idx, vals, fills=(0.0, 0.0, 0.0)):
            out = jnp.zeros((n, 3), vals.dtype)
            for col, fill in enumerate(fills):
                if fill != 0.0:
                    out = out.at[:, col].set(fill)
            return out.at[idx].set(vals)

        def bounce_compact(args, cap, order):
            # Exact compaction: when the live set fits in cap slots,
            # gather it (per-slot RNG travels with the ray, so values are
            # bitwise identical), run ONE bounce at reduced width, scatter
            # children back.
            n = args[2].shape[0]
            k = 1 if last else cfg.child_slots
            idx = order[:cap]
            sub = tuple(a[idx] for a in args)
            contrib_c, (oc, dc, wc, bgc) = bounce_body(sub)
            contrib = _scatter3(n, idx, contrib_c)
            if last:
                return contrib, args[:4]
            cidx = (idx[:, None] * k + jnp.arange(k)[None, :]).reshape(-1)
            o2 = _scatter3(n * k, cidx, oc)
            d2 = _scatter3(n * k, cidx, dc, fills=(0.0, 0.0, -1.0))
            w2 = jnp.zeros((n * k,), dtype).at[cidx].set(wc)
            bg2 = jnp.zeros((n * k,), bool).at[cidx].set(bgc)
            return contrib, (o2, d2, w2, bg2)

        def bounce_segmented(args, cap, order):
            # Exact sparse execution: sort the wavefront alive-first (by
            # SLOT, randomness travels with the ray), cut it into
            # cap-wide segments, and lax.map a single compiled
            # bounce-body over them with a per-segment all-dead skip.
            # Live rays occupy the first ceil(alive/cap) segments, so
            # cost adapts to occupancy like the reference's recursion
            # (dead paths return immediately) while XLA sees ONE body
            # per depth — no K^depth-wide fallback graphs to compile.
            # Children of the ray in slot s scatter to s*K..s*K+K-1,
            # preserving the contiguous-block fold-back invariant.
            # `order` (alive-first slot permutation) is computed by the
            # caller OUTSIDE the lax.cond — a sort inside a
            # differentiated cond branch heap-corrupts XLA:CPU under
            # shard_map (same invariant as render.py's tiered dispatch
            # and shade.py's shadow compaction).
            n = args[2].shape[0]
            k = 1 if last else cfg.child_slots
            segs = n // cap
            seg_in = tuple(a[order].reshape((segs, cap) + a.shape[1:])
                           for a in args)

            def seg_fn(seg):
                return jax.lax.cond(jnp.any(seg[2] > 0.0), bounce_body,
                                    bounce_skip, seg)

            contrib_s, children_s = jax.lax.map(seg_fn, seg_in)
            contrib = _scatter3(n, order, contrib_s.reshape(n, 3))
            if last:
                return contrib, args[:4]
            cidx = (order[:, None] * k + jnp.arange(k)[None, :]).reshape(-1)
            oc, dc, wc, bgc = (a.reshape((n * k,) + a.shape[2:])
                               for a in children_s)
            o2 = _scatter3(n * k, cidx, oc)
            d2 = _scatter3(n * k, cidx, dc, fills=(0.0, 0.0, -1.0))
            w2 = jnp.zeros((n * k,), dtype).at[cidx].set(wc)
            bg2 = jnp.zeros((n * k,), bool).at[cidx].set(bgc)
            return contrib, (o2, d2, w2, bg2)

        args = (o, d, weight, miss_bg) + rnds
        if depth == 0 or not cfg.bounce_skip:
            contrib, (o, d, weight, miss_bg) = bounce_body(args)
        else:
            if cfg.bounce_mode == "roulette":
                cap = (n_cur // cfg.compact_factor
                       if cfg.compact_factor > 1 else n_cur)
            else:
                # split widens by K each bounce but the live count stays
                # ~chunk-sized (only refractive hits branch): compact to
                # the primary width r0.  The overflow fallback (live >
                # r0, e.g. a chunk fully inside a refractive object)
                # runs the SAME r0-wide body segment-by-segment instead
                # of one K^depth-wide op, so XLA never compiles the
                # giant graphs yet every case stays exact.
                cap = min(r0, n_cur)
            if 0 < cap < n_cur and n_cur % cap == 0:
                alive_n = jnp.sum(weight > 0.0)
                # Permutation computed OUTSIDE the conds (a sort inside
                # a differentiated cond branch heap-corrupts XLA:CPU
                # under shard_map); the compact branch and the
                # segmented-overflow branch both consume the same
                # alive-first permutation.
                order = jnp.argsort(~(weight > 0.0), stable=True)
                if cfg.bounce_mode == "roulette":
                    overflow_fn = bounce_body
                else:
                    overflow_fn = functools.partial(bounce_segmented,
                                                    cap=cap, order=order)
                comp = functools.partial(bounce_compact, cap=cap,
                                         order=order)

                def dispatch(a):
                    return jax.lax.cond(alive_n <= cap, comp, overflow_fn,
                                        a)

                contrib, (o, d, weight, miss_bg) = jax.lax.cond(
                    alive_n == 0, bounce_skip, dispatch, args)
            else:
                contrib, (o, d, weight, miss_bg) = jax.lax.cond(
                    jnp.any(weight > 0.0), bounce_body, bounce_skip, args)
        accum = accum + contrib.reshape(r0, -1, 3).sum(axis=1)

    return accum


@functools.partial(jax.jit, static_argnames=("cfg",))
def _render_ids(scene: Scene, cfg: RenderConfig,
                ids: jnp.ndarray, keys: jnp.ndarray,
                accel=None) -> jnp.ndarray:
    """jit entry: ids (C, R0), keys (C,) -> colors (C, R0, 3)."""
    geom = derive_geometry(scene)

    def one(args):
        chunk_ids, chunk_key = args
        return render_chunk(scene, geom, cfg, chunk_ids, chunk_key, accel)

    return jax.lax.map(one, (ids, keys))


@functools.partial(jax.jit, static_argnames=("cfg",))
def _render_image(scene: Scene, cfg: RenderConfig,
                  ids: jnp.ndarray, keys: jnp.ndarray,
                  accel=None) -> jnp.ndarray:
    """Whole-frame jit: linear-ordered chunks -> (H, W, 3) on device.

    Chunks stream through a lax.scan that scatter-adds each chunk's
    sample colors into an (H*W, 3) accumulator, so device memory is
    O(image), independent of spp (a lax.map would materialize the full
    (chunks, chunk_size, 3) sample buffer — 60 GB at 960^2 x 128 spp).
    Per-pixel sums accumulate in chunk order; for spp > 1 this is a
    different (equally valid) float summation order than a per-pixel
    reduce.  The host round trip moves only the final image.
    """
    h, w, spp = scene.height, scene.width, cfg.samples_per_pixel
    total = h * w * spp
    geom = derive_geometry(scene)

    if ids.size * 3 * 4 <= 1 << 30:
        # Small sample buffer: one map over chunks, then a per-pixel
        # reshape-sum instead of the scatter-add scan below.
        colors = _render_ids.__wrapped__(scene, cfg, ids, keys, accel)
        flat = colors.reshape(-1, 3)
        if resolved_ray_order(cfg) == "tiled":
            # The tiled id order is a block transpose of padded full
            # blocks (_tiled_ids), so the image is recovered with a
            # reshape/transpose — no gather.
            b = TILE_BLOCK
            nby, nbx = -(-h // b), -(-w // b)
            n = nby * nbx * b * b * spp
            blocks = flat[:n].reshape(nby, nbx, b, b, spp, 3)
            img = blocks.transpose(0, 2, 1, 3, 4, 5).reshape(
                nby * b, nbx * b, spp, 3)[:h, :w].sum(axis=2) / spp
            return img
        flat = flat[:total]
        img = flat.reshape(h * w, spp, 3).sum(axis=1) / spp
        return img.reshape(h, w, 3)

    def step(accum, args):
        chunk_ids, chunk_key = args
        colors = render_chunk(scene, geom, cfg, chunk_ids, chunk_key,
                              accel)
        valid = chunk_ids < total
        pix = jnp.minimum(chunk_ids, total - 1) // spp
        accum = accum.at[pix].add(
            jnp.where(valid[:, None], colors, 0.0))
        return accum, None

    accum0 = jnp.zeros((h * w, 3), scene.vertices.dtype)
    accum, _ = jax.lax.scan(step, accum0, (ids, keys))
    return (accum / spp).reshape(h, w, 3)


def resolved_ray_order(cfg: RenderConfig) -> str:
    if cfg.ray_order != "auto":
        return cfg.ray_order
    return "tiled" if cfg.intersector == "sweep" else "linear"


# Screen-block edge for the tiled ray order.  A sweep kernel ray tile
# (accel/sweep.py R_TILE rays) then covers a compact screen patch, which
# is what makes its per-tile interval boxes tight.
TILE_BLOCK = 32


def _tiled_ids(h: int, w: int, spp: int, block: int = TILE_BLOCK
               ) -> np.ndarray:
    """Ray ids ordered by full (padded) screen blocks.

    Every block is emitted complete — out-of-image pixels carry the
    sentinel id h*w*spp (invalid, weight 0) — so the flat color buffer
    has the exact shape (nby, nbx, block, block, spp, 3) and the image
    is recovered with a pure transpose instead of a 2M-row gather.  The
    moral equivalent of the reference's bucket tiles
    (tile/bucket.hpp:7-21), reused as a memory layout."""
    nby, nbx = -(-h // block), -(-w // block)
    by, bx, iy, ix = np.ogrid[0:nby, 0:nbx, 0:block, 0:block]
    y = by * block + iy
    x = bx * block + ix
    pix = (y * w + x).astype(np.int64)
    valid = (y < h) & (x < w)
    ids = (pix[..., None] * spp + np.arange(spp, dtype=np.int64))
    ids = np.where(valid[..., None], ids, h * w * spp)
    return ids.reshape(-1)


def make_ray_chunks(scene: Scene, cfg: RenderConfig, scheduling=None):
    """Host-side: (C, R0) int32 ray-id array covering H*W*spp, padded.

    scheduling: None (ray_order-controlled: linear pixel order or
    32x32-block tiled order) or a parallel.tiles.SchedulingType
    replicating the reference's tile orders (single / region grid /
    bucket tiles, tile/*.hpp).  The estimator is identical either way;
    order affects chunk locality, the sweep kernel's tile culling, and
    which pixels finish first under progressive rendering.
    """
    total = scene.height * scene.width * cfg.samples_per_pixel
    r0 = cfg.chunk_size
    if scheduling is not None:
        from ..parallel.tiles import make_schedule, schedule_to_chunks
        tiles = make_schedule(scheduling, scene.height, scene.width,
                              bucket=scene.bucket_size)
        return schedule_to_chunks(tiles, scene.width,
                                  cfg.samples_per_pixel, r0, total)
    if resolved_ray_order(cfg) == "tiled":
        ids = _tiled_ids(scene.height, scene.width, cfg.samples_per_pixel)
        c = -(-ids.size // r0)
        pad = np.full(c * r0 - ids.size, total, np.int64)
        return np.concatenate([ids, pad]).astype(np.int32).reshape(c, r0)
    c = -(-total // r0)
    ids = np.arange(c * r0, dtype=np.int32).reshape(c, r0)
    return ids


_IDS_CACHE: dict = {}


def _device_ray_chunks(scene: Scene, cfg: RenderConfig, scheduling):
    """make_ray_chunks + one host->device upload, cached per geometry.

    The id layout depends only on (H, W, spp, chunk, order), so a frame
    loop uploads the ~8 MB id array of a 1080p frame once.  The target
    device participates in the key so a later render under a different
    jax.default_device never reuses a buffer committed to the old
    device."""
    dev = jax.config.jax_default_device or jax.devices()[0]
    key = (scene.height, scene.width, cfg.samples_per_pixel,
           cfg.chunk_size, resolved_ray_order(cfg), scheduling,
           str(dev))
    ent = _IDS_CACHE.get(key)
    if ent is None:
        ids_np = make_ray_chunks(scene, cfg, scheduling)
        ent = (ids_np, jnp.asarray(ids_np))
        if len(_IDS_CACHE) >= 8:
            _IDS_CACHE.pop(next(iter(_IDS_CACHE)))
        _IDS_CACHE[key] = ent
    return ent


def render_frame(scene: Scene, cfg: RenderConfig = RenderConfig(),
                 key: Optional[jax.Array] = None,
                 accel=None, scheduling=None) -> jnp.ndarray:
    """Full-frame render -> (H, W, 3) float32 (linear color).

    Equivalent of render_frame (render.hpp:18-108): camera rays for every
    (pixel, sample), wavefront bounce loop, spp average.  With
    cfg.intersector == "kdtree" the accelerator is built on the host when
    not supplied (the analog of the kd_tree_simd_accel ctor at
    src/main.cpp:41).
    """
    if key is None:
        seed = cfg.rng_seed if cfg.rng_seed is not None else 0
        key = jax.random.PRNGKey(seed)
    spp = cfg.samples_per_pixel
    h, w = scene.height, scene.width
    total = h * w * spp

    if accel is None and cfg.intersector == "kdtree":
        from ..accel.build import build_kdtree_for_scene
        accel = build_kdtree_for_scene(scene)
    if accel is None and cfg.intersector == "sweep":
        from ..accel.sweep import build_sweep_for_scene
        accel = build_sweep_for_scene(scene)

    ids_np, ids = _device_ray_chunks(scene, cfg, scheduling)
    keys = jax.random.split(key, ids.shape[0])
    if scheduling is None:
        # Fast path: everything through the final (H, W, 3) image stays
        # on device; only the image crosses the host link.
        return _render_image(scene, cfg, ids, keys, accel)
    colors = _render_ids(scene, cfg, ids, keys, accel)
    # Scatter tile-ordered chunks back to pixel-major order.
    flat = np.asarray(colors).reshape(-1, 3)
    out = np.zeros((total, 3), flat.dtype)
    sel = ids_np.reshape(-1) < total
    out[ids_np.reshape(-1)[sel]] = flat[sel]
    img = out.reshape(h * w, spp, 3).sum(axis=1) / spp
    return jnp.asarray(img.reshape(h, w, 3))
