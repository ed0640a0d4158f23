"""Wavefront shading: the reference's recursive Whitted+GI shader
restructured as one iterative, branchless bounce step.

The reference shader (reference: include/raytracer/render/render.hpp:133-308)
is a recursive std::visit over five material variants.  Its recursion is
*linear* in the child colors: every material's output is
`direct_term + sum_i w_i * color(child_i)` —
  diffuse:    (sum GI children + direct lighting) / (N_gi + 1)
  texture:    direct lighting with sampled color
  reflective: color(mirror child), background on miss
  refractive: fresnel*color(reflection) + (1-fresnel)*color(refraction)
  constant:   albedo
so it unrolls exactly into a wavefront: each ray carries a scalar
throughput `weight` and a `miss_is_bg` flag; hits emit direct contributions
immediately and spawn up to K children with scaled weights.  One bounce of
every ray is a single fused XLA program in place of CPU recursion +
std::optional control flow.

Shadow rays replicate is_occluded (render.hpp:110-131): `fast` mode
resolves occlusion with a single closest-hit query that ignores
transmissive (refractive) triangles — equivalent up to the reference's
accumulated shadow_bias re-origining — while `march` mode reproduces the
iterative re-origined marching hop by hop.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..models.scene import (Geometry, MAT_CONSTANT, MAT_DIFFUSE,
                            MAT_REFLECTIVE, MAT_REFRACTIVE, MAT_TEXTURE,
                            Scene)
from ..models.textures import sample_texture
from .intersect import HitRecord, make_select_fn, mt_refine, trace

FOUR_PI = 4.0 * math.pi


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _safe_normalize(v):
    # rsqrt-with-clamp keeps the backward pass NaN-free when v == 0
    # (zero-length `perp` at normal incidence, degenerate normals); see
    # the same-named helper in models/scene.py.
    sq = jnp.sum(v * v, axis=-1, keepdims=True)
    return v * jax.lax.rsqrt(jnp.maximum(sq, 1e-18))


def occluded(o: jnp.ndarray, d: jnp.ndarray, max_t: jnp.ndarray,
             scene: Scene, geom: Geometry, cfg: RenderConfig,
             accel=None) -> jnp.ndarray:
    """Batched is_occluded (render.hpp:110-131). o,d (N,3); max_t (N,).

    Occlusion is a discrete visibility predicate — no gradients flow
    (consistent with treating visibility as piecewise constant).
    """
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    max_t = jax.lax.stop_gradient(max_t)
    eps = cfg.epsilon
    select = make_select_fn(cfg.intersector, accel)

    if cfg.occlusion_mode == "fast":
        # Transmissive surfaces never occlude and only re-originate the
        # march past themselves, so the first *non-transmissive* hit
        # decides.  Every backend implements the any-hit contract: an
        # INCLUSIVE t <= max_t window (the reference's `t <= max_t`,
        # render.hpp:121) and a pure hit predicate — brute backends drop
        # the argmin/min (and `fast`/`mxu` the (R, T) division) for one
        # `any` reduce; the sweep kernel seeds its running winner with
        # the light distance so slices beyond it cull and decided rays
        # take the early exit; no winner gather, no refine.
        mask = geom.tri_valid & ~geom.tri_transmissive
        _, hit = select(o, d, geom.v0, geom.e1, geom.e2, eps, False,
                        mask, t_max=max_t, any_hit=True)
        return hit

    # "march": faithful iterative replication (render.hpp:110-131) paid
    # only where it can differ from the windowed any-hit predicate.  Two
    # cheap any-hit probes over the same ray set — solid triangles and
    # transmissive ones (XLA CSEs the shared Moller-Trumbore pair grid;
    # only the masks and reduces differ) — decide most rays outright: a
    # ray with NO transmissive intersection inside its window never
    # re-originates, so its march result IS the solid predicate,
    # exactly.  Only rays that crossed glass (where re-origination, the
    # hop cap, or accumulated shadow_bias can change the answer) run
    # the real hop loop, compacted narrow.
    n = o.shape[0]

    def march_hop(o_cur, d_cur, mt_cur, undecided):
        # The remaining budget doubles as the select window: the closest
        # hit within it is the closest hit overall whenever one exists,
        # and backends with real windows (sweep slice culling, the
        # division-free numerator test in fast/mxu) get to prune.
        idx, hit = select(o_cur, d_cur, geom.v0, geom.e1, geom.e2,
                          eps, False, geom.tri_valid, t_max=mt_cur)
        t, _, _ = mt_refine(o_cur, d_cur, geom.v0[idx], geom.e1[idx],
                            geom.e2[idx], eps)
        transmissive = geom.tri_transmissive[idx]
        within = hit & (t <= mt_cur)
        occ_now = undecided & within & ~transmissive
        cont = undecided & within & transmissive
        pos = o_cur + t[:, None] * d_cur
        o_next = jnp.where(cont[:, None],
                           pos + cfg.shadow_bias * d_cur, o_cur)
        mt_next = jnp.where(cont, mt_cur - t, mt_cur)
        # Loop guard `while (0 < max_t)` (render.hpp:115).
        return occ_now, o_next, mt_next, cont & (mt_next > 0.0)

    def rest(o_c, d_c, mt_c, und_c):
        def cond(state):
            i, _o, _mt, _occ, und = state
            return (i < cfg.max_shadow_march - 1) & jnp.any(und)

        def body(state):
            i, o_cur, mt_cur, occ_c, und = state
            occ_now, o_n, mt_n, und_n = march_hop(o_cur, d_c, mt_cur,
                                                  und)
            return i + 1, o_n, mt_n, occ_c | occ_now, und_n

        init = (jnp.int32(0), o_c, mt_c,
                jnp.zeros(o_c.shape[0], bool), und_c)
        return jax.lax.while_loop(cond, body, init)[3]

    def march_full(o_c, d_c, mt_c, und_c):
        occ1, o1, mt1, und1 = march_hop(o_c, d_c, mt_c, und_c)
        if cfg.max_shadow_march <= 1:
            return occ1
        return occ1 | rest(o1, d_c, mt1, und1)

    if not cfg.bounce_skip:
        # Cond-free graph (the XLA:CPU shard_map workaround,
        # config.py::bounce_skip): the classic full-width march.
        return march_full(o, d, max_t, jnp.ones(n, bool))

    solid = geom.tri_valid & ~geom.tri_transmissive
    glass = geom.tri_valid & geom.tri_transmissive
    _, occ_solid = select(o, d, geom.v0, geom.e1, geom.e2, eps, False,
                          solid, t_max=max_t, any_hit=True)
    _, crossed = select(o, d, geom.v0, geom.e1, geom.e2, eps, False,
                        glass, t_max=max_t, any_hit=True)

    # Tiered narrow march over the glass-crossing rays (same dispatch
    # pattern + sort-outside-conds invariant as shade's shadow
    # compaction below).  Scenes without transmissive geometry skip the
    # march entirely via the n_crossed == 0 cond.
    n_crossed = jnp.sum(crossed)
    caps = ([c for c in (n // 8, n // 2) if 0 < c < n]
            if cfg.shadow_compact else []) + [n]
    order = (jnp.argsort(~crossed, stable=True) if len(caps) > 1
             else jnp.arange(n))

    def march_at(cap):
        if cap == n:
            return march_full(o, d, max_t, crossed)
        idx = order[:cap]
        occ_c = march_full(o[idx], d[idx], max_t[idx], crossed[idx])
        return jnp.zeros(n, bool).at[idx].set(occ_c)

    def dispatch(tiers):
        cap = tiers[0]
        if len(tiers) == 1:
            return march_at(cap)
        return jax.lax.cond(n_crossed <= cap, lambda: march_at(cap),
                            lambda: dispatch(tiers[1:]))

    occ_march = jax.lax.cond(n_crossed == 0,
                             lambda: jnp.zeros(n, bool),
                             lambda: dispatch(caps))
    return jnp.where(crossed, occ_march, occ_solid)


def direct_light_factor(scene: Scene, geom: Geometry, hit: HitRecord,
                        cfg: RenderConfig, accel=None) -> jnp.ndarray:
    """Sum over lights of  visibility * intensity/(4*pi*r^2) * cos_law.

    Replicates the per-light loop shared by diffuse and texture materials
    (render.hpp:184-206 / :213-237): inverse-square-sphere falloff, cosine
    against the smooth or face normal per material.smooth_shading, shadow
    ray from position + shadow_bias*light_dir with max_t = r.
    Returns the scalar factor (N,); the caller multiplies by albedo or the
    texture sample.
    """
    n_rays = hit.position.shape[0]
    nl = scene.light_pos.shape[0]

    ldir_un = scene.light_pos[None, :, :] - hit.position[:, None, :]  # (N,L)3
    r = jnp.sqrt(jnp.maximum(jnp.sum(ldir_un * ldir_un, axis=-1), 1e-24))
    ldir = ldir_un / r[..., None]
    area = FOUR_PI * r * r

    shade_n = jnp.where(hit.smooth[:, None], hit.hit_n, hit.face_n)
    cos_law = jnp.maximum(0.0, _dot(ldir, shade_n[:, None, :]))       # (N,L)

    shadow_o = hit.position[:, None, :] + cfg.shadow_bias * ldir
    # A (ray, light) pair with cos_law == 0 contributes nothing whatever
    # the visibility says, so its shadow query gets a zero-length window:
    # the march loop exits immediately (t <= 0 never holds) and — when
    # whole screen tiles face away from a light — the sweep kernel's
    # per-tile t_max cap culls every slice for them.  Values unchanged.
    max_t = jnp.where(cos_law > 0.0, r, 0.0)
    # Light-major batching: (N, L) -> (L, N) so consecutive shadow rays
    # share one light (coherent directions from a coherent hit patch);
    # ray-major interleaving would mix L different lights inside every
    # sweep ray tile and blow up its direction interval boxes.  Pure
    # layout change — per-ray occlusion results are order-independent.
    occ = occluded(shadow_o.transpose(1, 0, 2).reshape(-1, 3),
                   ldir.transpose(1, 0, 2).reshape(-1, 3),
                   max_t.T.reshape(-1), scene, geom, cfg, accel
                   ).reshape(nl, n_rays).T

    falloff = scene.light_intensity[None, :] / jnp.maximum(area, 1e-20)
    return jnp.sum(jnp.where(occ, 0.0, falloff * cos_law), axis=-1)


def shade(scene: Scene, geom: Geometry, hit: HitRecord,
          d_in: jnp.ndarray, weight: jnp.ndarray,
          cfg: RenderConfig, key: jax.Array, accel=None,
          rnd_coin: jnp.ndarray = None, rnd_gi: jnp.ndarray = None,
          ) -> Tuple[jnp.ndarray, Tuple]:
    """One wavefront bounce of shading.

    Inputs: hit records for N rays (mask=False rays ignored), incoming
    directions d_in (N,3), throughput weight (N,) already zeroed for dead
    rays.  Returns (contrib (N,3),
    children = (o' (N*K,3), d' (N*K,3), weight' (N*K,), miss_bg' (N*K,))).

    rnd_coin (N,) / rnd_gi (N, gi_count, 2) carry pre-drawn uniforms so a
    caller that compacts/segments the wavefront can keep each ray's
    randomness tied to its SLOT, not its position in the gathered buffer
    (bitwise invariance of compaction); if None they are drawn here from
    `key` positionally.
    """
    n = d_in.shape[0]
    k = cfg.child_slots
    gi_count = cfg.diffuse_reflection_ray_count

    live = weight * hit.mask.astype(weight.dtype)    # (N,) throughput of hits
    tag = hit.mat_tag
    is_diffuse = tag == MAT_DIFFUSE
    is_reflective = tag == MAT_REFLECTIVE
    is_refractive = tag == MAT_REFRACTIVE
    is_constant = tag == MAT_CONSTANT
    is_texture = tag == MAT_TEXTURE

    # ---- direct contributions --------------------------------------
    lit = is_diffuse | is_texture
    # Shadow rays cost a full occlusion select per light, so the query
    # set is compacted to the rays that can actually contribute: only
    # live diffuse/texture hits run the per-light loop in the reference's
    # recursion (render.hpp:184-206); everything else (misses, mirrors,
    # glass, dead lanes) is gathered out before the occlusion sweep.
    # Tiered lax.conds pick the narrowest compiled width that fits.
    if cfg.bounce_skip:
        need = lit & hit.mask & (weight > 0.0)
        n_need = jnp.sum(need)

        def factor_at(cap, idx):
            if cap == n:
                f = direct_light_factor(scene, geom, hit, cfg, accel)
                return jnp.where(need, f, 0.0)
            sub = jax.tree_util.tree_map(lambda a: a[idx], hit)
            f = direct_light_factor(scene, geom, sub, cfg, accel)
            f = jnp.where(need[idx], f, 0.0)
            return jnp.zeros_like(weight).at[idx].set(f)

        caps = ([c for c in (n // 8, n // 2) if 0 < c < n]
                if cfg.shadow_compact else []) + [n]
        # The gather permutation is computed OUTSIDE the conds (sort
        # inside a differentiated lax.cond branch heap-corrupts XLA:CPU
        # under shard_map; it is also cheap relative to the select).
        # Fully-lit chunks keep one wide occlusion op.
        order = (jnp.argsort(~need, stable=True) if len(caps) > 1
                 else jnp.arange(n))

        def dispatch(tiers):
            cap = tiers[0]
            if len(tiers) == 1:
                return factor_at(cap, order[:cap])
            return jax.lax.cond(n_need <= cap,
                                lambda: factor_at(cap, order[:cap]),
                                lambda: dispatch(tiers[1:]))

        factor = jax.lax.cond(n_need == 0,
                              lambda: jnp.zeros_like(weight),
                              lambda: dispatch(caps))
    else:
        factor = direct_light_factor(scene, geom, hit, cfg, accel)
    factor = jnp.where(lit, factor, 0.0)
    tex_color = sample_texture(scene, hit.tex, hit.u, hit.v, hit.w, hit.uvs)
    surf_color = jnp.where(is_texture[:, None], tex_color, hit.albedo)
    # diffuse divides its total (direct + GI) by (gi_count + 1)
    # (render.hpp:208); texture does not (render.hpp:211-238).
    direct_scale = jnp.where(is_diffuse, 1.0 / (gi_count + 1), 1.0)
    contrib = (live * factor * direct_scale)[:, None] * surf_color
    contrib += (live * is_constant)[:, None] * hit.albedo

    # ---- reflective child (render.hpp:239-250) ---------------------
    refl_dir = d_in - 2.0 * _dot(d_in, hit.hit_n)[:, None] * hit.hit_n
    refl_org = hit.position + cfg.reflection_bias * refl_dir

    # ---- refractive children (render.hpp:251-301) ------------------
    n_geo = jnp.where(hit.smooth[:, None], hit.hit_n, hit.face_n)
    nrm = _safe_normalize(n_geo)
    i_dir = _safe_normalize(d_in)
    din = _dot(i_dir, nrm)
    entering_flip = din > 0.0            # render.hpp:257-260
    nrm = jnp.where(entering_flip[:, None], -nrm, nrm)
    eta_i = jnp.where(entering_flip, hit.ior, 1.0)
    eta_r = jnp.where(entering_flip, 1.0, hit.ior)
    cos_i = -_dot(i_dir, nrm)
    # sqrt args clamped to a small positive value, not 0: sqrt'(0) = inf
    # and TIR rays evaluate the (masked-out) refraction branch, which
    # would inject NaN into the backward pass via 0 * inf.
    sin_i = jnp.sqrt(jnp.maximum(1e-12, 1.0 - cos_i * cos_i))
    tir = (eta_r / jnp.maximum(eta_i, 1e-20)) < sin_i   # render.hpp:266
    r_refl_dir = i_dir - 2.0 * _dot(i_dir, nrm)[:, None] * nrm
    r_refl_org = hit.position + cfg.reflection_bias * r_refl_dir
    sin_r = sin_i * eta_i / jnp.maximum(eta_r, 1e-20)
    cos_r = jnp.sqrt(jnp.maximum(1e-12, 1.0 - sin_r * sin_r))
    perp = _safe_normalize(i_dir + cos_i[:, None] * nrm)
    refr_dir = cos_r[:, None] * (-nrm) + sin_r[:, None] * perp
    refr_org = hit.position + cfg.refraction_bias * refr_dir
    # Pseudo-Fresnel 0.5*(1 + i.n)^5 (render.hpp:300); i.n == -cos_i here.
    fresnel = 0.5 * (1.0 - cos_i) ** 5

    # ---- diffuse GI children (render.hpp:151-182) ------------------
    if gi_count > 0:
        right = _safe_normalize(jnp.cross(d_in, hit.hit_n))
        up = hit.hit_n
        fwd = jnp.cross(right, up)
        rnd = (rnd_gi if rnd_gi is not None else
               jax.random.uniform(key, (n, gi_count, 2),
                                  dtype=weight.dtype))
        theta = jnp.pi * rnd[..., 0]
        phi = 2.0 * jnp.pi * rnd[..., 1]
        # rand vec (cos t, sin t, 0) rotated about Y by phi
        # (render.hpp:160-170): result = (cos phi * cos t, sin t,
        # sin phi * cos t).
        vx = jnp.cos(phi) * jnp.cos(theta)
        vy = jnp.sin(theta)
        vz = jnp.sin(phi) * jnp.cos(theta)
        # direction = mat3(right,up,fwd) * v, i.e. components are the
        # rows-dot-vec products (right.v, up.v, fwd.v) — replicated
        # literally from render.hpp:157,:173 + mat3.hpp:53-60.
        gi_dir = jnp.stack([
            right[:, None, 0] * vx + right[:, None, 1] * vy
            + right[:, None, 2] * vz,
            up[:, None, 0] * vx + up[:, None, 1] * vy + up[:, None, 2] * vz,
            fwd[:, None, 0] * vx + fwd[:, None, 1] * vy
            + fwd[:, None, 2] * vz,
        ], axis=-1)                                    # (N, gi_count, 3)
        gi_org = (hit.position + cfg.reflection_bias * hit.hit_n)[:, None, :]
        gi_org = jnp.broadcast_to(gi_org, gi_dir.shape)

    hit_live_rr = hit.mask & (weight > 0.0)
    if cfg.bounce_mode == "roulette":
        # ---- single stochastic child per ray (flat wavefront) -------
        # Each ray continues along one child chosen with probability
        # proportional to its branch weight, scaled to keep the estimator
        # unbiased: refractive picks reflection w.p. fresnel (weight
        # carried unchanged), diffuse picks one GI ray uniformly (weight
        # gi_count/(gi_count+1)).  TIR and reflective have one child
        # anyway, so only variance on refractive/GI paths changes.
        r_coin = (rnd_coin if rnd_coin is not None else
                  jax.random.uniform(jax.random.fold_in(key, 1), (n,),
                                     weight.dtype))
        c_o = hit.position                      # dead default (w=0)
        c_d = jnp.zeros((n, 3), weight.dtype).at[:, 2].set(-1.0)
        c_w = jnp.zeros((n,), weight.dtype)
        c_bg = jnp.zeros((n,), bool)

        def pick(sel, o_s, d_s, w_s, bg_s: bool):
            nonlocal c_o, c_d, c_w, c_bg
            c_o = jnp.where(sel[:, None], o_s, c_o)
            c_d = jnp.where(sel[:, None], d_s, c_d)
            c_w = jnp.where(sel, w_s, c_w)
            if bg_s:
                c_bg = c_bg | sel

        pick(hit_live_rr & is_reflective, refl_org, refl_dir, weight, True)
        take_reflect = tir | (r_coin < fresnel)
        pick(hit_live_rr & is_refractive & take_reflect,
             r_refl_org, r_refl_dir, weight, False)
        pick(hit_live_rr & is_refractive & ~take_reflect,
             refr_org, refr_dir, weight, False)
        if gi_count > 0:
            j = jnp.clip((r_coin * gi_count).astype(jnp.int32),
                         0, gi_count - 1)
            rows = jnp.arange(n)
            pick(hit_live_rr & is_diffuse, gi_org[rows, j], gi_dir[rows, j],
                 weight * gi_count / (gi_count + 1), False)

        children = (c_o, c_d, c_w, c_bg)
        return contrib, children

    # ---- assemble K child slots (full deterministic split) ----------
    child_o = jnp.zeros((n, k, 3), weight.dtype)
    child_d = jnp.zeros((n, k, 3), weight.dtype)
    child_d = child_d.at[..., 2].set(-1.0)   # harmless default direction
    child_w = jnp.zeros((n, k), weight.dtype)
    child_bg = jnp.zeros((n, k), bool)

    def put(slot, sel, o_s, d_s, w_s, bg_s: bool):
        sel3 = sel[:, None]
        nonlocal child_o, child_d, child_w, child_bg
        child_o = child_o.at[:, slot].set(
            jnp.where(sel3, o_s, child_o[:, slot]))
        child_d = child_d.at[:, slot].set(
            jnp.where(sel3, d_s, child_d[:, slot]))
        child_w = child_w.at[:, slot].set(
            jnp.where(sel, w_s, child_w[:, slot]))
        if bg_s:
            child_bg = child_bg.at[:, slot].set(
                child_bg[:, slot] | sel)

    hit_live = hit.mask & (weight > 0.0)
    # slot 0: mirror reflection (reflective), refr-reflection (refractive),
    # or first GI ray (diffuse).
    put(0, hit_live & is_reflective, refl_org, refl_dir, weight, True)
    refr_refl_w = jnp.where(tir, weight, weight * fresnel)
    put(0, hit_live & is_refractive, r_refl_org, r_refl_dir,
        refr_refl_w, False)
    # slot 1: refraction ray (skipped under total internal reflection,
    # render.hpp:266-276).
    put(1, hit_live & is_refractive & ~tir, refr_org, refr_dir,
        weight * (1.0 - fresnel), False)
    if gi_count > 0:
        gi_w = weight / (gi_count + 1)
        for s in range(gi_count):
            put(s, hit_live & is_diffuse, gi_org[:, s], gi_dir[:, s],
                gi_w, False)

    children = (child_o.reshape(n * k, 3), child_d.reshape(n * k, 3),
                child_w.reshape(n * k), child_bg.reshape(n * k))
    return contrib, children
