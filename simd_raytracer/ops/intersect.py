"""Ray-triangle intersection: batched Moller-Trumbore.

The reference's hot kernel is a width-W SIMD Moller-Trumbore over triangle
packets (reference: include/raytracer/render/accel/kd_tree_simd.hpp:26-60),
one ray against W triangles per instruction.  Here the same math runs a
whole ray wavefront against the whole triangle soup (or, for the sweep
kernel, a culled subset of it) as one fused elementwise+reduce program
over a (rays, triangles) grid.

Differentiability is split in two:
  * `select` — argmin over triangles (discrete winner choice).  Gradients
    through a piecewise-constant winner index are zero/undefined, so it is
    wrapped in stop_gradient.
  * `refine` — recompute t,u,v for the winning triangle only, in plain
    differentiable JAX, so d(hit)/d(vertices) flows through the winner's
    Moller-Trumbore formulas (the standard differentiable-renderer
    treatment of discrete visibility).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..models.scene import Geometry, Scene
from ..utils.pytree import pytree_dataclass

BIG = jnp.float32(3.4e38)  # stand-in for numeric_limits<float>::max


def _cross(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def mt_pairs(o_comp, d_comp, v0_comp, e1_comp, e2_comp, eps, cull):
    """Componentwise Moller-Trumbore over broadcastable operand grids.

    Each argument is a 3-tuple of x/y/z component arrays; all component
    arrays broadcast against each other (e.g. rays as (R,1) columns and
    triangles as (1,T) rows, or per-ray gathered leaves as (R,K)).
    Returns (t, ok) in the broadcast shape.

    Math mirrors triangle_packet::intersect (kd_tree_simd.hpp:26-60):
    backface culling keeps det > eps, otherwise |det| > eps; u in [0,1],
    v >= 0, u+v <= 1, t > eps.  Shared by the brute-force sweep and the
    kd-tree leaf test so their winning t values are bitwise identical.
    """
    ox, oy, oz = o_comp
    dx, dy, dz = d_comp
    v0x, v0y, v0z = v0_comp
    e1x, e1y, e1z = e1_comp
    e2x, e2y, e2z = e2_comp

    px, py, pz = _cross(dx, dy, dz, e2x, e2y, e2z)         # pvec
    det = e1x * px + e1y * py + e1z * pz
    if cull:
        ok = det > eps
    else:
        ok = jnp.abs(det) > eps
    inv_det = 1.0 / jnp.where(ok, det, 1.0)

    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z           # tvec
    u = (tvx * px + tvy * py + tvz * pz) * inv_det
    ok &= (u >= 0.0) & (u <= 1.0)

    qx, qy, qz = _cross(tvx, tvy, tvz, e1x, e1y, e1z)      # qvec
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    ok &= (v >= 0.0) & (u + v <= 1.0)

    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok &= t > eps
    return t, ok


def mt_select(
    o: jnp.ndarray,            # (R, 3) ray origins
    d: jnp.ndarray,            # (R, 3) ray directions
    v0: jnp.ndarray,           # (T, 3)
    e1: jnp.ndarray,           # (T, 3)
    e2: jnp.ndarray,           # (T, 3)
    eps: float,
    cull: bool,
    tri_mask: Optional[jnp.ndarray] = None,   # (T,) bool, False = skip
    t_max: Optional[jnp.ndarray] = None,      # (R,) inclusive t window
    any_hit: bool = False,
):
    """All-pairs Moller-Trumbore; returns (best_idx (R,) i32, hit (R,) bool).

    Misses get t = BIG before the min-reduce, like the
    `where(!mask, t) = best_t` lane masking at kd_tree_simd.hpp:276-287.

    t_max (optional, per ray) accepts only pairs with t <= t_max —
    inclusive, matching the reference's `t <= max_t` (render.hpp:121).
    any_hit=True returns (zeros, any-accepted-pair) without the
    argmin/min reduces: the occlusion predicate (render.hpp:110-131)
    needs no winner, so the reduction is a single `any`.
    """
    t, ok = mt_pairs(
        (o[:, 0:1], o[:, 1:2], o[:, 2:3]),                       # (R, 1)
        (d[:, 0:1], d[:, 1:2], d[:, 2:3]),
        (v0[None, :, 0], v0[None, :, 1], v0[None, :, 2]),        # (1, T)
        (e1[None, :, 0], e1[None, :, 1], e1[None, :, 2]),
        (e2[None, :, 0], e2[None, :, 1], e2[None, :, 2]),
        eps, cull)

    if tri_mask is not None:
        ok &= tri_mask[None, :]
    if t_max is not None:
        ok &= t <= t_max[:, None]
    if any_hit:
        return (jnp.zeros(o.shape[0], jnp.int32), jnp.any(ok, axis=1))

    t_masked = jnp.where(ok, t, BIG)
    best_idx = jnp.argmin(t_masked, axis=1).astype(jnp.int32)
    best_t = jnp.min(t_masked, axis=1)
    hit = best_t < BIG
    return best_idx, hit


def mt_refine(o, d, v0, e1, e2, eps: float = 1e-6):
    """Differentiable t,u,v for a single (per-ray) triangle.

    Same formulas as the scalar path (scene/primitive/triangle.hpp:32-67)
    without the accept/reject tests — the caller already knows this
    triangle is the winner.
    o,d: (R,3); v0,e1,e2: (R,3) gathered winner data.  Returns t,u,v (R,).
    eps should be the same intersection epsilon the select ran with.
    """
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    # Clamp at the intersection epsilon (a genuine winner always has
    # |det| > eps): a smaller clamp lets inv_det reach ~1e30 for the
    # degenerate records of missed rays, and d(1/det)/d(det) = -1/det^2
    # then overflows to inf -> 0*inf NaNs in the backward pass.
    inv_det = 1.0 / jnp.where(jnp.abs(det) > eps, det, eps)
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    return t, u, v


@pytree_dataclass
class HitRecord:
    """Wavefront hit record — SoA version of the reference's hit<F>
    (reference: include/raytracer/render/hit.hpp:9-21) plus gathered
    material attributes so shading needs no further indirection."""

    mask: jnp.ndarray       # (N,) bool — ray hit something
    idx: jnp.ndarray        # (N,) i32 winning triangle
    t: jnp.ndarray          # (N,)
    u: jnp.ndarray          # (N,)
    v: jnp.ndarray          # (N,)
    w: jnp.ndarray          # (N,)   barycentric 1-u-v
    position: jnp.ndarray   # (N,3)
    hit_n: jnp.ndarray      # (N,3) normalized smooth normal
    face_n: jnp.ndarray     # (N,3)
    uvs: jnp.ndarray        # (N,3,2) per-corner texture UVs
    mat_tag: jnp.ndarray    # (N,) i32
    albedo: jnp.ndarray     # (N,3)
    ior: jnp.ndarray        # (N,)
    smooth: jnp.ndarray     # (N,) bool
    tex: jnp.ndarray        # (N,) i32
    mesh_idx: jnp.ndarray   # (N,) i32


def make_select_fn(intersector: str, accel=None):
    """Resolve the closest-hit select backend.

    All backends share one call signature
    (o, d, v0, e1, e2, eps, cull, tri_mask) -> (idx, hit) — the batched
    analog of the reference's accelerator concept (accel/accel.hpp:8-12).
    """
    if intersector == "jnp":
        return mt_select
    if intersector == "sweep":
        if accel is None:
            raise ValueError("intersector='sweep' needs an accel: build "
                             "one with accel.sweep.build_sweep_for_scene")
        from .intersect_sweep import make_sweep_select
        return make_sweep_select(accel)
    if intersector == "kdtree":
        if accel is None:
            raise ValueError("intersector='kdtree' needs an accel: build "
                             "one with accel.build_kdtree_for_scene(scene)")

        def kd(o, d, v0, e1, e2, eps, cull, tri_mask=None,
               t_max=None, any_hit=False):
            from ..accel.traverse import kd_select
            idx, hit = kd_select(o, d, v0, e1, e2, eps, cull, tri_mask,
                                 accel)
            if t_max is not None:
                # Window emulation for the parity backend: the winner's
                # t decides (closest within window == closest if any is);
                # refine reproduces the pre-r5 occlusion comparison.
                t, _, _ = mt_refine(o, d, v0[idx], e1[idx], e2[idx], eps)
                hit = hit & (t <= t_max)
            if any_hit:
                idx = jnp.zeros_like(idx)
            return idx, hit

        return kd
    raise ValueError(intersector)


def trace(
    o: jnp.ndarray,
    d: jnp.ndarray,
    scene: Scene,
    geom: Geometry,
    eps: float,
    cull: bool,
    tri_mask: Optional[jnp.ndarray] = None,
    intersector: str = "jnp",
    accel=None,
) -> HitRecord:
    """Closest-hit query for a ray wavefront against the whole scene.

    Equivalent surface to `accelerator.intersect<cull>` (accel/accel.hpp:8-12)
    but batched: N rays in, N hit records out (mask=False for misses).
    """
    mask = tri_mask if tri_mask is not None else geom.tri_valid

    select = make_select_fn(intersector, accel)
    idx, hit = select(
        jax.lax.stop_gradient(o), jax.lax.stop_gradient(d),
        jax.lax.stop_gradient(geom.v0), jax.lax.stop_gradient(geom.e1),
        jax.lax.stop_gradient(geom.e2), eps, cull, mask)
    idx = jax.lax.stop_gradient(idx)
    hit = jax.lax.stop_gradient(hit)

    v0 = geom.v0[idx]
    e1 = geom.e1[idx]
    e2 = geom.e2[idx]
    t, u, v = mt_refine(o, d, v0, e1, e2, eps)
    # Missed rays carry idx=0 whose refine can hit the det clamp and
    # produce ~1e30-scale t; position then overflows f32 in r^2 terms and
    # the backward pass turns 0-weighted infs into NaNs.  Pin misses to a
    # harmless finite record (every consumer masks on `mask` anyway).
    t = jnp.where(hit, t, 1.0)
    u = jnp.where(hit, u, 0.0)
    v = jnp.where(hit, v, 0.0)
    w = 1.0 - u - v
    position = o + t[:, None] * d

    # Smooth normal interpolation + normalize (kd_tree_simd.hpp:252):
    # normalized(u*n1 + v*n2 + w*n0).
    vn = geom.vn[idx]                       # (N, 3corners, 3)
    n_interp = (u[:, None] * vn[:, 1] + v[:, None] * vn[:, 2]
                + w[:, None] * vn[:, 0])
    # Clamped rsqrt: NaN-free backward when n_interp degenerates to 0.
    sq = jnp.sum(n_interp * n_interp, axis=-1, keepdims=True)
    hit_n = n_interp * jax.lax.rsqrt(jnp.maximum(sq, 1e-18))

    mat = geom.tri_mat[idx]
    return HitRecord(
        mask=hit, idx=idx, t=t, u=u, v=v, w=w,
        position=position, hit_n=hit_n, face_n=geom.face_n[idx],
        uvs=geom.uv[idx],
        mat_tag=scene.mat_tag[mat], albedo=scene.mat_albedo[mat],
        ior=scene.mat_ior[mat], smooth=scene.mat_smooth[mat],
        tex=scene.mat_tex[mat], mesh_idx=geom.tri_mesh[idx],
    )
