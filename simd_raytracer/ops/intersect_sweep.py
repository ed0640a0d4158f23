"""Block-sparse sweep: closest hit via AABB-culled triangle slices, as a
Pallas kernel on the Triton route.

Triangles are packed into spatially tight slices (accel/sweep.py), each
with an AABB.  For every tile of `r_tile` rays the XLA side builds a
conservative, front-to-back slice schedule (`_tile_reach` interval
arithmetic over the tile's origin/direction boxes, then `_tile_schedule`
sorting the reachable slices by their entry-distance lower bound).  The
kernel runs one program per ray tile: it walks its own schedule row,
loads each slice's structure-of-arrays rows straight from device memory
(the whole sliced soup is small enough to stay in L2), runs the packet
Moller-Trumbore of mt_pairs on the (rays x slice) block and merges into
per-ray running winners, and stops at the first slice whose entry bound
exceeds every ray's best t — the tile-granular analog of the reference
kd traversal's `best_t < box.t_min` prune (kd_tree_simd.hpp:199-205).
A brute-force reduction cannot skip work that way; culled slices cost
nothing and a tile whose rays have all found near hits exits early.

Winners are identical to every other backend: ties resolve to the
lowest global triangle id, and dropping per-ray slab tests cannot change
a winner (any accepted hit lies inside its slice's AABB).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

BIG = 3.4e38
IMAX = 2**31 - 1


def _tile_reach(o, d, tmax, aabb, r_tile: int):
    """Conservative (tiles, slices) reach matrix -> (reach bool, t_near f32).

    A slice is reachable from a tile unless interval arithmetic over the
    tile's origin box x direction box PROVES no ray can enter the slice
    AABB within [0, max over tile of t_max].  Direction intervals that
    span zero constrain nothing on that axis (their 1/d interval is the
    whole line), so the test degrades gracefully for incoherent tiles —
    it only ever over-approximates, never culls a genuine hit.

    t_near is the per-(tile, slice) LOWER bound on any ray's entry
    distance into the slice box (0 where unconstrained) — the sort key
    for the kernel's front-to-back sweep and the proof obligation for
    its early exit (t_hit >= t_entry >= t_near, so a slice with
    t_near > best_t for every ray cannot improve any winner).
    """
    p = o.shape[0] // r_tile
    o_t = o.reshape(p, r_tile, 3)
    d_t = d.reshape(p, r_tile, 3)
    o_lo, o_hi = o_t.min(axis=1), o_t.max(axis=1)          # (P, 3)
    d_lo, d_hi = d_t.min(axis=1), d_t.max(axis=1)
    tcap = tmax.reshape(p, r_tile).max(axis=1)             # (P,)
    bmin, bmax = aabb[:, 0:3], aabb[:, 3:6]                # (S, 3)
    box_valid = jnp.all(bmax >= bmin, axis=1)              # (S,)

    # 1/d over a sign-uniform interval is [1/d_hi, 1/d_lo]; clamp the
    # near-zero blowup to +-BIG so 0 * inf never makes a NaN below
    # (NaN would compare False and cull a reachable slice).
    uniform = (d_lo > 0.0) | (d_hi < 0.0)                  # (P, 3)
    inv_lo = jnp.clip(1.0 / jnp.where(uniform, d_hi, 1.0), -BIG, BIG)
    inv_hi = jnp.clip(1.0 / jnp.where(uniform, d_lo, 1.0), -BIG, BIG)

    # numerator intervals per (tile, slice, axis)
    na_lo = bmin[None] - o_hi[:, None]                     # (P, S, 3)
    na_hi = bmin[None] - o_lo[:, None]
    nb_lo = bmax[None] - o_hi[:, None]
    nb_hi = bmax[None] - o_lo[:, None]

    def prod_bounds(n_lo, n_hi, i_lo, i_hi):
        p1, p2 = n_lo * i_lo, n_lo * i_hi
        p3, p4 = n_hi * i_lo, n_hi * i_hi
        return (jnp.minimum(jnp.minimum(p1, p2), jnp.minimum(p3, p4)),
                jnp.maximum(jnp.maximum(p1, p2), jnp.maximum(p3, p4)))

    il, ih = inv_lo[:, None, :], inv_hi[:, None, :]
    ta_lo, ta_hi = prod_bounds(na_lo, na_hi, il, ih)
    tb_lo, tb_hi = prod_bounds(nb_lo, nb_hi, il, ih)
    # near = min(tA, tB) pointwise (whichever plane the ray enters
    # first), so its lower bound is min of the lower bounds; dually far.
    near_lo = jnp.minimum(ta_lo, tb_lo)
    far_hi = jnp.maximum(ta_hi, tb_hi)
    unb = ~uniform[:, None, :]
    near_lo = jnp.where(unb, -BIG, near_lo)
    far_hi = jnp.where(unb, BIG, far_hi)
    t_near = jnp.maximum(jnp.max(near_lo, axis=2), 0.0)    # (P, S)
    t_far = jnp.min(far_hi, axis=2)
    reach = (t_far >= t_near) & (t_near <= tcap[:, None])
    return reach & box_valid[None, :], t_near


def _tile_schedule(reach, t_near):
    """Per-tile compacted front-to-back slice schedule.

    Returns order (P, S) i32 — slice ids, reachable first by ascending
    t_near — and tnear (P, S) f32 in that order, +inf past the reachable
    ones.  The kernel walks order[j] while tnear[j] <= the largest best t
    in its tile: later slices have even larger entry bounds (sorted), so
    no skipped slice can hold a winner, the inf sentinel ends the walk at
    the last reachable slice, and ties (==) keep going, preserving the
    lowest-id tie-break.
    """
    # inf sentinel, NOT BIG: a reachable slice can legitimately carry
    # t_near == BIG (tcap == BIG with a saturated 1/d interval) and must
    # sort strictly before every unreachable entry.
    key = jnp.where(reach, t_near, jnp.inf)
    order = jnp.argsort(key, axis=1).astype(jnp.int32)
    return order, jnp.take_along_axis(key, order, axis=1)


def _mt_merge(o, d, tri, gid, best_t, best_i, *, eps, cull, any_hit):
    """Packet Moller-Trumbore of (R, 1) ray columns x (1, T) triangle rows,
    merged into the running (best_t, best_i) of shape (R,).  Same math as
    mt_pairs (ops/intersect.py); lanes with gid < 0 are padding or masked.
    """
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = (det > eps) if cull else (jnp.abs(det) > eps)
    ok &= gid >= 0

    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u_num = tvx * px + tvy * py + tvz * pz
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v_num = dx * qx + dy * qy + dz * qz
    t_num = e2x * qx + e2y * qy + e2z * qz

    if any_hit:
        # Occlusion predicate: division-free accepts on the numerators
        # (u in [0,1] <=> 0 <= u_num*s <= |det| with s = sign(det), and
        # likewise for v, u+v and t) and one any-reduce instead of the
        # min/tie merge.  The inclusive t <= t_max window tests against best_t,
        # which stays at the ray's t_max until the ray decides (then -1,
        # so every later test is false and the tile can exit early).
        s = jnp.where(det >= 0.0, 1.0, -1.0)
        adet = det * s
        us, vs, ts = u_num * s, v_num * s, t_num * s
        ok &= (us >= 0.0) & (us <= adet)
        ok &= (vs >= 0.0) & (us + vs <= adet)
        ok &= ts > eps * adet
        ok &= ts <= best_t[:, None] * adet
        dec = (jnp.max(ok.astype(jnp.int32), axis=1) > 0) & (best_i == IMAX)
        return jnp.where(dec, -1.0, best_t), jnp.where(dec, 0, best_i)

    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    u = u_num * inv_det
    ok &= (u >= 0.0) & (u <= 1.0)
    v = v_num * inv_det
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = t_num * inv_det
    ok &= t > eps

    t_m = jnp.where(ok, t, BIG)
    blk_t = jnp.min(t_m, axis=1)
    blk_i = jnp.min(jnp.where(t_m == blk_t[:, None], gid, IMAX), axis=1)
    # blk_t == BIG rows (no accepted lane) tie-match every lane in the
    # where() above, so blk_i is a bogus min(gid) there — gate the whole
    # update on a real candidate t.  best_t seeded with t_max makes the
    # window INCLUSIVE (t == t_max ties the seed and wins on blk_i <
    # IMAX), matching the reference's t <= max_t (render.hpp:121).
    upd = ((blk_t < best_t)
           | ((blk_t == best_t) & (blk_i < best_i))) & (blk_t < BIG)
    return jnp.where(upd, blk_t, best_t), jnp.where(upd, blk_i, best_i)


def _kernel(ray_ref, order_ref, tnear_ref, tri_ref, gid_ref, idx_ref,
            hit_ref, *, width: int, eps: float, cull: bool, any_hit: bool):
    """One ray tile: walk its schedule row until no slice can improve."""
    o = tuple(ray_ref[k, :][:, None] for k in range(3))
    d = tuple(ray_ref[k, :][:, None] for k in range(3, 6))
    n_sched = order_ref.shape[0]

    def cond(carry):
        j, best_t, _ = carry
        # clamped read: & does not short-circuit, so j == n_sched must
        # still index in bounds (the j < n_sched term already kills it)
        jc = jnp.minimum(j, n_sched - 1)
        return (j < n_sched) & (tnear_ref[jc] <= jnp.max(best_t))

    def body(carry):
        j, best_t, best_i = carry
        lanes = pl.ds(pl.multiple_of(order_ref[j] * width, width), width)
        tri = tuple(tri_ref[k, lanes][None, :] for k in range(9))
        gid = gid_ref[lanes][None, :]
        best_t, best_i = _mt_merge(o, d, tri, gid, best_t, best_i, eps=eps,
                                   cull=cull, any_hit=any_hit)
        return j + 1, best_t, best_i

    best_t0 = ray_ref[6, :]
    best_i0 = jnp.full(best_t0.shape, IMAX, jnp.int32)
    _, _, best_i = jax.lax.while_loop(cond, body,
                                      (jnp.int32(0), best_t0, best_i0))
    won = best_i != IMAX
    idx_ref[:] = jnp.where(won, best_i, 0)
    hit_ref[:] = won.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=(
    "eps", "cull", "any_hit", "r_tile", "num_warps", "interpret"))
def _sweep_call(rays, order, tnear, tri, gid, *, eps: float, cull: bool,
                any_hit: bool, r_tile: int, num_warps: int,
                interpret: bool):
    """rays (8, Rp): o xyz, d xyz, t_max, pad; order/tnear (P, S);
    tri (9, S*T) slice-major SoA rows; gid (S*T,) i32 (-1 = skip lane)."""
    rp = rays.shape[1]
    p, s = order.shape
    width = gid.shape[0] // s
    kern = functools.partial(_kernel, width=width, eps=eps, cull=cull,
                             any_hit=any_hit)
    idx, hit = pl.pallas_call(
        kern,
        grid=(p,),
        in_specs=[
            pl.BlockSpec((8, r_tile), lambda i: (0, i)),
            pl.BlockSpec((None, s), lambda i: (i, 0)),
            pl.BlockSpec((None, s), lambda i: (i, 0)),
            pl.BlockSpec(tri.shape, lambda i: (0, 0)),
            pl.BlockSpec(gid.shape, lambda i: (0,)),
        ],
        out_specs=[pl.BlockSpec((r_tile,), lambda i: (i,)),
                   pl.BlockSpec((r_tile,), lambda i: (i,))],
        out_shape=[jax.ShapeDtypeStruct((rp,), jnp.int32),
                   jax.ShapeDtypeStruct((rp,), jnp.int32)],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        interpret=interpret,
        name="sweep_select",
    )(rays, order, tnear, tri, gid)
    return idx, hit


def make_sweep_select(sweep):
    """Bind SweepData into the common select signature
    (o, d, v0, e1, e2, eps, cull, tri_mask, t_max, any_hit) -> (idx, hit).

    v0/e1/e2 are ignored — slice geometry was packed at build time
    (select is stop-gradiented; the differentiable refine re-derives the
    winner's t/u/v from live vertices, ops/intersect.py).

    t_max (N,) accepts hits with t <= t_max (inclusive, like the
    reference's `t <= max_t`) and culls the slices past it; any_hit=True
    returns the first accepted hit inside the window instead of the
    closest (occlusion predicate — only hit-ness is specified).
    """
    r_tile = sweep.r_tile

    def select(o, d, v0, e1, e2, eps, cull, tri_mask=None,
               t_max=None, any_hit=False):
        r = o.shape[0]
        rp = -(-r // r_tile) * r_tile
        ids = sweep.tri_ids.reshape(-1)
        ok = ids >= 0
        if tri_mask is not None:
            ok &= tri_mask[jnp.maximum(ids, 0)]
        gid = jnp.where(ok, ids, -1)
        tm = (jnp.full((r,), BIG, jnp.float32) if t_max is None
              else t_max.astype(jnp.float32))
        # Padded rays get t_max = 0 (not BIG): they seed best_t at 0, so
        # they can never hold up the last tile's front-to-back early exit.
        o32 = jnp.pad(o.astype(jnp.float32), ((0, rp - r), (0, 0)))
        d32 = jnp.pad(d.astype(jnp.float32), ((0, rp - r), (0, 0)),
                      constant_values=1.0)
        tm = jnp.pad(tm, (0, rp - r))
        reach, t_near = _tile_reach(o32, d32, tm, sweep.aabb, r_tile)
        order, tnear = _tile_schedule(reach, t_near)
        rays = jnp.concatenate([o32.T, d32.T, tm[None],
                                jnp.zeros((1, rp), jnp.float32)])
        idx, hit = _sweep_call(rays, order, tnear, sweep.tri_soa, gid,
                               eps=float(eps), cull=bool(cull),
                               any_hit=bool(any_hit), r_tile=r_tile,
                               num_warps=sweep.num_warps,
                               interpret=sweep.interpret)
        return idx[:r], hit[:r] > 0

    return select
