"""Wavefront kd-tree traversal: iterative while_loop with per-ray stacks.

The reference walks the tree with an explicit per-thread stack of node ids
(reference: include/raytracer/render/accel/kd_tree_simd.hpp:188-228): pop,
slab-test the node AABB, prune when best_t < t_min, push children for
inner nodes, run the SIMD packet Moller-Trumbore for leaves (:266-302).

Here the same algorithm runs ALL rays in lockstep (SURVEY.md §7): the
stack is an (R, S) int32 array, one lax.while_loop iteration pops one
node per ray, and the leaf packet test intersects every ray against its
own leaf's fixed-width triangle row as a dense (R, CAP) block.  Rays that popped
an inner node or were pruned are masked out of the packet test.  The loop
ends when every ray's stack is empty; divergence costs idle lanes, not
serialization.

Winner selection is the lexicographic (t, triangle_id) minimum, matching
both the brute-force argmin and the reference's hmin + find_first_set
lane pick (:276-302) — equal-t ties resolve to the lowest triangle id, so
kd and brute-force renders are pixel-identical.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..ops.intersect import BIG, mt_pairs
from .build import KdTree

IMAX = jnp.int32(2**31 - 1)
MAX_STACK_SLOTS = 64   # sanity cap; a deeper tree raises (never clamps)
LEAF_SLICE = 64    # triangles tested per ray per inner step: bounds the
                   # (R, LEAF_SLICE) gather so huge duplicated leaves
                   # (depth-8 leaves can exceed the 64-triangle target,
                   # kd_tree_simd.hpp:65-66 only *tries* to stop there)
                   # never materialize an (R, cap) buffer


def _slab(o, inv_d, bmin, bmax):
    """Ray-AABB slab test (core/math/aabb3.hpp:74-90): returns
    (t_min clamped >= 0, hit).  NaNs from 0*inf (origin exactly on a slab
    plane of an axis-parallel ray) are treated as spanning the axis."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    lo = jnp.where(jnp.isnan(lo), -BIG, lo)
    hi = jnp.where(jnp.isnan(hi), BIG, hi)
    t_near = jnp.maximum(jnp.max(lo, axis=-1), 0.0)   # clamp like :85
    t_far = jnp.min(hi, axis=-1)
    return t_near, t_far >= t_near


def kd_select(
    o: jnp.ndarray,           # (R, 3)
    d: jnp.ndarray,           # (R, 3)
    v0: jnp.ndarray,          # (T, 3) triangle SoA
    e1: jnp.ndarray,
    e2: jnp.ndarray,
    eps: float,
    cull: bool,
    tri_mask: Optional[jnp.ndarray],   # (T,) bool or None
    tree: KdTree,
):
    """kd-tree closest-hit sweep; drop-in for ops.intersect.mt_select.

    Returns (best_idx (R,) i32, hit (R,) bool) identical to the
    brute-force winner (same t formula via mt_pairs, same tie-break).
    """
    r = o.shape[0]
    rows = jnp.arange(r)
    inv_d = 1.0 / d                     # ray3 caches inv_direction (:11-14)

    # DFS over a binary tree of depth D needs at most D+1 live stack
    # entries; +1 headroom for the two-slot push below.  tree.depth is a
    # static field measured from the built topology, so a too-deep build
    # fails loudly here instead of silently corrupting traversal.
    stack_slots = int(tree.depth) + 2
    if stack_slots > MAX_STACK_SLOTS:
        raise ValueError(
            f"kd-tree depth {tree.depth} needs {stack_slots} stack slots "
            f"(> cap {MAX_STACK_SLOTS}); build with a smaller max_depth")

    stack0 = jnp.zeros((r, stack_slots), jnp.int32)   # root = node 0
    sp0 = jnp.ones((r,), jnp.int32)
    best_t0 = jnp.full((r,), BIG, o.dtype)
    best_i0 = jnp.full((r,), IMAX, jnp.int32)

    cap = tree.leaf_cap
    n_slices = -(-cap // LEAF_SLICE)
    pad = n_slices * LEAF_SLICE - cap
    leaf_sliced = jnp.pad(tree.leaf_tris, ((0, 0), (0, pad)),
                          constant_values=-1
                          ).reshape(-1, n_slices, LEAF_SLICE)

    def cond(state):
        sp = state[1]
        return jnp.any(sp > 0)

    def body(state):
        stack, sp, best_t, best_i = state
        active = sp > 0
        top = jnp.maximum(sp - 1, 0)
        node = stack[rows, top]
        sp = jnp.where(active, sp - 1, sp)

        t_near, box_hit = _slab(o, inv_d, tree.node_min[node],
                                tree.node_max[node])
        # Prune when the running winner is closer than the box
        # (kd_tree_simd.hpp:203-205: best_t < t_min -> skip).
        visit = active & box_hit & (t_near <= best_t)

        c0 = tree.child0[node]
        is_leaf = c0 < 0

        # ---- leaf packet test (masked for rays on inner nodes) -------
        # Fixed-width slices keep peak memory at (R, LEAF_SLICE) however
        # large the fattest leaf is.
        lid = jnp.maximum(tree.leaf_id[node], 0)
        at_leaf = (visit & is_leaf)[:, None]

        def leaf_slice(s, carry):
            bt, bi = carry
            tris = leaf_sliced[lid, s]                # (R, SLICE) i32
            lane_ok = (tris >= 0) & at_leaf
            tidx = jnp.maximum(tris, 0)
            lv0 = v0[tidx]                            # (R, SLICE, 3)
            le1 = e1[tidx]
            le2 = e2[tidx]
            t, ok = mt_pairs(
                (o[:, 0:1], o[:, 1:2], o[:, 2:3]),
                (d[:, 0:1], d[:, 1:2], d[:, 2:3]),
                (lv0[..., 0], lv0[..., 1], lv0[..., 2]),
                (le1[..., 0], le1[..., 1], le1[..., 2]),
                (le2[..., 0], le2[..., 1], le2[..., 2]),
                eps, cull)
            ok &= lane_ok
            if tri_mask is not None:
                ok &= tri_mask[tidx]
            t_m = jnp.where(ok, t, BIG)
            leaf_t = jnp.min(t_m, axis=1)
            leaf_i = jnp.min(jnp.where(t_m == leaf_t[:, None], tidx, IMAX),
                             axis=1)
            upd = (leaf_t < bt) | ((leaf_t == bt) & (leaf_i < bi))
            return jnp.where(upd, leaf_t, bt), jnp.where(upd, leaf_i, bi)

        if n_slices == 1:
            best_t, best_i = leaf_slice(0, (best_t, best_i))
        else:
            best_t, best_i = jax.lax.fori_loop(
                0, n_slices, leaf_slice, (best_t, best_i))

        # ---- push children for visited inner nodes -------------------
        push = visit & ~is_leaf
        c1 = tree.child1[node]
        # Near-far ordering: visit the child on the ray's side of the
        # split plane first, so its hits tighten best_t before the far
        # child's `t_near <= best_t` prune runs (the reference pushes in
        # fixed order, :207-214; ordering is a strict improvement with
        # identical winners — closest-hit is order-independent).  The
        # split axis is recovered from the child box: child0's bmax
        # equals the node's bmax except on the split axis (= mid).
        c0s = jnp.maximum(c0, 0)
        axis = jnp.argmax(tree.node_max[c0s] != tree.node_max[node],
                          axis=-1)
        d_axis = jnp.take_along_axis(d, axis[:, None], axis=1)[:, 0]
        near_first = d_axis >= 0.0       # c0 holds the lower half
        first = jnp.where(near_first, c0, c1)
        second = jnp.where(near_first, c1, c0)
        # LIFO: `second` goes under `first`, so `first` pops first.
        slot0 = top   # stack_slots = depth+2 guarantees top+1 in bounds
        stack = stack.at[rows, slot0].set(
            jnp.where(push, second, stack[rows, slot0]))
        stack = stack.at[rows, slot0 + 1].set(
            jnp.where(push, first, stack[rows, slot0 + 1]))
        sp = jnp.where(push, sp + 2, sp)

        return stack, sp, best_t, best_i

    _, _, best_t, best_i = jax.lax.while_loop(
        cond, body, (stack0, sp0, best_t0, best_i0))

    hit = best_t < BIG
    return jnp.where(hit, best_i, 0), hit
