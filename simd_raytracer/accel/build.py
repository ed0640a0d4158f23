"""Host-side kd-tree construction, flattened to arrays for device traversal.

Replicates the reference build topology exactly
(reference: include/raytracer/render/accel/kd_tree_simd.hpp:146-185):

  * root AABB = union of all triangle AABBs (:101-111),
  * midpoint split cycling axis = depth % 3, skipping degenerate axes by
    advancing to (axis+1) % 3 like aabb3::split
    (core/math/aabb3.hpp:43-60),
  * a triangle whose AABB overlaps both half-boxes is DUPLICATED into both
    children (:160-170),
  * leaf when depth == max_depth (8) or count <= max_leaf_size (64)
    (:65-66).

Instead of pointer-chasing nodes, the tree is flattened into dense int32/
float32 arrays (a pytree) so traversal is an iterative, data-parallel
wavefront loop (SURVEY.md §7).  Leaf triangle lists are stored as
fixed-width rows of one (num_leaves, leaf_cap) index matrix — the moral
equivalent of the reference's SoA triangle packets padded to SIMD width
(:120-137), with -1 padding instead of repeating the last triangle
(deterministic either way; masked lanes never win).

A C++ builder with identical output lives in native/kdtree.cpp; the
NumPy implementation below is the portable fallback and the oracle the
native one is tested against.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np
from ..utils.pytree import pytree_dataclass, static_field

DEFAULT_MAX_DEPTH = 8     # kd_tree_simd.hpp:65
DEFAULT_MAX_LEAF = 64     # kd_tree_simd.hpp:66


@pytree_dataclass
class KdTree:
    """Flattened kd-tree (all device arrays; shapes static per scene).

    N nodes, L leaves, CAP = max leaf size padded to a multiple of 8.
    """

    node_min: jnp.ndarray    # (N, 3) f32
    node_max: jnp.ndarray    # (N, 3) f32
    child0: jnp.ndarray      # (N,) i32, -1 for leaves
    child1: jnp.ndarray      # (N,) i32, -1 for leaves
    leaf_id: jnp.ndarray     # (N,) i32 row into leaf_tris, -1 for inner
    leaf_tris: jnp.ndarray   # (L, CAP) i32 triangle ids, -1 padding
    # Static (non-pytree) actual tree depth, computed from the built
    # topology; traversal sizes its per-ray stack from this so a deep
    # build can never silently overflow the stack (it raises instead).
    depth: int = static_field(default=8)

    @property
    def num_nodes(self) -> int:
        return int(self.child0.shape[0])

    @property
    def leaf_cap(self) -> int:
        return int(self.leaf_tris.shape[1])


def tree_depth(child0: np.ndarray, child1: np.ndarray) -> int:
    """Depth of the flattened tree (root = depth 0), iteratively (the
    tree can be deeper than Python's recursion limit)."""
    c0 = np.asarray(child0)
    c1 = np.asarray(child1)
    depth = 0
    frontier = np.array([0], np.int32) if len(c0) else np.array([], np.int32)
    while True:
        kids = np.concatenate([c0[frontier], c1[frontier]])
        kids = kids[kids >= 0]
        if len(kids) == 0:
            return depth
        depth += 1
        frontier = kids


def _split_box(bmin: np.ndarray, bmax: np.ndarray, axis: int
               ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
    """Midpoint split with degenerate-axis skip (aabb3.hpp:43-60).

    Returns (b0_max, b1_min, mid, axis_used) or None if every axis is
    degenerate (all triangles in a point — forced leaf).
    """
    for k in range(3):
        ax = (axis + k) % 3
        if bmax[ax] - bmin[ax] > 0.0:
            mid = 0.5 * (bmin[ax] + bmax[ax])
            b0_max = bmax.copy()
            b0_max[ax] = mid
            b1_min = bmin.copy()
            b1_min[ax] = mid
            return b0_max, b1_min, mid, ax
    return None


def build_kdtree(
    tri_min: np.ndarray,     # (T, 3) per-triangle AABB mins
    tri_max: np.ndarray,     # (T, 3) per-triangle AABB maxs
    valid: Optional[np.ndarray] = None,   # (T,) bool; padding excluded
    max_depth: int = DEFAULT_MAX_DEPTH,
    max_leaf: int = DEFAULT_MAX_LEAF,
) -> KdTree:
    """Build the flattened kd-tree on the host (NumPy)."""
    tri_min = np.asarray(tri_min, np.float32)
    tri_max = np.asarray(tri_max, np.float32)
    t = len(tri_min)
    ids_all = (np.flatnonzero(np.asarray(valid)) if valid is not None
               else np.arange(t)).astype(np.int32)

    if len(ids_all):
        root_min = tri_min[ids_all].min(axis=0)
        root_max = tri_max[ids_all].max(axis=0)
    else:
        root_min = np.zeros(3, np.float32)
        root_max = np.zeros(3, np.float32)

    node_min, node_max = [], []
    child0, child1, leaf_id = [], [], []
    leaves: list = []

    def add_node(bmin, bmax):
        node_min.append(bmin)
        node_max.append(bmax)
        child0.append(-1)
        child1.append(-1)
        leaf_id.append(-1)
        return len(child0) - 1

    def rec(ids: np.ndarray, bmin: np.ndarray, bmax: np.ndarray,
            depth: int) -> int:
        me = add_node(bmin, bmax)
        split = None
        if depth < max_depth and len(ids) > max_leaf:
            split = _split_box(bmin, bmax, depth % 3)
        if split is None:
            leaf_id[me] = len(leaves)
            leaves.append(ids)
            return me
        b0_max, b1_min, mid, ax = split
        # Inclusive AABB-AABB overlap (aabb3.hpp:68-72): a triangle
        # touching the split plane goes to BOTH children (duplication,
        # kd_tree_simd.hpp:160-170).
        in0 = tri_min[ids, ax] <= mid
        in1 = tri_max[ids, ax] >= mid
        c0 = rec(ids[in0], bmin, b0_max, depth + 1)
        c1 = rec(ids[in1], b1_min, bmax, depth + 1)
        child0[me] = c0
        child1[me] = c1
        return me

    rec(ids_all, root_min, root_max, 0)

    cap = max(8, -(-max((len(l) for l in leaves), default=1) // 8) * 8)
    leaf_tris = np.full((max(1, len(leaves)), cap), -1, np.int32)
    for i, l in enumerate(leaves):
        leaf_tris[i, :len(l)] = l

    c0_arr = np.array(child0, np.int32)
    c1_arr = np.array(child1, np.int32)
    return KdTree(
        node_min=jnp.asarray(np.stack(node_min)),
        node_max=jnp.asarray(np.stack(node_max)),
        child0=jnp.asarray(c0_arr),
        child1=jnp.asarray(c1_arr),
        leaf_id=jnp.asarray(np.array(leaf_id, np.int32)),
        leaf_tris=jnp.asarray(leaf_tris),
        depth=tree_depth(c0_arr, c1_arr),
    )


def triangle_aabbs(vertices: np.ndarray, tri_vidx: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-triangle AABBs (triangle ctor, scene/primitive/triangle.hpp:26-30)."""
    v = np.asarray(vertices)
    idx = np.asarray(tri_vidx)
    corners = v[idx]              # (T, 3, 3)
    return corners.min(axis=1), corners.max(axis=1)


def build_kdtree_for_scene(scene, max_depth: int = DEFAULT_MAX_DEPTH,
                           max_leaf: int = DEFAULT_MAX_LEAF,
                           use_native: Optional[bool] = None) -> KdTree:
    """Build the kd-tree over a Scene's (host-copied) triangle soup.

    Topology is NOT differentiable: the tree is built once from the
    current vertices; inverse-rendering loops that move vertices should
    rebuild periodically (cheap, host-side) — the reference likewise
    builds once per run (src/main.cpp:41).

    use_native: force the C++ builder (native/kdtree.cpp) on/off; None
    auto-selects it when the shared library is available.
    """
    tri_min, tri_max = triangle_aabbs(np.asarray(scene.vertices),
                                      np.asarray(scene.tri_vidx))
    valid = np.asarray(scene.tri_valid)
    if use_native is None or use_native:
        from ..native import native_build_kdtree
        tree = native_build_kdtree(tri_min, tri_max, valid,
                                   max_depth, max_leaf,
                                   required=bool(use_native))
        if tree is not None:
            return tree
    return build_kdtree(tri_min, tri_max, valid, max_depth, max_leaf)
