"""Sweep acceleration data: the triangle soup cut into tight slices.

Triangles are sorted along a Morton curve of their centroids and cut into
disjoint slices of `slice_size` consecutive triangles, each with a tight
AABB — the scaled-up sibling of the reference's width-W triangle_packet
(kd_tree_simd.hpp:16-24).  The sweep kernel (ops/intersect_sweep.py)
culls (ray tile, slice) pairs by those boxes and tests the rest as dense
packets: block sparsity instead of pointer chasing.  A disjoint partition
never tests more lanes than brute force (no kd-split duplication,
kd_tree_simd.hpp:160-170), so culling is pure profit.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..utils.pytree import pytree_dataclass, static_field
from .build import triangle_aabbs

# Kernel shape, chosen on an H100 (PERF.md): triangles per slice (a power
# of two: it is the kernel's lane width), rays per program, warps.
SLICE = 32
R_TILE = 32
NUM_WARPS = 4


@pytree_dataclass
class SweepData:
    """S slices of `width` triangles each (static shapes per scene)."""

    tri_soa: jnp.ndarray   # (9, S*width) f32 rows v0xyz e1xyz e2xyz
    aabb: jnp.ndarray      # (S, 8) f32: min xyz, max xyz, 2 pad
    tri_ids: jnp.ndarray   # (S, width) i32 global triangle ids, -1 pad
    r_tile: int = static_field(default=R_TILE)
    num_warps: int = static_field(default=NUM_WARPS)
    # Run the kernel in the Pallas interpreter (CPU tests only).
    interpret: bool = static_field(default=False)

    @property
    def num_slices(self) -> int:
        return int(self.tri_ids.shape[0])


def _morton_order(tri_min: np.ndarray, tri_max: np.ndarray,
                  ids: np.ndarray) -> np.ndarray:
    """Sort triangle ids along a 30-bit Morton curve of their centroids,
    so nearby triangles land in the same slice."""
    if len(ids) == 0:
        return ids
    c = 0.5 * (tri_min[ids] + tri_max[ids])
    lo = c.min(axis=0)
    span = np.maximum(c.max(axis=0) - lo, 1e-30)
    q = np.minimum((1023.0 * (c - lo) / span), 1023.0).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))
    return ids[np.argsort(code, kind="stable")]


def build_sweep_for_scene(scene, slice_size: int = SLICE,
                          r_tile: int = R_TILE, num_warps: int = NUM_WARPS,
                          interpret: bool = False) -> SweepData:
    """Pack the scene's valid triangles into ceil(T / slice_size) slices."""
    if slice_size & (slice_size - 1) or r_tile & (r_tile - 1):
        raise ValueError("slice_size and r_tile must be powers of two")
    vertices = np.asarray(scene.vertices)
    tri_vidx = np.asarray(scene.tri_vidx)
    tri_min, tri_max = triangle_aabbs(vertices, tri_vidx)
    order = _morton_order(tri_min, tri_max, np.flatnonzero(
        np.asarray(scene.tri_valid)).astype(np.int32))
    s_count = max(1, -(-len(order) // slice_size))

    tri_ids = np.full(s_count * slice_size, -1, np.int32)
    tri_ids[:len(order)] = order
    tri_ids = tri_ids.reshape(s_count, slice_size)
    corners = vertices[tri_vidx[np.maximum(tri_ids, 0)]]  # (S, W, 3, 3)
    v0 = corners[..., 0, :]
    soa = np.concatenate([v0, corners[..., 1, :] - v0,
                          corners[..., 2, :] - v0], axis=-1)   # (S, W, 9)
    soa[tri_ids < 0] = 0.0
    tri_soa = soa.reshape(-1, 9).T.astype(np.float32)

    # An empty slice gets an inverted box (min = +inf > max = -inf), which
    # _tile_reach culls by its explicit box-validity check.
    pad = (tri_ids < 0)[..., None]
    aabb = np.zeros((s_count, 8), np.float32)
    aabb[:, 0:3] = np.where(pad, np.inf, tri_min[tri_ids]).min(axis=1)
    aabb[:, 3:6] = np.where(pad, -np.inf, tri_max[tri_ids]).max(axis=1)

    return SweepData(tri_soa=jnp.asarray(tri_soa), aabb=jnp.asarray(aabb),
                     tri_ids=jnp.asarray(tri_ids), r_tile=r_tile,
                     num_warps=num_warps, interpret=interpret)
