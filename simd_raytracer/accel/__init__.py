"""Acceleration structures (SURVEY.md §2 #5-#8).

The reference ships three accelerators behind one concept
(reference: include/raytracer/render/accel/accel.hpp:8-12): brute-force
`list_accel`, scalar `kd_tree_accel`, and the namesake SIMD packet
`kd_tree_simd_accel`.  Here the same family is:

  * brute force   -> ops.intersect.mt_select (fused XLA),
  * sweep         -> accel.sweep (Morton slices with AABBs) + the
                     ops.intersect_sweep Pallas kernel,
  * kd-tree       -> accel.build (host-side flattened builder, reference
                     topology) + accel.traverse (wavefront while_loop with
                     per-ray register stacks, leaf packets as dense blocks).
"""

from .build import KdTree, build_kdtree, build_kdtree_for_scene
from .traverse import kd_select

__all__ = ["KdTree", "build_kdtree", "build_kdtree_for_scene", "kd_select"]
