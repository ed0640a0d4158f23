"""kd-tree accelerator: topology invariants + winner equality vs brute
force (SURVEY.md §2 #6-#7; reference accel family behind one concept,
accel/accel.hpp:8-12 — all backends must agree on every query)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from simd_raytracer import RenderConfig, parse_scene_file, render_frame
from simd_raytracer.accel.build import (build_kdtree_for_scene,
                                        triangle_aabbs)
from simd_raytracer.accel.traverse import kd_select
from simd_raytracer.models.scene import derive_geometry
from simd_raytracer.ops.intersect import mt_select


def _rand_rays(scene, n, seed=0):
    rng = np.random.default_rng(seed)
    o = np.tile(np.asarray(scene.cam_pos), (n, 1)).astype(np.float32)
    o[n // 2:] += rng.normal(scale=2.0, size=(n // 2, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_build_invariants(scenes):
    scene = parse_scene_file(str(scenes / "dragon_glass.crtscene"))
    tree = build_kdtree_for_scene(scene, use_native=False)
    child0 = np.asarray(tree.child0)
    child1 = np.asarray(tree.child1)
    leaf_id = np.asarray(tree.leaf_id)
    leaf_tris = np.asarray(tree.leaf_tris)
    node_min = np.asarray(tree.node_min)
    node_max = np.asarray(tree.node_max)

    # Inner nodes have two children and no leaf; leaves the reverse.
    inner = child0 >= 0
    assert (child1[inner] >= 0).all()
    assert (leaf_id[inner] == -1).all()
    assert (leaf_id[~inner] >= 0).all()
    # Child boxes are contained in (actually: partition) the parent box.
    for c in (child0, child1):
        sel = c[inner]
        assert (node_min[sel] >= node_min[inner] - 1e-6).all()
        assert (node_max[sel] <= node_max[inner] + 1e-6).all()
    # Every valid triangle appears in at least one leaf.
    valid_ids = np.flatnonzero(np.asarray(scene.tri_valid))
    present = np.unique(leaf_tris[leaf_tris >= 0])
    assert np.isin(valid_ids, present).all()
    # Triangles land only in leaves whose box overlaps their AABB.
    tri_min, tri_max = triangle_aabbs(np.asarray(scene.vertices),
                                      np.asarray(scene.tri_vidx))
    leaf_nodes = np.flatnonzero(~inner)
    for n in leaf_nodes[:16]:
        tris = leaf_tris[leaf_id[n]]
        tris = tris[tris >= 0]
        assert (tri_max[tris] >= node_min[n] - 1e-6).all()
        assert (tri_min[tris] <= node_max[n] + 1e-6).all()


@pytest.mark.parametrize("name", ["dragon_glass", "room"])
@pytest.mark.parametrize("cull", [True, False])
def test_kd_select_matches_brute_force(scenes, name, cull):
    scene = parse_scene_file(str(scenes / f"{name}.crtscene"))
    geom = derive_geometry(scene)
    tree = build_kdtree_for_scene(scene, use_native=False)
    o, d = _rand_rays(scene, 256)

    bi, bh = mt_select(o, d, geom.v0, geom.e1, geom.e2, 1e-6, cull,
                       geom.tri_valid)
    ki, kh = jax.jit(
        lambda o, d: kd_select(o, d, geom.v0, geom.e1, geom.e2, 1e-6, cull,
                               geom.tri_valid, tree))(o, d)
    bi, bh, ki, kh = map(np.asarray, (bi, bh, ki, kh))
    assert (bh == kh).all()
    assert (bi[bh] == ki[bh]).all()


def test_kd_select_respects_tri_mask(scenes):
    # Occlusion queries mask transmissive triangles (shade.occluded); the
    # kd backend must honor the same mask.
    scene = parse_scene_file(str(scenes / "room.crtscene"))
    geom = derive_geometry(scene)
    tree = build_kdtree_for_scene(scene, use_native=False)
    o, d = _rand_rays(scene, 128, seed=5)
    mask = np.asarray(geom.tri_valid).copy()
    mask[::3] = False
    mask = jnp.asarray(mask)

    bi, bh = mt_select(o, d, geom.v0, geom.e1, geom.e2, 1e-6, False, mask)
    ki, kh = kd_select(o, d, geom.v0, geom.e1, geom.e2, 1e-6, False, mask,
                       tree)
    assert (np.asarray(bh) == np.asarray(kh)).all()
    assert (np.asarray(bi)[np.asarray(bh)]
            == np.asarray(ki)[np.asarray(bh)]).all()


def test_kdtree_render_equals_brute_force(scenes):
    scene = parse_scene_file(str(scenes / "mixed.crtscene")).replace(
        height=18, width=24)
    cfg_b = RenderConfig(chunk_size=512, max_ray_depth=3)
    cfg_k = RenderConfig(chunk_size=512, max_ray_depth=3,
                         intersector="kdtree")
    img_b = np.asarray(render_frame(scene, cfg_b))
    img_k = np.asarray(render_frame(scene, cfg_k))   # auto-builds the tree
    assert np.array_equal(img_b, img_k)
