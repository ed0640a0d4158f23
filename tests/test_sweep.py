"""Sweep intersector (accel/sweep.py + ops/intersect_sweep.py) vs brute
force — winners must be identical (shared accelerator contract,
reference accel/accel.hpp:8-12).  The kernel runs in the Pallas
interpreter here; the `gpu` test compiles it for the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from simd_raytracer import RenderConfig, parse_scene_file, render_frame
from simd_raytracer.accel.sweep import build_sweep_for_scene
from simd_raytracer.models.scene import build_scene, derive_geometry
from simd_raytracer.ops.intersect import mt_refine, mt_select
from simd_raytracer.ops.intersect_sweep import (_tile_reach, _tile_schedule,
                                                make_sweep_select)


def _rand_rays(scene, n, seed=0):
    rng = np.random.default_rng(seed)
    o = np.tile(np.asarray(scene.cam_pos), (n, 1)).astype(np.float32)
    o[n // 2:] += rng.normal(scale=2.0, size=(n - n // 2, 3)).astype(
        np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _interp(scene, **kw):
    return build_sweep_for_scene(scene, interpret=True, **kw)


def _assert_same_winners(sel, geom, o, d, cull, **kw):
    bi, bh = mt_select(o, d, geom.v0, geom.e1, geom.e2, 1e-6, cull,
                       geom.tri_valid, **kw)
    si, sh = sel(o, d, geom.v0, geom.e1, geom.e2, 1e-6, cull,
                 geom.tri_valid, **kw)
    bh, sh = np.asarray(bh), np.asarray(sh)
    assert (bh == sh).all()
    assert (np.asarray(bi)[bh] == np.asarray(si)[bh]).all()
    return bh


@pytest.fixture(scope="module")
def dragon(scenes):
    scene = parse_scene_file(str(scenes / "dragon_glass.crtscene"))
    return scene, derive_geometry(scene)


def test_slices_cover_all_triangles(dragon):
    scene, _ = dragon
    sweep = build_sweep_for_scene(scene)
    ids = np.asarray(sweep.tri_ids)
    present = np.unique(ids[ids >= 0])
    valid = np.flatnonzero(np.asarray(scene.tri_valid))
    assert np.array_equal(present, valid)        # disjoint and complete
    assert (ids >= 0).sum() == len(valid)
    assert sweep.tri_soa.shape == (9, ids.size)
    # slice AABBs contain their member triangles
    from simd_raytracer.accel.build import triangle_aabbs
    tri_min, tri_max = triangle_aabbs(np.asarray(scene.vertices),
                                      np.asarray(scene.tri_vidx))
    aabb = np.asarray(sweep.aabb)
    for s in range(sweep.num_slices):
        tris = ids[s][ids[s] >= 0]
        assert (tri_min[tris] >= aabb[s, 0:3] - 1e-6).all()
        assert (tri_max[tris] <= aabb[s, 3:6] + 1e-6).all()
    # packed SoA rows are v0, e1, e2 of the member triangles
    soa = np.asarray(sweep.tri_soa).T.reshape(ids.shape + (9,))
    corners = np.asarray(scene.vertices)[np.asarray(scene.tri_vidx)]
    t = ids[0, 0]
    np.testing.assert_array_equal(soa[0, 0, :3], corners[t, 0])
    np.testing.assert_array_equal(soa[0, 0, 3:6], corners[t, 1] - corners[t, 0])


def test_build_rejects_non_power_of_two(dragon):
    with pytest.raises(ValueError):
        build_sweep_for_scene(dragon[0], slice_size=48)
    with pytest.raises(ValueError):
        build_sweep_for_scene(dragon[0], r_tile=100)


@pytest.mark.parametrize("cull", [True, False])
def test_sweep_select_matches_brute_force(dragon, cull):
    scene, geom = dragon
    o, d = _rand_rays(scene, 512)
    hit = _assert_same_winners(make_sweep_select(_interp(scene)), geom,
                               o, d, cull)
    assert 0 < hit.sum() < len(hit)


@pytest.mark.parametrize("r_tile,slice_size", [(16, 32), (128, 16),
                                               (32, 128)])
def test_kernel_shapes_agree(dragon, r_tile, slice_size):
    scene, geom = dragon
    o, d = _rand_rays(scene, 200, seed=4)
    sel = make_sweep_select(_interp(scene, r_tile=r_tile,
                                    slice_size=slice_size))
    _assert_same_winners(sel, geom, o, d, False)


def test_sweep_tmax_window_and_any_hit(dragon):
    """t_max drops hits beyond the window; any_hit matches the occlusion
    predicate (exists accepted hit with t <= t_max)."""
    scene, geom = dragon
    sel = make_sweep_select(_interp(scene))
    n = 512
    o, d = _rand_rays(scene, n, seed=3)
    bi, bh = mt_select(o, d, geom.v0, geom.e1, geom.e2, 1e-6, False,
                       geom.tri_valid)
    bt, _, _ = mt_refine(o, d, geom.v0[bi], geom.e1[bi], geom.e2[bi])
    bt = np.where(np.asarray(bh), np.asarray(bt), np.inf)

    # window below every hit -> no hits; window above -> same winners
    _, sh_lo = sel(o, d, geom.v0, geom.e1, geom.e2, 1e-6, False,
                   geom.tri_valid, t_max=jnp.full(n, 1e-3))
    assert not np.asarray(sh_lo).any()
    _assert_same_winners(sel, geom, o, d, False, t_max=jnp.full(n, 1e9))

    # a mid window keeps exactly the hits strictly inside it (rays whose
    # winner t sits AT the window edge are ulp-order dependent — skip)
    tm_val = float(np.median(bt[np.isfinite(bt)]))
    tmax = jnp.full(n, tm_val)
    _, sh_mid = sel(o, d, geom.v0, geom.e1, geom.e2, 1e-6, False,
                    geom.tri_valid, t_max=tmax)
    off_edge = np.abs(bt - tm_val) > 1e-5 * tm_val
    assert (np.asarray(sh_mid) == (bt < tm_val))[off_edge].all()

    # any_hit returns the same predicate for every window
    for tm in (jnp.full(n, 1e-3), tmax, jnp.full(n, 1e9)):
        _, sh_c = sel(o, d, geom.v0, geom.e1, geom.e2, 1e-6, False,
                      geom.tri_valid, t_max=tm)
        _, sh_a = sel(o, d, geom.v0, geom.e1, geom.e2, 1e-6, False,
                      geom.tri_valid, t_max=tm, any_hit=True)
        assert (np.asarray(sh_a) == np.asarray(sh_c)).all()


@pytest.mark.parametrize("n_tri,n_ray", [(5, 1), (70, 63), (130, 65)])
def test_ragged_counts_and_ties(n_tri, n_ray):
    """Triangle counts that leave a partial last slice, ray counts that
    leave a partial last tile, and exact duplicates (ties resolve to the
    lowest id)."""
    rng = np.random.default_rng(n_tri)
    base = rng.uniform(-2.0, 2.0, (n_tri, 3, 3)).astype(np.float32)
    base[:, :, 2] -= 5.0
    base[1::3] = base[0::3][:len(base[1::3])]        # duplicated triangles
    scene = build_scene(
        mesh_vertices=[base.reshape(-1, 3)],
        mesh_tri_vidx=[np.arange(3 * n_tri).reshape(-1, 3)],
        mesh_uvs=[None], mesh_material=[0],
        materials=[{"tag": 0, "albedo": (1, 1, 1)}], textures=[],
        lights=[], cam_pos=(0, 0, 0), cam_mat=np.eye(3),
        background=(0, 0, 0), height=1, width=1, bucket_size=1)
    geom = derive_geometry(scene)
    o = jnp.asarray(rng.normal(scale=0.5, size=(n_ray, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(n_ray, 3)) * [0.3, 0.3, 0.0]
                    + [0, 0, -1], jnp.float32)
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    sel = make_sweep_select(_interp(scene, slice_size=32, r_tile=16))
    for cull in (True, False):
        _assert_same_winners(sel, geom, o, d, cull)


def test_tile_schedule_front_to_back():
    rng = np.random.default_rng(1)
    reach = jnp.asarray(rng.random((6, 9)) < 0.5)
    t_near = jnp.asarray(rng.uniform(0, 10, (6, 9)), jnp.float32)
    order, tnear = _tile_schedule(reach, t_near)
    order, tnear = np.asarray(order), np.asarray(tnear)
    r, tn = np.asarray(reach), np.asarray(t_near)
    for p in range(6):
        assert sorted(order[p]) == list(range(9))        # a permutation
        k = r[p].sum()
        assert r[p][order[p][:k]].all()                  # reachable first
        assert np.isinf(tnear[p][k:]).all()              # inf sentinel
        assert (np.diff(tnear[p][:k]) >= 0).all()        # ascending
        np.testing.assert_array_equal(tnear[p][:k], tn[p][order[p][:k]])


def test_tile_reach_is_conservative(dragon):
    """Every slice holding a ray's brute-force winner is reachable from
    that ray's tile, with an entry bound no larger than the hit."""
    scene, geom = dragon
    sweep = build_sweep_for_scene(scene, r_tile=32)
    # 8 coherent tiles: 32 camera rays in a narrow cone each
    rng = np.random.default_rng(9)
    base = rng.normal(size=(8, 1, 3)) * [0.6, 0.4, 0.0] + [0, -0.3, -1.0]
    d = (base + rng.normal(scale=0.02, size=(8, 32, 3))).reshape(-1, 3)
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
    o = jnp.broadcast_to(scene.cam_pos, d.shape)
    bi, bh = mt_select(o, d, geom.v0, geom.e1, geom.e2, 1e-6, False,
                       geom.tri_valid)
    bt, _, _ = mt_refine(o, d, geom.v0[bi], geom.e1[bi], geom.e2[bi])
    reach, t_near = _tile_reach(o, d, jnp.full(256, 3.4e38), sweep.aabb, 32)
    reach, t_near = np.asarray(reach), np.asarray(t_near)
    slice_of = {int(t): s for s, row in enumerate(np.asarray(sweep.tri_ids))
                for t in row if t >= 0}
    assert not reach.all()                                # it does cull
    for i in np.flatnonzero(np.asarray(bh)):
        s = slice_of[int(bi[i])]
        assert reach[i // 32, s]
        assert t_near[i // 32, s] <= float(bt[i]) * (1 + 1e-5)


def test_sweep_render_equals_brute_force(scenes):
    scene = parse_scene_file(str(scenes / "room.crtscene")).replace(
        height=18, width=24)
    a = np.asarray(render_frame(
        scene, RenderConfig(chunk_size=512, max_ray_depth=3)))
    b = np.asarray(render_frame(
        scene, RenderConfig(chunk_size=512, max_ray_depth=3,
                            intersector="sweep", ray_order="linear"),
        accel=_interp(scene)))
    assert np.array_equal(a, b)


def test_sweep_gradient_matches_jnp(scenes):
    """Select is stop-gradiented, so gradients flow only through refine
    and shading: the sweep backend must give the jnp gradients."""
    from simd_raytracer.ops.grad import loss_and_grad, split_params
    scene = parse_scene_file(str(scenes / "mixed.crtscene")).replace(
        height=8, width=12)
    params, skeleton = split_params(scene)
    ids = jnp.arange(96, dtype=jnp.int32)
    target = jnp.zeros((96, 3))
    key = jax.random.PRNGKey(0)
    cfg = RenderConfig(chunk_size=96, max_ray_depth=2)
    l0, g0 = loss_and_grad(params, skeleton, cfg, ids, target, key)
    l1, g1 = loss_and_grad(params, skeleton,
                           RenderConfig(chunk_size=96, max_ray_depth=2,
                                        intersector="sweep"),
                           ids, target, key, _interp(scene))
    assert float(l0) == float(l1)
    for k in ("vertices", "mat_albedo", "light_intensity"):
        assert np.abs(np.asarray(g0[k])).max() > 0, k
        np.testing.assert_array_equal(np.asarray(g1[k]), np.asarray(g0[k]))


@pytest.mark.gpu
def test_compiled_kernel_matches_brute_force(gpu, dragon):
    """The Triton-compiled kernel (no interpreter) on the card."""
    scene, geom = dragon
    o, d = _rand_rays(scene, 4096, seed=5)
    sel = make_sweep_select(build_sweep_for_scene(scene))
    for cull in (True, False):
        _assert_same_winners(sel, geom, o, d, cull)
