"""Multi-chip scaling: shard_map over a device mesh.

The reference's only parallelism is a mutex-protected tile queue drained by
a jthread pool over shared memory (reference: render/render.hpp:79-105,
render/tile/queue.hpp:9-51).  The equivalent here (SURVEY.md §5):

  * the ray/tile axis is sharded over a 1-D `data` mesh axis — static even
    decomposition instead of dynamic work stealing (which is not idiomatic
    XLA; load balance comes from interleaving ray ids across shards),
  * the scene (triangle soup, material/texture tables, atlas) is
    replicated to every device's memory,
  * inverse-rendering gradients of the replicated scene parameters are
    all-reduced (pmean) across the mesh,
  * multi-host execution uses jax.distributed.initialize + the same mesh.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import RenderConfig
from ..models.scene import Scene, derive_geometry
from ..ops.grad import merge_params, pixel_loss
from ..ops.render import make_ray_chunks, render_chunk

DATA_AXIS = "data"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (DATA_AXIS,))


def init_distributed(**kwargs) -> None:
    """Multi-host rendezvous (fail-fast, like the reference's single
    process); call before make_mesh on pods.

    MUST run before anything initializes the XLA backend — including
    importing simd_raytracer modules that build module-level jnp
    constants.  On a pod: `import jax; jax.distributed.initialize(...)`
    (or this wrapper via a bare `from simd_raytracer.parallel import
    sharding` won't work — import jax only) as the very first JAX call.
    Exercised for real by tests/test_distributed.py (two OS processes).
    """
    jax.distributed.initialize(**kwargs)


def render_frame_sharded(scene: Scene, cfg: RenderConfig, mesh: Mesh,
                         key: Optional[jax.Array] = None,
                         accel=None) -> jnp.ndarray:
    """Full-frame render with the chunk axis sharded over the mesh.

    Ray-id chunks are dealt round-robin to shards (chunk c -> shard
    c % n_shards) so expensive image regions spread across chips — the
    static analog of the bucket queue's dynamic load balancing.
    """
    if key is None:
        seed = cfg.rng_seed if cfg.rng_seed is not None else 0
        key = jax.random.PRNGKey(seed)
    # Replicate the key onto THIS mesh explicitly: a caller-created key
    # committed to a single device trips an internal assertion on the
    # jit-cache fast path when the same function later runs on a larger
    # mesh (jax 0.9 sharp edge, bisected via bench.py --mesh).
    key = jax.device_put(key, NamedSharding(mesh, P()))
    h, w, spp = scene.height, scene.width, cfg.samples_per_pixel
    total = h * w * spp
    nd = mesh.devices.size

    ids = make_ray_chunks(scene, cfg)             # (C, R0)
    c, r0 = ids.shape
    # pad C to a multiple of the shard count, round-robin interleave
    c_pad = -(-c // nd) * nd
    pad_rows = np.full((c_pad - c, r0), total, np.int32)   # all-invalid ids
    ids = np.concatenate([ids, pad_rows])
    perm = np.arange(c_pad).reshape(-1, nd).T.reshape(-1)  # round robin
    ids_sharded = ids[perm].reshape(nd, c_pad // nd, r0)
    # Per-chunk seeds: fold the chunk's original index into the frame key
    # on-device (stateless counter-based RNG; utils analog of the
    # reference's thread_local LCG, utils/rand.hpp:5-19).
    seeds = np.arange(c_pad, dtype=np.uint32)[perm].reshape(nd, -1)

    # Host-side (static): where does each real ray id land in the
    # shard-ordered output?  Passing this gather map into the jit keeps
    # the un-permute + spp average on device; only the final (H, W, 3)
    # image crosses the host link.
    ids_flat = ids[perm].reshape(-1)
    pos_of_id = np.zeros(total, np.int64)
    real = ids_flat < total
    pos_of_id[ids_flat[real]] = np.flatnonzero(real)

    return _render_sharded_jit(scene, cfg, mesh, key,
                               jnp.asarray(ids_sharded),
                               jnp.asarray(seeds),
                               jnp.asarray(pos_of_id, dtype=jnp.int32),
                               accel)


@functools.partial(jax.jit, static_argnames=("cfg", "mesh"))
def _render_sharded_jit(scene: Scene, cfg: RenderConfig, mesh: Mesh,
                        key: jax.Array, ids: jnp.ndarray,
                        seeds: jnp.ndarray, pos_of_id: jnp.ndarray,
                        accel=None):
    def shard_fn(scene_rep, key_rep, ids_shard, seeds_shard, accel_rep):
        # ids_shard: (1, C/nd, R0) on this device; scene+accel replicated.
        geom = derive_geometry(scene_rep)

        def one(args):
            cid, seed = args
            return render_chunk(scene_rep, geom, cfg, cid,
                                jax.random.fold_in(key_rep, seed),
                                accel_rep)

        return jax.lax.map(one, (ids_shard[0], seeds_shard[0]))[None]

    out = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(DATA_AXIS), P(DATA_AXIS), P()),
        out_specs=P(DATA_AXIS),
        # jax.shard_map defaults check_vma=True, which rejects the
        # pallas_call out_shapes inside the sweep select (no vma field);
        # False matches the legacy experimental shard_map semantics.
        check_vma=False,
    )(scene, key, ids, seeds, accel)

    h, w, spp = scene.height, scene.width, cfg.samples_per_pixel
    flat = out.reshape(-1, 3)[pos_of_id]         # undo round-robin
    img = flat.reshape(h * w, spp, 3).sum(axis=1) / spp
    return img.reshape(h, w, 3)


@functools.partial(jax.jit, static_argnames=("cfg", "mesh", "lr"))
def train_step_sharded(params, skeleton: Scene, cfg: RenderConfig,
                       mesh: Mesh, ids, target, seeds, lr: float = 1e-2,
                       accel=None):
    """One data-parallel inverse-rendering SGD step.

    ids (nd, N) ray ids and target (nd, N, 3) colors are sharded over the
    data axis; params/skeleton replicated; per-shard gradients are averaged
    across the mesh before the update — the standard DP recipe applied with rays
    as the batch dimension (SURVEY.md §2 parallelism note).
    """

    # XLA:CPU heap-corrupts when differentiating the per-bounce lax.cond
    # skips inside shard_map (reproducer: scripts/repro_shard_skip.py —
    # depth>=1 crashes, depth=0 is clean, minimal cond probes all pass,
    # so it is an XLA:CPU conditional-codegen bug our graph tickles, not
    # a formulation choice; values are identical either way).  Only the
    # CPU backend runs the cond-free graph; GPU meshes keep the real
    # skip-enabled graph (checked against one card by
    # `chip_smoke.py --four-gpus`).  tests/test_shard_skip_regression.py
    # turns strict-xfail the day an XLA upgrade fixes it.
    if any(d.platform == "cpu" for d in mesh.devices.flat):
        import dataclasses
        cfg = dataclasses.replace(cfg, bounce_skip=False)

    def shard_fn(params_rep, skel_rep, ids_s, tgt_s, seed_s, accel_rep):
        key = jax.random.PRNGKey(0)
        key = jax.random.fold_in(key, seed_s[0, 0])
        loss, grads = jax.value_and_grad(pixel_loss)(
            params_rep, skel_rep, cfg, ids_s[0], tgt_s[0], key, accel_rep)
        loss = jax.lax.pmean(loss, DATA_AXIS)
        grads = jax.lax.pmean(grads, DATA_AXIS)
        new_params = jax.tree_util.tree_map(
            lambda p, g: p - lr * g, params_rep, grads)
        return new_params, loss

    return shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P()),
        out_specs=(P(), P()),
        check_vma=False,   # see render_frame_sharded
    )(params, skeleton, ids, target, seeds, accel)
