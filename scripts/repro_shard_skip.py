"""Repro/regression probe: grad of the cond-ful (bounce_skip=True) graph
under shard_map on XLA:CPU.  Exits 0 and prints OK when the skip-enabled
and cond-free sharded gradients agree; historically this segfaulted
("free(): corrupted unsorted chunks") — see sharding.py notes.

Usage: python scripts/repro_shard_skip.py [compact_factor] [shadow_compact]
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import dataclasses
import functools

import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map

from simd_raytracer import RenderConfig
from simd_raytracer.models.scenegen import load_scene
from simd_raytracer.ops.grad import pixel_loss, split_params
from simd_raytracer.parallel import sharding as sh


@functools.partial(jax.jit, static_argnames=("cfg", "mesh", "lr"))
def train_step_noforce(params, skeleton, cfg, mesh, ids, target, seeds,
                       lr=1e-2, accel=None):
    def shard_fn(params_rep, skel_rep, ids_s, tgt_s, seed_s, accel_rep):
        key = jax.random.fold_in(jax.random.PRNGKey(0), seed_s[0, 0])
        loss, grads = jax.value_and_grad(pixel_loss)(
            params_rep, skel_rep, cfg, ids_s[0], tgt_s[0], key, accel_rep)
        loss = jax.lax.pmean(loss, "data")
        grads = jax.lax.pmean(grads, "data")
        new_params = jax.tree_util.tree_map(
            lambda p, g: p - lr * g, params_rep, grads)
        return new_params, loss

    return shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P("data"), P("data"), P("data"), P()),
        out_specs=(P(), P()))(params, skeleton, ids, target, seeds, accel)


def main():
    compact = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    shadow = bool(int(sys.argv[2])) if len(sys.argv) > 2 else True
    depth = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    mode = sys.argv[4] if len(sys.argv) > 4 else "roulette"
    scene = load_scene("room", height=16, width=16)
    cfg = RenderConfig(chunk_size=64, max_ray_depth=depth,
                       bounce_mode=mode, bounce_skip=True,
                       compact_factor=compact, shadow_compact=shadow)
    mesh = sh.make_mesh(8)
    params, skeleton = split_params(scene)
    nd, n = 8, 64
    ids = jnp.arange(nd * n, dtype=jnp.int32).reshape(nd, n) % (16 * 16)
    target = jnp.zeros((nd, n, 3), jnp.float32)
    seeds = jnp.arange(nd, dtype=jnp.uint32).reshape(nd, 1).repeat(n, 1)

    new_p, loss = train_step_noforce(params, skeleton, cfg, mesh, ids,
                                     target, seeds)
    print("skip=True loss:", float(loss))
    cfg2 = dataclasses.replace(cfg, bounce_skip=False)
    new_p2, loss2 = train_step_noforce(params, skeleton, cfg2, mesh, ids,
                                       target, seeds)
    print("skip=False loss:", float(loss2))
    import jax.tree_util as jtu
    diffs = jtu.tree_map(
        lambda a, b: float(jnp.max(jnp.abs(a - b))), new_p, new_p2)
    print("max param diffs:", diffs)
    bad = max(jtu.tree_leaves(diffs) or [0.0])
    assert bad < 1e-5, f"grad mismatch {bad}"
    print("OK")


if __name__ == "__main__":
    main()
