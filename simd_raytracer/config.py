"""Render configuration.

Counterpart of the reference's compile-time constants
(reference: include/raytracer/config.hpp:6-17).  In the reference every knob
is a `constexpr` baked into the binary; here they are fields of a frozen
dataclass whose values become jit-constants when the render function is
traced, which gives the same "free" constant folding without recompiling the
world by hand.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


INTERSECTORS = ("jnp", "kdtree", "sweep")
# What the CLI, bench.py and chip_smoke.py render with: the fastest
# backend end to end on an H100 (PERF.md).  RenderConfig's own default
# stays `jnp`, the reference formulation, which needs no accel.
DEFAULT_INTERSECTOR = "sweep"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters (all become XLA compile-time constants).

    Defaults mirror reference config.hpp:6-17 exactly.
    """

    fov_degrees: float = 90.0
    epsilon: float = 1e-6
    shadow_bias: float = 1e-4
    reflection_bias: float = 1e-4
    refraction_bias: float = 1e-4

    samples_per_pixel: int = 1
    max_ray_depth: int = 5
    diffuse_reflection_ray_count: int = 0

    # Fixed seed 42 matches reference config.hpp:17; None -> draw from OS.
    rng_seed: Optional[int] = 42

    # --- execution knobs (no reference counterpart) ---
    # Primary rays are processed in chunks of this many (pixel, sample)
    # pairs; the moral equivalent of the reference's bucket scheduler
    # (reference: render/tile/bucket.hpp) restructured for static XLA shapes.
    chunk_size: int = 16384
    # Shadow-ray semantics: "fast" resolves occlusion with a single
    # intersect that ignores transmissive triangles; "march" replicates the
    # reference's iterative re-origined marching (render/render.hpp:110-131)
    # up to `max_shadow_march` hops.
    occlusion_mode: str = "fast"
    max_shadow_march: int = 8
    # Intersection backend: "jnp" (fused XLA brute force, the reference
    # formulation), "kdtree" (flattened-tree wavefront traversal, the
    # parity path), or "sweep" (Pallas/Triton kernel over AABB-culled
    # Morton slices, ops/intersect_sweep.py).
    intersector: str = "jnp"
    # Bounce-tree handling.  "split" evaluates the reference's full
    # deterministic recursion tree (refractive spawns reflection AND
    # refraction, render.hpp:278-301; diffuse spawns every GI ray), so the
    # wavefront widens by child_slots each bounce.  "roulette" keeps the
    # wavefront FLAT: each ray continues along at most one stochastically
    # chosen child (Fresnel-weighted for refractive, uniform over GI
    # rays), with weights scaled so the estimator is unbiased — same mean
    # image, more variance on refractive/GI paths, ~child_slots^depth less
    # compute (SURVEY.md §7 hard part (c)).
    bounce_mode: str = "split"
    # Wavefront compaction (roulette only): when the live-ray count of a
    # bounce fits in chunk/compact_factor slots, the bounce runs at that
    # reduced width (exact — dead rays neither shade nor spawn).  1
    # disables.  Costs one extra compiled branch per bounce.
    compact_factor: int = 4
    # Shadow-query compaction: gather the live diffuse/texture hits
    # before the per-light occlusion sweep (tiered widths n/8, n/2).
    # False falls back to one full-width query gated by a single
    # any-lit cond.  Rendered values identical either way.
    shadow_compact: bool = True
    # Ray-id traversal order within a frame: "linear" walks pixels
    # row-major; "tiled" walks 32x32 pixel blocks so each Pallas ray
    # tile covers a compact screen region (tight origin/direction
    # interval boxes -> the sweep kernel's tile-level culling actually
    # fires); "auto" picks tiled for the sweep intersector and linear
    # otherwise.  The estimator is unchanged, but ALL per-chunk-slot
    # randomness is reassigned by the order (spp jitter, GI directions,
    # roulette coins — even at spp=1 when GI/roulette is on): same
    # distribution, different sample values, so order-sensitive golden
    # images must pin ray_order explicitly.
    ray_order: str = "auto"
    # Per-bounce lax.cond skips (dead-wavefront early exit, unlit-ray
    # occlusion skip, compaction dispatch).  Identical rendered values
    # either way — False trades the sparse-bounce savings for a
    # cond-free graph.  XLA:CPU corrupts memory differentiating these
    # conds inside shard_map (latent heap corruption, bisected), so the
    # sharded train step forces False on CPU meshes.
    bounce_skip: bool = True

    def __post_init__(self):
        if self.occlusion_mode not in ("fast", "march"):
            raise ValueError(f"bad occlusion_mode {self.occlusion_mode!r}")
        if self.intersector not in INTERSECTORS:
            raise ValueError(f"bad intersector {self.intersector!r}")
        if self.bounce_mode not in ("split", "roulette"):
            raise ValueError(f"bad bounce_mode {self.bounce_mode!r}")
        if self.ray_order not in ("auto", "linear", "tiled"):
            raise ValueError(f"bad ray_order {self.ray_order!r}")

    @property
    def child_slots(self) -> int:
        """Secondary-ray slots a single ray keeps after one bounce.

        split: refractive spawns 2 (reflection + refraction,
        render.hpp:278-301); diffuse spawns `diffuse_reflection_ray_count`
        GI rays (render.hpp:151-182).  The same ray has one material, so
        the slot count is the max of the two.  roulette: always 1.
        """
        if self.bounce_mode == "roulette":
            return 1
        return max(2, self.diffuse_reflection_ray_count)


DEFAULT_CONFIG = RenderConfig()
