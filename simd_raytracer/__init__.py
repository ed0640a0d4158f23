"""simd_raytracer — a differentiable wavefront path tracer in JAX.

Implements the capabilities of the C++23 simd-raytracer reference
(kd-tree accelerated Whitted+GI rendering of .crtscene scenes) as
wavefront bounce loops, batched Moller-Trumbore (fused XLA or a Pallas
kernel on the Triton route), shard_map scaling and end-to-end
differentiability.
"""

from .config import RenderConfig, DEFAULT_CONFIG
from .models.loader import parse_scene_file, parse_scene_dict
from .models.scene import Scene, derive_geometry
from .ops.render import render_frame
from .utils.ppm import write_ppm, save_ppm, ppm_bytes
from .accel import KdTree, build_kdtree_for_scene
from .parallel.tiles import SchedulingType
from .utils.checkpoint import render_progressive

__version__ = "0.2.0"
