"""Scene model: SoA JAX pytrees.

The reference stores the scene as nested AoS C++ objects
(reference: include/raytracer/scene/scene.hpp:14-22 — settings, camera,
lights, texture map, material variants, meshes of triangles).  Batched
device code wants flat structure-of-arrays: every mesh's triangles are flattened into one
global triangle soup, the five-way `std::variant` material dispatch
(scene/material/material.hpp:11-12) becomes an integer tag plus dense
parameter table, and the four texture variants (scene/texture/texture.hpp:10)
become a tag table plus one flat texel atlas.

Differentiability: the pytree leaves `vertices`, `uv`, `mat_albedo`,
`mat_ior`, `light_*`, `tex_*`, `background` are the differentiable scene
parameters.  Derived quantities (edge vectors, face normals, area-weighted
vertex normals — reference scene/object/mesh.hpp:23-44) are recomputed
inside the traced render function by `derive_geometry`, so gradients flow
back to raw vertices.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from ..utils.pytree import pytree_dataclass, static_field

# Material tags (order matches the reference variant declaration order,
# scene/material/material.hpp:11-12, purely for familiarity).
MAT_DIFFUSE = 0
MAT_REFLECTIVE = 1
MAT_REFRACTIVE = 2
MAT_CONSTANT = 3
MAT_TEXTURE = 4

# Texture tags (order matches scene/texture/texture.hpp:10-11).
TEX_ALBEDO = 0
TEX_EDGES = 1
TEX_CHECKER = 2
TEX_BITMAP = 3

TRI_PAD = 128  # triangle count padded to a multiple of this


@pytree_dataclass
class Scene:
    """Flattened scene as one pytree of device arrays.

    Shapes: V vertices, T triangles (padded to TRI_PAD), M materials,
    L lights (>=1, zero-intensity padded), X textures (>=1), P atlas texels.
    """

    # Geometry (differentiable root: vertices).
    vertices: jnp.ndarray      # (V, 3) f32
    tri_vidx: jnp.ndarray      # (T, 3) i32 indices into `vertices`
    uv: jnp.ndarray            # (T, 3, 2) f32 per-corner UVs
    tri_mat: jnp.ndarray       # (T,) i32 material index
    tri_mesh: jnp.ndarray      # (T,) i32 owning mesh index
    tri_valid: jnp.ndarray     # (T,) bool — False on padding

    # Materials table.
    mat_tag: jnp.ndarray       # (M,) i32
    mat_albedo: jnp.ndarray    # (M, 3) f32
    mat_ior: jnp.ndarray       # (M,) f32
    mat_smooth: jnp.ndarray    # (M,) bool
    mat_tex: jnp.ndarray       # (M,) i32 texture index (or 0 if none)

    # Textures table.
    tex_tag: jnp.ndarray       # (X,) i32
    tex_color_a: jnp.ndarray   # (X, 3) f32  albedo / edge_color / color_A
    tex_color_b: jnp.ndarray   # (X, 3) f32  inner_color / color_B
    tex_param: jnp.ndarray     # (X,) f32    edge_width / square_size
    tex_offset: jnp.ndarray    # (X,) i32    start texel in atlas
    tex_width: jnp.ndarray     # (X,) i32
    tex_height: jnp.ndarray    # (X,) i32
    atlas: jnp.ndarray         # (P, 3) f32 flat bitmap texels, row-major

    # Lights.
    light_pos: jnp.ndarray     # (L, 3) f32
    light_intensity: jnp.ndarray  # (L,) f32

    # Camera + background.
    cam_pos: jnp.ndarray       # (3,) f32
    cam_mat: jnp.ndarray       # (3, 3) f32 row-major orientation matrix
    background: jnp.ndarray    # (3,) f32

    # Static metadata (not traced).
    height: int = static_field()
    width: int = static_field()
    bucket_size: int = static_field()
    num_meshes: int = static_field()

    @property
    def num_triangles(self) -> int:
        return int(self.tri_vidx.shape[0])


@pytree_dataclass
class Geometry:
    """Per-triangle derived arrays consumed by intersection/shading.

    Mirrors what the reference precomputes at triangle/mesh construction
    (scene/primitive/triangle.hpp:20-30 e1/e2/normal;
    scene/object/mesh.hpp:26-43 vertex normals) but recomputed in-trace so
    it stays differentiable w.r.t. Scene.vertices.
    """

    v0: jnp.ndarray           # (T, 3)
    e1: jnp.ndarray           # (T, 3)
    e2: jnp.ndarray           # (T, 3)
    face_n: jnp.ndarray       # (T, 3) normalized geometric normal
    vn: jnp.ndarray           # (T, 3, 3) per-corner smooth vertex normals
    uv: jnp.ndarray           # (T, 3, 2)
    tri_mat: jnp.ndarray      # (T,) i32
    tri_mesh: jnp.ndarray     # (T,) i32
    tri_valid: jnp.ndarray    # (T,) bool
    tri_transmissive: jnp.ndarray  # (T,) bool — material is refractive


def _safe_normalize(v: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    # Clamp BEFORE the sqrt: jnp.linalg.norm's sqrt(0) has an inf/NaN
    # gradient that survives multiplication by a zero cotangent (the
    # padding triangles have zero cross products), so grad-of-render would
    # be NaN.  rsqrt(max(sumsq, tiny)) has gradient 0 at the clamp.
    sq = jnp.sum(v * v, axis=axis, keepdims=True)
    return v * jax.lax.rsqrt(jnp.maximum(sq, 1e-18))


def derive_geometry(scene: Scene) -> Geometry:
    """Compute e1/e2/face normals/vertex normals from raw vertices.

    Vertex normals are the normalized sum of adjacent (unit) face normals,
    exactly the reference's scheme (scene/object/mesh.hpp:33-43).  Padding
    triangles have all three corners at vertex 0 of their slot; their face
    normal is the zero vector and they are excluded via `tri_valid` anyway.
    """
    v = scene.vertices
    idx = scene.tri_vidx
    p0 = v[idx[:, 0]]
    p1 = v[idx[:, 1]]
    p2 = v[idx[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p0
    n_raw = jnp.cross(e1, e2)
    face_n = _safe_normalize(n_raw)

    # Scatter-add face normals to vertices, then normalize (mesh.hpp:37-43).
    valid3 = scene.tri_valid[:, None].astype(face_n.dtype)
    vn_accum = jnp.zeros_like(v)
    for corner in range(3):
        vn_accum = vn_accum.at[idx[:, corner]].add(face_n * valid3)
    vertex_n = _safe_normalize(vn_accum)
    vn = vertex_n[idx]  # (T, 3, 3)

    tri_transmissive = scene.mat_tag[scene.tri_mat] == MAT_REFRACTIVE

    return Geometry(
        v0=p0, e1=e1, e2=e2, face_n=face_n, vn=vn,
        uv=scene.uv, tri_mat=scene.tri_mat, tri_mesh=scene.tri_mesh,
        tri_valid=scene.tri_valid,
        tri_transmissive=tri_transmissive,
    )


def build_scene(
    *,
    mesh_vertices: list,      # list of (Vi, 3) f32 arrays
    mesh_tri_vidx: list,      # list of (Ti, 3) int arrays (mesh-local)
    mesh_uvs: list,           # list of (Vi, 2) f32 arrays or None
    mesh_material: list,      # list of int material indices
    materials: list,          # list of dicts (tag/albedo/ior/smooth/tex)
    textures: list,           # list of dicts (tag/color_a/color_b/param/bitmap)
    lights: list,             # list of (pos(3,), intensity)
    cam_pos, cam_mat, background,
    height: int, width: int, bucket_size: int,
) -> Scene:
    """Assemble the flat SoA Scene from per-mesh host data (NumPy)."""
    all_v, all_idx, all_uv, all_mat, all_mesh = [], [], [], [], []
    voffset = 0
    for mi, (verts, tidx) in enumerate(zip(mesh_vertices, mesh_tri_vidx)):
        verts = np.asarray(verts, np.float32).reshape(-1, 3)
        tidx = np.asarray(tidx, np.int64).reshape(-1, 3)
        all_v.append(verts)
        all_idx.append(tidx + voffset)
        uvs = mesh_uvs[mi]
        if uvs is not None and len(uvs):
            uvs = np.asarray(uvs, np.float32).reshape(-1, 2)
            all_uv.append(uvs[tidx])           # (Ti, 3, 2)
        else:
            all_uv.append(np.zeros((len(tidx), 3, 2), np.float32))
        all_mat.append(np.full(len(tidx), mesh_material[mi], np.int32))
        all_mesh.append(np.full(len(tidx), mi, np.int32))
        voffset += len(verts)

    vertices = np.concatenate(all_v) if all_v else np.zeros((1, 3), np.float32)
    tri_vidx = (np.concatenate(all_idx) if all_idx
                else np.zeros((0, 3), np.int64)).astype(np.int32)
    uv = np.concatenate(all_uv) if all_uv else np.zeros((0, 3, 2), np.float32)
    tri_mat = np.concatenate(all_mat) if all_mat else np.zeros(0, np.int32)
    tri_mesh = np.concatenate(all_mesh) if all_mesh else np.zeros(0, np.int32)

    t = len(tri_vidx)
    t_pad = max(TRI_PAD, ((t + TRI_PAD - 1) // TRI_PAD) * TRI_PAD)
    pad = t_pad - t
    tri_valid = np.concatenate([np.ones(t, bool), np.zeros(pad, bool)])
    # Padding triangles are degenerate (all corners = vertex 0): their
    # Moller-Trumbore determinant is 0, so the epsilon test rejects them
    # (matching how det<=eps rejects in triangle.hpp:36-44).
    tri_vidx = np.concatenate([tri_vidx, np.zeros((pad, 3), np.int32)])
    uv = np.concatenate([uv, np.zeros((pad, 3, 2), np.float32)])
    tri_mat = np.concatenate([tri_mat, np.zeros(pad, np.int32)])
    tri_mesh = np.concatenate([tri_mesh, np.zeros(pad, np.int32)])

    m = max(1, len(materials))
    mat_tag = np.zeros(m, np.int32)
    mat_albedo = np.zeros((m, 3), np.float32)
    mat_ior = np.ones(m, np.float32)
    mat_smooth = np.zeros(m, bool)
    mat_tex = np.zeros(m, np.int32)
    for i, md in enumerate(materials):
        mat_tag[i] = md["tag"]
        mat_albedo[i] = md.get("albedo", (0, 0, 0))
        mat_ior[i] = md.get("ior", 1.0)
        mat_smooth[i] = md.get("smooth", False)
        mat_tex[i] = md.get("tex", 0)

    x = max(1, len(textures))
    tex_tag = np.zeros(x, np.int32)
    tex_color_a = np.zeros((x, 3), np.float32)
    tex_color_b = np.zeros((x, 3), np.float32)
    tex_param = np.ones(x, np.float32)
    tex_offset = np.zeros(x, np.int32)
    tex_width = np.ones(x, np.int32)
    tex_height = np.ones(x, np.int32)
    atlas_parts = []
    texel_count = 0
    for i, td in enumerate(textures):
        tex_tag[i] = td["tag"]
        tex_color_a[i] = td.get("color_a", (0, 0, 0))
        tex_color_b[i] = td.get("color_b", (0, 0, 0))
        tex_param[i] = td.get("param", 1.0)
        bmp = td.get("bitmap")
        if bmp is not None:
            bmp = np.asarray(bmp, np.float32)   # (Hb, Wb, 3) in [0,1]
            hb, wb = bmp.shape[:2]
            tex_offset[i] = texel_count
            tex_width[i] = wb
            tex_height[i] = hb
            atlas_parts.append(bmp.reshape(-1, 3))
            texel_count += hb * wb
    atlas = (np.concatenate(atlas_parts) if atlas_parts
             else np.zeros((1, 3), np.float32))

    nl = max(1, len(lights))
    light_pos = np.zeros((nl, 3), np.float32)
    light_intensity = np.zeros(nl, np.float32)
    # Zero-intensity padded light sits off-origin so its direction norm > 0.
    light_pos[:, 1] = 1.0
    for i, (pos, inten) in enumerate(lights):
        light_pos[i] = pos
        light_intensity[i] = inten

    jn = jnp.asarray
    return Scene(
        vertices=jn(vertices), tri_vidx=jn(tri_vidx), uv=jn(uv),
        tri_mat=jn(tri_mat), tri_mesh=jn(tri_mesh), tri_valid=jn(tri_valid),
        mat_tag=jn(mat_tag), mat_albedo=jn(mat_albedo), mat_ior=jn(mat_ior),
        mat_smooth=jn(mat_smooth), mat_tex=jn(mat_tex),
        tex_tag=jn(tex_tag), tex_color_a=jn(tex_color_a),
        tex_color_b=jn(tex_color_b), tex_param=jn(tex_param),
        tex_offset=jn(tex_offset), tex_width=jn(tex_width),
        tex_height=jn(tex_height), atlas=jn(atlas),
        light_pos=jn(light_pos), light_intensity=jn(light_intensity),
        cam_pos=jn(np.asarray(cam_pos, np.float32)),
        cam_mat=jn(np.asarray(cam_mat, np.float32).reshape(3, 3)),
        background=jn(np.asarray(background, np.float32)),
        height=int(height), width=int(width), bucket_size=int(bucket_size),
        num_meshes=len(mesh_vertices),
    )
