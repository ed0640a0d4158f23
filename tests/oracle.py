"""Scalar NumPy oracle: a direct, recursive re-implementation of the
reference renderer's semantics (render.hpp color_hit/is_occluded,
kd_tree_simd smooth-normal reconstruction, texture samplers), used as the
golden reference for the wavefront renderer since the C++ binary cannot
be built offline (its CMake FetchContent needs network).

Intentionally slow and simple — per-pixel Python recursion with the
intersection vectorized over all triangles.  Only usable for tiny images.
"""

from __future__ import annotations

import math

import numpy as np

from simd_raytracer.config import RenderConfig
from simd_raytracer.models.scene import (MAT_CONSTANT, MAT_DIFFUSE,
                                         MAT_REFLECTIVE, MAT_REFRACTIVE,
                                         MAT_TEXTURE, TEX_ALBEDO,
                                         TEX_BITMAP, TEX_CHECKER,
                                         TEX_EDGES, Scene)


class NumpyScene:
    """Scene pytree pulled to host numpy + derived triangle arrays."""

    def __init__(self, scene: Scene):
        g = lambda a: np.asarray(a)
        self.s = scene
        v = g(scene.vertices)
        idx = g(scene.tri_vidx)
        self.valid = g(scene.tri_valid)
        self.v0 = v[idx[:, 0]]
        self.e1 = v[idx[:, 1]] - self.v0
        self.e2 = v[idx[:, 2]] - self.v0
        n_raw = np.cross(self.e1, self.e2)
        norm = np.maximum(np.linalg.norm(n_raw, axis=-1, keepdims=True), 1e-20)
        self.face_n = n_raw / norm
        vn_accum = np.zeros_like(v)
        for c in range(3):
            np.add.at(vn_accum, idx[:, c],
                      self.face_n * self.valid[:, None])
        vn_norm = np.maximum(np.linalg.norm(vn_accum, axis=-1,
                                            keepdims=True), 1e-20)
        vertex_n = vn_accum / vn_norm
        self.vn = vertex_n[idx]
        self.uv = g(scene.uv)
        self.tri_mat = g(scene.tri_mat)
        self.tri_mesh = g(scene.tri_mesh)
        self.mat_tag = g(scene.mat_tag)
        self.mat_albedo = g(scene.mat_albedo)
        self.mat_ior = g(scene.mat_ior)
        self.mat_smooth = g(scene.mat_smooth)
        self.mat_tex = g(scene.mat_tex)
        self.tex_tag = g(scene.tex_tag)
        self.tex_color_a = g(scene.tex_color_a)
        self.tex_color_b = g(scene.tex_color_b)
        self.tex_param = g(scene.tex_param)
        self.tex_offset = g(scene.tex_offset)
        self.tex_width = g(scene.tex_width)
        self.tex_height = g(scene.tex_height)
        self.atlas = g(scene.atlas)
        self.light_pos = g(scene.light_pos)
        self.light_intensity = g(scene.light_intensity)
        self.cam_pos = g(scene.cam_pos).astype(np.float32)
        self.cam_mat = g(scene.cam_mat).astype(np.float32)
        self.background = g(scene.background).astype(np.float32)
        self.transmissive = self.mat_tag[self.tri_mat] == MAT_REFRACTIVE


def intersect(ns: NumpyScene, o, d, eps, cull, exclude_transmissive=False):
    """Closest hit over all triangles; returns dict or None."""
    px = np.cross(np.broadcast_to(d, ns.e2.shape), ns.e2)
    det = np.sum(ns.e1 * px, axis=-1)
    if cull:
        ok = det > eps
    else:
        ok = np.abs(det) > eps
    ok &= ns.valid
    if exclude_transmissive:
        ok &= ~ns.transmissive
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / det
        tv = o - ns.v0
        u = np.sum(tv * px, axis=-1) * inv
        ok &= (u >= 0) & (u <= 1)
        q = np.cross(tv, ns.e1)
        v = np.sum(np.broadcast_to(d, q.shape) * q, axis=-1) * inv
        ok &= (v >= 0) & (u + v <= 1)
        t = np.sum(ns.e2 * q, axis=-1) * inv
        ok &= t > eps
    if not ok.any():
        return None
    t = np.where(ok, t, np.inf)
    i = int(np.argmin(t))
    u, v, t = float(u[i]), float(v[i]), float(t[i])
    w = 1.0 - u - v
    pos = o + t * d
    n_int = u * ns.vn[i, 1] + v * ns.vn[i, 2] + w * ns.vn[i, 0]
    n_int = n_int / max(np.linalg.norm(n_int), 1e-20)
    return dict(idx=i, t=t, u=u, v=v, w=w, position=pos, hit_n=n_int,
                face_n=ns.face_n[i], uvs=ns.uv[i],
                mat=int(ns.tri_mat[i]), d=d, o=o)


def is_occluded(ns: NumpyScene, o, d, max_t, cfg: RenderConfig):
    """render.hpp:110-131."""
    while max_t > 0.0:
        h = intersect(ns, o, d, cfg.epsilon, cull=False)
        if h is None or max_t < h["t"]:
            return False
        if ns.mat_tag[h["mat"]] != MAT_REFRACTIVE:
            return True
        o = h["position"] + cfg.shadow_bias * d
        max_t -= h["t"]
    return False


def sample_tex(ns: NumpyScene, tex_id, hit):
    tag = ns.tex_tag[tex_id]
    u, v = hit["u"], hit["v"]
    w = 1.0 - u - v
    uvs = hit["uvs"]
    fuv = w * uvs[0] + u * uvs[1] + v * uvs[2]
    if tag == TEX_ALBEDO:
        return ns.tex_color_a[tex_id]
    if tag == TEX_EDGES:
        p = ns.tex_param[tex_id]
        return (ns.tex_color_a[tex_id] if (u < p or v < p or w < p)
                else ns.tex_color_b[tex_id])
    if tag == TEX_CHECKER:
        sq = ns.tex_param[tex_id]
        u2 = int(fuv[0] / sq)
        v2 = int(fuv[1] / sq)
        return (ns.tex_color_a[tex_id] if math.fmod(u2 + v2, 2) == 0
                else ns.tex_color_b[tex_id])
    # bitmap
    th, tw = int(ns.tex_height[tex_id]), int(ns.tex_width[tex_id])
    row = int(np.clip(int((1.0 - fuv[1]) * th), 0, th - 1))
    col = int(np.clip(int(fuv[0] * tw), 0, tw - 1))
    return ns.atlas[int(ns.tex_offset[tex_id]) + row * tw + col]


def direct_light(ns: NumpyScene, hit, smooth, cfg):
    total = 0.0
    for lp, li in zip(ns.light_pos, ns.light_intensity):
        ldir = lp - hit["position"]
        r = float(np.linalg.norm(ldir))
        area = 4.0 * math.pi * r * r
        ldir = ldir / max(r, 1e-20)
        nvec = hit["hit_n"] if smooth else hit["face_n"]
        cosl = max(0.0, float(np.dot(ldir, nvec)))
        so = hit["position"] + cfg.shadow_bias * ldir
        if is_occluded(ns, so, ldir, r, cfg):
            continue
        total += li / max(area, 1e-20) * cosl
    return total


def color_hit(ns: NumpyScene, hit, depth, cfg: RenderConfig, rng=None):
    """render.hpp:133-308."""
    if depth == cfg.max_ray_depth:
        return ns.background.copy()
    tag = ns.mat_tag[hit["mat"]]
    smooth = bool(ns.mat_smooth[hit["mat"]])
    eps = cfg.epsilon

    if tag == MAT_DIFFUSE:
        out = np.zeros(3, np.float32)
        cnt = cfg.diffuse_reflection_ray_count
        for _ in range(cnt):
            right = np.cross(hit["d"], hit["hit_n"])
            right = right / max(np.linalg.norm(right), 1e-20)
            up = hit["hit_n"]
            fwd = np.cross(right, up)
            a1 = math.pi * rng.random()
            rv = np.array([math.cos(a1), math.sin(a1), 0.0])
            a2 = 2.0 * math.pi * rng.random()
            c, s = math.cos(a2), math.sin(a2)
            rv = np.array([c * rv[0] - s * rv[2], rv[1],
                           s * rv[0] + c * rv[2]])
            gdir = np.array([np.dot(right, rv), np.dot(up, rv),
                             np.dot(fwd, rv)])
            gorg = hit["position"] + cfg.reflection_bias * hit["hit_n"]
            gh = intersect(ns, gorg, gdir, eps, cull=False)
            if gh is None:
                continue
            out += color_hit(ns, gh, depth + 1, cfg, rng)
        out += direct_light(ns, hit, smooth, cfg) * ns.mat_albedo[hit["mat"]]
        return out / (cnt + 1)

    if tag == MAT_TEXTURE:
        f = direct_light(ns, hit, smooth, cfg)
        return np.float32(f) * np.asarray(
            sample_tex(ns, int(ns.mat_tex[hit["mat"]]), hit), np.float32)

    if tag == MAT_REFLECTIVE:
        d = hit["d"]
        rd = d - 2.0 * np.dot(d, hit["hit_n"]) * hit["hit_n"]
        ro = hit["position"] + cfg.reflection_bias * rd
        rh = intersect(ns, ro, rd, eps, cull=False)
        if rh is None:
            return ns.background.copy()
        return color_hit(ns, rh, depth + 1, cfg, rng)

    if tag == MAT_REFRACTIVE:
        nvec = hit["hit_n"] if smooth else hit["face_n"]
        nvec = nvec / max(np.linalg.norm(nvec), 1e-20)
        i = hit["d"] / max(np.linalg.norm(hit["d"]), 1e-20)
        eta_i, eta_r = 1.0, float(ns.mat_ior[hit["mat"]])
        if np.dot(i, nvec) > 0:
            eta_i, eta_r = eta_r, eta_i
            nvec = -nvec
        cos_i = -float(np.dot(i, nvec))
        sin_i = math.sqrt(max(0.0, 1.0 - cos_i * cos_i))
        if eta_r / eta_i < sin_i:   # total internal reflection
            rd = i - 2.0 * np.dot(i, nvec) * nvec
            ro = hit["position"] + cfg.reflection_bias * rd
            rh = intersect(ns, ro, rd, eps, cull=False)
            if rh is None:
                return np.zeros(3, np.float32)
            return color_hit(ns, rh, depth + 1, cfg, rng)
        sin_r = sin_i * eta_i / eta_r
        cos_r = math.sqrt(max(0.0, 1.0 - sin_r * sin_r))
        perp = i + cos_i * nvec
        perp = perp / max(np.linalg.norm(perp), 1e-20)
        refr = cos_r * (-nvec) + sin_r * perp
        fo = hit["position"] + cfg.refraction_bias * refr
        fh = intersect(ns, fo, refr, eps, cull=False)
        refr_c = (color_hit(ns, fh, depth + 1, cfg, rng) if fh is not None
                  else np.zeros(3, np.float32))
        rd = i - 2.0 * np.dot(i, nvec) * nvec
        ro = hit["position"] + cfg.reflection_bias * rd
        rh = intersect(ns, ro, rd, eps, cull=False)
        refl_c = (color_hit(ns, rh, depth + 1, cfg, rng) if rh is not None
                  else np.zeros(3, np.float32))
        fresnel = 0.5 * (1.0 + float(np.dot(i, nvec))) ** 5
        return fresnel * refl_c + (1.0 - fresnel) * refr_c

    if tag == MAT_CONSTANT:
        return ns.mat_albedo[hit["mat"]].copy()

    return np.zeros(3, np.float32)


def render(scene: Scene, cfg: RenderConfig, res=None) -> np.ndarray:
    """Full oracle render; res=(h, w) overrides the scene resolution."""
    ns = NumpyScene(scene)
    h, w = res if res is not None else (scene.height, scene.width)
    aspect = np.float32(w) / np.float32(h)
    tan_half = np.float32(math.tan(math.radians(cfg.fov_degrees) / 2.0))
    img = np.zeros((h, w, 3), np.float32)
    rng = np.random.default_rng(cfg.rng_seed or 0)
    for y in range(h):
        for x in range(w):
            acc = np.zeros(3, np.float32)
            for _ in range(cfg.samples_per_pixel):
                if cfg.samples_per_pixel == 1:
                    rx, ry = x + 0.5, y + 0.5
                else:
                    rx, ry = x + rng.random(), y + rng.random()
                sx = (2.0 * np.float32(rx / w) - 1.0) * aspect * tan_half
                sy = (1.0 - 2.0 * np.float32(ry / h)) * tan_half
                dvec = np.array([sx, sy, -1.0], np.float32) @ ns.cam_mat
                dvec = dvec / np.linalg.norm(dvec)
                hrec = intersect(ns, ns.cam_pos, dvec, cfg.epsilon, cull=True)
                if hrec is None:
                    acc += ns.background
                else:
                    acc += color_hit(ns, hrec, 0, cfg, rng)
            img[y, x] = acc / cfg.samples_per_pixel
    return img
