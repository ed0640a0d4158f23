"""Seeded stand-in scenes, written as `.crtscene` files.

The reference's scene corpus is not part of this repository, so every
scene the tests, the benchmark and `chip_smoke.py` render is generated
here from a seed and written to disk in the `.crtscene` dialect; the
normal entry points (`parse_scene_file`, `python -m simd_raytracer`) then
load it like any user scene.  Bitmap textures are written as binary PPM,
which the loader decodes without Pillow.

Stand-ins and the corpus scenes whose shape they keep (the true geometry
is unknown; see README "Stand-in scenes" for what is assumed):

  room          hw15/scene2: 2,012 triangles, 1920x1920, bucket 24, one
                light, 12 materials (2 refractive, 7 constant,
                10 reflective)
  dragon        hw09/scene5: one closed 4,012-triangle mesh (a seeded
                displaced sphere) on a floor, 4,014 in all, 1920x1080,
                four lights
  dragon_glass  hw11/scene8: the same mesh refractive in a five-wall box,
                4,022 triangles
  textures      hw12/scene4: 8 triangles, albedo/edges/checker/bitmap
  terrain       large scenes: a 2*g^2-triangle heightfield (g=354 gives
                250,632 triangles), 512x512

and the small cases the tests render at a few dozen pixels:

  diffuse       diffuse quads and boxes, one light
  diffuse_room  closed diffuse room, two lights
  mirror        a mirror quad reflecting diffuse boxes
  glass         a refractive sphere (total internal reflection inside)
  prism         a refractive 45-degree prism (total internal reflection)
  mixed         diffuse, mirror, glass and constant surfaces, two lights
  tiny          three lit quads: diffuse, mirror, glass

Usage: write_scene(name, out_dir, seed) -> path;
       python -m simd_raytracer.models.scenegen OUT_DIR [NAME ...]
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

from ..utils.ppm import write_ppm_binary


class _Doc:
    """Accumulates one `.crtscene` document."""

    def __init__(self, width, height, background, bucket_size=None):
        image = {"width": int(width), "height": int(height)}
        if bucket_size is not None:
            image["bucket_size"] = int(bucket_size)
        self.doc = {"settings": {"background_color": list(background),
                                 "image_settings": image},
                    "camera": None, "lights": [], "textures": [],
                    "materials": [], "objects": []}
        self.bitmaps = {}

    def look_at(self, pos, target, up=(0.0, 1.0, 0.0)):
        pos, target = np.asarray(pos, float), np.asarray(target, float)
        back = pos - target
        back /= np.linalg.norm(back)
        right = np.cross(up, back)
        right /= np.linalg.norm(right)
        m = np.stack([right, np.cross(back, right), back])
        self.doc["camera"] = {"position": _floats(pos),
                              "matrix": _floats(m)}

    def light(self, pos, intensity):
        self.doc["lights"].append({"position": _floats(pos),
                                   "intensity": float(intensity)})

    def material(self, kind, albedo=(0.8, 0.8, 0.8), ior=1.5,
                 smooth=False) -> int:
        m = {"type": kind, "smooth_shading": bool(smooth)}
        if kind == "refractive":
            m["ior"] = float(ior)
        else:
            m["albedo"] = albedo if isinstance(albedo, str) else _floats(albedo)
        self.doc["materials"].append(m)
        return len(self.doc["materials"]) - 1

    def texture(self, name, kind, bitmap=None, **fields):
        t = {"name": name, "type": kind}
        t.update({k: _floats(v) if isinstance(v, (tuple, list, np.ndarray))
                  else float(v) for k, v in fields.items()})
        if bitmap is not None:
            t["file_path"] = f"{name}.ppm"
            self.bitmaps[t["file_path"]] = bitmap
        self.doc["textures"].append(t)

    def mesh(self, verts, tris, material, uvs=None):
        obj = {"material_index": int(material),
               "vertices": _floats(verts),
               "triangles": np.asarray(tris, np.int64).ravel().tolist()}
        if uvs is not None:
            uv3 = np.concatenate([np.asarray(uvs, np.float32),
                                  np.zeros((len(uvs), 1), np.float32)], 1)
            obj["uvs"] = _floats(uv3)
        self.doc["objects"].append(obj)


def _floats(a):
    # float32 values written as their exact float64 repr: parsing them back
    # and casting to float32 reproduces the generated vertices bit for bit.
    return np.asarray(a, np.float32).ravel().tolist()


# ------------------------------------------------------------ geometry

def _quad(center, u, v):
    """Planar quad c +- u +- v, 2 triangles, normal along u x v."""
    c, u, v = (np.asarray(x, np.float32) for x in (center, u, v))
    verts = np.stack([c - u - v, c + u - v, c + u + v, c - u + v])
    return verts, np.array([[0, 1, 2], [0, 2, 3]]), np.array(
        [[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)


def _box_faces(center, half, inward=False):
    """{(axis, sign): (verts, tris)} for the six faces of an axis-aligned
    box, normals outward (or inward, for a room)."""
    c = np.asarray(center, np.float32)
    h = np.asarray(half, np.float32)
    e = np.eye(3, dtype=np.float32)
    faces = {}
    for k in range(3):
        for s in (1.0, -1.0):
            u = e[(k + 1) % 3] * h[(k + 1) % 3]
            v = e[(k + 2) % 3] * h[(k + 2) % 3]
            if (s < 0) != inward:
                u, v = v, u
            faces[(k, s)] = _quad(c + s * h[k] * e[k], u, v)[:2]
    return faces


def _box(center, half, inward=False, skip=()):
    """Axis-aligned box, 2 triangles per face; skip: (axis, sign) faces
    left open."""
    faces = [f for key, f in _box_faces(center, half, inward).items()
             if key not in skip]
    return (np.concatenate([v for v, _ in faces]),
            np.concatenate([t + 4 * i for i, (_, t) in enumerate(faces)]))


def _sphere(center, radius, n_lon, n_lat, displace=None):
    """Closed UV sphere: 2 * n_lon * (n_lat - 1) triangles, outward.

    displace(unit_dirs) -> radial scale per vertex (positive) turns it into
    a star-shaped blob; winding is fixed on the undisplaced sphere."""
    theta = np.pi * np.arange(1, n_lat) / n_lat
    phi = 2.0 * np.pi * np.arange(n_lon) / n_lon
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    ring = np.stack([st * np.cos(phi), np.repeat(ct, n_lon, axis=1),
                     st * np.sin(phi)], -1)
    unit = np.concatenate([[[0.0, 1.0, 0.0]], ring.reshape(-1, 3),
                           [[0.0, -1.0, 0.0]]])
    south = len(unit) - 1

    def rid(i, j):
        return 1 + i * n_lon + (j % n_lon)

    tris = []
    for j in range(n_lon):
        tris.append([0, rid(0, j), rid(0, j + 1)])
        tris.append([south, rid(n_lat - 2, j + 1), rid(n_lat - 2, j)])
        for i in range(n_lat - 2):
            a, b = rid(i, j), rid(i, j + 1)
            c, d = rid(i + 1, j + 1), rid(i + 1, j)
            tris += [[a, b, c], [a, c, d]]
    tris = np.array(tris)
    p = unit[tris]
    n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    flip = np.sum(n * p.mean(axis=1), axis=1) < 0
    tris[flip] = tris[flip][:, ::-1]
    r = radius * (displace(unit) if displace is not None else 1.0)
    verts = np.asarray(center) + unit * np.reshape(r, (-1, 1))
    return verts.astype(np.float32), tris


def _prism(center, half_width, depth):
    """Right isosceles prism (45-degree faces) standing on its square face:
    rays entering the hypotenuse face meet the legs past the critical
    angle of glass, so the scene exercises total internal reflection."""
    c = np.asarray(center, np.float32)
    a, z = half_width, depth
    base = np.array([[-a, 0, 0], [a, 0, 0], [0, a, 0]], np.float32)
    front = base + c + [0, 0, z]
    back = base + c - [0, 0, z]
    verts = np.concatenate([front, back])
    tris = np.array([[0, 1, 2], [3, 5, 4],                # caps
                     [0, 3, 4], [0, 4, 1],                # floor
                     [1, 4, 5], [1, 5, 2],                # right leg
                     [2, 5, 3], [2, 3, 0]])               # left leg
    p = verts[tris]
    n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    flip = np.sum(n * (p.mean(axis=1) - verts.mean(axis=0)), axis=1) < 0
    tris[flip] = tris[flip][:, ::-1]
    return verts, tris


def _blob(rng, stretch=(1.7, 0.9, 1.0)):
    """Seeded smooth radial displacement: a lumpy elongated body."""
    w = rng.normal(size=(6, 3)) * rng.uniform(2.0, 5.0, (6, 1))
    a = rng.uniform(-1.0, 1.0, 6) / 6.0
    ph = rng.uniform(0.0, 2.0 * np.pi, 6)
    s = np.asarray(stretch)

    def displace(unit):
        lumps = 1.0 + 0.35 * np.sin(unit @ w.T + ph) @ a
        return lumps * np.linalg.norm(unit * s, axis=1)

    return displace


# --------------------------------------------------------------- scenes

def _room(rng) -> _Doc:
    g = _Doc(1920, 1920, (0.1, 0.1, 0.12), bucket_size=24)
    g.look_at((0.0, 2.5, 2.3), (0.0, 2.3, -2.5))
    g.light((0.0, 4.3, -2.2), 75.0)
    mats = [g.material("diffuse", (0.75, 0.75, 0.75)),          # 0 ceiling
            g.material("diffuse", (0.75, 0.2, 0.2)),            # 1 left
            g.material("refractive", ior=1.5, smooth=True),     # 2 glass
            g.material("diffuse", (0.2, 0.7, 0.25)),            # 3 right
            g.material("diffuse", (0.25, 0.35, 0.8)),           # 4 box
            g.material("diffuse", (0.6, 0.6, 0.55)),            # 5 floor
            g.material("diffuse", (0.85, 0.6, 0.2)),            # 6 box
            g.material("constant", (1.0, 0.95, 0.85)),          # 7 panel
            g.material("diffuse", (0.7, 0.7, 0.7)),             # 8 back
            g.material("diffuse", (0.55, 0.3, 0.65), smooth=True),  # 9
            g.material("reflective", (0.9, 0.9, 0.9), smooth=True),  # 10
            g.material("diffuse", (0.3, 0.65, 0.65))]           # 11
    faces = _box_faces((0.0, 2.5, -2.5), (2.5, 2.5, 2.5), inward=True)
    for face, mat in [((1, 1.0), 0), ((0, -1.0), 1), ((0, 1.0), 3),
                      ((1, -1.0), 5), ((2, -1.0), 8)]:
        g.mesh(*faces[face], mats[mat])
    v, t, _ = _quad((0.0, 4.98, -2.5), (0.6, 0, 0), (0, 0, 0.6))
    g.mesh(v, t, mats[7])                                    # faces down
    jitter = rng.uniform(-0.15, 0.15, (4, 2))
    g.mesh(*_sphere((-1.0 + jitter[0, 0], 0.9, -2.2 + jitter[0, 1]), 0.9,
                    26, 20), mats[2])
    g.mesh(*_sphere((1.2 + jitter[1, 0], 0.8, -3.4 + jitter[1, 1]), 0.8,
                    26, 20), mats[10])
    g.mesh(*_box((1.4 + jitter[2, 0], 0.45, -1.3 + jitter[2, 1]),
                 (0.45, 0.45, 0.45)), mats[4])
    g.mesh(*_box((-1.3 + jitter[3, 0], 0.7, -4.0 + jitter[3, 1]),
                 (0.5, 0.7, 0.4)), mats[9])
    return g


def _dragon(rng, glass=False) -> _Doc:
    g = _Doc(1920, 1080, (0.15, 0.18, 0.25))
    g.look_at((0.0, 1.6, 4.2), (0.0, 0.7, 0.0))
    body = g.material("refractive", ior=1.5, smooth=True) if glass else \
        g.material("diffuse", (0.35, 0.65, 0.3), smooth=True)
    floor = g.material("diffuse", (0.7, 0.7, 0.65))
    # 2 * 59 * 34 = 4,012 triangles
    v, t = _sphere((0.0, 1.0, 0.0), 1.0, 59, 35, displace=_blob(rng))
    v[:, 1] -= v[:, 1].min() - 0.02                       # rest on the floor
    g.mesh(v, t, body)
    if glass:
        v, t = _box((0.0, 3.0, -1.0), (4.0, 3.0, 5.0), inward=True,
                    skip=[(2, 1.0)])
        g.mesh(v, t, floor)
        g.light((2.0, 5.0, 2.0), 120.0)
        g.light((-3.0, 4.0, -2.0), 90.0)
    else:
        v, t, _ = _quad((0.0, 0.0, 0.0), (6.0, 0, 0), (0, 0, -6.0))
        g.mesh(v, t, floor)
        for pos, inten in [((3.0, 4.0, 3.0), 100.0), ((-3.5, 3.0, 2.0), 70.0),
                           ((0.5, 5.0, -3.0), 90.0), ((-1.0, 2.0, 4.0), 35.0)]:
            g.light(pos, inten * rng.uniform(0.9, 1.1))
    return g


def _textures(rng) -> _Doc:
    g = _Doc(1920, 1080, (0.2, 0.2, 0.2))
    g.look_at((0.0, 0.0, 1.25), (0.0, 0.0, 0.0))
    g.light((0.0, 1.0, 1.5), 25.0)
    g.light((-2.0, -1.0, 2.0), 10.0)
    g.texture("flat", "albedo", albedo=(0.8, 0.3, 0.2))
    g.texture("frame", "edges", edge_color=(0.05, 0.05, 0.05),
              inner_color=(0.9, 0.8, 0.3), edge_width=0.04)
    g.texture("board", "checker", color_A=(0.9, 0.9, 0.9),
              color_B=(0.1, 0.2, 0.6), square_size=0.125)
    hb, wb = 48, 64
    yy, xx = np.mgrid[0:hb, 0:wb]
    base = rng.uniform(0, 1, 3)
    img = np.stack([(xx / wb + base[0]) % 1.0, (yy / hb + base[1]) % 1.0,
                    (0.5 + 0.5 * np.sin((xx + yy) * 0.3 + base[2] * 6))], -1)
    g.texture("picture", "bitmap", bitmap=(img * 255.0).astype(np.uint8))
    for i, (name, cx, cy) in enumerate([("flat", -1.05, 0.55),
                                        ("frame", 1.05, 0.55),
                                        ("board", -1.05, -0.55),
                                        ("picture", 1.05, -0.55)]):
        m = g.material("diffuse", albedo=name, smooth=False)
        v, t, uv = _quad((cx, cy, 0.0), (1.0, 0, 0), (0, 0.5, 0))
        g.mesh(v, t, m, uvs=uv)
    return g


def _terrain(rng, g_cells=354) -> _Doc:
    """Heightfield over [-10,10] x [-20,0] with seeded rolling hills,
    2 * g^2 triangles, camera tilted ~20.6 degrees down the -z axis."""
    g = _Doc(512, 512, (0.2, 0.3, 0.5))
    g.doc["camera"] = {"position": [0.0, 2.5, 1.0],
                       "matrix": [1.0, 0.0, 0.0, 0.0, 0.9363, -0.3515,
                                  0.0, 0.3515, 0.9363]}
    g.light((0.0, 6.0, -10.0), 900.0)
    m = g.material("diffuse", (0.55, 0.5, 0.4), smooth=True)
    n = g_cells
    ph = rng.uniform(0.0, 2.0 * np.pi, 2)
    xs = np.linspace(-10, 10, n + 1, dtype=np.float32)
    zs = np.linspace(-20, 0, n + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, zs, indexing="xy")
    gy = (np.sin(gx * 0.9 + ph[0]) * np.cos(gz * 0.7) * 0.8
          + np.sin(gx * 2.3 + gz * 1.7 + ph[1]) * 0.3 - 2.0)
    verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    v00 = (ii * (n + 1) + jj).ravel()
    v10 = v00 + (n + 1)
    tris = np.concatenate([np.stack([v00, v10, v00 + 1], axis=1),
                           np.stack([v00 + 1, v10, v10 + 1], axis=1)])
    g.mesh(verts, tris, m)
    return g


def _small(background=(0.1, 0.12, 0.18)) -> _Doc:
    g = _Doc(320, 240, background)
    g.look_at((0.0, 1.2, 4.0), (0.0, 0.5, 0.0))
    return g


def _diffuse(rng) -> _Doc:
    g = _small()
    g.light((1.5, 3.0, 2.5), 130.0)
    floor = g.material("diffuse", (0.7, 0.7, 0.7))
    red = g.material("diffuse", (0.8, 0.25, 0.2))
    blue = g.material("diffuse", (0.2, 0.3, 0.8), smooth=True)
    g.mesh(*_quad((0, 0, 0), (3.0, 0, 0), (0, 0, -3.0))[:2], floor)
    off = rng.uniform(-0.2, 0.2, 2)
    g.mesh(*_box((-0.8 + off[0], 0.5, -0.5), (0.5, 0.5, 0.5)), red)
    g.mesh(*_sphere((0.9, 0.6, -0.3 + off[1]), 0.6, 12, 8), blue)
    return g


def _diffuse_room(rng) -> _Doc:
    g = _small()
    g.look_at((0.0, 1.5, 2.6), (0.0, 1.2, -2.0))
    g.light((-1.0, 2.6, -1.0), 12.0)
    g.light((1.2, 2.0, 0.5), 8.0)
    walls = g.material("diffuse", (0.75, 0.75, 0.7))
    box = g.material("diffuse", (0.3, 0.6, 0.8))
    g.mesh(*_box((0.0, 1.5, -1.0), (2.0, 1.5, 2.0), inward=True), walls)
    h = rng.uniform(0.4, 0.6)
    g.mesh(*_box((0.4, h, -1.5), (0.5, h, 0.4)), box)
    return g


def _mirror(rng) -> _Doc:
    g = _small()
    g.light((0.0, 3.0, 2.0), 120.0)
    floor = g.material("diffuse", (0.6, 0.6, 0.6))
    mirror = g.material("reflective", (0.9, 0.9, 0.95))
    red = g.material("diffuse", (0.8, 0.2, 0.2))
    green = g.material("diffuse", (0.2, 0.7, 0.3), smooth=True)
    g.mesh(*_quad((0, 0, 0), (3.0, 0, 0), (0, 0, -3.0))[:2], floor)
    tilt = rng.uniform(0.2, 0.35)
    g.mesh(*_quad((0.0, 1.0, -1.5), (1.2, 0, tilt), (0, 1.0, 0))[:2], mirror)
    g.mesh(*_box((-0.9, 0.35, 0.3), (0.35, 0.35, 0.35)), red)
    g.mesh(*_sphere((0.9, 0.4, 0.4), 0.4, 10, 7), green)
    return g


def _glass(rng) -> _Doc:
    g = _small()
    g.light((1.0, 3.0, 2.0), 120.0)
    floor = g.material("diffuse", (0.7, 0.7, 0.7))
    back = g.material("diffuse", (0.3, 0.4, 0.8))
    glass = g.material("refractive", ior=1.5, smooth=True)
    g.mesh(*_quad((0, 0, -1), (3.0, 0, 0), (0, 0, -2.0))[:2], floor)
    g.mesh(*_quad((0, 1.5, -2.5), (3.0, 0, 0), (0, 1.5, 0))[:2], back)
    g.mesh(*_sphere((rng.uniform(-0.1, 0.1), 0.7, -0.8), 0.7, 16, 10), glass)
    return g


def _prism_scene(rng) -> _Doc:
    g = _small()
    g.light((-1.0, 3.0, 2.0), 110.0)
    floor = g.material("diffuse", (0.7, 0.7, 0.7))
    back = g.material("diffuse", (0.8, 0.5, 0.2))
    glass = g.material("refractive", ior=1.5)
    g.mesh(*_quad((0, 0, -1), (3.0, 0, 0), (0, 0, -2.0))[:2], floor)
    g.mesh(*_quad((0, 1.5, -2.5), (3.0, 0, 0), (0, 1.5, 0))[:2], back)
    g.mesh(*_prism((rng.uniform(-0.1, 0.1), 0.01, -0.6), 0.8, 0.5), glass)
    return g


def _mixed(rng) -> _Doc:
    g = _small()
    g.light((1.5, 3.0, 2.0), 120.0)
    g.light((-2.0, 2.0, 1.0), 45.0)
    floor = g.material("diffuse", (0.7, 0.7, 0.7))
    back = g.material("diffuse", (0.75, 0.6, 0.4))
    mirror = g.material("reflective", (0.85, 0.85, 0.9))
    glass = g.material("refractive", ior=1.45, smooth=True)
    lamp = g.material("constant", (1.0, 0.9, 0.6))
    box = g.material("diffuse", (0.3, 0.55, 0.8), smooth=True)
    g.mesh(*_quad((0, 0, -0.5), (3.0, 0, 0), (0, 0, -2.5))[:2], floor)
    g.mesh(*_quad((0, 1.5, -3.0), (3.0, 0, 0), (0, 1.5, 0))[:2], back)
    g.mesh(*_quad((-1.6, 0.9, -1.8), (0.6, 0, 0.35), (0, 0.8, 0))[:2], mirror)
    g.mesh(*_sphere((0.2, 0.55, -0.7 + rng.uniform(-0.1, 0.1)), 0.55, 12, 8),
           glass)
    g.mesh(*_box((1.3, 0.4, -1.4), (0.4, 0.4, 0.4)), box)
    g.mesh(*_quad((1.6, 1.8, -2.9), (0.3, 0, 0), (0, 0.3, 0))[:2], lamp)
    return g


def _tiny(rng) -> _Doc:
    g = _Doc(16, 16, (0.05, 0.05, 0.1), bucket_size=8)
    g.doc["camera"] = {"position": [0.0, 0.0, 0.0],
                       "matrix": np.eye(3).ravel().tolist()}
    g.light((0.0, 2.0, -2.0), 60.0)
    mats = [g.material("diffuse", (0.8, 0.3, 0.2)),
            g.material("reflective", (0.9, 0.9, 0.9), smooth=True),
            g.material("refractive", ior=1.5, smooth=True)]
    for (cx, cy, z), m in zip([(-1.0, 0.0, -4.0), (1.0, 0.0, -5.0),
                               (0.0, -1.2, -4.5)], mats):
        g.mesh(*_quad((cx, cy, z), (0.8, 0, 0), (0, 0.8, 0))[:2], m)
    return g


STANDINS = {
    "room": _room,
    "dragon": _dragon,
    "dragon_glass": lambda rng: _dragon(rng, glass=True),
    "textures": _textures,
    "terrain": _terrain,
    "diffuse": _diffuse,
    "diffuse_room": _diffuse_room,
    "mirror": _mirror,
    "glass": _glass,
    "prism": _prism_scene,
    "mixed": _mixed,
    "tiny": _tiny,
}

# Everything but the 250k-triangle terrain: what the tests write.
SMALL = tuple(n for n in STANDINS if n != "terrain")


def scene_doc(name: str, seed: int = 0):
    """(doc dict, {bitmap file name: (H, W, 3) uint8}) for a stand-in."""
    g = STANDINS[name](np.random.default_rng(seed))
    return g.doc, g.bitmaps


def write_scene(name: str, out_dir: str, seed: int = 0) -> str:
    """Write stand-in `name` (and its bitmaps) into out_dir; returns the
    path of the `.crtscene` file."""
    doc, bitmaps = scene_doc(name, seed)
    os.makedirs(out_dir, exist_ok=True)
    for fname, img in bitmaps.items():
        write_ppm_binary(img, os.path.join(out_dir, fname))
    path = os.path.join(out_dir, f"{name}.crtscene")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def load_scene(name: str, seed: int = 0, **overrides):
    """Generate, write to a temporary directory and parse one stand-in;
    overrides (height=..., width=...) are applied to the parsed Scene."""
    from .loader import parse_scene_file
    with tempfile.TemporaryDirectory() as d:
        scene = parse_scene_file(write_scene(name, d, seed))
    return scene.replace(**overrides) if overrides else scene


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 2
    for name in argv[1:] or SMALL:
        print(write_scene(name, argv[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
