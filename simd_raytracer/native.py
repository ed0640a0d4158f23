"""ctypes bindings to the native C++ runtime components (native/).

The reference's runtime is C++ end to end; the compute path here is
JAX/XLA/Pallas, but the host-side runtime pieces that the reference also
does natively — kd-tree construction (kd_tree_simd.hpp:100-185), scene
JSON parsing (io/json/loader.hpp via simdjson), PPM encoding
(io/image/ppm.hpp) — have C++ implementations in native/, compiled to one
shared library and loaded here.  Every entry point has a pure-Python
fallback, so the package works without a toolchain; when the library is
present the native path is used and tested for bit-identical output
against the Python oracle.

Build: `make -C native` (or `python -m simd_raytracer.native`).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import sys
from typing import Optional

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[1] / "native"
_LIB_PATH = _NATIVE_DIR / "libsrt_native.so"
_lib = None
_lib_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    if not _LIB_PATH.exists():
        # First use on a fresh checkout: compile the native components
        # (cheap, ~2 s).  Opt out with SRT_NO_NATIVE_BUILD=1.
        if (os.environ.get("SRT_NO_NATIVE_BUILD")
                or not (_NATIVE_DIR / "Makefile").exists()):
            return None
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR)],
                           capture_output=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            return None
    if not _LIB_PATH.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None

    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    lib.srt_kdtree_build.restype = ctypes.c_void_p
    lib.srt_kdtree_build.argtypes = [
        f32p, f32p, i32p, ctypes.c_int32,           # tri_min, tri_max, ids, n
        ctypes.c_int32, ctypes.c_int32,             # max_depth, max_leaf
    ]
    lib.srt_kdtree_counts.restype = None
    lib.srt_kdtree_counts.argtypes = [
        ctypes.c_void_p, i32p, i32p, i32p]          # -> nodes, leaves, cap
    lib.srt_kdtree_export.restype = None
    lib.srt_kdtree_export.argtypes = [
        ctypes.c_void_p, f32p, f32p, i32p, i32p, i32p, i32p]
    lib.srt_kdtree_free.restype = None
    lib.srt_kdtree_free.argtypes = [ctypes.c_void_p]

    lib.srt_ppm_encode.restype = ctypes.c_int64
    lib.srt_ppm_encode.argtypes = [
        f32p, ctypes.c_int32, ctypes.c_int32, u8p, ctypes.c_int64]

    lib.srt_scene_parse.restype = ctypes.c_void_p
    lib.srt_scene_parse.argtypes = [ctypes.c_char_p]
    lib.srt_scene_error.restype = ctypes.c_char_p
    lib.srt_scene_error.argtypes = [ctypes.c_void_p]
    lib.srt_scene_header.restype = None
    lib.srt_scene_header.argtypes = [ctypes.c_void_p] + [i32p] * 3 + \
        [f32p] * 3 + [i32p] * 4
    lib.srt_scene_lights.restype = None
    lib.srt_scene_lights.argtypes = [ctypes.c_void_p, f32p, f32p]
    lib.srt_scene_material.restype = None
    lib.srt_scene_material.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, i32p, f32p, f32p, i32p, i32p]
    lib.srt_scene_texture.restype = ctypes.c_int32
    lib.srt_scene_texture.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, i32p, f32p, f32p, f32p,
        ctypes.c_char_p, ctypes.c_int32]
    lib.srt_scene_object_counts.restype = None
    lib.srt_scene_object_counts.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, i32p, i32p, i32p, i32p]
    lib.srt_scene_object_data.restype = None
    lib.srt_scene_object_data.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, f32p, f32p, i32p]
    lib.srt_scene_free.restype = None
    lib.srt_scene_free.argtypes = [ctypes.c_void_p]

    _lib = lib
    return _lib


def build_native(verbose: bool = False) -> bool:
    """Compile native/ with make; returns True on success."""
    if not _NATIVE_DIR.exists():
        return False
    try:
        r = subprocess.run(["make", "-C", str(_NATIVE_DIR)],
                           capture_output=not verbose, text=True)
        if r.returncode != 0:
            if not verbose and r.stderr:
                print(r.stderr, file=sys.stderr)
            return False
    except OSError:
        return False
    global _lib, _lib_tried
    _lib, _lib_tried = None, False
    return _load() is not None


def native_available() -> bool:
    return _load() is not None


def native_build_kdtree(tri_min: np.ndarray, tri_max: np.ndarray,
                        valid: Optional[np.ndarray],
                        max_depth: int, max_leaf: int,
                        required: bool = False):
    """C++ kd-tree build; returns a KdTree or None if the lib is missing."""
    lib = _load()
    if lib is None:
        if required:
            raise RuntimeError(
                f"native kd-tree builder requested but {_LIB_PATH} is not "
                "built; run `make -C native`")
        return None

    from .accel.build import KdTree
    import jax.numpy as jnp

    tri_min = np.ascontiguousarray(tri_min, np.float32)
    tri_max = np.ascontiguousarray(tri_max, np.float32)
    if valid is not None:
        ids = np.flatnonzero(np.asarray(valid)).astype(np.int32)
    else:
        ids = np.arange(len(tri_min), dtype=np.int32)
    ids = np.ascontiguousarray(ids)

    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    handle = lib.srt_kdtree_build(
        tri_min.ctypes.data_as(f32p), tri_max.ctypes.data_as(f32p),
        ids.ctypes.data_as(i32p), np.int32(len(ids)),
        np.int32(max_depth), np.int32(max_leaf))
    try:
        n = np.zeros(1, np.int32)
        l = np.zeros(1, np.int32)
        cap = np.zeros(1, np.int32)
        lib.srt_kdtree_counts(handle, n.ctypes.data_as(i32p),
                              l.ctypes.data_as(i32p),
                              cap.ctypes.data_as(i32p))
        nn, nl, ncap = int(n[0]), int(l[0]), int(cap[0])
        node_min = np.zeros((nn, 3), np.float32)
        node_max = np.zeros((nn, 3), np.float32)
        child0 = np.zeros(nn, np.int32)
        child1 = np.zeros(nn, np.int32)
        leaf_id = np.zeros(nn, np.int32)
        leaf_tris = np.zeros((max(1, nl), ncap), np.int32)
        lib.srt_kdtree_export(
            handle,
            node_min.ctypes.data_as(f32p), node_max.ctypes.data_as(f32p),
            child0.ctypes.data_as(i32p), child1.ctypes.data_as(i32p),
            leaf_id.ctypes.data_as(i32p), leaf_tris.ctypes.data_as(i32p))
    finally:
        lib.srt_kdtree_free(handle)

    from .accel.build import tree_depth
    return KdTree(
        node_min=jnp.asarray(node_min), node_max=jnp.asarray(node_max),
        child0=jnp.asarray(child0), child1=jnp.asarray(child1),
        leaf_id=jnp.asarray(leaf_id), leaf_tris=jnp.asarray(leaf_tris),
        depth=tree_depth(child0, child1))


def native_ppm_encode(img: np.ndarray) -> Optional[bytes]:
    """C++ P3 PPM encoder; returns None if the lib is missing."""
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.float32)
    h, w = img.shape[:2]
    # worst case: "255\t" per channel + header
    cap = h * w * 3 * 4 + 64
    out = np.zeros(cap, np.uint8)
    n = lib.srt_ppm_encode(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        np.int32(h), np.int32(w),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        np.int64(cap))
    if n < 0:
        return None
    return out[:n].tobytes()


def native_parse_scene(path: str):
    """Parse a .crtscene with the C++ loader.

    Returns a dict of raw host arrays mirroring the fields
    models/loader.py extracts (bitmap textures carry their file path, not
    pixels — decode stays in Python), or None if the lib is missing.
    Raises ValueError on malformed scenes, like the Python loader.
    """
    lib = _load()
    if lib is None:
        return None

    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)

    def fp(a):
        return a.ctypes.data_as(f32p)

    def ip(a):
        return a.ctypes.data_as(i32p)

    handle = lib.srt_scene_parse(os.fsencode(path))
    try:
        err = lib.srt_scene_error(handle)
        if err:
            raise ValueError(err.decode())

        h = np.zeros(1, np.int32)
        w = np.zeros(1, np.int32)
        bucket = np.zeros(1, np.int32)
        background = np.zeros(3, np.float32)
        cam_pos = np.zeros(3, np.float32)
        cam_mat = np.zeros(9, np.float32)
        counts = np.zeros(4, np.int32)
        lib.srt_scene_header(
            handle, ip(h), ip(w), ip(bucket), fp(background), fp(cam_pos),
            fp(cam_mat), ip(counts[0:]), ip(counts[1:]), ip(counts[2:]),
            ip(counts[3:]))
        nl, nm, nx, no = (int(c) for c in counts)

        light_pos = np.zeros((nl, 3), np.float32)
        light_intensity = np.zeros(nl, np.float32)
        if nl:
            lib.srt_scene_lights(handle, fp(light_pos), fp(light_intensity))

        materials = []
        for i in range(nm):
            tag = np.zeros(1, np.int32)
            albedo = np.zeros(3, np.float32)
            ior = np.zeros(1, np.float32)
            smooth = np.zeros(1, np.int32)
            tex = np.zeros(1, np.int32)
            lib.srt_scene_material(handle, np.int32(i), ip(tag), fp(albedo),
                                   fp(ior), ip(smooth), ip(tex))
            materials.append({
                "tag": int(tag[0]), "albedo": tuple(albedo.tolist()),
                "ior": float(ior[0]), "smooth": bool(smooth[0]),
                "tex": int(tex[0])})

        textures = []
        for i in range(nx):
            tag = np.zeros(1, np.int32)
            ca = np.zeros(3, np.float32)
            cb = np.zeros(3, np.float32)
            param = np.zeros(1, np.float32)
            buf = ctypes.create_string_buffer(4096)
            n = lib.srt_scene_texture(handle, np.int32(i), ip(tag), fp(ca),
                                      fp(cb), fp(param), buf, 4096)
            textures.append({
                "tag": int(tag[0]), "color_a": tuple(ca.tolist()),
                "color_b": tuple(cb.tolist()), "param": float(param[0]),
                "file_path": buf.raw[:n].decode() if n else None})

        objects = []
        for i in range(no):
            mat = np.zeros(1, np.int32)
            nv = np.zeros(1, np.int32)
            nu = np.zeros(1, np.int32)
            nt = np.zeros(1, np.int32)
            lib.srt_scene_object_counts(handle, np.int32(i), ip(mat),
                                        ip(nv), ip(nu), ip(nt))
            verts = np.zeros(int(nv[0]), np.float32)
            uvs = np.zeros(int(nu[0]), np.float32)
            tris = np.zeros(int(nt[0]), np.int32)
            lib.srt_scene_object_data(handle, np.int32(i), fp(verts),
                                      fp(uvs), ip(tris))
            objects.append({
                "material_index": int(mat[0]),
                "vertices": verts.reshape(-1, 3),
                "uvs": uvs.reshape(-1, 2) if int(nu[0]) else None,
                "triangles": tris.reshape(-1, 3).astype(np.int64)})

        return {
            "height": int(h[0]), "width": int(w[0]),
            "bucket_size": int(bucket[0]), "background": background,
            "cam_pos": cam_pos, "cam_mat": cam_mat.reshape(3, 3),
            "light_pos": light_pos, "light_intensity": light_intensity,
            "materials": materials, "textures": textures,
            "objects": objects,
        }
    finally:
        lib.srt_scene_free(handle)


if __name__ == "__main__":
    ok = build_native(verbose=True)
    print("native build:", "ok" if ok else "FAILED")
    sys.exit(0 if ok else 1)
