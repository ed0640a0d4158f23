"""ASCII P3 PPM writer, byte-compatible with the reference writer
(reference: include/raytracer/io/image/ppm.hpp:7-25): header `P3`, `W H`,
`255`, then one image row per line with `R G B\t` per pixel, where each
channel is `uint8(255.999 * clamp(c, 0, 1))` (truncating cast).
"""

from __future__ import annotations

import io

import numpy as np


def image_to_u8(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) float -> uint8 via the reference's 255.999*clamp cast.

    Arithmetic is kept in float32 (the reference's F=float) so the Python
    and C++ (native/ppm.cpp) encoders truncate identically at integer
    boundaries."""
    img = np.asarray(img, np.float32)
    return (np.float32(255.999) * np.clip(img, 0.0, 1.0)).astype(np.uint8)


def write_ppm(img: np.ndarray, stream) -> None:
    """Write (H, W, 3) float image as ASCII P3 to a text stream."""
    h, w = img.shape[:2]
    u8 = image_to_u8(img)
    stream.write(f"P3\n{w} {h}\n255\n")
    for row in u8:
        stream.write("".join(f"{r} {g} {b}\t" for r, g, b in row) + "\n")


def ppm_bytes(img: np.ndarray, use_native: bool = None) -> bytes:
    """Encode to P3 bytes; uses the C++ encoder (native/ppm.cpp) when the
    shared library is built (byte-identical, tested in test_native.py)."""
    if use_native is None or use_native:
        from ..native import native_ppm_encode
        out = native_ppm_encode(np.asarray(img, np.float32))
        if out is not None:
            return out
        if use_native:
            raise RuntimeError("native PPM encoder requested but the shared "
                               "library is not built; run `make -C native`")
    buf = io.StringIO()
    write_ppm(img, buf)
    return buf.getvalue().encode()


def save_ppm(img: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(ppm_bytes(img))


def write_ppm_binary(u8: np.ndarray, path: str) -> None:
    """Write an (H, W, 3) uint8 array as a binary P6 PPM."""
    h, w = u8.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(u8, np.uint8).tobytes())


def read_ppm(path: str) -> np.ndarray:
    """Read an ASCII (P3) or binary (P6) PPM with maxval 255 into an
    (H, W, 3) uint8 array."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:                  # magic, width, height, maxval
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":       # comment to end of line
            pos = data.index(b"\n", pos)
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end].decode())
        pos = end
    magic, w, h, maxv = fields[0], int(fields[1]), int(fields[2]), int(fields[3])
    if maxv != 255 or magic not in ("P3", "P6"):
        raise ValueError(f"{path}: unsupported PPM ({magic}, maxval {maxv})")
    n = w * h * 3
    if magic == "P6":
        px = np.frombuffer(data, np.uint8, n, pos + 1)
    else:
        px = np.array(data[pos:].split()[:n], dtype=np.int64).astype(np.uint8)
    return px.reshape(h, w, 3)
