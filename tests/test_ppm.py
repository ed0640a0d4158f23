"""PPM writer tests — byte format per reference io/image/ppm.hpp:7-25."""

import numpy as np

from simd_raytracer.utils.ppm import image_to_u8, ppm_bytes, read_ppm


def test_exact_format():
    img = np.array([[[0.0, 0.5, 1.0], [2.0, -1.0, 0.25]]], np.float32)
    data = ppm_bytes(img).decode()
    # clamp + 255.999 scale + truncating cast:
    # 0 -> 0, 0.5 -> 127, 1.0 -> 255, 2.0 -> 255, -1 -> 0, 0.25 -> 63
    assert data == "P3\n2 1\n255\n0 127 255\t255 0 63\t\n"


def test_u8_cast_truncates():
    vals = np.array([[[0.999, 0.001, 0.5]]], np.float32)
    u8 = image_to_u8(vals)[0, 0]
    assert list(u8) == [255, 0, 127]


def test_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.random((5, 7, 3)).astype(np.float32)
    p = tmp_path / "x.ppm"
    with open(p, "w") as f:
        from simd_raytracer.utils.ppm import write_ppm
        write_ppm(img, f)
    back = read_ppm(str(p))
    assert (back == image_to_u8(img)).all()
