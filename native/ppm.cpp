// Native ASCII P3 PPM encoder, byte-compatible with both
// simd_raytracer/utils/ppm.py and the reference writer's format
// (reference: include/raytracer/io/image/ppm.hpp:7-25 behavior):
// header "P3\nW H\n255\n", then one image row per line with "R G B\t" per
// pixel and channel = uint8(255.999f * clamp(c, 0, 1)) (truncating cast).

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

inline uint8_t to_u8(float c) {
    if (c < 0.0f) c = 0.0f;
    if (c > 1.0f) c = 1.0f;
    return static_cast<uint8_t>(255.999f * c);
}

// Writes the decimal digits of v (0..255) into p, returns chars written.
inline int put_u8(uint8_t v, char* p) {
    if (v >= 100) {
        p[0] = '0' + v / 100;
        p[1] = '0' + (v / 10) % 10;
        p[2] = '0' + v % 10;
        return 3;
    }
    if (v >= 10) {
        p[0] = '0' + v / 10;
        p[1] = '0' + v % 10;
        return 2;
    }
    p[0] = '0' + v;
    return 1;
}

}  // namespace

extern "C" {

// img: (h, w, 3) float32 row-major.  out: byte buffer of size out_cap.
// Returns bytes written, or -1 if out_cap is too small.
int64_t srt_ppm_encode(const float* img, int32_t h, int32_t w,
                       uint8_t* out, int64_t out_cap) {
    char* p = reinterpret_cast<char*>(out);
    char* const end = p + out_cap;

    int header = std::snprintf(p, static_cast<size_t>(end - p),
                               "P3\n%d %d\n255\n", w, h);
    if (header < 0 || p + header >= end) return -1;
    p += header;

    const float* px = img;
    for (int32_t y = 0; y < h; ++y) {
        // Worst case per pixel: 3*3 digits + 2 spaces + tab = 12 chars.
        if (p + static_cast<int64_t>(w) * 12 + 1 > end) return -1;
        for (int32_t x = 0; x < w; ++x, px += 3) {
            p += put_u8(to_u8(px[0]), p);
            *p++ = ' ';
            p += put_u8(to_u8(px[1]), p);
            *p++ = ' ';
            p += put_u8(to_u8(px[2]), p);
            *p++ = '\t';
        }
        *p++ = '\n';
    }
    return p - reinterpret_cast<char*>(out);
}

}  // extern "C"
