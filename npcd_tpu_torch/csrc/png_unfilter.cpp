// PNG row filters undone on the host (PNG specification, section 9).
//
// The port's PNG reader (npcd_tpu_torch/data/png.py) inflates a file's
// IDAT stream with zlib and hands the scanlines here: each row is one filter
// byte (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) then `stride` bytes, and
// each byte is predicted from the reconstructed byte `bpp` to its left (a),
// the one above (b) and the one above that (c). Average and Paeth rows are
// sequential along the row, which is why this is C++ and not numpy. A plain
// C interface, loaded with ctypes (which releases the GIL during the call,
// so the loader's threads decode in parallel).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

inline uint8_t paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    if (pb <= pc) return static_cast<uint8_t>(b);
    return static_cast<uint8_t>(c);
}

}  // namespace

// raw: height rows of (1 + stride) bytes; out: height rows of stride bytes.
// Returns 0, or 1 + the index of the first row whose filter byte is not 0-4.
extern "C" int64_t png_unfilter(const uint8_t* raw, uint8_t* out, int64_t height,
                                int64_t stride, int64_t bpp) {
    std::vector<uint8_t> zero(static_cast<size_t>(stride), 0);
    for (int64_t r = 0; r < height; ++r) {
        const uint8_t filter = raw[r * (stride + 1)];
        const uint8_t* x = raw + r * (stride + 1) + 1;
        uint8_t* cur = out + r * stride;
        const uint8_t* up = r ? out + (r - 1) * stride : zero.data();
        switch (filter) {
            case 0:
                std::memcpy(cur, x, static_cast<size_t>(stride));
                break;
            case 1:
                for (int64_t i = 0; i < stride; ++i)
                    cur[i] = static_cast<uint8_t>(x[i] + (i >= bpp ? cur[i - bpp] : 0));
                break;
            case 2:
                for (int64_t i = 0; i < stride; ++i)
                    cur[i] = static_cast<uint8_t>(x[i] + up[i]);
                break;
            case 3:
                for (int64_t i = 0; i < stride; ++i) {
                    const int a = i >= bpp ? cur[i - bpp] : 0;
                    cur[i] = static_cast<uint8_t>(x[i] + ((a + up[i]) >> 1));
                }
                break;
            case 4:
                for (int64_t i = 0; i < stride; ++i) {
                    const int a = i >= bpp ? cur[i - bpp] : 0;
                    const int c = i >= bpp ? up[i - bpp] : 0;
                    cur[i] = static_cast<uint8_t>(x[i] + paeth(a, up[i], c));
                }
                break;
            default:
                return r + 1;
        }
    }
    return 0;
}
