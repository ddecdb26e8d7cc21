// Undo the five PNG row filters (PNG specification, section 9): the inner
// loop of pipeline/png.py's reader, host code built with g++ by core/native.py.
// Average and Paeth rows need each byte's reconstructed left neighbour, a
// sequential chain that Python would walk byte by byte.
#include <cstdint>
#include <cstdlib>

namespace {

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

}  // namespace

extern "C" {

// raw: h scanlines, each a filter-type byte and `stride` filtered bytes;
// out: h * stride bytes; bpp: bytes a pixel (the left neighbour's distance).
// Returns 0, or 1 + the index of the first row whose filter type is unknown.
int64_t png_unfilter(const uint8_t* raw, int64_t h, int64_t stride, int64_t bpp, uint8_t* out) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* f = raw + y * (stride + 1) + 1;
    const int type = f[-1];
    if (type > 4) return y + 1;
    uint8_t* row = out + y * stride;
    const uint8_t* up = y > 0 ? out + (y - 1) * stride : nullptr;
    for (int64_t x = 0; x < stride; ++x) {
      const int a = x >= bpp ? row[x - bpp] : 0;
      const int b = up ? up[x] : 0;
      const int c = up && x >= bpp ? up[x - bpp] : 0;
      int pred = 0;
      switch (type) {
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
        default: break;
      }
      row[x] = static_cast<uint8_t>(f[x] + pred);
    }
  }
  return 0;
}

}  // extern "C"
