// OpenEXR's PIZ decoder for one chunk, and its Huffman decoder alone (DWAA and
// DWAB code their AC words with it): host code for pipeline/exr.py, built
// with g++ at first use by core/native.py. pipeline/exr.py holds the same
// decoder in numpy (`piz_words_numpy`), and the tests hold the two against
// each other bit for bit.
//
// A PIZ chunk (OpenEXR's ImfPizCompressor, ImfHuf and ImfWav) holds the
// chunk's 16-bit words, channel after channel (a FLOAT or UINT pixel is two
// words, low then high), each channel's rows in turn:
//   - the bitmap of the word values present: u16 first and last nonzero
//     byte of its 8192, then those bytes (value 0 is always present);
//   - an i32 byte count, then the Huffman stream of the words, each first
//     mapped to its rank among the present values and run through the 2D
//     Haar wavelet (one transform a channel, a 32-bit channel's two words
//     as two planes).
// The Huffman stream: u32 im and iM (the first and last symbol with a
// code; iM is the run symbol, which repeats the last word 8 bits' worth of
// times), the table's byte count, the data's bit count and a zero; the code
// lengths of symbols im..iM in 6 bits each (59-62: a run of 2-5 zero
// lengths, 63 then 8 bits: a run of 6-261); then the codes, MSB first.
// Codes are canonical from the lengths: longer codes take the lower values.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kUshortRange = 1 << 16;
constexpr int kBitmapSize = kUshortRange >> 3;
constexpr int kEncSize = kUshortRange + 1;  // every 16-bit value and the run symbol
constexpr int kMaxLen = 58;
constexpr int kShortZeroRun = 59, kLongZeroRun = 63, kShortestLongRun = 6;

enum Status : int64_t { kOk = 0, kTruncated = -1, kBitmap = -2, kTable = -3, kCode = -4, kCount = -5 };

uint32_t le32(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24); }

// MSB-first bits of bytes [p, end), fetched a byte at a time as needed.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t c = 0;
  int lc = 0;
  bool get(int n, uint32_t* v) {  // n <= 8
    while (lc < n) {
      if (p >= end) return false;
      c = (c << 8) | *p++;
      lc += 8;
    }
    lc -= n;
    *v = uint32_t(c >> lc) & ((1u << n) - 1);
    return true;
  }
};

int64_t huf_decode(const uint8_t* in, int64_t n_in, uint16_t* out, int64_t n_out) {
  if (n_in == 0) return n_out == 0 ? kOk : kCount;
  if (n_in < 20) return kTruncated;
  const uint32_t im = le32(in), iM = le32(in + 4), n_bits = le32(in + 12);
  if (im >= uint32_t(kEncSize) || iM >= uint32_t(kEncSize) || im > iM) return kTable;
  // code lengths of im..iM
  std::vector<uint8_t> len(kEncSize, 0);
  BitReader table{in + 20, in + n_in};
  for (uint32_t s = im; s <= iM; ++s) {
    uint32_t l;
    if (!table.get(6, &l)) return kTruncated;
    if (l >= uint32_t(kShortZeroRun)) {  // a run of zero lengths
      uint32_t run = l - kShortZeroRun + 2;
      if (l == uint32_t(kLongZeroRun)) {
        if (!table.get(8, &run)) return kTruncated;
        run += kShortestLongRun;
      }
      if (s + run > iM + 1) return kTable;
      s += run - 1;  // lengths stay 0
    } else {
      len[s] = uint8_t(l);
    }
  }
  const uint8_t* data = table.p;
  if (uint64_t(n_bits) > 8 * uint64_t(in + n_in - data)) return kTruncated;
  // canonical codes: first[l] is the lowest code of length l, and the
  // symbols of one length take consecutive codes in increasing order
  uint64_t count[kMaxLen + 2] = {0}, first[kMaxLen + 2] = {0};
  for (uint32_t s = im; s <= iM; ++s) count[len[s]] += 1;
  uint64_t c = 0;
  for (int l = kMaxLen; l > 0; --l) {
    const uint64_t next = (c + count[l]) >> 1;
    first[l] = c;
    c = next;
  }
  uint64_t offset[kMaxLen + 2] = {0};
  for (int l = 1, at = 0; l <= kMaxLen; ++l) {
    offset[l] = at;
    at += count[l];
  }
  std::vector<uint32_t> by_code(iM - im + 1);
  {
    uint64_t fill[kMaxLen + 2];
    std::memcpy(fill, offset, sizeof(fill));
    for (uint32_t s = im; s <= iM; ++s)
      if (len[s]) by_code[fill[len[s]]++] = s;
  }
  int64_t n = 0, pos = 0;
  while (pos < int64_t(n_bits)) {
    uint64_t v = 0;
    int l = 0;
    uint32_t sym = 0;
    for (;;) {
      if (pos >= int64_t(n_bits) || l == kMaxLen) return kCode;
      v = (v << 1) | ((data[pos >> 3] >> (7 - (pos & 7))) & 1);
      ++pos;
      ++l;
      if (count[l] && v >= first[l] && v - first[l] < count[l]) {
        sym = by_code[offset[l] + (v - first[l])];
        break;
      }
    }
    if (sym == iM) {  // the run symbol: the last word again, 8 bits' worth of times
      if (pos + 8 > int64_t(n_bits)) return kCode;
      uint32_t run = 0;
      for (int i = 0; i < 8; ++i, ++pos) run = (run << 1) | ((data[pos >> 3] >> (7 - (pos & 7))) & 1);
      if (n == 0 || n + run > n_out) return kCount;
      for (uint32_t i = 0; i < run; ++i, ++n) out[n] = out[n - 1];
    } else {
      if (n >= n_out) return kCount;
      out[n++] = uint16_t(sym);
    }
  }
  return n == n_out ? kOk : kCount;
}

inline void wdec14(uint16_t l, uint16_t h, uint16_t* a, uint16_t* b) {
  const int ls = int16_t(l), hi = int16_t(h);
  const int ai = ls + (hi & 1) + (hi >> 1);
  *a = uint16_t(ai);
  *b = uint16_t(ai - hi);
}

inline void wdec16(uint16_t l, uint16_t h, uint16_t* a, uint16_t* b) {
  const int m = l, d = h;
  const int bb = (m - (d >> 1)) & 0xFFFF;
  *b = uint16_t(bb);
  *a = uint16_t((d + bb - 0x8000) & 0xFFFF);
}

// The inverse of the 2D wavelet over nx x ny words at `in`, ox apart in a
// row and oy apart between rows; mx is the largest word (below 2^14 the
// transform is the plain Haar step, above it the modular one).
void wav2_decode(uint16_t* in, int nx, int ox, int ny, int oy, uint16_t mx) {
  const bool w14 = mx < (1 << 14);
  const auto dec = w14 ? wdec14 : wdec16;
  const int n = nx > ny ? ny : nx;
  int p = 1;
  while (p <= n) p <<= 1;
  p >>= 1;
  int p2 = p;
  p >>= 1;
  while (p >= 1) {
    uint16_t* py = in;
    uint16_t* const ey = in + int64_t(oy) * (ny - p2);
    const int oy1 = oy * p, oy2 = oy * p2, ox1 = ox * p, ox2 = ox * p2;
    uint16_t i00, i01, i10, i11;
    for (; py <= ey; py += oy2) {
      uint16_t* px = py;
      uint16_t* const ex = py + int64_t(ox) * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        uint16_t* p10 = px + oy1;
        uint16_t* p11 = p10 + ox1;
        dec(*px, *p10, &i00, &i10);
        dec(*p01, *p11, &i01, &i11);
        dec(i00, i01, px, p01);
        dec(i10, i11, p10, p11);
      }
      if (nx & p) {  // the odd column
        uint16_t* p10 = px + oy1;
        dec(*px, *p10, &i00, p10);
        *px = i00;
      }
    }
    if (ny & p) {  // the odd row
      uint16_t* px = py;
      uint16_t* const ex = py + int64_t(ox) * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        dec(*px, *p01, &i00, p01);
        *px = i00;
      }
    }
    p2 = p;
    p >>= 1;
  }
}

}  // namespace

extern "C" {

// Decode one PIZ chunk of n_in bytes at `in` into out: n_out words, channel
// after channel, each ny rows of nx pixels of sizes[c] words (1 for HALF, 2
// for FLOAT and UINT). Returns 0, or a negative Status.
int64_t piz_decode(const uint8_t* in, int64_t n_in, int32_t nx, int32_t ny, const int32_t* sizes, int32_t n_ch,
                   uint16_t* out, int64_t n_out) {
  int64_t want = 0;
  for (int c = 0; c < n_ch; ++c) want += int64_t(nx) * ny * sizes[c];
  if (want != n_out) return kCount;
  if (n_in < 4) return kTruncated;
  const int lo = in[0] | (in[1] << 8), hi = in[2] | (in[3] << 8);
  int64_t at = 4;
  std::vector<uint8_t> bitmap(kBitmapSize, 0);
  if (hi >= kBitmapSize) return kBitmap;
  if (lo <= hi) {
    if (at + (hi - lo + 1) > n_in) return kTruncated;
    std::memcpy(bitmap.data() + lo, in + at, hi - lo + 1);
    at += hi - lo + 1;
  }
  std::vector<uint16_t> lut(kUshortRange, 0);  // rank -> value
  int k = 0;
  for (int v = 0; v < kUshortRange; ++v)
    if (v == 0 || (bitmap[v >> 3] & (1 << (v & 7)))) lut[k++] = uint16_t(v);
  const uint16_t max_value = uint16_t(k - 1);
  if (at + 4 > n_in) return kTruncated;
  const int64_t length = int32_t(le32(in + at));
  at += 4;
  if (length < 0 || at + length > n_in) return kTruncated;
  const int64_t status = huf_decode(in + at, length, out, n_out);
  if (status != kOk) return status;
  uint16_t* start = out;
  for (int c = 0; c < n_ch; ++c) {
    for (int j = 0; j < sizes[c]; ++j) wav2_decode(start + j, nx, sizes[c], ny, nx * sizes[c], max_value);
    start += int64_t(nx) * ny * sizes[c];
  }
  for (int64_t i = 0; i < n_out; ++i) out[i] = lut[out[i]];
  return kOk;
}

// Decode the Huffman stream of n_in bytes at `in` (the coding PIZ chunks
// and the AC words of DWAA and DWAB chunks share) into n_out words.
// Returns 0, or a negative Status.
int64_t huf_words(const uint8_t* in, int64_t n_in, uint16_t* out, int64_t n_out) {
  return huf_decode(in, n_in, out, n_out);
}

}  // extern "C"
