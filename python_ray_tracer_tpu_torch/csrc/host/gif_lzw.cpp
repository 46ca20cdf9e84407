// GIF image data (LZW, minimum code size 8) for python_ray_tracer_tpu_torch's
// GIF writer (utils/image.py), code for code and byte for byte what Pillow's
// GIF encoder writes for the same palette indices:
//
//   * a clear code (256) first; codes start 9 bits wide, first free code 258;
//   * greedy longest-match: on a miss the current string's code goes out, and
//     the string plus the next index becomes the next free code while fewer
//     than 4096 codes exist; a code is one bit wider from the moment the next
//     free code passes 2^width;
//   * when a miss finds the table full (4096 codes), a clear code follows the
//     string's code at 12 bits, and the table starts over;
//   * the last string's code and the end code (257) close the stream;
//   * codes are packed least significant bit first, the last byte padded
//     with zeros, and the bytes cut into sub-blocks of 255 (the last shorter),
//     each after its length byte. The caller writes the minimum code size
//     before and the zero-length terminator after.
//
// Interlaced frames feed the rows in GIF order: every 8th row from row 0,
// every 8th from row 4, every 4th from row 2, every 2nd from row 1.
//
// Built with g++ -O2 -fPIC -shared by utils/native.py; no other library.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kClear = 256;
constexpr int kEnd = 257;
constexpr int kFirstFree = 258;
constexpr int kCodeLimit = 4096;
constexpr uint32_t kSlots = 1u << 14;   // open-addressed (prefix, index) -> code

struct Writer {
  uint8_t* out;
  int64_t cap;
  int64_t pos = 0;          // bytes written, length bytes included
  int64_t block = -1;       // position of the open sub-block's length byte
  int fill = 0;             // data bytes in the open sub-block
  uint32_t bits = 0;
  int nbits = 0;
  bool overflow = false;

  void byte(uint8_t b) {
    if (block < 0 || fill == 255) {
      if (block >= 0 && block < cap) out[block] = 255;
      block = pos++;
      fill = 0;
    }
    if (pos < cap) out[pos] = b; else overflow = true;
    ++pos;
    ++fill;
  }
  void code(int c, int width) {
    bits |= static_cast<uint32_t>(c) << nbits;
    nbits += width;
    while (nbits >= 8) {
      byte(static_cast<uint8_t>(bits));
      bits >>= 8;
      nbits -= 8;
    }
  }
  void finish() {
    if (nbits > 0) byte(static_cast<uint8_t>(bits));
    if (block >= 0) {
      if (block < cap) out[block] = static_cast<uint8_t>(fill); else overflow = true;
    }
  }
};

inline uint32_t slot_of(uint32_t key) { return (key * 2654435761u) >> (32 - 14); }

}  // namespace

extern "C" {

// Encode the (h, w) uint8 palette indices `idx` (rows `stride` bytes apart)
// into `out` (`cap` bytes). Returns the bytes written, or minus the bytes
// needed when `cap` is too small (nothing usable is written then), or 0 for
// bad arguments.
int64_t rt_gif_lzw(const uint8_t* idx, int32_t w, int32_t h, int64_t stride,
                   int32_t interlace, uint8_t* out, int64_t cap) {
  if (!idx || !out || w <= 0 || h <= 0 || stride < w) return 0;
  std::vector<int32_t> rows;
  rows.reserve(h);
  if (interlace) {
    static const int kStart[4] = {0, 4, 2, 1}, kStep[4] = {8, 8, 4, 2};
    for (int p = 0; p < 4; ++p)
      for (int32_t y = kStart[p]; y < h; y += kStep[p]) rows.push_back(y);
  } else {
    for (int32_t y = 0; y < h; ++y) rows.push_back(y);
  }

  std::vector<uint32_t> keys(kSlots), stamp(kSlots, 0);
  std::vector<uint16_t> codes(kSlots);
  uint32_t gen = 1;

  Writer wr{out, cap};
  int width = 9, next = kFirstFree;
  wr.code(kClear, width);
  int prefix = idx[static_cast<int64_t>(rows[0]) * stride];
  bool first = true;
  for (int32_t y : rows) {
    const uint8_t* row = idx + static_cast<int64_t>(y) * stride;
    for (int32_t x = first ? 1 : 0; x < w; ++x) {
      const int c = row[x];
      const uint32_t key = (static_cast<uint32_t>(prefix) << 8) | static_cast<uint32_t>(c);
      uint32_t s = slot_of(key);
      while (stamp[s] == gen && keys[s] != key) s = (s + 1) & (kSlots - 1);
      if (stamp[s] == gen) {
        prefix = codes[s];
        continue;
      }
      wr.code(prefix, width);
      if (next < kCodeLimit) {
        stamp[s] = gen;
        keys[s] = key;
        codes[s] = static_cast<uint16_t>(next++);
        if (next > (1 << width)) ++width;
      } else {
        wr.code(kClear, width);
        ++gen;
        next = kFirstFree;
        width = 9;
      }
      prefix = c;
    }
    first = false;
  }
  wr.code(prefix, width);
  wr.code(kEnd, width);
  wr.finish();
  return wr.overflow ? -wr.pos : wr.pos;
}

}  // extern "C"
