// VP8L lossless decoder written from RFC 9649, for the lossless WebP decode
// of dali_tpu_torch: the predictor (modes 0-13; 14 and 15 predict black, as
// in libwebp), cross-colour, subtract-green and colour-indexing transforms
// (pixel bundling at 2, 4 and 16 colours or fewer), undone in the reverse of
// their reading order; simple and normal prefix codes, five per group; the
// entropy (meta-prefix) image; the colour cache; LZ77 lengths and distances
// through the 120-entry distance map. A stream fails where libwebp fails it:
// a prefix code that is neither complete nor a single symbol, a transform
// read twice, a copy before the first pixel or past the last, or a read past
// the end of the data (libwebp's end-of-stream rule: past 8 * max(len, 8)
// bits).

#include <cstring>

#include "webp.h"
#include "webp_tables.h"

namespace dali_webp {
namespace {

constexpr uint8_t kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2,  3,  4,  5,  16, 6,
                                              7,  8,  9, 10, 11, 12, 13, 14, 15};
constexpr int kAlphabetSize[5] = {256 + 24, 256, 256, 256, 40};

struct Fail {};

class BitReader {
 public:
  BitReader(const uint8_t* d, size_t n) : d_(d), n_(n) {
    limit_ = 8 * static_cast<unsigned long long>(n < 8 ? 8 : n);
  }
  uint32_t read(int bits) {
    if (bits == 0) return 0;
    fill();
    const uint32_t v = static_cast<uint32_t>(val_ & ((1ull << bits) - 1));
    skip(bits);
    return v;
  }
  uint32_t peek(int bits) {
    fill();
    return static_cast<uint32_t>(val_ & ((1ull << bits) - 1));
  }
  void skip(int bits) {
    val_ >>= bits;
    nbits_ -= bits;
    used_ += bits;
    if (used_ > limit_ && !tolerate_end_) throw Fail();
  }
  // libwebp's 8-bit alpha decode tests the end only after each symbol and
  // accepts a read past it by the symbol that reaches the last pixel
  void tolerate_end() { tolerate_end_ = true; }
  bool past_end() const { return used_ > limit_; }

 private:
  void fill() {
    while (nbits_ <= 56) {
      val_ |= static_cast<uint64_t>(pos_ < n_ ? d_[pos_] : 0) << nbits_;
      ++pos_;
      nbits_ += 8;
    }
  }
  const uint8_t* d_;
  size_t n_, pos_ = 0;
  uint64_t val_ = 0;
  int nbits_ = 0;
  unsigned long long used_ = 0, limit_;
  bool tolerate_end_ = false;
};

inline uint32_t reverse_bits(uint32_t v, int n) {
  uint32_t r = 0;
  for (int i = 0; i < n; ++i) r |= ((v >> i) & 1) << (n - 1 - i);
  return r;
}

// A canonical prefix code: an 8-bit lookup of the stream's next bits (the
// first bit read is the code's most significant) and, for longer codes, a
// walk by length.
class PrefixCode {
 public:
  // false for a code libwebp rejects: no symbol, or neither complete nor a
  // single symbol
  bool build(const int* lengths, int n) {
    int count[16] = {0};
    int used = 0;
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > 15) return false;
      if (lengths[s]) {
        ++count[lengths[s]];
        ++used;
      }
    }
    if (used == 0) return false;
    if (used == 1) {
      for (int s = 0; s < n; ++s)
        if (lengths[s]) single_ = s;
      return true;
    }
    int left = 1;
    for (int l = 1; l <= 15; ++l) {
      left = (left << 1) - count[l];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    int offs[16];
    offs[1] = 0;
    for (int l = 1; l < 15; ++l) offs[l + 1] = offs[l] + count[l];
    symbols_.assign(used, 0);
    for (int s = 0; s < n; ++s)
      if (lengths[s]) symbols_[offs[lengths[s]]++] = static_cast<uint16_t>(s);
    std::memcpy(count_, count, sizeof(count));
    std::memset(fast_len_, 0, sizeof(fast_len_));
    int code = 0, k = 0;
    for (int l = 1; l <= 15; ++l) {
      for (int i = 0; i < count[l]; ++i, ++code, ++k) {
        if (l > 8) continue;
        const uint32_t rev = reverse_bits(code, l);
        for (uint32_t e = rev; e < 256; e += 1u << l) {
          fast_len_[e] = static_cast<uint8_t>(l);
          fast_sym_[e] = symbols_[k];
        }
      }
      code <<= 1;
    }
    return true;
  }
  int read(BitReader& br) const {
    if (single_ >= 0) return single_;
    const uint32_t bits = br.peek(16);
    const int l8 = fast_len_[bits & 255];
    if (l8) {
      br.skip(l8);
      return fast_sym_[bits & 255];
    }
    int code = 0, first = 0, index = 0;
    for (int l = 1; l <= 15; ++l) {
      code |= (bits >> (l - 1)) & 1;
      const int c = count_[l];
      if (code - c < first) {
        br.skip(l);
        return symbols_[index + (code - first)];
      }
      index += c;
      first = (first + c) << 1;
      code <<= 1;
    }
    throw Fail();
  }
  bool single() const { return single_ >= 0; }

 private:
  int single_ = -1;
  int count_[16] = {0};
  std::vector<uint16_t> symbols_;
  uint8_t fast_len_[256];
  uint16_t fast_sym_[256];
};

struct Group {
  PrefixCode codes[5];  // green + lengths + cache, red, blue, alpha, distance
};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

void read_code_lengths(BitReader& br, const int* cl_lengths, int n, int* lengths) {
  PrefixCode cl;
  if (!cl.build(cl_lengths, 19)) throw Fail();
  int max_symbol = n;
  if (br.read(1)) {
    const int nbits = 2 + 2 * static_cast<int>(br.read(3));
    max_symbol = 2 + static_cast<int>(br.read(nbits));
    if (max_symbol > n) throw Fail();
  }
  int prev = 8;
  int s = 0;
  while (s < n) {
    if (max_symbol-- == 0) break;
    const int len = cl.read(br);
    if (len < 16) {
      lengths[s++] = len;
      if (len) prev = len;
    } else {
      static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
      const int slot = len - 16;
      int repeat = static_cast<int>(br.read(kExtra[slot])) + kOffset[slot];
      if (s + repeat > n) throw Fail();
      const int v = len == 16 ? prev : 0;
      while (repeat-- > 0) lengths[s++] = v;
    }
  }
}

void read_prefix_code(BitReader& br, int n, PrefixCode* code) {
  std::vector<int> lengths(n, 0);
  if (br.read(1)) {  // simple code: one or two symbols
    const int num = static_cast<int>(br.read(1)) + 1;
    const int first_bits = br.read(1) ? 8 : 1;
    const int s0 = static_cast<int>(br.read(first_bits));
    if (s0 < n) lengths[s0] = 1;
    if (num == 2) {
      const int s1 = static_cast<int>(br.read(8));
      if (s1 < n) lengths[s1] = 1;
    }
  } else {
    int cl_lengths[19] = {0};
    const int num = static_cast<int>(br.read(4)) + 4;
    for (int i = 0; i < num; ++i) cl_lengths[kCodeLengthCodeOrder[i]] = static_cast<int>(br.read(3));
    read_code_lengths(br, cl_lengths, n, lengths.data());
  }
  if (!code->build(lengths.data(), n)) throw Fail();
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
         (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline int sub3(int a, int b, int c) {
  const int pb = b - c, pa = a - c;
  return (pb < 0 ? -pb : pb) - (pa < 0 ? -pa : pa);
}
inline uint32_t select(uint32_t a, uint32_t b, uint32_t c) {  // a = T, b = L, c = TL
  const int d = sub3(a >> 24, b >> 24, c >> 24) +
                sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                sub3(a & 0xff, b & 0xff, c & 0xff);
  return d <= 0 ? a : b;
}
inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline uint32_t clamped_add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t r = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = static_cast<int>((c0 >> s) & 0xff) + static_cast<int>((c1 >> s) & 0xff) -
                  static_cast<int>((c2 >> s) & 0xff);
    r |= clip255(static_cast<uint32_t>(v)) << s;
  }
  return r;
}
inline uint32_t clamped_add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t r = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = static_cast<int>((ave >> s) & 0xff), b = static_cast<int>((c2 >> s) & 0xff);
    r |= clip255(static_cast<uint32_t>(a + (a - b) / 2)) << s;
  }
  return r;
}

inline uint32_t predict(int mode, const uint32_t* out, const uint32_t* top) {
  const uint32_t L = out[-1];
  switch (mode) {
    case 1: return L;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(L, top[1]), top[0]);
    case 6: return average2(L, top[-1]);
    case 7: return average2(L, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(L, top[-1]), average2(top[0], top[1]));
    case 11: return select(top[0], L, top[-1]);
    case 12: return clamped_add_sub_full(L, top[0], top[-1]);
    case 13: return clamped_add_sub_half(L, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and 14-15 as libwebp reads them
  }
}

struct Transform {
  int type = 0, bits = 0, xsize = 0;
  std::vector<uint32_t> data;
};

class Decoder {
 public:
  Decoder(const uint8_t* d, size_t n) : br_(d, n) {}
  void decode(int* w, int* h, std::vector<uint32_t>* out);
  void decode_alpha(int w, int h, std::vector<uint8_t>* out);

 private:
  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0);
  void read_transform(int* xsize, int ysize);
  void inverse(const Transform& t, int ysize, std::vector<uint32_t>& px);
  BitReader br_;
  std::vector<Transform> transforms_;
  unsigned seen_ = 0;
  bool alpha_ = false;
};

std::vector<uint32_t> Decoder::decode_stream(int xsize, int ysize, bool level0) {
  int cache_bits = 0;
  if (br_.read(1)) {
    cache_bits = static_cast<int>(br_.read(4));
    if (cache_bits < 1 || cache_bits > 11) throw Fail();
  }
  int meta_bits = 0, meta_w = 0;
  std::vector<uint32_t> meta;
  int num_groups = 1;
  if (level0 && br_.read(1)) {
    meta_bits = static_cast<int>(br_.read(3)) + 2;
    meta_w = subsample(xsize, meta_bits);
    meta = decode_stream(meta_w, subsample(ysize, meta_bits), false);
    for (uint32_t& m : meta) {
      m = (m >> 8) & 0xffff;
      if (static_cast<int>(m) >= num_groups) num_groups = static_cast<int>(m) + 1;
    }
  }
  std::vector<Group> groups(num_groups);
  for (Group& g : groups)
    for (int j = 0; j < 5; ++j)
      read_prefix_code(br_, kAlphabetSize[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0),
                       &g.codes[j]);
  // libwebp decodes an alpha plane of palette indices with no colour cache
  // and single-symbol red, blue and alpha codes one byte a pixel
  bool alpha_8b = level0 && alpha_ && cache_bits == 0 && transforms_.size() == 1 &&
                  transforms_[0].type == 3;
  for (const Group& g : groups)
    alpha_8b = alpha_8b && g.codes[1].single() && g.codes[2].single() && g.codes[3].single();
  if (alpha_8b) br_.tolerate_end();
  const size_t total = static_cast<size_t>(xsize) * ysize;
  std::vector<uint32_t> px(total);
  std::vector<uint32_t> cache(cache_bits ? 1u << cache_bits : 0u);
  const int cache_shift = 32 - cache_bits;
  size_t pos = 0, cached = 0;
  int col = 0, row = 0;
  auto insert_cached = [&]() {
    if (cache_bits)
      for (; cached < pos; ++cached) cache[(px[cached] * 0x1e35a7bdu) >> cache_shift] = px[cached];
  };
  while (pos < total) {
    const Group& g =
        groups[meta.empty() ? 0 : meta[(row >> meta_bits) * meta_w + (col >> meta_bits)]];
    const int code = g.codes[0].read(br_);
    if (code < 256) {
      const uint32_t red = g.codes[1].read(br_);
      const uint32_t blue = g.codes[2].read(br_);
      const uint32_t alpha = g.codes[3].read(br_);
      px[pos++] = (alpha << 24) | (red << 16) | (static_cast<uint32_t>(code) << 8) | blue;
      if (++col >= xsize) {
        col = 0;
        ++row;
      }
    } else if (code < 256 + 24) {
      auto prefix_value = [&](int sym) {
        if (sym < 4) return sym + 1;
        const int extra = (sym - 2) >> 1;
        const int offset = (2 + (sym & 1)) << extra;
        return offset + static_cast<int>(br_.read(extra)) + 1;
      };
      const int length = prefix_value(code - 256);
      const int dist_code = prefix_value(g.codes[4].read(br_));
      long dist;
      if (dist_code > 120) {
        dist = dist_code - 120;
      } else {
        const int dc = kCodeToPlane[dist_code - 1];
        dist = static_cast<long>(dc >> 4) * xsize + (8 - (dc & 0xf));
        if (dist < 1) dist = 1;
      }
      if (static_cast<long>(pos) < dist || total - pos < static_cast<size_t>(length)) throw Fail();
      for (int i = 0; i < length; ++i, ++pos) px[pos] = px[pos - dist];
      col += length;
      while (col >= xsize) {
        col -= xsize;
        ++row;
      }
    } else {
      const int key = code - 256 - 24;
      if (!cache_bits || key >= (1 << cache_bits)) throw Fail();
      insert_cached();
      px[pos++] = cache[key];
      if (++col >= xsize) {
        col = 0;
        ++row;
      }
    }
    insert_cached();
    if (alpha_8b && br_.past_end() && pos < total) throw Fail();
  }
  return px;
}

void Decoder::read_transform(int* xsize, int ysize) {
  Transform t;
  t.type = static_cast<int>(br_.read(2));
  if (seen_ & (1u << t.type)) throw Fail();
  seen_ |= 1u << t.type;
  t.xsize = *xsize;
  switch (t.type) {
    case 0:  // predictor
    case 1:  // cross colour
      t.bits = static_cast<int>(br_.read(3)) + 2;
      t.data = decode_stream(subsample(t.xsize, t.bits), subsample(ysize, t.bits), false);
      break;
    case 3: {  // colour indexing
      const int num_colors = static_cast<int>(br_.read(8)) + 1;
      t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      *xsize = subsample(t.xsize, t.bits);
      std::vector<uint32_t> pal = decode_stream(num_colors, 1, false);
      t.data.assign(static_cast<size_t>(1) << (8 >> t.bits), 0);
      for (int i = 0; i < num_colors; ++i)
        t.data[i] = i ? add_pixels(pal[i], t.data[i - 1]) : pal[0];
      break;
    }
    default:  // subtract green
      break;
  }
  transforms_.push_back(std::move(t));
}

void Decoder::inverse(const Transform& t, int ysize, std::vector<uint32_t>& px) {
  const int w = t.xsize;
  if (t.type == 2) {
    for (uint32_t& p : px) {
      const uint32_t g = (p >> 8) & 0xff;
      const uint32_t rb = ((p & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
      p = (p & 0xff00ff00u) | rb;
    }
    return;
  }
  if (t.type == 3) {
    const int in_w = subsample(w, t.bits);
    std::vector<uint32_t> out(static_cast<size_t>(w) * ysize);
    const int bpp = 8 >> t.bits, count_mask = (1 << t.bits) - 1, bit_mask = (1 << bpp) - 1;
    for (int y = 0; y < ysize; ++y) {
      const uint32_t* src = &px[static_cast<size_t>(y) * in_w];
      uint32_t* dst = &out[static_cast<size_t>(y) * w];
      uint32_t packed = 0;
      for (int x = 0; x < w; ++x) {
        if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
        dst[x] = t.data[packed & bit_mask];
        packed >>= bpp;
      }
    }
    px.swap(out);
    return;
  }
  const int tiles = subsample(w, t.bits);
  if (t.type == 0) {
    for (int y = 0; y < ysize; ++y) {
      uint32_t* out = &px[static_cast<size_t>(y) * w];
      if (y == 0) {
        out[0] = add_pixels(out[0], 0xff000000u);
        for (int x = 1; x < w; ++x) out[x] = add_pixels(out[x], out[x - 1]);
        continue;
      }
      const uint32_t* top = out - w;
      const uint32_t* modes = &t.data[static_cast<size_t>(y >> t.bits) * tiles];
      out[0] = add_pixels(out[0], top[0]);
      for (int x = 1; x < w; ++x) {
        const int mode = (modes[x >> t.bits] >> 8) & 0xf;
        out[x] = add_pixels(out[x], predict(mode, out + x, top + x));
      }
    }
    return;
  }
  for (int y = 0; y < ysize; ++y) {  // cross colour
    uint32_t* row = &px[static_cast<size_t>(y) * w];
    const uint32_t* codes = &t.data[static_cast<size_t>(y >> t.bits) * tiles];
    for (int x = 0; x < w; ++x) {
      const uint32_t cc = codes[x >> t.bits];
      const int g2r = static_cast<int8_t>(cc & 0xff);
      const int g2b = static_cast<int8_t>((cc >> 8) & 0xff);
      const int r2b = static_cast<int8_t>((cc >> 16) & 0xff);
      const uint32_t argb = row[x];
      const int green = static_cast<int8_t>((argb >> 8) & 0xff);
      int red = (argb >> 16) & 0xff;
      int blue = argb & 0xff;
      red = (red + ((g2r * green) >> 5)) & 0xff;
      blue += (g2b * green) >> 5;
      blue += (r2b * static_cast<int8_t>(red)) >> 5;
      blue &= 0xff;
      row[x] = (argb & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) | static_cast<uint32_t>(blue);
    }
  }
}

void Decoder::decode(int* w, int* h, std::vector<uint32_t>* out) {
  if (br_.read(8) != 0x2f) throw Fail();
  const int xsize = static_cast<int>(br_.read(14)) + 1;
  const int ysize = static_cast<int>(br_.read(14)) + 1;
  br_.read(1);  // alpha_is_used: a hint only
  if (br_.read(3) != 0) throw Fail();
  int tx = xsize;
  while (br_.read(1)) read_transform(&tx, ysize);
  std::vector<uint32_t> px = decode_stream(tx, ysize, true);
  for (size_t i = transforms_.size(); i-- > 0;) inverse(transforms_[i], ysize, px);
  *w = xsize;
  *h = ysize;
  out->swap(px);
}

// An ALPH chunk's lossless stream: no header, the frame's size, the alpha
// value in the green channel.
void Decoder::decode_alpha(int w, int h, std::vector<uint8_t>* out) {
  alpha_ = true;
  int tx = w;
  while (br_.read(1)) read_transform(&tx, h);
  std::vector<uint32_t> px = decode_stream(tx, h, true);
  for (size_t i = transforms_.size(); i-- > 0;) inverse(transforms_[i], h, px);
  out->resize(px.size());
  for (size_t i = 0; i < px.size(); ++i) (*out)[i] = static_cast<uint8_t>(px[i] >> 8);
}

}  // namespace

bool vp8l_size(const uint8_t* data, size_t len, int* w, int* h) {
  if (len < 5 || data[0] != 0x2f || (data[4] >> 5) != 0) return false;
  const uint32_t bits = data[1] | (data[2] << 8) | (data[3] << 16) | (static_cast<uint32_t>(data[4]) << 24);
  *w = static_cast<int>(bits & 0x3fff) + 1;
  *h = static_cast<int>((bits >> 14) & 0x3fff) + 1;
  return true;
}

int vp8l_decode(const uint8_t* data, size_t len, int* w, int* h, std::vector<uint32_t>* argb) {
  try {
    Decoder dec(data, len);
    dec.decode(w, h, argb);
    return 0;
  } catch (const Fail&) {
    return -1;
  } catch (const std::bad_alloc&) {
    return -1;
  }
}

int vp8l_decode_alpha(const uint8_t* data, size_t len, int w, int h, std::vector<uint8_t>* alpha) {
  try {
    Decoder dec(data, len);
    dec.decode_alpha(w, h, alpha);
    return 0;
  } catch (const Fail&) {
    return -1;
  } catch (const std::bad_alloc&) {
    return -1;
  }
}

}  // namespace dali_webp
