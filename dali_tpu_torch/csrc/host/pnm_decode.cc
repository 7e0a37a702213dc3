// PNM (PBM, PGM, PPM) decoder written from the Netpbm format descriptions,
// for the host image decode of dali_tpu_torch. It gives what cv2.imdecode
// (OpenCV 5.0) gives dali_tpu for P1-P6:
//
// * the header's numbers after whitespace and '#' comments (a comment runs
//   to '\n' or '\r'); one byte after the last number ends the header;
// * maxval up to 65535: 8-bit below 256, 16-bit (big-endian when binary)
//   above; binary samples come out unscaled and unclipped, ASCII samples are
//   clipped to maxval and, at 8 bits, scaled by 255 / maxval (integer
//   division), as OpenCV's reader does;
// * bitmaps (P1, P4): 1 is black, 0 white;
// * a read past the end of the data fails, as does a number that does not
//   start with a digit.
//
// Output: RGB [h, w, 3] or grey [h, w, 1], uint8 or uint16; grey from RGB
// by OpenCV's 14-bit weights (4899 R + 9617 G + 1868 B + 8192) >> 14.

#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

struct Fail {};

class Stream {
 public:
  Stream(const uint8_t* d, size_t n) : d_(d), n_(n) {}
  int byte() {
    if (pos_ >= n_) throw Fail();
    return d_[pos_++];
  }
  const uint8_t* take(size_t k) {
    if (k > n_ - pos_) throw Fail();
    const uint8_t* p = d_ + pos_;
    pos_ += k;
    return p;
  }
  // OpenCV's ReadNumber: ``maxdigits`` 0 reads to the first non-digit,
  // which it consumes
  int number(int maxdigits = 0) {
    int code = byte();
    while (!(code >= '0' && code <= '9')) {
      if (code == '#') {
        do code = byte();
        while (code != '\n' && code != '\r');
        code = byte();
      } else if (code == ' ' || (code >= '\t' && code <= '\r')) {
        while (code == ' ' || (code >= '\t' && code <= '\r')) code = byte();
      } else {
        throw Fail();
      }
    }
    long long val = 0;
    int digits = 0;
    do {
      val = val * 10 + (code - '0');
      if (val > 0x7fffffff) throw Fail();
      if (maxdigits != 0 && ++digits >= maxdigits) break;
      code = byte();
    } while (code >= '0' && code <= '9');
    return static_cast<int>(val);
  }

 private:
  const uint8_t* d_;
  size_t n_, pos_ = 0;
};

struct Header {
  int kind = 0, w = 0, h = 0, maxval = 1;
};

Header read_header(Stream& s) {
  Header hd;
  if (s.byte() != 'P') throw Fail();
  const int k = s.byte();
  if (k < '1' || k > '6') throw Fail();
  hd.kind = k - '0';
  hd.w = s.number();
  hd.h = s.number();
  if (hd.kind != 1 && hd.kind != 4) hd.maxval = s.number();
  if (hd.maxval > 65535 || hd.w <= 0 || hd.h <= 0 || hd.maxval <= 0) throw Fail();
  return hd;
}

inline int gray14(int r, int g, int b) { return (b * 1868 + g * 9617 + r * 4899 + (1 << 13)) >> 14; }

template <typename T>
void put(T* dst, size_t i, int gray, int r, int g, int b) {
  if (gray) {
    dst[i] = static_cast<T>(gray14(r, g, b));
  } else {
    dst[3 * i] = static_cast<T>(r);
    dst[3 * i + 1] = static_cast<T>(g);
    dst[3 * i + 2] = static_cast<T>(b);
  }
}

template <typename T>
void decode_samples(Stream& s, const Header& hd, int gray, T* dst) {
  const int nch = hd.kind == 3 || hd.kind == 6 ? 3 : 1;
  const bool ascii = hd.kind <= 3;
  const bool wide = sizeof(T) == 2;
  const size_t row = static_cast<size_t>(hd.w) * nch;
  std::vector<int> v(row);
  for (int y = 0; y < hd.h; ++y) {
    if (ascii) {
      for (size_t x = 0; x < row; ++x) {
        int code = s.number();
        if (code > hd.maxval) code = hd.maxval;
        v[x] = wide ? code : code * 255 / hd.maxval;
      }
    } else {
      const uint8_t* p = s.take(row * (wide ? 2 : 1));
      for (size_t x = 0; x < row; ++x) v[x] = wide ? (p[2 * x] << 8) | p[2 * x + 1] : p[x];
    }
    const size_t base = static_cast<size_t>(y) * hd.w;
    for (int x = 0; x < hd.w; ++x) {
      if (nch == 1) {
        if (gray) dst[base + x] = static_cast<T>(v[x]);
        else put(dst, base + x, 0, v[x], v[x], v[x]);
      } else {
        put(dst, base + x, gray, v[3 * x], v[3 * x + 1], v[3 * x + 2]);
      }
    }
  }
}

void decode_bits(Stream& s, const Header& hd, int gray, uint8_t* dst) {
  const size_t pitch = (static_cast<size_t>(hd.w) + 7) / 8;
  for (int y = 0; y < hd.h; ++y) {
    const size_t base = static_cast<size_t>(y) * hd.w;
    const uint8_t* p = hd.kind == 4 ? s.take(pitch) : nullptr;
    for (int x = 0; x < hd.w; ++x) {
      const int bit = p ? (p[x >> 3] >> (7 - (x & 7))) & 1 : s.number(1) != 0;
      const uint8_t v = bit ? 0 : 255;
      if (gray) dst[base + x] = v;
      else std::memset(dst + 3 * (base + x), v, 3);
    }
  }
}

}  // namespace

namespace dali_pnm {

// Size and output depth (0 uint8, 1 uint16); -1 for a header cv2 rejects.
int info(const uint8_t* data, size_t len, int* h, int* w, int* depth) {
  try {
    Stream s(data, len);
    const Header hd = read_header(s);
    *h = hd.h;
    *w = hd.w;
    *depth = hd.maxval > 255 ? 1 : 0;
    return 0;
  } catch (const Fail&) {
    return -1;
  }
}

int decode(const uint8_t* data, size_t len, int gray, void* dst) {
  try {
    Stream s(data, len);
    const Header hd = read_header(s);
    if (hd.kind == 1 || hd.kind == 4) decode_bits(s, hd, gray, static_cast<uint8_t*>(dst));
    else if (hd.maxval > 255) decode_samples(s, hd, gray, static_cast<uint16_t*>(dst));
    else decode_samples(s, hd, gray, static_cast<uint8_t*>(dst));
    return 0;
  } catch (const Fail&) {
    return -1;
  } catch (const std::bad_alloc&) {
    return -1;
  }
}

}  // namespace dali_pnm
