// HuffYUV frames as FFmpeg 5.1's huffyuvdec.c decodes them, at 8 bits:
// HuffYUV (``HFYU``) and FFmpeg's HuffYUV v2 (``FFVH``).
//
// The stream's form comes from the extradata (``HFYU``/``FFVH`` written by
// FFmpeg or by OpenCV, which wraps FFmpeg): byte 0 the predictor (0 left,
// 1 plane, 2 median) and the decorrelation flag (bit 6), byte 1 the bits of
// a coded pixel (12 yuv420p, 16 yuv422p, 24 RGB, 32 RGBA) or, for version 3
// (byte 3 non-zero), the bit depth and chroma shifts, byte 2 the interlace
// flag (0x10 on, 0x20 off, else on above 288 rows), the per-frame tables
// flag (0x40) and, in version 3, chroma and alpha, then the code lengths
// of each plane run-length coded. A stream without extradata (HuffYUV 1.x)
// takes its predictor from biBitCount & 7 and the classic tables
// (huffyuv_tables.h).
//
// A frame is coded in 32-bit little-endian words read from the most
// significant bit. Planar YUV codes Y U Y V per pixel pair (yuv420p codes
// the odd rows in luma only), RGB codes each pixel as G, B - G, R - G (with
// decorrelation), rows bottom first; the predictors are FFmpeg's, with
// the rows of a field above when interlaced. The codes are canonical with
// the longest code first (ff_huffyuv_generate_bits_table).
//
// Where FFmpeg decodes a damaged frame into whatever the bits give (a code
// outside the table, a frame shorter than its pixels), the port raises
// ValueError. Forms beyond 8 bits are left to item 8b.

#include <algorithm>
#include <cstring>
#include <string>
#include <vector>

#include "huffyuv_tables.h"
#include "video.h"

namespace video {
namespace {

enum Predictor { kLeft = 0, kPlane = 1, kMedian = 2 };

using Bits = MsbBits;

// One plane's code: a 12-bit lookup table, then canonical ranges by length.
struct Vlc {
  static constexpr int kBits = 12;
  std::vector<int16_t> sym;   // [1 << kBits]: symbol, or -1 (longer code or none)
  std::vector<uint8_t> len;   // [1 << kBits]
  uint32_t first[33] = {0};   // first code of each length
  int count[33] = {0};
  std::vector<int16_t> by_len[33];  // symbols of each length, code order
  bool build(const uint8_t* lens, const uint32_t* codes, int n) {
    sym.assign(1 << kBits, -1);
    len.assign(1 << kBits, 0);
    for (int l = 0; l <= 32; l++) by_len[l].clear(), count[l] = 0;
    for (int i = 0; i < n; i++) {
      const int l = lens[i];
      if (!l) continue;
      if (l > 32) return false;
      if (l <= kBits) {
        const uint32_t c = codes[i];
        if (c >> l) return false;
        const uint32_t base = c << (kBits - l);
        for (uint32_t k = 0; k < (1u << (kBits - l)); k++) {
          if (sym[base + k] >= 0) return false;
          sym[base + k] = int16_t(i);
          len[base + k] = uint8_t(l);
        }
      }
    }
    // the long codes: sorted by code within each length
    std::vector<std::pair<uint32_t, int>> items[33];
    for (int i = 0; i < n; i++)
      if (lens[i] > kBits) items[lens[i]].push_back({codes[i], i});
    for (int l = kBits + 1; l <= 32; l++) {
      auto& it = items[l];
      std::sort(it.begin(), it.end());
      for (size_t k = 0; k < it.size(); k++) by_len[l].push_back(int16_t(it[k].second));
      count[l] = int(it.size());
      first[l] = it.empty() ? 0 : it[0].first;
      for (size_t k = 0; k < it.size(); k++)
        if (it[k].first != first[l] + k) return false;  // not one range: not canonical
    }
    return true;
  }
  // the next symbol, or -1 for a code outside the table
  int read(Bits& b) const {
    const uint32_t w = b.peek32();
    const uint32_t top = w >> (32 - kBits);
    if (sym[top] >= 0) {
      b.skip(len[top]);
      return sym[top];
    }
    for (int l = kBits + 1; l <= 32; l++) {
      if (!count[l]) continue;
      const uint32_t c = l == 32 ? w : w >> (32 - l);
      if (c >= first[l] && c - first[l] < uint32_t(count[l])) {
        b.skip(l);
        return by_len[l][c - first[l]];
      }
    }
    return -1;
  }
};

inline uint8_t mid_pred(int a, int b, int c) {
  if (a > b) std::swap(a, b);
  if (b > c) b = c < a ? a : c;
  return uint8_t(b);
}

// llviddsp's add_left_pred: returns the running value
uint8_t add_left(uint8_t* dst, const uint8_t* src, int w, uint8_t acc) {
  for (int i = 0; i < w; i++) dst[i] = acc = uint8_t(acc + src[i]);
  return acc;
}

void add_bytes(uint8_t* dst, const uint8_t* src, int w) {
  for (int i = 0; i < w; i++) dst[i] = uint8_t(dst[i] + src[i]);
}

void add_median(uint8_t* dst, const uint8_t* top, const uint8_t* diff, int w, uint8_t* left,
                uint8_t* left_top) {
  uint8_t l = *left, lt = *left_top;
  for (int i = 0; i < w; i++) {
    l = uint8_t(mid_pred(l, top[i], (l + top[i] - lt) & 0xff) + diff[i]);
    lt = top[i];
    dst[i] = l;
  }
  *left = l;
  *left_top = lt;
}

// read_len_table: ``n`` code lengths, run-length coded
bool read_len_table(uint8_t* dst, Bits& b, int n) {
  for (int i = 0; i < n;) {
    int repeat = int(b.get(3));
    const int val = int(b.get(5));
    if (repeat == 0) repeat = int(b.get(8));
    if (i + repeat > n || b.over()) return false;
    while (repeat--) dst[i++] = uint8_t(val);
  }
  return true;
}

// ff_huffyuv_generate_bits_table: canonical codes, the longest first
bool generate_bits(uint32_t* dst, const uint8_t* lens, int n) {
  int cnt[33] = {0};
  uint32_t codes[33];
  for (int i = 0; i < n; i++) cnt[lens[i]]++;
  codes[32] = 0;
  for (int i = 32; i > 0; i--) {
    if ((cnt[i] + codes[i]) & 1) return false;
    codes[i - 1] = (cnt[i] + codes[i]) >> 1;
  }
  for (int i = 0; i < n; i++)
    if (lens[i]) dst[i] = codes[lens[i]]++;
  return true;
}

}  // namespace

struct HuffyuvDecoder::Impl {
  int version = 0;
  int bpp = 0;  // bitstream_bpp of versions 0-2
  int predictor = kLeft;
  bool decorrelate = false;
  bool interlaced = false;
  bool context = false;
  bool chroma = true, alpha = false, yuv = false;
  int hshift = 0, vshift = 0;
  int width = 0, height = 0;
  int format = -1;
  Vlc vlc[4];
  std::vector<uint8_t> buf;  // the frame's words in reading order
  std::vector<uint8_t> temp[3];
  Picture pic;

  // the plane tables from ``b``: 3 of them, or version 3's count
  bool read_tables(Bits& b) {
    const int count = version > 2 ? 1 + (alpha ? 1 : 0) + 2 * (chroma ? 1 : 0) : 3;
    for (int i = 0; i < count; i++) {
      uint8_t lens[256];
      uint32_t codes[256] = {0};
      if (!read_len_table(lens, b, 256) || !generate_bits(codes, lens, 256) ||
          !vlc[i].build(lens, codes, 256))
        return false;
    }
    return true;
  }

  bool classic_tables() {
    uint8_t lens[2][256];
    Bits b;
    b.init(kClassicShiftLuma, sizeof(kClassicShiftLuma));
    if (!read_len_table(lens[0], b, 256)) return false;
    b.init(kClassicShiftChroma, sizeof(kClassicShiftChroma));
    if (!read_len_table(lens[1], b, 256)) return false;
    uint32_t codes[2][256];
    for (int i = 0; i < 256; i++) {
      codes[0][i] = kClassicAddLuma[i];
      codes[1][i] = kClassicAddChroma[i];
    }
    const int c = bpp >= 24 ? 0 : 1;  // RGB codes every plane with the luma table
    return vlc[0].build(lens[0], codes[0], 256) && vlc[1].build(lens[c], codes[c], 256) &&
           vlc[2].build(lens[c], codes[c], 256);
  }

  bool read(Bits& b, int plane, uint8_t* out) {
    const int s = vlc[plane].read(b);
    if (s < 0) return false;
    *out = uint8_t(s);
    return true;
  }
};

HuffyuvDecoder::HuffyuvDecoder() : impl_(new Impl) {}
HuffyuvDecoder::~HuffyuvDecoder() { delete impl_; }
const Picture& HuffyuvDecoder::picture() const { return impl_->pic; }
int HuffyuvDecoder::format() const { return impl_->format; }

int HuffyuvDecoder::configure(int bits, const uint8_t* extra, size_t n, int width, int height,
                              std::string* msg) {
  Impl& d = *impl_;
  d.width = width;
  d.height = height;
  d.interlaced = height > 288;
  if (n) {
    if ((bits & 7) && bits != 12) d.version = 1;
    else if (n > 3 && extra[3] == 0) d.version = 2;
    else d.version = 3;
  } else {
    d.version = 0;
  }
  if (d.version >= 2) {
    if (n < 4) {
      *msg = "HuffYUV extradata shorter than its header";
      return kInvalid;
    }
    d.decorrelate = extra[0] & 64;
    d.predictor = extra[0] & 63;
    if (d.version == 2) {
      d.bpp = extra[1] ? extra[1] : (bits & ~7);
    } else {
      const int bps = (extra[1] >> 4) + 1;
      if (bps != 8) {
        *msg = "HuffYUV at " + std::to_string(bps) +
               " bits: the port decodes 8-bit HuffYUV, ROADMAP.md Queue 1 item 8b";
        return kUnsupported;
      }
      d.hshift = extra[1] & 3;
      d.vshift = (extra[1] >> 2) & 3;
      d.yuv = extra[2] & 1;
      d.chroma = (extra[2] & 3) != 0;
      d.alpha = extra[2] & 4;
    }
    const int il = (extra[2] & 0x30) >> 4;
    d.interlaced = il == 1 ? true : (il == 2 ? false : d.interlaced);
    d.context = extra[2] & 0x40;
    Bits b;
    b.init(extra + 4, n - 4);
    if (!d.read_tables(b)) {
      *msg = "damaged HuffYUV tables";
      return kInvalid;
    }
  } else {
    switch (bits & 7) {
      case 1: d.predictor = kLeft; d.decorrelate = false; break;
      case 2: d.predictor = kLeft; d.decorrelate = true; break;
      case 3: d.predictor = kPlane; d.decorrelate = bits >= 24; break;
      case 4: d.predictor = kMedian; d.decorrelate = false; break;
      default: d.predictor = kLeft; d.decorrelate = false; break;
    }
    d.bpp = bits & ~7;
    if (!d.classic_tables()) {
      *msg = "damaged HuffYUV tables";
      return kInvalid;
    }
  }
  if (d.version <= 2) {
    switch (d.bpp) {
      case 12: d.format = kYuv420p; break;
      case 16: d.format = kYuv422p; break;
      case 24: d.format = kBgr0; break;
      case 32: d.format = kBgra; d.alpha = true; break;
      default:
        *msg = "HuffYUV of " + std::to_string(d.bpp) + " bits a pixel";
        return kInvalid;
    }
  } else {
    const int key = (int(d.chroma) << 10) | (int(d.yuv) << 9) | (int(d.alpha) << 8) | 0x70 |
                    d.hshift | (d.vshift << 2);
    if (key == 0x070) d.format = kGray8;
    else if (key == 0x670) d.format = kYuv444p;
    else {
      *msg = "HuffYUV v2 in a pixel format other than yuv420p, yuv422p, yuv444p, gray and "
             "8-bit RGB/RGBA: ROADMAP.md Queue 1 item 8b";
      return kUnsupported;
    }
  }
  if ((d.format == kYuv422p || d.format == kYuv420p) && (width & 1)) {
    *msg = "HuffYUV 4:2:x of odd width";
    return kInvalid;
  }
  if (d.predictor == kMedian && d.format == kYuv422p && width % 4) {
    *msg = "HuffYUV median prediction at a width not a multiple of 4";
    return kInvalid;
  }
  if (d.predictor > kMedian || (d.predictor == kMedian && (d.format == kBgr0 || d.format == kBgra))) {
    *msg = "HuffYUV prediction type not supported";
    return kInvalid;
  }
  for (auto& t : d.temp) t.assign(size_t(width) * 4 + 16, 0);
  return kOk;
}

int HuffyuvDecoder::decode(const uint8_t* src, size_t n, std::string* msg) {
  Impl& d = *impl_;
  const int w = d.width, h = d.height, w2 = w >> 1;
  if (n < (size_t(w) * h + 7) / 8) {
    *msg = "HuffYUV frame shorter than its pixels";
    return kInvalid;
  }
  // bswap_buf over whole words; the bytes past the last word read as zero
  d.buf.assign(n, 0);
  for (size_t i = 0; i + 4 <= n; i += 4) {
    d.buf[i] = src[i + 3];
    d.buf[i + 1] = src[i + 2];
    d.buf[i + 2] = src[i + 1];
    d.buf[i + 3] = src[i];
  }
  if (d.pic.width != w || d.pic.height != h || d.pic.format != d.format)
    d.pic.allocate(d.format, w, h);
  Bits b;
  size_t table_bytes = 0;
  if (d.context) {
    b.init(d.buf.data(), n);
    if (!d.read_tables(b)) {
      *msg = "damaged HuffYUV frame tables";
      return kInvalid;
    }
    table_bytes = (b.pos + 7) / 8;
  }
  b.init(d.buf.data() + table_bytes, n - table_bytes);
  Picture& p = d.pic;
  uint8_t* t0 = d.temp[0].data();
  uint8_t* t1 = d.temp[1].data();
  uint8_t* t2 = d.temp[2].data();
  bool ok = true;
  // Y U Y V of ``count`` pixels; Y Y of ``count`` for grey rows
  auto row422 = [&](int count) {
    for (int i = 0; i < count / 2 && ok; i++)
      ok = d.read(b, 0, t0 + 2 * i) && d.read(b, 1, t1 + i) && d.read(b, 0, t0 + 2 * i + 1) &&
           d.read(b, 2, t2 + i);
  };
  auto row_gray = [&](int count) {
    for (int i = 0; i < count / 2 && ok; i++)
      ok = d.read(b, 0, t0 + 2 * i) && d.read(b, 0, t0 + 2 * i + 1);
  };
  auto row_plane = [&](int count, int plane) {
    for (int i = 0; i < count / 2 && ok; i++)
      ok = d.read(b, plane, t0 + 2 * i) && d.read(b, plane, t0 + 2 * i + 1);
    if ((count & 1) && ok && b.left() > 0) ok = d.read(b, plane, t0 + count - 1);
  };
  const int sy = p.stride_y, sc = p.stride_c;
  const int fy = d.interlaced ? 2 * sy : sy, fc = d.interlaced ? 2 * sc : sc;
  uint8_t* Y = p.y.data();
  uint8_t* U = p.u.data();
  uint8_t* V = p.v.data();

  if (d.version > 2) {
    const int planes = 1 + 2 * (d.chroma ? 1 : 0) + (d.alpha ? 1 : 0);
    for (int pl = 0; pl < planes && ok && pl < 3; pl++) {
      int pw = w, ph = h, stride = sy, fs = fy;
      uint8_t* base = pl == 0 ? Y : (pl == 1 ? U : V);
      if (d.chroma && pl > 0) {
        pw >>= d.hshift;
        ph >>= d.vshift;
        stride = sc;
        fs = fc;
      }
      if (d.predictor != kMedian) {
        row_plane(pw, pl);
        uint8_t left = add_left(base, t0, pw, 0);
        for (int y = 1; y < ph && ok; y++) {
          uint8_t* dst = base + size_t(stride) * y;
          row_plane(pw, pl);
          left = add_left(dst, t0, pw, left);
          if (d.predictor == kPlane && y > int(d.interlaced)) add_bytes(dst, dst - fs, pw);
        }
      } else {
        row_plane(pw, pl);
        uint8_t left = add_left(base, t0, pw, 0);
        int y = 1;
        if (y >= ph) continue;
        if (d.interlaced) {
          row_plane(pw, pl);
          left = add_left(base + stride, t0, pw, left);
          if (++y >= ph) continue;
        }
        uint8_t lefttop = base[0];
        row_plane(pw, pl);
        add_median(base + fs, base, t0, pw, &left, &lefttop);
        y++;
        for (; y < ph && ok; y++) {
          uint8_t* dst = base + size_t(stride) * y;
          row_plane(pw, pl);
          add_median(dst, dst - fs, t0, pw, &left, &lefttop);
        }
      }
    }
  } else if (d.bpp < 24) {
    const bool is420 = d.bpp == 12;
    uint8_t leftv = V[0] = uint8_t(b.get(8));
    uint8_t lefty = Y[1] = uint8_t(b.get(8));
    uint8_t leftu = U[0] = uint8_t(b.get(8));
    Y[0] = uint8_t(b.get(8));
    if (d.predictor != kMedian) {
      row422(w - 2);
      lefty = add_left(Y + 2, t0, w - 2, lefty);
      leftu = add_left(U + 1, t1, w2 - 1, leftu);
      leftv = add_left(V + 1, t2, w2 - 1, leftv);
      for (int cy = 1, y = 1; y < h && ok; y++, cy++) {
        if (is420) {
          row_gray(w);
          uint8_t* yd = Y + size_t(sy) * y;
          lefty = add_left(yd, t0, w, lefty);
          if (d.predictor == kPlane && y > int(d.interlaced)) add_bytes(yd, yd - fy, w);
          if (++y >= h) break;
        }
        uint8_t* yd = Y + size_t(sy) * y;
        uint8_t* ud = U + size_t(sc) * cy;
        uint8_t* vd = V + size_t(sc) * cy;
        row422(w);
        lefty = add_left(yd, t0, w, lefty);
        leftu = add_left(ud, t1, w2, leftu);
        leftv = add_left(vd, t2, w2, leftv);
        if (d.predictor == kPlane && cy > int(d.interlaced)) {
          add_bytes(yd, yd - fy, w);
          add_bytes(ud, ud - fc, w2);
          add_bytes(vd, vd - fc, w2);
        }
      }
    } else {
      row422(w - 2);
      lefty = add_left(Y + 2, t0, w - 2, lefty);
      leftu = add_left(U + 1, t1, w2 - 1, leftu);
      leftv = add_left(V + 1, t2, w2 - 1, leftv);
      int y = 1, cy = 1;
      if (y < h) {
        bool done = false;
        if (d.interlaced) {
          row422(w);
          lefty = add_left(Y + sy, t0, w, lefty);
          leftu = add_left(U + sc, t1, w2, leftu);
          leftv = add_left(V + sc, t2, w2, leftv);
          y++;
          cy++;
          done = y >= h;
        }
        if (!done) {
          row422(4);
          lefty = add_left(Y + fy, t0, 4, lefty);
          leftu = add_left(U + fc, t1, 2, leftu);
          leftv = add_left(V + fc, t2, 2, leftv);
          uint8_t lefttopy = Y[3];
          row422(w - 4);
          add_median(Y + fy + 4, Y + 4, t0, w - 4, &lefty, &lefttopy);
          uint8_t lefttopu = U[1], lefttopv = V[1];
          add_median(U + fc + 2, U + 2, t1, w2 - 2, &leftu, &lefttopu);
          add_median(V + fc + 2, V + 2, t2, w2 - 2, &leftv, &lefttopv);
          y++;
          cy++;
          for (; y < h && ok; y++, cy++) {
            if (is420) {
              while (2 * cy > y && ok) {
                row_gray(w);
                uint8_t* yd = Y + size_t(sy) * y;
                add_median(yd, yd - fy, t0, w, &lefty, &lefttopy);
                y++;
              }
              if (y >= h) break;
            }
            row422(w);
            uint8_t* yd = Y + size_t(sy) * y;
            uint8_t* ud = U + size_t(sc) * cy;
            uint8_t* vd = V + size_t(sc) * cy;
            add_median(yd, yd - fy, t0, w, &lefty, &lefttopy);
            add_median(ud, ud - fc, t1, w2, &leftu, &lefttopu);
            add_median(vd, vd - fc, t2, w2, &leftv, &lefttopv);
          }
        }
      }
    }
  } else {
    // packed B G R A, rows bottom first
    enum { B = 0, G = 1, R = 2, A = 3 };
    uint8_t left[4];
    uint8_t* last = Y + size_t(sy) * (h - 1);
    if (d.bpp == 32) {
      left[A] = last[A] = uint8_t(b.get(8));
      left[R] = last[R] = uint8_t(b.get(8));
      left[G] = last[G] = uint8_t(b.get(8));
      left[B] = last[B] = uint8_t(b.get(8));
    } else {
      left[R] = last[R] = uint8_t(b.get(8));
      left[G] = last[G] = uint8_t(b.get(8));
      left[B] = last[B] = uint8_t(b.get(8));
      left[A] = last[A] = 255;
      b.skip(8);
    }
    auto row_bgr = [&](int count) {
      for (int i = 0; i < count && ok; i++) {
        uint8_t* t = t0 + 4 * i;
        if (d.decorrelate) {
          ok = d.read(b, 1, t + G) && d.read(b, 0, t + B) && d.read(b, 2, t + R);
          t[B] = uint8_t(t[B] + t[G]);
          t[R] = uint8_t(t[R] + t[G]);
        } else {
          ok = d.read(b, 0, t + B) && d.read(b, 1, t + G) && d.read(b, 2, t + R);
        }
        if (ok && d.bpp == 32) ok = d.read(b, 2, t + A);
      }
    };
    auto left_bgr = [&](uint8_t* dst, int count) {
      for (int i = 0; i < count; i++)
        for (int c = 0; c < 4; c++) dst[4 * i + c] = left[c] = uint8_t(left[c] + t0[4 * i + c]);
    };
    row_bgr(w - 1);
    left_bgr(last + 4, w - 1);
    for (int y = h - 2; y >= 0 && ok; y--) {
      row_bgr(w);
      uint8_t* row = Y + size_t(sy) * y;
      left_bgr(row, w);
      if (d.predictor == kPlane) {
        if (d.bpp != 32) left[A] = 0;
        if (y < h - 1 - int(d.interlaced)) add_bytes(row, row + fy, 4 * w);
      }
    }
  }
  if (!ok || b.over()) {
    *msg = ok ? "HuffYUV frame shorter than its codes" : "a code outside the HuffYUV tables";
    return kInvalid;
  }
  return 1;
}

}  // namespace video
