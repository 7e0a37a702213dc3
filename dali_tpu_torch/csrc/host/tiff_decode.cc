// TIFF decoder written from the TIFF 6.0 specification (and BigTIFF's
// header), for the host image decode of dali_tpu_torch. It gives what
// cv2.imdecode(IMREAD_COLOR | IMREAD_ANYDEPTH) (OpenCV 5.0 over libtiff)
// gives dali_tpu for the first image of a file, before the Orientation tag,
// which the caller applies as cv2 does.
//
// Read: classic (II/MM, 42) and BigTIFF (43) headers, the first IFD; strips
// and tiles; planar configuration 1 and 2; compression 1 (none), 5 (LZW,
// MSB-first codes with the early width change), 32773 (PackBits) and 8 /
// 32946 (Deflate, through inflate.cc); predictor 2 at 8, 16 and 32 bits and
// predictor 3 (the floating-point byte planes) at 32; photometric 0-3; 1, 4
// (palette), 8 and 16 bits per sample and 32-bit IEEE float. cv2 takes two
// routes:
//
// * 8 bits and fewer go through libtiff's RGBA interface: grey through its
//   map (x * 255 / range, inverted for min-is-white; 0/255 when bilevel),
//   a palette through its colormap (16-bit entries >> 8 unless every entry
//   is below 256), RGB as stored, or premultiplied as (c * a + 127) / 255
//   under unassociated alpha; grey is then OpenCV's BGRA2Gray, 14-bit
//   weights (1868 B + 9617 G + 4899 R + 8192) >> 14;
// * 16-bit and float samples are read raw and keep their depth: grey
//   repeated to three channels, RGB as stored, a fourth sample dropped; grey
//   output from three or four samples by the same 14-bit weights.
//
// Output: RGB [h, w, 3] or grey [h, w, 1], uint8, uint16 or float32.
// Return codes: 0; -1 for a file libtiff or cv2 rejects; 1 for a form this
// decoder does not read (JPEG-in-TIFF, CMYK, YCbCr, ...).

#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

#include "inflate.h"

namespace {

struct Fail {
  int rc;
};
[[noreturn]] void bad() { throw Fail{-1}; }
[[noreturn]] void unsupported() { throw Fail{1}; }

struct Ifd {
  bool le = true, big = false;
  uint32_t w = 0, h = 0;
  int bps = 1, spp = 1, compression = 1, photometric = -1, planar = 1, predictor = 1;
  int orientation = 1, sample_format = 1, fill_order = 1;
  uint64_t rows_per_strip = 0xffffffffull;
  bool tiled = false, has_counts = false;
  uint32_t tile_w = 0, tile_h = 0;
  std::vector<uint64_t> offsets, counts;
  std::vector<uint64_t> colormap;
  std::vector<uint64_t> extra;
};

class Reader {
 public:
  Reader(const uint8_t* d, size_t n) : d_(d), n_(n) {}
  uint64_t u(uint64_t off, int size, bool le) const {
    if (off > n_ || static_cast<uint64_t>(size) > n_ - off) bad();
    uint64_t v = 0;
    for (int i = 0; i < size; ++i) {
      const uint64_t b = d_[off + i];
      v |= le ? b << (8 * i) : b << (8 * (size - 1 - i));
    }
    return v;
  }
  size_t size() const { return n_; }
  const uint8_t* data() const { return d_; }

 private:
  const uint8_t* d_;
  size_t n_;
};

int type_size(int type) {
  switch (type) {
    case 1: case 2: case 6: case 7: return 1;
    case 3: case 8: return 2;
    case 4: case 9: case 11: case 13: return 4;
    case 5: case 10: case 12: case 16: case 17: case 18: return 8;
    default: return 0;
  }
}

Ifd parse_ifd(const Reader& r) {
  Ifd f;
  if (r.size() < 8) bad();
  const uint8_t* d = r.data();
  if (d[0] == 'I' && d[1] == 'I') f.le = true;
  else if (d[0] == 'M' && d[1] == 'M') f.le = false;
  else bad();
  const int magic = static_cast<int>(r.u(2, 2, f.le));
  uint64_t ifd;
  if (magic == 42) {
    ifd = r.u(4, 4, f.le);
  } else if (magic == 43) {
    f.big = true;
    if (r.u(4, 2, f.le) != 8 || r.u(6, 2, f.le) != 0) bad();
    ifd = r.u(8, 8, f.le);
  } else {
    bad();
  }
  const uint64_t count = r.u(ifd, f.big ? 8 : 2, f.le);
  const uint64_t first = ifd + (f.big ? 8 : 2);
  const int entry = f.big ? 20 : 12;
  bool has_w = false, has_h = false;
  for (uint64_t i = 0; i < count; ++i) {
    const uint64_t e = first + i * entry;
    const int tag = static_cast<int>(r.u(e, 2, f.le));
    const int type = static_cast<int>(r.u(e + 2, 2, f.le));
    const uint64_t n = r.u(e + 4, f.big ? 8 : 4, f.le);
    const int ts = type_size(type);
    if (ts == 0) continue;
    const int inline_bytes = f.big ? 8 : 4;
    const uint64_t field = e + (f.big ? 12 : 8);
    const bool inl = n * ts <= static_cast<uint64_t>(inline_bytes);
    const uint64_t at = inl ? field : r.u(field, f.big ? 8 : 4, f.le);
    auto values = [&](uint64_t limit) {
      if (n > limit) bad();
      std::vector<uint64_t> v(n);
      for (uint64_t k = 0; k < n; ++k) v[k] = r.u(at + k * ts, ts > 8 ? 8 : ts, f.le);
      return v;
    };
    auto one = [&]() {
      if (n < 1 || type == 5 || type == 10 || type == 11 || type == 12) bad();
      return r.u(at, ts, f.le);
    };
    switch (tag) {
      case 256: f.w = static_cast<uint32_t>(one()); has_w = true; break;
      case 257: f.h = static_cast<uint32_t>(one()); has_h = true; break;
      case 258: {
        const std::vector<uint64_t> b = values(1 << 16);
        if (b.empty()) bad();
        for (uint64_t x : b)
          if (x != b[0]) bad();
        f.bps = static_cast<int>(b[0]);
        break;
      }
      case 259: f.compression = static_cast<int>(one()); break;
      case 262: f.photometric = static_cast<int>(one()); break;
      case 266: f.fill_order = static_cast<int>(one()); break;
      case 273: case 324: f.offsets = values(1ull << 28); f.tiled |= tag == 324; break;
      case 279: case 325: f.counts = values(1ull << 28); f.has_counts = true; break;
      case 274: f.orientation = static_cast<int>(one()); break;
      case 277: f.spp = static_cast<int>(one()); break;
      case 278: f.rows_per_strip = one(); break;
      case 284: f.planar = static_cast<int>(one()); break;
      case 317: f.predictor = static_cast<int>(one()); break;
      case 320: f.colormap = values(3 << 16); break;
      case 322: f.tile_w = static_cast<uint32_t>(one()); break;
      case 323: f.tile_h = static_cast<uint32_t>(one()); break;
      case 338: f.extra = values(1 << 16); break;
      case 339: {
        const std::vector<uint64_t> s = values(1 << 16);
        if (!s.empty()) f.sample_format = static_cast<int>(s[0]);
        break;
      }
      default: break;
    }
  }
  if (!has_w || !has_h || f.w == 0 || f.h == 0) bad();
  if (f.orientation < 1 || f.orientation > 8) f.orientation = 1;
  return f;
}

enum Route { kRgba8 = 0, kRaw16 = 1, kFloat = 2 };

// The route cv2 takes, or a refusal.
// Values that name a form cv2 reads and this decoder does not: refused as
// not read. Any other value outside the forms read fails, as in libtiff.
bool known_compression(int c) {
  switch (c) {
    case 2: case 3: case 4: case 6: case 7: case 32771: case 32809: case 32908: case 32909:
    case 34661: case 34676: case 34677: case 34712: case 34925: case 50000: case 50001:
      return true;
    default:
      return false;
  }
}

Route classify(const Ifd& f) {
  if (f.photometric < 0 || !f.has_counts) bad();
  if (f.photometric == 4 || f.photometric == 5 || f.photometric == 6 || f.photometric == 8 ||
      f.photometric == 9 || f.photometric == 10 || f.photometric == 32844 ||
      f.photometric == 32845)
    unsupported();  // mask, CMYK, YCbCr, CIE L*a*b*, ICC and ITU L*a*b*, LogL, LogLuv
  if (f.photometric > 3) bad();
  if (f.compression != 1 && f.compression != 5 && f.compression != 8 && f.compression != 32946 &&
      f.compression != 32773) {
    if (known_compression(f.compression)) unsupported();  // JPEG-in-TIFF, CCITT, LZMA, ...
    bad();
  }
  if (f.planar < 1 || f.planar > 2 || f.fill_order < 1 || f.fill_order > 2) bad();
  if (f.fill_order != 1) unsupported();
  if (f.spp < 1 || f.spp > 4) bad();  // cv2 reads at most four samples
  if (f.sample_format < 1 || f.sample_format > 6 || f.predictor < 1 || f.predictor > 3) bad();
  if (f.bps < 1 || f.bps > 64) bad();
  if (f.tiled && (f.tile_w == 0 || f.tile_h == 0)) bad();
  if (f.bps == 16 || f.bps == 32) {
    if (f.photometric > 2 || f.spp == 2 || (f.planar == 2 && f.spp > 1)) unsupported();
    if (f.bps == 16) {
      if (f.sample_format != 1) unsupported();
      if (f.predictor != 1 && f.predictor != 2) unsupported();
      return kRaw16;
    }
    if (f.sample_format != 3) unsupported();  // 32-bit integers
    if (f.predictor < 1 || f.predictor > 3) unsupported();
    return kFloat;
  }
  if (f.bps != 1 && f.bps != 2 && f.bps != 4 && f.bps != 8) unsupported();
  // cv2 5.0 reads 2-bit samples nowhere and 4-bit ones only as palette indices
  if (f.bps == 2 || (f.bps == 4 && f.photometric != 3)) bad();
  if (f.sample_format != 1) unsupported();
  if (f.predictor == 3 || f.predictor > 3) unsupported();
  if (f.predictor == 2 && f.bps < 8) bad();  // libtiff refuses the file
  if (f.photometric == 2 && (f.bps != 8 || f.spp < 3)) bad();
  if (f.photometric != 2 && f.planar == 1 && f.spp != 1 && f.bps < 8) bad();
  if (f.photometric == 3 && f.planar == 2 && f.spp > 1) bad();
  if (f.planar == 2 && f.spp > 1 && f.photometric < 2 && f.bps < 8) bad();
  // cv2 5.0's libtiff fails an uncompressed tile through the RGBA reader
  // unless its byte size is a multiple of 1024 (found by probing tile sizes
  // and depths against cv2; the compressed tiles and the 16-bit reader are
  // not affected)
  if (f.tiled && f.compression == 1 &&
      (static_cast<uint64_t>(f.tile_h) * ((static_cast<uint64_t>(f.tile_w) *
                                           (f.planar == 2 ? 1 : f.spp) * f.bps + 7) / 8)) % 1024)
    bad();
  return kRgba8;
}

// ---------------------------------------------------------------- codecs
// LZW as libtiff decodes it (new-style codes); false where libtiff fails
bool lzw_decode(const uint8_t* src, size_t n, uint8_t* out, size_t occ) {
  if (n >= 2 && src[0] == 0 && (src[1] & 1)) unsupported();  // the pre-5.0 bit order
  constexpr int kClear = 256, kEoi = 257, kFirst = 258, kSize = 4096 + 1024;
  struct Entry {
    int prev;
    uint16_t len;
    uint8_t value, first;
  };
  std::vector<Entry> tab(kSize);
  for (int i = 0; i < 256; ++i) tab[i] = {-1, 1, static_cast<uint8_t>(i), static_cast<uint8_t>(i)};
  const uint64_t total_bits = 8ull * n;
  uint64_t bitpos = 0;
  int nbits = 9, free_ent = kFirst, max_code = 510;
  int old = 0;
  size_t pos = 0;
  auto next = [&]() -> int {
    if (total_bits - bitpos < static_cast<uint64_t>(nbits)) return kEoi;  // not terminated
    int v = 0;
    for (int i = 0; i < nbits; ++i, ++bitpos) v = (v << 1) | ((src[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    return v;
  };
  auto emit = [&](int code) {
    const int len = tab[code].len;
    if (len == 0) return false;
    // written back to front; a string past the end is cut
    int c = code;
    for (int k = len - 1; k >= 0; --k, c = tab[c].prev)
      if (pos + k < occ) out[pos + k] = tab[c].value;
    pos += len;
    return true;
  };
  while (pos < occ) {
    int code = next();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        for (int i = kFirst; i < kSize; ++i) tab[i].len = 0;
        free_ent = kFirst;
        nbits = 9;
        max_code = 510;
        code = next();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return false;
      out[pos++] = static_cast<uint8_t>(code);
      old = code;
      continue;
    }
    if (free_ent >= kSize) return false;
    Entry& e = tab[free_ent];
    e.prev = old;
    e.first = tab[old].first;
    e.len = static_cast<uint16_t>(tab[old].len + 1);
    e.value = code < free_ent ? tab[code].first : e.first;
    if (++free_ent > max_code) {
      if (++nbits > 12) nbits = 12;
      max_code = (1 << nbits) - 2;
    }
    old = code;
    if (code >= 256) {
      if (!emit(code)) return false;
    } else {
      out[pos++] = static_cast<uint8_t>(code);
    }
  }
  return pos >= occ;
}

bool packbits_decode(const uint8_t* src, size_t cc, uint8_t* op, size_t occ) {
  while (cc > 0 && occ > 0) {
    int n = *src++;
    cc--;
    if (n >= 128) n -= 256;
    if (n < 0) {
      if (n == -128) continue;
      size_t run = static_cast<size_t>(-n + 1);
      if (occ < run) run = occ;
      if (cc == 0) break;
      occ -= run;
      const uint8_t b = *src++;
      cc--;
      std::memset(op, b, run);
      op += run;
    } else {
      size_t lit = static_cast<size_t>(n) + 1;
      if (occ < lit) lit = occ;
      if (cc < lit) break;
      std::memcpy(op, src, lit);
      op += lit;
      occ -= lit;
      src += lit;
      cc -= lit;
    }
  }
  return occ == 0;
}

struct Layout {
  uint32_t chunks_across = 1, chunks_down = 0, cw = 0, ch = 0;  // chunk grid and size (pixels)
  int planes = 1, chunk_spp = 1;
  size_t row_bytes = 0;  // bytes of one row of a chunk
  size_t n_chunks() const { return static_cast<size_t>(chunks_across) * chunks_down * planes; }
};

Layout layout(const Ifd& f) {
  Layout l;
  l.planes = f.planar == 2 ? f.spp : 1;
  l.chunk_spp = f.planar == 2 ? 1 : f.spp;
  if (f.tiled) {
    l.cw = f.tile_w;
    l.ch = f.tile_h;
    l.chunks_across = (f.w + f.tile_w - 1) / f.tile_w;
    l.chunks_down = (f.h + f.tile_h - 1) / f.tile_h;
  } else {
    const uint64_t rps = f.rows_per_strip == 0 || f.rows_per_strip > f.h ? f.h : f.rows_per_strip;
    l.cw = f.w;
    l.ch = static_cast<uint32_t>(rps);
    l.chunks_down = static_cast<uint32_t>((f.h + rps - 1) / rps);
  }
  l.row_bytes = (static_cast<size_t>(l.cw) * l.chunk_spp * f.bps + 7) / 8;
  return l;
}

inline uint16_t bswap16(uint16_t v) { return static_cast<uint16_t>((v >> 8) | (v << 8)); }

// The decoded bytes of one chunk (strip or tile) with the predictor undone
// and samples in host order. A codec error fails the file, except under
// ``lenient`` (libtiff's RGBA reader, which goes on past it): the chunk then
// keeps what the codec wrote before the error, zeros after, the predictor
// not undone.
void decode_chunk(const Ifd& f, const Layout& l, const uint8_t* src, size_t n, size_t rows,
                  bool lenient, std::vector<uint8_t>* out) {
  const size_t occ = rows * l.row_bytes;
  out->assign(occ, 0);
  uint8_t* o = out->data();
  bool ok;
  switch (f.compression) {
    case 1:
      ok = n >= occ;
      if (ok) std::memcpy(o, src, occ);
      break;
    case 5:
      ok = lzw_decode(src, n, o, occ);
      break;
    case 32773:
      ok = packbits_decode(src, n, o, occ);
      break;
    default: {  // Deflate: what zlib wrote before it failed stays
      size_t written;
      const int rc = dali_inflate::inflate_zlib(src, n, o, occ, &written);
      ok = written == occ && rc != dali_inflate::kError;
    }
  }
  if (!ok) {
    if (!lenient) bad();
    return;
  }
  // libtiff undoes the predictor only under the codecs that declare it (LZW
  // and Deflate here); uncompressed and PackBits strips ignore the tag
  const int predictor = f.compression == 1 || f.compression == 32773 ? 1 : f.predictor;
  const int stride = l.chunk_spp;
  if (predictor == 3) {  // floating point: byte planes, most significant first
    const size_t wc = static_cast<size_t>(l.cw) * stride;
    std::vector<uint8_t> tmp(l.row_bytes);
    for (size_t r = 0; r < rows; ++r) {
      uint8_t* cp = o + r * l.row_bytes;
      for (size_t i = stride; i < l.row_bytes; ++i) cp[i] = static_cast<uint8_t>(cp[i] + cp[i - stride]);
      std::memcpy(tmp.data(), cp, l.row_bytes);
      for (size_t k = 0; k < wc; ++k)
        for (int b = 0; b < 4; ++b) cp[4 * k + b] = tmp[(3 - b) * wc + k];
    }
    return;
  }
  const bool swab = !f.le;
  if (f.bps == 16) {
    uint16_t* p = reinterpret_cast<uint16_t*>(o);
    const size_t nw = occ / 2;
    if (swab)
      for (size_t i = 0; i < nw; ++i) p[i] = bswap16(p[i]);
    if (predictor == 2) {
      const size_t wr = l.row_bytes / 2;
      for (size_t r = 0; r < rows; ++r)
        for (size_t i = stride; i < wr; ++i)
          p[r * wr + i] = static_cast<uint16_t>(p[r * wr + i] + p[r * wr + i - stride]);
    }
  } else if (f.bps == 32) {
    uint32_t* p = reinterpret_cast<uint32_t*>(o);
    const size_t nw = occ / 4;
    if (swab)
      for (size_t i = 0; i < nw; ++i) p[i] = __builtin_bswap32(p[i]);
    if (predictor == 2) {
      const size_t wr = l.row_bytes / 4;
      for (size_t r = 0; r < rows; ++r)
        for (size_t i = stride; i < wr; ++i) p[r * wr + i] += p[r * wr + i - stride];
    }
  } else if (predictor == 2) {
    for (size_t r = 0; r < rows; ++r) {
      uint8_t* p = o + r * l.row_bytes;
      for (size_t i = stride; i < l.row_bytes; ++i) p[i] = static_cast<uint8_t>(p[i] + p[i - stride]);
    }
  }
}

inline uint32_t sample_at(const uint8_t* row, size_t k, int bps) {
  switch (bps) {
    case 8: return row[k];
    case 16: return reinterpret_cast<const uint16_t*>(row)[k];
    case 32: return reinterpret_cast<const uint32_t*>(row)[k];
    default: {
      const size_t bit = k * bps;
      return (row[bit >> 3] >> (8 - bps - (bit & 7))) & ((1u << bps) - 1);
    }
  }
}

// All samples of the image: [h, w, spp] for planar 1, [spp, h, w] for 2.
std::vector<uint32_t> read_samples(const Ifd& f, const uint8_t* data, size_t len) {
  const Layout l = layout(f);
  const size_t nc = l.n_chunks();
  if (f.offsets.size() < nc || f.counts.size() < nc) bad();
  std::vector<uint32_t> s(static_cast<size_t>(f.w) * f.h * f.spp);
  std::vector<uint8_t> buf;
  const size_t per_plane = static_cast<size_t>(l.chunks_across) * l.chunks_down;
  for (size_t c = 0; c < nc; ++c) {
    const int plane = static_cast<int>(c / per_plane);
    const uint32_t cy = static_cast<uint32_t>((c % per_plane) / l.chunks_across);
    const uint32_t cx = static_cast<uint32_t>((c % per_plane) % l.chunks_across);
    const uint32_t y0 = cy * l.ch, x0 = cx * l.cw;
    const size_t rows = f.tiled ? l.ch : (f.h - y0 < l.ch ? f.h - y0 : l.ch);
    // a chunk whose bytes are not all in the file fails it, in either reader
    if (f.counts[c] == 0 || f.offsets[c] > len || f.counts[c] > len - f.offsets[c]) bad();
    decode_chunk(f, l, data + f.offsets[c], f.counts[c], rows, f.bps <= 8, &buf);
    const uint32_t vis_h = f.h - y0 < l.ch ? f.h - y0 : l.ch;
    const uint32_t vis_w = f.w - x0 < l.cw ? f.w - x0 : l.cw;
    // libtiff's RGBA reader steps a grey tile with extra samples by the
    // clipped width's samples plus the clipped pixels (not samples): a
    // right-edge tile's rows after the first start early, as cv2 gives them
    const size_t pitch = f.tiled && f.planar == 1 && f.photometric < 2 && f.spp > 1 && f.bps == 8
                             ? static_cast<size_t>(vis_w) * f.spp + (l.cw - vis_w)
                             : l.row_bytes;
    for (uint32_t y = 0; y < vis_h; ++y) {
      const uint8_t* row = buf.data() + y * pitch;
      for (uint32_t x = 0; x < vis_w; ++x)
        for (int k = 0; k < l.chunk_spp; ++k) {
          const uint32_t v = sample_at(row, static_cast<size_t>(x) * l.chunk_spp + k, f.bps);
          if (f.planar == 2)
            s[(static_cast<size_t>(plane) * f.h + y0 + y) * f.w + x0 + x] = v;
          else
            s[((static_cast<size_t>(y0) + y) * f.w + x0 + x) * f.spp + k] = v;
        }
    }
  }
  return s;
}

inline uint32_t gray14(uint32_t r, uint32_t g, uint32_t b) {
  return (b * 1868 + g * 9617 + r * 4899 + (1 << 13)) >> 14;
}

void decode(const uint8_t* data, size_t len, int gray, void* dst) {
  const Reader r(data, len);
  const Ifd f = parse_ifd(r);
  const Route route = classify(f);
  const std::vector<uint32_t> s = read_samples(f, data, len);
  const size_t px = static_cast<size_t>(f.w) * f.h;
  const int spp = f.spp;
  auto sample = [&](size_t i, int k) {
    return f.planar == 2 ? s[static_cast<size_t>(k) * px + i] : s[i * spp + k];
  };
  if (route == kRgba8) {
    uint8_t* out = static_cast<uint8_t*>(dst);
    const int range = (1 << f.bps) - 1;
    uint8_t map[256];
    for (int x = 0; x <= range; ++x)
      map[x] = static_cast<uint8_t>((f.photometric == 0 ? range - x : x) * 255 / range);
    uint8_t pal[3][256];
    if (f.photometric == 3) {
      const size_t n = static_cast<size_t>(1) << f.bps;
      if (f.colormap.size() != 3 * n) bad();
      bool wide = false;
      for (uint64_t v : f.colormap) wide |= v >= 256;
      for (int c = 0; c < 3; ++c)
        for (size_t i = 0; i < n; ++i)
          pal[c][i] = static_cast<uint8_t>(wide ? f.colormap[c * n + i] >> 8 : f.colormap[c * n + i]);
    }
    const bool unassoc = f.photometric == 2 && spp >= 4 && !f.extra.empty() && f.extra[0] == 2;
    // libtiff's RGBA reader mirrors a right-to-left Orientation (2, 3, 6, 7)
    // within the region it reads, one tile at a time, while the Orientation
    // cv2 applies after mirrors the whole image: a tiled file comes out with
    // its tiles in mirrored places and their contents as stored. ``src(i)``
    // is the stored pixel that lands at ``i`` before that Orientation.
    const bool mirror = f.tiled && (f.orientation == 2 || f.orientation == 3 ||
                                    f.orientation == 6 || f.orientation == 7);
    auto src = [&](size_t i) -> size_t {
      if (!mirror) return i;
      const size_t y = i / f.w, xm = f.w - 1 - i % f.w;  // the globally mirrored column
      const size_t x0 = xm / f.tile_w * f.tile_w;
      const size_t vw = f.w - x0 < f.tile_w ? f.w - x0 : f.tile_w;
      return y * f.w + x0 + (vw - 1 - (xm - x0));
    };
    for (size_t o = 0; o < px; ++o) {
      const size_t i = src(o);
      uint32_t rr, gg, bb;
      if (f.photometric < 2 && f.planar == 2 && spp > 1) {
        // separate planes skip the map and take RGB's alpha rules
        // (libtiff's gtStripSeparate with one colour channel)
        rr = gg = bb = sample(i, 0);
        if (!f.extra.empty() && f.extra[0] == 2) rr = gg = bb = (rr * sample(i, 1) + 127) / 255;
      } else if (f.photometric < 2) {
        rr = gg = bb = map[sample(i, 0)];
      } else if (f.photometric == 3) {
        const uint32_t v = sample(i, 0);
        rr = pal[0][v];
        gg = pal[1][v];
        bb = pal[2][v];
      } else {
        rr = sample(i, 0);
        gg = sample(i, 1);
        bb = sample(i, 2);
        if (unassoc) {
          const uint32_t a = sample(i, 3);
          rr = (rr * a + 127) / 255;
          gg = (gg * a + 127) / 255;
          bb = (bb * a + 127) / 255;
        }
      }
      if (gray) {
        out[o] = static_cast<uint8_t>(gray14(rr, gg, bb));
      } else {
        out[3 * o] = static_cast<uint8_t>(rr);
        out[3 * o + 1] = static_cast<uint8_t>(gg);
        out[3 * o + 2] = static_cast<uint8_t>(bb);
      }
    }
    return;
  }
  if (route == kRaw16) {
    uint16_t* out = static_cast<uint16_t*>(dst);
    for (size_t i = 0; i < px; ++i) {
      const uint32_t r0 = sample(i, 0);
      const uint32_t g0 = spp >= 3 ? sample(i, 1) : r0, b0 = spp >= 3 ? sample(i, 2) : r0;
      if (gray) {
        out[i] = static_cast<uint16_t>(spp == 1 ? r0 : gray14(r0, g0, b0));
      } else {
        out[3 * i] = static_cast<uint16_t>(r0);
        out[3 * i + 1] = static_cast<uint16_t>(g0);
        out[3 * i + 2] = static_cast<uint16_t>(b0);
      }
    }
    return;
  }
  uint32_t* out = static_cast<uint32_t*>(dst);  // float32 bit patterns
  if (spp != (gray ? 1 : 3)) bad();  // cv2 reads float samples only into as many channels
  for (size_t i = 0; i < px; ++i) {
    const uint32_t r0 = sample(i, 0);
    if (gray) {
      out[i] = r0;
      continue;
    }
    out[3 * i] = r0;
    out[3 * i + 1] = spp >= 3 ? sample(i, 1) : r0;
    out[3 * i + 2] = spp >= 3 ? sample(i, 2) : r0;
  }
}

}  // namespace

namespace dali_tiff {

// Header facts: size, Orientation, output depth (0 uint8, 1 uint16, 2
// float32) and the number of strips or tiles.
int info(const uint8_t* data, size_t len, int* h, int* w, int* orientation, int* depth,
         int* n_chunks) {
  try {
    const Reader r(data, len);
    const Ifd f = parse_ifd(r);
    const Route route = classify(f);
    *h = static_cast<int>(f.h);
    *w = static_cast<int>(f.w);
    *orientation = f.orientation;
    *depth = static_cast<int>(route);
    *n_chunks = static_cast<int>(layout(f).n_chunks());
    return 0;
  } catch (const Fail& e) {
    return e.rc;
  }
}

// Offsets, byte counts and decoded sizes of the first ``n`` chunks.
int chunks(const uint8_t* data, size_t len, int n, uint64_t* offsets, uint64_t* counts,
           uint64_t* sizes) {
  try {
    const Ifd f = parse_ifd(Reader(data, len));
    const Layout l = layout(f);
    if (f.offsets.size() < static_cast<size_t>(n) || f.counts.size() < static_cast<size_t>(n)) bad();
    const size_t per_plane = static_cast<size_t>(l.chunks_across) * l.chunks_down;
    for (int c = 0; c < n; ++c) {
      const uint32_t y0 = static_cast<uint32_t>((c % per_plane) / l.chunks_across) * l.ch;
      const size_t rows = f.tiled ? l.ch : (f.h - y0 < l.ch ? f.h - y0 : l.ch);
      offsets[c] = f.offsets[c];
      counts[c] = f.counts[c];
      sizes[c] = rows * l.row_bytes;
    }
    return 0;
  } catch (const Fail& e) {
    return e.rc;
  }
}

int decode(const uint8_t* data, size_t len, int gray, void* dst) {
  try {
    ::decode(data, len, gray, dst);
    return 0;
  } catch (const Fail& e) {
    return e.rc;
  } catch (const std::bad_alloc&) {
    return -1;
  }
}

}  // namespace dali_tiff
