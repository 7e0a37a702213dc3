// WebP decode for dali_tpu_torch's host image decoders: the RIFF container
// (RFC 9649 section 2), the pixel decoders of webp_vp8.cc (lossy) and
// webp_vp8l.cc (lossless), and the colour conversion libwebp's
// WebPDecodeBGR applies by default, which is what cv2.imdecode (OpenCV 5.0)
// gives dali_tpu:
//
// * ``VP8 ``, ``VP8L`` and ``VP8X`` files; a lossy frame's ``ALPH`` chunk
//   (the last one before the frame, as libwebp takes it) is decoded as
//   libwebp decodes it, even into BGR: raw or lossless (a headerless VP8L
//   stream of the frame's size, alpha in green), then unfiltered; a chunk
//   libwebp fails fails the file, and the colour output drops alpha,
//   unblended; ``ICCP`` and ``XMP `` are skipped;
//   the ``EXIF`` chunk's orientation is returned for the caller to apply, as
//   cv2 applies it;
// * the container checks of libwebp's header parse: the RIFF size against
//   the data, the VP8X canvas against the frame, the chunk sizes;
// * an animated file gives its first frame where that frame covers the
//   canvas opaquely (what cv2's animation decoder then shows); other
//   animations are refused as not read;
// * lossy frames: "fancy" chroma upsampling (the 9-3-3-1 filter between two
//   chroma rows, the first and an even height's last row and an even width's
//   last column from their own chroma row and column), then libwebp's
//   fixed-point YUV->RGB
//   (MultHi with 19077, 26149, 6419, 13320 and 33050, offsets -14234, 8708
//   and -17685, clipped to 8 bits after >> 6).
//
// Output: RGB uint8 [h, w, 3], or one grey channel as OpenCV's cvtColor
// BGR2GRAY gives it: (9798 R + 19235 G + 3735 B + 16384) >> 15.

#include <cstring>
#include <new>

#include "webp.h"

namespace dali_webp {
namespace {

inline uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}
inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }

// What the container holds: the bitstream to decode, its kind, the canvas
// (the image size cv2 reads from the header) and the EXIF orientation.
struct Container {
  const uint8_t* payload = nullptr;
  size_t size = 0;
  bool lossless = false;
  int w = 0, h = 0;
  int orientation = 1;
  bool animated = false;
  bool frame_alpha = false;  // the frame has an ALPH chunk
  const uint8_t* alpha = nullptr;  // its payload and declared size
  size_t alpha_size = 0;
};

int tiff_orientation(const uint8_t* d, size_t n) {
  if (n >= 6 && std::memcmp(d, "Exif\0\0", 6) == 0) {
    d += 6;
    n -= 6;
  }
  if (n < 8) return 1;
  const bool le = d[0] == 'I' && d[1] == 'I';
  if (!le && !(d[0] == 'M' && d[1] == 'M')) return 1;
  auto u16 = [&](size_t o) { return le ? d[o] | (d[o + 1] << 8) : (d[o] << 8) | d[o + 1]; };
  auto u32 = [&](size_t o) {
    return le ? le32(d + o)
              : (static_cast<uint32_t>(d[o]) << 24) | (d[o + 1] << 16) | (d[o + 2] << 8) | d[o + 3];
  };
  const size_t ifd = u32(4);
  if (ifd + 2 > n) return 1;
  const int count = u16(ifd);
  for (int i = 0; i < count; ++i) {
    const size_t e = ifd + 2 + 12 * static_cast<size_t>(i);
    if (e + 12 > n) return 1;
    if (u16(e) == 0x0112) {
      const int v = u16(e + 8);
      return v >= 1 && v <= 8 ? v : 1;
    }
  }
  return 1;
}

// The frame's bitstream after the optional chunks (``optional``: a VP8X
// file's), as libwebp's ParseOptionalChunks and ParseVP8Header find it.
// 0 or -1.
int find_frame(const uint8_t* p, size_t left, uint32_t riff_size, uint32_t total, Container* c,
               bool optional) {
  while (optional) {
    if (left < 8) return -1;
    const uint32_t chunk = le32(p + 4);
    if (chunk > 0xfffffff6u) return -1;
    const uint32_t disk = (8 + chunk + 1) & ~1u;
    total += disk;
    if (riff_size > 0 && total > riff_size) return -1;
    if (std::memcmp(p, "VP8 ", 4) == 0 || std::memcmp(p, "VP8L", 4) == 0) break;
    if (left < disk) return -1;
    if (std::memcmp(p, "ALPH", 4) == 0) {
      c->frame_alpha = true;
      c->alpha = p + 8;
      c->alpha_size = chunk;
    }
    if (std::memcmp(p, "EXIF", 4) == 0) c->orientation = tiff_orientation(p + 8, chunk);
    p += disk;
    left -= disk;
  }
  if (left < 8) return -1;
  const uint32_t size = le32(p + 4);
  if (riff_size >= 12 && size > riff_size - 12) return -1;
  if (size > left - 8) return -1;
  c->payload = p + 8;
  c->size = size;
  c->lossless = p[3] == 'L';
  return 0;
}

// 0, -1 for a file libwebp or cv2 rejects, 1 for an animation this decoder
// does not read.
int parse(const uint8_t* d, size_t n, Container* c) {
  if (n < 32 || std::memcmp(d, "RIFF", 4) != 0 || std::memcmp(d + 8, "WEBP", 4) != 0) return -1;
  const uint32_t riff_size = le32(d + 4);
  if (riff_size < 12 || riff_size > 0xfffffff6u || riff_size > n - 8) return -1;
  const uint8_t* p = d + 12;
  size_t left = n - 12;
  bool vp8x = false;
  int cw = 0, ch = 0;
  if (std::memcmp(p, "VP8X", 4) == 0) {
    if (le32(p + 4) != 10 || left < 18) return -1;
    const uint32_t flags = le32(p + 8);
    cw = 1 + static_cast<int>(le24(p + 12));
    ch = 1 + static_cast<int>(le24(p + 15));
    if (static_cast<uint64_t>(cw) * ch >= (1ull << 32)) return -1;
    vp8x = true;
    c->animated = (flags & 0x02) != 0;
    p += 18;
    left -= 18;
  }
  if (c->animated) {
    // the chunks up to the first ANMF, then the frame inside it
    uint32_t total = 4 + 18;
    for (;;) {
      if (left < 8) return -1;
      const uint32_t chunk = le32(p + 4);
      const uint32_t disk = (8 + chunk + 1) & ~1u;
      if (left < disk) return -1;
      total += disk;
      if (total > riff_size) return -1;
      if (std::memcmp(p, "EXIF", 4) == 0) c->orientation = tiff_orientation(p + 8, chunk);
      if (std::memcmp(p, "ANMF", 4) == 0) {
        if (chunk < 16) return -1;
        const uint8_t* f = p + 8;
        const int fx = 2 * static_cast<int>(le24(f)), fy = 2 * static_cast<int>(le24(f + 3));
        const int fw = 1 + static_cast<int>(le24(f + 6)), fh = 1 + static_cast<int>(le24(f + 9));
        if (fx != 0 || fy != 0 || fw != cw || fh != ch) return 1;
        Container fc;
        if (find_frame(f + 16, chunk - 16, 0, 0, &fc, true) != 0) return -1;
        if (fc.frame_alpha) return 1;
        c->payload = fc.payload;
        c->size = fc.size;
        c->lossless = fc.lossless;
        break;
      }
      p += disk;
      left -= disk;
    }
    // EXIF may follow the frames
    const uint8_t* q = p;
    size_t qleft = left;
    while (qleft >= 8) {
      const uint32_t disk = (8 + le32(q + 4) + 1) & ~1u;
      if (qleft < disk) break;
      if (std::memcmp(q, "EXIF", 4) == 0) c->orientation = tiff_orientation(q + 8, le32(q + 4));
      q += disk;
      qleft -= disk;
    }
  } else {
    if (left < 4) return -1;
    if (vp8x) {
      if (find_frame(p, left, riff_size, 4 + 18, c, true) != 0) return -1;
      // the EXIF chunk comes after the image data in the layout RFC 9649 gives
      const uint8_t* q = c->payload + c->size + (c->size & 1);
      const uint8_t* end = d + 8 + riff_size;
      while (q + 8 <= end && q + 8 <= d + n) {
        const uint32_t chunk = le32(q + 4);
        const uint32_t disk = (8 + chunk + 1) & ~1u;
        if (q + disk > d + n) break;
        if (std::memcmp(q, "EXIF", 4) == 0) c->orientation = tiff_orientation(q + 8, chunk);
        q += disk;
      }
    } else {
      if (left < 8 || (std::memcmp(p, "VP8 ", 4) != 0 && std::memcmp(p, "VP8L", 4) != 0)) return -1;
      if (find_frame(p, left, riff_size, 4, c, false) != 0) return -1;
    }
  }
  int w, h;
  if (!(c->lossless ? vp8l_size(c->payload, c->size, &w, &h) : vp8_size(c->payload, c->size, &w, &h)))
    return -1;
  if (vp8x && (w != cw || h != ch)) return -1;
  c->w = w;
  c->h = h;
  return 0;
}

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) { return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255; }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  const int yy = mult_hi(y, 19077);
  rgb[0] = yuv_clip8(yy + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(yy + mult_hi(u, 33050) - 17685);
}

// libwebp's UpsampleRgbLinePair: two output rows from their luma rows and
// the two chroma rows around them (u and v packed as u | v << 16).
void upsample_pair(const uint8_t* top_y, const uint8_t* bot_y, const uint8_t* tu, const uint8_t* tv,
                   const uint8_t* cu, const uint8_t* cv, uint8_t* top_dst, uint8_t* bot_dst,
                   int len) {
  const int last_pair = (len - 1) >> 1;
  uint32_t tl_uv = tu[0] | (tv[0] << 16);
  uint32_t l_uv = cu[0] | (cv[0] << 16);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_rgb(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
  }
  if (bot_y) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_rgb(bot_y[0], uv0 & 0xff, uv0 >> 16, bot_dst);
  }
  for (int x = 1; x <= last_pair; ++x) {
    const uint32_t t_uv = tu[x] | (tv[x] << 16);
    const uint32_t uv = cu[x] | (cv[x] << 16);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      yuv_to_rgb(top_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16) & 0xff, top_dst + (2 * x - 1) * 3);
      yuv_to_rgb(top_y[2 * x], uv1 & 0xff, (uv1 >> 16) & 0xff, top_dst + 2 * x * 3);
    }
    if (bot_y) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      yuv_to_rgb(bot_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16) & 0xff, bot_dst + (2 * x - 1) * 3);
      yuv_to_rgb(bot_y[2 * x], uv1 & 0xff, (uv1 >> 16) & 0xff, bot_dst + 2 * x * 3);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_rgb(top_y[len - 1], uv0 & 0xff, (uv0 >> 16) & 0xff, top_dst + (len - 1) * 3);
    }
    if (bot_y) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_rgb(bot_y[len - 1], uv0 & 0xff, (uv0 >> 16) & 0xff, bot_dst + (len - 1) * 3);
    }
  }
}

// The whole frame, as libwebp's EmitFancyRGB emits it: row 0 alone, then
// rows (2k-1, 2k) between chroma rows k-1 and k, then an even height's last
// row alone.
void yuv_to_rgb_frame(const Yuv& f, uint8_t* rgb) {
  const int w = f.w, h = f.h, uw = (w + 1) / 2;
  const size_t row = static_cast<size_t>(w) * 3;
  const uint8_t* u = f.u.data();
  const uint8_t* v = f.v.data();
  upsample_pair(&f.y[0], nullptr, u, v, u, v, rgb, nullptr, w);
  int y = 1;
  for (int k = 1; 2 * k < h; ++k, y += 2) {
    const uint8_t* tu = u + static_cast<size_t>(k - 1) * uw;
    const uint8_t* tv = v + static_cast<size_t>(k - 1) * uw;
    upsample_pair(&f.y[static_cast<size_t>(y) * w], &f.y[static_cast<size_t>(y + 1) * w], tu, tv,
                  tu + uw, tv + uw, rgb + y * row, rgb + (y + 1) * row, w);
  }
  if (y == h - 1) {
    const uint8_t* lu = u + static_cast<size_t>((h - 1) / 2) * uw;
    const uint8_t* lv = v + static_cast<size_t>((h - 1) / 2) * uw;
    upsample_pair(&f.y[static_cast<size_t>(y) * w], nullptr, lu, lv, lu, lv, rgb + y * row, nullptr,
                  w);
  }
}

// libwebp's alpha unfilters (WEBP_FILTER_HORIZONTAL, VERTICAL, GRADIENT) of
// one row in place; ``prev`` is the row above, null for the first row.
void unfilter_row(int filter, const uint8_t* prev, uint8_t* row, int w) {
  if (filter == 1 || (filter > 1 && prev == nullptr)) {
    uint8_t pred = prev ? prev[0] : 0;
    for (int i = 0; i < w; ++i) pred = row[i] = static_cast<uint8_t>(pred + row[i]);
  } else if (filter == 2) {
    for (int i = 0; i < w; ++i) row[i] = static_cast<uint8_t>(prev[i] + row[i]);
  } else if (filter == 3) {
    int top_left = prev[0], left = prev[0];
    for (int i = 0; i < w; ++i) {
      const int top = prev[i];
      const int g = left + top - top_left;
      left = static_cast<uint8_t>(row[i] + ((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255));
      top_left = top;
      row[i] = static_cast<uint8_t>(left);
    }
  }
}

// The alpha plane [h, w] of an ALPH chunk as libwebp's ALPHInit and
// ALPHDecode give it: header byte (compression 0 raw or 1 lossless, filter,
// pre-processing 0 or 1, reserved bits 0), then the values, unfiltered. 0,
// or -1 where libwebp fails the frame.
int decode_alpha(const uint8_t* data, size_t size, int w, int h, std::vector<uint8_t>* plane) {
  if (size <= 1) return -1;
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3;
  if (method > 1 || pre > 1 || (data[0] >> 6) != 0) return -1;
  const size_t px = static_cast<size_t>(w) * h;
  if (method == 0) {
    if (size - 1 < px) return -1;
    plane->assign(data + 1, data + 1 + px);
  } else if (vp8l_decode_alpha(data + 1, size - 1, w, h, plane) != 0) {
    return -1;
  }
  for (int y = 0; y < h; ++y)
    unfilter_row(filter, y ? plane->data() + static_cast<size_t>(y - 1) * w : nullptr,
                 plane->data() + static_cast<size_t>(y) * w, w);
  return 0;
}

inline uint8_t cv_gray15(int r, int g, int b) {
  return static_cast<uint8_t>((9798 * r + 19235 * g + 3735 * b + 16384) >> 15);
}

int decode(const uint8_t* data, size_t len, int gray, uint8_t* dst) {
  Container c;
  const int rc = parse(data, len, &c);
  if (rc != 0) return rc;
  const size_t px = static_cast<size_t>(c.w) * c.h;
  if (c.lossless) {
    std::vector<uint32_t> argb;
    int w, h;
    if (vp8l_decode(c.payload, c.size, &w, &h, &argb) != 0) return -1;
    if (c.animated)
      for (uint32_t p : argb)
        if ((p >> 24) != 0xff) return 1;  // blended onto the canvas: not read
    for (size_t i = 0; i < px; ++i) {
      const uint32_t p = argb[i];
      const int r = (p >> 16) & 0xff, g = (p >> 8) & 0xff, b = p & 0xff;
      if (gray) {
        dst[i] = cv_gray15(r, g, b);
      } else {
        dst[3 * i] = static_cast<uint8_t>(r);
        dst[3 * i + 1] = static_cast<uint8_t>(g);
        dst[3 * i + 2] = static_cast<uint8_t>(b);
      }
    }
    return 0;
  }
  Yuv f;
  if (vp8_decode(c.payload, c.size, &f) != 0) return -1;
  std::vector<uint8_t> alpha;
  if (c.alpha && decode_alpha(c.alpha, c.alpha_size, c.w, c.h, &alpha) != 0) return -1;
  if (!gray) {
    yuv_to_rgb_frame(f, dst);
    return 0;
  }
  std::vector<uint8_t> rgb(px * 3);
  yuv_to_rgb_frame(f, rgb.data());
  for (size_t i = 0; i < px; ++i) dst[i] = cv_gray15(rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2]);
  return 0;
}

}  // namespace

// Header facts for the batch entry (image_decode_batch.cc).
int webp_info(const uint8_t* data, size_t len, int* h, int* w, int* orientation) {
  Container c;
  const int rc = parse(data, len, &c);
  if (rc != 0) return rc;
  *h = c.h;
  *w = c.w;
  *orientation = c.orientation;
  return 0;
}

int webp_decode(const uint8_t* data, size_t len, int gray, uint8_t* dst) {
  try {
    return decode(data, len, gray, dst);
  } catch (const std::bad_alloc&) {
    return -1;
  }
}

// The alpha plane [h, w] of a still lossy WebP's ALPH chunk into ``dst``: 0,
// -1 where libwebp fails it, 1 for a file without one.
int webp_alpha(const uint8_t* data, size_t len, uint8_t* dst) {
  try {
    Container c;
    if (parse(data, len, &c) != 0) return -1;
    if (c.lossless || c.animated || !c.alpha) return 1;
    std::vector<uint8_t> plane;
    if (decode_alpha(c.alpha, c.alpha_size, c.w, c.h, &plane) != 0) return -1;
    std::memcpy(dst, plane.data(), plane.size());
    return 0;
  } catch (const std::bad_alloc&) {
    return -1;
  }
}

}  // namespace dali_webp
