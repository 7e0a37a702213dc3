// BMP decode: the counterpart of the reference's BMP route, cv2.imdecode
// with IMREAD_COLOR or IMREAD_GRAYSCALE (OpenCV's own reader,
// imgcodecs grfmt_bmp.cpp), followed here step by step:
//
//  * headers of 12 bytes (OS/2) and of 36 bytes or more (Windows); 1, 4 and
//    8 bits through the palette, 15/16 bits (555, or 565 under
//    BI_BITFIELDS), 24 bits, 32 bits (the fourth byte dropped); BI_RLE4 and
//    BI_RLE8 with OpenCV's handling of end of line, end of bitmap and delta
//    (skipped pixels take palette entry 0); bottom-up and top-down rows;
//  * grey output through OpenCV's BGR -> grey (utils.cpp
//    icvCvt_BGR2Gray_8u_C3C1R: 1868 B + 9617 G + 4899 R, 14 bits, rounded),
//    applied to the palette for the palette forms.
//
// Output is RGB (the caller flips it for BGR) or one grey channel, uint8.

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum { kRGB = 0, kRLE8 = 1, kRLE4 = 2, kBitfields = 3 };

struct Pal {
  uint8_t b, g, r, a;
};

inline uint8_t cv_gray(int b, int g, int r) {
  return (uint8_t)((b * 1868 + g * 9617 + r * 4899 + (1 << 13)) >> 14);
}

struct Header {
  int offset = 0, width = 0, height = 0, bpp = 0, rle = kRGB;
  bool bottom_up = true;
  Pal palette[256];
};

// A reader that fails where OpenCV's stream runs out of data.
struct Stream {
  const uint8_t* d;
  size_t n, pos = 0;
  bool ok = true;
  int byte() {
    if (pos >= n) {
      ok = false;
      return 0;
    }
    return d[pos++];
  }
  int word() {
    const int a = byte();
    return a | byte() << 8;
  }
  uint32_t dword() {
    const uint32_t a = (uint32_t)word();
    return a | (uint32_t)word() << 16;
  }
  void bytes(uint8_t* out, size_t k) {
    if (n - pos < k || pos > n) {
      ok = false;
      return;
    }
    std::memcpy(out, d + pos, k);
    pos += k;
  }
};

// BmpDecoder::readHeader. Returns false for a header OpenCV rejects.
bool read_header(const uint8_t* data, size_t len, Header* hd) {
  Stream s{data, len};
  std::memset(hd->palette, 0, sizeof(hd->palette));
  s.pos = 10;
  hd->offset = (int)s.dword();
  const int size = (int)s.dword();
  if (size <= 0) return false;
  bool result = true;
  if (size >= 36) {
    hd->width = (int)s.dword();
    hd->height = (int)s.dword();
    hd->bpp = (int)(s.dword() >> 16);
    const int rle = (int)s.dword();
    if (rle < 0 || rle > kBitfields) return false;
    hd->rle = rle;
    s.pos += 12;
    const int clrused = (int)s.dword();
    if (hd->bpp <= 8) {
      if (clrused < 0 || clrused > 256) return false;
      s.pos += size - 36;
      const int n = clrused == 0 ? 1 << hd->bpp : clrused;
      s.bytes(reinterpret_cast<uint8_t*>(hd->palette), (size_t)n * 4);
    } else if (hd->bpp == 16 && hd->rle == kBitfields) {
      s.pos += size - 36;  // the masks after the header, whatever its size
      const uint32_t red = s.dword(), green = s.dword(), blue = s.dword();
      if (blue == 0x1f && green == 0x3e0 && red == 0x7c00)
        hd->bpp = 15;
      else if (!(blue == 0x1f && green == 0x7e0 && red == 0xf800))
        result = false;
    } else if (hd->bpp == 16 && hd->rle == kRGB) {
      hd->bpp = 15;
    }
  } else if (size == 12) {
    hd->width = s.word();
    hd->height = s.word();
    hd->bpp = (int)(s.dword() >> 16);
    hd->rle = kRGB;
    if (hd->bpp <= 8) {
      uint8_t buf[256 * 3];
      const int n = 1 << hd->bpp;
      s.bytes(buf, (size_t)n * 3);
      for (int j = 0; j < n; j++) hd->palette[j] = {buf[3 * j], buf[3 * j + 1], buf[3 * j + 2], 0};
    }
  } else {
    return false;
  }
  if (!s.ok) return false;
  hd->bottom_up = hd->height > 0;
  hd->height = std::abs(hd->height);
  const int b = hd->bpp, r = hd->rle;
  const bool form = ((b == 1 || b == 4 || b == 8 || b == 15 || b == 16 || b == 24 || b == 32) &&
                     r == kRGB) ||
                    ((b == 16 || b == 32) && r == kBitfields) || (b == 4 && r == kRLE4) ||
                    (b == 8 && r == kRLE8);
  return result && hd->width > 0 && hd->height > 0 && form;
}

// The output in OpenCV's BGR (or grey) order, one row of `width * nch`
// bytes at a time; rows run bottom-up through a negative step.
struct Canvas {
  std::vector<uint8_t> px;
  int nch;
  const Pal* pal;
  const uint8_t* gray_pal;
  void put(uint8_t* p, int idx) const {
    if (nch == 3) {
      p[0] = pal[idx].b;
      p[1] = pal[idx].g;
      p[2] = pal[idx].r;
    } else {
      *p = gray_pal[idx];
    }
  }
};

// OpenCV FillUniColor / FillUniGray: `count` bytes of palette entry `idx`
// from the cursor, wrapping to the next row; y counts finished rows.
uint8_t* fill_uni(const Canvas& cv, uint8_t* data, uint8_t*& line_end, long step, int width_n,
                  int& y, int height, int count, int idx) {
  do {
    uint8_t* end = data + count;
    if (end > line_end) end = line_end;
    count -= (int)(end - data);
    for (; data < end; data += cv.nch) cv.put(data, idx);
    if (data >= line_end) {
      line_end += step;
      data = line_end - width_n;
      if (++y >= height) break;
    }
  } while (count > 0);
  return data;
}

}  // namespace

extern "C" {

// Image size of a BMP as OpenCV reads it. Returns 0, or -1 for a header
// OpenCV rejects.
int dali_tpu_torch_bmp_info(const uint8_t* data, size_t len, int* h, int* w) {
  Header hd;
  if (!read_header(data, len, &hd)) return -1;
  *h = hd.height;
  *w = hd.width;
  return 0;
}

// Decode into out: h x w x 3 RGB, or h x w grey. Returns 0, or -1 where
// OpenCV's reader fails (bad header, data that ends early, an RLE run past
// the end of its row).
int dali_tpu_torch_bmp_decode(const uint8_t* data, size_t len, int gray, uint8_t* out) {
  Header hd;
  if (!read_header(data, len, &hd)) return -1;
  const int W = hd.width, H = hd.height, bpp = hd.bpp;
  const int nch = gray ? 1 : 3;
  uint8_t gray_pal[256] = {0};
  for (int i = 0; i < 256; i++)
    gray_pal[i] = cv_gray(hd.palette[i].b, hd.palette[i].g, hd.palette[i].r);
  Canvas cv{std::vector<uint8_t>((size_t)W * H * nch), nch, hd.palette, gray_pal};
  const long row = (long)W * nch;
  long step = row;
  uint8_t* data0 = cv.px.data();
  if (hd.bottom_up) {
    data0 += (size_t)(H - 1) * row;
    step = -row;
  }
  const int src_pitch = ((W * (bpp != 15 ? bpp : 16) + 7) / 8 + 3) & -4;
  std::vector<uint8_t> src((size_t)src_pitch + 32);
  Stream s{data, len};
  if (hd.offset < 0) return -1;
  s.pos = (size_t)hd.offset;
  uint8_t* d = data0;
  int y = 0;
  if (hd.rle == kRLE8 || hd.rle == kRLE4) {
    uint8_t* line_end = d + row;
    int line_end_flag = 0;
    for (;;) {
      const int word = s.word();
      if (!s.ok) return -1;
      const int len8 = word & 255;
      int code = word >> 8;
      if (len8 != 0) {  // encoded run
        uint8_t* end = d + (long)len8 * nch;
        if (end > line_end) return -1;
        if (hd.rle == kRLE8) {
          for (; d < end; d += nch) cv.put(d, code);
          line_end_flag = 0;
        } else {
          int t = 0;
          for (; d < end; d += nch, t ^= 1) cv.put(d, t ? code & 15 : code >> 4);
        }
        if (hd.rle == kRLE8 && y >= H) break;
      } else if (code > 2) {  // absolute run
        if (d + (long)code * nch > line_end) return -1;
        const int sz = hd.rle == kRLE8 ? (code + 1) & ~1 : (((code + 1) >> 1) + 1) & ~1;
        s.bytes(src.data(), (size_t)sz);
        if (!s.ok) return -1;
        for (int x = 0; x < code; x++, d += nch)
          cv.put(d, hd.rle == kRLE8 ? src[x] : (x & 1 ? src[x >> 1] & 15 : src[x >> 1] >> 4));
        line_end_flag = 0;
        if (hd.rle == kRLE8 && y >= H) break;
      } else if (hd.rle == kRLE8) {  // end of line, end of bitmap, delta
        int x_shift = (int)(line_end - d);
        int y_shift = H - y;
        if (code || !line_end_flag || x_shift < row) {
          if (code == 2) {
            x_shift = s.byte() * nch;
            y_shift = s.byte();
            if (!s.ok) return -1;
          }
          x_shift += (int)((y_shift * row) & (code == 0 ? 0 : -1));
          if (y >= H) break;
          d = fill_uni(cv, d, line_end, step, (int)row, y, H, x_shift, 0);
          if (y >= H) break;
        }
        line_end_flag = 0;
        if (y >= H) break;
      } else {
        int x_shift = (int)(line_end - d);
        if (code == 2) {
          x_shift = s.byte() * nch;
          s.byte();
          if (!s.ok) return -1;
        }
        d = fill_uni(cv, d, line_end, step, (int)row, y, H, x_shift, 0);
        if (y >= H) break;
      }
    }
  } else {
    for (y = 0; y < H; y++, d += step) {
      s.bytes(src.data(), (size_t)src_pitch);
      if (!s.ok) return -1;
      const uint8_t* p = src.data();
      for (int x = 0; x < W; x++) {
        int b, g, r;
        switch (bpp) {
          case 1:
          case 4:
          case 8: {
            const int idx = bpp == 8   ? p[x]
                            : bpp == 4 ? (x & 1 ? p[x >> 1] & 15 : p[x >> 1] >> 4)
                                       : (p[x >> 3] >> (7 - (x & 7))) & 1;
            cv.put(d + (long)x * nch, idx);
            continue;
          }
          case 15: {
            const int t = p[2 * x] | p[2 * x + 1] << 8;
            b = (t << 3) & 0xf8;
            g = (t >> 2) & 0xf8;
            r = (t >> 7) & 0xf8;
            break;
          }
          case 16: {
            const int t = p[2 * x] | p[2 * x + 1] << 8;
            b = (t << 3) & 0xf8;
            g = (t >> 3) & 0xfc;
            r = (t >> 8) & 0xf8;
            break;
          }
          case 24:
            b = p[3 * x], g = p[3 * x + 1], r = p[3 * x + 2];
            break;
          default:  // 32
            b = p[4 * x], g = p[4 * x + 1], r = p[4 * x + 2];
            break;
        }
        uint8_t* o = d + (long)x * nch;
        if (gray) {
          *o = cv_gray(b, g, r);
        } else {
          o[0] = (uint8_t)b;
          o[1] = (uint8_t)g;
          o[2] = (uint8_t)r;
        }
      }
    }
  }
  // BGR -> RGB
  const size_t npx = (size_t)W * H;
  if (gray) {
    std::memcpy(out, cv.px.data(), npx);
  } else {
    for (size_t i = 0; i < npx; i++) {
      out[3 * i] = cv.px[3 * i + 2];
      out[3 * i + 1] = cv.px[3 * i + 1];
      out[3 * i + 2] = cv.px[3 * i];
    }
  }
  return 0;
}

}  // extern "C"
