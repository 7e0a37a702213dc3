// GIF decoder written from the GIF89a specification, for the host image
// decode of dali_tpu_torch. It gives what cv2.imdecode (OpenCV 5.0) gives
// dali_tpu for a GIF: the first image of the file composited onto the
// logical screen, which starts as the global colour table's background
// colour (black without a global table); pixels of the Graphic Control
// Extension's transparent index keep the screen's colour. Covered: GIF87a
// and GIF89a, global and local colour tables, LZW with minimum code sizes
// 2-8 (clear codes, a full 4096-entry table kept until the next clear),
// interlaced images, and a first image smaller than the screen or offset in
// it. Extensions other than the Graphic Control Extension are skipped.
//
// Output: RGB uint8 [h, w, 3], or one grey channel as OpenCV's cvtColor
// BGRA2GRAY gives it: (9798 R + 19235 G + 3735 B + 16384) >> 15.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Fail {};

struct Reader {
  const uint8_t* d;
  size_t len;
  size_t pos = 0;

  uint8_t u8() {
    if (pos >= len) throw Fail();
    return d[pos++];
  }
  uint16_t u16() {
    const uint16_t lo = u8();
    return static_cast<uint16_t>(lo | (u8() << 8));
  }
  const uint8_t* take(size_t n) {
    if (n > len - pos) throw Fail();
    const uint8_t* p = d + pos;
    pos += n;
    return p;
  }
  // the data sub-blocks up to their zero terminator, appended to ``out``
  void sub_blocks(std::vector<uint8_t>* out) {
    for (;;) {
      const uint8_t n = u8();
      if (n == 0) return;
      const uint8_t* p = take(n);
      if (out) out->insert(out->end(), p, p + n);
    }
  }
};

struct Screen {
  int w = 0, h = 0;
  const uint8_t* gct = nullptr;
  int gct_size = 0;
  int background = 0;
};

void read_screen(Reader& r, Screen& s) {
  const uint8_t* sig = r.take(6);
  if (std::memcmp(sig, "GIF87a", 6) != 0 && std::memcmp(sig, "GIF89a", 6) != 0) throw Fail();
  s.w = r.u16();
  s.h = r.u16();
  const uint8_t packed = r.u8();
  s.background = r.u8();
  r.u8();  // pixel aspect ratio
  if (packed & 0x80) {
    s.gct_size = 2 << (packed & 7);
    s.gct = r.take(3 * static_cast<size_t>(s.gct_size));
  }
  if (s.w == 0 || s.h == 0) throw Fail();
}

// LZW of one image into ``count`` palette indices.
void lzw_decode(const std::vector<uint8_t>& src, int min_size, size_t count,
                std::vector<uint8_t>& out) {
  if (min_size < 2 || min_size > 8) throw Fail();
  const int clear = 1 << min_size, eoi = clear + 1;
  uint16_t prefix[4096];
  uint8_t suffix[4096], first[4096];
  uint16_t length[4096];
  for (int i = 0; i < clear; i++) {
    prefix[i] = 0xFFFF;
    suffix[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  int size = min_size + 1, next = eoi + 1, prev = -1;
  size_t bitpos = 0;
  const size_t nbits = src.size() * 8;
  out.assign(count, 0);
  size_t n = 0;
  while (n < count) {
    if (bitpos + size > nbits) throw Fail();  // the data ends before the image
    int code = 0;
    for (int b = 0; b < size; b++, bitpos++)
      code |= ((src[bitpos >> 3] >> (bitpos & 7)) & 1) << b;
    if (code == clear) {
      size = min_size + 1;
      next = eoi + 1;
      prev = -1;
      continue;
    }
    if (code == eoi) throw Fail();
    int emit;
    if (prev < 0) {
      if (code >= clear) throw Fail();
      emit = code;
    } else if (code < next) {
      emit = code;
      if (next < 4096) {
        prefix[next] = static_cast<uint16_t>(prev);
        suffix[next] = first[code];
        first[next] = first[prev];
        length[next] = static_cast<uint16_t>(length[prev] + 1);
        next++;
      }
    } else if (code == next && next < 4096) {  // the KwKwK case
      prefix[next] = static_cast<uint16_t>(prev);
      suffix[next] = first[prev];
      first[next] = first[prev];
      length[next] = static_cast<uint16_t>(length[prev] + 1);
      emit = next++;
    } else {
      throw Fail();
    }
    if (next == (1 << size) && size < 12) size++;
    prev = code;
    // write the string of ``emit`` backwards from its end
    const size_t len = length[emit];
    size_t end = n + len;
    int c = emit;
    for (size_t k = len; k-- > 0;) {
      if (n + k < count) out[n + k] = suffix[c];
      c = prefix[c];
    }
    n = end < count ? end : count;
  }
}

void decode(const uint8_t* data, size_t len, int gray, uint8_t* dst) {
  Reader r{data, len};
  Screen s;
  read_screen(r, s);
  std::vector<uint8_t> canvas(static_cast<size_t>(s.w) * s.h * 3, 0);
  if (s.gct && s.background < s.gct_size) {
    const uint8_t* c = s.gct + 3 * s.background;
    for (size_t i = 0; i < canvas.size(); i += 3) std::memcpy(&canvas[i], c, 3);
  }
  int transparent = -1;
  for (;;) {
    const uint8_t tag = r.u8();
    if (tag == 0x21) {  // extension
      const uint8_t label = r.u8();
      if (label == 0xF9) {
        const uint8_t n = r.u8();
        const uint8_t* g = r.take(n);
        if (n >= 4) transparent = (g[0] & 1) ? g[3] : -1;
      }
      r.sub_blocks(nullptr);
    } else if (tag == 0x2C) {  // the first image
      const int left = r.u16(), top = r.u16(), w = r.u16(), h = r.u16();
      const uint8_t packed = r.u8();
      const uint8_t* pal = s.gct;
      int pal_size = s.gct_size;
      if (packed & 0x80) {
        pal_size = 2 << (packed & 7);
        pal = r.take(3 * static_cast<size_t>(pal_size));
      }
      if (!pal || w == 0 || h == 0) throw Fail();
      const int min_size = r.u8();
      std::vector<uint8_t> lzw;
      r.sub_blocks(&lzw);
      std::vector<uint8_t> idx;
      lzw_decode(lzw, min_size, static_cast<size_t>(w) * h, idx);
      std::vector<int> rows(h);
      if (packed & 0x40) {  // interlaced: rows 0::8, 4::8, 2::4, 1::2
        int k = 0;
        for (int start : {0, 4, 2, 1}) {
          const int step = start == 0 || start == 4 ? 8 : start == 2 ? 4 : 2;
          for (int y = start; y < h; y += step) rows[k++] = y;
        }
      } else {
        for (int y = 0; y < h; y++) rows[y] = y;
      }
      for (int k = 0; k < h; k++) {
        const int y = top + rows[k];
        if (y >= s.h) continue;
        for (int x = 0; x < w && left + x < s.w; x++) {
          const int v = idx[static_cast<size_t>(k) * w + x];
          if (v == transparent) continue;
          if (v >= pal_size) throw Fail();
          std::memcpy(&canvas[(static_cast<size_t>(y) * s.w + left + x) * 3], pal + 3 * v, 3);
        }
      }
      break;
    } else {  // a trailer or anything else before the first image
      throw Fail();
    }
  }
  const size_t px = static_cast<size_t>(s.w) * s.h;
  if (gray) {
    for (size_t i = 0; i < px; i++) {
      const uint8_t* c = &canvas[3 * i];
      dst[i] = static_cast<uint8_t>((9798 * c[0] + 19235 * c[1] + 3735 * c[2] + 16384) >> 15);
    }
  } else {
    std::memcpy(dst, canvas.data(), canvas.size());
  }
}

}  // namespace

extern "C" {

// The logical screen's size; 0, or -1 for a stream that is not a GIF.
int dali_tpu_torch_gif_info(const uint8_t* data, size_t len, int* h, int* w) {
  try {
    Reader r{data, len};
    Screen s;
    read_screen(r, s);
    *h = s.h;
    *w = s.w;
    return 0;
  } catch (const Fail&) {
    return -1;
  }
}

// The first image on the logical screen into ``dst`` (uint8 [h, w, 3] RGB,
// or [h, w, 1] with ``gray``). 0, or -1 for a malformed stream.
int dali_tpu_torch_gif_decode(const uint8_t* data, size_t len, int gray, uint8_t* dst) {
  try {
    decode(data, len, gray, dst);
    return 0;
  } catch (const Fail&) {
    return -1;
  } catch (const std::bad_alloc&) {
    return -1;
  }
}

}  // extern "C"
