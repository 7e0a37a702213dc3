// MPEG-1 (ISO/IEC 11172-2) and MPEG-2 (ISO/IEC 13818-2) video decoder for
// frame pictures in 4:2:0 and 4:2:2, written from the specifications:
// sequence headers with their matrices, the sequence, quant matrix and
// picture coding extensions, GOP headers, I-, P- and B-pictures, slices,
// the macroblock types of Tables B.2-B.4, skipped macroblocks, intra DC
// prediction at 8-11 bits, both coefficient tables (B.14, B.15) and both
// scans, linear and non-linear quantiser scales, half-sample motion with
// forward, backward and interpolated prediction, frame and field motion and
// frame and field DCT in frame pictures, and the reorder of anchors.
//
// One packet is one picture with the headers before it, as libavformat's
// mpegvideo parser splits a stream. Where the standard leaves the decoder
// a choice, the choices are those of the stream's reference decode, FFmpeg
// 5.1's ``mpeg1video`` / ``mpeg2video`` decoder on x86-64, so that the
// output is bit-equal to it:
//   * the inverse DCT is FFmpeg's "simple" integer IDCT (as for MPEG-4
//     Part 2, its default on x86-64);
//   * coefficients are dequantised without the [-2048, 2047] saturation;
//     MPEG-2 mismatch control toggles coefficient 63; an intra matrix's
//     first entry is taken as 8;
//   * the reference pictures are the macroblock-aligned canvases and a
//     vector that reaches past them is damage (FFmpeg skips such a
//     prediction);
//   * a skipped macroblock of a B-picture keeps the previous macroblock's
//     directions with the predictors as its vectors (undoubled even with
//     MPEG-1's full_pel vectors);
//   * pictures leave in display order: an I- or P-picture when the next
//     one starts, a B-picture at once, every picture at once when the
//     sequence says low_delay; the held anchor leaves at the end of the
//     stream, and is dropped when a sequence header changes the size;
//   * after a flush (a seek) the B-pictures before the first anchor are
//     skipped unless their GOP header says closed_gop, and a B-picture
//     without a past reference predicts from a grey picture.
// Field pictures, dual-prime motion, 4:4:4, the scalable extensions and
// MPEG-1 D-pictures are ROADMAP.md Queue 1 item 8b (kUnsupported). A stream
// the reference would conceal (a VLC or position error, an overread, a
// missing slice) is reported as damaged.

#include <algorithm>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#include "mpeg12_tables.h"
#include "video.h"

namespace video {
namespace {

using namespace mpeg12_tables;

constexpr int kSeqStart = 0xb3, kExtStart = 0xb5, kGopStart = 0xb8, kPictureStart = 0x00;
constexpr int kI = 1, kP = 2, kB = 3;

// macroblock type flags
constexpr int kIntra = 1, kQuant = 2, kFwd = 4, kBack = 8, kCbp = 16, kZeroMv = 32;

// ---------------------------------------------------------------- bitstream

struct Bits {
  const uint8_t* p = nullptr;
  int64_t nbits = 0;
  int64_t pos = 0;
  Bits() = default;
  Bits(const uint8_t* d, size_t n) : p(d), nbits(int64_t(n) * 8) {}
  // the next 32 bits; zeros past the end
  uint32_t peek32() const {
    const int64_t byte = pos >> 3;
    uint64_t w = 0;
    if (byte >= 0 && byte + 8 <= (nbits >> 3)) {
      for (int i = 0; i < 5; i++) w = (w << 8) | p[byte + i];
    } else {
      for (int i = 0; i < 5; i++) {
        const int64_t b = byte + i;
        w = (w << 8) | (b >= 0 && b < (nbits >> 3) ? p[b] : 0u);
      }
    }
    return uint32_t(w >> (8 - (pos & 7)));
  }
  uint32_t peek(int k) const { return k ? peek32() >> (32 - k) : 0; }
  int32_t peek_signed(int k) const { return int32_t(peek32()) >> (32 - k); }
  uint32_t get(int k) {
    uint32_t v = peek(k);
    pos += k;
    return v;
  }
  int bit() { return int(get(1)); }
  void skip(int64_t k) { pos += k; }
  int64_t left() const { return nbits - pos; }
};

// ---------------------------------------------------------------- VLC tables

// One entry of the coefficient tables as FFmpeg's rl_vlc holds it: run + 1
// and the level of a code, run 65 level 0 for the escape, level 127 for the
// end of block, length 0 for a code outside the table.
struct AcEntry {
  uint8_t run;
  uint8_t level;
  uint8_t len;
};

struct ShortVlc {
  int bits = 0;
  std::vector<int8_t> sym;
  std::vector<uint8_t> len;
  void build(int nbits, int n, const int* codes, const int* lens) {
    bits = nbits;
    sym.assign(size_t(1) << nbits, -1);
    len.assign(size_t(1) << nbits, 0);
    for (int i = 0; i < n; i++) {
      const int l = lens[i];
      if (!l) continue;
      const uint32_t first = uint32_t(codes[i]) << (nbits - l);
      for (uint32_t k = 0; k < (1u << (nbits - l)); k++) {
        sym[first + k] = int8_t(i);
        len[first + k] = uint8_t(l);
      }
    }
  }
  // the symbol, or -1 for a code outside the table
  int read(Bits& b) const {
    const uint32_t v = b.peek(bits);
    if (!len[v]) return -1;
    b.skip(len[v]);
    return sym[v];
  }
};

struct Tables {
  AcEntry ac[2][1 << 16];
  ShortVlc incr, pattern, motion, dc[2];
};

const Tables& tables() {
  static Tables* t = new Tables();
  static std::once_flag once;
  std::call_once(once, [] {
    for (int k = 0; k < 2; k++) {
      const uint16_t(*tab)[2] = k ? kMpeg2Vlc : kMpeg1Vlc;
      AcEntry* dst = t->ac[k];
      for (int v = 0; v < (1 << 16); v++) dst[v] = {65, 64, 0};
      for (int i = 0; i < 113; i++) {
        const int code = tab[i][0], l = tab[i][1];
        AcEntry e;
        if (i == 111) e = {65, 0, uint8_t(l)};
        else if (i == 112) e = {0, 127, uint8_t(l)};
        else e = {uint8_t(kRun[i] + 1), kLevel[i], uint8_t(l)};
        const uint32_t first = uint32_t(code) << (16 - l);
        for (uint32_t j = 0; j < (1u << (16 - l)); j++) dst[first + j] = e;
      }
    }
    int codes[64], lens[64];
    for (int i = 0; i < 36; i++) codes[i] = kMbAddrIncr[i][0], lens[i] = kMbAddrIncr[i][1];
    t->incr.build(11, 36, codes, lens);
    for (int i = 0; i < 64; i++) codes[i] = kMbPattern[i][0], lens[i] = kMbPattern[i][1];
    t->pattern.build(9, 64, codes, lens);
    for (int i = 0; i < 17; i++) codes[i] = kMotion[i][0], lens[i] = kMotion[i][1];
    t->motion.build(10, 17, codes, lens);
    for (int i = 0; i < 12; i++) codes[i] = kDcLumCode[i], lens[i] = kDcLumBits[i];
    t->dc[0].build(10, 12, codes, lens);
    for (int i = 0; i < 12; i++) codes[i] = kDcChromaCode[i], lens[i] = kDcChromaBits[i];
    t->dc[1].build(10, 12, codes, lens);
  });
  return *t;
}

// Tables B.2-B.4 as flags; -1 for a code outside them
int read_mb_type(Bits& b, int pict_type) {
  if (pict_type == kI) {
    if (b.bit()) return kIntra;
    return b.bit() ? (kIntra | kQuant) : -1;
  }
  const uint32_t v = b.peek(6);
  if (pict_type == kP) {
    if (v >> 5) { b.skip(1); return kFwd | kCbp; }
    if (v >> 4) { b.skip(2); return kZeroMv | kFwd | kCbp; }
    if (v >> 3) { b.skip(3); return kFwd; }
    if (v >> 1 == 3) { b.skip(5); return kIntra; }
    if (v >> 1 == 2) { b.skip(5); return kQuant | kFwd | kCbp; }
    if (v >> 1 == 1) { b.skip(5); return kQuant | kZeroMv | kFwd | kCbp; }
    if (v == 1) { b.skip(6); return kQuant | kIntra; }
    return -1;
  }
  switch (v >> 4) {
    case 2: b.skip(2); return kFwd | kBack;
    case 3: b.skip(2); return kFwd | kBack | kCbp;
    default: break;
  }
  switch (v >> 3) {
    case 2: b.skip(3); return kBack;
    case 3: b.skip(3); return kBack | kCbp;
    default: break;
  }
  switch (v >> 2) {
    case 2: b.skip(4); return kFwd;
    case 3: b.skip(4); return kFwd | kCbp;
    default: break;
  }
  if (v >> 1 == 3) { b.skip(5); return kIntra; }
  if (v >> 1 == 2) { b.skip(5); return kQuant | kFwd | kBack | kCbp; }
  if (v == 3) { b.skip(6); return kQuant | kFwd | kCbp; }
  if (v == 2) { b.skip(6); return kQuant | kBack | kCbp; }
  if (v == 1) { b.skip(6); return kQuant | kIntra; }
  return -1;
}

inline int sign_extend(int v, int bits) {
  return int(uint32_t(v) << (32 - bits)) >> (32 - bits);
}

// ---------------------------------------------------------------- motion compensation

// FFmpeg's hpeldsp with rounding: a w x h block at half-sample phase dxy
// (bit 0 horizontal, bit 1 vertical), put, or averaged into dst
void hpel(uint8_t* dst, int ds, const uint8_t* src, int ss, int w, int h, int dxy, bool avg) {
  for (int j = 0; j < h; j++) {
    const uint8_t* s0 = src + int64_t(j) * ss;
    const uint8_t* s1 = s0 + ss;
    uint8_t* d = dst + int64_t(j) * ds;
    for (int i = 0; i < w; i++) {
      int v;
      switch (dxy) {
        case 0: v = s0[i]; break;
        case 1: v = (s0[i] + s0[i + 1] + 1) >> 1; break;
        case 2: v = (s0[i] + s1[i] + 1) >> 1; break;
        default: v = (s0[i] + s0[i + 1] + s1[i] + s1[i + 1] + 2) >> 2; break;
      }
      d[i] = uint8_t(avg ? (d[i] + v + 1) >> 1 : v);
    }
  }
}

}  // namespace

// ---------------------------------------------------------------- decoder

struct Mpeg12Decoder::Impl {
  Mpeg12State st;
  int pict_type = 0;
  // pictures: 0-3 the pool, 4 the grey past reference of a B-picture
  // decoded without one
  Picture pool[5];
  int64_t pool_tag[5] = {-1, -1, -1, -1, -1};
  int last = -1, next = -1, cur = -1, out = -1;
  bool allocated = false;  // set up for the sequence's size
  int alloc_w = 0, alloc_h = 0, alloc_aspect = -1, alloc_chroma = 0, alloc_prog = -1;
  int mb_width = 0, mb_height = 0;
  // cleared by a flush
  bool closed_gop = false, sync = false;
  // slice state
  int qscale = 0;
  int last_dc[3] = {0, 0, 0};
  int last_mv[2][2][2] = {};
  int mv[2][2][2] = {};
  int field_select[2][2] = {};
  int mv_dir = 0, mv_field = 0;  // mv_field: two field vectors a direction
  int interlaced_dct = 0;
  int mb_intra = 0;
  alignas(16) int16_t block[8][64];
  int block_last[8];
  std::vector<uint8_t> mb_done;
  std::string err;
  int last_type_ = 0;
  bool last_decoded_ = false;

  int invalid(const char* what) {
    err = std::string("damaged MPEG-1/2 stream (") + what + ")";
    return kInvalid;
  }
  int unsupported(const std::string& what) {
    err = what + ": the port decodes MPEG-1/2 frame pictures in 4:2:0 and 4:2:2; the rest is "
                 "ROADMAP.md Queue 1 item 8b";
    return kUnsupported;
  }

  int block_count() const { return 4 + (1 << st.chroma_format); }

  static void load_matrix(Bits& b, uint16_t* m0, uint16_t* m1, bool intra, bool* bad) {
    for (int i = 0; i < 64; i++) {
      const int j = kZigzag[i];
      int v = int(b.get(8));
      if (v == 0) *bad = true;
      if (intra && i == 0 && v != 8) v = 8;
      m0[j] = uint16_t(v);
      if (m1) m1[j] = uint16_t(v);
    }
  }

  int sequence_header(const uint8_t* p, size_t n) {
    Bits b(p, n);
    const int w = int(b.get(12)), h = int(b.get(12));
    st.aspect = int(b.get(4));
    st.frame_rate_index = int(b.get(4));
    if (st.frame_rate_index == 0 || st.frame_rate_index > 13) st.frame_rate_index = 1;
    st.bit_rate = int64_t(b.get(18)) * 400;
    if (!b.bit()) return invalid("sequence header marker");
    b.skip(10 + 1);
    bool bad = false;
    if (b.bit()) {
      load_matrix(b, st.chroma_intra, st.intra, true, &bad);
    } else {
      for (int i = 0; i < 64; i++) st.intra[i] = st.chroma_intra[i] = kDefaultIntraMatrix[i];
    }
    if (b.bit()) {
      load_matrix(b, st.chroma_inter, st.inter, false, &bad);
    } else {
      for (int i = 0; i < 64; i++) st.inter[i] = st.chroma_inter[i] = 16;
    }
    if (bad) return invalid("quantiser matrix");
    if (b.peek(23) != 0) return invalid("sequence header");
    st.width = w;
    st.height = h;
    // MPEG-1 as MPEG-2 with these parameters, until an extension says
    // otherwise
    st.progressive_sequence = 1;
    st.progressive_frame = 1;
    st.picture_structure = 3;
    st.frame_pred_frame_dct = 1;
    st.chroma_format = 1;
    st.mpeg2 = false;
    st.seen = true;
    return kOk;
  }

  int extension(const uint8_t* p, size_t n, int last_code) {
    Bits b(p, n);
    const int id = int(b.get(4));
    if (id == 1 && last_code == 0) {
      b.skip(1 + 3 + 4);  // profile and level
      st.progressive_sequence = b.bit();
      st.chroma_format = int(b.get(2));
      if (!st.chroma_format) st.chroma_format = 1;
      st.width |= int(b.get(2)) << 12;
      st.height |= int(b.get(2)) << 12;
      st.bit_rate += (int64_t(b.get(12)) << 18) * 400;
      b.skip(1 + 8);  // marker, vbv_buffer_size_extension
      st.low_delay = b.bit();
      st.frame_rate_ext_n = int(b.get(2)) + 1;
      st.frame_rate_ext_d = int(b.get(5)) + 1;
      st.mpeg2 = true;
    } else if (id == 3) {
      bool bad = false;
      if (b.bit()) load_matrix(b, st.chroma_intra, st.intra, true, &bad);
      if (b.bit()) load_matrix(b, st.chroma_inter, st.inter, false, &bad);
      if (b.bit()) load_matrix(b, st.chroma_intra, nullptr, true, &bad);
      if (b.bit()) load_matrix(b, st.chroma_inter, nullptr, false, &bad);
      if (bad) return invalid("quantiser matrix");
    } else if (id == 8 && last_code == 0x100) {
      st.full_pel[0] = st.full_pel[1] = 0;
      for (int i = 0; i < 2; i++)
        for (int k = 0; k < 2; k++) {
          st.f_code[i][k] = int(b.get(4));
          st.f_code[i][k] += !st.f_code[i][k];
        }
      st.intra_dc_precision = int(b.get(2));
      st.picture_structure = int(b.get(2));
      b.skip(1);  // top_field_first
      st.frame_pred_frame_dct = b.bit();
      st.concealment_mv = b.bit();
      st.q_scale_type = b.bit();
      st.intra_vlc_format = b.bit();
      st.alternate_scan = b.bit();
      b.skip(2);  // repeat_first_field, chroma_420_type
      st.progressive_frame = b.bit();
    } else if (id == 5 || id == 9 || id == 10) {
      // sequence scalable, picture spatial and temporal scalable
      return unsupported("MPEG-2 scalable extension");
    }
    return kOk;
  }

  // mpeg_decode_postinit: sets the decoder up for the sequence, dropping
  // every picture when its size (or form) changes
  int postinit() {
    const int prog = st.progressive_sequence;
    const bool align_differs = ((st.height + 15) & ~15) != ((st.height + 31) & ~31);
    if (allocated && alloc_w == st.width && alloc_h == st.height && alloc_aspect == st.aspect &&
        alloc_chroma == st.chroma_format && !(alloc_prog != prog && align_differs))
      return kOk;
    last = next = cur = -1;
    allocated = false;
    if (st.width <= 0 || st.height <= 0 ||
        (int64_t(st.width) + 128) * (int64_t(st.height) + 128) >= INT32_MAX / 8)
      return invalid("frame size");
    if (st.chroma_format == 3) return unsupported("MPEG-2 4:4:4");
    mb_width = (st.width + 15) / 16;
    mb_height = st.mpeg2 && !prog ? 2 * ((st.height + 31) / 32) : (st.height + 15) / 16;
    allocated = true;
    alloc_w = st.width;
    alloc_h = st.height;
    alloc_aspect = st.aspect;
    alloc_chroma = st.chroma_format;
    alloc_prog = prog;
    return kOk;
  }

  // 0 when the picture is to be ignored, as FFmpeg ignores it
  int picture_header(const uint8_t* p, size_t n) {
    Bits b(p, n);
    b.skip(10);  // temporal_reference
    pict_type = int(b.get(3));
    if (pict_type == 4) return unsupported("MPEG-1 D-picture");
    if (pict_type == 0 || pict_type > 3) {
      pict_type = 0;
      return kOk;
    }
    b.skip(16);  // vbv_delay
    if (pict_type == kP || pict_type == kB) {
      st.full_pel[0] = b.bit();
      int f = int(b.get(3));
      f += !f;
      st.f_code[0][0] = st.f_code[0][1] = f;
    }
    if (pict_type == kB) {
      st.full_pel[1] = b.bit();
      int f = int(b.get(3));
      f += !f;
      st.f_code[1][0] = st.f_code[1][1] = f;
    }
    return kOk;
  }

  // A picture's macroblock-aligned canvas for the sequence's size and
  // chroma format
  void canvas(Picture& p) const {
    const int cw = mb_width * 8, ch = st.chroma_format == 1 ? mb_height * 8 : mb_height * 16;
    p.format = st.chroma_format == 1 ? kYuv420p : kYuv422p;
    p.width = st.width;
    p.height = st.height;
    p.stride_y = mb_width * 16;
    p.rows_y = mb_height * 16;
    p.stride_c = cw;
    p.rows_c = ch;
    p.y.resize(size_t(p.stride_y) * p.rows_y);
    p.u.resize(size_t(cw) * ch);
    p.v.resize(size_t(cw) * ch);
  }

  // ff_mpv_frame_start: the picture's buffer and its references (the
  // buffers only when the picture is decoded)
  int field_start(size_t packet_size, int64_t tag, bool headers_only) {
    if (int64_t(mb_width) * mb_height * 11 / (33 * 2 * 8) > int64_t(packet_size))
      return invalid("picture shorter than its size allows");
    if (pict_type != kB && last >= 0 && last != next) last = -1;
    cur = -1;
    for (int i = 0; i < 4; i++)
      if (i != last && i != next) {
        cur = i;
        break;
      }
    pool_tag[cur] = tag;
    if (!headers_only) canvas(pool[cur]);
    if (pict_type != kB) {
      last = next;
      next = cur;
    }
    if (last < 0 && pict_type != kI) {
      if (pict_type == kP) return unsupported("a P-picture without its reference picture");
      // FFmpeg's grey past reference
      if (!headers_only) {
        Picture& g = pool[4];
        canvas(g);
        std::fill(g.y.begin(), g.y.end(), 0x80);
        std::fill(g.u.begin(), g.u.end(), 0x80);
        std::fill(g.v.begin(), g.v.end(), 0x80);
      }
      last = 4;
    }
    if (next < 0 && pict_type == kB) return invalid("a B-picture without a future reference");
    if (!headers_only) mb_done.assign(size_t(mb_width) * mb_height, 0);
    return kOk;
  }

  int get_qscale(Bits& b) const {
    const int q = int(b.get(5));
    return st.q_scale_type ? kNonLinearQscale[q] : q << 1;
  }

  // mpeg_decode_motion; 0xffff for a code outside Table B.10
  int decode_motion(Bits& b, int fcode, int pred) const {
    const int code = tables().motion.read(b);
    if (code == 0) return pred;
    if (code < 0) return 0xffff;
    const int sign = b.bit();
    const int shift = fcode - 1;
    int val = code;
    if (shift) {
      val = (val - 1) << shift;
      val |= int(b.get(shift));
      val++;
    }
    if (sign) val = -val;
    val += pred;
    return sign_extend(val, 5 + shift);
  }

  int decode_dc(Bits& b, int component) const {
    const int code = tables().dc[component ? 1 : 0].read(b);
    if (code < 0) return 0xffff;
    if (code == 0) return 0;
    const uint32_t v = b.get(code);
    // get_xbits: a leading 0 makes the value negative
    return (v >> (code - 1)) ? int(v) : int(v) - ((1 << code) - 1);
  }

  const uint8_t* scan() const { return st.alternate_scan ? kAlternateScan : kZigzag; }

  // ff_mpeg1_decode_block_intra
  int mpeg1_intra(Bits& b, int16_t* blk, int n) {
    const int component = n <= 3 ? 0 : n - 4 + 1;
    const int diff = decode_dc(b, component);
    if (diff >= 0xffff) return invalid("DC code");
    int dc = last_dc[component] + diff;
    last_dc[component] = dc;
    blk[0] = int16_t(dc * st.intra[0]);
    const AcEntry* tab = tables().ac[0];
    const uint8_t* sc = scan();
    int i = 0;
    if ((b.peek32() >> 30) != 2) {
      while (true) {
        const AcEntry& e = tab[b.peek(16)];
        if (!e.len) return invalid("coefficient code");
        b.skip(e.len);
        int level = e.level, j;
        if (level != 0) {
          i += e.run;
          if (i > 63) return invalid("coefficient run");
          j = sc[i];
          level = (level * qscale * st.intra[j]) >> 4;
          level = (level - 1) | 1;
          if (b.bit()) level = -level;
        } else {
          i += int(b.get(6)) + 1;
          level = int(b.peek_signed(8));
          b.skip(8);
          if (level == -128) level = int(b.get(8)) - 256;
          else if (level == 0) level = int(b.get(8));
          if (i > 63) return invalid("coefficient run");
          j = sc[i];
          if (level < 0) {
            level = -level;
            level = (level * qscale * st.intra[j]) >> 4;
            level = (level - 1) | 1;
            level = -level;
          } else {
            level = (level * qscale * st.intra[j]) >> 4;
            level = (level - 1) | 1;
          }
        }
        blk[j] = int16_t(level);
        if ((b.peek32() >> 30) == 2) break;
      }
    }
    b.skip(2);
    block_last[n] = i;
    return kOk;
  }

  // mpeg1_decode_block_inter
  int mpeg1_inter(Bits& b, int16_t* blk, int n) {
    const AcEntry* tab = tables().ac[0];
    const uint8_t* sc = scan();
    const uint16_t* m = st.inter;
    int i = -1;
    bool done = false;
    if (b.peek32() >> 31) {
      int level = (3 * qscale * m[0]) >> 5;
      level = (level - 1) | 1;
      if ((b.peek32() >> 30) & 1) level = -level;
      blk[0] = int16_t(level);
      i++;
      b.skip(2);
      done = (b.peek32() >> 30) == 2;
    }
    while (!done) {
      const AcEntry& e = tab[b.peek(16)];
      if (!e.len) return invalid("coefficient code");
      b.skip(e.len);
      int level = e.level, j;
      if (level != 0) {
        i += e.run;
        if (i > 63) return invalid("coefficient run");
        j = sc[i];
        level = ((level * 2 + 1) * qscale * m[j]) >> 5;
        level = (level - 1) | 1;
        if (b.bit()) level = -level;
      } else {
        i += int(b.get(6)) + 1;
        level = int(b.peek_signed(8));
        b.skip(8);
        if (level == -128) level = int(b.get(8)) - 256;
        else if (level == 0) level = int(b.get(8));
        if (i > 63) return invalid("coefficient run");
        j = sc[i];
        if (level < 0) {
          level = -level;
          level = ((level * 2 + 1) * qscale * m[j]) >> 5;
          level = (level - 1) | 1;
          level = -level;
        } else {
          level = ((level * 2 + 1) * qscale * m[j]) >> 5;
          level = (level - 1) | 1;
        }
      }
      blk[j] = int16_t(level);
      if ((b.peek32() >> 30) == 2) break;
    }
    b.skip(2);
    block_last[n] = i;
    return kOk;
  }

  // mpeg2_decode_block_intra
  int mpeg2_intra(Bits& b, int16_t* blk, int n) {
    const uint16_t* m = n < 4 ? st.intra : st.chroma_intra;
    const int component = n < 4 ? 0 : (n & 1) + 1;
    const int diff = decode_dc(b, component);
    if (diff >= 0xffff) return invalid("DC code");
    int dc = last_dc[component] + diff;
    last_dc[component] = dc;
    blk[0] = int16_t(dc * (1 << (3 - st.intra_dc_precision)));
    int mismatch = blk[0] ^ 1;
    const AcEntry* tab = tables().ac[st.intra_vlc_format ? 1 : 0];
    const uint8_t* sc = scan();
    int i = 0;
    while (true) {
      const AcEntry& e = tab[b.peek(16)];
      if (!e.len) return invalid("coefficient code");
      b.skip(e.len);
      int level = e.level, j;
      if (level == 127) break;
      if (level != 0) {
        i += e.run;
        if (i > 63) return invalid("coefficient run");
        j = sc[i];
        level = (level * qscale * m[j]) >> 4;
        if (b.bit()) level = -level;
      } else {
        i += int(b.get(6)) + 1;
        level = int(b.peek_signed(12));
        b.skip(12);
        if (i > 63) return invalid("coefficient run");
        j = sc[i];
        if (level < 0) level = -((-level * qscale * m[j]) >> 4);
        else level = (level * qscale * m[j]) >> 4;
      }
      mismatch ^= level;
      blk[j] = int16_t(level);
    }
    blk[63] ^= int16_t(mismatch & 1);
    block_last[n] = i;
    return kOk;
  }

  // mpeg2_decode_block_non_intra
  int mpeg2_inter(Bits& b, int16_t* blk, int n) {
    const uint16_t* m = n < 4 ? st.inter : st.chroma_inter;
    const AcEntry* tab = tables().ac[0];
    const uint8_t* sc = scan();
    int mismatch = 1;
    int i = -1;
    bool done = false;
    if (b.peek32() >> 31) {
      int level = (3 * qscale * m[0]) >> 5;
      if ((b.peek32() >> 30) & 1) level = -level;
      blk[0] = int16_t(level);
      mismatch ^= level;
      i++;
      b.skip(2);
      done = (b.peek32() >> 30) == 2;
    }
    while (!done) {
      const AcEntry& e = tab[b.peek(16)];
      if (!e.len) return invalid("coefficient code");
      b.skip(e.len);
      int level = e.level, j;
      if (level != 0) {
        i += e.run;
        if (i > 63) return invalid("coefficient run");
        j = sc[i];
        level = ((level * 2 + 1) * qscale * m[j]) >> 5;
        if (b.bit()) level = -level;
      } else {
        i += int(b.get(6)) + 1;
        level = int(b.peek_signed(12));
        b.skip(12);
        if (i > 63) return invalid("coefficient run");
        j = sc[i];
        if (level < 0) level = -(((-level * 2 + 1) * qscale * m[j]) >> 5);
        else level = ((level * 2 + 1) * qscale * m[j]) >> 5;
      }
      mismatch ^= level;
      blk[j] = int16_t(level);
      if ((b.peek32() >> 30) == 2) break;
    }
    b.skip(2);
    blk[63] ^= int16_t(mismatch & 1);
    block_last[n] = i;
    return kOk;
  }

  void clear_blocks() {
    memset(block, 0, sizeof(block));
    for (int& k : block_last) k = -1;
  }

  // mpeg_decode_mb for a coded macroblock
  int decode_mb(Bits& b) {
    const int mb_type = read_mb_type(b, pict_type);
    if (mb_type < 0) return invalid("macroblock type");
    const int count = block_count();
    if (mb_type & kIntra) {
      clear_blocks();
      if (!st.frame_pred_frame_dct) interlaced_dct = b.bit();
      if (mb_type & kQuant) qscale = get_qscale(b);
      if (st.concealment_mv) {
        for (int k = 0; k < 2; k++) {
          const int v = decode_motion(b, st.f_code[0][k], last_mv[0][0][k]);
          if (v == 0xffff) return invalid("motion code");
          mv[0][0][k] = last_mv[0][0][k] = last_mv[0][1][k] = v;
        }
        b.skip(1);  // marker
      } else {
        memset(last_mv, 0, sizeof(last_mv));
      }
      mb_intra = 1;
      for (int i = 0; i < (st.mpeg2 ? count : 6); i++) {
        int r = st.mpeg2 ? mpeg2_intra(b, block[i], i) : mpeg1_intra(b, block[i], i);
        if (r < 0) return r;
      }
      return kOk;
    }
    if (mb_type & kZeroMv) {
      mv_dir = 1;
      if (!st.frame_pred_frame_dct) interlaced_dct = b.bit();
      mv_field = 0;
      if (mb_type & kQuant) qscale = get_qscale(b);
      memset(last_mv[0], 0, sizeof(last_mv[0]));
      mv[0][0][0] = mv[0][0][1] = 0;
    } else {
      int motion_type = 2;
      if (!st.frame_pred_frame_dct) {
        motion_type = int(b.get(2));
        if (mb_type & kCbp) interlaced_dct = b.bit();
      }
      if (mb_type & kQuant) qscale = get_qscale(b);
      mv_dir = (mb_type & kFwd ? 1 : 0) | (mb_type & kBack ? 2 : 0);
      if (motion_type == 2) {
        mv_field = 0;
        for (int i = 0; i < 2; i++) {
          if (!(mv_dir & (1 << i))) continue;
          for (int k = 0; k < 2; k++) {
            const int v = decode_motion(b, st.f_code[i][k], last_mv[i][0][k]);
            if (v == 0xffff) return invalid("motion code");
            mv[i][0][k] = last_mv[i][0][k] = last_mv[i][1][k] = v;
          }
          if (st.full_pel[i]) {
            mv[i][0][0] *= 2;
            mv[i][0][1] *= 2;
          }
        }
      } else if (motion_type == 1) {
        mv_field = 1;
        for (int i = 0; i < 2; i++) {
          if (!(mv_dir & (1 << i))) continue;
          for (int j = 0; j < 2; j++) {
            field_select[i][j] = b.bit();
            int v = decode_motion(b, st.f_code[i][0], last_mv[i][j][0]);
            if (v == 0xffff) return invalid("motion code");
            last_mv[i][j][0] = mv[i][j][0] = v;
            v = decode_motion(b, st.f_code[i][1], last_mv[i][j][1] >> 1);
            if (v == 0xffff) return invalid("motion code");
            last_mv[i][j][1] = 2 * v;
            mv[i][j][1] = v;
          }
        }
      } else if (motion_type == 3) {
        if (st.progressive_sequence) return invalid("dual prime in a progressive sequence");
        return unsupported("MPEG-2 dual-prime motion");
      } else {
        return invalid("motion type");
      }
    }
    mb_intra = 0;
    clear_blocks();
    if (mb_type & kCbp) {
      int cbp = tables().pattern.read(b);
      if (count > 6) {
        cbp = cbp * (1 << (count - 6));
        cbp |= int(b.get(count - 6));
      }
      if (cbp <= 0) return invalid("coded block pattern");
      if (st.mpeg2) {
        cbp <<= 12 - count;
        for (int i = 0; i < count; i++) {
          if (cbp & (1 << 11)) {
            int r = mpeg2_inter(b, block[i], i);
            if (r < 0) return r;
          }
          cbp += cbp;
        }
      } else {
        for (int i = 0; i < 6; i++) {
          if (cbp & 32) {
            int r = mpeg1_inter(b, block[i], i);
            if (r < 0) return r;
          }
          cbp += cbp;
        }
      }
    }
    return kOk;
  }

  // mpeg_motion_internal: one prediction of a 16x16 macroblock (h 16) or
  // of one of its fields (h 8)
  bool motion(int mb_x, int mb_y, int ref, bool avg, int field_based, int bottom, int fsel,
              int mx, int my, int h) {
    const Picture& r = pool[ref];
    Picture& d = pool[cur];
    const int v_edge = (mb_height * 16) >> field_based, h_edge = mb_width * 16;
    const int ls = r.stride_y << field_based, uvls = r.stride_c << field_based;
    const int dxy = ((my & 1) << 1) | (mx & 1);
    const int src_x = mb_x * 16 + (mx >> 1);
    const int src_y = (mb_y << (4 - field_based)) + (my >> 1);
    int uvdxy, uvsrc_x, uvsrc_y;
    const int cmx = mx / 2;
    if (st.chroma_format == 1) {
      const int cmy = my / 2;
      uvdxy = ((cmy & 1) << 1) | (cmx & 1);
      uvsrc_x = mb_x * 8 + (cmx >> 1);
      uvsrc_y = (mb_y << (3 - field_based)) + (cmy >> 1);
    } else {
      uvdxy = ((my & 1) << 1) | (cmx & 1);
      uvsrc_x = mb_x * 8 + (cmx >> 1);
      uvsrc_y = src_y;
    }
    if (unsigned(src_x) >= unsigned(std::max(h_edge - (mx & 1) - 15, 0)) ||
        unsigned(src_y) >= unsigned(std::max(v_edge - (my & 1) - h + 1, 0)))
      return false;
    const int cy_shift = st.chroma_format == 1 ? 1 : 0;
    uint8_t* dy = d.y.data() + int64_t(mb_y) * 16 * d.stride_y + mb_x * 16;
    uint8_t* du = d.u.data() + int64_t(mb_y) * (16 >> cy_shift) * d.stride_c + mb_x * 8;
    uint8_t* dv = d.v.data() + int64_t(mb_y) * (16 >> cy_shift) * d.stride_c + mb_x * 8;
    const uint8_t* py = r.y.data() + int64_t(src_y) * ls + src_x;
    const uint8_t* pu = r.u.data() + int64_t(uvsrc_y) * uvls + uvsrc_x;
    const uint8_t* pv = r.v.data() + int64_t(uvsrc_y) * uvls + uvsrc_x;
    if (bottom) {
      dy += d.stride_y;
      du += d.stride_c;
      dv += d.stride_c;
    }
    if (fsel) {
      py += r.stride_y;
      pu += r.stride_c;
      pv += r.stride_c;
    }
    hpel(dy, ls, py, ls, 16, h, dxy, avg);
    hpel(du, uvls, pu, uvls, 8, h >> cy_shift, uvdxy, avg);
    hpel(dv, uvls, pv, uvls, 8, h >> cy_shift, uvdxy, avg);
    return true;
  }

  // ff_mpv_reconstruct_mb
  int reconstruct(int mb_x, int mb_y) {
    if (!mb_intra) last_dc[0] = last_dc[1] = last_dc[2] = 128 << st.intra_dc_precision;
    Picture& d = pool[cur];
    const int ls = d.stride_y, uvls = d.stride_c;
    const int cy = st.chroma_format == 1 ? 8 : 16;
    uint8_t* dy = d.y.data() + int64_t(mb_y) * 16 * ls + mb_x * 16;
    uint8_t* du = d.u.data() + int64_t(mb_y) * cy * uvls + mb_x * 8;
    uint8_t* dv = d.v.data() + int64_t(mb_y) * cy * uvls + mb_x * 8;
    const int dct_ls = interlaced_dct ? ls * 2 : ls;
    const int dct_off = interlaced_dct ? ls : ls * 8;
    auto blocks = [&](void (*op)(int16_t*, uint8_t*, int), bool only_coded) {
      uint8_t* dst[4] = {dy, dy + 8, dy + dct_off, dy + dct_off + 8};
      for (int i = 0; i < 4; i++)
        if (!only_coded || block_last[i] >= 0) op(block[i], dst[i], dct_ls);
      if (st.chroma_format == 1) {
        if (!only_coded || block_last[4] >= 0) op(block[4], du, uvls);
        if (!only_coded || block_last[5] >= 0) op(block[5], dv, uvls);
      } else {
        const int cls = dct_ls >> 1, coff = dct_off >> 1;
        uint8_t* cdst[4] = {du, dv, du + coff, dv + coff};
        for (int i = 0; i < 4; i++)
          if (!only_coded || block_last[4 + i] >= 0) op(block[4 + i], cdst[i], cls);
      }
    };
    if (mb_intra) {
      blocks(simple_idct_put, false);
      return kOk;
    }
    bool avg = false;
    for (int dir = 0; dir < 2; dir++) {
      if (!(mv_dir & (1 << dir))) continue;
      const int ref = dir ? next : last;
      bool ok;
      if (!mv_field) {
        ok = motion(mb_x, mb_y, ref, avg, 0, 0, 0, mv[dir][0][0], mv[dir][0][1], 16);
      } else {
        ok = motion(mb_x, mb_y, ref, avg, 1, 0, field_select[dir][0], mv[dir][0][0],
                    mv[dir][0][1], 8) &&
             motion(mb_x, mb_y, ref, avg, 1, 1, field_select[dir][1], mv[dir][1][0],
                    mv[dir][1][1], 8);
      }
      if (!ok) return invalid("motion vector out of the picture");
      avg = true;
    }
    blocks(simple_idct_add, true);
    return kOk;
  }

  // mpeg_decode_slice
  int decode_slice(int mb_y, const uint8_t* p, size_t n) {
    Bits b(p, n);
    if (st.mpeg2 && mb_height > 2800 / 16) b.skip(3);
    last_dc[0] = last_dc[1] = last_dc[2] = 1 << (7 + st.intra_dc_precision);
    memset(last_mv, 0, sizeof(last_mv));
    interlaced_dct = 0;
    qscale = get_qscale(b);
    if (qscale == 0) return invalid("quantiser scale 0");
    // extra_information_slice
    if (b.left() <= 0) return invalid("slice header");
    while (b.bit()) {
      b.skip(8);
      if (b.left() <= 0) return invalid("slice header");
    }
    int mb_x = 0;
    const Tables& t = tables();
    while (b.left() > 0) {
      const int code = t.incr.read(b);
      if (code < 0) return invalid("first macroblock address increment");
      if (code >= 33) {
        if (code == 33) mb_x += 33;
      } else {
        mb_x += code;
        break;
      }
    }
    if (mb_x >= mb_width) return invalid("initial skip overflow");
    int skip_run = 0;
    mb_intra = 0;
    while (true) {
      if (skip_run-- == 0) {
        const int r = decode_mb(b);
        if (r < 0) return r;
      }
      const int r = reconstruct(mb_x, mb_y);
      if (r < 0) return r;
      mb_done[size_t(mb_y) * mb_width + mb_x] = 1;
      if (++mb_x >= mb_width) {
        mb_x = 0;
        mb_y++;
        if (mb_y >= mb_height) {
          const int64_t left = b.left();
          if (left < 0 || (left && b.peek(int(std::min<int64_t>(left, 23))) != 0))
            return invalid("data after the last macroblock");
          break;
        }
        const int64_t left = b.left();
        if (mb_y >= ((st.height + 15) >> 4) && !st.progressive_sequence && left <= 25 &&
            left >= 0 && skip_run == -1 && (!left || b.peek(int(left)) == 0))
          break;
      }
      if (skip_run == -1) {
        skip_run = 0;
        bool end = false;
        while (true) {
          const int code = t.incr.read(b);
          if (code < 0) return invalid("macroblock address increment");
          if (code >= 33) {
            if (code == 33) {
              skip_run += 33;
            } else if (code == 35) {
              if (skip_run != 0 || b.peek(15) != 0) return invalid("slice end");
              end = true;
              break;
            }
          } else {
            skip_run += code;
            break;
          }
        }
        if (end) break;
        if (skip_run) {
          if (pict_type == kI) return invalid("skipped macroblock in an I-picture");
          if (pict_type == kB && mb_intra) return invalid("skip after an intra macroblock");
          mb_intra = 0;
          for (int& k : block_last) k = -1;
          mv_field = 0;
          if (pict_type == kP) {
            mv_dir = 1;
            mv[0][0][0] = mv[0][0][1] = 0;
            memset(last_mv[0], 0, sizeof(last_mv[0]));
            field_select[0][0] = 0;
          } else {
            mv[0][0][0] = last_mv[0][0][0];
            mv[0][0][1] = last_mv[0][0][1];
            mv[1][0][0] = last_mv[1][0][0];
            mv[1][0][1] = last_mv[1][0][1];
            field_select[0][0] = field_select[1][0] = 0;
          }
        }
      }
    }
    if (b.left() < 0) return invalid("overread");
    return kOk;
  }

  int decode_packet(const uint8_t* p, size_t n, int64_t tag, bool headers_only) {
    out = -1;
    last_type_ = 0;
    last_decoded_ = false;
    int last_code = 0;  // 0, 0x100 after a picture header, 0x101 after a slice
    bool picture_seen = false, skip_frame = false, first_slice = false, decoded = false;
    size_t i = 0;
    while (true) {
      size_t k = i;
      while (k + 3 < n && !(p[k] == 0 && p[k + 1] == 0 && p[k + 2] == 1)) k++;
      if (k + 3 >= n) break;
      const int code = p[k + 3];
      const uint8_t* body = p + k + 4;
      const size_t blen = n - (k + 4);
      i = k + 4;
      if (code == kSeqStart) {
        if (last_code == 0) {
          const int r = sequence_header(body, blen);
          if (r < 0) return r;
        }
      } else if (code == kExtStart) {
        const int r = extension(body, blen, last_code);
        if (r < 0) return r;
      } else if (code == kGopStart) {
        if (last_code == 0) {
          Bits b(body, blen);
          b.skip(25);
          closed_gop = b.bit();
          sync = true;
        }
      } else if (code == kPictureStart) {
        if (picture_seen && st.picture_structure == 3) continue;  // an extra picture
        picture_seen = true;
        if (!st.seen || st.width <= 0 || st.height <= 0) return invalid("no sequence header");
        if (last_code == 0 || last_code == 0x101) {
          int r = postinit();
          if (r < 0) return r;
          r = picture_header(body, blen);
          if (r < 0) return r;
          last_type_ = pict_type;
          first_slice = true;
          last_code = 0x100;
        }
      } else if (code >= 0x01 && code <= 0xaf && last_code != 0) {
        if (last_code == 0x100) {
          if (st.progressive_sequence && !st.progressive_frame) st.progressive_frame = 1;
          if (st.picture_structure == 0 || (st.progressive_frame && st.picture_structure != 3))
            st.picture_structure = 3;
          if (st.picture_structure != 3) return unsupported("MPEG-2 field pictures");
        }
        last_code = 0x101;
        int mb_y = code - 1;
        if (st.mpeg2 && mb_height > 2800 / 16) mb_y += (blen ? (body[0] & 0xe0) : 0) << 2;
        if (blen < 2) return invalid("slice too small");
        if (mb_y >= mb_height) return invalid("slice below the picture");
        if (last < 0 && pict_type == kB && !closed_gop) {
          skip_frame = true;
          continue;
        }
        if (pict_type == kI) sync = true;
        if (next < 0 && pict_type == kP && !sync) {
          skip_frame = true;
          continue;
        }
        if (!pict_type) continue;
        if (first_slice) {
          skip_frame = false;
          first_slice = false;
          const int r = field_start(n, tag, headers_only);
          if (r < 0) return r;
          decoded = true;
        }
        if (!headers_only) {
          const int r = decode_slice(mb_y, body, blen);
          if (r < 0) return r;
        }
      }
    }
    last_decoded_ = decoded;
    if (skip_frame || !decoded) return 0;
    // slice_end: the picture is complete
    if (!headers_only)
      for (uint8_t done : mb_done)
        if (!done) return invalid("missing slices");
    if (pict_type == kB || st.low_delay) out = cur;
    else if (last >= 0) out = last;
    return out >= 0 ? 1 : 0;
  }
};

Mpeg12Decoder::Mpeg12Decoder() : impl_(new Impl()) { tables(); }
Mpeg12Decoder::~Mpeg12Decoder() { delete impl_; }

int Mpeg12Decoder::decode_packet(const uint8_t* p, size_t n, int64_t tag, bool headers_only,
                                 std::string* msg) {
  const int r = impl_->decode_packet(p, n, tag, headers_only);
  if (r < 0 && msg) *msg = impl_->err;
  return r;
}

int Mpeg12Decoder::drain() {
  Impl& d = *impl_;
  d.out = -1;
  if (!d.st.low_delay && d.next >= 0) {
    d.out = d.next;
    d.next = -1;
    return 1;
  }
  return 0;
}

void Mpeg12Decoder::flush() {
  Impl& d = *impl_;
  d.last = d.next = d.cur = d.out = -1;
  d.closed_gop = false;
  d.sync = false;
}

const Picture& Mpeg12Decoder::output() const {
  Picture& p = impl_->pool[impl_->out];
  p.tag = impl_->pool_tag[impl_->out];
  return p;
}

Mpeg12State Mpeg12Decoder::state() const { return impl_->st; }
void Mpeg12Decoder::restore(const Mpeg12State& s) { impl_->st = s; }
int Mpeg12Decoder::last_type() const { return impl_->last_type_; }
bool Mpeg12Decoder::last_decoded() const { return impl_->last_decoded_; }

}  // namespace video
