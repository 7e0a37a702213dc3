// MPEG-4 Part 2 (ISO/IEC 14496-2) Simple and Advanced Simple Profile video
// decoder, written from the specification: VOS/VO/VOL headers, I-, P- and
// B-VOPs (including vop_coded 0; B-VOPs forward, backward, interpolated
// and direct, scaled by the VOP times), intra DC/AC prediction, the TCOEF
// VLCs with the three escape modes, H.263 and MPEG inverse quantisation,
// 1MV and 4MV motion with median prediction, half-sample compensation
// under the VOP's rounding control, unrestricted vectors over replicated
// edges, video packets (resync markers) and frame sizes that are not
// multiples of 16.
//
// Where the specification leaves the decoder a choice, the choices are
// those of the stream's reference decode, FFmpeg 5.1's ``mpeg4`` decoder on
// x86-64, so that the output is bit-equal to it:
//   * the inverse DCT is the "simple" integer IDCT (13-bit row pass,
//     20-bit column pass, a row holding only DC scaled by 8), which FFmpeg
//     selects by default, or Xvid's for a stream whose user data names
//     Xvid (or an XVID-tagged stream that names no encoder), as its
//     ff_mpeg4_workaround_bugs selects;
//   * in AVI (``decode_packet``) the packet layer of its h263dec.c: DivX
//     5's packed bitstreams, pictures shown in display order with a delay
//     of one unless low_delay, a B-VOP without its past reference skipped;
//   * intra coefficients are dequantised without the [-2048, 2047] clip,
//     and the MPEG quantiser's mismatch control is applied to inter blocks
//     only;
//   * the reference picture's edges replicate from the macroblock-aligned
//     size; an 8x8 luma vector is first clipped to [-16, width] (and the
//     combined chroma vector of 4MV to [-8, width/2]), dropping its half
//     sample at the far edge;
//   * prediction across video packets follows FFmpeg's first_slice_line
//     rules, and each new packet clears the AC predictors around it;
//   * half-sample averages without rounding (rounding_type 1) in one
//     direction use the SIMD form: the left (or odd-row) sample is reduced
//     by one with saturation, then averaged up.
// A stream the reference would conceal (a VLC or position error, an
// overread, a packet that ends early) is reported as damaged.

#include <algorithm>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#include "mpeg4_tables.h"
#include "video.h"

namespace video {
namespace {

using namespace mpeg4_tables;

// ---------------------------------------------------------------- bitstream

struct Bits {
  const uint8_t* p = nullptr;
  int64_t nbits = 0;
  int64_t pos = 0;
  Bits() = default;
  Bits(const uint8_t* d, size_t n) : p(d), nbits(int64_t(n) * 8) {}
  // up to 25 bits; zeros past the end
  uint32_t peek(int k) const {
    if (k == 0) return 0;
    int64_t byte = pos >> 3;
    uint32_t w = 0;
    for (int i = 0; i < 4; i++) {
      int64_t b = byte + i;
      w = (w << 8) | (b < (nbits >> 3) && b >= 0 ? p[b] : 0u);
    }
    return (w << (pos & 7)) >> (32 - k);
  }
  uint32_t get(int k) {
    uint32_t v = peek(k);
    pos += k;
    return v;
  }
  bool bit() { return get(1) != 0; }
  void skip(int64_t k) { pos += k; }
  int64_t left() const { return nbits - pos; }
  void align() { pos = (pos + 7) & ~int64_t(7); }
};

// ---------------------------------------------------------------- VLC tables

struct Vlc {
  int bits = 0;
  std::vector<int16_t> sym;
  std::vector<uint8_t> len;
  template <typename Entry>
  void build(const Entry* tab, int n, int nbits, int (*code_of)(const Entry&),
             int (*len_of)(const Entry&)) {
    bits = nbits;
    sym.assign(size_t(1) << nbits, -1);
    len.assign(size_t(1) << nbits, 0);
    for (int i = 0; i < n; i++) {
      int l = len_of(tab[i]);
      if (l == 0) continue;
      uint32_t first = uint32_t(code_of(tab[i])) << (nbits - l);
      uint32_t count = 1u << (nbits - l);
      for (uint32_t k = 0; k < count; k++) {
        sym[first + k] = int16_t(i);
        len[first + k] = uint8_t(l);
      }
    }
  }
  // symbol index, or -1 for a code not in the table
  int read(Bits& b) const {
    uint32_t v = b.peek(bits);
    int l = len[v];
    if (!l) return -1;
    b.skip(l);
    return sym[v];
  }
};

struct RlInfo {
  uint8_t max_level[2][64];  // LMAX by (last, run)
  uint8_t max_run[2][64];    // RMAX by (last, level)
};

struct Tables {
  Vlc intra_mcbpc, inter_mcbpc, cbpy, mv, dc_lum, dc_chrom, tcoef[2];
  RlInfo rl[2];  // 0 inter, 1 intra
};

int code_c(const Code& c) { return c.code; }
int len_c(const Code& c) { return c.len; }
int code_t(const TCoef& c) { return c.code; }
int len_t(const TCoef& c) { return c.len; }

const Tables& tables() {
  static Tables t;
  static std::once_flag once;
  std::call_once(once, [] {
    t.intra_mcbpc.build(kIntraMcbpc, 9, 9, code_c, len_c);
    t.inter_mcbpc.build(kInterMcbpc, 28, 13, code_c, len_c);
    t.cbpy.build(kCbpy, 16, 6, code_c, len_c);
    t.mv.build(kMv, 33, 12, code_c, len_c);
    t.dc_lum.build(kDcLum, 13, 11, code_c, len_c);
    t.dc_chrom.build(kDcChrom, 13, 12, code_c, len_c);
    const TCoef* src[2] = {kInterTCoef, kIntraTCoef};
    for (int k = 0; k < 2; k++) {
      TCoef with_esc[103];
      memcpy(with_esc, src[k], sizeof(TCoef) * 102);
      with_esc[102] = {kTCoefEscape.code, kTCoefEscape.len, 0, 0, 0};
      t.tcoef[k].build(with_esc, 103, 12, code_t, len_t);
      memset(&t.rl[k], 0, sizeof(RlInfo));
      for (int i = 0; i < 102; i++) {
        const TCoef& e = src[k][i];
        t.rl[k].max_level[e.last][e.run] = std::max<uint8_t>(t.rl[k].max_level[e.last][e.run], e.level);
        t.rl[k].max_run[e.last][e.level] = std::max<uint8_t>(t.rl[k].max_run[e.last][e.level], e.run);
      }
    }
  });
  return t;
}

// ---------------------------------------------------------------- simple IDCT

constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867, W7 = 4520;
constexpr int ROW_SHIFT = 11, COL_SHIFT = 20;

inline void idct_row(int16_t* row) {
  if (!(row[1] | row[2] | row[3] | row[4] | row[5] | row[6] | row[7])) {
    int16_t v = int16_t(uint16_t(uint32_t(row[0]) << 3));
    for (int i = 0; i < 8; i++) row[i] = v;
    return;
  }
  uint32_t a0 = uint32_t(W4) * uint32_t(row[0]) + (1u << (ROW_SHIFT - 1));
  uint32_t a1 = a0, a2 = a0, a3 = a0;
  a0 += uint32_t(W2) * uint32_t(row[2]);
  a1 += uint32_t(W6) * uint32_t(row[2]);
  a2 -= uint32_t(W6) * uint32_t(row[2]);
  a3 -= uint32_t(W2) * uint32_t(row[2]);
  uint32_t b0 = uint32_t(W1) * uint32_t(row[1]) + uint32_t(W3) * uint32_t(row[3]);
  uint32_t b1 = uint32_t(W3) * uint32_t(row[1]) - uint32_t(W7) * uint32_t(row[3]);
  uint32_t b2 = uint32_t(W5) * uint32_t(row[1]) - uint32_t(W1) * uint32_t(row[3]);
  uint32_t b3 = uint32_t(W7) * uint32_t(row[1]) - uint32_t(W5) * uint32_t(row[3]);
  a0 += uint32_t(W4) * uint32_t(row[4]) + uint32_t(W6) * uint32_t(row[6]);
  a1 += -uint32_t(W4) * uint32_t(row[4]) - uint32_t(W2) * uint32_t(row[6]);
  a2 += -uint32_t(W4) * uint32_t(row[4]) + uint32_t(W2) * uint32_t(row[6]);
  a3 += uint32_t(W4) * uint32_t(row[4]) - uint32_t(W6) * uint32_t(row[6]);
  b0 += uint32_t(W5) * uint32_t(row[5]) + uint32_t(W7) * uint32_t(row[7]);
  b1 += -uint32_t(W1) * uint32_t(row[5]) - uint32_t(W5) * uint32_t(row[7]);
  b2 += uint32_t(W7) * uint32_t(row[5]) + uint32_t(W3) * uint32_t(row[7]);
  b3 += uint32_t(W3) * uint32_t(row[5]) - uint32_t(W1) * uint32_t(row[7]);
  row[0] = int16_t(int32_t(a0 + b0) >> ROW_SHIFT);
  row[7] = int16_t(int32_t(a0 - b0) >> ROW_SHIFT);
  row[1] = int16_t(int32_t(a1 + b1) >> ROW_SHIFT);
  row[6] = int16_t(int32_t(a1 - b1) >> ROW_SHIFT);
  row[2] = int16_t(int32_t(a2 + b2) >> ROW_SHIFT);
  row[5] = int16_t(int32_t(a2 - b2) >> ROW_SHIFT);
  row[3] = int16_t(int32_t(a3 + b3) >> ROW_SHIFT);
  row[4] = int16_t(int32_t(a3 - b3) >> ROW_SHIFT);
}

inline uint8_t clip8(int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// column pass: out[k] for k = 0..7 down the column
inline void idct_col(const int16_t* col, int out[8]) {
  uint32_t a0 = uint32_t(W4) * uint32_t(col[0] + ((1 << (COL_SHIFT - 1)) / W4));
  uint32_t a1 = a0, a2 = a0, a3 = a0;
  a0 += uint32_t(W2) * uint32_t(col[16]);
  a1 += uint32_t(W6) * uint32_t(col[16]);
  a2 += -uint32_t(W6) * uint32_t(col[16]);
  a3 += -uint32_t(W2) * uint32_t(col[16]);
  uint32_t b0 = uint32_t(W1) * uint32_t(col[8]) + uint32_t(W3) * uint32_t(col[24]);
  uint32_t b1 = uint32_t(W3) * uint32_t(col[8]) - uint32_t(W7) * uint32_t(col[24]);
  uint32_t b2 = uint32_t(W5) * uint32_t(col[8]) - uint32_t(W1) * uint32_t(col[24]);
  uint32_t b3 = uint32_t(W7) * uint32_t(col[8]) - uint32_t(W5) * uint32_t(col[24]);
  a0 += uint32_t(W4) * uint32_t(col[32]);
  a1 += -uint32_t(W4) * uint32_t(col[32]);
  a2 += -uint32_t(W4) * uint32_t(col[32]);
  a3 += uint32_t(W4) * uint32_t(col[32]);
  b0 += uint32_t(W5) * uint32_t(col[40]);
  b1 += -uint32_t(W1) * uint32_t(col[40]);
  b2 += uint32_t(W7) * uint32_t(col[40]);
  b3 += uint32_t(W3) * uint32_t(col[40]);
  a0 += uint32_t(W6) * uint32_t(col[48]);
  a1 += -uint32_t(W2) * uint32_t(col[48]);
  a2 += uint32_t(W2) * uint32_t(col[48]);
  a3 += -uint32_t(W6) * uint32_t(col[48]);
  b0 += uint32_t(W7) * uint32_t(col[56]);
  b1 += -uint32_t(W5) * uint32_t(col[56]);
  b2 += uint32_t(W3) * uint32_t(col[56]);
  b3 += -uint32_t(W1) * uint32_t(col[56]);
  out[0] = int32_t(a0 + b0) >> COL_SHIFT;
  out[1] = int32_t(a1 + b1) >> COL_SHIFT;
  out[2] = int32_t(a2 + b2) >> COL_SHIFT;
  out[3] = int32_t(a3 + b3) >> COL_SHIFT;
  out[4] = int32_t(a3 - b3) >> COL_SHIFT;
  out[5] = int32_t(a2 - b2) >> COL_SHIFT;
  out[6] = int32_t(a1 - b1) >> COL_SHIFT;
  out[7] = int32_t(a0 - b0) >> COL_SHIFT;
}

}  // namespace

void simple_idct_put(int16_t* blk, uint8_t* dst, int stride) {
  for (int i = 0; i < 8; i++) idct_row(blk + 8 * i);
  int out[8];
  for (int i = 0; i < 8; i++) {
    idct_col(blk + i, out);
    for (int k = 0; k < 8; k++) dst[k * stride + i] = clip8(out[k]);
  }
}

void simple_idct_add(int16_t* blk, uint8_t* dst, int stride) {
  for (int i = 0; i < 8; i++) idct_row(blk + 8 * i);
  int out[8];
  for (int i = 0; i < 8; i++) {
    idct_col(blk + i, out);
    for (int k = 0; k < 8; k++) dst[k * stride + i] = clip8(dst[k * stride + i] + out[k]);
  }
}

namespace {

// ---------------------------------------------------------------- XviD IDCT
// FFmpeg's xvididct.c (the C form its SSE2 code reproduces): a row pass
// with per-row tables and rounding constants that carry the column pass's
// rounding, a zero row left untouched, and a column pass of 16-bit
// fixed-point tangent rotations.

constexpr int kXvidRowShift = 11, kXvidColShift = 6;
constexpr int kXvidRnd[8] = {65536, 3597, 2260, 1203, 0, 120, 512, 512};
constexpr int kXvidTab[4][7] = {{22725, 21407, 19266, 16384, 12873, 8867, 4520},
                                {31521, 29692, 26722, 22725, 17855, 12299, 6270},
                                {29692, 27969, 25172, 21407, 16819, 11585, 5906},
                                {26722, 25172, 22654, 19266, 15137, 10426, 5315}};
constexpr int kXvidRowTab[8] = {0, 1, 2, 3, 0, 3, 2, 1};

void xvid_row(int16_t* in, const int* tab, int rnd) {
  const unsigned c1 = tab[0], c2 = tab[1], c3 = tab[2], c4 = tab[3], c5 = tab[4], c6 = tab[5],
                 c7 = tab[6];
  const int right = in[5] | in[6] | in[7];
  const int left = in[1] | in[2] | in[3];
  if (!(right | in[4])) {
    const int k = int(c4 * unsigned(in[0]) + unsigned(rnd));
    if (left) {
      const unsigned a0 = unsigned(k) + c2 * unsigned(in[2]);
      const unsigned a1 = unsigned(k) + c6 * unsigned(in[2]);
      const unsigned a2 = unsigned(k) - c6 * unsigned(in[2]);
      const unsigned a3 = unsigned(k) - c2 * unsigned(in[2]);
      const unsigned b0 = c1 * unsigned(in[1]) + c3 * unsigned(in[3]);
      const unsigned b1 = c3 * unsigned(in[1]) - c7 * unsigned(in[3]);
      const unsigned b2 = c5 * unsigned(in[1]) - c1 * unsigned(in[3]);
      const unsigned b3 = c7 * unsigned(in[1]) - c5 * unsigned(in[3]);
      in[0] = int16_t(int(a0 + b0) >> kXvidRowShift);
      in[1] = int16_t(int(a1 + b1) >> kXvidRowShift);
      in[2] = int16_t(int(a2 + b2) >> kXvidRowShift);
      in[3] = int16_t(int(a3 + b3) >> kXvidRowShift);
      in[4] = int16_t(int(a3 - b3) >> kXvidRowShift);
      in[5] = int16_t(int(a2 - b2) >> kXvidRowShift);
      in[6] = int16_t(int(a1 - b1) >> kXvidRowShift);
      in[7] = int16_t(int(a0 - b0) >> kXvidRowShift);
    } else {
      const int a0 = k >> kXvidRowShift;
      if (a0)
        for (int i = 0; i < 8; i++) in[i] = int16_t(a0);
    }
    return;
  }
  const unsigned k = c4 * unsigned(in[0]) + unsigned(rnd);
  const unsigned a0 = k + c2 * unsigned(in[2]) + c4 * unsigned(in[4]) + c6 * unsigned(in[6]);
  const unsigned a1 = k + c6 * unsigned(in[2]) - c4 * unsigned(in[4]) - c2 * unsigned(in[6]);
  const unsigned a2 = k - c6 * unsigned(in[2]) - c4 * unsigned(in[4]) + c2 * unsigned(in[6]);
  const unsigned a3 = k - c2 * unsigned(in[2]) + c4 * unsigned(in[4]) - c6 * unsigned(in[6]);
  const unsigned b0 = c1 * unsigned(in[1]) + c3 * unsigned(in[3]) + c5 * unsigned(in[5]) + c7 * unsigned(in[7]);
  const unsigned b1 = c3 * unsigned(in[1]) - c7 * unsigned(in[3]) - c1 * unsigned(in[5]) - c5 * unsigned(in[7]);
  const unsigned b2 = c5 * unsigned(in[1]) - c1 * unsigned(in[3]) + c7 * unsigned(in[5]) + c3 * unsigned(in[7]);
  const unsigned b3 = c7 * unsigned(in[1]) - c5 * unsigned(in[3]) + c3 * unsigned(in[5]) - c1 * unsigned(in[7]);
  in[0] = int16_t(int(a0 + b0) >> kXvidRowShift);
  in[1] = int16_t(int(a1 + b1) >> kXvidRowShift);
  in[2] = int16_t(int(a2 + b2) >> kXvidRowShift);
  in[3] = int16_t(int(a3 + b3) >> kXvidRowShift);
  in[4] = int16_t(int(a3 - b3) >> kXvidRowShift);
  in[5] = int16_t(int(a2 - b2) >> kXvidRowShift);
  in[6] = int16_t(int(a1 - b1) >> kXvidRowShift);
  in[7] = int16_t(int(a0 - b0) >> kXvidRowShift);
}

inline int xvid_mult(int c, int x) { return int(unsigned(int(unsigned(c) * unsigned(x)) >> 16)); }

// the column pass; FFmpeg's 3- and 4-row forms are this one with zeros
void xvid_col(int16_t* in) {
  constexpr int kTan1 = 0x32EC, kTan2 = 0x6A0A, kTan3 = 0xAB0E, kSqrt2 = 0x5A82;
  int mm0, mm1, mm2, mm3, mm4, mm5, mm6, mm7, t;
  mm4 = in[7 * 8];
  mm5 = in[5 * 8];
  mm6 = in[3 * 8];
  mm7 = in[1 * 8];
  mm0 = xvid_mult(kTan1, mm4) + mm7;
  mm1 = xvid_mult(kTan1, mm7) - mm4;
  mm2 = xvid_mult(kTan3, mm5) + mm6;
  mm3 = xvid_mult(kTan3, mm6) - mm5;
  mm7 = mm0 + mm2;
  mm4 = mm1 - mm3;
  mm0 = mm0 - mm2;
  mm1 = mm1 + mm3;
  mm6 = mm0 + mm1;
  mm5 = mm0 - mm1;
  mm5 = 2 * xvid_mult(kSqrt2, mm5);
  mm6 = 2 * xvid_mult(kSqrt2, mm6);
  mm1 = in[2 * 8];
  mm2 = in[6 * 8];
  mm3 = xvid_mult(kTan2, mm2) + mm1;
  mm2 = xvid_mult(kTan2, mm1) - mm2;
  mm0 = in[0] + in[4 * 8];
  mm1 = in[0] - in[4 * 8];
  t = mm0 + mm3; mm3 = mm0 - mm3; mm0 = t;
  t = mm0 + mm7; mm7 = mm0 - mm7; mm0 = t;
  in[8 * 0] = int16_t(mm0 >> kXvidColShift);
  in[8 * 7] = int16_t(mm7 >> kXvidColShift);
  t = mm3 + mm4; mm4 = mm3 - mm4; mm3 = t;
  in[8 * 3] = int16_t(mm3 >> kXvidColShift);
  in[8 * 4] = int16_t(mm4 >> kXvidColShift);
  t = mm1 + mm2; mm2 = mm1 - mm2; mm1 = t;
  t = mm1 + mm6; mm6 = mm1 - mm6; mm1 = t;
  in[8 * 1] = int16_t(mm1 >> kXvidColShift);
  in[8 * 6] = int16_t(mm6 >> kXvidColShift);
  t = mm2 + mm5; mm5 = mm2 - mm5; mm2 = t;
  in[8 * 2] = int16_t(mm2 >> kXvidColShift);
  in[8 * 5] = int16_t(mm5 >> kXvidColShift);
}

void xvid_idct(int16_t* blk) {
  for (int r = 0; r < 8; r++) xvid_row(blk + 8 * r, kXvidTab[kXvidRowTab[r]], kXvidRnd[r]);
  for (int c = 0; c < 8; c++) xvid_col(blk + c);
}

void idct_put(int16_t* blk, uint8_t* dst, int stride, bool xvid) {
  if (!xvid) return simple_idct_put(blk, dst, stride);
  xvid_idct(blk);
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++) dst[y * stride + x] = clip8(blk[8 * y + x]);
}

void idct_add(int16_t* blk, uint8_t* dst, int stride, bool xvid) {
  if (!xvid) return simple_idct_add(blk, dst, stride);
  xvid_idct(blk);
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++) dst[y * stride + x] = clip8(dst[y * stride + x] + blk[8 * y + x]);
}

// ---------------------------------------------------------------- motion compensation

// Copies a (bw+1) x (bh+1) window at (x, y) of a plane of w x h samples,
// replicating its edges, into ``tmp`` (stride bw+1); returns the source
// pointer and stride to read from.
const uint8_t* fetch(const uint8_t* plane, int stride, int w, int h, int x, int y, int bw,
                     int bh, uint8_t* tmp, int* out_stride) {
  if (x >= 0 && y >= 0 && x + bw < w && y + bh < h) {
    *out_stride = stride;
    return plane + int64_t(y) * stride + x;
  }
  for (int j = 0; j <= bh; j++) {
    int yy = std::min(std::max(y + j, 0), h - 1);
    for (int i = 0; i <= bw; i++) {
      int xx = std::min(std::max(x + i, 0), w - 1);
      tmp[j * (bw + 1) + i] = plane[int64_t(yy) * stride + xx];
    }
  }
  *out_stride = bw + 1;
  return tmp;
}

void mc_block(uint8_t* dst, int dstride, const uint8_t* src, int sstride, int bw, int bh,
              int dxy, bool no_rnd, bool avg) {
  for (int j = 0; j < bh; j++) {
    const uint8_t* s0 = src + j * sstride;
    const uint8_t* s1 = s0 + sstride;
    uint8_t* d = dst + j * dstride;
    auto store = [&](int i, int v) { d[i] = uint8_t(avg ? (d[i] + v + 1) >> 1 : v); };
    switch (dxy) {
      case 0:
        for (int i = 0; i < bw; i++) store(i, s0[i]);
        break;
      case 1:
        if (no_rnd)
          for (int i = 0; i < bw; i++) store(i, (std::max(s0[i] - 1, 0) + s0[i + 1] + 1) >> 1);
        else
          for (int i = 0; i < bw; i++) store(i, (s0[i] + s0[i + 1] + 1) >> 1);
        break;
      case 2:
        if (no_rnd) {
          // the odd row of each pair is reduced
          for (int i = 0; i < bw; i++) {
            int a = s0[i], b = s1[i];
            if (j & 1) a = std::max(a - 1, 0);
            else b = std::max(b - 1, 0);
            store(i, (a + b + 1) >> 1);
          }
        } else {
          for (int i = 0; i < bw; i++) store(i, (s0[i] + s1[i] + 1) >> 1);
        }
        break;
      default: {
        int r = no_rnd ? 1 : 2;
        for (int i = 0; i < bw; i++) store(i, (s0[i] + s0[i + 1] + s1[i] + s1[i + 1] + r) >> 2);
        break;
      }
    }
  }
}

inline int mid3(int a, int b, int c) {
  if (a > b) std::swap(a, b);
  return std::max(a, std::min(b, c));
}

inline int sign_extend(int v, int bits) {
  return int(uint32_t(v) << (32 - bits)) >> (32 - bits);
}

constexpr int kDquant[4] = {-1, -2, 1, 2};

}  // namespace

// ---------------------------------------------------------------- decoder state

struct Mpeg4Decoder::Impl {
  // VOL
  bool have_vol = false;
  int width = 0, height = 0;
  int time_bits = 1;
  int quant_precision = 5;
  bool mpeg_quant = false;
  uint16_t intra_matrix[64], inter_matrix[64];
  bool full_range = false;
  int vo_type = 0;
  bool vol_control = false;
  int time_res = 1;  // vop_time_increment_resolution
  // what FFmpeg keeps across VOPs: the delay, the picture count, the
  // encoder found in the user data and what it selects
  Mpeg4State st;
  uint32_t codec_tag = 0;  // the container's FourCC in upper case (AVI), 0 in MP4
  bool packet_mode = false;  // AVI: B-VOPs, packed bitstreams, output in display order
  bool headers_only = false;  // parse the VOP headers, decode no macroblock
  std::vector<uint8_t> config;
  // VOP times (FFmpeg's time_base, last_non_b_time, pp_time, pb_time)
  int64_t time_base = 0, last_time_base = 0, last_non_b_time = 0;
  uint16_t pp_time = 0, pb_time = 0;
  // pictures: the past and future references (FFmpeg's last and next
  // picture) and the picture being decoded
  Picture pics[3];
  int ref_last = -1, ref_next = -1;
  Picture* cur = &pics[0];
  const Picture* out = nullptr;
  // the future reference's macroblocks: not coded, four vectors
  std::vector<uint8_t> ref_skip, ref_4mv;
  // a packed VOP held for the next packet (FFmpeg's bitstream_buffer), with
  // the tag of its first byte
  std::vector<uint8_t> stored;
  int64_t stored_tag = 0;
  int64_t packet_tag = 0;  // packet_mode: the tag base of the packet being decoded
  int64_t vop_offset = 0;  // start code of the VOP of the last walk, in its buffer
  // per-VOP state
  int mb_w = 0, mb_h = 0, mb_num = 0;
  int pict_type = 0;  // 0 I, 1 P, 2 B
  int pict_p = 0;     // 1 for a P-VOP
  int qscale = 1;
  bool no_rounding = false;
  int fcode = 1, bcode = 1;
  int last_mv[2][2];  // B-VOP vector predictors, forward and backward
  int bmv[2][4][2];   // B-VOP vectors by direction and block
  int dc_threshold = 99;
  int mb_x = 0, mb_y = 0;
  int resync_x = 0, resync_y = 0;
  bool first_slice_line = true;
  // predictors, FFmpeg-compatible layouts: luma blocks with stride 2*mb_w+1,
  // chroma by macroblock with stride mb_w+1, one border row and column
  int ls = 0, cs = 0;
  std::vector<int16_t> dc[3];
  std::vector<int16_t> ac[3];  // 16 per block: [1..7] left column, [9..15] top row
  std::vector<int16_t> mvs;    // 2 per luma block, stride ls
  std::vector<int8_t> qtab;
  // per-MB
  int16_t block[6][64];
  int last_index[6];
  bool intra = false, ac_pred = false, four_mv = false, skipped = false;
  int mv[4][2];
  bool fwd = false, bwd = false;  // B-VOP prediction directions
  std::string err;
  bool unsupported = false;

  Impl() {
    for (int i = 0; i < 64; i++) {
      intra_matrix[i] = kDefaultIntraMatrix[i];
      inter_matrix[i] = kDefaultInterMatrix[i];
    }
  }

  bool fail(const char* m) {
    if (err.empty()) err = m;
    return false;
  }
  bool unsupported_form(const std::string& m) {
    if (err.empty()) err = m + ": ROADMAP.md Queue 1 item 8b";
    unsupported = true;
    return false;
  }

  // ------------------------------------------------------------ headers

  void parse_vo(Bits& b) {
    if (b.bit()) b.skip(7);  // verid, priority
    int type = int(b.get(4));
    if (type == 1 || type == 2) {
      if (b.bit()) {  // video_signal_type
        b.skip(3);
        full_range = b.bit();
        if (b.bit()) b.skip(24);
      }
    }
  }

  bool load_matrix(Bits& b, uint16_t* m) {
    int i = 0, last = 0;
    for (; i < 64; i++) {
      if (b.left() < 8) return fail("truncated quantiser matrix");
      int v = int(b.get(8));
      if (v == 0) break;
      last = v;
      m[kZigzag[i]] = uint16_t(v);
    }
    for (; i < 64; i++) m[kZigzag[i]] = uint16_t(last);
    return true;
  }

  bool parse_vol(Bits& b) {
    b.skip(1);  // random_accessible_vol
    vo_type = int(b.get(8));
    int verid = 1;
    if (b.bit()) {
      verid = int(b.get(4));
      b.skip(3);
    }
    if (b.get(4) == 15) b.skip(16);  // extended PAR
    vol_control = b.bit();
    if (vol_control) {
      int chroma = int(b.get(2));
      if (chroma != 1) return unsupported_form("MPEG-4 chroma format other than 4:2:0");
      st.low_delay = b.bit();
      if (b.bit()) b.skip(15 + 1 + 15 + 1 + 15 + 1 + 3 + 11 + 1 + 15 + 1);
    } else if (st.picture_number == 0) {
      st.low_delay = vo_type == 1 || vo_type == 17;  // Simple and Advanced Simple
    }
    int shape = int(b.get(2));
    if (shape != 0) return unsupported_form("MPEG-4 arbitrary-shape VOLs");
    b.skip(1);
    int res = int(b.get(16));
    if (res == 0) return fail("vop_time_increment_resolution 0");
    time_res = res;
    time_bits = 1;
    while ((1 << time_bits) < res) time_bits++;
    b.skip(1);
    if (b.bit()) b.skip(time_bits);  // fixed_vop_time_increment
    b.skip(1);
    int w = int(b.get(13));
    b.skip(1);
    int h = int(b.get(13));
    b.skip(1);
    if (b.bit()) return unsupported_form("interlaced MPEG-4");
    b.skip(1);  // obmc_disable
    int sprite = verid == 1 ? int(b.get(1)) : int(b.get(2));
    if (sprite) return unsupported_form("MPEG-4 sprites and GMC");
    if (b.bit()) return unsupported_form("MPEG-4 N-bit video");
    quant_precision = 5;
    mpeg_quant = b.bit();
    for (int i = 0; i < 64; i++) {
      intra_matrix[i] = kDefaultIntraMatrix[i];
      inter_matrix[i] = kDefaultInterMatrix[i];
    }
    if (mpeg_quant) {
      if (b.bit() && !load_matrix(b, intra_matrix)) return false;
      if (b.bit() && !load_matrix(b, inter_matrix)) return false;
    }
    if (verid != 1 && b.bit()) return unsupported_form("MPEG-4 quarter-sample motion");
    if (b.left() < 4) return fail("truncated VOL header");
    if (!b.bit()) return unsupported_form("MPEG-4 complexity estimation headers");
    b.skip(1);  // resync_marker_disable: markers are looked for either way
    if (b.bit()) return unsupported_form("MPEG-4 data partitioning");
    if (verid != 1) {
      if (b.bit()) return unsupported_form("MPEG-4 NEWPRED");
      if (b.bit()) return unsupported_form("MPEG-4 reduced-resolution VOPs");
    }
    if (b.bit()) return unsupported_form("MPEG-4 scalability");
    if (w && h) {
      width = w;
      height = h;
    }
    if (width <= 0 || height <= 0) return fail("VOL without a frame size");
    have_vol = true;
    return true;
  }

  // Walks the start codes of a buffer; decodes the VOP if there is one.
  // Returns 1 (picture), 0 (none) or a Status.
  int walk(const uint8_t* p, size_t n, bool config_only) {
    size_t i = 0;
    while (i + 4 <= n) {
      if (!(p[i] == 0 && p[i + 1] == 0 && p[i + 2] == 1)) {
        i++;
        continue;
      }
      int code = p[i + 3];
      size_t body = i + 4;
      // the header ends at the next start code
      size_t end = body;
      while (end + 3 <= n && !(p[end] == 0 && p[end + 1] == 0 && p[end + 2] == 1)) end++;
      if (end + 3 > n) end = n;
      Bits b(p + body, (code == 0xb6 ? n : end) - body);
      if (code >= 0x20 && code <= 0x2f) {
        if (!parse_vol(b)) return unsupported ? kUnsupported : kInvalid;
      } else if (code == 0xb5) {
        parse_vo(b);
      } else if (code == 0xb2) {
        parse_user_data(p + body, end - body);
      } else if (code == 0xb3) {
        // GOV: the time code sets the seconds the VOP times count from
        if (b.peek(23)) {
          int hours = int(b.get(5)), minutes = int(b.get(6));
          b.skip(1);
          int seconds = int(b.get(6));
          time_base = seconds + 60 * (minutes + 60 * hours);
        }
      } else if (code == 0xb6) {
        if (config_only) return 0;
        vop_offset = int64_t(i);
        return decode_vop(b);
      }
      i = end;
    }
    return 0;
  }

  // FFmpeg's decode_user_data: the encoder and its build, and DivX's
  // packed-bitstream flag
  void parse_user_data(const uint8_t* p, size_t n) {
    char buf[256];
    size_t k = 0;
    for (; k < 255 && k < n; k++) buf[k] = char(p[k]);
    buf[k] = 0;
    int ver = 0, ver2 = 0, ver3 = 0, build = 0;
    char last = 0;
    int e = sscanf(buf, "DivX%dBuild%d%c", &ver, &build, &last);
    if (e < 2) e = sscanf(buf, "DivX%db%d%c", &ver, &build, &last);
    if (e >= 2) {
      st.divx_version = ver;
      st.divx_build = build;
      st.packed = e == 3 && last == 'p';
    }
    e = sscanf(buf, "FFmpe%*[^b]b%d", &build) + 3;
    if (e != 4)
      e = sscanf(buf, "FFmpeg v%d.%d.%d / libavcodec build: %d", &ver, &ver2, &ver3, &build);
    if (e != 4) {
      e = sscanf(buf, "Lavc%d.%d.%d", &ver, &ver2, &ver3) + 1;
      if (e > 1) {
        if (unsigned(ver) > 0xff || unsigned(ver2) > 0xff || unsigned(ver3) > 0xff) e = 0;
        else build = (ver << 16) + (ver2 << 8) + ver3;
      }
    }
    if (e != 4) {
      if (strcmp(buf, "ffmpeg") == 0) st.lavc_build = 4600;
    }
    if (e == 4) st.lavc_build = build;
    if (sscanf(buf, "XviD%d", &build) == 1) st.xvid_build = build;
  }

  // FFmpeg's ff_mpeg4_workaround_bugs: the encoder from the codec tag when
  // the user data names none, and the IDCT it selects (Xvid's for a stream
  // of Xvid's). The workarounds that change the decode of the forms the
  // port reads are left to item 8b.
  bool workarounds() {
    auto tag_is = [&](const char* t) { return codec_tag == riff_fourcc(t); };
    if (st.xvid_build == -1 && st.divx_version == -1 && st.lavc_build == -1 &&
        (tag_is("XVID") || tag_is("XVIX") || tag_is("RMP4") || tag_is("ZMP4") || tag_is("SIPP")))
      st.xvid_build = 0;
    if (st.xvid_build == -1 && st.divx_version == -1 && st.lavc_build == -1 && tag_is("DIVX") &&
        vo_type == 0 && !vol_control)
      st.divx_version = 400;
    if (st.xvid_build >= 0 && st.divx_version >= 0) st.divx_version = st.divx_build = -1;
    const char* bug = nullptr;
    if (tag_is("XVIX")) bug = "Xvid's interlacing bug (XVIX)";
    else if (tag_is("UMP4")) bug = "UMP4 streams";
    else if (tag_is("GEOV") || tag_is("GEOX")) bug = "GeoVision streams";
    else if (unsigned(st.xvid_build) <= 32u)
      bug = "Xvid builds before 33 (edge and DC workarounds)";
    else if (unsigned(st.divx_version) < 500u) bug = "DivX 4 streams (edge workaround)";
    else if (unsigned(st.lavc_build) <= 4712u)
      bug = "old libavcodec streams (edge and DC workarounds)";
    else if ((st.lavc_build & 0xff) >= 100 && st.lavc_build > 3621476 && st.lavc_build < 3752552 &&
             (st.lavc_build < 3752037 || st.lavc_build > 3752191))
      bug = "libavcodec 55 streams (intra edge workaround)";
    if (bug) return unsupported_form(std::string("MPEG-4 ") + bug);
    if (st.xvid_build >= 0) st.xvid_idct = true;
    return true;
  }

  // ------------------------------------------------------------ VOP

  void alloc_vop() {
    int mw = (width + 15) / 16, mh = (height + 15) / 16;
    for (Picture& pic : pics) {  // a VOL may change the size within one macroblock grid
      pic.width = width;
      pic.height = height;
    }
    if (mw == mb_w && mh == mb_h && !pics[0].y.empty()) return;
    mb_w = mw;
    mb_h = mh;
    mb_num = mw * mh;
    for (Picture& p : pics) {
      Picture* pic = &p;
      pic->stride_y = mw * 16;
      pic->stride_c = mw * 8;
      pic->rows_y = mh * 16;
      pic->rows_c = mh * 8;
      pic->y.assign(size_t(pic->stride_y) * pic->rows_y, 0);
      pic->u.assign(size_t(pic->stride_c) * pic->rows_c, 0);
      pic->v.assign(size_t(pic->stride_c) * pic->rows_c, 0);
    }
    ref_last = ref_next = -1;
    ref_skip.assign(size_t(mb_num), 0);
    ref_4mv.assign(size_t(mb_num), 0);
    ls = 2 * mw + 1;
    cs = mw + 1;
    size_t lsize = size_t(ls) * (2 * mh + 2), csize = size_t(cs) * (mh + 2);
    dc[0].assign(lsize, 1024);
    dc[1].assign(csize, 1024);
    dc[2].assign(csize, 1024);
    ac[0].assign(lsize * 16, 0);
    ac[1].assign(csize * 16, 0);
    ac[2].assign(csize * 16, 0);
    mvs.assign(size_t(ls) * (2 * mh + 2) * 2, 0);
    qtab.assign(size_t(mw) * mh, 0);
  }

  // index of luma block (bx, by) / chroma (mx, my) in the predictor arrays
  int lidx(int bx, int by) const { return (by + 1) * ls + bx + 1; }
  int cidx(int x, int y) const { return (y + 1) * cs + x + 1; }
  int16_t* mvp(int bx, int by) { return &mvs[size_t((by + 1) * ls + bx) * 2]; }

  int y_dc_scale() const { return kYDcScale[qscale]; }
  int c_dc_scale() const { return kCDcScale[qscale]; }

  void set_qscale(int q) { qscale = q < 1 ? 1 : (q > 31 ? 31 : q); }

  // FFmpeg's clean of the AC predictors (and the B-VOP vector predictors)
  // at the start of a video packet
  void clean_ac_for_packet() {
    memset(last_mv, 0, sizeof(last_mv));
    int l0 = lidx(2 * mb_x - 1, 2 * mb_y - 1);
    for (int k = 0; k < 2 * ls + 1; k++)
      if (l0 + k >= 0 && size_t(l0 + k) < dc[0].size())
        memset(&ac[0][size_t(l0 + k) * 16], 0, 16 * sizeof(int16_t));
    int c0 = cidx(mb_x - 1, mb_y - 1);
    for (int k = 0; k < cs + 1; k++)
      if (c0 + k >= 0 && size_t(c0 + k) < dc[1].size()) {
        memset(&ac[1][size_t(c0 + k) * 16], 0, 16 * sizeof(int16_t));
        memset(&ac[2][size_t(c0 + k) * 16], 0, 16 * sizeof(int16_t));
      }
  }

  // position of block n in the predictor arrays, and its plane
  int block_pos(int n, int* plane) const {
    if (n < 4) {
      *plane = 0;
      return lidx(2 * mb_x + (n & 1), 2 * mb_y + (n >> 1));
    }
    *plane = n - 3;
    return cidx(mb_x, mb_y);
  }

  // DC prediction: predicted quantised DC added to ``level``; stores the
  // reconstructed DC; *dir 1 = from above, 0 = from the left
  int pred_dc(int n, int level, int* dir) {
    int plane;
    int pos = block_pos(n, &plane);
    int wrap = plane ? cs : ls;
    int scale = n < 4 ? y_dc_scale() : c_dc_scale();
    std::vector<int16_t>& d = dc[plane];
    int a = d[pos - 1], b = d[pos - 1 - wrap], c = d[pos - wrap];
    if (first_slice_line && n != 3) {
      if (n != 2) b = c = 1024;
      if (n != 1 && mb_x == resync_x) b = a = 1024;
    }
    if (mb_x == resync_x && mb_y == resync_y + 1) {
      if (n == 0 || n == 4 || n == 5) b = 1024;
    }
    int pred;
    if (std::abs(a - b) < std::abs(b - c)) {
      pred = c;
      *dir = 1;
    } else {
      pred = a;
      *dir = 0;
    }
    pred = (pred + (scale >> 1)) / scale;
    level += pred;
    int ret = level;
    level *= scale;
    if (level & ~2047) level = level < 0 ? 0 : 2047;
    d[pos] = int16_t(level);
    return ret;
  }

  void pred_ac(int16_t* blk, int n, int dir) {
    int plane;
    int pos = block_pos(n, &plane);
    int wrap = plane ? cs : ls;
    int16_t* cur_ac = &ac[plane][size_t(pos) * 16];
    if (ac_pred) {
      if (dir == 0) {
        const int16_t* left = cur_ac - 16;
        int q = mb_x > 0 ? qtab[mb_y * mb_w + mb_x - 1] : qscale;
        if (mb_x == 0 || qscale == q || n == 1 || n == 3) {
          for (int i = 1; i < 8; i++) blk[i << 3] = int16_t(blk[i << 3] + left[i]);
        } else {
          for (int i = 1; i < 8; i++) {
            int v = left[i] * q;
            v = v > 0 ? (v + (qscale >> 1)) / qscale : (v - (qscale >> 1)) / qscale;
            blk[i << 3] = int16_t(blk[i << 3] + v);
          }
        }
      } else {
        const int16_t* top = cur_ac - 16 * wrap;
        int q = mb_y > 0 ? qtab[(mb_y - 1) * mb_w + mb_x] : qscale;
        if (mb_y == 0 || qscale == q || n == 2 || n == 3) {
          for (int i = 1; i < 8; i++) blk[i] = int16_t(blk[i] + top[i + 8]);
        } else {
          for (int i = 1; i < 8; i++) {
            int v = top[i + 8] * q;
            v = v > 0 ? (v + (qscale >> 1)) / qscale : (v - (qscale >> 1)) / qscale;
            blk[i] = int16_t(blk[i] + v);
          }
        }
      }
    }
    for (int i = 1; i < 8; i++) cur_ac[i] = blk[i << 3];
    for (int i = 1; i < 8; i++) cur_ac[8 + i] = blk[i];
  }

  bool decode_dc(Bits& b, int n, int* level) {
    const Tables& t = tables();
    int size = (n < 4 ? t.dc_lum : t.dc_chrom).read(b);
    if (size < 0 || size > 9) return fail("illegal intra DC code");
    if (size == 0) {
      *level = 0;
      return true;
    }
    int v = int(b.get(size));
    if (!(v >> (size - 1))) v -= (1 << size) - 1;
    if (size > 8) b.skip(1);  // marker
    *level = v;
    return true;
  }

  // One block's coefficients (quantised for intra and MPEG-quant inter,
  // dequantised for H.263-quant inter).
  bool decode_block(Bits& b, int16_t* blk, int n, bool coded, bool use_dc_vlc) {
    const Tables& t = tables();
    int i;
    int dir = 0;
    const uint8_t* scan = kZigzag;
    int qmul = 1, qadd = 0;
    const Vlc* vlc;
    const RlInfo* rl;
    if (intra) {
      if (use_dc_vlc) {
        int level;
        if (!decode_dc(b, n, &level)) return false;
        blk[0] = int16_t(pred_dc(n, level, &dir));
        i = 0;
      } else {
        i = -1;
        pred_dc(n, 0, &dir);
      }
      vlc = &t.tcoef[1];
      rl = &t.rl[1];
      if (ac_pred) scan = dir == 0 ? kAltVertical : kAltHorizontal;
    } else {
      i = -1;
      vlc = &t.tcoef[0];
      rl = &t.rl[0];
      if (!coded) {
        last_index[n] = -1;
        return true;
      }
      if (!mpeg_quant) {
        qmul = qscale << 1;
        qadd = (qscale - 1) | 1;
      }
    }
    if (coded) {
      for (;;) {
        int sym = vlc->read(b);
        if (sym < 0) return fail("illegal TCOEF code");
        int last, run, level;
        bool dequant_done = false;
        if (sym == 102) {
          uint32_t mode = b.peek(2);
          if (mode < 2) {  // escape 1: level offset by LMAX
            b.skip(1);
            int s2 = vlc->read(b);
            if (s2 < 0 || s2 == 102) return fail("illegal TCOEF escape");
            const TCoef& e = (intra ? kIntraTCoef : kInterTCoef)[s2];
            last = e.last;
            run = e.run;
            level = e.level + rl->max_level[last][run];
          } else if (mode == 2) {  // escape 2: run offset by RMAX
            b.skip(2);
            int s2 = vlc->read(b);
            if (s2 < 0 || s2 == 102) return fail("illegal TCOEF escape");
            const TCoef& e = (intra ? kIntraTCoef : kInterTCoef)[s2];
            last = e.last;
            level = e.level;
            run = e.run + rl->max_run[last][level] + 1;
          } else {  // escape 3: fixed length
            b.skip(2);
            last = int(b.get(1));
            run = int(b.get(6));
            if (!b.bit()) return fail("missing marker in TCOEF escape");
            level = sign_extend(int(b.get(12)), 12);
            if (!b.bit()) return fail("missing marker in TCOEF escape");
            level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
            if (unsigned(level + 2048) > 4095) level = level < 0 ? -2048 : 2047;
            dequant_done = true;
          }
          if (!dequant_done) {
            level = level * qmul + qadd;
            if (b.bit()) level = -level;
          }
        } else {
          const TCoef& e = (intra ? kIntraTCoef : kInterTCoef)[sym];
          last = e.last;
          run = e.run;
          level = e.level * qmul + qadd;
          if (b.bit()) level = -level;
        }
        i += run + 1;
        if (last ? i > 63 : i > 62) return fail("AC coefficients past the block");
        blk[scan[i]] = int16_t(level);
        if (last) break;
      }
    }
    if (intra) {
      if (!use_dc_vlc) {
        blk[0] = int16_t(pred_dc(n, blk[0], &dir));
        if (i < 0) i = 0;
      }
      pred_ac(blk, n, dir);
      if (ac_pred) i = 63;
    }
    last_index[n] = i;
    return true;
  }

  bool decode_motion(Bits& b, int pred, int* out, int f_code) {
    const Tables& t = tables();
    int code = t.mv.read(b);
    if (code < 0) return fail("illegal motion vector code");
    if (code == 0) {
      *out = pred;
      return true;
    }
    bool sign = b.bit();
    int shift = f_code - 1;
    int val = code;
    if (shift) {
      val = (val - 1) << shift;
      val |= int(b.get(shift));
      val++;
    }
    if (sign) val = -val;
    val += pred;
    *out = sign_extend(val, 5 + f_code);
    return true;
  }

  // median prediction of luma block ``blk`` (FFmpeg's first-slice-line rules)
  void pred_motion(int blk, int* px, int* py) {
    static const int off[4] = {2, 1, 1, -1};
    int bx = 2 * mb_x + (blk & 1), by = 2 * mb_y + (blk >> 1);
    int16_t* A = mvp(bx - 1, by);
    if (first_slice_line && blk < 3) {
      if (blk == 0) {
        if (mb_x == resync_x) {
          *px = *py = 0;
        } else if (mb_x + 1 == resync_x) {
          int16_t* C = mvp(bx + off[blk], by - 1);
          if (mb_x == 0) {
            *px = C[0];
            *py = C[1];
          } else {
            *px = mid3(A[0], 0, C[0]);
            *py = mid3(A[1], 0, C[1]);
          }
        } else {
          *px = A[0];
          *py = A[1];
        }
      } else if (blk == 1) {
        if (mb_x + 1 == resync_x) {
          int16_t* C = mvp(bx + off[blk], by - 1);
          *px = mid3(A[0], 0, C[0]);
          *py = mid3(A[1], 0, C[1]);
        } else {
          *px = A[0];
          *py = A[1];
        }
      } else {
        int16_t* B = mvp(bx, by - 1);
        int16_t* C = mvp(bx + off[blk], by - 1);
        if (mb_x == resync_x) A[0] = A[1] = 0;
        *px = mid3(A[0], B[0], C[0]);
        *py = mid3(A[1], B[1], C[1]);
      }
    } else {
      int16_t* B = mvp(bx, by - 1);
      int16_t* C = mvp(bx + off[blk], by - 1);
      *px = mid3(A[0], B[0], C[0]);
      *py = mid3(A[1], B[1], C[1]);
    }
  }

  bool decode_intra_body(Bits& b, int cbpc, bool dquant) {
    const Tables& t = tables();
    intra = true;
    ac_pred = b.bit();
    int cbpy = t.cbpy.read(b);
    if (cbpy < 0) return fail("illegal CBPY code");
    int cbp = (cbpc & 3) | (cbpy << 2);
    bool use_dc_vlc = qscale < dc_threshold;
    if (dquant) set_qscale(qscale + kDquant[b.get(2)]);
    for (int k = 0; k < 6; k++) {
      if (!decode_block(b, block[k], k, (cbp & 32) != 0, use_dc_vlc)) return false;
      cbp += cbp;
    }
    return true;
  }

  bool decode_mb(Bits& b) {
    const Tables& t = tables();
    memset(block, 0, sizeof(block));
    intra = false;
    ac_pred = false;
    four_mv = false;
    skipped = false;
    mv[0][0] = mv[0][1] = 0;
    if (!pict_p) {
      int cbpc;
      do {
        cbpc = t.intra_mcbpc.read(b);
        if (cbpc < 0) return fail("illegal intra MCBPC code");
      } while (cbpc == 8);
      return decode_intra_body(b, cbpc, (cbpc & 4) != 0);
    }
    int cbpc;
    do {
      if (b.bit()) {  // not_coded
        skipped = true;
        for (int k = 0; k < 6; k++) last_index[k] = -1;
        return true;
      }
      cbpc = t.inter_mcbpc.read(b);
      if (cbpc < 0) return fail("illegal inter MCBPC code");
    } while (cbpc == 20);
    bool dquant = (cbpc & 8) != 0;
    if (cbpc & 4) return decode_intra_body(b, cbpc, dquant);
    int cbpy = t.cbpy.read(b);
    if (cbpy < 0) return fail("illegal CBPY code");
    cbpy ^= 0xf;
    int cbp = (cbpc & 3) | (cbpy << 2);
    if (dquant) set_qscale(qscale + kDquant[b.get(2)]);
    int px, py;
    if (!(cbpc & 16)) {
      pred_motion(0, &px, &py);
      if (!decode_motion(b, px, &mv[0][0], fcode) || !decode_motion(b, py, &mv[0][1], fcode))
        return false;
    } else {
      four_mv = true;
      for (int k = 0; k < 4; k++) {
        pred_motion(k, &px, &py);
        if (!decode_motion(b, px, &mv[k][0], fcode) || !decode_motion(b, py, &mv[k][1], fcode))
          return false;
        int16_t* m = mvp(2 * mb_x + (k & 1), 2 * mb_y + (k >> 1));
        m[0] = int16_t(mv[k][0]);
        m[1] = int16_t(mv[k][1]);
      }
    }
    for (int k = 0; k < 6; k++) {
      if (!decode_block(b, block[k], k, (cbp & 32) != 0, false)) return false;
      cbp += cbp;
    }
    return true;
  }

  // ------------------------------------------------------------ reconstruction

  void mc_luma(int x, int y, int mx, int my, int bs, uint8_t* dst, const Picture& ref, bool avg,
               bool no_rnd) {
    int dxy = ((my & 1) << 1) | (mx & 1);
    int sx = x + (mx >> 1), sy = y + (my >> 1);
    if (bs == 8) {  // an 8x8 vector is clipped first
      sx = std::min(std::max(sx, -16), width);
      if (sx == width) dxy &= ~1;
      sy = std::min(std::max(sy, -16), height);
      if (sy == height) dxy &= ~2;
    }
    uint8_t tmp[17 * 17];
    int ss;
    const uint8_t* src = fetch(ref.y.data(), ref.stride_y, ref.stride_y, ref.rows_y, sx, sy, bs,
                               bs, tmp, &ss);
    mc_block(dst, cur->stride_y, src, ss, bs, bs, dxy, no_rnd, avg);
  }

  void mc_chroma(int sx, int sy, int dxy, uint8_t* du, uint8_t* dv, const Picture& ref, bool avg,
                 bool no_rnd) {
    uint8_t tmp[9 * 9];
    int ss;
    const uint8_t* src = fetch(ref.u.data(), ref.stride_c, ref.stride_c, ref.rows_c, sx, sy, 8,
                               8, tmp, &ss);
    mc_block(du, cur->stride_c, src, ss, 8, 8, dxy, no_rnd, avg);
    src = fetch(ref.v.data(), ref.stride_c, ref.stride_c, ref.rows_c, sx, sy, 8, 8, tmp, &ss);
    mc_block(dv, cur->stride_c, src, ss, 8, 8, dxy, no_rnd, avg);
  }

  // one direction's prediction of the macroblock from ``ref``: a 16x16
  // vector, or four 8x8 ones with the chroma vector from their sum; ``avg``
  // averages it into what the other direction put there
  void predict(const Picture& ref, const int (*v)[2], bool four, bool avg, bool no_rnd,
               uint8_t* dy, uint8_t* du, uint8_t* dv) {
    const int sy_ = cur->stride_y;
    if (!four) {
      int mx = v[0][0], my = v[0][1];
      mc_luma(mb_x * 16, mb_y * 16, mx, my, 16, dy, ref, avg, no_rnd);
      int dxy = ((my & 1) << 1) | (mx & 1);
      int uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
      int sx = (mb_x * 16 + (mx >> 1)) >> 1, sy = (mb_y * 16 + (my >> 1)) >> 1;
      mc_chroma(sx, sy, uvdxy, du, dv, ref, avg, no_rnd);
      return;
    }
    int sumx = 0, sumy = 0;
    for (int k = 0; k < 4; k++) {
      mc_luma(mb_x * 16 + (k & 1) * 8, mb_y * 16 + (k >> 1) * 8, v[k][0], v[k][1], 8,
              dy + (k & 1) * 8 + (k >> 1) * 8 * sy_, ref, avg, no_rnd);
      sumx += v[k][0];
      sumy += v[k][1];
    }
    static const uint8_t round_tab[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
    int mx = round_tab[sumx & 15] + ((sumx >> 3) & ~1);
    int my = round_tab[sumy & 15] + ((sumy >> 3) & ~1);
    int dxy = ((my & 1) << 1) | (mx & 1);
    mx >>= 1;
    my >>= 1;
    int sx = mb_x * 8 + mx, sy = mb_y * 8 + my;
    sx = std::min(std::max(sx, -8), width >> 1);
    if (sx == (width >> 1)) dxy &= ~1;
    sy = std::min(std::max(sy, -8), height >> 1);
    if (sy == (height >> 1)) dxy &= ~2;
    mc_chroma(sx, sy, dxy, du, dv, ref, avg, no_rnd);
  }

  void reconstruct() {
    const int sy_ = cur->stride_y, sc = cur->stride_c;
    uint8_t* dy = cur->y.data() + size_t(mb_y) * 16 * sy_ + mb_x * 16;
    uint8_t* du = cur->u.data() + size_t(mb_y) * 8 * sc + mb_x * 8;
    uint8_t* dv = cur->v.data() + size_t(mb_y) * 8 * sc + mb_x * 8;
    uint8_t* dest[6] = {dy, dy + 8, dy + 8 * sy_, dy + 8 * sy_ + 8, du, dv};
    int strides[6] = {sy_, sy_, sy_, sy_, sc, sc};
    if (intra) {
      for (int n = 0; n < 6; n++) {
        int16_t* blk = block[n];
        blk[0] = int16_t(blk[0] * (n < 4 ? y_dc_scale() : c_dc_scale()));
        if (mpeg_quant) {
          for (int i = 1; i < 64; i++) {
            int level = blk[i];
            if (!level) continue;
            int a = (int)(unsigned(std::abs(level)) * unsigned(qscale) * intra_matrix[i]) >> 3;
            blk[i] = int16_t(level < 0 ? -a : a);
          }
        } else {
          int qmul = qscale << 1, qadd = (qscale - 1) | 1;
          for (int i = 1; i < 64; i++) {
            int level = blk[i];
            if (!level) continue;
            blk[i] = int16_t(level < 0 ? level * qmul - qadd : level * qmul + qadd);
          }
        }
        idct_put(blk, dest[n], strides[n], st.xvid_idct);
      }
      return;
    }
    // prediction
    if (pict_type == 2) {
      // B-VOP: forward, backward or both averaged, always rounding; a
      // macroblock not coded in the future reference copies the past one
      static const int zero[4][2] = {};
      if (skipped) {
        predict(pics[ref_last], zero, false, false, false, dy, du, dv);
        return;
      }
      if (fwd) predict(pics[ref_last], bmv[0], four_mv, false, false, dy, du, dv);
      if (bwd) predict(pics[ref_next], bmv[1], four_mv, fwd, false, dy, du, dv);
    } else {
      predict(pics[ref_last], mv, four_mv, false, no_rounding, dy, du, dv);
    }
    if (skipped) return;
    for (int n = 0; n < 6; n++) {
      if (last_index[n] < 0) continue;
      int16_t* blk = block[n];
      if (mpeg_quant) {
        int sum = -1;
        for (int i = 0; i < 64; i++) {
          int level = blk[i];
          if (!level) continue;
          int a = (int)(unsigned((std::abs(level) << 1) + 1) * unsigned(qscale) *
                        inter_matrix[i]) >> 4;
          level = level < 0 ? -a : a;
          blk[i] = int16_t(level);
          sum += level;
        }
        blk[63] = int16_t(blk[63] ^ (sum & 1));
      }
      idct_add(blk, dest[n], strides[n], st.xvid_idct);
    }
  }

  // after each MB: predictors of a non-intra MB are reset; motion stored
  void update_after_mb() {
    qtab[mb_y * mb_w + mb_x] = int8_t(qscale);
    ref_skip[size_t(mb_y * mb_w + mb_x)] = skipped;
    ref_4mv[size_t(mb_y * mb_w + mb_x)] = four_mv && !intra;
    if (!intra) {
      for (int k = 0; k < 4; k++) {
        int pos = lidx(2 * mb_x + (k & 1), 2 * mb_y + (k >> 1));
        dc[0][pos] = 1024;
        memset(&ac[0][size_t(pos) * 16], 0, 16 * sizeof(int16_t));
      }
      int pos = cidx(mb_x, mb_y);
      for (int p = 1; p < 3; p++) {
        dc[p][pos] = 1024;
        memset(&ac[p][size_t(pos) * 16], 0, 16 * sizeof(int16_t));
      }
    }
    if (!four_mv) {
      int mx = intra ? 0 : mv[0][0], my = intra ? 0 : mv[0][1];
      for (int k = 0; k < 4; k++) {
        int16_t* m = mvp(2 * mb_x + (k & 1), 2 * mb_y + (k >> 1));
        m[0] = int16_t(mx);
        m[1] = int16_t(my);
      }
    }
  }

  // FFmpeg's mpeg4_is_resync: 0, or the first MB of what follows (the
  // next packet's, or mb_num at the end of the VOP)
  int is_resync(Bits& b) {
    int64_t bits_count = b.pos;
    uint32_t v = b.peek(16);
    while (v <= 0xff) {  // MCBPC stuffing
      if (pict_type == 2 || (v >> (8 - (pict_p ? 2 : 1))) != 1) break;
      b.skip(8 + (pict_p ? 2 : 1));
      bits_count += 8 + (pict_p ? 2 : 1);
      v = b.peek(16);
    }
    if (bits_count + 8 >= b.nbits) {
      v >>= 8;
      v |= 0x7f >> (7 - (bits_count & 7));
      if (v == 0x7f) return mb_num;
    } else {
      static const uint16_t prefix[8] = {0x7F00, 0x7E00, 0x7C00, 0x7800,
                                         0x7000, 0x6000, 0x4000, 0x0000};
      if (v == prefix[bits_count & 7]) {
        Bits g = b;
        g.skip(1);
        g.align();
        int len = 0;
        for (; len < 32; len++)
          if (g.bit()) break;
        int mb_bits = 1;
        while ((1 << mb_bits) < mb_num) mb_bits++;
        int num = int(g.get(mb_bits));
        if (!num || num > mb_num || g.pos + 6 > g.nbits) num = -1;
        if (len >= prefix_len()) return num;
      }
    }
    return 0;
  }

  bool packet_header(Bits& b) {
    // stuffing to the byte boundary, then the marker
    b.skip(1);
    b.align();
    if (b.pos > b.nbits - 20) return fail("truncated video packet header");
    int len = 0;
    for (; len < 32; len++)
      if (b.bit()) break;
    if (len != prefix_len()) return fail("resync marker does not match f_code");
    int mb_bits = 1;
    while ((1 << mb_bits) < mb_num) mb_bits++;
    int num = int(b.get(mb_bits));
    if (num >= mb_num || !num) return fail("illegal macroblock number in a video packet");
    if (pict_type == 2) {  // macroblocks the future reference skipped are skipped here too
      while (num < mb_num && ref_skip[size_t(num)]) num++;
      if (num >= mb_num) return fail("a video packet of skipped macroblocks only");
    }
    mb_x = num % mb_w;
    mb_y = num / mb_w;
    int q = int(b.get(quant_precision));
    if (q) set_qscale(q);
    if (b.bit()) {  // header_extension_code
      while (b.bit()) {
      }
      b.skip(1);
      b.skip(time_bits);
      b.skip(1);
      b.skip(2);
      b.skip(3);
      if (pict_type) b.skip(3);
      if (pict_type == 2) b.skip(3);
    }
    return true;
  }

  int prefix_len() const {
    if (pict_type == 0) return 16;
    return (pict_type == 1 ? fcode : std::max(std::max(fcode, bcode), 2)) + 15;
  }

  bool decode_mb_b(Bits& b) {
    if (mb_x == 0) memset(last_mv, 0, sizeof(last_mv));
    memset(block, 0, sizeof(block));
    intra = false;
    ac_pred = false;
    four_mv = false;
    skipped = false;
    fwd = bwd = false;
    if (ref_skip[size_t(mb_y * mb_w + mb_x)]) {
      // not coded in the future reference: not coded here, copied forward
      skipped = fwd = true;
      for (int k = 0; k < 6; k++) last_index[k] = -1;
      return true;
    }
    int cbp = 0, mx = 0, my = 0;
    bool direct = true;
    if (!b.bit()) {  // modb 1: direct with no delta and no coefficients
      bool no_cbp = b.bit();
      int type = 0;  // MBTYPE: 1 direct, 01 interpolated, 001 backward, 0001 forward
      while (type < 4 && !b.bit()) type++;
      if (type == 4) return fail("illegal B macroblock type");
      direct = type == 0;
      if (!no_cbp) cbp = int(b.get(6));
      if (!direct && cbp && b.bit()) set_qscale(qscale + int(b.get(1)) * 4 - 2);
      if (direct) {
        if (!decode_motion(b, 0, &mx, 1) || !decode_motion(b, 0, &my, 1)) return false;
      } else {
        if (type == 1 || type == 3) {
          fwd = true;
          if (!decode_motion(b, last_mv[0][0], &bmv[0][0][0], fcode) ||
              !decode_motion(b, last_mv[0][1], &bmv[0][0][1], fcode))
            return false;
          last_mv[0][0] = bmv[0][0][0];
          last_mv[0][1] = bmv[0][0][1];
        }
        if (type == 1 || type == 2) {
          bwd = true;
          if (!decode_motion(b, last_mv[1][0], &bmv[1][0][0], bcode) ||
              !decode_motion(b, last_mv[1][1], &bmv[1][0][1], bcode))
            return false;
          last_mv[1][0] = bmv[1][0][0];
          last_mv[1][1] = bmv[1][0][1];
        }
      }
    }
    if (direct) set_direct(mx, my);
    for (int k = 0; k < 6; k++) {
      if (!decode_block(b, block[k], k, (cbp & 32) != 0, false)) return false;
      cbp += cbp;
    }
    return true;
  }

  // direct mode: the future reference's co-located vectors scaled by the
  // VOP distances, plus the delta (FFmpeg's ff_mpeg4_set_direct_mv)
  void set_direct(int mx, int my) {
    fwd = bwd = true;
    const int pb = pb_time, pp = pp_time;
    auto one = [&](int i, const int16_t* p) {
      const int d[2] = {mx, my};
      for (int c = 0; c < 2; c++) {
        bmv[0][i][c] = p[c] * pb / pp + d[c];
        bmv[1][i][c] = d[c] ? bmv[0][i][c] - p[c] : p[c] * (pb - pp) / pp;
      }
    };
    four_mv = ref_4mv[size_t(mb_y * mb_w + mb_x)] != 0;
    for (int i = 0; i < (four_mv ? 4 : 1); i++)
      one(i, mvp(2 * mb_x + (i & 1), 2 * mb_y + (i >> 1)));
  }

  int decode_vop(Bits& b) {
    if (!have_vol) return 0;  // a VOP before any VOL is dropped, as FFmpeg drops it
    int type = int(b.get(2));
    if (type == 3) {
      unsupported_form("MPEG-4 S-VOPs");
      return kUnsupported;
    }
    if (type == 2 && !packet_mode) {
      unsupported_form("MPEG-4 B-VOPs in MP4");
      return kUnsupported;
    }
    if (type == 2 && st.low_delay && !vol_control) st.low_delay = false;
    // the VOP's time, counted as FFmpeg counts it: before vop_coded, so a
    // VOP not coded moves the reference times too
    int incr = 0;
    while (b.bit() && b.left() > 0) incr++;  // modulo_time_base
    b.skip(1);
    int inc = int(b.get(time_bits));
    if (type != 2) {
      last_time_base = time_base;
      time_base += incr;
      int64_t t = time_base * time_res + inc;
      pp_time = uint16_t(t - last_non_b_time);
      last_non_b_time = t;
    } else {
      int64_t t = (last_time_base + incr) * time_res + inc;
      pb_time = uint16_t(pp_time - (last_non_b_time - t));
      if (pp_time <= pb_time || int(pp_time) <= int(pp_time) - int(pb_time) || pp_time == 0)
        return 0;  // out of order (after a seek): FFmpeg skips it
    }
    b.skip(1);
    if (!b.bit()) return 0;  // vop_coded 0: no picture
    pict_type = type;
    pict_p = type == 1;
    no_rounding = pict_p ? b.bit() : false;
    if (b.left() < 3) {
      fail("truncated VOP header");
      return kInvalid;
    }
    dc_threshold = kDcThreshold[b.get(3)];
    int q = int(b.get(quant_precision));
    if (q == 0) {
      fail("VOP quantiser 0");
      return kInvalid;
    }
    set_qscale(q);
    fcode = bcode = 1;
    if (type) {
      fcode = int(b.get(3));
      if (fcode == 0) {
        fail("VOP fcode 0");
        return kInvalid;
      }
    }
    if (type == 2) {
      bcode = int(b.get(3));
      if (bcode == 0) {
        fail("VOP bcode 0");
        return kInvalid;
      }
    }
    if (vo_type == 0 && !vol_control && st.divx_version == -1 && st.picture_number == 0)
      st.low_delay = true;
    st.picture_number++;
    if (!workarounds()) return kUnsupported;
    alloc_vop();
    if (type == 2 && ref_last < 0) return 0;  // FFmpeg skips a B-VOP without its references
    if (type == 1 && ref_next < 0) {
      // a P-VOP with nothing to predict from (a stream cut mid-way): FFmpeg
      // predicts it from ff_mpv_frame_start's dummy picture, samples 0x80
      // over the frame's size and the new buffer's zeros past it in the
      // macroblock rows, and where output is delayed shows that picture,
      // as of the P-VOP's packet; MP4, whose reads start at sync samples,
      // drops it
      if (!packet_mode) return 0;
      ref_next = ref_last == 0 ? 1 : 0;
      Picture& grey = pics[ref_next];
      grey.tag = packet_tag + 0xffffffffLL;
      if (!headers_only) {
        const int cw = (width + 1) / 2, ch = (height + 1) / 2;
        for (auto* plane : {&grey.y, &grey.u, &grey.v}) std::fill(plane->begin(), plane->end(), 0);
        for (int r = 0; r < height; r++)
          std::fill_n(grey.y.begin() + ptrdiff_t(r) * grey.stride_y, width, 0x80);
        for (int r = 0; r < ch; r++) {
          std::fill_n(grey.u.begin() + ptrdiff_t(r) * grey.stride_c, cw, 0x80);
          std::fill_n(grey.v.begin() + ptrdiff_t(r) * grey.stride_c, cw, 0x80);
        }
      }
    }
    // the picture to write: a free one; an I- or P-VOP becomes the future
    // reference and the future one the past
    int target = 0;
    while (target == ref_last || target == ref_next) target++;
    if (type != 2) {
      ref_last = ref_next;
      ref_next = target;
    }
    cur = &pics[target];
    if (headers_only) return 1;
    // decode every packet
    mb_x = mb_y = 0;
    bool ok = true;
    while (ok) {
      resync_x = mb_x;
      resync_y = mb_y;
      first_slice_line = true;
      bool packet_end = false;
      for (; mb_y < mb_h && !packet_end; mb_y++) {
        for (; mb_x < mb_w; mb_x++) {
          if (resync_x == mb_x && resync_y + 1 == mb_y) first_slice_line = false;
          if (!(type == 2 ? decode_mb_b(b) : decode_mb(b))) {
            ok = false;
            break;
          }
          if (b.pos > b.nbits) {
            ok = fail("read past the end of the VOP");
            break;
          }
          reconstruct();
          if (type != 2) update_after_mb();
          int next = is_resync(b);
          if (next) {
            const int here = mb_x + mb_y * mb_w + 1;
            // at the last macroblock anything that looks like a marker ends
            // the VOP (the next VOP's start code of a packed bitstream does)
            if (here == mb_num || here == next) {
              packet_end = true;
              mb_x++;
              if (mb_x >= mb_w) {
                mb_x = 0;
                mb_y++;
              }
              break;
            }
            if (next < 0) {
              ok = fail("damaged resync marker");
              break;
            }
            if (here > next) {
              ok = fail("overlapping video packets");
              break;
            }
          }
        }
        if (!ok || packet_end) break;
        mb_x = 0;
      }
      if (!ok) break;
      if (mb_y >= mb_h) {
        if (!packet_end) {
          int64_t left = b.left();
          if (left < 0 || left > 7) ok = fail("VOP does not end at its last macroblock");
        }
        break;
      }
      // another packet
      int expect = mb_x + mb_y * mb_w;
      if (!packet_header(b)) {
        ok = false;
        break;
      }
      if (mb_x + mb_y * mb_w != expect) {
        // a B-VOP's packet may start past macroblocks the future reference skipped
        bool skipped_run = type == 2 && mb_x + mb_y * mb_w > expect;
        for (int k = expect; skipped_run && k < mb_x + mb_y * mb_w; k++)
          skipped_run = ref_skip[size_t(k)] != 0;
        if (!skipped_run) {
          ok = fail("macroblocks missing between video packets");
          break;
        }
        int resume = mb_x + mb_y * mb_w;
        for (int k = expect; k < resume; k++) {
          mb_x = k % mb_w;
          mb_y = k / mb_w;
          decode_mb_b(b);
          reconstruct();
        }
        mb_x = resume % mb_w;
        mb_y = resume / mb_w;
      }
      clean_ac_for_packet();
    }
    if (!ok) {
      ref_last = ref_next = -1;
      return kInvalid;
    }
    return 1;
  }

  // FFmpeg's ff_h263_decode_frame around one packet: a packed VOP held
  // from the packet before is decoded in its place, a B-VOP without both
  // references is skipped, and the picture shown is the decoded B-VOP (or
  // any picture without delay) or else the past reference.
  int decode_packet(const uint8_t* buf, size_t n, int64_t index) {
    out = nullptr;
    if (st.packed && !stored.empty()) {
      for (size_t i = 0; i + 3 < n; i++)
        if (buf[i] == 0 && buf[i + 1] == 0 && buf[i + 2] == 1) {
          if (buf[i + 3] == 0xb0) stored.clear();  // a new sequence drops it
          break;
        }
    }
    const bool use_stored = !stored.empty() && (st.packed || n <= 19);
    std::vector<uint8_t> held;
    int64_t base = index << 32;
    if (use_stored) {
      held.swap(stored);
      base = stored_tag;
    }
    packet_tag = index << 32;
    stored.clear();
    if (st.picture_number == 0 && !config.empty()) walk(config.data(), config.size(), true);
    err.clear();
    int r = use_stored ? walk(held.data(), held.size(), false) : walk(buf, n, false);
    if (r <= 0) return r;
    cur->tag = base + vop_offset;
    if (st.packed) {
      // the rest of the packet, from the next VOP on, when that is an I- or
      // a B-VOP (FFmpeg's ff_mpeg4_frame_end)
      size_t from = use_stored ? 0 : size_t(vop_offset) + 4;
      if (n > from + 7)
        for (size_t i = from; i + 4 < n; i++)
          if (buf[i] == 0 && buf[i + 1] == 0 && buf[i + 2] == 1 && buf[i + 3] == 0xb6) {
            if (!(buf[i + 4] & 0x40)) {
              stored.assign(buf + i, buf + n);
              stored_tag = (index << 32) + int64_t(i);
            }
            break;
          }
    }
    if (pict_type == 2 || st.low_delay) out = cur;
    else if (ref_last >= 0) out = &pics[ref_last];
    return out ? 1 : 0;
  }
};

Mpeg4Decoder::Mpeg4Decoder() : impl_(new Impl) {}
Mpeg4Decoder::~Mpeg4Decoder() { delete impl_; }

int Mpeg4Decoder::configure(const uint8_t* p, size_t n, std::string* msg) {
  impl_->err.clear();
  impl_->config.assign(p, p + n);
  int r = impl_->walk(p, n, true);
  if (r < 0) *msg = impl_->err;
  return r < 0 ? r : kOk;
}

int Mpeg4Decoder::decode(const uint8_t* p, size_t n, std::string* msg) {
  impl_->err.clear();
  impl_->unsupported = false;
  int r = impl_->walk(p, n, false);
  if (r < 0) *msg = impl_->err;
  return r;
}

void Mpeg4Decoder::set_packet_mode(uint32_t codec_tag) {
  impl_->packet_mode = true;
  impl_->codec_tag = codec_tag;
}

int Mpeg4Decoder::decode_packet(const uint8_t* p, size_t n, int64_t index, bool headers_only,
                                std::string* msg) {
  impl_->unsupported = false;
  impl_->headers_only = headers_only;
  int r = impl_->decode_packet(p, n, index);
  impl_->headers_only = false;
  if (r < 0) *msg = impl_->err;
  return r;
}

int Mpeg4Decoder::drain() {
  Impl* d = impl_;
  d->out = nullptr;
  if (d->st.low_delay || d->ref_next < 0) return 0;
  d->out = &d->pics[d->ref_next];
  d->ref_next = -1;
  return 1;
}

void Mpeg4Decoder::flush() {
  impl_->ref_last = impl_->ref_next = -1;
  impl_->stored.clear();
  impl_->pp_time = 0;
}
const Picture& Mpeg4Decoder::picture() const { return *impl_->cur; }
const Picture& Mpeg4Decoder::output() const { return *impl_->out; }
Mpeg4State Mpeg4Decoder::state() const { return impl_->st; }
void Mpeg4Decoder::restore(const Mpeg4State& s) { impl_->st = s; }
int Mpeg4Decoder::width() const { return impl_->width; }
int Mpeg4Decoder::height() const { return impl_->height; }
bool Mpeg4Decoder::full_range() const { return impl_->full_range; }

}  // namespace video
