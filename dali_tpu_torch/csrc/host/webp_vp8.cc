// VP8 key-frame decoder written from RFC 6386, for the lossy WebP decode of
// dali_tpu_torch. WebP holds one key frame, so there is no inter prediction.
// It follows libwebp's reading of the RFC where the two could part, since
// cv2.imdecode gives dali_tpu libwebp's output:
//
// * the boolean decoder fails a partition it reads past its end (libwebp's
//   end-of-stream flag), and a frame whose last partition is empty;
// * the segment map and the per-segment quantiser and filter levels, absolute
//   or relative; 1, 2, 4 or 8 token partitions; token-probability updates and
//   the skip probability;
// * intra prediction from unfiltered neighbours: 16x16 and chroma modes (DC
//   without top or left), B_PRED's ten 4x4 modes with above/left mode
//   contexts, 127 above the frame and 129 left of it, and the above-right
//   pixels of sub-blocks in column 3 taken from the macroblock's top-right
//   (the top row's last pixel repeated in the last macroblock column);
// * the inverse WHT and the 4x4 IDCT (20091 / 35468), coefficients in int16;
//   a block with coefficients past the third goes through the IDCT in 16-bit
//   lanes, as libwebp's SSE2 transform computes it on x86-64 (sums wrap,
//   products are mulhi), and so do all four chroma blocks of a plane when
//   any of them has an AC coefficient; the others take the exact 32-bit
//   DC-only and three-coefficient forms. The two agree on every stream an
//   encoder writes and part only on corrupt coefficients;
// * the normal and simple loop filters after the frame is reconstructed, in
//   macroblock order, with sharpness, HEV thresholds and the mode/ref deltas.
//   As in libwebp a frame-level filter level of 0 turns filtering off even
//   where segments set their own levels.

#include <cstdlib>
#include <cstring>

#include "webp.h"
#include "webp_tables.h"

namespace dali_webp {
namespace {

constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

// intra modes: 16x16 and chroma use the first four
enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED,
       B_VL_PRED, B_HD_PRED, B_HU_PRED };
enum { DC_PRED = B_DC_PRED, TM_PRED = B_TM_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED,
       DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6 };
// the sub-block mode tree (RFC 6386 11.2); leaves are negated modes
constexpr int8_t kYModesIntra4[18] = {-B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6,
                                      -B_HE_PRED, 5, -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7,
                                      -B_VL_PRED, 8, -B_HD_PRED, -B_HU_PRED};

constexpr int BPS = 32;  // stride of the per-macroblock work buffers

// Boolean entropy decoder (RFC 6386 section 7), holding up to 56 bits
// ahead. ``eof`` is libwebp's flag: a bit was asked for after every byte of
// the partition was shifted in (the window then fills with zeros).
class BoolDecoder {
 public:
  void init(const uint8_t* p, size_t n) {
    buf_ = p;
    end_ = p + n;
    value_ = 0;
    range_ = 255 - 1;
    bits_ = -8;
    eof_ = false;
    load();
  }
  __attribute__((always_inline)) int get(int prob) {
    if (bits_ < 0) load();
    const int pos = bits_;
    uint32_t range = range_;  // range - 1
    const uint32_t split = (range * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t value = static_cast<uint32_t>(value_ >> pos);
    const int bit = value > split;
    if (bit) {
      range -= split;
      value_ -= static_cast<uint64_t>(split + 1) << pos;
    } else {
      range = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(range));
    range <<= shift;
    bits_ -= shift;
    range_ = range - 1;
    return bit;
  }
  int value(int bits) {
    int v = 0;
    while (bits-- > 0) v |= get(0x80) << bits;
    return v;
  }
  int signed_value(int bits) {
    const int v = value(bits);
    return get(0x80) ? -v : v;
  }
  bool eof() const { return eof_; }

 private:
  void load() {
    if (end_ - buf_ >= 8) {  // 7 bytes at once
      uint64_t in;
      std::memcpy(&in, buf_, 8);
      buf_ += 7;
      value_ = (value_ << 56) | (__builtin_bswap64(in) >> 8);
      bits_ += 56;
    } else if (buf_ < end_) {
      value_ = (value_ << 8) | *buf_++;
      bits_ += 8;
    } else if (!eof_) {
      value_ <<= 8;
      bits_ += 8;
      eof_ = true;
    } else {
      bits_ = 0;  // keeps the shifts defined; the partition has failed
    }
  }
  const uint8_t* buf_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  uint32_t range_ = 254;
  int bits_ = -8;
  bool eof_ = false;
};

struct FInfo {
  int limit = 0, ilevel = 0, hev = 0, inner = 0;
};

struct MbCtx {  // non-zero flags of a macroblock's edge blocks
  uint8_t y[4] = {0}, u[2] = {0}, v[2] = {0}, dc = 0;
};

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : static_cast<uint8_t>(v); }

// ---------------------------------------------------------------- transforms
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform_add(const int16_t* in, uint8_t* dst) {
  int c[16];
  int* tmp = c;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int cc = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + cc;
    tmp[2] = b - cc;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = c;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int cc = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + cc) >> 3));
    dst[2] = clip8(dst[2] + ((b - cc) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += BPS;
  }
}

// libwebp's Transform_SSE2 lane by lane: 16-bit wrapping sums, the
// multiplications as mulhi by 20091 and by 35468 - 65536, the sum with the
// prediction wrapped to 16 bits and then saturated to 8.
inline int16_t w16(int v) { return static_cast<int16_t>(v); }
inline int16_t mulhi(int16_t a, int k) { return static_cast<int16_t>((a * k) >> 16); }

void transform_add16(const int16_t* in, uint8_t* dst) {
  int16_t t[4][4];  // t[x][i]: the first pass's output x of column i
  for (int i = 0; i < 4; ++i) {
    const int16_t i0 = in[i], i1 = in[4 + i], i2 = in[8 + i], i3 = in[12 + i];
    const int16_t a = w16(i0 + i2), b = w16(i0 - i2);
    const int16_t c = w16(w16(i1 - i3) + w16(mulhi(i1, -30068) - mulhi(i3, 20091)));
    const int16_t d = w16(w16(i1 + i3) + w16(mulhi(i1, 20091) + mulhi(i3, -30068)));
    t[0][i] = w16(a + d);
    t[1][i] = w16(b + c);
    t[2][i] = w16(b - c);
    t[3][i] = w16(a - d);
  }
  for (int j = 0; j < 4; ++j, dst += BPS) {  // output row j
    const int16_t T0 = t[j][0], T1 = t[j][1], T2 = t[j][2], T3 = t[j][3];
    const int16_t dc = w16(T0 + 4);
    const int16_t a = w16(dc + T2), b = w16(dc - T2);
    const int16_t c = w16(w16(T1 - T3) + w16(mulhi(T1, -30068) - mulhi(T3, 20091)));
    const int16_t d = w16(w16(T1 + T3) + w16(mulhi(T1, 20091) + mulhi(T3, -30068)));
    const int16_t out[4] = {w16(a + d), w16(b + c), w16(b - c), w16(a - d)};
    for (int x = 0; x < 4; ++x) dst[x] = clip8(w16(dst[x] + (out[x] >> 3)));
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// ---------------------------------------------------------------- predictors
#define DST(x, y) dst[(x) + (y) * BPS]
inline uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1] - tl;
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + l);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

void pred_luma16(uint8_t* dst, int mode) {
  switch (mode) {
    case V_PRED:
      for (int j = 0; j < 16; ++j) std::memcpy(dst + j * BPS, dst - BPS, 16);
      break;
    case H_PRED:
      for (int j = 0; j < 16; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], 16);
      break;
    case TM_PRED:
      true_motion(dst, 16);
      break;
    case DC_PRED: {
      int dc = 16;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, dc >> 5, 16);
      break;
    }
    case DC_NOTOP: {
      int dc = 8;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS];
      fill(dst, dc >> 4, 16);
      break;
    }
    case DC_NOLEFT: {
      int dc = 8;
      for (int i = 0; i < 16; ++i) dc += dst[i - BPS];
      fill(dst, dc >> 4, 16);
      break;
    }
    default:
      fill(dst, 0x80, 16);
  }
}

void pred_chroma8(uint8_t* dst, int mode) {
  switch (mode) {
    case V_PRED:
      for (int j = 0; j < 8; ++j) std::memcpy(dst + j * BPS, dst - BPS, 8);
      break;
    case H_PRED:
      for (int j = 0; j < 8; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], 8);
      break;
    case TM_PRED:
      true_motion(dst, 8);
      break;
    case DC_PRED: {
      int dc = 8;
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, dc >> 4, 8);
      break;
    }
    case DC_NOTOP: {
      int dc = 4;
      for (int i = 0; i < 8; ++i) dc += dst[-1 + i * BPS];
      fill(dst, dc >> 3, 8);
      break;
    }
    case DC_NOLEFT: {
      int dc = 4;
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS];
      fill(dst, dc >> 3, 8);
      break;
    }
    default:
      fill(dst, 0x80, 8);
  }
}

void pred_luma4(uint8_t* dst, int mode) {
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  const int X = dst[-1 - BPS];
  const int A = dst[-BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS];
  const int E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, dc >> 3, 4);
      break;
    }
    case B_TM_PRED:
      true_motion(dst, 4);
      break;
    case B_VE_PRED: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, v, 4);
      break;
    }
    case B_HE_PRED:
      std::memset(dst, avg3(X, I, J), 4);
      std::memset(dst + BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD_PRED:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL_PRED:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HU_PRED:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) =
          static_cast<uint8_t>(L);
      break;
    default:  // B_HD_PRED
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
  }
}
#undef DST

// ---------------------------------------------------------------- loop filter
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112]

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
}

// ``six``: a macroblock edge (6-tap), else an inner edge (4-tap)
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_t, bool six) {
  const int t2 = 2 * thresh + 1;
  for (; size-- > 0; p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t)) do_filter2(p, hstride);
    else if (six) do_filter6(p, hstride);
    else do_filter4(p, hstride);
  }
}

// ---------------------------------------------------------------- the decoder
class Decoder {
 public:
  int decode(const uint8_t* data, size_t len, Yuv* out);

 private:
  bool parse_headers(const uint8_t* data, size_t len);
  void parse_intra_mode(int mb_x);
  int get_coeffs(int type, int ctx, const int* dq, int n, int16_t* out, BoolDecoder& br);
  int get_large_value(const uint8_t* p, BoolDecoder& br);
  bool parse_residuals(int mb_x, BoolDecoder& br);
  void reconstruct(int mb_x, int mb_y);
  void filter_mb(int mb_x, int mb_y);

  int w_ = 0, h_ = 0, mb_w_ = 0, mb_h_ = 0;
  BoolDecoder br_;
  BoolDecoder parts_[8];
  int num_parts_ = 1;
  // segment header
  bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
  int quantizer_[4] = {0}, filter_strength_[4] = {0};
  int segment_proba_[3] = {255, 255, 255};
  // filter header
  bool simple_ = false;
  int level_ = 0, sharpness_ = 0;
  bool use_lf_delta_ = false;
  int ref_lf_delta_[4] = {0}, mode_lf_delta_[4] = {0};
  int filter_type_ = 0;  // 0 off, 1 simple, 2 normal
  FInfo fstrengths_[4][2];
  // quantiser per segment: y1, y2, uv as {dc, ac}
  int dq_[4][3][2];
  uint8_t proba_[4][8][3][11];
  const uint8_t (*bands_[4][17])[11];  // proba_[t][kBands[n]] by position n
  bool use_skip_proba_ = false;
  int skip_p_ = 0;
  // the current macroblock
  int segment_ = 0, is_i4x4_ = 0, skip_ = 0, uvmode_ = 0;
  uint8_t imodes_[16];
  int16_t coeffs_[384];
  uint8_t block_nz_[24];  // libwebp's per-block code: 0 all zero, else non-zero
  // contexts
  std::vector<uint8_t> intra_t_;  // 4 per macroblock column
  uint8_t intra_l_[4];
  std::vector<MbCtx> nz_top_;
  MbCtx nz_left_;
  std::vector<FInfo> finfo_;
  // the frame, macroblock-padded, unfiltered until the loop filter runs
  std::vector<uint8_t> y_, u_, v_;
  int ys_ = 0, uvs_ = 0;
};

bool Decoder::parse_headers(const uint8_t* data, size_t len) {
  if (!vp8_size(data, len, &w_, &h_)) return false;
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  const size_t part0 = bits >> 5;
  const uint8_t* buf = data + 10;
  size_t size = len - 10;
  if (part0 > size) return false;
  mb_w_ = (w_ + 15) >> 4;
  mb_h_ = (h_ + 15) >> 4;
  br_.init(buf, part0);
  buf += part0;
  size -= part0;
  BoolDecoder& br = br_;
  br.get(0x80);  // colour space
  br.get(0x80);  // clamping type: libwebp always clamps
  // segment header (RFC 6386 9.3)
  use_segment_ = br.get(0x80);
  if (use_segment_) {
    update_map_ = br.get(0x80);
    if (br.get(0x80)) {
      absolute_delta_ = br.get(0x80);
      for (int s = 0; s < 4; ++s) quantizer_[s] = br.get(0x80) ? br.signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) filter_strength_[s] = br.get(0x80) ? br.signed_value(6) : 0;
    }
    if (update_map_)
      for (int s = 0; s < 3; ++s) segment_proba_[s] = br.get(0x80) ? br.value(8) : 255;
  }
  // filter header (9.4)
  simple_ = br.get(0x80);
  level_ = br.value(6);
  sharpness_ = br.value(3);
  use_lf_delta_ = br.get(0x80);
  if (use_lf_delta_ && br.get(0x80)) {
    for (int i = 0; i < 4; ++i)
      if (br.get(0x80)) ref_lf_delta_[i] = br.signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br.get(0x80)) mode_lf_delta_[i] = br.signed_value(6);
  }
  filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
  if (br.eof()) return false;
  // token partitions (9.5)
  const int last = (1 << br.value(2)) - 1;
  num_parts_ = last + 1;
  if (size < 3 * static_cast<size_t>(last)) return false;
  const uint8_t* sz = buf;
  const uint8_t* start = buf + 3 * last;
  size_t left = size - 3 * last;
  for (int p = 0; p < last; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > left) psize = left;
    parts_[p].init(start, psize);
    start += psize;
    left -= psize;
    sz += 3;
  }
  parts_[last].init(start, left);
  if (start >= buf + size) return false;
  // quantisers (9.6)
  const int base_q0 = br.value(7);
  const int dqy1_dc = br.get(0x80) ? br.signed_value(4) : 0;
  const int dqy2_dc = br.get(0x80) ? br.signed_value(4) : 0;
  const int dqy2_ac = br.get(0x80) ? br.signed_value(4) : 0;
  const int dquv_dc = br.get(0x80) ? br.signed_value(4) : 0;
  const int dquv_ac = br.get(0x80) ? br.signed_value(4) : 0;
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int s = 0; s < 4; ++s) {
    int q;
    if (use_segment_) {
      q = quantizer_[s] + (absolute_delta_ ? 0 : base_q0);
    } else if (s > 0) {
      std::memcpy(dq_[s], dq_[0], sizeof(dq_[0]));
      continue;
    } else {
      q = base_q0;
    }
    dq_[s][0][0] = kDcTable[clip(q + dqy1_dc, 127)];
    dq_[s][0][1] = kAcTable[clip(q, 127)];
    dq_[s][1][0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    // x * 155 / 100, exactly, for every AC step
    dq_[s][1][1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (dq_[s][1][1] < 8) dq_[s][1][1] = 8;
    dq_[s][2][0] = kDcTable[clip(q + dquv_dc, 117)];
    dq_[s][2][1] = kAcTable[clip(q + dquv_ac, 127)];
  }
  br.get(0x80);  // refresh_entropy_probs: a single frame ignores it
  // token probabilities (13.4)
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          proba_[t][b][c][p] = static_cast<uint8_t>(
              br.get(kCoeffsUpdateProba[t][b][c][p]) ? br.value(8) : kCoeffsProba0[t][b][c][p]);
  for (int t = 0; t < 4; ++t)
    for (int n = 0; n < 17; ++n) bands_[t][n] = proba_[t][kBands[n]];
  use_skip_proba_ = br.get(0x80);
  if (use_skip_proba_) skip_p_ = br.value(8);
  // filter strengths by segment and by B_PRED (libwebp's precomputation)
  if (filter_type_ > 0) {
    for (int s = 0; s < 4; ++s) {
      int base = level_;
      if (use_segment_) base = filter_strength_[s] + (absolute_delta_ ? 0 : level_);
      for (int i4 = 0; i4 <= 1; ++i4) {
        FInfo& f = fstrengths_[s][i4];
        int level = base;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4) level += mode_lf_delta_[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          f.ilevel = ilevel;
          f.limit = 2 * level + ilevel;
          f.hev = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          f.limit = 0;
        }
        f.inner = i4;
      }
    }
  }
  return true;
}

void Decoder::parse_intra_mode(int mb_x) {
  BoolDecoder& br = br_;
  uint8_t* top = &intra_t_[4 * mb_x];
  segment_ = 0;
  if (update_map_)
    segment_ = !br.get(segment_proba_[0]) ? br.get(segment_proba_[1])
                                          : br.get(segment_proba_[2]) + 2;
  skip_ = use_skip_proba_ ? br.get(skip_p_) : 0;
  is_i4x4_ = !br.get(145);
  if (!is_i4x4_) {
    const int ymode = br.get(156) ? (br.get(128) ? TM_PRED : H_PRED)
                                  : (br.get(163) ? V_PRED : DC_PRED);
    imodes_[0] = static_cast<uint8_t>(ymode);
    std::memset(top, ymode, 4);
    std::memset(intra_l_, ymode, 4);
  } else {
    uint8_t* modes = imodes_;
    for (int y = 0; y < 4; ++y) {
      int ymode = intra_l_[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba[top[x]][ymode];
        int i = kYModesIntra4[br.get(prob[0])];
        while (i > 0) i = kYModesIntra4[2 * i + br.get(prob[i])];
        ymode = -i;
        top[x] = static_cast<uint8_t>(ymode);
      }
      std::memcpy(modes, top, 4);
      modes += 4;
      intra_l_[y] = static_cast<uint8_t>(ymode);
    }
  }
  uvmode_ = !br.get(142) ? DC_PRED : !br.get(114) ? V_PRED : br.get(183) ? TM_PRED : H_PRED;
}

int Decoder::get_large_value(const uint8_t* p, BoolDecoder& br) {
  int v;
  if (!br.get(p[3])) {
    v = !br.get(p[4]) ? 2 : 3 + br.get(p[5]);
  } else if (!br.get(p[6])) {
    if (!br.get(p[7])) {
      v = 5 + br.get(159);
    } else {
      v = 7 + 2 * br.get(165);
      v += br.get(145);
    }
  } else {
    const int bit1 = br.get(p[8]);
    const int bit0 = br.get(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get(*tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// The tokens of one 4x4 block from position ``n``; returns the position
// after the last one read (libwebp's GetCoeffs).
int Decoder::get_coeffs(int type, int ctx, const int* dq, int n, int16_t* out,
                        BoolDecoder& br) {
  const uint8_t(*const* bands)[11] = bands_[type];
  const uint8_t* p = bands[n][ctx];
  for (; n < 16; ++n) {
    if (!br.get(p[0])) return n;
    while (!br.get(p[1])) {
      p = bands[++n][0];
      if (n == 16) return 16;
    }
    const uint8_t(*p_ctx)[11] = bands[n + 1];
    int v;
    if (!br.get(p[2])) {
      v = 1;
      p = p_ctx[1];
    } else {
      v = get_large_value(p, br);
      p = p_ctx[2];
    }
    const int s = br.get(0x80) ? -v : v;
    out[kZigzag[n]] = static_cast<int16_t>(s * dq[n > 0]);
  }
  return 16;
}

inline uint8_t nz_code(int nz, int16_t dc) { return nz > 3 ? 3 : nz > 1 ? 2 : dc != 0; }

// Residuals of the current macroblock; true when every block is zero.
bool Decoder::parse_residuals(int mb_x, BoolDecoder& br) {
  MbCtx& top = nz_top_[mb_x];
  MbCtx& left = nz_left_;
  const int(*q)[2] = dq_[segment_];
  std::memset(coeffs_, 0, sizeof(coeffs_));
  int first, ac_type;
  if (!is_i4x4_) {
    int16_t dc[16] = {0};
    const int nz = get_coeffs(1, top.dc + left.dc, q[1], 0, dc, br);
    top.dc = left.dc = nz > 0;
    transform_wht(dc, coeffs_);
    first = 1;
    ac_type = 0;
  } else {
    first = 0;
    ac_type = 3;
  }
  bool zero = true;
  for (int y = 0; y < 4; ++y) {
    int l = left.y[y];
    for (int x = 0; x < 4; ++x) {
      int16_t* blk = coeffs_ + 16 * (4 * y + x);
      const int nz = get_coeffs(ac_type, l + top.y[x], q[0], first, blk, br);
      l = nz > first;
      top.y[x] = static_cast<uint8_t>(l);
      block_nz_[4 * y + x] = nz_code(nz, blk[0]);
      zero &= block_nz_[4 * y + x] == 0;
    }
    left.y[y] = static_cast<uint8_t>(l);
  }
  for (int ch = 0; ch < 2; ++ch) {
    uint8_t* tnz = ch ? top.v : top.u;
    uint8_t* lnz = ch ? left.v : left.u;
    for (int y = 0; y < 2; ++y) {
      int l = lnz[y];
      for (int x = 0; x < 2; ++x) {
        const int b = 16 + 4 * ch + 2 * y + x;
        const int nz = get_coeffs(2, l + tnz[x], q[2], 0, coeffs_ + 16 * b, br);
        l = nz > 0;
        tnz[x] = static_cast<uint8_t>(l);
        block_nz_[b] = nz_code(nz, coeffs_[16 * b]);
        zero &= block_nz_[b] == 0;
      }
      lnz[y] = static_cast<uint8_t>(l);
    }
  }
  return zero;
}

// libwebp's DoTransform by the block's code: the full transform in 16-bit
// lanes (3), or the exact 32-bit three-coefficient or DC-only form (2, 1)
inline void add_residual(int code, const int16_t* c, uint8_t* dst) {
  if (code == 3) transform_add16(c, dst);
  else if (code) transform_add(c, dst);
}

inline int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == DC_PRED) {
    if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mb_y == 0 ? DC_NOTOP : DC_PRED;
  }
  return mode;
}

void Decoder::reconstruct(int mb_x, int mb_y) {
  uint8_t ywork[17 * BPS], uwork[9 * BPS], vwork[9 * BPS];
  uint8_t* yd = ywork + BPS + 8;
  uint8_t* ud = uwork + BPS + 8;
  uint8_t* vd = vwork + BPS + 8;
  const int y0 = 16 * mb_y, x0 = 16 * mb_x;
  // the row above, its left corner and its four right neighbours
  if (mb_y == 0) {
    std::memset(yd - BPS - 1, 127, 21);
    std::memset(ud - BPS - 1, 127, 9);
    std::memset(vd - BPS - 1, 127, 9);
  } else {
    const uint8_t* top = &y_[(y0 - 1) * ys_ + x0];
    yd[-BPS - 1] = mb_x == 0 ? 129 : top[-1];
    std::memcpy(yd - BPS, top, 16);
    if (mb_x < mb_w_ - 1) std::memcpy(yd - BPS + 16, top + 16, 4);
    else std::memset(yd - BPS + 16, top[15], 4);
    const uint8_t* tu = &u_[(y0 / 2 - 1) * uvs_ + x0 / 2];
    const uint8_t* tv = &v_[(y0 / 2 - 1) * uvs_ + x0 / 2];
    ud[-BPS - 1] = mb_x == 0 ? 129 : tu[-1];
    vd[-BPS - 1] = mb_x == 0 ? 129 : tv[-1];
    std::memcpy(ud - BPS, tu, 8);
    std::memcpy(vd - BPS, tv, 8);
  }
  for (int j = 0; j < 16; ++j) yd[j * BPS - 1] = mb_x == 0 ? 129 : y_[(y0 + j) * ys_ + x0 - 1];
  for (int j = 0; j < 8; ++j) {
    ud[j * BPS - 1] = mb_x == 0 ? 129 : u_[(y0 / 2 + j) * uvs_ + x0 / 2 - 1];
    vd[j * BPS - 1] = mb_x == 0 ? 129 : v_[(y0 / 2 + j) * uvs_ + x0 / 2 - 1];
  }
  if (is_i4x4_) {
    // sub-blocks of column 3 below the first row see the macroblock's top-right
    for (int r = 3; r < 16; r += 4) std::memcpy(yd + r * BPS + 16, yd - BPS + 16, 4);
    for (int n = 0; n < 16; ++n) {
      uint8_t* dst = yd + (n & 3) * 4 + (n >> 2) * 4 * BPS;
      pred_luma4(dst, imodes_[n]);
      add_residual(block_nz_[n], coeffs_ + 16 * n, dst);
    }
  } else {
    pred_luma16(yd, check_mode(mb_x, mb_y, imodes_[0]));
    for (int n = 0; n < 16; ++n)
      add_residual(block_nz_[n], coeffs_ + 16 * n, yd + (n & 3) * 4 + (n >> 2) * 4 * BPS);
  }
  const int uvmode = check_mode(mb_x, mb_y, uvmode_);
  pred_chroma8(ud, uvmode);
  pred_chroma8(vd, uvmode);
  for (int ch = 0; ch < 2; ++ch) {
    const uint8_t* codes = block_nz_ + 16 + 4 * ch;
    const bool ac = codes[0] >= 2 || codes[1] >= 2 || codes[2] >= 2 || codes[3] >= 2;
    for (int n = 0; n < 4; ++n) {
      const int16_t* c = coeffs_ + 16 * (16 + 4 * ch + n);
      uint8_t* dst = (ch ? vd : ud) + (n & 1) * 4 + (n >> 1) * 4 * BPS;
      if (ac) transform_add16(c, dst);
      else if (c[0]) transform_add(c, dst);
    }
  }
  for (int j = 0; j < 16; ++j) std::memcpy(&y_[(y0 + j) * ys_ + x0], yd + j * BPS, 16);
  for (int j = 0; j < 8; ++j) {
    std::memcpy(&u_[(y0 / 2 + j) * uvs_ + x0 / 2], ud + j * BPS, 8);
    std::memcpy(&v_[(y0 / 2 + j) * uvs_ + x0 / 2], vd + j * BPS, 8);
  }
}

void Decoder::filter_mb(int mb_x, int mb_y) {
  const FInfo& f = finfo_[mb_y * mb_w_ + mb_x];
  const int limit = f.limit;
  if (limit == 0) return;
  uint8_t* yd = &y_[16 * mb_y * ys_ + 16 * mb_x];
  if (filter_type_ == 1) {
    if (mb_x > 0) simple_filter(yd, 1, ys_, limit + 4);
    if (f.inner)
      for (int k = 4; k < 16; k += 4) simple_filter(yd + k, 1, ys_, limit);
    if (mb_y > 0) simple_filter(yd, ys_, 1, limit + 4);
    if (f.inner)
      for (int k = 4; k < 16; k += 4) simple_filter(yd + k * ys_, ys_, 1, limit);
    return;
  }
  uint8_t* ud = &u_[8 * mb_y * uvs_ + 8 * mb_x];
  uint8_t* vd = &v_[8 * mb_y * uvs_ + 8 * mb_x];
  const int il = f.ilevel, hv = f.hev;
  if (mb_x > 0) {
    filter_loop(yd, 1, ys_, 16, limit + 4, il, hv, true);
    filter_loop(ud, 1, uvs_, 8, limit + 4, il, hv, true);
    filter_loop(vd, 1, uvs_, 8, limit + 4, il, hv, true);
  }
  if (f.inner) {
    for (int k = 4; k < 16; k += 4) filter_loop(yd + k, 1, ys_, 16, limit, il, hv, false);
    filter_loop(ud + 4, 1, uvs_, 8, limit, il, hv, false);
    filter_loop(vd + 4, 1, uvs_, 8, limit, il, hv, false);
  }
  if (mb_y > 0) {
    filter_loop(yd, ys_, 1, 16, limit + 4, il, hv, true);
    filter_loop(ud, uvs_, 1, 8, limit + 4, il, hv, true);
    filter_loop(vd, uvs_, 1, 8, limit + 4, il, hv, true);
  }
  if (f.inner) {
    for (int k = 4; k < 16; k += 4) filter_loop(yd + k * ys_, ys_, 1, 16, limit, il, hv, false);
    filter_loop(ud + 4 * uvs_, uvs_, 1, 8, limit, il, hv, false);
    filter_loop(vd + 4 * uvs_, uvs_, 1, 8, limit, il, hv, false);
  }
}

int Decoder::decode(const uint8_t* data, size_t len, Yuv* out) {
  if (!parse_headers(data, len)) return -1;
  ys_ = 16 * mb_w_;
  uvs_ = 8 * mb_w_;
  y_.assign(static_cast<size_t>(ys_) * 16 * mb_h_, 0);
  u_.assign(static_cast<size_t>(uvs_) * 8 * mb_h_, 0);
  v_.assign(u_.size(), 0);
  intra_t_.assign(4 * mb_w_, B_DC_PRED);
  nz_top_.assign(mb_w_, MbCtx());
  finfo_.assign(static_cast<size_t>(mb_w_) * mb_h_, FInfo());
  for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
    BoolDecoder& tokens = parts_[mb_y & (num_parts_ - 1)];
    std::memset(intra_l_, B_DC_PRED, 4);
    nz_left_ = MbCtx();
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
      parse_intra_mode(mb_x);
      bool zero;
      if (!skip_) {
        zero = parse_residuals(mb_x, tokens);
      } else {
        MbCtx& top = nz_top_[mb_x];
        const uint8_t dc_t = top.dc, dc_l = nz_left_.dc;
        top = MbCtx();
        nz_left_ = MbCtx();
        if (is_i4x4_) {
          top.dc = dc_t;
          nz_left_.dc = dc_l;
        }
        std::memset(coeffs_, 0, sizeof(coeffs_));
        std::memset(block_nz_, 0, sizeof(block_nz_));
        zero = true;
      }
      if (tokens.eof()) return -1;
      if (filter_type_ > 0) {
        FInfo& f = finfo_[mb_y * mb_w_ + mb_x];
        f = fstrengths_[segment_][is_i4x4_];
        f.inner |= !zero;
      }
      reconstruct(mb_x, mb_y);
    }
    if (br_.eof()) return -1;
  }
  if (filter_type_ > 0)
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) filter_mb(mb_x, mb_y);
  out->w = w_;
  out->h = h_;
  const int uw = (w_ + 1) / 2, uh = (h_ + 1) / 2;
  out->y.resize(static_cast<size_t>(w_) * h_);
  out->u.resize(static_cast<size_t>(uw) * uh);
  out->v.resize(out->u.size());
  for (int j = 0; j < h_; ++j) std::memcpy(&out->y[static_cast<size_t>(j) * w_], &y_[j * ys_], w_);
  for (int j = 0; j < uh; ++j) {
    std::memcpy(&out->u[static_cast<size_t>(j) * uw], &u_[j * uvs_], uw);
    std::memcpy(&out->v[static_cast<size_t>(j) * uw], &v_[j * uvs_], uw);
  }
  return 0;
}

}  // namespace

bool vp8_size(const uint8_t* data, size_t len, int* w, int* h) {
  if (len < 10) return false;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return false;
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  if (bits & 1) return false;               // not a key frame
  if (((bits >> 1) & 7) > 3) return false;  // unknown profile
  if (!((bits >> 4) & 1)) return false;     // invisible frame
  if ((bits >> 5) >= len) return false;     // first partition past the chunk
  *w = ((data[7] << 8) | data[6]) & 0x3fff;
  *h = ((data[9] << 8) | data[8]) & 0x3fff;
  return *w != 0 && *h != 0;
}

int vp8_decode(const uint8_t* data, size_t len, Yuv* out) {
  Decoder dec;
  return dec.decode(data, len, out);
}

}  // namespace dali_webp
