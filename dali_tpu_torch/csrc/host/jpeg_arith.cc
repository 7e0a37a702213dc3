// Arithmetic (QM-coder) entropy decoding of JPEG scans: ITU T.81 Annex D
// (the decoder and its probability estimation), F.2.4 (sequential DC and AC
// statistics) and G.1.3 / G.2 (progressive DC first and refine, AC first and
// refine). libjpeg-free.
//
// The decoder follows libjpeg-turbo 2.1.5's jdarith.c where it leaves the
// standard, since that library is the reference's route for these streams:
// past a marker or the end of the data it reads zero bytes (libjpeg's memory
// source supplies an EOI marker for the missing bytes), a spectral or
// magnitude overflow stops the decoding of the scan until the next restart,
// and restart markers are found and resynchronised as jdmarker.c does.

#include <cstdint>
#include <cstring>

#include "jpeg_full.h"

namespace dali_tpu_torch {

namespace {

// T.81 Table D.2 in jdarith.c's packed form: Qe << 16 | Next_Index_MPS << 8
// | Switch_MPS << 7 | Next_Index_LPS. Entry 113 is the fixed estimate of 0.5
// (T.851 Table 5) that the sign and refinement bits use.
#define V(i, qe, nl, nm, sw) ((int64_t)(qe) << 16 | (nm) << 8 | (sw) << 7 | (nl))
const int64_t kAritab[114] = {
    V(0, 0x5a1d, 1, 1, 1),       V(1, 0x2586, 14, 2, 0),      V(2, 0x1114, 16, 3, 0),
    V(3, 0x080b, 18, 4, 0),      V(4, 0x03d8, 20, 5, 0),      V(5, 0x01da, 23, 6, 0),
    V(6, 0x00e5, 25, 7, 0),      V(7, 0x006f, 28, 8, 0),      V(8, 0x0036, 30, 9, 0),
    V(9, 0x001a, 33, 10, 0),     V(10, 0x000d, 35, 11, 0),    V(11, 0x0006, 9, 12, 0),
    V(12, 0x0003, 10, 13, 0),    V(13, 0x0001, 12, 13, 0),    V(14, 0x5a7f, 15, 15, 1),
    V(15, 0x3f25, 36, 16, 0),    V(16, 0x2cf2, 38, 17, 0),    V(17, 0x207c, 39, 18, 0),
    V(18, 0x17b9, 40, 19, 0),    V(19, 0x1182, 42, 20, 0),    V(20, 0x0cef, 43, 21, 0),
    V(21, 0x09a1, 45, 22, 0),    V(22, 0x072f, 46, 23, 0),    V(23, 0x055c, 48, 24, 0),
    V(24, 0x0406, 49, 25, 0),    V(25, 0x0303, 51, 26, 0),    V(26, 0x0240, 52, 27, 0),
    V(27, 0x01b1, 54, 28, 0),    V(28, 0x0144, 56, 29, 0),    V(29, 0x00f5, 57, 30, 0),
    V(30, 0x00b7, 59, 31, 0),    V(31, 0x008a, 60, 32, 0),    V(32, 0x0068, 62, 33, 0),
    V(33, 0x004e, 63, 34, 0),    V(34, 0x003b, 32, 35, 0),    V(35, 0x002c, 33, 9, 0),
    V(36, 0x5ae1, 37, 37, 1),    V(37, 0x484c, 64, 38, 0),    V(38, 0x3a0d, 65, 39, 0),
    V(39, 0x2ef1, 67, 40, 0),    V(40, 0x261f, 68, 41, 0),    V(41, 0x1f33, 69, 42, 0),
    V(42, 0x19a8, 70, 43, 0),    V(43, 0x1518, 72, 44, 0),    V(44, 0x1177, 73, 45, 0),
    V(45, 0x0e74, 74, 46, 0),    V(46, 0x0bfb, 75, 47, 0),    V(47, 0x09f8, 77, 48, 0),
    V(48, 0x0861, 78, 49, 0),    V(49, 0x0706, 79, 50, 0),    V(50, 0x05cd, 48, 51, 0),
    V(51, 0x04de, 50, 52, 0),    V(52, 0x040f, 50, 53, 0),    V(53, 0x0363, 51, 54, 0),
    V(54, 0x02d4, 52, 55, 0),    V(55, 0x025c, 53, 56, 0),    V(56, 0x01f8, 54, 57, 0),
    V(57, 0x01a4, 55, 58, 0),    V(58, 0x0160, 56, 59, 0),    V(59, 0x0125, 57, 60, 0),
    V(60, 0x00f6, 58, 61, 0),    V(61, 0x00cb, 59, 62, 0),    V(62, 0x00ab, 61, 63, 0),
    V(63, 0x008f, 61, 32, 0),    V(64, 0x5b12, 65, 65, 1),    V(65, 0x4d04, 80, 66, 0),
    V(66, 0x412c, 81, 67, 0),    V(67, 0x37d8, 82, 68, 0),    V(68, 0x2fe8, 83, 69, 0),
    V(69, 0x293c, 84, 70, 0),    V(70, 0x2379, 86, 71, 0),    V(71, 0x1edf, 87, 72, 0),
    V(72, 0x1aa9, 87, 73, 0),    V(73, 0x174e, 72, 74, 0),    V(74, 0x1424, 72, 75, 0),
    V(75, 0x119c, 74, 76, 0),    V(76, 0x0f6b, 74, 77, 0),    V(77, 0x0d51, 75, 78, 0),
    V(78, 0x0bb6, 77, 79, 0),    V(79, 0x0a40, 77, 48, 0),    V(80, 0x5832, 80, 81, 1),
    V(81, 0x4d1c, 88, 82, 0),    V(82, 0x438e, 89, 83, 0),    V(83, 0x3bdd, 90, 84, 0),
    V(84, 0x34ee, 91, 85, 0),    V(85, 0x2eae, 92, 86, 0),    V(86, 0x299a, 93, 87, 0),
    V(87, 0x2516, 86, 71, 0),    V(88, 0x5570, 88, 89, 1),    V(89, 0x4ca9, 95, 90, 0),
    V(90, 0x44d9, 96, 91, 0),    V(91, 0x3e22, 97, 92, 0),    V(92, 0x3824, 99, 93, 0),
    V(93, 0x32b4, 99, 94, 0),    V(94, 0x2e17, 93, 86, 0),    V(95, 0x56a8, 95, 96, 1),
    V(96, 0x4f46, 101, 97, 0),   V(97, 0x47e5, 102, 98, 0),   V(98, 0x41cf, 103, 99, 0),
    V(99, 0x3c3d, 104, 100, 0),  V(100, 0x375e, 99, 93, 0),   V(101, 0x5231, 105, 102, 0),
    V(102, 0x4c0f, 106, 103, 0), V(103, 0x4639, 107, 104, 0), V(104, 0x415e, 103, 99, 0),
    V(105, 0x5627, 105, 106, 1), V(106, 0x50e7, 108, 107, 0), V(107, 0x4b85, 109, 103, 0),
    V(108, 0x5597, 110, 109, 0), V(109, 0x504f, 111, 107, 0), V(110, 0x5a10, 110, 111, 1),
    V(111, 0x5522, 112, 109, 0), V(112, 0x59eb, 112, 111, 1), V(113, 0x5a1d, 113, 113, 0)};
#undef V

// zigzag index -> natural index
constexpr unsigned char kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kDcBins = 64, kAcBins = 256;

// The decoder's helpers are inlined into arith_decode_scan (see ScanState).
#define ARITH_INLINE inline __attribute__((always_inline))

// The entropy decoder's state and libjpeg's view of the input: its memory
// source (two bytes FF D9 again and again past the end) and the marker it
// has read but not yet acted on.
struct QmDecoder {
  const uint8_t* d;
  size_t n, pos;
  int eof_phase = 0;
  int unread_marker = 0;
  size_t marker_pos = 0;  // index of the FF before unread_marker's code (n: past the end)
  int next_restart = 0;
  int64_t c = 0, a = 0;
  int ct = -16;

  ARITH_INLINE int get_byte() {
    if (pos < n) return d[pos++];
    return (eof_phase++ & 1) ? 0xD9 : 0xFF;
  }

  // jdmarker.c next_marker: skip to the next FF xx with xx neither 00 nor FF
  void next_marker() {
    for (;;) {
      int ch = get_byte();
      while (ch != 0xFF) ch = get_byte();
      do ch = get_byte();
      while (ch == 0xFF);
      if (ch != 0) {
        unread_marker = ch;
        marker_pos = eof_phase ? n : pos - 2;
        return;
      }
    }
  }

  // jdmarker.c read_restart_marker and jpeg_resync_to_restart
  void read_restart_marker() {
    if (unread_marker == 0) next_marker();
    const int want = next_restart;
    if (unread_marker == 0xD0 + want) {
      unread_marker = 0;
    } else {
      for (;;) {
        const int m = unread_marker;
        int action;
        if (m < 0xC0)
          action = 2;
        else if (m < 0xD0 || m > 0xD7)
          action = 3;
        else if (m == 0xD0 + ((want + 1) & 7) || m == 0xD0 + ((want + 2) & 7))
          action = 3;
        else if (m == 0xD0 + ((want - 1) & 7) || m == 0xD0 + ((want - 2) & 7))
          action = 2;
        else
          action = 1;
        if (action == 1) {
          unread_marker = 0;
          break;
        }
        if (action == 3) break;
        next_marker();
      }
    }
    next_restart = (next_restart + 1) & 7;
  }

  void reset() {
    c = 0;
    a = 0;
    ct = -16;
  }

  // jdarith.c arith_decode: one binary decision with the statistics bin st
  // (the registers in locals: a store through st may alias them)
  ARITH_INLINE int decode(unsigned char* st) {
    int64_t a_ = a, c_ = c;
    int ct_ = ct;
    while (a_ < 0x8000) {
      if (--ct_ < 0) {
        int data;
        if (unread_marker) {
          data = 0;
        } else {
          data = get_byte();
          if (data == 0xFF) {
            do data = get_byte();
            while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              unread_marker = data;
              marker_pos = eof_phase ? n : pos - 2;
              data = 0;
            }
          }
        }
        c_ = (c_ << 8) | data;
        if ((ct_ += 8) < 0)
          if (++ct_ == 0) a_ = 0x8000;
      }
      a_ <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const unsigned char nl = (unsigned char)(qe & 0xFF);
    qe >>= 8;
    const unsigned char nm = (unsigned char)(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a_ - qe;
    a_ = temp;
    temp <<= ct_;
    unsigned char next = (unsigned char)sv;
    if (c_ >= temp) {
      c_ -= temp;
      if (a_ < qe) {
        next = (unsigned char)((sv & 0x80) ^ nm);
      } else {
        next = (unsigned char)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
      a_ = qe;
    } else if (a_ < 0x8000) {
      if (a_ < qe) {
        next = (unsigned char)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        next = (unsigned char)((sv & 0x80) ^ nm);
      }
    }
    a = a_;
    c = c_;
    ct = ct_;
    *st = next;
    return sv >> 7;
  }
};

// The statistics bins of the 16 conditioning tables of each kind.
struct Stats {
  unsigned char dc[16][kDcBins];
  unsigned char ac[16][kAcBins];
};

// One scan's decoder state, a local of arith_decode_scan with every helper
// inlined, so that its registers stay in registers: the bins are stored
// through pointers into Stats, which cannot alias it.
struct ScanState {
  QmDecoder q;
  unsigned char (*dc_stats)[kDcBins];
  unsigned char (*ac_stats)[kAcBins];
  unsigned char fixed_bin = 113;
  int last_dc[4] = {0, 0, 0, 0};
  int dc_context[4] = {0, 0, 0, 0};
};

// F.1.4.4.1 / F.2.4.1: one DC difference with the slot's conditioning.
// Returns false on a magnitude overflow (the decoder then stops).
ARITH_INLINE bool decode_dc_diff(ScanState& S, const ArithScan& s, int slot, int* diff) {
  const int tbl = s.td[slot];
  unsigned char* base = S.dc_stats[tbl];
  unsigned char* st = base + S.dc_context[slot];
  if (S.q.decode(st) == 0) {
    S.dc_context[slot] = 0;
    *diff = 0;
    return true;
  }
  const int sign = S.q.decode(st + 1);
  st += 2 + sign;
  int m = S.q.decode(st);
  if (m != 0) {
    st = base + 20;
    while (S.q.decode(st)) {
      if ((m <<= 1) == 0x8000) {
        S.q.ct = -1;
        return false;
      }
      st += 1;
    }
  }
  if (m < (int)((1L << s.dc_l[tbl]) >> 1))
    S.dc_context[slot] = 0;
  else if (m > (int)((1L << s.dc_u[tbl]) >> 1))
    S.dc_context[slot] = 12 + sign * 4;
  else
    S.dc_context[slot] = 4 + sign * 4;
  int v = m;
  st += 14;
  while (m >>= 1)
    if (S.q.decode(st)) v |= m;
  v += 1;
  if (sign) v = -v;
  *diff = v;
  return true;
}

// F.2.4.2 / G.1.3.2: the value of a nonzero AC coefficient at zigzag index k
// whose statistics start at st (the bin of its "zero run" decision + 1).
// Returns false on a magnitude overflow.
ARITH_INLINE bool decode_ac_value(ScanState& S, const ArithScan& s, int tbl, int k, unsigned char* st,
                     int* out) {
  const int sign = S.q.decode(&S.fixed_bin);
  st += 2;
  int m = S.q.decode(st);
  if (m != 0) {
    if (S.q.decode(st)) {
      m <<= 1;
      st = S.ac_stats[tbl] + (k <= s.ac_k[tbl] ? 189 : 217);
      while (S.q.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          S.q.ct = -1;
          return false;
        }
        st += 1;
      }
    }
  }
  int v = m;
  st += 14;
  while (m >>= 1)
    if (S.q.decode(st)) v |= m;
  v += 1;
  if (sign) v = -v;
  *out = v;
  return true;
}

// Statistics of the scan's tables back to their initial state (start of a
// scan and each restart), with the DC predictions and contexts.
ARITH_INLINE void reset_stats(ScanState& S, const ArithScan& s) {
  for (int i = 0; i < s.ns; i++) {
    if (!s.progressive || (s.ss == 0 && s.ah == 0)) {
      std::memset(S.dc_stats[s.td[i]], 0, kDcBins);
      S.last_dc[i] = 0;
      S.dc_context[i] = 0;
    }
    if (!s.progressive || s.ss != 0) std::memset(S.ac_stats[s.ta[i]], 0, kAcBins);
  }
  S.q.reset();
}

// jdarith.c decode_mcu: one sequential block (DC, then AC 1-63), natural order
ARITH_INLINE void seq_block(ScanState& S, const ArithScan& s, int slot, short* blk) {
  int diff;
  if (!decode_dc_diff(S, s, slot, &diff)) return;
  S.last_dc[slot] = (S.last_dc[slot] + diff) & 0xffff;
  blk[0] = (short)S.last_dc[slot];
  const int tbl = s.ta[slot];
  for (int k = 1; k <= 63; k++) {
    unsigned char* st = S.ac_stats[tbl] + 3 * (k - 1);
    if (S.q.decode(st)) break;  // EOB
    while (S.q.decode(st + 1) == 0) {
      st += 3;
      if (++k > 63) {
        S.q.ct = -1;  // spectral overflow
        return;
      }
    }
    int v;
    if (!decode_ac_value(S, s, tbl, k, st, &v)) return;
    blk[kNatural[k]] = (short)v;
  }
}

// decode_mcu_AC_first: band [ss, se] of one block, zigzag order
ARITH_INLINE void ac_first_block(ScanState& S, const ArithScan& s, short* blk) {
  const int tbl = s.ta[0];
  for (int k = s.ss; k <= s.se; k++) {
    unsigned char* st = S.ac_stats[tbl] + 3 * (k - 1);
    if (S.q.decode(st)) break;  // EOB
    while (S.q.decode(st + 1) == 0) {
      st += 3;
      if (++k > s.se) {
        S.q.ct = -1;
        return;
      }
    }
    int v;
    if (!decode_ac_value(S, s, tbl, k, st, &v)) return;
    blk[k] = (short)((unsigned)v << s.al);
  }
}

// decode_mcu_AC_refine: band [ss, se] of one block, zigzag order
ARITH_INLINE void ac_refine_block(ScanState& S, const ArithScan& s, short* blk) {
  const int tbl = s.ta[0];
  const int p1 = 1 << s.al, m1 = (int)(-1u << s.al);
  int kex = s.se;
  for (; kex > 0; kex--)
    if (blk[kex]) break;
  for (int k = s.ss; k <= s.se; k++) {
    unsigned char* st = S.ac_stats[tbl] + 3 * (k - 1);
    if (k > kex && S.q.decode(st)) break;  // EOB
    for (;;) {
      short* coef = blk + k;
      if (*coef) {
        if (S.q.decode(st + 2)) *coef = (short)(*coef + (*coef < 0 ? m1 : p1));
        break;
      }
      if (S.q.decode(st + 1)) {
        *coef = (short)(S.q.decode(&S.fixed_bin) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > s.se) {
        S.q.ct = -1;
        return;
      }
    }
  }
}

}  // namespace

const uint8_t* arith_decode_scan(const uint8_t* data, size_t len, const uint8_t* scan_start,
                                 const ArithScan& s, const ArithPlane* planes, int mcus_x,
                                 int mcus_y) {
  static thread_local Stats T;
  ScanState S{QmDecoder{data, len, (size_t)(scan_start - data)}, T.dc, T.ac};
  std::memset(&T, 0, sizeof(T));
  reset_stats(S, s);
  const bool single = s.ns == 1;
  const ArithPlane& p0 = planes[0];
  const int nx = single ? p0.bw : mcus_x, ny = single ? p0.bh : mcus_y;
  int togo = s.ri;
  short dummy[64];
  for (int my = 0; my < ny; my++) {
    for (int mx = 0; mx < nx; mx++) {
      if (s.ri) {
        if (togo == 0) {
          S.q.read_restart_marker();
          reset_stats(S, s);
          togo = s.ri;
        }
        togo--;
      }
      if (S.q.ct == -1) continue;
      for (int i = 0; i < s.ns; i++) {
        const ArithPlane& P = planes[i];
        const int bv = single ? 1 : P.v, bh = single ? 1 : P.h;
        for (int by = 0; by < bv; by++)
          for (int bx = 0; bx < bh; bx++) {
            const int r = single ? my : my * P.v + by, col = single ? mx : mx * P.h + bx;
            short* blk = dummy;
            if (r < P.rows && col < P.stride) blk = P.coef + ((size_t)r * P.stride + col) * 64;
            else std::memset(dummy, 0, sizeof(dummy));
            if (!s.progressive) {
              seq_block(S, s, i, blk);
            } else if (s.ss == 0 && s.ah == 0) {
              int diff;
              if (decode_dc_diff(S, s, i, &diff)) {
                S.last_dc[i] += diff;
                blk[0] = (short)((unsigned)S.last_dc[i] << s.al);
              }
            } else if (s.ss == 0) {
              if (S.q.decode(&S.fixed_bin)) blk[0] = (short)(blk[0] | (1 << s.al));
            } else if (s.ah == 0) {
              ac_first_block(S, s, blk);
            } else {
              ac_refine_block(S, s, blk);
            }
            if (S.q.ct == -1) goto next_mcu;
          }
      }
    next_mcu:;
    }
  }
  return data + (S.q.unread_marker ? S.q.marker_pos : S.q.pos);
}

}  // namespace dali_tpu_torch
