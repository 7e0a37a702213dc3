// From-scratch baseline-JPEG Huffman coefficient decoder for the hybrid
// decode path. Decodes entropy data DIRECTLY into the split wire format
// (DC int16 planes, AC saturated-int8 planes restricted to the k*k
// low-frequency selection), and stops after the crop window's last MCU row.
//
// Rationale (vs routing through libjpeg's jpeg_read_coefficients):
//  * no whole-image virtual coefficient arrays (alloc + pre-zero memset),
//  * no second copy/saturate pass over all 64 coefficients per block,
//  * entropy decode cost scales with the fused RRC crop's row extent
//    (rows below the window are never decoded; rows above it are decoded
//    but not stored — sequential Huffman state demands it),
//  * libjpeg-turbo's Huffman stage is scalar anyway; its SIMD only covers
//    IDCT/color which the hybrid path runs on the TPU instead.
//
// Reference analogue: the host half of nvJPEG hybrid decoding
// (reference dali/imgcodec/decoders/nvjpeg: host Huffman -> device IDCT);
// entropy decode per ITU-T.81 sections F.2.2.1-F.2.2.4.
//
// Supported: baseline/extended-sequential (SOF0/SOF1), 8-bit, single
// interleaved scan, 3 components with 4:2:0 or 4:4:4 sampling, restart
// markers. Anything else returns nonzero and the caller falls back to the
// libjpeg path (jpeg_coeffs_split.cc).
//
// Hot-loop structure note: the scan's entropy bytes are UNSTUFFED once into
// a contiguous thread-local buffer (FF 00 -> FF, restart markers recorded,
// zero tail padding). The decode loop keeps the bit reader in two locals —
// a left-aligned 64-bit accumulator and a valid-bit count — and refills it
// BRANCHLESSLY from that buffer (one unaligned load + bswap + shift; the
// overlapping re-OR of already-buffered bits is idempotent), so there is no
// refill branch, no stuffing check, and no marker state anywhere in the
// loop. Out-of-selection coefficient stores go through a conditional-move
// select to a sink byte instead of a data-dependent branch.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>

#include <vector>

#include "jpeg_full.h"

namespace {

// Decode-phase itemization (accounts for the gap between in-pipeline and
// microbenchmark µs/img inside the native call). Relaxed atomics, a handful
// of steady_clock reads per image (~100 ns against a ~400 µs decode).
struct HuffStats {
  std::atomic<long long> ns_parse{0};     // marker walk + table builds/cache
  std::atomic<long long> ns_unstuff{0};   // FF00/RST strip pass
  std::atomic<long long> ns_scan{0};      // entropy loop (incl. unstuff)
  std::atomic<long long> ns_rowcompact{0};  // pack rows -> contiguous stream
  std::atomic<long long> tbl_hits{0};
  std::atomic<long long> tbl_misses{0};
  std::atomic<long long> n_imgs{0};
};
HuffStats g_hstats;

inline long long now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Store-phase symbol counting for the entropy-scan floor analysis
// (dali_tpu's docs/performance.md). Compile with -DDALI_TPU_COUNT_SYMS to
// enable (A/B/analysis builds only); the shipped build compiles the hooks
// to nothing. Counts one unit per Huffman symbol resolved in the store
// phase (DC + every AC_SYM invocation) and one per block.
#ifdef DALI_TPU_COUNT_SYMS
thread_local long long g_count_syms = 0, g_count_blocks = 0;
#define SYMC() (g_count_syms++)
#define BLKC() (g_count_blocks++)
#else
#define SYMC() ((void)0)
#define BLKC() ((void)0)
#endif
extern "C" void dali_tpu_scan_syms(long long out[2], int reset) {
#ifdef DALI_TPU_COUNT_SYMS
  out[0] = g_count_syms;
  out[1] = g_count_blocks;
  if (reset) g_count_syms = g_count_blocks = 0;
#else
  (void)reset;
  out[0] = out[1] = 0;
#endif
}

constexpr int kLookahead = 10;
// fast-AC table window (see build_fac; 12 bits measured +16% vs 10 on this
// host, 16 KB/table stays cache-resident; 13/14 measured on the idx-warm
// distribution — see dali_tpu's docs/performance.md). Overridable for A/B
// builds only; the shipped default is 12.
#ifndef DALI_TPU_KFASTAC
#define DALI_TPU_KFASTAC 12
#endif
constexpr int kFastAc = DALI_TPU_KFASTAC;

inline signed char sat8(int v) {
  return (signed char)(v < -128 ? -128 : v > 127 ? 127 : v);
}

// The AC store of a decode: saturated to int8 (the int8 wire) or the full
// int16 value, wrapped as libjpeg's (JCOEF) cast wraps it.
template <typename AC>
inline AC ac_cast(int v);
template <>
inline signed char ac_cast<signed char>(int v) { return sat8(v); }
template <>
inline short ac_cast<short>(int v) { return (short)v; }

// zigzag index -> natural (row-major 8x8) index
struct ZigzagTable {
  int nat[64];
  ZigzagTable() {
    int r = 0, c = 0;
    for (int i = 0; i < 64; i++) {
      nat[i] = r * 8 + c;
      if (((r + c) & 1) == 0) {  // moving up-right
        if (c == 7) r++;
        else if (r == 0) c++;
        else { r--; c++; }
      } else {  // moving down-left
        if (r == 7) c++;
        else if (c == 0) r++;
        else { r++; c--; }
      }
    }
  }
};
const ZigzagTable kZZ;

struct HuffTbl {
  int16_t lut[1 << kLookahead];  // (len<<8)|symbol for codes <= kLookahead bits
  int32_t maxcode[17];           // per length; -1 when empty
  int32_t valoff[17];
  uint8_t vals[256];
  bool valid = false;
};

// Fast-AC table (the stb_image / nvJPEG trick): for every kFastAc-bit
// window whose leading code is an AC (run, size) symbol with size>0 and
// code+magnitude fitting the window, pre-compute run, the EXTENDed value
// (pre-saturated to int8 — exactly what the wire format stores), and the
// total bits to consume. One lookup replaces symbol decode + receive+extend
// for the common small coefficients. sz==0 control symbols (EOB, ZRL) whose
// code fits the window get entries too (bit 24 set; run distinguishes them)
// — EOB fires once per block, keeping it out of the slow path matters.
// Entry 0 = not covered (regular path).
struct FastAc {
  int32_t e[1 << kFastAc];  // ctrl<<24 | (sat8(value)&0xFF)<<16 | run<<8 | nbits
};

void build_fac(const uint8_t* counts, const uint8_t* vals, FastAc* f) {
  std::memset(f->e, 0, sizeof(f->e));
  int code = 0, k = 0;
  for (int l = 1; l <= 16; l++) {
    for (int c = 0; c < counts[l]; c++, k++) {
      int cd = code + c;
      int rs = vals[k];
      int run = rs >> 4, sz = rs & 15;
      if (sz == 0) {  // EOB (run 0) / ZRL (run 15): code-only entry
        if (l > kFastAc) continue;
        int32_t entry = (1 << 24) | (run << 8) | l;
        int lo = cd << (kFastAc - l), n = 1 << (kFastAc - l);
        for (int j = 0; j < n; j++) f->e[lo + j] = entry;
        continue;
      }
      if (l + sz > kFastAc) continue;
      int tail = kFastAc - l - sz;  // free bits after code+magnitude
      for (int m = 0; m < (1 << sz); m++) {
        int v = m < (1 << (sz - 1)) ? m - (1 << sz) + 1 : m;
        // values beyond int8 take the regular path, which stores them at
        // the decode's own precision (saturated or full int16)
        if (v < -128 || v > 127) continue;
        int sv = v;
        int32_t entry =
            ((int32_t)(uint8_t)(signed char)sv << 16) | (run << 8) | (l + sz);
        int base = ((cd << sz) | m) << tail;
        for (int tfill = 0; tfill < (1 << tail); tfill++)
          f->e[base + tfill] = entry;
      }
    }
    code = (code + counts[l]) << 1;
  }
}

// Same trick for DC: (size symbol + magnitude) -> signed diff + bits
// consumed, one lookup. Entry 0 = not covered.
struct FastDc {
  int32_t e[1 << kFastAc];  // (diff as int16) << 16 | nbits
};

void build_fdc(const uint8_t* counts, const uint8_t* vals, FastDc* f) {
  std::memset(f->e, 0, sizeof(f->e));
  int code = 0, k = 0;
  for (int l = 1; l <= 16; l++) {
    for (int c = 0; c < counts[l]; c++, k++) {
      int cd = code + c;
      int sz = vals[k];
      if (sz > 11 || l + sz > kFastAc) continue;
      int tail = kFastAc - l - sz;
      int nmag = 1 << sz;  // sz==0: single entry, diff 0
      for (int m = 0; m < nmag; m++) {
        int diff = sz == 0 ? 0 : (m < (1 << (sz - 1)) ? m - (1 << sz) + 1 : m);
        int32_t entry = ((int32_t)(uint16_t)(int16_t)diff << 16) | (l + sz);
        int base = ((cd << sz) | m) << tail;
        for (int tfill = 0; tfill < (1 << tail); tfill++)
          f->e[base + tfill] = entry;
      }
    }
    code = (code + counts[l]) << 1;
  }
}

// Fast-SKIP table: skip-mode rows (above the crop window) advance the
// Huffman state without extending or storing values, so a symbol only needs
// its LENGTHS — code bits + magnitude bit count — never the magnitude bits
// themselves. That changes the coverage math vs FastAc in two ways:
//   * a single value symbol is coverable whenever its CODE fits the window
//     (l <= kFastAc), regardless of magnitude size (FastAc needs l+sz <= w
//     to precompute the extended value), so slow-path hits nearly vanish;
//   * when code1+sz1 ends early enough in the window for the SECOND code to
//     be resolved too, both symbols fuse into ONE table load — halving the
//     load->index->load serial chain that binds this decoder (~18 cy/sym).
// Entry layout (0 = not covered -> slow path):
//   bits  0-4  n1      bits to consume for symbol 1 (code+magnitude, <= 27)
//   bits  5-10 kadv1   zigzag advance (value: run+1; ZRL: 16; EOB: 0)
//   bit   11   ABORT1  symbol 1 is a value: k overrun past 63 aborts
//   bits 12-16 n2      symbol 2 bits (0 = single-symbol entry)
//   bits 17-22 kadv2
//   bit   23   ABORT2
//   bit   30   DONE2   symbol 2 is EOB
//   bit   31   DONE1   symbol 1 is EOB (sign bit: one test)
// Pairs are emitted only when n1+n2 <= 26 so a step never consumes more
// than the store-mode per-symbol worst case (budget: refill >= 56 covers
// two steps; the opportunistic third step requires cnt >= 31 >= 27).
// The overrun/exit semantics exactly mirror the store-mode loop: a value
// symbol whose run passes 63 aborts the image (k+kadv > 64), landing
// exactly ON 64 exits the block loop, ZRL past the end is tolerated —
// so corrupt-stream output stays crop-position-independent.
#ifndef DALI_TPU_KFASTSKIP
#define DALI_TPU_KFASTSKIP 12
#endif
constexpr int kFastSkip = DALI_TPU_KFASTSKIP;
struct FastSkip {
  int32_t e[1 << kFastSkip];
};

void build_fsk(const uint8_t* counts, const uint8_t* vals, FastSkip* f) {
  std::memset(f->e, 0, sizeof(f->e));
  // canonical decode tables for window-time symbol resolution
  int mincode[17], maxcode[17], valptr[17];
  {
    int code = 0, k = 0;
    for (int l = 1; l <= 16; l++) {
      valptr[l] = k;
      mincode[l] = code;
      code += counts[l];
      k += counts[l];
      maxcode[l] = code - 1;  // valid only if counts[l] > 0
      code <<= 1;
    }
  }
  // decode one symbol from the top of a kFastSkip-bit window; returns false
  // when the code does not fully fit in `avail` bits
  auto decode1 = [&](unsigned w, int avail, int* len, int* rs) {
    for (int l = 1; l <= avail; l++) {
      if (!counts[l]) continue;
      int cd = (int)(w >> (kFastSkip - l));
      if (cd >= mincode[l] && cd <= maxcode[l]) {
        *len = l;
        *rs = vals[valptr[l] + cd - mincode[l]];
        return true;
      }
    }
    return false;
  };
  for (unsigned i = 0; i < (1u << kFastSkip); i++) {
    int l1, rs1;
    if (!decode1(i, kFastSkip, &l1, &rs1)) continue;
    int r1 = rs1 >> 4, sz1 = rs1 & 15;
    int32_t e;
    int n1;
    if (sz1 == 0) {
      if (r1 == 0) {  // EOB
        f->e[i] = (int32_t)((1u << 31) | (unsigned)l1);
        continue;
      }
      // ZRL — and bogus run/0 symbols, which the store-mode FAST path also
      // advances by 16 (semantics must match per crop-independence)
      n1 = l1;
      e = n1 | (16 << 5);
    } else {
      n1 = l1 + sz1;  // value: only the BIT COUNT matters in skip mode
      e = n1 | ((r1 + 1) << 5) | (1 << 11);
    }
    if (n1 < kFastSkip) {
      // try to fuse the second symbol: its code must resolve within the
      // remaining window bits
      int l2, rs2;
      if (decode1((i << n1) & ((1u << kFastSkip) - 1), kFastSkip - n1, &l2, &rs2)) {
        int r2 = rs2 >> 4, sz2 = rs2 & 15;
        if (sz2 == 0) {
          if (r2 == 0) {  // EOB second
            if (n1 + l2 <= 26)
              e |= (l2 << 12) | (1 << 30);
          } else if (n1 + l2 <= 26) {  // ZRL second (incl. bogus run/0)
            e |= (l2 << 12) | (16 << 17);
          }
        } else if (n1 + l2 + sz2 <= 26) {
          e |= ((l2 + sz2) << 12) | ((r2 + 1) << 17) | (1 << 23);
        }
      }
    }
    f->e[i] = e;
  }
}

// Content-keyed fast-table cache: JPEGs from one encoder ship identical DHT
// segments, so the expanded 16 KB fast tables are reused across images on
// each worker thread instead of being rebuilt per image. Keyed by the raw
// (counts, vals) bytes (memcmp-verified — no hash-collision exposure).
template <typename T, void (*Build)(const uint8_t*, const uint8_t*, T*)>
struct TblCache {
  struct Slot {
    int len = -1;               // counts[1..16] + vals byte count; -1 = empty
    uint64_t stamp = 0;         // LRU recency, refreshed on HIT too
    uint8_t spec[16 + 256];
    T tbl;
  };
  Slot slots[4];
  uint64_t clock = 0;
  const T* get(const uint8_t* counts, const uint8_t* vals, int total) {
    uint8_t spec[16 + 256];
    std::memcpy(spec, counts + 1, 16);
    std::memcpy(spec + 16, vals, total);
    const int len = 16 + total;
    for (auto& s : slots)
      if (s.len == len && std::memcmp(s.spec, spec, len) == 0) {
        // refreshing on hit pins every table the current image referenced:
        // an image defines at most 4 tables of each class, so the 4 most
        // recent gets — hits included — always survive eviction
        s.stamp = ++clock;
        g_hstats.tbl_hits.fetch_add(1, std::memory_order_relaxed);
        return &s.tbl;
      }
    g_hstats.tbl_misses.fetch_add(1, std::memory_order_relaxed);
    Slot* victim = &slots[0];
    for (auto& s : slots)
      if (s.stamp < victim->stamp) victim = &s;
    Build(counts, vals, &victim->tbl);
    victim->len = len;
    victim->stamp = ++clock;
    std::memcpy(victim->spec, spec, len);
    return &victim->tbl;
  }
};
thread_local TblCache<FastAc, build_fac> g_fac_cache;
thread_local TblCache<FastDc, build_fdc> g_fdc_cache;
thread_local TblCache<FastSkip, build_fsk> g_fsk_cache;

bool build_huff(const uint8_t* counts /*[1..16]*/, const uint8_t* vals,
                int nvals, HuffTbl* t) {
  int code = 0, k = 0;
  int mincode[17];
  for (int l = 1; l <= 16; l++) {
    mincode[l] = code;
    t->valoff[l] = k - code;
    int c = counts[l];
    if (c) {
      if (k + c > nvals || k + c > 256) return false;
      if (code + c - 1 >= (1 << l)) return false;  // over-subscribed
      t->maxcode[l] = code + c - 1;
    } else {
      t->maxcode[l] = -1;
    }
    code = (code + c) << 1;
    k += c;
  }
  if (k != nvals) return false;
  std::memcpy(t->vals, vals, nvals);
  for (int i = 0; i < (1 << kLookahead); i++) t->lut[i] = -1;
  k = 0;
  for (int l = 1; l <= kLookahead; l++) {
    for (int c = 0; c < counts[l]; c++, k++) {
      int cd = mincode[l] + c;
      int lo = cd << (kLookahead - l), n = 1 << (kLookahead - l);
      int16_t e = (int16_t)((l << 8) | vals[k]);
      for (int j = 0; j < n; j++) t->lut[lo + j] = e;
    }
  }
  t->valid = true;
  return true;
}

// Unstuffed entropy stream: scan bytes with FF 00 collapsed to FF, restart
// markers stripped (their unstuffed byte offsets recorded in rst_off), and
// kTailBytes zero bytes of tail padding. Truncated/corrupt streams simply run into
// the zero padding; the decode loop bounds every store by the window maps
// and checks the bit position once per BLOCK. One block's TRUE worst case —
// adversarial Huffman tables can declare 16-bit codes with size-15
// magnitudes, so DC 31 bits + 63 AC symbols * 31 bits ~ 249 bytes — plus the
// refill lookahead (up to 7 bytes) and the 8-byte window stays well inside
// the padding, so reads stay in bounds and decode terminates cleanly (the
// same warn-and-zero-fill contract libjpeg applies to broken streams).
// The zero tail: holds the int8 read's one block past the end (~249 bytes
// worst case, see above) and the full read's MCUs decoded from zero bits.
constexpr size_t kTailBytes = 4096;
struct Unstuffed {
  std::vector<uint8_t> buf;     // reused across calls (thread-local)
  std::vector<size_t> rst_off;  // unstuffed offset just AFTER each RSTn
  size_t len = 0;               // unstuffed payload length (pre-padding)
  const uint8_t* in_end = nullptr;  // input position of the terminating marker
};

void unstuff_scan(const uint8_t* p, const uint8_t* pend, Unstuffed* u) {
  u->rst_off.clear();
  u->in_end = pend;
  size_t cap = (size_t)(pend - p) + kTailBytes;
  if (u->buf.size() < cap) u->buf.resize(cap);
  uint8_t* o = u->buf.data();
  while (p < pend) {
    const uint8_t* ff =
        (const uint8_t*)std::memchr(p, 0xFF, (size_t)(pend - p));
    if (!ff) {
      std::memcpy(o, p, (size_t)(pend - p));
      o += pend - p;
      break;
    }
    std::memcpy(o, p, (size_t)(ff - p));
    o += ff - p;
    p = ff;
    if (p + 1 >= pend) break;  // lone trailing FF: drop
    uint8_t m = p[1];
    if (m == 0x00) {  // stuffed FF
      *o++ = 0xFF;
      p += 2;
    } else if (m == 0xFF) {  // fill byte
      p++;
    } else if (m >= 0xD0 && m <= 0xD7) {  // restart marker
      u->rst_off.push_back((size_t)(o - u->buf.data()));
      p += 2;
    } else {
      u->in_end = p;  // EOI or other marker: end of scan
      break;
    }
  }
  u->len = (size_t)(o - u->buf.data());
  std::memset(o, 0, kTailBytes);
}

inline uint64_t peek64(const uint8_t* buf, uint64_t pos) {
  uint64_t x;
  std::memcpy(&x, buf + (pos >> 3), 8);
  return __builtin_bswap64(x) << (pos & 7);
}

// Codes longer than kLookahead bits: canonical decode, shortest-first.
// `w` is the left-aligned 57+ bit window at the current position.
// Returns symbol (-1 invalid) and writes the code length.
__attribute__((noinline)) int huff_decode_slow(uint64_t w, const HuffTbl* t,
                                               int* len_out) {
  unsigned code16 = (unsigned)(w >> 48);
  for (int l = kLookahead + 1; l <= 16; l++) {
    unsigned cd = code16 >> (16 - l);
    if ((int32_t)cd <= t->maxcode[l]) {
      *len_out = l;
      return t->vals[t->valoff[l] + cd];
    }
  }
  return -1;
}

struct Parser {
  const uint8_t* d;
  size_t n;
  size_t pos = 2;

  int W = 0, H = 0, prec = 0, ncomp = 0;
  struct SofComp { int id = 0, h = 0, v = 0, tq = 0; } comp[4];
  int ns = 0;
  int scan_comp[4] = {0, 0, 0, 0};  // scan slot -> SOF component index
  int scan_td[4] = {0, 0, 0, 0}, scan_ta[4] = {0, 0, 0, 0};
  int ss = 0, se = 63, ah = 0, al = 0;
  uint16_t qt[4][64];
  bool qok[4] = {false, false, false, false};
  HuffTbl htdc[4], htac[4];
  const FastAc* fac[4] = {nullptr, nullptr, nullptr, nullptr};
  const FastDc* fdc[4] = {nullptr, nullptr, nullptr, nullptr};
  const FastSkip* fsk[4] = {nullptr, nullptr, nullptr, nullptr};
  int ri = 0;
  const uint8_t* scan_start = nullptr;
  bool sof_seen = false;
  bool progressive = false;        // SOF2 stream (set when allow_progressive)
  bool allow_progressive = false;  // keep parsing instead of rc=1 on SOF2
  bool saw_eoi = false;
  bool full = false;  // full read: return at the first SOS, no fast-path check
  bool jfif = false;  // APP0 "JFIF" seen
  int adobe = -1;     // APP14 "Adobe" transform flag, -1 = no such segment

  Parser(const uint8_t* data, size_t len) : d(data), n(len) {}

  bool u8(int* v) {
    if (pos >= n) return false;
    *v = d[pos++];
    return true;
  }
  bool u16(int* v) {
    if (pos + 2 > n) return false;
    *v = (d[pos] << 8) | d[pos + 1];
    pos += 2;
    return true;
  }

  // 0 = fast path ok; 1 = valid-but-unsupported (fall back); -1 = corrupt.
  int parse() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return -1;
    for (;;) {
      int b;
      if (!u8(&b)) return -1;
      if (b != 0xFF) continue;  // lenient: skip garbage between segments
      int m;
      do {
        if (!u8(&m)) return -1;
      } while (m == 0xFF);
      if (m == 0x00 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      if (m == 0xD9) return -1;  // EOI before any scan
      int L;
      if (!u16(&L) || L < 2) return -1;
      size_t seg_end = pos + (size_t)L - 2;
      if (seg_end > n) return -1;
      int rc = 0;
      switch (m) {
        case 0xC0:
        case 0xC1:
          rc = parse_sof(seg_end);
          break;
        case 0xC4:
          rc = parse_dht(seg_end);
          break;
        case 0xDB:
          rc = parse_dqt(seg_end);
          break;
        case 0xDD: {
          int v;
          if (L != 4 || !u16(&v)) return -1;
          ri = v;
          break;
        }
        case 0xDA: {
          rc = parse_sos(seg_end);
          if (rc) return rc;
          scan_start = d + pos;
          return (progressive || full) ? 0 : check_fast();
        }
        case 0xC2:  // progressive
          if (allow_progressive) {
            rc = parse_sof(seg_end);
            progressive = true;
            break;
          }
          return 1;
        case 0xC3:  // lossless
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xC9:  // arithmetic family
        case 0xCA:
        case 0xCB:
        case 0xCC:  // DAC
        case 0xCD:
        case 0xCE:
        case 0xCF:
          return 1;
        case 0xE0:  // APP0: JFIF (libjpeg's colour-space guess reads it)
          if (L >= 16 && std::memcmp(d + pos, "JFIF\0", 5) == 0) jfif = true;
          break;
        case 0xEE:  // APP14: Adobe, transform flag at byte 11
          if (L >= 14 && std::memcmp(d + pos, "Adobe", 5) == 0) adobe = d[pos + 11];
          break;
        default:
          break;  // APPn / COM / others: skip payload
      }
      if (rc) return rc;
      pos = seg_end;
    }
  }

  // Resume the marker walk at input position `from` (just after a scan's
  // entropy data): handles DHT/DQT/DRI between scans, stops at the next
  // SOS (returns 0, scan_start set) or EOI (returns 0, saw_eoi). A stream
  // that ends before the next marker, or inside an APPn/COM segment, returns
  // -2: libjpeg's inserted EOI ends it cleanly. A bad table segment returns
  // -1 (libjpeg fails); one the data ends inside is read as libjpeg reads it
  // (cut_segment).
  int parse_next_scan(const uint8_t* from) {
    pos = (size_t)(from - d);
    for (;;) {
      int b;
      if (!u8(&b)) return -2;
      if (b != 0xFF) continue;
      int m;
      do {
        if (!u8(&m)) return -2;
      } while (m == 0xFF);
      if (m == 0x00 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      if (m == 0xD9) {
        saw_eoi = true;
        return 0;
      }
      const bool table = m == 0xC4 || m == 0xDB || m == 0xDD || m == 0xDA;
      if (pos + 2 > n || pos + ((d[pos] << 8) | d[pos + 1]) > n) return table ? cut_segment() : -2;
      int rc = segment(m);
      if (rc != 1) return rc;
    }
  }

  // One segment between scans at pos (its length field): 0 an SOS (scan_start
  // set), -1 bad, 1 another segment read (pos past it).
  int segment(int m) {
    int L;
    if (!u16(&L) || L < 2) return -1;
    size_t seg_end = pos + (size_t)L - 2;
    if (seg_end > n) return -1;
    int rc = 0;
    switch (m) {
      case 0xC4:
        rc = parse_dht(seg_end);
        break;
      case 0xDB:
        rc = parse_dqt(seg_end);
        break;
      case 0xDD: {
        int v;
        if (L != 4 || !u16(&v)) return -1;
        ri = v;
        break;
      }
      case 0xDA:
        rc = parse_sos(seg_end);
        if (rc) return -1;
        scan_start = d + pos;
        return 0;
      default:
        break;  // APPn/COM: skip
    }
    if (rc) return -1;
    pos = seg_end;
    return 1;
  }

  // A DHT, DQT, DRI or SOS segment the data ends inside, read as libjpeg
  // reads it: its memory source supplies an EOI marker (FF D9, again and
  // again) for the missing bytes. A bad segment fails (-1); a good DHT, DQT
  // or DRI is followed by that EOI (-2); a good SOS starts a scan with no
  // data (0), whose first MCU libjpeg decodes from zero bits.
  int cut_segment() {
    std::vector<uint8_t> pad(d, d + n);
    pad.resize(n + 65540);
    for (size_t i = n; i < pad.size(); i++) pad[i] = (i - n) % 2 ? 0xD9 : 0xFF;
    const uint8_t* d0 = d;
    const size_t n0 = n;
    const int m = d[pos - 1];
    d = pad.data();
    n = pad.size();
    const int rc = segment(m);
    d = d0;
    n = n0;
    if (rc < 0) return -1;
    if (rc == 1) return -2;
    scan_start = d0 + n0;
    return 0;
  }

  int parse_sof(size_t seg_end) {
    if (sof_seen) return 1;
    int y, x, nf;
    if (!u8(&prec) || !u16(&y) || !u16(&x) || !u8(&nf)) return -1;
    H = y;
    W = x;
    ncomp = nf;
    if (nf < 1 || nf > 4) return -1;
    for (int i = 0; i < nf; i++) {
      int id, hv, tq;
      if (!u8(&id) || !u8(&hv) || !u8(&tq)) return -1;
      comp[i] = {id, hv >> 4, hv & 15, tq};
      if (comp[i].h < 1 || comp[i].h > 4 || comp[i].v < 1 || comp[i].v > 4 ||
          tq > 3)
        return -1;
    }
    if (pos > seg_end) return -1;
    sof_seen = true;
    return 0;
  }

  int parse_dht(size_t seg_end) {
    while (pos < seg_end) {
      int tcth;
      if (!u8(&tcth)) return -1;
      int tc = tcth >> 4, th = tcth & 15;
      if (tc > 1 || th > 3) return -1;
      if (pos + 16 > seg_end) return -1;
      uint8_t counts[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; l++) {
        counts[l] = d[pos++];
        total += counts[l];
      }
      if (total > 256 || pos + (size_t)total > seg_end) return -1;
      HuffTbl* t = tc ? &htac[th] : &htdc[th];
      if (!build_huff(counts, d + pos, total, t)) return -1;
      if (tc) {
        fac[th] = g_fac_cache.get(counts, d + pos, total);
        fsk[th] = g_fsk_cache.get(counts, d + pos, total);
      } else {
        fdc[th] = g_fdc_cache.get(counts, d + pos, total);
      }
      pos += total;
    }
    return 0;
  }

  int parse_dqt(size_t seg_end) {
    while (pos < seg_end) {
      int pqtq;
      if (!u8(&pqtq)) return -1;
      int pq = pqtq >> 4, tq = pqtq & 15;
      if (pq > 1 || tq > 3) return -1;
      size_t need = pq ? 128 : 64;
      if (pos + need > seg_end) return -1;
      for (int i = 0; i < 64; i++) {
        int v = pq ? ((d[pos] << 8) | d[pos + 1]) : d[pos];
        pos += pq ? 2 : 1;
        qt[tq][kZZ.nat[i]] = (uint16_t)v;
      }
      qok[tq] = true;
    }
    return 0;
  }

  int parse_sos(size_t seg_end) {
    if (!sof_seen) return -1;
    const size_t seg_start = pos;
    if (!u8(&ns) || ns < 1 || ns > 4 || seg_end - seg_start != (size_t)(2 * ns + 4)) return -1;
    for (int i = 0; i < ns; i++) {
      int cs, tdta;
      if (!u8(&cs) || !u8(&tdta)) return -1;
      int idx = -1;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == cs) idx = j;
      if (idx < 0) return -1;
      scan_comp[i] = idx;
      scan_td[i] = tdta >> 4;
      scan_ta[i] = tdta & 15;
      if (scan_td[i] > 3 || scan_ta[i] > 3) return -1;
    }
    int ahal;
    if (!u8(&ss) || !u8(&se) || !u8(&ahal)) return -1;
    ah = ahal >> 4;
    al = ahal & 15;
    if (pos > seg_end) return -1;
    pos = seg_end;
    return 0;
  }

  int check_fast() const {
    if (prec != 8) return 1;
    if (H <= 0 || W <= 0) return 1;  // DNL-deferred height etc.
    if (ncomp == 1) {  // grayscale: single-component scan, 8x8 MCUs
      if (ns != 1 || comp[0].h != 1 || comp[0].v != 1) return 1;
      if (!htdc[scan_td[0]].valid || !htac[scan_ta[0]].valid) return 1;
      if (!fdc[scan_td[0]] || !fac[scan_ta[0]]) return 1;
      if (!qok[comp[0].tq]) return 1;
      return 0;
    }
    if (ncomp != 3 || ns != 3) return 1;
    if (ss != 0 || se != 63 || ah != 0 || al != 0) return 1;
    bool c420 = comp[0].h == 2 && comp[0].v == 2 && comp[1].h == 1 &&
                comp[1].v == 1 && comp[2].h == 1 && comp[2].v == 1;
    bool c444 = comp[0].h == 1 && comp[0].v == 1 && comp[1].h == 1 &&
                comp[1].v == 1 && comp[2].h == 1 && comp[2].v == 1;
    bool c422 = comp[0].h == 2 && comp[0].v == 1 && comp[1].h == 1 &&
                comp[1].v == 1 && comp[2].h == 1 && comp[2].v == 1;
    if (!c420 && !c444 && !c422) return 1;
    if (comp[1].tq != comp[2].tq) return 1;  // wire has one shared chroma qtable
    for (int i = 0; i < 3; i++) {
      int slot = -1;
      for (int s = 0; s < ns; s++)
        if (scan_comp[s] == i) slot = s;
      if (slot < 0) return 1;
      if (!htdc[scan_td[slot]].valid || !htac[scan_ta[slot]].valid) return 1;
      if (!fdc[scan_td[slot]] || !fac[scan_ta[slot]]) return 1;
      if (!qok[comp[i].tq]) return 1;
    }
    return 0;
  }
};

template <typename AC>
struct CompStateT {
  short* dc;
  AC* ac;
  const signed char* zmap;
  const HuffTbl* dct;
  const HuffTbl* act;
  const FastAc* fac;
  const FastDc* fdc;
  int h, v, bh, bw, br0, bc0, nac, real_bh, real_bw;
  const FastSkip* fsk = nullptr;  // skip-mode pair table (set by the entries)
  int dcs = 1;  // element stride of the DC plane (64: DC inside whole blocks)
};
using CompState = CompStateT<signed char>;

// Decode the (single, interleaved) scan into the component windows.
// Returns 0; corrupt tails stop early, leaving pre-zeroed cells (the same
// warn-and-zero-fill contract libjpeg applies to broken streams).
//
// Bit reader: register accumulator `acc` (left-aligned, top `cnt` bits
// valid) refilled BRANCHLESSLY from the unstuffed buffer — one unaligned
// load + bswap + shift per refill, no stuffing/marker checks in the loop
// (the unstuff pass removed them; see the structure note at the top).
// The largest per-step consumption is code(16) + magnitude(11) = 27 bits,
// so one refill (>= 56 bits) covers symbol + value. The byte cursor is
// validated once per block; the buffer's kTailBytes zero tail (the single
// padding constant lives in unstuff_scan — see the worst-case derivation
// at the Unstuffed struct, ~249 bytes/block) covers a block's worst-case
// consumption plus refill slack between checks, so reads stay in bounds
// and truncated streams terminate.
#define REFILL()                         \
  {                                      \
    uint64_t x_;                         \
    std::memcpy(&x_, p, 8);              \
    acc |= __builtin_bswap64(x_) >> cnt; \
    p += (63 - cnt) >> 3;                \
    cnt |= 56;                           \
  }

// Pack-emit state (PACK=true instantiation): the decoder emits the sparse
// wire DIRECTLY — per-block uint16 masks in ZIGZAG-bit convention (bit b =
// b-th selected coefficient in zigzag order; the device applies a constant
// nac-permutation, executor._unsparse_boundary) and the nonzero values
// appended to per-plane-row cursors in a slack-strided thread-local arena.
// This deletes the dense AC planes entirely: no zero-fill memset, no dense
// stores, no separate compaction pass over 13 MB/batch (the sparse pack is
// folded into the decode fan-out).
struct PackComp {
  unsigned short* mask;   // planar window mask plane (bh*bw entries)
  const uint16_t* zbit;   // zigzag index -> mask bit (0 = unselected)
  signed char* arena;     // per-row value arena (bh rows of `stride`)
  long stride;            // bw*nac + slack
  int* row_len;           // per window-row value counts (size bh)
};

// --- ROI decode index ---------------------------------------------------------
// JPEG entropy coding is serial: a crop-bounded decode still has to Huffman-
// decode every MCU from the stream start to the window (skip mode) and every
// column of each window row. The decode index is a per-FILE side blob that
// records the bit-reader state (consumed bit position, DC predictors,
// restart bookkeeping) before each MCU on the first decode of a file; later
// decodes of the same file (epoch 2+ of training — RRC windows move, bytes
// don't) SEEK straight to the window: rows above it cost nothing and fully
// indexed rows decode only the window's MCU columns. Multi-epoch training
// amortizes ~24 B/MCU (~30 KB per ImageNet-sized file) the same way video
// readers amortize a keyframe index. Out-of-window blocks never store
// anything (mask bits are 0, DC goes to a sink — see RowState), so a
// column-restricted decode is output-identical by construction; only the
// Huffman state at the seek target must match, which the entry guarantees.
// The reference ships the same idea as decoder caches keyed by source info
// (dali/operators/decoder/cache/, image_decoder.h cache_* args) — this
// variant caches positions instead of pixels, so it stays small and exact.
constexpr uint32_t kIdxMagic = 0x58494431u;  // "1DIX"
struct IdxHeader {
  uint32_t magic;
  uint16_t mcus_x, mcus_y;
  uint32_t us_len;    // unstuffed scan length: revalidates blob<->content
  uint32_t n_valid;   // entries [0, n_valid) are valid
};
struct IdxEntry {
  uint32_t bitpos;    // consumed bits into the unstuffed stream
  int32_t pred[3];    // DC predictors per component
  uint16_t next_rst;  // next restart-marker slot
  uint16_t togo;      // MCUs until the next restart (0 when ri == 0)
  uint32_t pad_;
};
static_assert(sizeof(IdxHeader) == 16 && sizeof(IdxEntry) == 24, "abi");
struct IdxState {
  IdxEntry* e = nullptr;
  IdxHeader* hdr = nullptr;
  bool on = false;
};

// Validate-or-initialize an index blob for this (file, geometry). A blob
// whose header doesn't match (fresh zeros, or the keyed file changed on
// disk) is re-initialized empty; a too-small capacity disables indexing.
inline void idx_init(unsigned char* buf, long long cap, int mcus_x,
                     int mcus_y, size_t us_len, IdxState* ix) {
  const long long need =
      (long long)sizeof(IdxHeader) +
      ((long long)mcus_x * mcus_y + 1) * (long long)sizeof(IdxEntry);
  if (!buf || cap < need) return;
  IdxHeader* h = reinterpret_cast<IdxHeader*>(buf);
  if (h->magic != kIdxMagic || h->mcus_x != mcus_x || h->mcus_y != mcus_y ||
      h->us_len != (uint32_t)us_len ||
      h->n_valid > (uint32_t)((long long)mcus_x * mcus_y + 1)) {
    h->magic = kIdxMagic;
    h->mcus_x = (uint16_t)mcus_x;
    h->mcus_y = (uint16_t)mcus_y;
    h->us_len = (uint32_t)us_len;
    h->n_valid = 0;
  }
  ix->hdr = h;
  ix->e = reinterpret_cast<IdxEntry*>(buf + sizeof(IdxHeader));
  ix->on = true;
}

// AC = short is the full-precision read, which also keeps libjpeg's handling
// of a stream that ends early (EXACT below): the MCU in which a decode first
// needs bits past the end finishes on zero bits (libjpeg's zero-filled bit
// buffer), and every MCU after it stays zero, across restart markers too
// (libjpeg keeps its out-of-data flag when the next marker is the end). The
// int8 read stops at the first block past the end, as the JAX package's
// decoder does.
template <bool PACK, typename AC = signed char>
int decode_scan(const Parser& ps, const CompStateT<AC>* cs, const uint8_t* pend,
                int mcus_x, int stop_my, PackComp* pk, int nc = 3,
                unsigned char* idx_buf = nullptr, long long idx_cap = 0,
                int mcus_y = 0, const uint8_t** in_end_out = nullptr) {
  constexpr bool EXACT = sizeof(AC) == 2;
  thread_local Unstuffed tl_us;
  Unstuffed& us = tl_us;
  long long t_us0 = now_ns();
  unstuff_scan(ps.scan_start, pend, &us);
  if (in_end_out) *in_end_out = us.in_end;
  g_hstats.ns_unstuff.fetch_add(now_ns() - t_us0, std::memory_order_relaxed);
  const uint8_t* buf0 = us.buf.data();
  const uint8_t* p = buf0;
  const long bits_len = (long)us.len << 3;  // padding lies beyond
  uint64_t acc = 0;
  int cnt = 0;
  size_t next_rst = 0;
  int pred0 = 0, pred1 = 0, pred2 = 0, pred3 = 0;
  const int ri = ps.ri;
  int togo = ri;
  IdxState ix;
  idx_init(idx_buf, idx_cap, mcus_x, mcus_y, us.len, &ix);
  const size_t n_rst_total = us.rst_off.size();
  // Record the state BEFORE MCU m (loop top, before the restart check —
  // seek + replay runs the same check, so the convention is consistent).
  // Only extends contiguously: entry m is written when m == n_valid.
  auto idx_record = [&](long long m) {
    if (!ix.on || m != (long long)ix.hdr->n_valid) return;
    const long long bp = ((p - buf0) << 3) - cnt;
    if (bp < 0 || bp > (long long)UINT32_MAX) return;
    // next_rst is stored 16-bit; a file with >65535 restart markers (huge
    // dims + tiny DRI) stops extending the index here rather than record a
    // wrapped slot that idx_seek would jump through (togo <= ri <= 65535
    // always fits: DRI is a 16-bit field)
    if (next_rst > (size_t)UINT16_MAX) return;
    IdxEntry& E = ix.e[m];
    E.bitpos = (uint32_t)bp;
    E.pred[0] = pred0;
    E.pred[1] = pred1;
    E.pred[2] = pred2;
    E.next_rst = (uint16_t)next_rst;
    E.togo = (uint16_t)togo;
    ix.hdr->n_valid = (uint32_t)(m + 1);
  };
  // Restore the reader to entry m's state. The REFILL invariant is
  // consumed = (p - buf0)*8 - cnt, so seeking to an arbitrary bit position
  // is exact: load at the byte, then shift off the sub-byte remainder.
  // Bounds checks are defense-in-depth only (the blob is self-written).
  auto idx_seek = [&](long long m) -> bool {
    const IdxEntry& E = ix.e[m];
    const long long bp = E.bitpos;
    if (bp > (long long)bits_len || (size_t)E.next_rst > n_rst_total)
      return false;
    p = buf0 + (bp >> 3);
    acc = 0;
    cnt = 0;
    uint64_t x_;
    std::memcpy(&x_, p, 8);
    acc = __builtin_bswap64(x_);
    p += 7;
    cnt = 56;
    const int r = (int)(bp & 7);
    acc <<= r;
    cnt -= r;
    pred0 = E.pred[0];
    pred1 = E.pred[1];
    pred2 = E.pred[2];
    next_rst = E.next_rst;
    togo = E.togo;
    return true;
  };
  // dummy sinks for out-of-window blocks: zmap of all -1 skips AC stores,
  // dc writes land in a scratch slot (branch-free vs a store/no-store split)
  signed char zmap_skip[64];
  std::memset(zmap_skip, -1, sizeof(zmap_skip));
  short dc_sink;
  AC ac_sink[4];  // branchless out-of-selection store target
  unsigned short mask_sink;
  signed char cur_sink[32];          // out-of-window rows: cursor parks here
  static const uint16_t zbit_zero[64] = {0};

  // MCU rows entirely above every component's window: decode in SKIP mode —
  // Huffman state and DC predictors advance, but no values are extended and
  // nothing is stored (rows below the window are never reached at all).
  // With a warm decode index this phase SEEKS to the farthest indexed MCU at
  // or before the first needed row and skip-decodes only the (usually empty)
  // remainder, recording new entries along the way.
  int skip_my = stop_my;
  for (int i = 0; i < nc; i++) {
    int s = cs[i].br0 > 0 ? cs[i].br0 / cs[i].v : 0;
    if (s < skip_my) skip_my = s;
  }
  long long pos = 0;  // linear index of the next MCU in stream order
  const long long target = (long long)skip_my * mcus_x;
  if (ix.on && ix.hdr->n_valid > 0) {
    const long long s =
        std::min<long long>(target, (long long)ix.hdr->n_valid - 1);
    if (idx_seek(s))
      pos = s;
    else
      ix.hdr->n_valid = 0;  // corrupt blob: rebuild from scratch
  }
  for (; pos < target; pos++) {
      idx_record(pos);
      if (ri && togo == 0) {
        if (next_rst >= us.rst_off.size()) return 0;  // corrupt: keep zeros
        p = us.buf.data() + us.rst_off[next_rst++];
        acc = 0;
        cnt = 0;
        pred0 = pred1 = pred2 = pred3 = 0;
        togo = ri;
      }
      for (int ci = 0; ci < nc; ci++) {
        const auto& C = cs[ci];
        int& pred = ci == 0 ? pred0 : ci == 1 ? pred1 : ci == 2 ? pred2 : pred3;
        for (int nb = C.v * C.h; nb > 0; nb--) {
          if (((p - buf0) << 3) - cnt > (long)bits_len) return 0;
          REFILL();
          int de = C.fdc->e[(unsigned)(acc >> (64 - kFastAc))];
          if (de) {
            pred = (int)((unsigned)pred + (unsigned)(int)(int16_t)(de >> 16));
            acc <<= (de & 63);
            cnt -= (de & 63);
          } else {
            int l = 0, s;
            int e = C.dct->lut[(unsigned)(acc >> (64 - kLookahead))];
            if (e >= 0) {
              l = e >> 8;
              s = e & 0xFF;
            } else {
              s = huff_decode_slow(acc, C.dct, &l);
            }
            if (s < 0 || s > 15) return 0;
            if (s) {
              int mv = (int)((acc << l) >> (64 - s));
              pred = (int)((unsigned)pred +
                           (unsigned)(mv < (1 << (s - 1)) ? mv - (1 << s) + 1 : mv));
            }
            acc <<= l + s;
            cnt -= l + s;
          }
          int k = 1;
          // Skip-mode AC loop over the FastSkip table (see build_fsk): one
          // lookup resolves the LENGTHS of one symbol (any magnitude size —
          // only the code must fit the window) or a fused PAIR of symbols,
          // then the second half of the entry applies branchlessly (zeros
          // for singles). Overrun semantics MATCH the store-mode loop so a
          // corrupt-but-decodable stream yields crop-position-independent
          // output: run+value past 63 aborts (k lands > 64), landing ON 64
          // exits the block, ZRL past 63 is tolerated. Bit budget: a step
          // consumes <= 27 (single, corrupt sz<=15) / <= 26 (pair), so two
          // steps fit one refill and the third needs cnt >= 31 > 27.
          while (k <= 63) {
            REFILL();
#define AC_SKIP_STEP(BLOCK_DONE)                                        \
            {                                                           \
              int fe = C.fsk->e[(unsigned)(acc >> (64 - kFastSkip))];     \
              if (fe) {                                                 \
                int n1 = fe & 31;                                       \
                acc <<= n1;                                             \
                cnt -= n1;                                              \
                k += (fe >> 5) & 63;                                    \
                if (fe < 0) goto BLOCK_DONE; /* EOB (sym1) */           \
                if (k > 63) {                                           \
                  if ((fe & (1 << 11)) && k > 64) return 0;             \
                  goto BLOCK_DONE; /* block exhausted / ZRL tail */     \
                }                                                       \
                int n2 = (fe >> 12) & 31; /* 0 for single entries */    \
                acc <<= n2;                                             \
                cnt -= n2;                                              \
                k += (fe >> 17) & 63;                                   \
                if (fe & (1 << 30)) goto BLOCK_DONE; /* EOB (sym2) */   \
                if (k > 63) {                                           \
                  if ((fe & (1 << 23)) && k > 64) return 0;             \
                  goto BLOCK_DONE;                                      \
                }                                                       \
              } else { /* code longer than kFastAc bits */              \
                int l = 0, rs;                                          \
                rs = huff_decode_slow(acc, C.act, &l);                  \
                if (rs < 0) return 0;                                   \
                int r = rs >> 4, sz = rs & 15;                          \
                acc <<= l + sz;                                         \
                cnt -= l + sz;                                          \
                if (cnt < 0) return 0; /* corrupt: sz>10 underflow */   \
                if (sz == 0) {                                          \
                  if (r != 15) goto BLOCK_DONE; /* EOB */               \
                  k += 16; /* ZRL */                                    \
                } else {                                                \
                  k += r;                                               \
                  if (k > 63) return 0;                                 \
                  k++;                                                  \
                }                                                       \
              }                                                         \
            }
            AC_SKIP_STEP(skip_blk_done);
            if (k > 63) break;
            AC_SKIP_STEP(skip_blk_done);
            // opportunistic third step (mirrors the store-mode loop)
            if (k > 63) break;
            if (cnt >= 31) AC_SKIP_STEP(skip_blk_done);
#undef AC_SKIP_STEP
          }
        skip_blk_done:;
        }
      }
      if (ri) togo--;
  }

  // Window MCU-column range: when a row is fully indexed, only these columns
  // are decoded (out-of-window blocks store nothing — see the sink routing in
  // RowState/AC_SYM — so the restriction is output-identical by construction)
  // and the next row is reached by seek instead of decoding the tail columns.
  int mcu_x0 = 0, mcu_x1 = mcus_x;
  if (ix.on) {
    int lo = mcus_x, hi = 0;
    for (int i = 0; i < nc; i++) {
      const int c0 = cs[i].bc0 / cs[i].h;
      const int c1 = (cs[i].bc0 + cs[i].bw + cs[i].h - 1) / cs[i].h;
      if (c0 < lo) lo = c0;
      if (c1 > hi) hi = c1;
    }
    mcu_x0 = lo < 0 ? 0 : (lo > mcus_x ? mcus_x : lo);
    mcu_x1 = hi < mcu_x0 ? mcu_x0 : (hi > mcus_x ? mcus_x : hi);
  }

  // Per-(component, sub-row) state that is constant across an MCU row —
  // hoists the row half of the window test and the row-base pointer math
  // out of the per-block path (the column half remains per block).
  struct RowState {
    short* dc_row;
    AC* ac_row;
    bool row_ok;
    // pack mode: value cursor + its row base + mask row + length slot
    signed char* cur;
    signed char* cur_base;
    unsigned short* mask_row;
    int* len_slot;
  } rows[4][4];

  int len_sink;
  for (int my = skip_my; my < stop_my; my++) {
    for (int ci = 0; ci < nc; ci++) {
      const auto& C = cs[ci];
      for (int v = 0; v < C.v; v++) {
        const int brow = my * C.v + v;
        const int wr = brow - C.br0;
        RowState& R = rows[ci][v];
        R.row_ok = (unsigned)wr < (unsigned)C.bh && brow < C.real_bh;
        if (R.row_ok) {
          R.dc_row = C.dc + (long)wr * C.bw * C.dcs;
          if (!PACK) R.ac_row = C.ac + (long)wr * C.bw * C.nac;
        }
        if (PACK) {
          const PackComp& P = pk[ci];
          if (R.row_ok) {
            R.cur = R.cur_base = P.arena + (long)wr * P.stride;
            R.mask_row = P.mask + (long)wr * C.bw;
            R.len_slot = &P.row_len[wr];
          } else {
            R.cur = R.cur_base = cur_sink;
            R.mask_row = nullptr;
            R.len_slot = &len_sink;
          }
        }
      }
    }
    // Fully indexed rows decode only the window's MCU columns and seek out;
    // rows past the indexed frontier decode full width (extending the index).
    const long long row_base = (long long)my * mcus_x;
    int mx_lo = 0, mx_hi = mcus_x;
    if (ix.on &&
        (long long)ix.hdr->n_valid >= row_base + mcus_x + 1) {
      mx_lo = mcu_x0;
      mx_hi = mcu_x1;
    }
    if (pos != row_base + mx_lo) {
      // only reachable with a warm index (a column-restricted or seeked
      // prior row); the target entry is guaranteed inside the valid prefix
      if (!ix.on || (long long)ix.hdr->n_valid <= row_base + mx_lo ||
          !idx_seek(row_base + mx_lo))
        return 0;  // corrupt blob: keep zeros (deterministic, bounded)
      pos = row_base + mx_lo;
    }
    for (int mx = mx_lo; mx < mx_hi; mx++, pos++) {
      idx_record(pos);
      if (ri && togo == 0) {
        if (next_rst < us.rst_off.size()) {
          p = us.buf.data() + us.rst_off[next_rst++];  // past pad bits + RSTn
        } else if (EXACT) {
          // no marker left: libjpeg decodes this MCU from zero bits unless
          // the data had already run out; either way the data is over
          const bool over = ((p - buf0) << 3) - cnt > (long)bits_len;
          p = buf0 + us.len + (over ? 1 : 0);
        } else {
          return 0;  // corrupt: keep zeros
        }
        acc = 0;
        cnt = 0;
        pred0 = pred1 = pred2 = pred3 = 0;
        togo = ri;
      }
      if (EXACT && ((p - buf0) << 3) - cnt > (long)bits_len) {
        if (ri) togo--;  // past the end: this MCU stays zero
        continue;
      }
      for (int ci = 0; ci < nc; ci++) {
        const auto& C = cs[ci];
        int& pred = ci == 0 ? pred0 : ci == 1 ? pred1 : ci == 2 ? pred2 : pred3;
        for (int v = 0; v < C.v; v++) {
          RowState& R = rows[ci][v];
          for (int h = 0; h < C.h; h++) {
            // Truncation check on the CONSUMED position (p runs up to 7
            // bytes ahead of it — refill lookahead): stop once decode has
            // actually eaten into the zero padding.
            if (((p - buf0) << 3) - cnt >
                (long)bits_len + (EXACT ? 8L * kTailBytes / 2 : 0L))
              return 0;
            const int bcol = mx * C.h + h;
            const int wc = bcol - C.bc0;
            short* dcp = &dc_sink;
            AC* acp = ac_sink;
            const signed char* zmap = zmap_skip;
            const uint16_t* zb = zbit_zero;
            unsigned short* mp = &mask_sink;
            signed char* cur = PACK ? R.cur : nullptr;
            unsigned mreg = 0;
            const bool in_win = R.row_ok && (unsigned)wc < (unsigned)C.bw &&
                                bcol < C.real_bw;
            if (in_win) {
              dcp = R.dc_row + (long)wc * C.dcs;
              if (!PACK) acp = R.ac_row + (long)wc * C.nac;
              zmap = C.zmap;
            }
            if (PACK && in_win) {
              zb = pk[ci].zbit;
              mp = R.mask_row + wc;
            }
            // --- one 8x8 block ---
            REFILL();
            int de = C.fdc->e[(unsigned)(acc >> (64 - kFastAc))];
            if (de) {  // size symbol + magnitude in one lookup
              pred = (int)((unsigned)pred + (unsigned)(int)(int16_t)(de >> 16));
              acc <<= (de & 63);
              cnt -= (de & 63);
            } else {
              int l = 0, s;
              int e = C.dct->lut[(unsigned)(acc >> (64 - kLookahead))];
              if (e >= 0) {
                l = e >> 8;
                s = e & 0xFF;
              } else {
                s = huff_decode_slow(acc, C.dct, &l);
              }
              if (s < 0 || s > 15) return 0;  // corrupt: stop, zeros remain
              if (s) {
                int mv = (int)((acc << l) >> (64 - s));
                pred = (int)((unsigned)pred +
                           (unsigned)(mv < (1 << (s - 1)) ? mv - (1 << s) + 1 : mv));
              }
              acc <<= l + s;
              cnt -= l + s;
            }
            *dcp = (short)pred;
            SYMC();
            BLKC();
            int k = 1;
            // AC loop, TWO symbols per refill: a refill leaves >= 56 valid
            // bits and one symbol consumes at most code(16) + magnitude(10)
            // = 26 bits, so two symbols (52) always fit — halves the
            // refill's load+bswap+or chain links per symbol. The FIRST AC
            // symbol rides the DC refill (DC <= 27 bits + AC <= 26 <= 56).
            // Measured faster; see dali_tpu's docs/performance.md.
#define AC_SYM(BLOCK_DONE)                                              \
              {                                                         \
                SYMC();                                                 \
                int fe = C.fac->e[(unsigned)(acc >> (64 - kFastAc))];   \
                if (fe) { /* symbol+magnitude in one lookup */          \
                  acc <<= (fe & 63);                                    \
                  cnt -= (fe & 63);                                     \
                  if (fe & (1 << 24)) { /* control symbol */            \
                    if ((fe & 0xF00) == 0) goto BLOCK_DONE; /* EOB */   \
                    k += 16; /* ZRL */                                  \
                  } else {                                              \
                    k += (fe >> 8) & 15;                                \
                    if (k > 63) return 0;                               \
                    if (PACK) {                                         \
                      unsigned mb = zb[k];                              \
                      mreg |= mb;                                       \
                      *cur = (signed char)(fe >> 16);                   \
                      cur += (mb != 0);                                 \
                    } else {                                            \
                      int slot = zmap[k];                               \
                      /* cmov to sink when out of selection */          \
                      AC* dst = slot >= 0 ? acp + slot : ac_sink;       \
                      *dst = (AC)(signed char)(fe >> 16);               \
                    }                                                   \
                    k++;                                                \
                  }                                                     \
                } else {                                                \
                  int l = 0, rs;                                        \
                  int e = C.act->lut[(unsigned)(acc >> (64 - kLookahead))]; \
                  if (e >= 0) {                                         \
                    l = e >> 8;                                         \
                    rs = e & 0xFF;                                      \
                  } else {                                              \
                    rs = huff_decode_slow(acc, C.act, &l);              \
                    if (rs < 0) return 0;                               \
                  }                                                     \
                  int r = rs >> 4, sz = rs & 15;                        \
                  if (sz == 0) {                                        \
                    acc <<= l;                                          \
                    cnt -= l;                                           \
                    if (r != 15) goto BLOCK_DONE; /* EOB */             \
                    k += 16; /* ZRL */                                  \
                  } else {                                              \
                    k += r;                                             \
                    if (k > 63) return 0;                               \
                    int mv = (int)((acc << l) >> (64 - sz));            \
                    acc <<= l + sz;                                     \
                    cnt -= l + sz;                                      \
                    if (cnt < 0) return 0; /* corrupt: sz>10 underflow */ \
                    int val = mv < (1 << (sz - 1)) ? mv - (1 << sz) + 1 : mv; \
                    if (PACK) {                                         \
                      unsigned mb = zb[k];                              \
                      mreg |= mb;                                       \
                      *cur = sat8(val);                                 \
                      cur += (mb != 0);                                 \
                    } else {                                            \
                      int slot = zmap[k];                               \
                      AC* dst = slot >= 0 ? acp + slot : ac_sink;       \
                      *dst = ac_cast<AC>(val);                          \
                    }                                                   \
                    k++;                                                \
                  }                                                     \
                }                                                       \
              }
            AC_SYM(blk_done);  // first symbol rides the DC refill
            while (k <= 63) {
              REFILL();
              AC_SYM(blk_done);
              if (k > 63) break;
              AC_SYM(blk_done);
              // opportunistic third symbol: when the first two took fast
              // paths the accumulator still holds >= 31 valid bits — enough
              // for any one symbol (code 16 + magnitude 15)
              if (k > 63) break;
              if (cnt >= 31) AC_SYM(blk_done);
            }
          blk_done:;
#undef AC_SYM
            if (PACK) {
              *mp = (unsigned short)mreg;
              R.cur = cur;
              *R.len_slot = (int)(cur - R.cur_base);
            }
          }
        }
      }
      if (ri) togo--;
    }
  }
  // One-past-the-end entry: lets a later, lower window seek to this decode's
  // frontier instead of restarting (no-op unless the frontier is contiguous).
  idx_record(pos);
  return 0;
}

#undef REFILL

// ----------------------------------------------------------------------------
// Interleaved pair decode (ILP): the sequential decoder is latency-bound on
// the refill→lookup→shift dependency chain (~18 cy/symbol measured). Two
// INDEPENDENT images' chains can overlap in the out-of-order window, so the
// pair loop below alternates block decodes between two cursors — each
// cursor is the decode_scan state machine flattened into a struct whose
// step() decodes one 8x8 block and advances the (my, mx, ci, bi) cursor.
// Output and overrun semantics are IDENTICAL to decode_scan (validated by
// checksum parity in dali_tpu's tools/bench_huff.cc and its hybrid golden
// tests).
struct ScanCursor {
  CompState cs[3];
  const uint8_t* buf0 = nullptr;
  const uint8_t* p = nullptr;
  uint64_t acc = 0;
  int cnt = 0;
  long bits_len = 0;
  size_t n_rst = 0;
  const size_t* rst_off = nullptr;
  const uint8_t* rst_base = nullptr;
  int ri = 0, togo = 0;
  size_t next_rst = 0;
  int pred0 = 0, pred1 = 0, pred2 = 0;
  int mcus_x = 0, stop_my = 0, skip_my = 0;
  int my = 0, mx = 0, ci = 0, bi = 0;  // bi < cs[ci].v * cs[ci].h
  bool done = false;
  // store-mode row state (recomputed when my advances)
  struct Row {
    short* dc_row;
    signed char* ac_row;
    bool row_ok;
  } rows[3][4];
  signed char zskip[64];
  short dc_sink;
  signed char ac_sink[4];

  void init(const Parser& ps, const CompState* cstates, Unstuffed* us,
            int mcusx, int stopmy) {
    for (int i = 0; i < 3; i++) cs[i] = cstates[i];
    buf0 = us->buf.data();
    p = buf0;
    bits_len = (long)us->len << 3;
    rst_off = us->rst_off.data();
    n_rst = us->rst_off.size();
    rst_base = us->buf.data();
    ri = ps.ri;
    togo = ri;
    mcus_x = mcusx;
    stop_my = stopmy;
    skip_my = stop_my;
    for (int i = 0; i < 3; i++) {
      int s = cs[i].br0 > 0 ? cs[i].br0 / cs[i].v : 0;
      if (s < skip_my) skip_my = s;
    }
    std::memset(zskip, -1, sizeof(zskip));
    if (stop_my <= 0) done = true;
    else refresh_rows();
  }

  void refresh_rows() {
    if (my < skip_my) return;  // skip mode doesn't use row state
    for (int c = 0; c < 3; c++) {
      const CompState& C = cs[c];
      for (int v = 0; v < C.v; v++) {
        const int brow = my * C.v + v;
        const int wr = brow - C.br0;
        Row& R = rows[c][v];
        R.row_ok = (unsigned)wr < (unsigned)C.bh && brow < C.real_bh;
        if (R.row_ok) {
          R.dc_row = C.dc + (long)wr * C.bw;
          R.ac_row = C.ac + (long)wr * C.bw * C.nac;
        }
      }
    }
  }

#define REFILL()                         \
  {                                      \
    uint64_t x_;                         \
    std::memcpy(&x_, p, 8);              \
    acc |= __builtin_bswap64(x_) >> cnt; \
    p += (63 - cnt) >> 3;                \
    cnt |= 56;                           \
  }

  // Per-block transient state for the split begin/ac_step/advance protocol
  // (symbol-level interleave needs the AC loop broken out so two cursors'
  // loops can be fused in decode_pair).
  int k = 1;
  signed char* acp_cur = nullptr;
  const signed char* zmap_cur = nullptr;
  const FastAc* fac_cur = nullptr;
  const HuffTbl* act_cur = nullptr;

  // Restart check + window pointers + DC decode for the block at the
  // cursor. Returns true if the block's AC loop should run; false when the
  // cursor is done/corrupt (sets done).
  inline bool begin_block() {
    if (done) return false;
    if (ci == 0 && bi == 0 && ri && togo == 0) {
      if (next_rst >= n_rst) { done = true; return false; }
      p = rst_base + rst_off[next_rst++];
      acc = 0;
      cnt = 0;
      pred0 = pred1 = pred2 = 0;
      togo = ri;
    }
    const CompState& C = cs[ci];
    int& pred = ci == 0 ? pred0 : ci == 1 ? pred1 : pred2;
    if (((p - buf0) << 3) - cnt > bits_len) { done = true; return false; }
    short* dcp = &dc_sink;
    acp_cur = ac_sink;
    zmap_cur = zskip;
    if (my >= skip_my) {
      const int v = bi / C.h, h = bi % C.h;
      const Row& R = rows[ci][v];
      const int bcol = mx * C.h + h;
      const int wc = bcol - C.bc0;
      if (R.row_ok && (unsigned)wc < (unsigned)C.bw && bcol < C.real_bw) {
        dcp = R.dc_row + wc;
        acp_cur = R.ac_row + (long)wc * C.nac;
        zmap_cur = C.zmap;
      }
    }
    fac_cur = C.fac;
    act_cur = C.act;
    REFILL();
    int de = C.fdc->e[(unsigned)(acc >> (64 - kFastAc))];
    if (de) {
      pred = (int)((unsigned)pred + (unsigned)(int)(int16_t)(de >> 16));
      acc <<= (de & 63);
      cnt -= (de & 63);
    } else {
      int l = 0, s;
      int e = C.dct->lut[(unsigned)(acc >> (64 - kLookahead))];
      if (e >= 0) {
        l = e >> 8;
        s = e & 0xFF;
      } else {
        s = huff_decode_slow(acc, C.dct, &l);
      }
      if (s < 0 || s > 15) { done = true; return false; }
      if (s) {
        int mv = (int)((acc << l) >> (64 - s));
        pred = (int)((unsigned)pred +
                           (unsigned)(mv < (1 << (s - 1)) ? mv - (1 << s) + 1 : mv));
      }
      acc <<= l + s;
      cnt -= l + s;
    }
    *dcp = (short)pred;
    k = 1;
    return true;
  }

  // One AC symbol. Returns true while the block has more symbols; false at
  // EOB / block end (caller must then advance()) or corrupt (done set).
  inline bool ac_step() {
    if (k > 63) return false;
    REFILL();
    int fe = fac_cur->e[(unsigned)(acc >> (64 - kFastAc))];
    if (fe) {
      acc <<= (fe & 63);
      cnt -= (fe & 63);
      if (fe & (1 << 24)) {
        if ((fe & 0xF00) == 0) return false;  // EOB
        k += 16;                              // ZRL
        return k <= 63;
      }
      k += (fe >> 8) & 15;
      if (k > 63) { done = true; return false; }
      int slot = zmap_cur[k];
      signed char* dst = slot >= 0 ? acp_cur + slot : ac_sink;
      *dst = (signed char)(fe >> 16);
      k++;
      return k <= 63;
    }
    int l = 0, rs;
    int e = act_cur->lut[(unsigned)(acc >> (64 - kLookahead))];
    if (e >= 0) {
      l = e >> 8;
      rs = e & 0xFF;
    } else {
      rs = huff_decode_slow(acc, act_cur, &l);
      if (rs < 0) { done = true; return false; }
    }
    int r = rs >> 4, sz = rs & 15;
    if (sz == 0) {
      acc <<= l;
      cnt -= l;
      if (r != 15) return false;  // EOB
      k += 16;                    // ZRL
      return k <= 63;
    }
    k += r;
    if (k > 63) { done = true; return false; }
    int mv = (int)((acc << l) >> (64 - sz));
    acc <<= l + sz;
    cnt -= l + sz;
    int val = mv < (1 << (sz - 1)) ? mv - (1 << sz) + 1 : mv;
    int slot = zmap_cur[k];
    signed char* dst = slot >= 0 ? acp_cur + slot : ac_sink;
    *dst = sat8(val);
    k++;
    return k <= 63;
  }

  // Decode ONE block at the cursor, then advance (solo-tail path).
  inline void step() {
    if (!begin_block()) return;
    while (ac_step()) {
    }
    if (!done) advance();
  }

  inline void advance() {
    if (++bi >= cs[ci].v * cs[ci].h) {
      bi = 0;
      if (++ci >= 3) {
        ci = 0;
        if (ri) togo--;
        if (++mx >= mcus_x) {
          mx = 0;
          if (++my >= stop_my) { done = true; return; }
          refresh_rows();
        }
      }
    }
  }
#undef REFILL
};

// Drive two cursors in lockstep at SYMBOL granularity: both blocks' DC
// decodes run back to back, then the two AC loops are fused so every
// iteration advances one symbol of each stream — the two refill→lookup→
// shift dependency chains are independent and overlap in the out-of-order
// window. Tail (one stream finished) runs solo via step().
void decode_pair(ScanCursor& a, ScanCursor& b) {
  while (!a.done && !b.done) {
    bool la = a.begin_block();
    bool lb = b.begin_block();
    while (la | lb) {
      if (la) la = a.ac_step();
      if (lb) lb = b.ac_step();
    }
    if (!a.done) a.advance();
    if (!b.done) b.advance();
  }
  while (!a.done) a.step();
  while (!b.done) b.step();
}

// Single-image setup shared by the pair entry: parse, windows, memset,
// returns 0 and fills the cursor (us must outlive the decode).
int setup_cursor(const uint8_t* data, size_t len, int ky, int kc, short* y_dc,
                 signed char* y_ac, short* cb_dc, signed char* cb_ac,
                 short* cr_dc, signed char* cr_ac, unsigned short* q_out,
                 int y_bh, int y_bw, int c_bh, int c_bw, int y_br0, int y_bc0,
                 int c_br0, int c_bc0, Parser* ps_out, ScanCursor* cur,
                 Unstuffed* us, signed char* zmap_y, signed char* zmap_c) {
  Parser& ps = *ps_out;
  int rc = ps.parse();
  if (rc != 0) return rc;
  if (ps.ncomp != 3) return 1;  // pair cursors assume 3 components
  if (ky < 1 || ky > 8 || kc < 1 || kc > 8) return 1;
  for (int z = 1; z < 64; z++) {
    int r = kZZ.nat[z] >> 3, c = kZZ.nat[z] & 7;
    zmap_y[z] = (r < ky && c < ky) ? (signed char)(r * ky + c - 1) : -1;
    zmap_c[z] = (r < kc && c < kc) ? (signed char)(r * kc + c - 1) : -1;
  }
  zmap_y[0] = zmap_c[0] = -1;
  for (int comp = 0; comp < 2; comp++) {
    int k = comp == 0 ? ky : kc;
    const uint16_t* src = ps.qt[ps.comp[comp].tq];
    unsigned short* qdst = comp == 0 ? q_out : q_out + ky * ky;
    for (int r = 0; r < k; r++)
      for (int c = 0; c < k; c++) qdst[r * k + c] = src[r * 8 + c];
  }
  const int hmax = ps.comp[0].h, vmax = ps.comp[0].v;
  const int mcus_x = (ps.W + 8 * hmax - 1) / (8 * hmax);
  const int mcus_y = (ps.H + 8 * vmax - 1) / (8 * vmax);
  CompState cs[3];
  short* dcs[3] = {y_dc, cb_dc, cr_dc};
  signed char* acs[3] = {y_ac, cb_ac, cr_ac};
  for (int i = 0; i < 3; i++) {
    int slot = 0;
    for (int s = 0; s < ps.ns; s++)
      if (ps.scan_comp[s] == i) slot = s;
    const int k = i == 0 ? ky : kc;
    cs[i] = {dcs[i],
             acs[i],
             i == 0 ? zmap_y : zmap_c,
             &ps.htdc[ps.scan_td[slot]],
             &ps.htac[ps.scan_ta[slot]],
             ps.fac[ps.scan_ta[slot]],
             ps.fdc[ps.scan_td[slot]],
             ps.comp[i].h,
             ps.comp[i].v,
             i == 0 ? y_bh : c_bh,
             i == 0 ? y_bw : c_bw,
             i == 0 ? y_br0 : c_br0,
             i == 0 ? y_bc0 : c_bc0,
             k * k - 1,
             (ps.H * ps.comp[i].v + 8 * vmax - 1) / (8 * vmax),
             (ps.W * ps.comp[i].h + 8 * hmax - 1) / (8 * hmax)};
    cs[i].fsk = ps.fsk[ps.scan_ta[slot]];
    std::memset(cs[i].dc, 0, sizeof(short) * (size_t)cs[i].bh * cs[i].bw);
    std::memset(cs[i].ac, 0, (size_t)cs[i].bh * cs[i].bw * cs[i].nac);
  }
  int stop_my = 0;
  for (int i = 0; i < 3; i++) {
    int need = (cs[i].br0 + cs[i].bh + cs[i].v - 1) / cs[i].v;
    if (need > stop_my) stop_my = need;
  }
  if (stop_my > mcus_y) stop_my = mcus_y;
  unstuff_scan(ps.scan_start, data + len, us);
  cur->init(ps, cs, us, mcus_x, stop_my);
  return 0;
}


// ============================================================================
// Progressive JPEG (SOF2) decode — ITU T.81 Annex G.2. Scans accumulate
// coefficients via spectral selection (ss..se bands) and successive
// approximation (ah/al bit planes). Each scan's entropy segment is
// independently decodable, which gives the hybrid path a structural bonus:
// scans whose band lies entirely ABOVE the k*k low-frequency selection are
// skipped without decoding, and every scan stops after the crop window's
// last block row. Output contract matches the baseline crop entry
// (libjpeg-parity tested bit-exactly in tests/test_jpeg_huff.py).

struct BitRd {
  const uint8_t* buf0;
  const uint8_t* p;
  uint64_t acc = 0;
  int cnt = 0;
  long bits_len = 0;

  void init(const Unstuffed& us, size_t off) {
    buf0 = us.buf.data();
    p = us.buf.data() + off;
    acc = 0;
    cnt = 0;
    bits_len = (long)us.len << 3;
  }
  inline void refill() {
    uint64_t x_;
    std::memcpy(&x_, p, 8);
    acc |= __builtin_bswap64(x_) >> cnt;
    p += (63 - cnt) >> 3;
    cnt |= 56;
  }
  inline bool exhausted() const {
    return ((p - buf0) << 3) - cnt > bits_len;
  }
  // n <= 16
  inline int bits(int n) {
    if (n == 0) return 0;
    refill();
    int v = (int)(acc >> (64 - n));
    acc <<= n;
    cnt -= n;
    return v;
  }
  inline int bit() { return bits(1); }
  // returns symbol or -1
  inline int huff(const HuffTbl* t) {
    refill();
    int e = t->lut[(unsigned)(acc >> (64 - kLookahead))];
    int l, s;
    if (e >= 0) {
      l = e >> 8;
      s = e & 0xFF;
    } else {
      s = huff_decode_slow(acc, t, &l);
      if (s < 0) return -1;
    }
    acc <<= l;
    cnt -= l;
    return s;
  }
};

// A restart boundary of a progressive scan: the reader moves past the next
// RSTn. With no marker left (a stream cut short), libjpeg decodes the next
// MCU from zero bits unless the data had already run out (false: stop).
inline bool restart(BitRd& br, const Unstuffed& us, size_t* next_rst) {
  if (*next_rst < us.rst_off.size()) {
    br.init(us, us.rst_off[(*next_rst)++]);
    return true;
  }
  if (br.exhausted()) return false;
  br.init(us, us.len);
  return true;
}

inline int extend_recv(BitRd& br, int s) {
  if (s == 0) return 0;
  int v = br.bits(s);
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct ProgComp {
  std::vector<short>* coef;  // [rows_alloc * full_bw * 64], natural... zigzag order
  int full_bw;               // MCU-padded block width (interleaved DC scans)
  int real_bw, real_bh;      // component's true block dims (AC scans)
  int rows_dec;              // rows [0, rows_dec) are decoded/stored
  int h, v;                  // sampling factors
  int last_dc;               // DC predictor (reset per scan / restart)
};

// DC first/refine scan (interleaved over the scan's components, or single).
// Returns 0 ok, -1 corrupt. *good gets the iMCU row of the last MCU begun
// before the data ran out (libjpeg's last_good_iMCU_row).
int prog_dc_scan(const Parser& ps, ProgComp* pc, const int* scan_idx, int nsc,
                 const Unstuffed& us, int mcus_x, int stop_my, int* good) {
  BitRd br;
  br.init(us, 0);
  size_t next_rst = 0;
  int ri = ps.ri, togo = ri;
  const int ah = ps.ah, al = ps.al;
  for (int i = 0; i < nsc; i++)
    if (ah == 0 && !ps.htdc[ps.scan_td[i]].valid) return -1;  // no such table
  for (int i = 0; i < nsc; i++) pc[scan_idx[i]].last_dc = 0;
  const bool single = nsc == 1;
  // rows bound: MCU rows when interleaved, component block rows when single
  const int nx = single ? pc[scan_idx[0]].real_bw : mcus_x;
  for (int my = 0; my < stop_my; my++) {
    for (int mx = 0; mx < nx; mx++) {
      if (!br.exhausted()) *good = single ? my / pc[scan_idx[0]].v : my;
      if (ri && togo == 0) {
        if (!restart(br, us, &next_rst)) return -1;
        for (int i = 0; i < nsc; i++) pc[scan_idx[i]].last_dc = 0;
        togo = ri;
      }
      if (br.exhausted()) return -1;
      for (int i = 0; i < nsc; i++) {
        ProgComp& C = pc[scan_idx[i]];
        const HuffTbl* dct = &ps.htdc[ps.scan_td[i]];
        const int bh_span = single ? 1 : C.v;
        const int bw_span = single ? 1 : C.h;
        for (int by = 0; by < bh_span; by++) {
          for (int bx = 0; bx < bw_span; bx++) {
            const int brow = single ? my : my * C.v + by;
            const int bcol = single ? mx : mx * C.h + bx;
            short dummy[64];
            short* blk = dummy;
            if (brow < C.rows_dec && bcol < C.full_bw)
              blk = C.coef->data() + ((size_t)brow * C.full_bw + bcol) * 64;
            if (ah == 0) {  // first scan: diff-coded DC, scaled by 2^al
              int s = br.huff(dct);
              if (s < 0 || s > 15) return -1;
              C.last_dc = (int)((unsigned)C.last_dc + (unsigned)extend_recv(br, s));
              blk[0] = (short)(C.last_dc * (1 << al));  // mul: dc may be negative
            } else {  // refinement: one correction bit
              if (br.bit()) blk[0] |= (short)(1 << al);
            }
          }
        }
      }
      if (ri) togo--;
    }
  }
  return 0;
}

// AC first scan (ah == 0), single component, band [ss, se].
int prog_ac_first(const Parser& ps, ProgComp& C, int scan_slot,
                  const Unstuffed& us, int row_end, int* good) {
  BitRd br;
  br.init(us, 0);
  size_t next_rst = 0;
  int ri = ps.ri, togo = ri;
  const HuffTbl* act = &ps.htac[ps.scan_ta[scan_slot]];
  if (!act->valid) return -1;  // no such table
  const int ss = ps.ss, se = ps.se, al = ps.al;
  long eobrun = 0;
  for (int brow = 0; brow < row_end; brow++) {
    for (int bcol = 0; bcol < C.real_bw; bcol++) {
      if (!br.exhausted()) *good = brow / C.v;
      if (ri && togo == 0) {
        if (!restart(br, us, &next_rst)) return -1;
        eobrun = 0;
        togo = ri;
      }
      short* blk = C.coef->data() + ((size_t)brow * C.full_bw + bcol) * 64;
      if (eobrun > 0) {
        eobrun--;
      } else {
        if (br.exhausted()) return -1;
        int k = ss;
        while (k <= se) {
          int rs = br.huff(act);
          if (rs < 0) return -1;
          int r = rs >> 4, s = rs & 15;
          if (s == 0) {
            if (r != 15) {  // EOBn
              eobrun = (1L << r);
              if (r) eobrun += br.bits(r);
              eobrun--;
              break;
            }
            k += 16;  // ZRL
            continue;
          }
          k += r;
          if (k > se) return -1;
          blk[k] = (short)(extend_recv(br, s) * (1 << al));
          k++;
        }
      }
      if (ri) togo--;
    }
  }
  return 0;
}

// AC refinement scan (ah > 0), single component, band [ss, se].
// Mirrors T.81 G.2 / the classic decode_mcu_AC_refine control flow.
int prog_ac_refine(const Parser& ps, ProgComp& C, int scan_slot,
                   const Unstuffed& us, int row_end, int* good) {
  BitRd br;
  br.init(us, 0);
  size_t next_rst = 0;
  int ri = ps.ri, togo = ri;
  const HuffTbl* act = &ps.htac[ps.scan_ta[scan_slot]];
  if (!act->valid) return -1;  // no such table
  const int ss = ps.ss, se = ps.se, al = ps.al;
  const short p1 = (short)(1 << al), m1 = (short)(-(1 << al));
  long eobrun = 0;
  for (int brow = 0; brow < row_end; brow++) {
    for (int bcol = 0; bcol < C.real_bw; bcol++) {
      if (!br.exhausted()) *good = brow / C.v;
      if (ri && togo == 0) {
        if (!restart(br, us, &next_rst)) return -1;
        eobrun = 0;
        togo = ri;
      }
      short* blk = C.coef->data() + ((size_t)brow * C.full_bw + bcol) * 64;
      int k = ss;
      if (eobrun == 0) {
        if (br.exhausted()) return -1;
        while (k <= se) {
          int rs = br.huff(act);
          if (rs < 0) return -1;
          int r = rs >> 4, s = rs & 15;
          short newval = 0;
          if (s == 0) {
            if (r != 15) {  // EOBn: refine the rest of the band below
              eobrun = (1L << r);
              if (r) eobrun += br.bits(r);
              break;
            }
            // ZRL: skip 16 zero-history positions (with corrections)
          } else {
            if (s != 1) return -1;  // refinement only creates +-1<<al
            newval = br.bit() ? p1 : m1;
          }
          // advance past `r` zero-history coefficients, refining nonzeros
          while (k <= se) {
            short* cp = blk + k;
            if (*cp != 0) {
              if (br.bit() && ((*cp & p1) == 0))
                *cp += (short)(*cp >= 0 ? p1 : m1);
            } else {
              if (r == 0) {
                if (newval) *cp = newval;
                k++;
                break;
              }
              r--;
            }
            k++;
          }
        }
      }
      if (eobrun > 0) {
        // end-of-band: refine every remaining nonzero coefficient
        for (; k <= se; k++) {
          short* cp = blk + k;
          if (*cp != 0) {
            if (br.bit() && ((*cp & p1) == 0))
              *cp += (short)(*cp >= 0 ? p1 : m1);
          }
        }
        eobrun--;
      }
      if (ri) togo--;
    }
  }
  return 0;
}

}  // namespace

// ============================================================================
// Full-precision read (jpeg_full.h): the same scan decoders with int16 AC
// stores and every coefficient selected, driven over every scan of the
// stream. Baseline scans go through decode_scan (an interleaved scan on the
// MCU grid, a single-component scan on the component's own block grid);
// progressive scans through the SOF2 decoders above, none skipped.

namespace dali_tpu_torch {

namespace {

// Frame checks and geometry shared by the header and the full read.
int read_frame(Parser& ps, JpegFull* f) {
  ps.allow_progressive = true;
  ps.full = true;
  int rc = ps.parse();
  if (rc != 0) return rc;
  if (ps.prec != 8 || ps.H <= 0 || ps.W <= 0) return 1;
  const int nc = ps.ncomp;
  // libjpeg's colour-space guess (jdapimin.c default_decompress_parms)
  int color = kUnknown;
  if (nc == 1) {
    color = kGray;
  } else if (nc == 3) {
    if (ps.jfif)
      color = kYCbCr;
    else if (ps.adobe >= 0)
      color = ps.adobe == 0 ? kRGB : kYCbCr;
    else
      color = ps.comp[0].id == 82 && ps.comp[1].id == 71 && ps.comp[2].id == 66 ? kRGB : kYCbCr;
  } else if (nc == 4) {
    color = ps.adobe > 0 ? kYCCK : kCMYK;  // Adobe transform 0 or no marker: CMYK
  }
  f->H = ps.H;
  f->W = ps.W;
  f->ncomp = nc;
  f->color = color;
  f->progressive = ps.progressive;
  int hmax = 1, vmax = 1;
  for (int i = 0; i < nc; i++) {
    hmax = std::max(hmax, nc == 1 ? 1 : ps.comp[i].h);
    vmax = std::max(vmax, nc == 1 ? 1 : ps.comp[i].v);
  }
  f->hmax = hmax;
  f->vmax = vmax;
  for (int i = 0; i < nc; i++) {
    f->h[i] = nc == 1 ? 1 : ps.comp[i].h;
    f->v[i] = nc == 1 ? 1 : ps.comp[i].v;
    f->bw[i] = (ps.W * f->h[i] + 8 * hmax - 1) / (8 * hmax);
    f->bh[i] = (ps.H * f->v[i] + 8 * vmax - 1) / (8 * vmax);
  }
  return 0;
}

// libjpeg's checks of a progressive scan's parameters (jdphuff.c
// start_pass_phuff_decoder: an error, not a warning) and its update of the
// progression status of coefficients 0-9 of each component in the scan.
bool prog_scan_start(const Parser& ps, JpegFull* f) {
  const bool dc = ps.ss == 0;
  if (dc ? ps.se != 0 : (ps.ss > ps.se || ps.se > 63 || ps.ns != 1)) return false;
  if ((ps.ah != 0 && ps.al != ps.ah - 1) || ps.al > 13) return false;
  f->nscans++;
  for (int s = 0; s < ps.ns; s++) {
    const int c = ps.scan_comp[s];
    for (int k = std::min(ps.ss, 1); k <= std::min(std::max(ps.se, 9), 9); k++)
      f->prev_bits[c][k] = f->nscans > 1 ? f->coef_bits[c][k] : 0;
    for (int k = ps.ss; k <= std::min(ps.se, 9); k++) f->coef_bits[c][k] = ps.al;
  }
  return true;
}

}  // namespace

int jpeg_read_header(const uint8_t* data, size_t len, JpegFull* f) {
  Parser ps(data, len);
  return read_frame(ps, f);
}

int jpeg_read_full(const uint8_t* data, size_t len, JpegFull* f) {
  Parser ps(data, len);
  int rc = read_frame(ps, f);
  if (rc != 0) return rc;
  const int nc = f->ncomp, hmax = f->hmax, vmax = f->vmax;
  const int mcus_x = (ps.W + 8 * hmax - 1) / (8 * hmax);
  const int mcus_y = (ps.H + 8 * vmax - 1) / (8 * vmax);
  for (int i = 0; i < nc; i++) f->coef[i].assign((size_t)f->bh[i] * f->bw[i] * 64, 0);
  for (int i = 0; i < 4; i++)
    for (int k = 0; k < 10; k++) f->coef_bits[i][k] = f->prev_bits[i][k] = -1;
  f->nscans = 0;
  f->last_good_row = mcus_y - 1;
  f->eoi = false;
  // zigzag index -> slot of the AC store, which starts at coefficient 1 of
  // the block: natural index - 1
  signed char zmap[64];
  for (int z = 0; z < 64; z++) zmap[z] = (signed char)(kZZ.nat[z] - 1);

  if (!ps.progressive) {
    for (;;) {
      const bool single = ps.ns == 1;
      int blocks = 0;
      for (int s = 0; s < ps.ns; s++) blocks += f->h[ps.scan_comp[s]] * f->v[ps.scan_comp[s]];
      if (!single && blocks > 10) return -1;  // libjpeg's D_MAX_BLOCKS_IN_MCU
      CompStateT<short> cs[4];
      for (int s = 0; s < ps.ns; s++) {
        const int i = ps.scan_comp[s], td = ps.scan_td[s], ta = ps.scan_ta[s];
        if (!ps.htdc[td].valid || !ps.htac[ta].valid || !ps.fdc[td] || !ps.fac[ta]) return -1;
        short* base = f->coef[i].data();
        cs[s] = {base, base + 1, zmap, &ps.htdc[td], &ps.htac[ta], ps.fac[ta], ps.fdc[td],
                 single ? 1 : f->h[i], single ? 1 : f->v[i], f->bh[i], f->bw[i], 0, 0, 64,
                 f->bh[i], f->bw[i]};
        cs[s].fsk = ps.fsk[ta];
        cs[s].dcs = 64;
      }
      const int i0 = ps.scan_comp[0];
      const uint8_t* end = nullptr;
      decode_scan<false, short>(ps, cs, data + len, single ? f->bw[i0] : mcus_x,
                                single ? f->bh[i0] : mcus_y, nullptr, ps.ns, nullptr, 0, 0,
                                &end);
      // a stream that ends before EOI ends here, as libjpeg's inserted EOI does
      if (end == nullptr || end >= data + len) break;
      const uint8_t* prev = ps.scan_start;
      const int pr = ps.parse_next_scan(end);
      if (pr == -1) return -1;
      if (pr != 0 || ps.saw_eoi || ps.scan_start <= prev) break;
    }
  } else {
    ProgComp pc[4];
    std::vector<short> zz[4];
    for (int i = 0; i < nc; i++) {
      ProgComp& C = pc[i];
      C.h = f->h[i];
      C.v = f->v[i];
      C.full_bw = mcus_x * C.h;
      C.real_bw = f->bw[i];
      C.real_bh = f->bh[i];
      C.rows_dec = f->bh[i];
      zz[i].assign((size_t)C.rows_dec * C.full_bw * 64, 0);
      C.coef = &zz[i];
      C.last_dc = 0;
    }
    thread_local Unstuffed tl_fus;
    for (;;) {
      if (!prog_scan_start(ps, f)) return -1;
      for (int s = 0; s < ps.ns; s++)
        if (ps.ss == 0 ? ps.ah == 0 && !ps.htdc[ps.scan_td[s]].valid
                       : !ps.htac[ps.scan_ta[s]].valid)
          return -1;
      const uint8_t* cursor = ps.scan_start;
      unstuff_scan(cursor, data + len, &tl_fus);
      int idx[4];
      for (int s = 0; s < ps.ns; s++) idx[s] = ps.scan_comp[s];
      int r2, good = 0;
      if (ps.ss == 0) {
        r2 = prog_dc_scan(ps, pc, idx, ps.ns, tl_fus, mcus_x,
                          ps.ns == 1 ? pc[idx[0]].rows_dec : mcus_y, &good);
      } else {
        ProgComp& C = pc[idx[0]];
        r2 = ps.ah == 0 ? prog_ac_first(ps, C, 0, tl_fus, C.rows_dec, &good)
                        : prog_ac_refine(ps, C, 0, tl_fus, C.rows_dec, &good);
      }
      f->last_good_row = good;
      // a scan that breaks off keeps what it decoded, and the stream ends
      if (r2 != 0 || tl_fus.in_end >= data + len) break;
      const int pr = ps.parse_next_scan(tl_fus.in_end);
      if (pr == -1) return -1;
      if (pr != 0 || ps.saw_eoi || ps.scan_start <= cursor) break;
    }
    for (int i = 0; i < nc; i++) {
      short* dst = f->coef[i].data();
      for (int r = 0; r < f->bh[i]; r++)
        for (int c = 0; c < f->bw[i]; c++) {
          const short* b = zz[i].data() + ((size_t)r * pc[i].full_bw + c) * 64;
          short* o = dst + ((size_t)r * f->bw[i] + c) * 64;
          for (int z = 0; z < 64; z++) o[kZZ.nat[z]] = b[z];
        }
    }
  }
  for (int i = 0; i < nc; i++) {
    if (!ps.qok[ps.comp[i].tq]) return -1;
    std::memcpy(f->q[i], ps.qt[ps.comp[i].tq], sizeof(f->q[i]));
  }
  f->eoi = ps.saw_eoi;
  return 0;
}

}  // namespace dali_tpu_torch

extern "C" {

// The split crop contract below (DC int16, AC saturated to int8, the k x k
// selection of a block window) over the full read: for the streams the two
// fast decoders decline (progressive grayscale, one scan per component),
// where the reference falls back to libjpeg. Returns as jpeg_read_full.
int dali_tpu_torch_jpeg_full_read_coeffs_split_crop(
    const char* data, size_t len, int ky, int kc, short* y_dc, signed char* y_ac,
    short* cb_dc, signed char* cb_ac, short* cr_dc, signed char* cr_ac,
    unsigned short* q_out, int y_bh, int y_bw, int c_bh, int c_bw, int y_br0,
    int y_bc0, int c_br0, int c_bc0) {
  if (ky < 1 || ky > 8 || kc < 1 || kc > 8) return 1;
  dali_tpu_torch::JpegFull f;
  int rc = dali_tpu_torch::jpeg_read_full(reinterpret_cast<const uint8_t*>(data), len, &f);
  if (rc != 0) return rc;
  if (!f.wire_form()) return 1;
  short* dcs[3] = {y_dc, cb_dc, cr_dc};
  signed char* acs[3] = {y_ac, cb_ac, cr_ac};
  for (int c = 0; c < 3; c++) {
    const int k = c == 0 ? ky : kc, nac = k * k - 1;
    const int bh = c == 0 ? y_bh : c_bh, bw = c == 0 ? y_bw : c_bw;
    const int br0 = c == 0 ? y_br0 : c_br0, bc0 = c == 0 ? y_bc0 : c_bc0;
    for (int br = 0; br < bh; br++)
      for (int bc = 0; bc < bw; bc++) {
        const long b = (long)br * bw + bc;
        const int sr = br + br0, sc = bc + bc0;
        signed char* ac = acs[c] + b * nac;
        if (c >= f.ncomp || sr < 0 || sc < 0 || sr >= f.bh[c] || sc >= f.bw[c]) {
          dcs[c][b] = 0;
          std::memset(ac, 0, nac);
          continue;
        }
        const short* blk = f.coef[c].data() + ((size_t)sr * f.bw[c] + sc) * 64;
        dcs[c][b] = blk[0];
        for (int r = 0; r < k; r++)
          for (int cc = 0; cc < k; cc++)
            if (r || cc) ac[r * k + cc - 1] = sat8(blk[r * 8 + cc]);
      }
  }
  for (int c = 0; c < 2; c++) {
    const int k = c == 0 ? ky : kc;
    unsigned short* qd = q_out + (c == 0 ? 0 : ky * ky);
    for (int r = 0; r < k; r++)
      for (int cc = 0; cc < k; cc++) qd[r * k + cc] = c < f.ncomp ? f.q[c][r * 8 + cc] : 1;
  }
  return 0;
}

// Same contract as dali_tpu_jpeg_read_coeffs_split_crop
// (jpeg_coeffs_split.cc): window dims are CANVAS dims (may exceed the real
// block extent; uncovered cells are zero). Returns 0 on success; nonzero
// means unsupported-or-corrupt and the caller should fall back to libjpeg.
int dali_tpu_jpeg_huff_read_coeffs_split_crop(
    const char* data_, size_t len, int ky, int kc, short* y_dc,
    signed char* y_ac, short* cb_dc, signed char* cb_ac, short* cr_dc,
    signed char* cr_ac, unsigned short* q_out, int y_bh, int y_bw, int c_bh,
    int c_bw, int y_br0, int y_bc0, int c_br0, int c_bc0) {
  const uint8_t* data = reinterpret_cast<const uint8_t*>(data_);
  Parser ps(data, len);
  int rc = ps.parse();
  if (rc != 0) return rc;
  if (ky < 1 || ky > 8 || kc < 1 || kc > 8) return 1;

  // zigzag index -> ac slot (selection r<k, c<k; slot r*k+c-1), or -1
  signed char zmap_y[64], zmap_c[64];
  for (int z = 1; z < 64; z++) {
    int r = kZZ.nat[z] >> 3, c = kZZ.nat[z] & 7;
    zmap_y[z] = (r < ky && c < ky) ? (signed char)(r * ky + c - 1) : -1;
    zmap_c[z] = (r < kc && c < kc) ? (signed char)(r * kc + c - 1) : -1;
  }

  // quant tables (natural order, k*k selection) — written regardless of how
  // far the scan decodes, like the libjpeg path. Grayscale: chroma table 1s
  // (its coefficients are all zero).
  const int nc = ps.ncomp == 1 ? 1 : 3;
  for (int comp = 0; comp < 2; comp++) {
    int k = comp == 0 ? ky : kc;
    unsigned short* qdst = comp == 0 ? q_out : q_out + ky * ky;
    if (comp == 1 && nc == 1) {
      for (int i = 0; i < k * k; i++) qdst[i] = 1;
      continue;
    }
    const uint16_t* src = ps.qt[ps.comp[comp].tq];
    for (int r = 0; r < k; r++)
      for (int c = 0; c < k; c++) qdst[r * k + c] = src[r * 8 + c];
  }

  const int hmax = ps.comp[0].h, vmax = ps.comp[0].v;  // chroma is 1x1
  const int mcus_x = (ps.W + 8 * hmax - 1) / (8 * hmax);
  const int mcus_y = (ps.H + 8 * vmax - 1) / (8 * vmax);

  CompState cs[3];
  short* dcs[3] = {y_dc, cb_dc, cr_dc};
  signed char* acs[3] = {y_ac, cb_ac, cr_ac};
  if (nc == 1) {  // grayscale: zero chroma planes (Cb=Cr=128 => R=G=B=Y)
    std::memset(cb_dc, 0, sizeof(short) * (size_t)c_bh * c_bw);
    std::memset(cr_dc, 0, sizeof(short) * (size_t)c_bh * c_bw);
    std::memset(cb_ac, 0, (size_t)c_bh * c_bw * (kc * kc - 1));
    std::memset(cr_ac, 0, (size_t)c_bh * c_bw * (kc * kc - 1));
  }
  for (int i = 0; i < nc; i++) {
    int slot = 0;
    for (int s = 0; s < ps.ns; s++)
      if (ps.scan_comp[s] == i) slot = s;
    const int k = i == 0 ? ky : kc;
    cs[i] = {dcs[i],
             acs[i],
             i == 0 ? zmap_y : zmap_c,
             &ps.htdc[ps.scan_td[slot]],
             &ps.htac[ps.scan_ta[slot]],
             ps.fac[ps.scan_ta[slot]],
             ps.fdc[ps.scan_td[slot]],
             ps.comp[i].h,
             ps.comp[i].v,
             i == 0 ? y_bh : c_bh,
             i == 0 ? y_bw : c_bw,
             i == 0 ? y_br0 : c_br0,
             i == 0 ? y_bc0 : c_bc0,
             k * k - 1,
             (ps.H * ps.comp[i].v + 8 * vmax - 1) / (8 * vmax),
             (ps.W * ps.comp[i].h + 8 * hmax - 1) / (8 * hmax)};
    cs[i].fsk = ps.fsk[ps.scan_ta[slot]];
    std::memset(cs[i].dc, 0, sizeof(short) * (size_t)cs[i].bh * cs[i].bw);
    std::memset(cs[i].ac, 0, (size_t)cs[i].bh * cs[i].bw * cs[i].nac);
  }

  // Early stop: last MCU row any window needs (decode everything above it —
  // sequential Huffman is stateful — but nothing below it).
  int stop_my = 0;
  for (int i = 0; i < nc; i++) {
    int need = (cs[i].br0 + cs[i].bh + cs[i].v - 1) / cs[i].v;
    if (need > stop_my) stop_my = need;
  }
  if (stop_my > mcus_y) stop_my = mcus_y;

  return decode_scan<false>(ps, cs, data + len, mcus_x, stop_my, nullptr, nc);
}

// Progressive (SOF2) entry: same contract as the baseline crop entry.
// Scans whose spectral band lies entirely above the k*k selection's highest
// zigzag index are skipped without decoding; every scan stops after the
// window's last needed block row. Returns 0 ok; nonzero = unsupported or
// corrupt (caller falls back to libjpeg).
int dali_tpu_jpeg_huff_progressive_read_coeffs_split_crop(
    const char* data_, size_t len, int ky, int kc, short* y_dc,
    signed char* y_ac, short* cb_dc, signed char* cb_ac, short* cr_dc,
    signed char* cr_ac, unsigned short* q_out, int y_bh, int y_bw, int c_bh,
    int c_bw, int y_br0, int y_bc0, int c_br0, int c_bc0) {
  const uint8_t* data = reinterpret_cast<const uint8_t*>(data_);
  Parser ps(data, len);
  ps.allow_progressive = true;
  int rc = ps.parse();
  if (rc != 0) return rc;
  if (!ps.progressive) return 1;  // baseline: use the fast path instead
  if (ky < 1 || ky > 8 || kc < 1 || kc > 8) return 1;
  if (ps.prec != 8 || ps.ncomp != 3) return 1;
  bool c420 = ps.comp[0].h == 2 && ps.comp[0].v == 2 && ps.comp[1].h == 1 &&
              ps.comp[1].v == 1 && ps.comp[2].h == 1 && ps.comp[2].v == 1;
  bool c444 = ps.comp[0].h == 1 && ps.comp[0].v == 1 && ps.comp[1].h == 1 &&
              ps.comp[1].v == 1 && ps.comp[2].h == 1 && ps.comp[2].v == 1;
  bool c422 = ps.comp[0].h == 2 && ps.comp[0].v == 1 && ps.comp[1].h == 1 &&
              ps.comp[1].v == 1 && ps.comp[2].h == 1 && ps.comp[2].v == 1;
  if (!c420 && !c444 && !c422) return 1;
  if (ps.comp[1].tq != ps.comp[2].tq) return 1;

  const int hmax = ps.comp[0].h, vmax = ps.comp[0].v;
  const int mcus_x = (ps.W + 8 * hmax - 1) / (8 * hmax);
  const int mcus_y = (ps.H + 8 * vmax - 1) / (8 * vmax);

  // zigzag coverage of the k*k selection: the highest zigzag index any
  // selected coefficient occupies (scan-skip bound)
  int zmax_y = 0, zmax_c = 0;
  for (int z = 1; z < 64; z++) {
    int r = kZZ.nat[z] >> 3, c = kZZ.nat[z] & 7;
    if (r < ky && c < ky) zmax_y = z;
    if (r < kc && c < kc) zmax_c = z;
  }

  // window geometry per component (coefficients stored in ZIGZAG order)
  ProgComp pc[3];
  thread_local std::vector<short> tl_coef[3];
  int want_bh[3] = {y_bh, c_bh, c_bh};
  int want_bw[3] = {y_bw, c_bw, c_bw};
  int want_br0[3] = {y_br0, c_br0, c_br0};
  int want_bc0[3] = {y_bc0, c_bc0, c_bc0};
  int stop_my = 0;
  for (int i = 0; i < 3; i++) {
    ProgComp& C = pc[i];
    C.h = ps.comp[i].h;
    C.v = ps.comp[i].v;
    C.full_bw = mcus_x * C.h;
    C.real_bh = (ps.H * C.v + 8 * vmax - 1) / (8 * vmax);
    C.real_bw = (ps.W * C.h + 8 * hmax - 1) / (8 * hmax);
    // rows we must DECODE: everything above + inside the window (refinement
    // scans consume bits per prior nonzero, so earlier rows need true state)
    int need_rows = want_br0[i] + want_bh[i];
    if (need_rows > C.real_bh) need_rows = C.real_bh;
    int mcu_rows_full = mcus_y * C.v;  // interleaved DC may touch padded rows
    C.rows_dec = need_rows;
    // DC scan row coverage in MCU rows:
    int need_my = (need_rows + C.v - 1) / C.v;
    if (need_my > stop_my) stop_my = need_my;
    (void)mcu_rows_full;
    size_t cells = (size_t)C.rows_dec * C.full_bw * 64;
    if (tl_coef[i].size() < cells) tl_coef[i].resize(cells);
    std::fill(tl_coef[i].begin(), tl_coef[i].begin() + cells, (short)0);
    C.coef = &tl_coef[i];
    C.last_dc = 0;
  }
  if (stop_my > mcus_y) stop_my = mcus_y;

  // Pass 1: record every scan's (component, band) WITHOUT decoding, to
  // compute which scans the selection actually needs. A scan can only be
  // skipped if no DECODED scan of the same component has an overlapping
  // band — successive-approximation refinements consume one bit per prior
  // NONZERO coefficient, so skipping a first-pass scan that a decoded
  // refinement overlaps would desynchronize the refinement's bitstream
  // (fixpoint below; the standard libjpeg script refines 1..63, which
  // pulls in the 6..63 first pass even for small selections).
  struct ScanHead {
    int ci, ss, se;  // ci = -1 for (interleaved) DC scans
  };
  std::vector<ScanHead> heads;
  thread_local Unstuffed tl_pus;
  {
    Parser p1(data, len);
    p1.allow_progressive = true;
    if (p1.parse() != 0 || !p1.progressive) return 1;
    const uint8_t* cur = p1.scan_start;
    for (;;) {
      unstuff_scan(cur, data + len, &tl_pus);
      heads.push_back({p1.ss == 0 ? -1 : p1.scan_comp[0], p1.ss, p1.se});
      if (p1.ss == 0 && p1.se != 0) return 1;  // mixed DC+AC band
      if (p1.ss != 0 && p1.ns != 1) return 1;  // AC must be single-comp
      if (tl_pus.in_end >= data + len) break;
      if (p1.parse_next_scan(tl_pus.in_end) != 0) return 1;
      if (p1.saw_eoi || p1.scan_start == nullptr) break;
      if (p1.scan_start <= cur) return 1;  // no forward progress
      cur = p1.scan_start;
    }
  }
  std::vector<char> keep(heads.size(), 0);
  for (size_t i = 0; i < heads.size(); i++) {
    if (heads[i].ci < 0) keep[i] = 1;  // DC scans always needed
    else {
      int zmax = heads[i].ci == 0 ? zmax_y : zmax_c;
      if (heads[i].ss <= zmax) keep[i] = 1;
    }
  }
  for (bool changed = true; changed;) {
    changed = false;
    for (size_t i = 0; i < heads.size(); i++) {
      if (keep[i] || heads[i].ci < 0) continue;
      for (size_t jx = 0; jx < heads.size(); jx++) {
        if (!keep[jx] || heads[jx].ci != heads[i].ci) continue;
        if (heads[i].ss <= heads[jx].se && heads[jx].ss <= heads[i].se) {
          keep[i] = 1;
          changed = true;
          break;
        }
      }
    }
  }

  // Pass 2: decode the kept scans in order
  const uint8_t* cursor = ps.scan_start;
  size_t si = 0;
  int good = 0;  // unused here: the wire applies no block smoothing
  for (;;) {
    unstuff_scan(cursor, data + len, &tl_pus);
    if (si >= heads.size()) return 1;
    const bool decode_this = keep[si];
    si++;
    int idx[4];
    for (int s = 0; s < ps.ns; s++) idx[s] = ps.scan_comp[s];
    if (decode_this) {
      if (ps.ss == 0) {
        int my_end = ps.ns == 1 ? pc[idx[0]].rows_dec : stop_my;
        if (prog_dc_scan(ps, pc, idx, ps.ns, tl_pus, mcus_x, my_end, &good) != 0)
          return 1;
      } else {
        ProgComp& C = pc[idx[0]];
        int r2 = (ps.ah == 0)
                     ? prog_ac_first(ps, C, 0, tl_pus, C.rows_dec, &good)
                     : prog_ac_refine(ps, C, 0, tl_pus, C.rows_dec, &good);
        if (r2 != 0) return 1;
      }
    }
    if (tl_pus.in_end >= data + len) break;
    if (ps.parse_next_scan(tl_pus.in_end) != 0) return 1;
    if (ps.saw_eoi || ps.scan_start == nullptr) break;
    if (ps.scan_start <= cursor) return 1;  // no forward progress: corrupt
    cursor = ps.scan_start;
  }

  // quant tables (same layout as the baseline entry)
  for (int comp = 0; comp < 2; comp++) {
    int k = comp == 0 ? ky : kc;
    if (!ps.qok[ps.comp[comp].tq]) return 1;
    const uint16_t* srcq = ps.qt[ps.comp[comp].tq];
    unsigned short* qdst = comp == 0 ? q_out : q_out + ky * ky;
    for (int r = 0; r < k; r++)
      for (int c = 0; c < k; c++) qdst[r * k + c] = srcq[r * 8 + c];
  }

  // emit the window: zigzag-stored coefficients -> split DC/AC selection
  short* dcs[3] = {y_dc, cb_dc, cr_dc};
  signed char* acs[3] = {y_ac, cb_ac, cr_ac};
  for (int i = 0; i < 3; i++) {
    const ProgComp& C = pc[i];
    const int k = i == 0 ? ky : kc;
    const int nac = k * k - 1;
    signed char zmap[64];
    for (int z = 0; z < 64; z++) {
      int r = kZZ.nat[z] >> 3, c = kZZ.nat[z] & 7;
      zmap[z] = (z > 0 && r < k && c < k) ? (signed char)(r * k + c - 1) : -1;
    }
    for (int br = 0; br < want_bh[i]; br++) {
      const int srow = br + want_br0[i];
      for (int bc = 0; bc < want_bw[i]; bc++) {
        const int scol = bc + want_bc0[i];
        long bidx = (long)br * want_bw[i] + bc;
        short* dcp = dcs[i] + bidx;
        signed char* acp = acs[i] + bidx * nac;
        if (srow < C.rows_dec && scol < C.real_bw) {
          const short* blk =
              C.coef->data() + ((size_t)srow * C.full_bw + scol) * 64;
          *dcp = blk[0];
          for (int z = 1; z < 64; z++)
            if (zmap[z] >= 0) acp[zmap[z]] = sat8(blk[z]);
        } else {
          *dcp = 0;
          std::memset(acp, 0, nac);
        }
      }
    }
  }
  return 0;
}

// Pack-emit entry: like the crop entry, but the AC output is the sparse
// wire itself — zigzag-convention per-block uint16 masks (y_mask[bh*bw],
// c_mask[2*c_bh*c_bw] as Cb plane then Cr plane) and the nonzero int8
// values compacted CONTIGUOUSLY per image into y_vals / c_vals (counts out
// via y_nnz / c_nnz; c stream is Cb rows then Cr rows). DC planes are dense
// int16 as before. Requires the k*k-1 selection to fit a uint16 bitmap
// (ky, kc <= 4); larger selections return 1 (caller falls back).
int dali_tpu_jpeg_huff_read_coeffs_split_crop_pack_idx(
    const char* data_, size_t len, int ky, int kc, short* y_dc,
    unsigned short* y_mask, signed char* y_vals, long long* y_nnz,
    short* cb_dc, short* cr_dc, unsigned short* c_mask, signed char* c_vals,
    long long* c_nnz, unsigned short* q_out, int y_bh, int y_bw, int c_bh,
    int c_bw, int y_br0, int y_bc0, int c_br0, int c_bc0,
    unsigned char* idx_buf, long long idx_cap) {
  *y_nnz = 0;
  *c_nnz = 0;
  if (ky < 1 || ky > 4 || kc < 1 || kc > 4) return 1;  // mask is uint16
  const uint8_t* data = reinterpret_cast<const uint8_t*>(data_);
  long long t_parse0 = now_ns();
  Parser ps(data, len);
  int rc = ps.parse();
  g_hstats.ns_parse.fetch_add(now_ns() - t_parse0, std::memory_order_relaxed);
  if (rc != 0) return rc;
  if (ps.ncomp != 3) return 1;  // grayscale rides the dense fallback

  // zigzag index -> mask bit (bit b = b-th SELECTED coefficient in zigzag
  // order); the device permutes bit order -> slot order with a constant
  // nac-gather (executor._unsparse_boundary).
  uint16_t zbit_y[64], zbit_c[64];
  {
    int by = 0, bc_ = 0;
    for (int z = 0; z < 64; z++) {
      int r = kZZ.nat[z] >> 3, c = kZZ.nat[z] & 7;
      zbit_y[z] = (z > 0 && r < ky && c < ky) ? (uint16_t)(1u << by++) : 0;
      zbit_c[z] = (z > 0 && r < kc && c < kc) ? (uint16_t)(1u << bc_++) : 0;
    }
  }
  for (int comp = 0; comp < 2; comp++) {
    int k = comp == 0 ? ky : kc;
    const uint16_t* srcq = ps.qt[ps.comp[comp].tq];
    unsigned short* qdst = comp == 0 ? q_out : q_out + ky * ky;
    for (int r = 0; r < k; r++)
      for (int c = 0; c < k; c++) qdst[r * k + c] = srcq[r * 8 + c];
  }
  const int hmax = ps.comp[0].h, vmax = ps.comp[0].v;
  const int mcus_x = (ps.W + 8 * hmax - 1) / (8 * hmax);
  const int mcus_y = (ps.H + 8 * vmax - 1) / (8 * vmax);
  const int nac_y = ky * ky - 1, nac_c = kc * kc - 1;

  CompState cs[3];
  short* dcs[3] = {y_dc, cb_dc, cr_dc};
  for (int i = 0; i < 3; i++) {
    int slot = 0;
    for (int s = 0; s < ps.ns; s++)
      if (ps.scan_comp[s] == i) slot = s;
    const int k = i == 0 ? ky : kc;
    cs[i] = {dcs[i],
             nullptr,  // no dense AC planes in pack mode
             nullptr,
             &ps.htdc[ps.scan_td[slot]],
             &ps.htac[ps.scan_ta[slot]],
             ps.fac[ps.scan_ta[slot]],
             ps.fdc[ps.scan_td[slot]],
             ps.comp[i].h,
             ps.comp[i].v,
             i == 0 ? y_bh : c_bh,
             i == 0 ? y_bw : c_bw,
             i == 0 ? y_br0 : c_br0,
             i == 0 ? y_bc0 : c_bc0,
             k * k - 1,
             (ps.H * ps.comp[i].v + 8 * vmax - 1) / (8 * vmax),
             (ps.W * ps.comp[i].h + 8 * hmax - 1) / (8 * hmax)};
    cs[i].fsk = ps.fsk[ps.scan_ta[slot]];
    std::memset(cs[i].dc, 0, sizeof(short) * (size_t)cs[i].bh * cs[i].bw);
  }
  std::memset(y_mask, 0, sizeof(unsigned short) * (size_t)y_bh * y_bw);
  std::memset(c_mask, 0, sizeof(unsigned short) * 2 * (size_t)c_bh * c_bw);

  // per-row value arena (slack-strided; rows compact into the caller's
  // contiguous vals buffers afterwards) + per-row length bookkeeping
  const long y_stride = (long)y_bw * nac_y + 16;
  const long c_stride = (long)c_bw * nac_c + 16;
  thread_local std::vector<signed char> tl_arena;
  thread_local std::vector<int> tl_lens;
  size_t need = (size_t)y_bh * y_stride + 2 * (size_t)c_bh * c_stride;
  if (tl_arena.size() < need) tl_arena.resize(need);
  if (tl_lens.size() < (size_t)(y_bh + 2 * c_bh)) tl_lens.resize(y_bh + 2 * c_bh);
  std::fill(tl_lens.begin(), tl_lens.begin() + y_bh + 2 * c_bh, 0);
  signed char* y_arena = tl_arena.data();
  signed char* cb_arena = y_arena + (size_t)y_bh * y_stride;
  signed char* cr_arena = cb_arena + (size_t)c_bh * c_stride;
  int* y_lens = tl_lens.data();
  int* cb_lens = y_lens + y_bh;
  int* cr_lens = cb_lens + c_bh;
  PackComp pk[3] = {
      {y_mask, zbit_y, y_arena, y_stride, y_lens},
      {c_mask, zbit_c, cb_arena, c_stride, cb_lens},
      {c_mask + (size_t)c_bh * c_bw, zbit_c, cr_arena, c_stride, cr_lens},
  };

  int stop_my = 0;
  for (int i = 0; i < 3; i++) {
    int nd = (cs[i].br0 + cs[i].bh + cs[i].v - 1) / cs[i].v;
    if (nd > stop_my) stop_my = nd;
  }
  if (stop_my > mcus_y) stop_my = mcus_y;

  long long t_scan0 = now_ns();
  decode_scan<true>(ps, cs, data + len, mcus_x, stop_my, pk, 3, idx_buf,
                    idx_cap, mcus_y);
  long long t_scan1 = now_ns();
  g_hstats.ns_scan.fetch_add(t_scan1 - t_scan0, std::memory_order_relaxed);

  // compact per-row streams into the contiguous per-image value buffers
  long long yt = 0;
  for (int r = 0; r < y_bh; r++) {
    std::memcpy(y_vals + yt, y_arena + (size_t)r * y_stride, y_lens[r]);
    yt += y_lens[r];
  }
  long long ct = 0;
  for (int r = 0; r < c_bh; r++) {
    std::memcpy(c_vals + ct, cb_arena + (size_t)r * c_stride, cb_lens[r]);
    ct += cb_lens[r];
  }
  for (int r = 0; r < c_bh; r++) {
    std::memcpy(c_vals + ct, cr_arena + (size_t)r * c_stride, cr_lens[r]);
    ct += cr_lens[r];
  }
  g_hstats.ns_rowcompact.fetch_add(now_ns() - t_scan1,
                                   std::memory_order_relaxed);
  g_hstats.n_imgs.fetch_add(1, std::memory_order_relaxed);
  *y_nnz = yt;
  *c_nnz = ct;
  return 0;
}

// Index-less compatibility entry (microbench legacy lanes, dense-parity
// tests): identical decode, no seek cache.
int dali_tpu_jpeg_huff_read_coeffs_split_crop_pack(
    const char* data_, size_t len, int ky, int kc, short* y_dc,
    unsigned short* y_mask, signed char* y_vals, long long* y_nnz,
    short* cb_dc, short* cr_dc, unsigned short* c_mask, signed char* c_vals,
    long long* c_nnz, unsigned short* q_out, int y_bh, int y_bw, int c_bh,
    int c_bw, int y_br0, int y_bc0, int c_br0, int c_bc0) {
  return dali_tpu_jpeg_huff_read_coeffs_split_crop_pack_idx(
      data_, len, ky, kc, y_dc, y_mask, y_vals, y_nnz, cb_dc, cr_dc, c_mask,
      c_vals, c_nnz, q_out, y_bh, y_bw, c_bh, c_bw, y_br0, y_bc0, c_br0,
      c_bc0, nullptr, 0);
}

// Snapshot (and optionally reset) the decode-phase itemization counters.
// Layout: [parse, unstuff, scan_incl_unstuff, rowcompact] ns, then
// [tbl_hits, tbl_misses, n_imgs].
extern "C" void dali_tpu_huff_stats(long long out[7], int reset) {
  out[0] = g_hstats.ns_parse.load(std::memory_order_relaxed);
  out[1] = g_hstats.ns_unstuff.load(std::memory_order_relaxed);
  out[2] = g_hstats.ns_scan.load(std::memory_order_relaxed);
  out[3] = g_hstats.ns_rowcompact.load(std::memory_order_relaxed);
  out[4] = g_hstats.tbl_hits.load(std::memory_order_relaxed);
  out[5] = g_hstats.tbl_misses.load(std::memory_order_relaxed);
  out[6] = g_hstats.n_imgs.load(std::memory_order_relaxed);
  if (reset) {
    g_hstats.ns_parse.store(0, std::memory_order_relaxed);
    g_hstats.ns_unstuff.store(0, std::memory_order_relaxed);
    g_hstats.ns_scan.store(0, std::memory_order_relaxed);
    g_hstats.ns_rowcompact.store(0, std::memory_order_relaxed);
    g_hstats.tbl_hits.store(0, std::memory_order_relaxed);
    g_hstats.tbl_misses.store(0, std::memory_order_relaxed);
    g_hstats.n_imgs.store(0, std::memory_order_relaxed);
  }
}

// Pair entry: decode TWO images with their entropy loops interleaved at
// block granularity (see ScanCursor). rc_a/rc_b get the per-image status
// with the same contract as the single entry. The JAX package's batch entry
// (jpeg_coeffs_split.cc) pairs each worker's queue of images with it.
void dali_tpu_jpeg_huff_read_coeffs_split_crop_pair(
    const char* a_data, size_t a_len, const char* b_data, size_t b_len,
    int ky, int kc,
    short* a_y_dc, signed char* a_y_ac, short* a_cb_dc, signed char* a_cb_ac,
    short* a_cr_dc, signed char* a_cr_ac, unsigned short* a_q,
    int a_y_bh, int a_y_bw, int a_c_bh, int a_c_bw,
    int a_y_br0, int a_y_bc0, int a_c_br0, int a_c_bc0,
    short* b_y_dc, signed char* b_y_ac, short* b_cb_dc, signed char* b_cb_ac,
    short* b_cr_dc, signed char* b_cr_ac, unsigned short* b_q,
    int b_y_bh, int b_y_bw, int b_c_bh, int b_c_bw,
    int b_y_br0, int b_y_bc0, int b_c_br0, int b_c_bc0,
    int* rc_a, int* rc_b) {
  thread_local Unstuffed tl_us_a, tl_us_b;
  Parser psa(reinterpret_cast<const uint8_t*>(a_data), a_len);
  Parser psb(reinterpret_cast<const uint8_t*>(b_data), b_len);
  ScanCursor ca, cb;
  signed char zya[64], zca[64], zyb[64], zcb[64];
  *rc_a = setup_cursor(reinterpret_cast<const uint8_t*>(a_data), a_len, ky,
                       kc, a_y_dc, a_y_ac, a_cb_dc, a_cb_ac, a_cr_dc, a_cr_ac,
                       a_q, a_y_bh, a_y_bw, a_c_bh, a_c_bw, a_y_br0, a_y_bc0,
                       a_c_br0, a_c_bc0, &psa, &ca, &tl_us_a, zya, zca);
  *rc_b = setup_cursor(reinterpret_cast<const uint8_t*>(b_data), b_len, ky,
                       kc, b_y_dc, b_y_ac, b_cb_dc, b_cb_ac, b_cr_dc, b_cr_ac,
                       b_q, b_y_bh, b_y_bw, b_c_bh, b_c_bw, b_y_br0, b_y_bc0,
                       b_c_br0, b_c_bc0, &psb, &cb, &tl_us_b, zyb, zcb);
  if (*rc_a != 0) ca.done = true;
  if (*rc_b != 0) cb.done = true;
  decode_pair(ca, cb);
}

}  // extern "C"
