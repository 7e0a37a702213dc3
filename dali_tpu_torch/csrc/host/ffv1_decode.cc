// FFV1 (RFC 9043) frames as FFmpeg 5.1's ffv1dec.c decodes them, at 8
// bits: versions 0 and 1 (the header in each key frame, one slice) and 3
// (the header in the extradata with its CRC, slices each with a header and
// a trailer of its size, error status and CRC).
//
//   * Both coders: the range coder (rangecoder.c: 16-bit low/range, states
//     from ff_build_rac_states(0.05 * 2^32, 248), or the stream's custom
//     transition table, coded as differences from those) and Golomb-Rice
//     with run mode (get_vlc_symbol, the JPEG-LS run lengths of
//     ff_log2_run, a limit of 12 then an escape of the sample's bits).
//   * The contexts: the quantisation tables the header codes (five of them,
//     the last two only in the large set), the states kept from frame to
//     frame until the next key frame; in version 3 the extradata may carry
//     initial states.
//   * Planar YUV and grey (both chroma planes share the context set of
//     plane 1), RGB through the reversible colour transform (G, B - G,
//     R - G at 9 bits; out as bgr0, or bgra with transparency), with the
//     median predictor and the context of the left, top-left, top, top-right
//     (and, in the large set, left-left and top-top) samples.
//
// A slice whose CRC fails, whose coder stops short of or past its end, or a
// non-key frame without its key frame is damage: FFmpeg copies the previous
// picture into the slice, the port raises ValueError. Version 2
// (experimental), version 4 and more than 8 bits raise NotImplementedError
// naming item 8b.

#include <algorithm>
#include <cstring>
#include <string>
#include <vector>

#include "video.h"

namespace video {
namespace {

constexpr int kContextSize = 32;
constexpr int kMaxSlices = 1024;

const uint8_t kLog2Run[41] = {0, 0, 0, 0, 1, 1, 1, 1, 2,  2,  2,  2,  3,  3,  3,  3,  4,  4,  5,  5, 6,
                              6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24};

// AV_CRC_32_IEEE: polynomial 0x04C11DB7, most significant bit first, no
// reflection, initial value 0
uint32_t crc32_ieee(const uint8_t* p, size_t n) {
  static uint32_t table[256];
  static bool init = [] {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i << 24;
      for (int k = 0; k < 8; k++) c = (c << 1) ^ ((c & 0x80000000u) ? 0x04C11DB7u : 0);
      table[i] = c;
    }
    return true;
  }();
  (void)init;
  uint32_t crc = 0;
  for (size_t i = 0; i < n; i++) crc = (crc << 8) ^ table[(crc >> 24) ^ p[i]];
  return crc;
}

struct RangeCoder {
  int low = 0, range = 0xff00;
  const uint8_t* start = nullptr;
  const uint8_t* pos = nullptr;
  const uint8_t* end = nullptr;
  int overread = 0;
  uint8_t zero_state[256], one_state[256];

  void init(const uint8_t* buf, size_t n) {
    start = pos = buf;
    end = buf + n;
    range = 0xff00;
    low = n >= 2 ? (buf[0] << 8) | buf[1] : (n ? buf[0] << 8 : 0);
    pos += 2;
    overread = 0;
    if (low >= 0xff00) {
      low = 0xff00;
      end = pos;
    }
  }
  void build_states(int64_t factor, int max_p) {
    const int64_t one = int64_t(1) << 32;
    memset(zero_state, 0, sizeof(zero_state));
    memset(one_state, 0, sizeof(one_state));
    int last_p8 = 0;
    int64_t p = one / 2;
    for (int i = 0; i < 128; i++) {
      int p8 = int((256 * p + one / 2) >> 32);
      if (p8 <= last_p8) p8 = last_p8 + 1;
      if (last_p8 && last_p8 < 256 && p8 <= max_p) one_state[last_p8] = uint8_t(p8);
      p += ((one - p) * factor + one / 2) >> 32;
      last_p8 = p8;
    }
    for (int i = 256 - max_p; i <= max_p; i++) {
      if (one_state[i]) continue;
      p = (i * one + 128) >> 8;
      p += ((one - p) * factor + one / 2) >> 32;
      int p8 = int((256 * p + one / 2) >> 32);
      if (p8 <= i) p8 = i + 1;
      if (p8 > max_p) p8 = max_p;
      one_state[i] = uint8_t(p8);
    }
    for (int i = 1; i < 255; i++) zero_state[i] = uint8_t(256 - one_state[256 - i]);
  }
  void default_states() { build_states(int64_t(0.05 * double(int64_t(1) << 32)), 256 - 8); }
  void custom_states(const uint8_t* transition) {
    for (int j = 1; j < 256; j++) {
      one_state[j] = transition[j];
      zero_state[256 - j] = uint8_t(256 - one_state[j]);
    }
  }
  void refill() {
    if (range < 0x100) {
      range <<= 8;
      low <<= 8;
      if (pos < end) low += *pos++;
      else overread++;
    }
  }
  int bit(uint8_t* state) {
    const int range1 = (range * (*state)) >> 8;
    range -= range1;
    if (low < range) {
      *state = zero_state[*state];
      refill();
      return 0;
    }
    low -= range;
    *state = one_state[*state];
    range = range1;
    refill();
    return 1;
  }
  // get_symbol; -1 with ``bad`` set past 31 exponent bits
  int symbol(uint8_t* state, bool is_signed, bool* bad) {
    if (bit(state)) return 0;
    int e = 0;
    while (bit(state + 1 + std::min(e, 9))) {
      if (++e > 31) {
        *bad = true;
        return -1;
      }
    }
    unsigned a = 1;
    for (int i = e - 1; i >= 0; i--) a += a + bit(state + 22 + std::min(i, 9));
    const int neg = -(is_signed && bit(state + 11 + std::min(e, 10)));
    return int((a ^ unsigned(neg)) - unsigned(neg));
  }
};

struct VlcState {
  int16_t drift = 0;
  uint16_t error_sum = 4;
  int8_t bias = 0;
  uint8_t count = 1;
};

struct Plane {
  int quant_index = 0;
  int16_t quant[5][256];
  int context_count = 0;
  std::vector<uint8_t> state;  // [context_count][kContextSize]
  std::vector<VlcState> vlc;
};

struct Slice {
  int x = 0, y = 0, w = 0, h = 0;
  Plane plane[3];
  RangeCoder c;
  MsbBits gb;
  int run_index = 0;
  bool have_states = false;
};

inline int mid_pred(int a, int b, int c) {
  if (a > b) std::swap(a, b);
  if (b > c) b = c < a ? a : c;
  return b;
}

// read_quant_table / read_quant_tables: the contexts, or -1
int read_quant_table(RangeCoder& c, int16_t* table, int scale) {
  uint8_t state[kContextSize];
  memset(state, 128, sizeof(state));
  int v = 0, i = 0;
  bool bad = false;
  for (v = 0; i < 128; v++) {
    const unsigned len = unsigned(c.symbol(state, false, &bad)) + 1u;
    if (bad || len > unsigned(128 - i) || !len) return -1;
    for (unsigned k = 0; k < len; k++) table[i++] = int16_t(scale * v);
  }
  for (i = 1; i < 128; i++) table[256 - i] = int16_t(-table[i]);
  table[128] = int16_t(-table[127]);
  return 2 * v - 1;
}

int read_quant_tables(RangeCoder& c, int16_t table[5][256]) {
  int count = 1;
  for (int i = 0; i < 5; i++) {
    const int r = read_quant_table(c, table[i], count);
    if (r < 0) return -1;
    count *= r;
    if (unsigned(count) > 32768u) return -1;
  }
  return (count + 1) / 2;
}

// get_sr_golomb(gb, k, 12, bits)
int sr_golomb(MsbBits& gb, int k, int bits) {
  const uint32_t buf = gb.peek32();
  const int log = buf ? 31 - __builtin_clz(buf) : 0;
  unsigned v;
  if (log > 31 - 12) {
    v = (buf >> (log - k)) + ((30u - unsigned(log)) << k);
    gb.pos += size_t(32 + k - log);
  } else {
    gb.pos += 12;
    v = gb.get(bits) + 12 - 1;
  }
  return int(v >> 1) ^ -int(v & 1);
}

int vlc_symbol(MsbBits& gb, VlcState* s, int bits) {
  int k = 0;
  for (int i = s->count; i < s->error_sum; i += i) k++;
  int v = sr_golomb(gb, k, bits);
  v ^= ((2 * s->drift + s->count) >> 31);
  int ret = v + s->bias;
  ret = bits == 8 ? int(int8_t(ret)) : int(unsigned(ret) << (32 - bits)) >> (32 - bits);
  // update_vlc_state
  int drift = s->drift, count = s->count;
  s->error_sum = uint16_t(s->error_sum + (v < 0 ? -v : v));
  drift += v;
  if (count == 128) {
    count >>= 1;
    drift >>= 1;
    s->error_sum >>= 1;
  }
  count++;
  if (drift <= -count) {
    s->bias = int8_t(std::max(s->bias - 1, -128));
    drift = std::max(drift + count, -count + 1);
  } else if (drift > 0) {
    s->bias = int8_t(std::min(s->bias + 1, 127));
    drift = std::min(drift - count, 0);
  }
  s->drift = int16_t(drift);
  s->count = uint8_t(count);
  return ret;
}

}  // namespace

struct Ffv1Decoder::Impl {
  int width = 0, height = 0;
  int version = -1, micro_version = 0;
  int ac = 0;  // 0 Golomb-Rice, 1 range (default table), 2 range (custom table)
  uint8_t transition[256];
  int colorspace = 0, bits = 8;
  bool chroma_planes = false, transparency = false;
  int hshift = 0, vshift = 0;
  int plane_count = 0;
  int num_h = 1, num_v = 1;
  int quant_table_count = 0;
  int16_t quant_tables[8][5][256];
  int context_counts[8] = {0};
  std::vector<uint8_t> initial[8];  // version 3's initial states, or empty
  int16_t quant_v01[5][256];
  int context_v01 = 0;
  bool ec = false;
  bool key_ok = false;
  int format = -1;
  std::vector<Slice> slices;
  int slice_count = 0;
  std::vector<int16_t> samples;
  Picture pic;
  std::string error;

  bool damage(const std::string& m) {
    error = m;
    return false;
  }

  // the pixel format from the global parameters; false (error set) when
  // the port does not take it
  int pick_format() {
    if (bits != 8 && bits != 0) {
      error = "FFV1 at " + std::to_string(bits) +
              " bits: the port decodes 8-bit FFV1, ROADMAP.md Queue 1 item 8b";
      return kUnsupported;
    }
    if (colorspace == 0) {
      if (!chroma_planes && !transparency) return format = kGray8, kOk;
      if (chroma_planes && !transparency) {
        switch (16 * hshift + vshift) {
          case 0x00: return format = kYuv444p, kOk;
          case 0x10: return format = kYuv422p, kOk;
          case 0x11: return format = kYuv420p, kOk;
        }
      }
      error = "FFV1 in a YUV form other than 4:2:0, 4:2:2, 4:4:4 and grey without alpha: "
              "ROADMAP.md Queue 1 item 8b";
      return kUnsupported;
    }
    if (colorspace == 1) {
      if (hshift || vshift) {
        error = "FFV1 RGB with chroma subsampling";
        return kInvalid;
      }
      format = transparency ? kBgra : kBgr0;
      return kOk;
    }
    error = "FFV1 colorspace " + std::to_string(colorspace);
    return kInvalid;
  }

  int read_extra(const uint8_t* p, size_t n) {
    RangeCoder c;
    uint8_t state[kContextSize];
    memset(state, 128, sizeof(state));
    c.init(p, n);
    c.default_states();
    bool bad = false;
    version = c.symbol(state, false, &bad);
    if (version < 2) return error = "invalid FFV1 version in the global header", kInvalid;
    if (version != 3) {
      error = "FFV1 version " + std::to_string(version) +
              ": the port decodes versions 0, 1 and 3, ROADMAP.md Queue 1 item 8b";
      return kUnsupported;
    }
    c.end -= 4;
    micro_version = c.symbol(state, false, &bad);
    ac = c.symbol(state, false, &bad);
    if (ac == 2)
      for (int i = 1; i < 256; i++) transition[i] = uint8_t(c.symbol(state, true, &bad) + c.one_state[i]);
    colorspace = c.symbol(state, false, &bad);
    bits = c.symbol(state, false, &bad);
    chroma_planes = c.bit(state);
    hshift = c.symbol(state, false, &bad);
    vshift = c.symbol(state, false, &bad);
    transparency = c.bit(state);
    plane_count = 2 + (transparency ? 1 : 0);
    num_h = 1 + c.symbol(state, false, &bad);
    num_v = 1 + c.symbol(state, false, &bad);
    if (bad || unsigned(hshift) > 4 || unsigned(vshift) > 4 || num_h > width || num_h <= 0 ||
        num_v > height || num_v <= 0 || num_h * num_v > kMaxSlices)
      return error = "damaged FFV1 global header", kInvalid;
    quant_table_count = c.symbol(state, false, &bad);
    if (quant_table_count <= 0 || quant_table_count > 8)
      return error = "damaged FFV1 global header", kInvalid;
    for (int i = 0; i < quant_table_count; i++) {
      context_counts[i] = read_quant_tables(c, quant_tables[i]);
      if (context_counts[i] < 0) return error = "damaged FFV1 quantisation tables", kInvalid;
    }
    uint8_t state2[kContextSize][kContextSize];
    memset(state2, 128, sizeof(state2));
    for (int i = 0; i < quant_table_count; i++) {
      initial[i].clear();
      if (c.bit(state)) {
        initial[i].assign(size_t(context_counts[i]) * kContextSize, 128);
        for (int j = 0; j < context_counts[i]; j++)
          for (int k = 0; k < kContextSize; k++) {
            const int pred = j ? initial[i][size_t(j - 1) * kContextSize + k] : 128;
            initial[i][size_t(j) * kContextSize + k] =
                uint8_t((pred + c.symbol(state2[k], true, &bad)) & 0xff);
          }
      }
    }
    ec = c.symbol(state, false, &bad) != 0;
    if (micro_version > 2) c.symbol(state, false, &bad);  // intra
    if (bad || n < 4 || crc32_ieee(p, n) != 0)
      return error = "FFV1 global header CRC mismatch", kInvalid;
    return pick_format();
  }

  // the v0/v1 header of a key frame, from the frame's coder
  int read_header(RangeCoder& c) {
    uint8_t state[kContextSize];
    memset(state, 128, sizeof(state));
    bool bad = false;
    if (version < 2) {
      const int v = c.symbol(state, false, &bad);
      if (v < 0 || v >= 2) return error = "invalid FFV1 version in a frame header", kInvalid;
      version = v;
      ac = c.symbol(state, false, &bad);
      if (ac == 2)
        for (int i = 1; i < 256; i++) {
          const int st = c.symbol(state, true, &bad) + c.one_state[i];
          if (st < 1 || st > 255) return error = "damaged FFV1 state transition table", kInvalid;
          transition[i] = uint8_t(st);
        }
      const int cs = c.symbol(state, false, &bad);
      const int b = version > 0 ? c.symbol(state, false, &bad) : 8;
      const bool cp = c.bit(state);
      const int hs = c.symbol(state, false, &bad), vs = c.symbol(state, false, &bad);
      const bool tr = c.bit(state);
      if (bad) return error = "damaged FFV1 frame header", kInvalid;
      if (plane_count && (cs != colorspace || b != bits || cp != chroma_planes || hs != hshift ||
                          vs != vshift || tr != transparency))
        return error = "FFV1 global parameters changed mid-stream", kInvalid;
      if (unsigned(hs) > 4 || unsigned(vs) > 4) return error = "damaged FFV1 frame header", kInvalid;
      colorspace = cs;
      bits = b;
      chroma_planes = cp;
      hshift = hs;
      vshift = vs;
      transparency = tr;
      plane_count = 2 + (transparency ? 1 : 0);
      const int r = pick_format();
      if (r != kOk) return r;
      context_v01 = read_quant_tables(c, quant_v01);
      if (context_v01 < 0) return error = "damaged FFV1 quantisation tables", kInvalid;
      slice_count = 1;
    }
    return kOk;
  }

  void clear_states(Slice& s) {
    for (int i = 0; i < plane_count; i++) {
      Plane& p = s.plane[i];
      if (ac) {
        // version 3's initial states where its extradata has them, else 128
        if (version > 2 && !initial[p.quant_index].empty()) p.state = initial[p.quant_index];
        else p.state.assign(size_t(p.context_count) * kContextSize, 128);
      } else {
        p.vlc.assign(size_t(p.context_count), VlcState());
      }
    }
  }

  bool decode_line(Slice& s, int w, int16_t* sample[2], int plane_index, int nbits) {
    Plane& p = s.plane[plane_index];
    if (ac ? s.c.overread > 2 : s.gb.left() < 1) return damage("FFV1 slice shorter than its samples");
    int run_count = 0, run_mode = 0, run_index = s.run_index;
    const bool large = p.quant[3][127] || p.quant[4][127];
    const int mask = (1 << nbits) - 1;
    for (int x = 0; x < w; x++) {
      if (!(x & 1023) && (ac ? s.c.overread > 2 : s.gb.left() < 1))
        return damage("FFV1 slice shorter than its samples");
      const int16_t* cur = sample[1] + x;
      const int16_t* top = sample[0] + x;
      const int LT = top[-1], T = top[0], RT = top[1], L = cur[-1];
      int context = p.quant[0][(L - LT) & 0xff] + p.quant[1][(LT - T) & 0xff] +
                    p.quant[2][(T - RT) & 0xff];
      if (large) context += p.quant[3][(cur[-2] - L) & 0xff] + p.quant[4][(cur[0] - T) & 0xff];
      bool sign = false;
      if (context < 0) {
        context = -context;
        sign = true;
      }
      if (context >= p.context_count) return damage("damaged FFV1 context tables");
      int diff;
      if (ac) {
        bool bad = false;
        diff = s.c.symbol(&p.state[size_t(context) * kContextSize], true, &bad);
        if (bad) return damage("damaged FFV1 range-coded samples");
      } else {
        if (context == 0 && run_mode == 0) run_mode = 1;
        if (run_mode) {
          if (run_count == 0 && run_mode == 1) {
            if (s.gb.get(1)) {
              run_count = 1 << kLog2Run[run_index];
              if (x + run_count <= w) run_index++;
            } else {
              run_count = kLog2Run[run_index] ? int(s.gb.get(kLog2Run[run_index])) : 0;
              if (run_index) run_index--;
              run_mode = 2;
            }
            if (run_index > 40) return damage("damaged FFV1 run");
          }
          run_count--;
          if (run_count < 0) {
            run_mode = 0;
            run_count = 0;
            diff = vlc_symbol(s.gb, &p.vlc[size_t(context)], nbits);
            if (diff >= 0) diff++;
          } else {
            diff = 0;
          }
        } else {
          diff = vlc_symbol(s.gb, &p.vlc[size_t(context)], nbits);
        }
      }
      if (sign) diff = int(-unsigned(diff));
      const int pred = mid_pred(L, L + T - LT, T);
      sample[1][x] = int16_t(unsigned(pred + diff) & unsigned(mask));
    }
    s.run_index = run_index;
    return true;
  }

  bool decode_plane(Slice& s, uint8_t* dst, int w, int h, int stride, int plane_index, int step) {
    samples.assign(size_t(2) * (w + 6), 0);
    int16_t* sample[2] = {samples.data() + 3, samples.data() + w + 6 + 3};
    s.run_index = 0;
    for (int y = 0; y < h; y++) {
      std::swap(sample[0], sample[1]);
      sample[1][-1] = sample[0][0];
      sample[0][w] = sample[0][w - 1];
      if (!decode_line(s, w, sample, plane_index, 8)) return false;
      for (int x = 0; x < w; x++) dst[size_t(x) * step + size_t(stride) * y] = uint8_t(sample[1][x]);
    }
    return true;
  }

  bool decode_rgb(Slice& s, uint8_t* dst, int w, int h, int stride) {
    const int np = 3 + (transparency ? 1 : 0);
    samples.assign(size_t(8) * (w + 6), 0);
    int16_t* sample[4][2];
    for (int k = 0; k < 4; k++) {
      sample[k][0] = samples.data() + size_t(2 * k) * (w + 6) + 3;
      sample[k][1] = samples.data() + size_t(2 * k + 1) * (w + 6) + 3;
    }
    s.run_index = 0;
    for (int y = 0; y < h; y++) {
      for (int k = 0; k < np; k++) {
        std::swap(sample[k][0], sample[k][1]);
        sample[k][1][-1] = sample[k][0][0];
        sample[k][0][w] = sample[k][0][w - 1];
        if (!decode_line(s, w, sample[k], (k + 1) / 2, 9)) return false;
      }
      uint8_t* row = dst + size_t(stride) * y;
      for (int x = 0; x < w; x++) {
        int g = sample[0][1][x], b = sample[1][1][x], r = sample[2][1][x];
        const int a = sample[3][1][x];
        b -= 256;
        r -= 256;
        g -= (b + r) >> 2;
        b += g;
        r += g;
        row[4 * x + 0] = uint8_t(b);
        row[4 * x + 1] = uint8_t(g);
        row[4 * x + 2] = uint8_t(r);
        row[4 * x + 3] = uint8_t(a);
      }
    }
    return true;
  }

  bool slice_header(Slice& s) {
    uint8_t state[kContextSize];
    memset(state, 128, sizeof(state));
    bool bad = false;
    const int sx = s.c.symbol(state, false, &bad), sy = s.c.symbol(state, false, &bad);
    const unsigned sw = unsigned(s.c.symbol(state, false, &bad)) + 1u;
    const unsigned sh = unsigned(s.c.symbol(state, false, &bad)) + 1u;
    if (bad || sx < 0 || sy < 0) return damage("damaged FFV1 slice header");
    s.x = int(int64_t(sx) * width / num_h);
    s.y = int(int64_t(sy) * height / num_v);
    s.w = int((int64_t(sx) + sw) * width / num_h - s.x);
    s.h = int((int64_t(sy) + sh) * height / num_v - s.y);
    if (s.x < 0 || s.y < 0 || s.w <= 0 || s.h <= 0 || s.x > width - s.w || s.y > height - s.h)
      return damage("damaged FFV1 slice header");
    for (int i = 0; i < plane_count; i++) {
      const int idx = s.c.symbol(state, false, &bad);
      if (bad || idx < 0 || idx >= quant_table_count) return damage("damaged FFV1 slice header");
      Plane& p = s.plane[i];
      p.quant_index = idx;
      memcpy(p.quant, quant_tables[idx], sizeof(p.quant));
      p.context_count = context_counts[idx];
    }
    s.c.symbol(state, false, &bad);  // picture structure
    s.c.symbol(state, false, &bad);  // sample aspect ratio
    s.c.symbol(state, false, &bad);
    return !bad || damage("damaged FFV1 slice header");
  }

  bool decode_slice(Slice& s, bool key) {
    if (version > 2) {
      if (ac == 2) s.c.custom_states(transition);
      if (!slice_header(s)) return false;
    } else {
      s.x = s.y = 0;
      s.w = width;
      s.h = height;
      for (int i = 0; i < plane_count; i++) {
        Plane& p = s.plane[i];
        memcpy(p.quant, quant_v01, sizeof(p.quant));
        p.context_count = context_v01;
      }
    }
    if (ac == 2) s.c.custom_states(transition);
    if (key || !s.have_states) clear_states(s);
    s.have_states = true;
    if (!ac) {
      if (version == 3 && micro_version > 1) {
        uint8_t st = 129;
        s.c.bit(&st);
      }
      const size_t used = size_t(s.c.pos - s.c.start) - 1;
      s.gb.p = s.c.start + used;
      s.gb.n = size_t(s.c.end - s.c.start) - used;
      s.gb.pos = 0;
    }
    Picture& p = pic;
    bool ok;
    if (colorspace == 0) {
      ok = decode_plane(s, p.y.data() + s.x + size_t(s.y) * p.stride_y, s.w, s.h, p.stride_y, 0, 1);
      if (ok && chroma_planes) {
        const int cw = (s.w + (1 << hshift) - 1) >> hshift, ch = (s.h + (1 << vshift) - 1) >> vshift;
        const int cx = s.x >> hshift, cy = s.y >> vshift;
        ok = decode_plane(s, p.u.data() + cx + size_t(cy) * p.stride_c, cw, ch, p.stride_c, 1, 1) &&
             decode_plane(s, p.v.data() + cx + size_t(cy) * p.stride_c, cw, ch, p.stride_c, 1, 1);
      }
    } else {
      ok = decode_rgb(s, p.y.data() + size_t(s.x) * 4 + size_t(s.y) * p.stride_y, s.w, s.h,
                      p.stride_y);
    }
    if (!ok) return false;
    if (ac && version > 2) {
      uint8_t st = 129;
      s.c.bit(&st);
      const long v = long(s.c.end - s.c.pos) - 2 - (ec ? 5 : 0);
      if (v) return damage("FFV1 slice does not end where its size says");
    }
    return true;
  }
};

Ffv1Decoder::Ffv1Decoder() : impl_(new Impl) {}
Ffv1Decoder::~Ffv1Decoder() { delete impl_; }
const Picture& Ffv1Decoder::picture() const { return impl_->pic; }
int Ffv1Decoder::format() const { return impl_->format; }
void Ffv1Decoder::flush() { impl_->key_ok = false; }

bool Ffv1Decoder::is_key(const uint8_t* p, size_t n) {
  RangeCoder c;
  c.init(p, n);
  c.default_states();
  uint8_t keystate = 128;
  return n >= 2 && c.bit(&keystate);
}

int Ffv1Decoder::configure(const uint8_t* extra, size_t n, int width, int height,
                           std::string* msg) {
  Impl& d = *impl_;
  d.width = width;
  d.height = height;
  if (width <= 0 || height <= 0) {
    *msg = "no frame size in the stream headers";
    return kInvalid;
  }
  if (n) {
    const int r = d.read_extra(extra, n);
    if (r != kOk) {
      *msg = d.error;
      return r;
    }
    d.slices.resize(size_t(d.num_h) * d.num_v);
  } else {
    d.slices.resize(1);
  }
  return kOk;
}

int Ffv1Decoder::decode(const uint8_t* buf, size_t n, std::string* msg) {
  Impl& d = *impl_;
  if (n < 2) {
    *msg = "FFV1 frame shorter than its header";
    return kInvalid;
  }
  Slice& s0 = d.slices[0];
  RangeCoder& c = s0.c;
  c.init(buf, n);
  c.default_states();
  uint8_t keystate = 128;
  const bool key = c.bit(&keystate);
  if (key) {
    d.key_ok = false;
    const int r = d.read_header(c);
    if (r != kOk) {
      *msg = d.error;
      return r;
    }
    d.key_ok = true;
  } else if (!d.key_ok) {
    *msg = "FFV1 frame that is not a key frame without its key frame";
    return kInvalid;
  }
  if (d.format < 0) {
    *msg = "FFV1 stream without a header";
    return kInvalid;
  }
  if (d.version > 2) {
    // the slices from the end of the frame, by the sizes in their trailers
    const int trailer = 3 + (d.ec ? 5 : 0);
    const uint8_t* p = buf + n;
    int count = 0;
    while (count < int(d.slices.size()) && trailer < p - buf) {
      const int size = (p[-trailer] << 16) | (p[-trailer + 1] << 8) | p[-trailer + 2];
      if (size + trailer > p - buf) break;
      p -= size + trailer;
      count++;
    }
    d.slice_count = count;
  }
  if (d.slice_count <= 0 || d.slice_count > int(d.slices.size())) {
    *msg = "damaged FFV1 frame (slice count)";
    return kInvalid;
  }
  if (d.pic.width != d.width || d.pic.height != d.height || d.pic.format != d.format)
    d.pic.allocate(d.format, d.width, d.height);
  const uint8_t* bp = buf + n;
  for (int i = d.slice_count - 1; i >= 0; i--) {
    Slice& s = d.slices[size_t(i)];
    const int trailer = 3 + (d.ec ? 5 : 0);
    long v;
    if (i || d.version > 2) {
      v = trailer > bp - buf ? -1
                             : long((bp[-trailer] << 16) | (bp[-trailer + 1] << 8) | bp[-trailer + 2]) +
                                   trailer;
    } else {
      v = long(bp - c.start);
    }
    if (v < 0 || bp - c.start < v) {
      *msg = "damaged FFV1 frame (slice pointer chain broken)";
      return kInvalid;
    }
    bp -= v;
    if (d.ec && crc32_ieee(bp, size_t(v)) != 0) {
      *msg = "damaged FFV1 stream (slice " + std::to_string(i) + " CRC mismatch)";
      return kInvalid;
    }
    if (i) {
      s.c.init(bp, size_t(v));
      s.c.default_states();
    } else {
      c.end = bp + v;
    }
  }
  for (int i = 0; i < d.slice_count; i++) {
    if (!d.decode_slice(d.slices[size_t(i)], key)) {
      *msg = "damaged FFV1 stream (" + d.error + ")";
      return kInvalid;
    }
  }
  return 1;
}

}  // namespace video
