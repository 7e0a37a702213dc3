// MPEG-1, MPEG-2 (LSF) and MPEG-2.5 Layer III decoder written from ISO/IEC
// 11172-3 and 13818-3, for the host audio decode of dali_tpu_torch. It links
// no library; its constant tables (Huffman codes, the synthesis window) are
// the standard's, in audio_tables.h.
//
// Around the frames it does what FFmpeg 5.1's mp3 demuxer and mp3float
// decoder do, the reference's route:
// - a leading ID3v2 tag is skipped; a first frame holding a Xing/Info (or
//   VBRI) tag yields no audio, and with a LAME tag the output is trimmed to
//   the encoder's delay and padding (start: delay + 529 samples; end: the
//   padding less 529, counted from the tag's frame count, which is not used
//   where the tag's stream size is far below the file's); a stream without
//   one comes back whole;
// - the first frame is the first header whose successor matches it (an
//   Info frame that fails to read as one is skipped so where its header
//   bits differ from the audio's, as FFmpeg's muxer writes them);
// - the packets are FFmpeg's parser's: a frame, or the bytes up to and
//   including the next frame. A packet that does not start with a header
//   fails the stream unless it starts with "TAG" (then swallowed whole);
//   what follows the last frame is dropped if it starts with an ID3v1 or an
//   APEv2 tag, and fails the stream otherwise;
// - the bit reservoir keeps the bytes after the last granule read, at most
//   512; a granule whose main data starts before the bytes at hand decodes
//   as silence; a frame cut short decodes from the bytes there are (reads
//   past them give zeros, the read position stops 8 bits past them, and
//   Huffman reads stop at their end);
// - a frame whose side information FFmpeg rejects (big_values > 288, block
//   type 0 with window switching) fails the whole stream, as the
//   reference's decode loop does; the CRC of a protected frame is read and
//   not checked, as FFmpeg's default does.
// Layers I and II and free-format streams are not decoded (kUnsupported).
//
// Output: float32, interleaved, full scale +-1, unclipped.

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstring>
#include <new>

#include "audio_codecs.h"
#include "audio_tables.h"

namespace audio_codecs {
namespace {

constexpr int kBackstep = 512;
constexpr double kPi = 3.14159265358979323846;

// ------------------------------------------------------------------ tables
const int kBitrateKbps[2][15] = {
    {0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320},
    {0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160}};
const int kSampleRate[9] = {44100, 48000, 32000, 22050, 24000, 16000, 11025, 12000, 8000};

// scale-factor band widths by sample-rate index
const uint8_t kBandLong[9][22] = {
    {4, 4, 4, 4, 4, 4, 6, 6, 8, 8, 10, 12, 16, 20, 24, 28, 34, 42, 50, 54, 76, 158},
    {4, 4, 4, 4, 4, 4, 6, 6, 6, 8, 10, 12, 16, 18, 22, 28, 34, 40, 46, 54, 54, 192},
    {4, 4, 4, 4, 4, 4, 6, 6, 8, 10, 12, 16, 20, 24, 30, 38, 46, 56, 68, 84, 102, 26},
    {6, 6, 6, 6, 6, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32, 38, 46, 52, 60, 68, 58, 54},
    {6, 6, 6, 6, 6, 6, 8, 10, 12, 14, 16, 18, 22, 26, 32, 38, 46, 52, 64, 70, 76, 36},
    {6, 6, 6, 6, 6, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32, 38, 46, 52, 60, 68, 58, 54},
    {6, 6, 6, 6, 6, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32, 38, 46, 52, 60, 68, 58, 54},
    {6, 6, 6, 6, 6, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32, 38, 46, 52, 60, 68, 58, 54},
    {12, 12, 12, 12, 12, 12, 16, 20, 24, 28, 32, 40, 48, 56, 64, 76, 90, 2, 2, 2, 2, 2}};
const uint8_t kBandShort[9][13] = {
    {4, 4, 4, 4, 6, 8, 10, 12, 14, 18, 22, 30, 56},
    {4, 4, 4, 4, 6, 6, 10, 12, 14, 16, 20, 26, 66},
    {4, 4, 4, 4, 6, 8, 12, 16, 20, 26, 34, 42, 12},
    {4, 4, 4, 6, 6, 8, 10, 14, 18, 26, 32, 42, 18},
    {4, 4, 4, 6, 8, 10, 12, 14, 18, 24, 32, 44, 12},
    {4, 4, 4, 6, 8, 10, 12, 14, 18, 24, 30, 40, 18},
    {4, 4, 4, 6, 8, 10, 12, 14, 18, 24, 30, 40, 18},
    {4, 4, 4, 6, 8, 10, 12, 14, 18, 24, 30, 40, 18},
    {8, 8, 8, 12, 16, 20, 24, 28, 36, 2, 2, 2, 26}};
const uint8_t kPretab[22] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 3, 2, 0};
// MPEG-1 scalefac_compress -> (slen1, slen2)
const uint8_t kSlen[2][16] = {{0, 0, 0, 0, 3, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4},
                              {0, 1, 2, 3, 0, 1, 2, 3, 1, 2, 3, 1, 2, 3, 2, 3}};
// MPEG-2 scale-factor partitions: [table][block kind: long, short, mixed][partition]
const uint8_t kLsfPartitions[6][3][4] = {
    {{6, 5, 5, 5}, {9, 9, 9, 9}, {6, 9, 9, 9}},
    {{6, 5, 7, 3}, {9, 9, 12, 6}, {6, 9, 12, 6}},
    {{11, 10, 0, 0}, {18, 18, 0, 0}, {15, 18, 0, 0}},
    {{7, 7, 7, 0}, {12, 12, 12, 0}, {6, 15, 12, 0}},
    {{6, 6, 6, 3}, {12, 9, 9, 6}, {6, 12, 9, 6}},
    {{8, 8, 5, 0}, {15, 12, 9, 0}, {6, 18, 9, 0}}};
// Huffman table linbits, and the code table each big-value table uses
const uint8_t kLinbits[32] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                              1, 2, 3, 4, 6, 8, 10, 13, 4, 5, 6, 7, 8, 9, 11, 13};

struct Vlc {
  // root table of kRoot bits, then sub-tables. An entry is (len << 16 | sym),
  // or (1 << 31 | sub_bits << 24 | offset) for a sub-table
  static constexpr int kRoot = 10;
  std::vector<uint32_t> t;

  void build(const uint16_t* codes, const uint8_t* lens, int n) {
    t.assign(1u << kRoot, 1u << 16);
    int sub_bits[1 << kRoot] = {0};
    for (int s = 0; s < n; s++) {
      const int len = lens[s];
      if (len <= kRoot) {
        const uint32_t first = uint32_t(codes[s]) << (kRoot - len);
        for (uint32_t k = 0; k < (1u << (kRoot - len)); k++) t[first + k] = (len << 16) | s;
      } else {
        const int prefix = codes[s] >> (len - kRoot);
        sub_bits[prefix] = std::max(sub_bits[prefix], len - kRoot);
      }
    }
    for (int p = 0; p < (1 << kRoot); p++) {
      if (!sub_bits[p]) continue;
      const uint32_t off = static_cast<uint32_t>(t.size());
      t.resize(t.size() + (1u << sub_bits[p]), 1u << 16);
      t[p] = 0x80000000u | (sub_bits[p] << 24) | off;
    }
    for (int s = 0; s < n; s++) {
      const int len = lens[s];
      if (len <= kRoot) continue;
      const uint32_t e = t[codes[s] >> (len - kRoot)];
      const int sb = (e >> 24) & 0x7F;
      const int rest = len - kRoot;
      const uint32_t first = (codes[s] & ((1u << rest) - 1)) << (sb - rest);
      for (uint32_t k = 0; k < (1u << (sb - rest)); k++)
        t[(e & 0xFFFFFF) + first + k] = (rest << 16) | s;
    }
  }
};

struct Tables {
  Vlc big[16];  // code tables 1-3, 5-13 and 15 at their numbers; 16 at 14, 24 at 4
  Vlc quad[2];
  float pow43[8207];
  float exp2q[512];         // 2^((e - 400) / 4)
  // cos(pi / 72 (2i + 1 + 18)(2k + 1)) for i = 0..8 and 18..26 (the other
  // outputs mirror these: y[17 - i] = -y[i], y[35 - i] = y[18 + i])
  float imdct36[18][18];
  // cos(pi / 24 (2i + 1 + 6)(2k + 1)) for i = 0..2 and 6..8 (z[5 - i] =
  // -z[i], z[11 - i] = z[6 + i])
  float imdct12[6][6];
  float win[4][36];         // block types 0, 1, 3 (long) and 2 (short, 12 used)
  float dct32[32][32];     // cos(j (2k + 1) pi / 64), [k][j]
  float d[512];             // the synthesis window
  float cs[8], ca[8];
  float is1[2][7];          // MPEG-1 intensity stereo: left, right
  float is2[2][2][16];      // MPEG-2: [intensity_scale][left, right][is_pos]

  Tables() {
    using namespace audio_tables;
    const uint16_t* codes[16] = {nullptr, kHuffCodes1, kHuffCodes2, kHuffCodes3, kHuffCodes24,
                                 kHuffCodes5, kHuffCodes6, kHuffCodes7, kHuffCodes8, kHuffCodes9,
                                 kHuffCodes10, kHuffCodes11, kHuffCodes12, kHuffCodes13,
                                 kHuffCodes16, kHuffCodes15};
    const uint8_t* lens[16] = {nullptr, kHuffLens1, kHuffLens2, kHuffLens3, kHuffLens24,
                               kHuffLens5, kHuffLens6, kHuffLens7, kHuffLens8, kHuffLens9,
                               kHuffLens10, kHuffLens11, kHuffLens12, kHuffLens13, kHuffLens16,
                               kHuffLens15};
    const int sizes[16] = {0, 2, 3, 3, 16, 4, 4, 6, 6, 6, 8, 8, 8, 16, 16, 16};
    for (int i = 1; i < 16; i++) big[i].build(codes[i], lens[i], sizes[i] * sizes[i]);
    quad[0].build(kHuffCodes32, kHuffLens32, 16);
    quad[1].build(kHuffCodes33, kHuffLens33, 16);
    for (int i = 0; i < 8207; i++) pow43[i] = static_cast<float>(std::pow(double(i), 4.0 / 3.0));
    for (int e = 0; e < 512; e++) exp2q[e] = static_cast<float>(std::exp2((e - 400) / 4.0));
    for (int j = 0; j < 18; j++) {
      const int i = j < 9 ? j : j + 9;
      for (int k = 0; k < 18; k++)
        imdct36[k][j] = static_cast<float>(std::cos(kPi / 72 * (2 * i + 1 + 18) * (2 * k + 1)));
    }
    for (int j = 0; j < 6; j++) {
      const int i = j < 3 ? j : j + 3;
      for (int k = 0; k < 6; k++)
        imdct12[k][j] = static_cast<float>(std::cos(kPi / 24 * (2 * i + 1 + 6) * (2 * k + 1)));
    }
    for (int i = 0; i < 36; i++) {
      const double l = std::sin(kPi / 36 * (i + 0.5));
      win[0][i] = static_cast<float>(l);
      win[1][i] = static_cast<float>(i < 18 ? l : i < 24 ? 1.0 : i < 30
                                     ? std::sin(kPi / 12 * (i - 18 + 0.5)) : 0.0);
      win[2][i] = static_cast<float>(i < 6 ? 0.0 : i < 12 ? std::sin(kPi / 12 * (i - 6 + 0.5))
                                     : i < 18 ? 1.0 : l);
      win[3][i] = static_cast<float>(i < 12 ? std::sin(kPi / 12 * (i + 0.5)) : 0.0);
    }
    for (int k = 0; k < 32; k++)
      for (int j = 0; j < 32; j++)
        dct32[k][j] = static_cast<float>(std::cos(j * (2 * k + 1) * kPi / 64));
    for (int i = 0; i <= 256; i++) {
      const double v = kSynthWindow[i] / 65536.0;
      d[i] = static_cast<float>(v);
      if (i) d[512 - i] = static_cast<float>((i & 63) ? -v : v);
    }
    const double ci[8] = {-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037};
    for (int i = 0; i < 8; i++) {
      const double sq = std::sqrt(1.0 + ci[i] * ci[i]);
      cs[i] = static_cast<float>(1.0 / sq);
      ca[i] = static_cast<float>(ci[i] / sq);
    }
    for (int i = 0; i < 7; i++) {
      const double k = i == 6 ? 0.0 : std::tan(i * kPi / 12);
      is1[0][i] = static_cast<float>(i == 6 ? 1.0 : k / (1 + k));
      is1[1][i] = static_cast<float>(i == 6 ? 0.0 : 1 / (1 + k));
    }
    for (int scale = 0; scale < 2; scale++)
      for (int p = 0; p < 16; p++) {
        const double f = std::exp2(-(scale + 1) * ((p + 1) >> 1) / 4.0);
        is2[scale][0][p] = static_cast<float>(p & 1 ? f : 1.0);
        is2[scale][1][p] = static_cast<float>(p & 1 ? 1.0 : f);
      }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// ------------------------------------------------------------------ bits
// MSB-first reader; bits past the end read as zeros, as FFmpeg's padded
// packets give them, and the position stops 8 bits past the end, as FFmpeg's
// checked reader's does.
struct Bits {
  const uint8_t* d = nullptr;
  size_t n = 0;    // bytes
  int64_t pos = 0;  // bit position
  int64_t limit = INT64_MAX;

  uint32_t peek32() const {
    if (pos < 0) return 0;
    const size_t byte = static_cast<size_t>(pos >> 3);
    uint64_t v = 0;
    if (byte + 8 <= n) {
      std::memcpy(&v, d + byte, 8);
      v = __builtin_bswap64(v);
    } else {
      for (size_t i = 0; i < 8; i++) v = (v << 8) | (byte + i < n ? d[byte + i] : 0);
    }
    return static_cast<uint32_t>((v << (pos & 7)) >> 32);
  }
  uint32_t get(int k) {  // k in 0..24
    if (k == 0) return 0;
    const uint32_t v = peek32() >> (32 - k);
    pos = std::min(pos + k, limit);
    return v;
  }
  int vlc(const Vlc& v) {
    const uint32_t w = peek32();
    uint32_t e = v.t[w >> (32 - Vlc::kRoot)];
    if (e & 0x80000000u) {
      const int sb = (e >> 24) & 0x7F;
      e = v.t[(e & 0xFFFFFF) + ((w << Vlc::kRoot) >> (32 - sb))];
      pos = std::min<int64_t>(pos + Vlc::kRoot, limit);
    }
    pos = std::min<int64_t>(pos + (e >> 16), limit);
    return static_cast<int>(e & 0xFFFF);
  }
};

// ------------------------------------------------------------------ frames
struct Header {
  bool lsf = false, mpeg25 = false, crc = false;
  int layer = 0, bitrate_index = 0, sr_index = 0, padding = 0, mode = 0, mode_ext = 0;
  int channels = 0, frame_size = 0, spf = 0;
};

// 0 valid, -1 not a header, 1 free format or not Layer III (decoded
// headers all the same, so a stream of them can be walked)
int parse_header(uint32_t h, Header& o) {
  if ((h & 0xFFE00000u) != 0xFFE00000u) return -1;
  if ((h & (3u << 19)) == (1u << 19)) return -1;  // reserved version
  if ((h & (3u << 17)) == 0) return -1;           // reserved layer
  if ((h & (0xFu << 12)) == (0xFu << 12)) return -1;
  if ((h & (3u << 10)) == (3u << 10)) return -1;
  if (h & (1u << 20)) {
    o.lsf = !(h & (1u << 19));
    o.mpeg25 = false;
  } else {
    o.lsf = true;
    o.mpeg25 = true;
  }
  o.sr_index = ((h >> 10) & 3) + 3 * (int(o.lsf) + int(o.mpeg25));
  o.layer = 4 - ((h >> 17) & 3);
  o.crc = !((h >> 16) & 1);
  o.bitrate_index = (h >> 12) & 0xF;
  o.padding = (h >> 9) & 1;
  o.mode = (h >> 6) & 3;
  o.mode_ext = (h >> 4) & 3;
  o.channels = o.mode == 3 ? 1 : 2;
  o.spf = o.layer == 3 && o.lsf ? 576 : o.layer == 1 ? 384 : 1152;
  if (o.bitrate_index == 0 || o.layer != 3) {
    // other layers' sizes, so that a stream of them can still be recognised
    if (o.bitrate_index == 0) return 1;
    static const int kL12[2][2][15] = {
        {{0, 32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352, 384, 416, 448},
         {0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 384}},
        {{0, 32, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176, 192, 224, 256},
         {0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160}}};
    const int kbps = kL12[o.lsf][o.layer - 1][o.bitrate_index];
    const int rate = kSampleRate[o.sr_index];
    o.frame_size = o.layer == 1 ? (kbps * 12000 / rate + o.padding) * 4
                                : kbps * 144000 / rate + o.padding;
    return 1;
  }
  const int rate = kSampleRate[o.sr_index];
  o.frame_size = kBitrateKbps[o.lsf][o.bitrate_index] * 144000 / (rate << int(o.lsf)) + o.padding;
  return 0;
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

struct Granule {
  int part2_3_length, big_values, global_gain, scalefac_compress;
  int block_type, switch_point, table_select[3], subblock_gain[3];
  int region_size[3], preflag, scalefac_scale, count1table_select;
  int long_end, short_start, scfsi;
  uint8_t scale_factors[40];
};

struct FrameError {};

class Decoder {
 public:
  explicit Decoder(int channels) : nch_(channels) {
    std::memset(overlap_, 0, sizeof(overlap_));
    std::memset(synth_v_, 0, sizeof(synth_v_));
    for (auto& g : gr_)
      for (auto& c : g) std::memset(&c, 0, sizeof(c));
  }

  // Decodes one frame of ``size`` bytes (``avail`` of them present) into
  // ``out`` (spf * channels interleaved). Throws FrameError where FFmpeg's
  // decoder fails the frame.
  void frame(const uint8_t* buf, size_t size, size_t avail, const Header& h, float* out) {
    h_ = h;
    const size_t buf_size = std::min(size, avail);
    Bits gb{buf + 4, buf_size > 4 ? buf_size - 4 : 0, 0};
    if (h.crc) gb.get(16);
    const int ngr = h.lsf ? 1 : 2;
    int main_data_begin;
    try {
      main_data_begin = side_info(gb, ngr);
    } catch (const FrameError&) {
      keep_tail(buf, buf_size);
      throw;
    }
    // main data: the reservoir, then this frame's bytes after the side info
    const int64_t main_start = gb.pos >> 3;
    const size_t main_len =
        gb.n > static_cast<size_t>(main_start) ? gb.n - static_cast<size_t>(main_start) : 0;
    const size_t res_len = reservoir_.size();
    std::vector<uint8_t> md(res_len + main_len + 8, 0);
    std::memcpy(md.data(), reservoir_.data(), res_len);
    if (main_len) std::memcpy(md.data() + res_len, gb.d + main_start, main_len);
    Bits mb{md.data(), res_len + main_len, 0, int64_t(res_len + main_len) * 8 + 8};
    int64_t pos = int64_t(res_len) * 8 - int64_t(main_data_begin) * 8;
    // Huffman data is read up to the end of the bytes at hand: the reservoir
    // until a granule's codes cross into this frame, then this frame's
    // (FFmpeg's two readers; it matters only in a frame cut short)
    res_bits_ = int64_t(res_len) * 8;
    total_bits_ = int64_t(res_len + main_len) * 8;
    switched_ = false;
    int gr = 0;
    for (; gr < ngr && pos < 0; gr++) {  // main data not at hand: silence
      for (int ch = 0; ch < nch_; ch++) {
        pos += gr_[ch][gr].part2_3_length;
        std::memset(xr_[ch], 0, sizeof(xr_[ch]));
        Granule silent = gr_[ch][gr];
        silent.block_type = 0;
        hybrid(silent, ch, gr);
      }
    }
    for (; gr < ngr; gr++) {
      for (int ch = 0; ch < nch_; ch++) {
        Granule& g = gr_[ch][gr];
        mb.pos = pos;
        if (h.lsf) scale_factors_lsf(mb, g, ch);
        else scale_factors_mpeg1(mb, g, ch, gr);
        huffman(mb, g, pos + g.part2_3_length, ch);
        pos += g.part2_3_length;
      }
      if (h.mode == 1 && nch_ == 2) stereo(gr_[1][gr]);
      for (int ch = 0; ch < nch_; ch++) {
        reorder(gr_[ch][gr], ch);
        antialias(gr_[ch][gr], ch);
        hybrid(gr_[ch][gr], ch, gr);
      }
    }
    // keep the bytes after the last granule, at most kBackstep
    const int64_t end = std::max<int64_t>((pos + 7) >> 3, 0);
    const int64_t total = int64_t(res_len + main_len);
    if (end > total) {
      keep_tail(buf, buf_size);
    } else {
      const size_t left = static_cast<size_t>(total - end);
      const size_t keep = std::min<size_t>(left, kBackstep);
      reservoir_.assign(md.begin() + (total - keep), md.begin() + total);
    }
    synthesis(ngr, out);
  }

 private:
  void keep_tail(const uint8_t* buf, size_t buf_size) {
    const size_t keep = std::min<size_t>(kBackstep, buf_size > 4 ? buf_size - 4 : 0);
    reservoir_.assign(buf + buf_size - keep, buf + buf_size);
  }

  int side_info(Bits& gb, int ngr) {
    int main_data_begin;
    int scfsi[2] = {0, 0};
    if (!h_.lsf) {
      main_data_begin = gb.get(9);
      gb.get(nch_ == 1 ? 5 : 3);
      for (int ch = 0; ch < nch_; ch++) scfsi[ch] = gb.get(4);
    } else {
      main_data_begin = gb.get(8);
      gb.get(nch_ == 1 ? 1 : 2);
    }
    for (int gr = 0; gr < ngr; gr++) {
      for (int ch = 0; ch < nch_; ch++) {
        Granule& g = gr_[ch][gr];
        g.scfsi = gr == 0 ? 0 : scfsi[ch];
        g.part2_3_length = gb.get(12);
        g.big_values = gb.get(9);
        if (g.big_values > 288) throw FrameError();
        g.global_gain = gb.get(8);
        // the 1/sqrt(2) of MS stereo alone, as a gain step of -2
        if ((h_.mode_ext & 3) == 2) g.global_gain -= 2;
        g.scalefac_compress = gb.get(h_.lsf ? 9 : 4);
        const int blocksplit = gb.get(1);
        if (blocksplit) {
          g.block_type = gb.get(2);
          if (g.block_type == 0) throw FrameError();
          g.switch_point = gb.get(1);
          for (int i = 0; i < 2; i++) g.table_select[i] = gb.get(5);
          for (int i = 0; i < 3; i++) g.subblock_gain[i] = gb.get(3);
          // region 0 ends after 3 short bands (line 36, at 8 kHz 72) for
          // short blocks, else after 8 long ones
          g.region_size[0] = h_.sr_index == 8 ? (g.block_type == 2 ? 36 : 54)
                             : g.block_type == 2 || h_.sr_index <= 2 ? 18 : 27;
          g.region_size[1] = 288;
        } else {
          g.block_type = 0;
          g.switch_point = 0;
          for (int i = 0; i < 3; i++) g.table_select[i] = gb.get(5);
          const int r0 = gb.get(4), r1 = gb.get(3);
          int b0 = 0, b1 = 0;
          const uint8_t* bl = kBandLong[h_.sr_index];
          for (int i = 0; i <= r0 && i < 22; i++) b0 += bl[i];
          const int l = std::min(r0 + r1 + 2, 22);
          for (int i = 0; i < l; i++) b1 += bl[i];
          g.region_size[0] = b0 / 2;
          g.region_size[1] = b1 / 2;
          for (int i = 0; i < 3; i++) g.subblock_gain[i] = 0;
        }
        // region ends -> sizes, in pairs, within big_values
        g.region_size[2] = 288;
        int j = 0;
        for (int i = 0; i < 3; i++) {
          const int k = std::min(g.region_size[i], g.big_values);
          g.region_size[i] = k - j;
          j = k;
        }
        if (g.block_type == 2) {
          if (g.switch_point) {
            g.long_end = h_.sr_index <= 2 ? 8 : 6;
            g.short_start = 3;
          } else {
            g.long_end = 0;
            g.short_start = 0;
          }
        } else {
          g.short_start = 13;
          g.long_end = 22;
        }
        g.preflag = 0;
        if (!h_.lsf) g.preflag = gb.get(1);
        g.scalefac_scale = gb.get(1);
        g.count1table_select = gb.get(1);
      }
    }
    return main_data_begin;
  }

  void scale_factors_mpeg1(Bits& b, Granule& g, int ch, int gr) {
    const int slen1 = kSlen[0][g.scalefac_compress], slen2 = kSlen[1][g.scalefac_compress];
    int j = 0;
    if (g.block_type == 2) {
      const int n = g.switch_point ? 17 : 18;
      for (int i = 0; i < n; i++) g.scale_factors[j++] = b.get(slen1);
      for (int i = 0; i < 18; i++) g.scale_factors[j++] = b.get(slen2);
      for (int i = 0; i < 3; i++) g.scale_factors[j++] = 0;
    } else {
      const uint8_t* prev = gr_[ch][0].scale_factors;
      for (int k = 0; k < 4; k++) {
        const int n = k == 0 ? 6 : 5;
        if (gr == 1 && (g.scfsi & (8 >> k))) {
          for (int i = 0; i < n; i++, j++) g.scale_factors[j] = prev[j];
        } else {
          const int slen = k < 2 ? slen1 : slen2;
          for (int i = 0; i < n; i++) g.scale_factors[j++] = b.get(slen);
        }
      }
      g.scale_factors[j++] = 0;
    }
  }

  void scale_factors_lsf(Bits& b, Granule& g, int ch) {
    const int kind = g.block_type == 2 ? (g.switch_point ? 2 : 1) : 0;
    int sf = g.scalefac_compress;
    int slen[4];
    int table;
    auto expand = [&slen](int v, int n1, int n2, int n3) {
      if (n3) { slen[3] = v % n3; v /= n3; } else slen[3] = 0;
      if (n2) { slen[2] = v % n2; v /= n2; } else slen[2] = 0;
      slen[1] = v % n1;
      slen[0] = v / n1;
    };
    if ((h_.mode_ext & 1) && ch == 1) {
      sf >>= 1;
      if (sf < 180) { expand(sf, 6, 6, 0); table = 3; }
      else if (sf < 244) { expand(sf - 180, 4, 4, 0); table = 4; }
      else { expand(sf - 244, 3, 0, 0); table = 5; }
    } else {
      if (sf < 400) { expand(sf, 5, 4, 4); table = 0; }
      else if (sf < 500) { expand(sf - 400, 5, 4, 0); table = 1; }
      else { expand(sf - 500, 3, 0, 0); table = 2; g.preflag = 1; }
    }
    int j = 0;
    for (int k = 0; k < 4; k++) {
      const int n = kLsfPartitions[table][kind][k];
      for (int i = 0; i < n; i++) g.scale_factors[j++] = b.get(slen[k]);
    }
    for (; j < 40; j++) g.scale_factors[j] = 0;
  }

  // Huffman decode and requantisation of one granule into xr_[ch]
  void huffman(Bits& b, const Granule& g, int64_t end_pos, int ch) {
    const Tables& T = tables();
    int64_t end = std::min(end_pos, switched_ ? total_bits_ : res_bits_);
    auto at_end = [&]() {
      if (b.pos < end) return false;
      if (!switched_ && b.pos >= res_bits_) {
        switched_ = true;
        end = end_pos;
      }
      return b.pos >= end;
    };
    // the exponent of each line, 400 + 4 log2(gain)
    int16_t expo[576];
    {
      const int gain = g.global_gain - 210;
      const int shift = g.scalefac_scale + 1;
      int16_t* e = expo;
      const uint8_t* bl = kBandLong[h_.sr_index];
      for (int i = 0; i < g.long_end; i++) {
        const int v = gain - ((g.scale_factors[i] + (g.preflag ? kPretab[i] : 0)) << shift) + 400;
        for (int k = 0; k < bl[i]; k++) *e++ = static_cast<int16_t>(v);
      }
      if (g.short_start < 13) {
        const uint8_t* bs = kBandShort[h_.sr_index];
        int k = g.long_end;
        for (int i = g.short_start; i < 13; i++)
          for (int w = 0; w < 3; w++) {
            const int v = gain - (g.subblock_gain[w] << 3) - (g.scale_factors[k++] << shift) + 400;
            for (int q = 0; q < bs[i]; q++) *e++ = static_cast<int16_t>(v);
          }
      }
    }
    auto value = [&](int mag, int idx) {
      int e = expo[idx];
      e = e < 0 ? 0 : e > 511 ? 511 : e;
      return T.pow43[mag] * T.exp2q[e];
    };
    float* xr = xr_[ch];
    int s = 0;
    for (int r = 0; r < 3; r++) {
      int j = g.region_size[r];
      if (j == 0) continue;
      const int ts = g.table_select[r];
      static const int kSlot[32] = {0, 1, 2, 3, 0, 5, 6, 7, 8, 9, 10, 11, 12, 13, 0, 15,
                                    14, 14, 14, 14, 14, 14, 14, 14, 4, 4, 4, 4, 4, 4, 4, 4};
      static const int kSize[32] = {0, 2, 3, 3, 0, 4, 4, 6, 6, 6, 8, 8, 8, 16, 0, 16,
                                    16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 16};
      const int size = kSize[ts];
      if (!size) {
        for (int k = 0; k < 2 * j; k++) xr[s++] = 0.0f;
        continue;
      }
      const Vlc& v = T.big[kSlot[ts]];
      const int linbits = kLinbits[ts];
      for (; j > 0; j--) {
        if (at_end()) break;
        const int sym = b.vlc(v);
        int x = sym / size, y = sym % size;
        float fx = 0.0f, fy = 0.0f;
        if (x) {
          if (linbits && x == 15) x += b.get(linbits);
          fx = value(x, s);
          if (b.get(1)) fx = -fx;
        }
        if (y) {
          if (linbits && y == 15) y += b.get(linbits);
          fy = value(y, s + 1);
          if (b.get(1)) fy = -fy;
        }
        xr[s] = fx;
        xr[s + 1] = fy;
        s += 2;
      }
      if (j > 0) break;
    }
    // count1: quadruples of -1, 0, 1 until the part's end; a quadruple that
    // reads past it is dropped
    const Vlc& q = T.quad[g.count1table_select];
    int64_t last_pos = 0;
    while (s <= 572) {
      const int64_t p = b.pos;
      if (p >= end) {
        if (p > end_pos && last_pos) {
          s -= 4;
          break;
        }
        if (at_end()) break;
      }
      last_pos = p;
      const int code = b.vlc(q);
      for (int k = 0; k < 4; k++) {
        float f = 0.0f;
        if (code & (8 >> k)) {
          f = value(1, s + k);
          if (b.get(1)) f = -f;
        }
        xr[s + k] = f;
      }
      s += 4;
    }
    for (; s < 576; s++) xr[s] = 0.0f;
  }

  // joint stereo of a granule; the right channel's granule places the
  // intensity-stereo bands
  void stereo(const Granule& g1) {
    const Tables& T = tables();
    float* t0 = xr_[0];
    float* t1 = xr_[1];
    if (h_.mode_ext & 1) {
      const float* is_l;
      const float* is_r;
      int sf_max;
      if (!h_.lsf) {
        is_l = T.is1[0];
        is_r = T.is1[1];
        sf_max = 7;
      } else {
        is_l = T.is2[g1.scalefac_compress & 1][0];
        is_r = T.is2[g1.scalefac_compress & 1][1];
        sf_max = 16;
      }
      const bool ms = h_.mode_ext & 2;
      auto ms_band = [&](int off, int len) {
        if (!ms) return;
        const float r = static_cast<float>(1.0 / std::sqrt(2.0));
        for (int j = 0; j < len; j++) {
          const float a = t0[off + j], c = t1[off + j];
          t0[off + j] = (a + c) * r;
          t1[off + j] = (a - c) * r;
        }
      };
      auto is_band = [&](int off, int len, int sf) {
        const float v1 = is_l[sf], v2 = is_r[sf];
        for (int j = 0; j < len; j++) {
          const float a = t0[off + j];
          t0[off + j] = a * v1;
          t1[off + j] = a * v2;
        }
      };
      auto nonzero = [&](int off, int len) {
        for (int j = 0; j < len; j++)
          if (t1[off + j] != 0.0f) return true;
        return false;
      };
      int off = 576;
      bool found_short[3] = {false, false, false};
      const uint8_t* bs = kBandShort[h_.sr_index];
      int k = (13 - g1.short_start) * 3 + g1.long_end - 3;
      for (int i = 12; i >= g1.short_start; i--) {
        if (i != 11) k -= 3;  // the last band takes the one before's factor
        const int len = bs[i];
        for (int l = 2; l >= 0; l--) {
          off -= len;
          bool done = found_short[l];
          if (!done && nonzero(off, len)) found_short[l] = done = true;
          if (!done) {
            const int sf = g1.scale_factors[k + l];
            if (sf < sf_max) {
              is_band(off, len, sf);
              continue;
            }
          }
          ms_band(off, len);
        }
      }
      bool found = found_short[0] || found_short[1] || found_short[2];
      const uint8_t* bl = kBandLong[h_.sr_index];
      for (int i = g1.long_end - 1; i >= 0; i--) {
        const int len = bl[i];
        off -= len;
        if (!found && nonzero(off, len)) found = true;
        if (!found) {
          const int sf = g1.scale_factors[i == 21 ? 20 : i];
          if (sf < sf_max) {
            is_band(off, len, sf);
            continue;
          }
        }
        ms_band(off, len);
      }
    } else if (h_.mode_ext & 2) {
      for (int j = 0; j < 576; j++) {
        const float a = t0[j], c = t1[j];
        t0[j] = a + c;
        t1[j] = a - c;
      }
    }
  }

  void reorder(const Granule& g, int ch) {
    if (g.block_type != 2) return;
    float* p = xr_[ch] + (g.switch_point ? (h_.sr_index != 8 ? 36 : 72) : 0);
    float tmp[576];
    const uint8_t* bs = kBandShort[h_.sr_index];
    for (int i = g.short_start; i < 13; i++) {
      const int len = bs[i];
      float* d = tmp;
      for (int j = 0; j < len; j++) {
        *d++ = p[j];
        *d++ = p[len + j];
        *d++ = p[2 * len + j];
      }
      std::memcpy(p, tmp, sizeof(float) * 3 * len);
      p += 3 * len;
    }
  }

  void antialias(const Granule& g, int ch) {
    const Tables& T = tables();
    int n;
    if (g.block_type == 2) {
      if (!g.switch_point) return;
      n = 1;
    } else {
      n = 31;
    }
    float* p = xr_[ch] + 18;
    for (int i = 0; i < n; i++, p += 18)
      for (int j = 0; j < 8; j++) {
        const float lo = p[-1 - j], hi = p[j];
        p[-1 - j] = lo * T.cs[j] - hi * T.ca[j];
        p[j] = hi * T.cs[j] + lo * T.ca[j];
      }
  }

  // IMDCT, windowing, overlap-add and frequency inversion into the subband
  // samples of granule ``gr``
  void hybrid(const Granule& g, int ch, int gr) {
    const Tables& T = tables();
    const float* xr = xr_[ch];
    const int long_end = g.block_type == 2 ? (g.switch_point ? 2 : 0) : 32;
    for (int sb = 0; sb < 32; sb++) {
      const float* in = xr + 18 * sb;
      float* ov = overlap_[ch][sb];
      float y[36];
      bool zero = true;
      for (int k = 0; k < 18; k++) zero = zero && in[k] == 0.0f;
      if (zero) {
        for (int i = 0; i < 36; i++) y[i] = 0.0f;
      } else if (sb < long_end) {
        // the two lowest subbands of a granule with the switch point set take
        // the normal window, whatever its block type
        const float* w = T.win[g.block_type == 2 || (g.switch_point && sb < 2) ? 0
                               : g.block_type == 3 ? 2 : g.block_type];
        float h[18];
        for (int j = 0; j < 18; j++) h[j] = 0.0f;
        for (int k = 0; k < 18; k++) {
          const float x = in[k];
          if (x == 0.0f) continue;
          for (int j = 0; j < 18; j++) h[j] += x * T.imdct36[k][j];
        }
        for (int i = 0; i < 9; i++) {
          y[i] = h[i];
          y[17 - i] = -h[i];
          y[18 + i] = h[9 + i];
          y[35 - i] = h[9 + i];
        }
        for (int i = 0; i < 36; i++) y[i] *= w[i];
      } else {
        for (int i = 0; i < 36; i++) y[i] = 0.0f;
        for (int w = 0; w < 3; w++) {
          float h[6] = {0};
          for (int k = 0; k < 6; k++) {
            const float x = in[3 * k + w];
            if (x == 0.0f) continue;
            for (int j = 0; j < 6; j++) h[j] += x * T.imdct12[k][j];
          }
          float z[12];
          for (int i = 0; i < 3; i++) {
            z[i] = h[i];
            z[5 - i] = -h[i];
            z[6 + i] = h[3 + i];
            z[11 - i] = h[3 + i];
          }
          for (int i = 0; i < 12; i++) y[6 + 6 * w + i] += z[i] * T.win[3][i];
        }
      }
      float* o = &sb_[ch][18 * gr][sb];
      for (int i = 0; i < 18; i++) {
        float v = y[i] + ov[i];
        if ((sb & 1) && (i & 1)) v = -v;
        o[32 * i] = v;
        ov[i] = y[18 + i];
      }
    }
  }

  // polyphase synthesis of 18 * ngr slots of 32 subband samples. The 64
  // values V[i] = sum_k cos((16 + i)(2k + 1) pi / 64) S[k] of a slot come
  // from the 32 of X[j] = sum_k cos(j (2k + 1) pi / 64) S[k]: V[i] =
  // X[16 + i] for i < 16, V[16] = 0, -X[48 - i] up to 47, -X[i - 48] after.
  // V's last 16 slots are kept twice over, so that a slot's window reads
  // 1024 values in a row.
  void synthesis(int ngr, float* out) {
    const Tables& T = tables();
    for (int ch = 0; ch < nch_; ch++) {
      float* v = synth_v_[ch];
      for (int t = 0; t < 18 * ngr; t++) {
        const float* s = sb_[ch][t];
        float x[32];
        for (int j = 0; j < 32; j++) x[j] = 0.0f;
        for (int k = 0; k < 32; k++) {
          const float sk = s[k];
          if (sk == 0.0f) continue;
          const float* c = T.dct32[k];
          for (int j = 0; j < 32; j++) x[j] += c[j] * sk;
        }
        const int off = synth_off_[ch] = (synth_off_[ch] - 64) & 1023;
        float* vv = v + off;
        for (int i = 0; i < 16; i++) vv[i] = x[16 + i];
        vv[16] = 0.0f;
        for (int i = 17; i < 48; i++) vv[i] = -x[48 - i];
        for (int i = 48; i < 64; i++) vv[i] = -x[i - 48];
        std::memcpy(v + off + 1024, vv, 64 * sizeof(float));
        // out[j] = sum_i V[128 i + j] D[64 i + j] + V[128 i + 96 + j] D[64 i + 32 + j]
        float sum[32];
        for (int j = 0; j < 32; j++) sum[j] = 0.0f;
        for (int i = 0; i < 8; i++) {
          const float* a = vv + 128 * i;
          const float* da = T.d + 64 * i;
          for (int j = 0; j < 32; j++) sum[j] += a[j] * da[j];
          for (int j = 0; j < 32; j++) sum[j] += a[96 + j] * da[32 + j];
        }
        float* o = out + size_t(t) * 32 * nch_ + ch;
        for (int j = 0; j < 32; j++) o[j * nch_] = sum[j];
      }
    }
  }

  int nch_;
  Header h_;
  Granule gr_[2][2];
  float xr_[2][576];
  float overlap_[2][32][18];
  float sb_[2][36][32];
  float synth_v_[2][2048];
  int synth_off_[2] = {0, 0};
  std::vector<uint8_t> reservoir_;
  int64_t res_bits_ = 0, total_bits_ = 0;
  bool switched_ = false;
};

size_t id3v2_end(const uint8_t* d, size_t len) {
  size_t pos = 0;
  while (len - pos >= 10 && std::memcmp(d + pos, "ID3", 3) == 0 && d[pos + 3] != 0xFF &&
         d[pos + 4] != 0xFF && !((d[pos + 6] | d[pos + 7] | d[pos + 8] | d[pos + 9]) & 0x80)) {
    size_t size = 0;
    for (int i = 6; i < 10; i++) size = (size << 7) | (d[pos + i] & 0x7F);
    pos += 10 + size + ((d[pos + 5] & 0x10) ? 10 : 0);
    if (pos > len) return len;
  }
  return pos;
}

struct Gapless {
  bool tag = false;  // a Xing/Info frame, yielding no audio
  int64_t frames = 0;
  bool lame = false;
  int start_pad = 0, end_pad = 0;
  int64_t bytes = 0;  // the tag's stream size, 0 if absent
};

// A first frame's Xing/Info tag (and its LAME tag) or Fraunhofer VBRI tag.
// As FFmpeg's demuxer, the frame counts as a tag, yielding no audio, only
// where the tag gives a frame count or a stream size.
Gapless read_info_frame(const uint8_t* d, size_t len, const Header& h) {
  Gapless g;
  const size_t side = h.lsf ? (h.channels == 1 ? 9 : 17) : (h.channels == 1 ? 17 : 32);
  size_t p = 4 + side;
  const size_t end = std::min(len, size_t(h.frame_size));
  auto have = [&](size_t n) { return p + n <= end; };
  if (have(4) && (!std::memcmp(d + p, "Xing", 4) || !std::memcmp(d + p, "Info", 4))) {
    p += 4;
    const uint32_t flags = have(4) ? be32(d + p) : 0;
    p += 4;
    if ((flags & 1) && have(4)) g.frames = be32(d + p);
    if (flags & 1) p += 4;
    if ((flags & 2) && have(4)) g.bytes = be32(d + p);
    if (flags & 2) p += 4;
    if (flags & 4) p += 100;
    if (flags & 8) p += 4;
    // LAME tag: version string (9), revision (1), lowpass (1), peak (4), two
    // gains (4), flags (1), bitrate (1), then the delays (3)
    if (have(9 + 1 + 1 + 4 + 4 + 1 + 1 + 3)) {
      const uint8_t* ver = d + p;
      p += 9 + 1 + 1 + 4 + 4 + 1 + 1;
      const uint32_t v = (uint32_t(d[p]) << 16) | (uint32_t(d[p + 1]) << 8) | d[p + 2];
      if (!std::memcmp(ver, "LAME", 4) || !std::memcmp(ver, "Lavf", 4) ||
          !std::memcmp(ver, "Lavc", 4)) {
        g.lame = true;
        g.start_pad = v >> 12;
        g.end_pad = v & 4095;
      }
    }
  }
  // VBRI: version 1, delay and quality, then the stream size and frames
  if (end >= 36 + 18 && !std::memcmp(d + 36, "VBRI", 4) && d[40] == 0 && d[41] == 1) {
    g.bytes = be32(d + 46);
    g.frames = be32(d + 50);
  }
  g.tag = g.frames || g.bytes;
  return g;
}

// Where the next header after ``pos`` starts (``end`` if none).
size_t next_header(const uint8_t* d, size_t pos, size_t end) {
  Header h;
  for (size_t i = pos; i + 4 <= end; i++)
    if (parse_header(be32(d + i), h) >= 0) return i;
  return end;
}

}  // namespace

// The packets are FFmpeg's: a frame, or the bytes up to and including the
// next frame. A packet that does not start with a header fails the stream,
// unless it starts with "TAG", which swallows it; what is left at the end
// after the last header is dropped if it starts with an ID3v1 or APEv2 tag
// and fails the stream otherwise. A last frame cut short is decoded from
// the bytes there are.
int mp3_decode(const uint8_t* data, size_t len, Pcm& out) {
  try {
    const size_t start = id3v2_end(data, len);
    const size_t end = len;
    // a Xing/Info frame first: no audio, maybe the gapless trim
    Gapless gap;
    size_t pos = start;
    Header h;
    if (start + 4 <= end && parse_header(be32(data + start), h) == 0) {
      gap = read_info_frame(data + start, end - start, h);
      if (gap.tag) pos += h.frame_size;
      // a tag whose size is far below the file's: a concatenated file, whose
      // frame count is not used
      if (gap.bytes && int64_t(len) > gap.bytes && int64_t(len) - gap.bytes > gap.bytes >> 4)
        gap.frames = 0;
    }
    // the first frame: the first header (free format aside) whose successor
    // is a header of the same version, layer, rate, channel mode, copyright,
    // original and emphasis bits; the search fails where a header, or a
    // header's successor, would reach past the end
    const uint32_t kMask = 0xFFFE0CCFu;
    size_t first = pos;
    for (size_t i = 0; i < 65536; i++) {
      const size_t at = pos + i;
      if (at + 4 > end) return kMalformed;
      Header a, b;
      const uint32_t w = be32(data + at);
      if (parse_header(w, a) < 0 || a.bitrate_index == 0) continue;
      const size_t nxt = at + a.frame_size;
      if (nxt + 4 > end) return kMalformed;
      const uint32_t w2 = be32(data + nxt);
      if (parse_header(w2, b) >= 0 && b.bitrate_index != 0 && (w & kMask) == (w2 & kMask)) {
        first = at;
        break;
      }
    }
    if (parse_header(be32(data + first), h) < 0) return kMalformed;
    if (h.layer != 3 || h.bitrate_index == 0) return kUnsupported;
    const int nch = h.channels;
    const int rate = kSampleRate[h.sr_index];
    const int spf = h.spf;
    pos = first;
    Decoder dec(nch);
    std::vector<float>& pcm = out.samples;
    pcm.clear();
    // the frames there is room for at the first frame's size, or the tag's
    // count where it is smaller (a VBR stream's first frame may be short)
    int64_t frames_est = int64_t((end - pos) / h.frame_size) + 1;
    if (gap.frames > 0) frames_est = std::min<int64_t>(frames_est, gap.frames);
    pcm.reserve(size_t(frames_est) * spf * nch);
    int64_t skip = gap.lame ? gap.start_pad + 529 : 0;
    const int64_t first_discard =
        gap.lame && gap.frames ? gap.frames * spf - gap.end_pad + 529 : -1;
    const int64_t last_discard = gap.lame && gap.frames ? gap.frames * spf : -1;
    std::vector<float> buf(size_t(spf) * nch);
    int64_t packet = 0;
    while (pos < end) {
      Header f;
      bool audio = true;
      const size_t at = next_header(data, pos, end);
      if (at == end) {  // trailing bytes
        const size_t rest = end - pos;
        if ((rest >= 128 && !std::memcmp(data + pos, "TAG", 3)) ||
            (rest >= 32 && !std::memcmp(data + pos, "APETAGEX", 8)))
          break;
        return kMalformed;
      }
      if (at != pos) {
        if (end - pos < 3 || std::memcmp(data + pos, "TAG", 3)) return kMalformed;
        audio = false;  // a packet swallowed whole
      }
      if (parse_header(be32(data + at), f) != 0 || f.channels != nch ||
          kSampleRate[f.sr_index] != rate)
        return kUnsupported;
      const size_t avail = std::min<size_t>(f.frame_size, end - at);
      if (audio) dec.frame(data + at, f.frame_size, avail, f, buf.data());
      pos = at + avail;
      // trimming, per packet: the leading skip, then the padding at the end
      const int64_t sample = packet * spf;
      packet++;
      if (!audio) continue;
      int64_t n = spf;
      int64_t discard = 0;
      if (first_discard >= 0 && sample + spf >= first_discard && sample < last_discard)
        discard = std::min<int64_t>(sample + spf - first_discard, spf);
      int64_t from = 0;
      if (skip > 0) {
        if (n <= skip) {
          skip -= n;
          continue;
        }
        from = skip;
        n -= skip;
        skip = 0;
      }
      if (discard > 0 && discard <= n) n -= discard;
      pcm.insert(pcm.end(), buf.begin() + from * nch, buf.begin() + (from + n) * nch);
    }
    if (pcm.empty()) return kMalformed;
    out.channels = nch;
    out.rate = rate;
  } catch (const FrameError&) {
    return kMalformed;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
  return kOk;
}

}  // namespace audio_codecs
