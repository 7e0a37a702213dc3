// FLAC decoder written from the format specification (RFC 9639), for the
// host audio decode of dali_tpu_torch. It links no library.
//
// Covered: a leading ID3v2 tag (skipped); the metadata blocks (STREAMINFO
// read; PADDING, APPLICATION, SEEKTABLE, VORBIS_COMMENT, CUESHEET and PICTURE
// skipped); frame headers with every block-size and sample-rate code,
// including the explicit 8- and 16-bit forms, checked by their CRC-8; the
// CONSTANT, VERBATIM, FIXED (orders 0-4) and LPC (orders 1-32) subframes with
// wasted bits; Rice and Rice2 residual partitions, escaped ones included;
// independent (1-8 channels), left/side, right/side and mid/side channels;
// bit depths 4 to 32. Each frame's CRC-16 is checked.
//
// Output: float32 interleaved, sample / 2^(bits - 1), as FFmpeg's decoder
// followed by swresample to AV_SAMPLE_FMT_FLT gives it (exact up to 24 bits).
// Any malformed or CRC-failing stream returns an error code.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

#include "audio_codecs.h"

namespace {

struct Fail {};

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t len) : d_(data), len_(len), nbits_(len * 8) {}

  uint32_t bits(int n) {  // n in 0..32
    if (n == 0) return 0;
    if (pos_ + n > nbits_) throw Fail();
    const uint64_t v = peek() >> (64 - n);
    pos_ += n;
    return static_cast<uint32_t>(v);
  }
  int64_t sbits(int n) {  // two's complement of n bits, n in 0..33
    if (n == 0) return 0;
    if (n > 32) {
      const int64_t hi = static_cast<int64_t>(bits(n - 32));
      const uint64_t v = (static_cast<uint64_t>(hi) << 32) | bits(32);
      return static_cast<int64_t>(v << (64 - n)) >> (64 - n);
    }
    const uint64_t v = bits(n);
    return static_cast<int64_t>(v << (64 - n)) >> (64 - n);
  }
  uint32_t bit() { return bits(1); }
  uint32_t unary() {  // zeros before the next one
    uint32_t q = 0;
    for (;;) {
      if (pos_ >= nbits_) throw Fail();
      const size_t avail = nbits_ - pos_ < 57 ? nbits_ - pos_ : 57;
      const uint64_t w = peek() & ~(~uint64_t(0) >> avail);  // the next ``avail`` bits
      if (w) {
        const int z = __builtin_clzll(w);
        pos_ += z + 1;
        return q + z;
      }
      q += static_cast<uint32_t>(avail);
      pos_ += avail;
      if (q > (1u << 30)) throw Fail();
    }
  }
  void align() { pos_ = (pos_ + 7) & ~size_t(7); }
  size_t byte_pos() const { return pos_ >> 3; }

 private:
  // the 64 bits from pos_ on, left-aligned, zeros past the end (at least
  // 57 of them are the stream's own when that many remain)
  uint64_t peek() const {
    const size_t byte = pos_ >> 3;
    uint64_t v = 0;
    if (byte + 8 <= len_) {
      std::memcpy(&v, d_ + byte, 8);
      v = __builtin_bswap64(v);
    } else {
      for (int i = 0; i < 8; i++) v = (v << 8) | (byte + i < len_ ? d_[byte + i] : 0);
    }
    return v << (pos_ & 7);
  }

  const uint8_t* d_;
  size_t len_;
  size_t nbits_;
  size_t pos_ = 0;
};

uint8_t crc8(const uint8_t* p, size_t n) {
  uint8_t c = 0;
  for (size_t i = 0; i < n; i++) {
    c ^= p[i];
    for (int k = 0; k < 8; k++) c = (c & 0x80) ? static_cast<uint8_t>((c << 1) ^ 0x07) : (c << 1);
  }
  return c;
}

struct Crc16Table {
  uint16_t t[256];
  Crc16Table() {
    for (int b = 0; b < 256; b++) {
      uint16_t c = static_cast<uint16_t>(b << 8);
      for (int k = 0; k < 8; k++)
        c = (c & 0x8000) ? static_cast<uint16_t>((c << 1) ^ 0x8005) : static_cast<uint16_t>(c << 1);
      t[b] = c;
    }
  }
};

uint16_t crc16(const uint8_t* p, size_t n) {  // polynomial 0x8005, a byte a step
  static const Crc16Table table;
  uint16_t c = 0;
  for (size_t i = 0; i < n; i++)
    c = static_cast<uint16_t>((c << 8) ^ table.t[(c >> 8) ^ p[i]]);
  return c;
}

struct StreamInfo {
  uint32_t rate = 0;
  int channels = 0;
  int bps = 0;
  uint64_t total = 0;
};

// Residual of one subframe into res[order..block), as RFC 9639 section 9.2.7.
void read_residual(BitReader& br, int block, int order, int64_t* res) {
  uint32_t method = br.bits(2);
  if (method > 1) throw Fail();
  const int pbits = method == 0 ? 4 : 5;
  const uint32_t escape = method == 0 ? 15 : 31;
  const int porder = static_cast<int>(br.bits(4));
  const int parts = 1 << porder;
  if (block % parts) throw Fail();
  const int per = block >> porder;
  if (per < order) throw Fail();
  int n = order;
  for (int p = 0; p < parts; p++) {
    const int count = p == 0 ? per - order : per;
    const uint32_t k = br.bits(pbits);
    if (k == escape) {
      const int nb = static_cast<int>(br.bits(5));
      for (int i = 0; i < count; i++) res[n++] = br.sbits(nb);
    } else {
      for (int i = 0; i < count; i++) {
        const uint64_t q = br.unary();
        const uint64_t u = (q << k) | br.bits(static_cast<int>(k));
        if (u >> 33) throw Fail();
        res[n++] = static_cast<int64_t>(u >> 1) ^ -static_cast<int64_t>(u & 1);
      }
    }
  }
}

void read_subframe(BitReader& br, int block, int bps, int64_t* out) {
  if (br.bit()) throw Fail();  // zero pad bit
  const uint32_t type = br.bits(6);
  int wasted = 0;
  if (br.bit()) wasted = static_cast<int>(br.unary()) + 1;
  if (wasted >= bps) throw Fail();
  const int sbps = bps - wasted;
  if (type == 0) {  // CONSTANT
    const int64_t v = br.sbits(sbps);
    for (int i = 0; i < block; i++) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < block; i++) out[i] = br.sbits(sbps);
  } else if (type >= 8 && type <= 12) {  // FIXED, order 0-4
    const int order = static_cast<int>(type - 8);
    if (order > block) throw Fail();
    for (int i = 0; i < order; i++) out[i] = br.sbits(sbps);
    read_residual(br, block, order, out);
    for (int i = order; i < block; i++) {
      int64_t p = 0;
      switch (order) {
        case 1: p = out[i - 1]; break;
        case 2: p = 2 * out[i - 1] - out[i - 2]; break;
        case 3: p = 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3]; break;
        case 4: p = 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] - out[i - 4]; break;
        default: break;
      }
      out[i] += p;
    }
  } else if (type >= 32) {  // LPC, order 1-32
    const int order = static_cast<int>(type - 31);
    if (order > block) throw Fail();
    for (int i = 0; i < order; i++) out[i] = br.sbits(sbps);
    const uint32_t prec = br.bits(4);
    if (prec == 15) throw Fail();
    const int64_t shift = br.sbits(5);
    if (shift < 0) throw Fail();
    int64_t coef[32];
    for (int j = 0; j < order; j++) coef[j] = br.sbits(static_cast<int>(prec) + 1);
    read_residual(br, block, order, out);
    for (int i = order; i < block; i++) {
      int64_t acc = 0;
      for (int j = 0; j < order; j++) acc += coef[j] * out[i - 1 - j];
      out[i] += acc >> shift;
    }
  } else {
    throw Fail();  // reserved subframe type
  }
  if (wasted)
    for (int i = 0; i < block; i++) out[i] = static_cast<int64_t>(static_cast<uint64_t>(out[i]) << wasted);
}

// The UTF-8-like coded frame or sample number of a frame header.
void skip_coded_number(BitReader& br) {
  const uint32_t b0 = br.bits(8);
  int extra;
  if (!(b0 & 0x80)) extra = 0;
  else if ((b0 & 0xE0) == 0xC0) extra = 1;
  else if ((b0 & 0xF0) == 0xE0) extra = 2;
  else if ((b0 & 0xF8) == 0xF0) extra = 3;
  else if ((b0 & 0xFC) == 0xF8) extra = 4;
  else if ((b0 & 0xFE) == 0xFC) extra = 5;
  else if (b0 == 0xFE) extra = 6;
  else throw Fail();
  for (int i = 0; i < extra; i++)
    if ((br.bits(8) & 0xC0) != 0x80) throw Fail();
}

// Decode one frame at byte offset ``pos``; appends float samples. Returns the
// byte offset after the frame.
size_t decode_frame(const uint8_t* d, size_t len, size_t pos, const StreamInfo& si,
                    std::vector<int64_t>& chans, std::vector<float>& out) {
  BitReader br(d + pos, len - pos);
  if (br.bits(15) != 0x7FFC) throw Fail();  // sync 0b111111111111100
  br.bit();                                  // blocking strategy
  const uint32_t bs_code = br.bits(4);
  const uint32_t sr_code = br.bits(4);
  const uint32_t ch_code = br.bits(4);
  const uint32_t ss_code = br.bits(3);
  if (br.bit()) throw Fail();  // reserved
  skip_coded_number(br);
  int block;
  if (bs_code == 0) throw Fail();
  else if (bs_code == 1) block = 192;
  else if (bs_code <= 5) block = 576 << (bs_code - 2);
  else if (bs_code == 6) block = static_cast<int>(br.bits(8)) + 1;
  else if (bs_code == 7) block = static_cast<int>(br.bits(16)) + 1;
  else block = 256 << (bs_code - 8);
  if (sr_code == 12) br.bits(8);
  else if (sr_code == 13 || sr_code == 14) br.bits(16);
  else if (sr_code == 15) throw Fail();
  const size_t hdr_len = br.byte_pos();
  const uint32_t crc = br.bits(8);
  if (crc8(d + pos, hdr_len) != crc) throw Fail();

  static const int kSizes[8] = {0, 8, 12, -1, 16, 20, 24, 32};
  const int bps = ss_code == 0 ? si.bps : kSizes[ss_code];
  if (bps <= 0) throw Fail();
  int nch;
  if (ch_code <= 7) nch = static_cast<int>(ch_code) + 1;
  else if (ch_code <= 10) nch = 2;
  else throw Fail();
  if (nch != si.channels) throw Fail();
  if (bps != si.bps) throw Fail();

  chans.resize(static_cast<size_t>(nch) * block);
  for (int c = 0; c < nch; c++) {
    const bool side = (ch_code == 8 && c == 1) || (ch_code == 9 && c == 0) ||
                      (ch_code == 10 && c == 1);
    read_subframe(br, block, bps + (side ? 1 : 0), chans.data() + static_cast<size_t>(c) * block);
  }
  br.align();
  const size_t body = br.byte_pos();
  const uint32_t crc_16 = br.bits(16);
  if (crc16(d + pos, body) != crc_16) throw Fail();

  int64_t* a = chans.data();
  int64_t* b = chans.data() + block;
  if (ch_code == 8) {  // left/side
    for (int i = 0; i < block; i++) b[i] = a[i] - b[i];
  } else if (ch_code == 9) {  // side/right
    for (int i = 0; i < block; i++) a[i] += b[i];
  } else if (ch_code == 10) {  // mid/side
    for (int i = 0; i < block; i++) {
      const int64_t mid = static_cast<int64_t>(static_cast<uint64_t>(a[i]) << 1) | (b[i] & 1);
      const int64_t s = b[i];
      a[i] = (mid + s) >> 1;
      b[i] = (mid - s) >> 1;
    }
  }
  const float scale = 1.0f / static_cast<float>(int64_t(1) << (bps - 1));
  const int64_t lo = -(int64_t(1) << (bps - 1)), hi = (int64_t(1) << (bps - 1)) - 1;
  const size_t base = out.size();
  out.resize(base + static_cast<size_t>(block) * nch);
  float* o = out.data() + base;
  for (int i = 0; i < block; i++)
    for (int c = 0; c < nch; c++) {
      const int64_t v = chans[static_cast<size_t>(c) * block + i];
      if (v < lo || v > hi) throw Fail();
      o[static_cast<size_t>(i) * nch + c] = static_cast<float>(v) * scale;
    }
  return pos + br.byte_pos();
}

size_t skip_id3v2(const uint8_t* d, size_t len) {
  if (len < 10 || std::memcmp(d, "ID3", 3) != 0) return 0;
  size_t size = 0;
  for (int i = 6; i < 10; i++) {
    if (d[i] & 0x80) throw Fail();
    size = (size << 7) | d[i];
  }
  size += 10;
  if (d[5] & 0x10) size += 10;  // footer
  if (size > len) throw Fail();
  return size;
}

// Parse the stream header and metadata; returns the offset of the first frame.
size_t read_header(const uint8_t* d, size_t len, StreamInfo& si) {
  size_t pos = skip_id3v2(d, len);
  if (len - pos < 4 || std::memcmp(d + pos, "fLaC", 4) != 0) throw Fail();
  pos += 4;
  bool have_info = false, last = false;
  while (!last) {
    if (len - pos < 4) throw Fail();
    last = (d[pos] & 0x80) != 0;
    const int type = d[pos] & 0x7F;
    const size_t blen = (size_t(d[pos + 1]) << 16) | (size_t(d[pos + 2]) << 8) | d[pos + 3];
    pos += 4;
    if (blen > len - pos || type == 127) throw Fail();
    if (type == 0) {
      if (have_info || blen < 34) throw Fail();
      BitReader br(d + pos, blen);
      br.bits(32);  // min and max block size
      br.bits(24);  // min and max frame size
      br.bits(24);
      si.rate = br.bits(20);
      si.channels = static_cast<int>(br.bits(3)) + 1;
      si.bps = static_cast<int>(br.bits(5)) + 1;
      si.total = (static_cast<uint64_t>(br.bits(4)) << 32) | br.bits(32);
      if (si.bps < 4) throw Fail();
      have_info = true;
    } else if (!have_info) {
      throw Fail();  // STREAMINFO comes first
    }
    pos += blen;
  }
  if (!have_info) throw Fail();
  return pos;
}

int decode_stream(const uint8_t* d, size_t len, std::vector<float>& out, StreamInfo& si) {
  try {
    size_t pos = read_header(d, len, si);
    std::vector<int64_t> chans;
    // STREAMINFO's count, but no more than a few samples per byte: a header
    // may claim more than its frames hold, and silence may hold more
    const uint64_t room = uint64_t(len) * 4 + (1 << 16);
    out.reserve(si.total ? std::min<uint64_t>(si.total * si.channels, room) : 1 << 16);
    while (pos < len) {
      if (len - pos == 128 && std::memcmp(d + pos, "TAG", 3) == 0) break;  // ID3v1 trailer
      pos = decode_frame(d, len, pos, si, chans, out);
    }
    if (out.empty()) return -1;
    if (si.total && out.size() != si.total * static_cast<uint64_t>(si.channels)) return -1;
  } catch (const Fail&) {
    return -1;
  } catch (const std::bad_alloc&) {
    return -3;
  }
  return 0;
}

}  // namespace

namespace audio_codecs {

int flac_decode(const uint8_t* data, size_t len, Pcm& out) {
  StreamInfo si;
  const int rc = decode_stream(data, len, out.samples, si);
  if (rc == kOk) {
    out.channels = si.channels;
    out.rate = static_cast<int>(si.rate);
  }
  return rc;
}

}  // namespace audio_codecs
