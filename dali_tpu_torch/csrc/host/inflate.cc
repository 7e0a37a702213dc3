// Inflate written from RFC 1950 (the zlib wrapper: header, Adler-32) and
// RFC 1951 (Deflate: stored, fixed and dynamic blocks), for the Deflate
// strips and tiles of tiff_decode.cc. What the RFCs leave open follows zlib's
// inflate() called once over a whole chunk into the chunk's buffer, as
// libtiff's ZIPDecode calls it, since the reference keeps what that call
// wrote when it fails:
//
// * output is written symbol by symbol, so a failed stream keeps everything
//   written before the error;
// * once the buffer is full, decoding goes on until a symbol would be
//   written or the input ends: a bad code, block header, code-length set or
//   stored length met there, or a wrong Adler-32 after the last block, still
//   fails the stream; "distance too far back" is checked only when a byte of
//   the match is to be written;
// * a code-length set fails when over-subscribed or incomplete, except a
//   literal/length or distance set of one 1-bit code (reading its unused
//   code fails) and an empty distance set (reading any distance fails); a
//   code-length code of all zero lengths reads every length as 0 in one bit;
// * the fixed code's literal/length symbols 286-287 and distances 30-31 fail
//   when read; the header's window size may not exceed 32 KiB, and a preset
//   dictionary fails (no dictionary is given).

#include <cstring>

#include "inflate.h"

namespace dali_inflate {
namespace {

constexpr int kRoot = 10;  // bits of the first-level lookup

struct Stop {
  Status status;
};

class Bits {
 public:
  Bits(const uint8_t* d, size_t n) : d_(d), n_(n) {}
  // ``n`` <= 32 bits, first bit read in bit 0; stops with kInput at the end
  uint32_t read(int n) {
    need(n);
    const uint32_t v = static_cast<uint32_t>(hold_ & ((1ull << n) - 1));
    drop(n);
    return v;
  }
  void need(int n) {
    while (cnt_ < n) {
      if (pos_ == n_) throw Stop{kInput};
      hold_ |= static_cast<uint64_t>(d_[pos_++]) << cnt_;
      cnt_ += 8;
    }
  }
  // the next 15 bits as far as the input has them, zeros after; sets
  // ``avail`` to the number of real ones
  uint32_t peek15(int* avail) {
    while (cnt_ < 15 && pos_ < n_) {
      hold_ |= static_cast<uint64_t>(d_[pos_++]) << cnt_;
      cnt_ += 8;
    }
    *avail = cnt_;
    return static_cast<uint32_t>(hold_ & 0x7fff);
  }
  void drop(int n) {
    hold_ >>= n;
    cnt_ -= n;
  }
  // to the next byte boundary, with whole bytes held back returned to the input
  void align() {
    drop(cnt_ & 7);
    pos_ -= cnt_ / 8;
    hold_ = 0;
    cnt_ = 0;
  }
  size_t left() const { return n_ - pos_; }
  const uint8_t* at() const { return d_ + pos_; }
  void skip(size_t k) { pos_ += k; }

 private:
  const uint8_t* d_;
  size_t n_, pos_ = 0;
  uint64_t hold_ = 0;
  int cnt_ = 0;
};

inline uint32_t reverse(uint32_t v, int n) {
  uint32_t r = 0;
  for (int i = 0; i < n; ++i) r |= ((v >> i) & 1) << (n - 1 - i);
  return r;
}

// A canonical Huffman code. ``single``: one 1-bit code, its other code an
// error; ``empty``: every code an error after one bit, or (code-length code)
// symbol 0 in one bit.
class Huffman {
 public:
  enum Kind { kCodes, kLens, kDists };

  // false where zlib's inflate_table refuses the set
  bool build(const uint8_t* lengths, int n, Kind kind) {
    int count[16] = {0};
    for (int s = 0; s < n; ++s) ++count[lengths[s]];
    int max = 15;
    while (max >= 1 && count[max] == 0) --max;
    empty_ = max == 0;
    single_ = false;
    if (empty_) return true;
    int left = 1;
    for (int l = 1; l <= 15; ++l) {
      left = (left << 1) - count[l];
      if (left < 0) return false;
    }
    if (left > 0) {
      if (kind == kCodes || max != 1) return false;
      single_ = true;
    }
    int offs[16];
    offs[1] = 0;
    for (int l = 1; l < 15; ++l) offs[l + 1] = offs[l] + count[l];
    for (int s = 0; s < n; ++s)
      if (lengths[s]) symbols_[offs[lengths[s]]++] = static_cast<uint16_t>(s);
    std::memcpy(count_, count, sizeof(count));
    std::memset(len_, 0, sizeof(len_));
    int code = 0, k = 0;
    for (int l = 1; l <= 15; ++l) {
      for (int i = 0; i < count[l]; ++i, ++code, ++k) {
        if (l > kRoot) continue;
        for (uint32_t e = reverse(code, l); e < (1u << kRoot); e += 1u << l) {
          len_[e] = static_cast<uint8_t>(l);
          sym_[e] = symbols_[k];
        }
      }
      code <<= 1;
    }
    return true;
  }

  // the next symbol, -1 for a code zlib marks invalid; kInput where the
  // input ends inside the code
  int read(Bits& br) const {
    int avail;
    const uint32_t bits = br.peek15(&avail);
    if (empty_ || single_) {
      if (avail < 1) throw Stop{kInput};
      br.drop(1);
      if (empty_) return -1;
      return bits & 1 ? -1 : symbols_[0];
    }
    int l = len_[bits & ((1u << kRoot) - 1)];
    int sym;
    if (l) {
      sym = sym_[bits & ((1u << kRoot) - 1)];
    } else {
      int code = 0, first = 0, index = 0;
      for (l = 1;; ++l) {
        code |= (bits >> (l - 1)) & 1;
        if (code - count_[l] < first) {
          sym = symbols_[index + (code - first)];
          break;
        }
        index += count_[l];
        first = (first + count_[l]) << 1;
        code <<= 1;
      }
    }
    if (l > avail) throw Stop{kInput};
    br.drop(l);
    return sym;
  }

 private:
  bool empty_ = false, single_ = false;
  int count_[16] = {0};
  uint16_t symbols_[288] = {0};
  uint8_t len_[1 << kRoot];
  uint16_t sym_[1 << kRoot];
};

constexpr uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                                   31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
constexpr uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                   2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
constexpr uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
                                    33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
                                    1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
constexpr uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                    6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
constexpr uint8_t kCodeOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                    11, 4,  12, 3, 13, 2, 14, 1, 15};

uint32_t adler32(const uint8_t* p, size_t n) {
  uint32_t a = 1, b = 0;
  while (n) {
    const size_t k = n < 5552 ? n : 5552;
    for (size_t i = 0; i < k; ++i) {
      a += p[i];
      b += a;
    }
    a %= 65521;
    b %= 65521;
    p += k;
    n -= k;
  }
  return (b << 16) | a;
}

class Inflater {
 public:
  Inflater(const uint8_t* src, size_t n, uint8_t* dst, size_t cap)
      : br_(src, n), dst_(dst), cap_(cap) {}

  Status run() {
    const uint32_t cmf = br_.read(8), flg = br_.read(8);
    if (((cmf << 8) | flg) % 31 != 0 || (cmf & 15) != 8 || (cmf >> 4) + 8 > 15)
      throw Stop{kError};
    if (flg & 0x20) {  // a preset dictionary: zlib asks for one, which fails here
      br_.read(32);
      throw Stop{kError};
    }
    for (bool last = false; !last;) {
      last = br_.read(1) != 0;
      switch (br_.read(2)) {
        case 0: stored(); break;
        case 1: fixed(); break;
        case 2: dynamic(); break;
        default: throw Stop{kError};
      }
    }
    br_.align();
    uint32_t check = 0;
    for (int i = 0; i < 4; ++i) check = (check << 8) | br_.read(8);
    if (check != adler32(dst_, out_)) throw Stop{kError};
    return kEnd;
  }
  size_t written() const { return out_; }

 private:
  void stored() {
    br_.align();
    const uint32_t len = br_.read(16), nlen = br_.read(16);
    if (len != (nlen ^ 0xffff)) throw Stop{kError};
    br_.align();
    size_t left = len;
    while (left) {
      if (out_ == cap_) throw Stop{kFull};
      if (br_.left() == 0) throw Stop{kInput};
      size_t k = left;
      if (k > br_.left()) k = br_.left();
      if (k > cap_ - out_) k = cap_ - out_;
      std::memcpy(dst_ + out_, br_.at(), k);
      br_.skip(k);
      out_ += k;
      left -= k;
    }
  }

  void fixed() {
    uint8_t l[288 + 32];
    for (int s = 0; s < 288; ++s) l[s] = s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8;
    for (int s = 0; s < 32; ++s) l[288 + s] = 5;
    lit_.build(l, 288, Huffman::kLens);
    dist_.build(l + 288, 32, Huffman::kDists);
    codes();
  }

  void dynamic() {
    const int nlen = static_cast<int>(br_.read(5)) + 257;
    const int ndist = static_cast<int>(br_.read(5)) + 1;
    const int ncode = static_cast<int>(br_.read(4)) + 4;
    if (nlen > 286 || ndist > 30) throw Stop{kError};
    uint8_t cl[19] = {0};
    for (int i = 0; i < ncode; ++i) cl[kCodeOrder[i]] = static_cast<uint8_t>(br_.read(3));
    Huffman code_lengths;
    if (!code_lengths.build(cl, 19, Huffman::kCodes)) throw Stop{kError};
    uint8_t l[286 + 30];
    int have = 0;
    while (have < nlen + ndist) {
      int sym = code_lengths.read(br_);
      if (sym < 0) sym = 0;  // an all-zero code-length code: length 0, one bit
      if (sym < 16) {
        l[have++] = static_cast<uint8_t>(sym);
        continue;
      }
      int len = 0, copy;
      if (sym == 16) {
        br_.need(2);
        if (have == 0) throw Stop{kError};
        len = l[have - 1];
        copy = 3 + static_cast<int>(br_.read(2));
      } else if (sym == 17) {
        copy = 3 + static_cast<int>(br_.read(3));
      } else {
        copy = 11 + static_cast<int>(br_.read(7));
      }
      if (have + copy > nlen + ndist) throw Stop{kError};
      while (copy--) l[have++] = static_cast<uint8_t>(len);
    }
    if (l[256] == 0) throw Stop{kError};
    if (!lit_.build(l, nlen, Huffman::kLens)) throw Stop{kError};
    if (!dist_.build(l + nlen, ndist, Huffman::kDists)) throw Stop{kError};
    codes();
  }

  void codes() {
    for (;;) {
      const int sym = lit_.read(br_);
      if (sym < 0 || sym > 285) throw Stop{kError};
      if (sym < 256) {
        if (out_ == cap_) throw Stop{kFull};
        dst_[out_++] = static_cast<uint8_t>(sym);
        continue;
      }
      if (sym == 256) return;
      size_t len = kLenBase[sym - 257] + br_.read(kLenExtra[sym - 257]);
      const int dsym = dist_.read(br_);
      if (dsym < 0 || dsym > 29) throw Stop{kError};
      const size_t dist = kDistBase[dsym] + br_.read(kDistExtra[dsym]);
      if (out_ == cap_) throw Stop{kFull};
      if (dist > out_) throw Stop{kError};
      for (; len && out_ < cap_; --len, ++out_) dst_[out_] = dst_[out_ - dist];
      if (len) throw Stop{kFull};
    }
  }

  Bits br_;
  uint8_t* dst_;
  size_t cap_, out_ = 0;
  Huffman lit_, dist_;
};

}  // namespace

int inflate_zlib(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, size_t* written) {
  Inflater inf(src, n, dst, cap);
  Status s;
  try {
    s = inf.run();
  } catch (const Stop& e) {
    s = e.status;
  }
  *written = inf.written();
  return s;
}

}  // namespace dali_inflate

extern "C" {

// ``dali_inflate::inflate_zlib`` for tests.
int dali_tpu_torch_inflate_zlib(const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                                size_t* written) {
  return dali_inflate::inflate_zlib(src, n, dst, cap, written);
}

}  // extern "C"
