// Vorbis I decoder written from the Vorbis I specification, for the host
// audio decode of dali_tpu_torch. It links no library; its one constant
// table (floor 1's inverse dB table) is the specification's, in
// audio_tables.h.
//
// Covered: the identification, comment and setup headers; codebooks (the
// specification's codeword assignment from the lengths, ordered and sparse
// length lists, VQ lookup type 1: FFmpeg, the reference, refuses type 2);
// floor 1; residue types 0, 1 and 2; mappings with submaps and polar
// channel coupling; the inverse MDCT of
// both block sizes, the power-sine windows and overlap-add. Floor 0, which
// libvorbis never writes, is not decoded (kUnsupported).
//
// Around the packets it does what FFmpeg 5.1's ogg demuxer and vorbis
// decoder do, the reference's route: the first audio packet yields no
// samples; the end of the stream is cut where the granule position of the
// last (end-of-stream) page says, with the timestamps FFmpeg gives the
// packets; a stream without an end-of-stream page comes back whole; the
// window between two blocks is the one their sizes call for; channels come
// out in FFmpeg's order for 3 to 8 channels. A packet the decoder rejects
// fails the whole stream, as the reference's decode loop does. A chained
// file (more streams after the first one's end) is not decoded
// (kUnsupported): FFmpeg decodes its streams one after another.
//
// Output: float32, interleaved, full scale +-1, unclipped.

#include <algorithm>
#include <cmath>
#include <complex>
#include <cstring>
#include <new>

#include "audio_codecs.h"
#include "audio_tables.h"

namespace audio_codecs {
namespace {

struct Malformed {};
struct Unsupported {};

constexpr double kPi = 3.14159265358979323846;

int ilog(uint32_t v) {
  int n = 0;
  while (v) {
    n++;
    v >>= 1;
  }
  return n;
}

// LSB-first reader; bits past the end read as zeros.
struct Bits {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;  // bits

  uint32_t peek(int k) const {  // k <= 32
    const size_t byte = pos >> 3;
    uint64_t v = 0;
    if (byte + 8 <= n) {
      std::memcpy(&v, d + byte, 8);
    } else {
      for (size_t i = 0; i < 8; i++) v |= uint64_t(byte + i < n ? d[byte + i] : 0) << (8 * i);
    }
    v >>= (pos & 7);
    return k == 32 ? uint32_t(v) : uint32_t(v & ((uint64_t(1) << k) - 1));
  }
  uint32_t get(int k) {
    if (k == 0) return 0;
    const uint32_t v = peek(k);
    pos += k;
    return v;
  }
  int64_t left() const { return int64_t(n) * 8 - int64_t(pos); }
};

float float32_unpack(uint32_t x) {
  const double mantissa = x & 0x1FFFFF;
  const int exponent = int((x & 0x7FE00000u) >> 21);
  const double v = std::ldexp(mantissa, exponent - 788);
  return static_cast<float>((x & 0x80000000u) ? -v : v);
}

uint32_t reverse_bits(uint32_t v, int n) {
  uint32_t r = 0;
  for (int i = 0; i < n; i++) r |= ((v >> i) & 1) << (n - 1 - i);
  return r;
}

struct Codebook {
  static constexpr int kRoot = 10;
  // FFmpeg's VLC tables index their subtables with int16 and hold at most
  // 2^11 slots each: a book of more codewords than this never loads there
  static constexpr int kMaxUsed = 32767 + 2048;
  int dims = 0, entries = 0;
  std::vector<int32_t> root;      // (len << 24 | entry), or -1 for longer / no code
  std::vector<int32_t> tree;      // pairs of children: >0 node, <0 ~entry, 0 none
  std::vector<float> vq;          // entries * dims, lookup type 1
  bool has_vq = false;

  // The header's limits are FFmpeg 5.1's, the reference's: 1 to 16
  // dimensions, lookup type 0 or 1 (it refuses type 2). A length list or a
  // lookup table reaching past the packet's end is refused before anything
  // is sized from it; the reference, reading zeros there, fails the setup's
  // framing bit.
  void read(Bits& b) {
    if (b.get(24) != 0x564342) throw Malformed();
    dims = b.get(16);
    entries = b.get(24);
    if (entries <= 0 || dims <= 0 || dims > 16) throw Malformed();
    std::vector<int> len;
    if (!b.get(1)) {
      const bool sparse = b.get(1);
      if (b.left() < int64_t(entries) * (sparse ? 1 : 5)) throw Malformed();
      len.assign(entries, 0);
      for (int i = 0; i < entries; i++)
        if (!sparse || b.get(1)) len[i] = int(b.get(5)) + 1;
    } else {
      if (entries > kMaxUsed) throw Malformed();
      len.assign(entries, 0);
      int cur = int(b.get(5)) + 1, i = 0;
      while (i < entries) {
        const int num = b.get(ilog(uint32_t(entries - i)));
        if (i + num > entries || cur > 32) throw Malformed();
        for (int k = 0; k < num; k++) len[i++] = cur;
        cur++;
      }
    }
    if (std::count_if(len.begin(), len.end(), [](int l) { return l > 0; }) > kMaxUsed)
      throw Malformed();
    build(len);
    const int lookup = b.get(4);
    if (lookup == 1) {
      const float minimum = float32_unpack(b.get(32));
      const float delta = float32_unpack(b.get(32));
      const int value_bits = int(b.get(4)) + 1;
      const bool sequence = b.get(1);
      // the largest r with r^dims <= entries
      int64_t r = static_cast<int64_t>(std::floor(std::pow(double(entries), 1.0 / dims)));
      auto pw = [this](int64_t v) {
        int64_t p = 1;
        for (int i = 0; i < dims && p <= entries; i++) p *= v;
        return p;
      };
      while (r > 0 && pw(r) > entries) r--;
      while (pw(r + 1) <= entries) r++;
      const int64_t nvals = r;
      if (b.left() < nvals * value_bits) throw Malformed();
      std::vector<uint32_t> mult(static_cast<size_t>(nvals));
      for (auto& m : mult) m = b.get(value_bits);
      vq.assign(size_t(entries) * dims, 0.0f);
      for (int e = 0; e < entries; e++) {
        float last = 0.0f;
        int64_t divisor = 1;
        for (int i = 0; i < dims; i++) {
          const float v = float(mult[size_t((e / divisor) % nvals)]) * delta + minimum + last;
          vq[size_t(e) * dims + i] = v;
          if (sequence) last = v;
          divisor *= nvals;
        }
      }
      has_vq = true;
    } else if (lookup != 0) {
      throw Malformed();
    }
  }

  // codewords from the lengths: each entry in order takes the first free
  // codeword of its length (the specification's assignment)
  void build(const std::vector<int>& len) {
    root.assign(1u << kRoot, -1);
    tree.assign(2, 0);
    uint32_t available[33] = {0};
    bool first = true;
    int used = 0;
    for (int e = 0; e < entries; e++) {
      const int l = len[e];
      if (!l) continue;
      uint32_t code;  // left-aligned in 32 bits
      if (first) {
        code = 0;
        for (int i = 1; i <= l; i++) available[i] = 1u << (32 - i);
        first = false;
      } else {
        int z = l;
        while (z > 0 && !available[z]) z--;
        if (z == 0) throw Malformed();
        code = available[z];
        available[z] = 0;
        for (int y = l; y > z; y--) available[y] = code + (1u << (32 - y));
      }
      used++;
      const uint32_t c = l == 32 ? code : code >> (32 - l);
      const uint32_t rev = reverse_bits(c, l);  // the first bit read at bit 0
      if (l <= kRoot) {
        for (uint32_t k = 0; k < (1u << (kRoot - l)); k++) root[rev | (k << l)] = (l << 24) | e;
      }
      int node = 0;
      for (int i = 0; i < l; i++) {
        const size_t at = 2 * size_t(node) + ((rev >> i) & 1);
        if (i == l - 1) {
          tree[at] = ~e;
        } else {
          if (tree[at] <= 0) {
            const int32_t fresh = static_cast<int32_t>(tree.size() / 2);
            tree.resize(tree.size() + 2, 0);
            tree[at] = fresh;
          }
          node = tree[at];
        }
      }
    }
    // a tree with a free leaf left is refused, as FFmpeg refuses it (a book
    // of one codeword aside)
    if (used > 1)
      for (int i = 1; i <= 32; i++)
        if (available[i]) throw Malformed();
  }

  // the next entry, or -1 for a codeword the book does not hold
  int decode(Bits& b) const {
    const int32_t e = root[b.peek(kRoot)];
    if (e >= 0) {
      b.pos += e >> 24;
      return e & 0xFFFFFF;
    }
    int node = 0;
    for (int i = 0; i < 32; i++) {
      const int32_t c = tree[2 * node + b.get(1)];
      if (c < 0) return ~c;
      if (c == 0) return -1;
      node = c;
    }
    return -1;
  }
};

struct Floor1 {
  std::vector<int> partition_class;
  int class_dims[16], class_sub[16], class_master[16], sub_books[16][8];
  int multiplier = 1;
  std::vector<int> x;       // X list
  std::vector<int> order;   // x indices sorted by X
  std::vector<int> low, high;
};

struct Residue {
  int type = 0;
  uint32_t begin = 0, end = 0, partition_size = 1;
  int classifications = 1, classbook = 0;
  int books[64][8];
};

struct Mapping {
  int submaps = 1;
  std::vector<int> magnitude, angle;
  std::vector<int> mux;
  int floor[16], residue[16];
};

struct Mode {
  int blockflag, mapping;
};

class Decoder {
 public:
  void ident(const uint8_t* p, size_t n) {
    Bits b{p, n};
    if (b.get(8) != 1 || n < 30 || std::memcmp(p + 1, "vorbis", 6)) throw Malformed();
    b.pos += 48;
    if (b.get(32) != 0) throw Malformed();
    channels_ = b.get(8);
    rate_ = static_cast<int>(b.get(32));
    b.get(32);
    b.get(32);
    b.get(32);
    const int bl0 = b.get(4), bl1 = b.get(4);
    if (channels_ <= 0 || rate_ <= 0 || bl0 < 6 || bl1 > 13 || bl0 > bl1) throw Malformed();
    if (!b.get(1)) throw Malformed();
    bs_[0] = 1 << bl0;
    bs_[1] = 1 << bl1;
  }

  void setup(const uint8_t* p, size_t n) {
    Bits b{p, n};
    if (b.get(8) != 5 || n < 7 || std::memcmp(p + 1, "vorbis", 6)) throw Malformed();
    b.pos += 48;
    books_.resize(b.get(8) + 1);
    for (auto& c : books_) c.read(b);
    const int ntime = int(b.get(6)) + 1;
    for (int i = 0; i < ntime; i++)
      if (b.get(16) != 0) throw Malformed();
    floors_.resize(b.get(6) + 1);
    for (auto& f : floors_) read_floor(b, f);
    residues_.resize(b.get(6) + 1);
    for (auto& r : residues_) read_residue(b, r);
    mappings_.resize(b.get(6) + 1);
    for (auto& m : mappings_) read_mapping(b, m);
    modes_.resize(b.get(6) + 1);
    for (auto& m : modes_) {
      m.blockflag = b.get(1);
      if (b.get(16) != 0 || b.get(16) != 0) throw Malformed();
      m.mapping = b.get(8);
      if (m.mapping >= int(mappings_.size())) throw Malformed();
    }
    if (!b.get(1)) throw Malformed();
    // windows (one slope per block size) and the transforms
    for (int k = 0; k < 2; k++) {
      const int half = bs_[k] / 2;
      slope_[k].resize(half);
      for (int i = 0; i < half; i++) {
        const double s = std::sin((i + 0.5) / half * kPi / 2);
        slope_[k][i] = static_cast<float>(std::sin(kPi / 2 * s * s));
      }
      init_imdct(k);
    }
    saved_.assign(channels_, std::vector<float>(bs_[1] / 2, 0.0f));
  }

  int channels() const { return channels_; }
  int rate() const { return rate_; }
  int blocksize(int flag) const { return bs_[flag]; }

  // The block-size flag of an audio packet (-1 if not one), as FFmpeg's
  // parser reads it for the packets' durations.
  int packet_blockflag(const uint8_t* p, size_t n) const {
    if (n == 0 || (p[0] & 1)) return -1;
    Bits b{p, n};
    b.get(1);
    const int mode = modes_.size() == 1 ? 0 : int(b.get(ilog(uint32_t(modes_.size() - 1))));
    if (mode >= int(modes_.size())) return -1;
    return modes_[mode].blockflag;
  }

  // Decodes one audio packet; appends its samples (interleaved, output
  // channel order) to ``out`` unless it is the first; returns their count.
  int64_t packet(const uint8_t* p, size_t n, std::vector<float>& out) {
    Bits b{p, n};
    if (b.get(1)) throw Malformed();
    int mode = 0;
    if (modes_.size() > 1) mode = b.get(ilog(uint32_t(modes_.size() - 1)));
    if (mode >= int(modes_.size())) throw Malformed();
    const Mapping& map = mappings_[modes_[mode].mapping];
    const int flag = modes_[mode].blockflag;
    const int bsize = bs_[flag];
    const int half = bsize / 2;
    if (flag) {
      const int code = b.get(2);
      if (prev_flag_ < 0) prev_flag_ = code >> 1;
    } else if (prev_flag_ < 0) {
      prev_flag_ = 0;
    }
    std::vector<std::vector<float>> floor(channels_, std::vector<float>(half, 0.0f));
    std::vector<std::vector<float>> res(channels_, std::vector<float>(half, 0.0f));
    std::vector<char> no_residue(channels_, 0);
    for (int c = 0; c < channels_; c++) {
      const int fl = map.floor[map.submaps > 1 ? map.mux[c] : 0];
      no_residue[c] = decode_floor(b, floors_[fl], floor[c].data(), half);
    }
    for (int i = int(map.magnitude.size()) - 1; i >= 0; i--)
      if (!(no_residue[map.magnitude[i]] && no_residue[map.angle[i]]))
        no_residue[map.magnitude[i]] = no_residue[map.angle[i]] = 0;
    for (int s = 0; s < map.submaps; s++) {
      std::vector<float*> vecs;
      std::vector<char> skip;
      for (int c = 0; c < channels_; c++)
        if (map.submaps == 1 || map.mux[c] == s) {
          vecs.push_back(res[c].data());
          skip.push_back(no_residue[c]);
        }
      if (!vecs.empty()) decode_residue(b, residues_[map.residue[s]], vecs, skip, half);
    }
    for (int i = int(map.magnitude.size()) - 1; i >= 0; i--) {
      float* m = res[map.magnitude[i]].data();
      float* a = res[map.angle[i]].data();
      for (int k = 0; k < half; k++) {
        const float mv = m[k], av = a[k];
        if (mv > 0.0f) {
          if (av > 0.0f) {
            a[k] = mv - av;
          } else {
            a[k] = mv;
            m[k] = mv + av;
          }
        } else {
          if (av > 0.0f) {
            a[k] = mv + av;
          } else {
            a[k] = mv;
            m[k] = mv - av;
          }
        }
      }
    }
    // dot product, inverse MDCT, window, overlap-add
    const int prev = prev_flag_;
    const int64_t count = (bsize + bs_[prev]) / 4;
    const bool emit = started_;
    const size_t base = out.size();
    if (emit) out.resize(base + size_t(count) * channels_);
    std::vector<float> y(bsize);
    for (int c = 0; c < channels_; c++) {
      float* v = res[c].data();
      for (int k = 0; k < half; k++) v[k] *= floor[c][k];
      imdct(flag, v, y.data());
      // the overlap of this block and the last takes the smaller one's slope
      const int small = std::min(flag, prev);
      const int ov = bs_[small] / 2;  // overlap length
      const float* w = slope_[small].data();
      std::vector<float>& sv = saved_[c];  // last block's second half, [0, bs_prev / 2)
      const int prev_half = bs_[prev] / 2;
      // the overlap region: centred at a quarter of each block
      const int p0 = prev_half / 2 - ov / 2;  // in the last block's second half
      const int c0 = half / 2 - ov / 2;       // in this block's first half
      const int oc = channels_ <= 8 ? kOutIndex[channels_ - 1][c] : c;
      if (emit) {  // from the centre of the last block to the centre of this one
        float* o = out.data() + base + oc;
        for (int i = 0; i < p0; i++, o += channels_) *o = sv[i];
        for (int i = 0; i < ov; i++, o += channels_) *o = sv[p0 + i] * w[ov - 1 - i] + y[c0 + i] * w[i];
        for (int i = c0 + ov; i < half; i++, o += channels_) *o = y[i];
      }
      sv.assign(y.begin() + half, y.end());
    }
    prev_flag_ = flag;
    if (!emit) {
      started_ = true;
      return 0;
    }
    return count;
  }

 private:
  // Vorbis channel c -> its place in FFmpeg's layout order
  static constexpr int kOutIndex[8][8] = {
      {0}, {0, 1}, {0, 2, 1}, {0, 1, 2, 3}, {0, 2, 1, 3, 4}, {0, 2, 1, 4, 5, 3},
      {0, 2, 1, 5, 6, 4, 3}, {0, 2, 1, 6, 7, 4, 5, 3}};

  void read_floor(Bits& b, Floor1& f) {
    const int type = b.get(16);
    if (type == 0) throw Unsupported();
    if (type != 1) throw Malformed();
    const int parts = b.get(5);
    f.partition_class.resize(parts);
    int max_class = -1;
    for (auto& c : f.partition_class) {
      c = b.get(4);
      max_class = std::max(max_class, c);
    }
    for (int c = 0; c <= max_class; c++) {
      f.class_dims[c] = int(b.get(3)) + 1;
      f.class_sub[c] = b.get(2);
      f.class_master[c] = f.class_sub[c] ? int(b.get(8)) : -1;
      if (f.class_master[c] >= int(books_.size())) throw Malformed();
      for (int j = 0; j < (1 << f.class_sub[c]); j++) {
        f.sub_books[c][j] = int(b.get(8)) - 1;
        if (f.sub_books[c][j] >= int(books_.size())) throw Malformed();
      }
    }
    f.multiplier = int(b.get(2)) + 1;
    const int rangebits = b.get(4);
    f.x = {0, 1 << rangebits};
    for (int c : f.partition_class)
      for (int j = 0; j < f.class_dims[c]; j++) f.x.push_back(b.get(rangebits));
    const int nx = int(f.x.size());
    if (nx > 65) throw Malformed();
    f.order.resize(nx);
    for (int i = 0; i < nx; i++) f.order[i] = i;
    std::stable_sort(f.order.begin(), f.order.end(),
                     [&f](int a, int c) { return f.x[a] < f.x[c]; });
    for (int i = 1; i < nx; i++)  // X values must differ
      if (f.x[f.order[i]] == f.x[f.order[i - 1]]) throw Malformed();
    f.low.assign(nx, 0);
    f.high.assign(nx, 1);
    for (int i = 2; i < nx; i++) {
      int lo = -1, hi = -1;
      for (int j = 0; j < i; j++) {
        if (f.x[j] < f.x[i] && (lo < 0 || f.x[j] > f.x[lo])) lo = j;
        if (f.x[j] > f.x[i] && (hi < 0 || f.x[j] < f.x[hi])) hi = j;
      }
      if (lo < 0 || hi < 0) throw Malformed();
      f.low[i] = lo;
      f.high[i] = hi;
    }
  }

  void read_residue(Bits& b, Residue& r) {
    r.type = b.get(16);
    if (r.type > 2) throw Malformed();
    r.begin = b.get(24);
    r.end = b.get(24);
    r.partition_size = b.get(24) + 1;
    r.classifications = int(b.get(6)) + 1;
    r.classbook = b.get(8);
    if (r.classbook >= int(books_.size()) || r.begin > r.end) throw Malformed();
    int cascade[64];
    for (int i = 0; i < r.classifications; i++) {
      int lo = b.get(3);
      int hi = b.get(1) ? int(b.get(5)) : 0;
      cascade[i] = hi * 8 + lo;
    }
    for (int i = 0; i < r.classifications; i++)
      for (int j = 0; j < 8; j++) {
        r.books[i][j] = (cascade[i] >> j) & 1 ? int(b.get(8)) : -1;
        if (r.books[i][j] >= int(books_.size())) throw Malformed();
      }
  }

  void read_mapping(Bits& b, Mapping& m) {
    if (b.get(16) != 0) throw Malformed();
    m.submaps = b.get(1) ? int(b.get(4)) + 1 : 1;
    if (b.get(1)) {
      const int steps = int(b.get(8)) + 1;
      const int bits = ilog(uint32_t(channels_ - 1));
      for (int i = 0; i < steps; i++) {
        const int mg = b.get(bits), an = b.get(bits);
        if (mg == an || mg >= channels_ || an >= channels_) throw Malformed();
        m.magnitude.push_back(mg);
        m.angle.push_back(an);
      }
    }
    if (b.get(2) != 0) throw Malformed();
    m.mux.assign(channels_, 0);
    if (m.submaps > 1)
      for (auto& x : m.mux) {
        x = b.get(4);
        if (x >= m.submaps) throw Malformed();
      }
    for (int i = 0; i < m.submaps; i++) {
      b.get(8);
      m.floor[i] = b.get(8);
      m.residue[i] = b.get(8);
      if (m.floor[i] >= int(floors_.size()) || m.residue[i] >= int(residues_.size()))
        throw Malformed();
    }
  }

  static void render_line(int x0, int y0, int x1, int y1, int* v) {
    const int dy = y1 - y0, adx = x1 - x0;
    const int base = dy / adx;
    const int sy = dy < 0 ? base - 1 : base + 1;
    const int ady = std::abs(dy) - std::abs(base) * adx;
    int y = y0, err = 0;
    v[x0] = y;
    for (int x = x0 + 1; x < x1; x++) {
      err += ady;
      if (err >= adx) {
        err -= adx;
        y += sy;
      } else {
        y += base;
      }
      v[x] = y;
    }
  }

  // floor 1 into ``out`` (n values); returns 1 for an unused floor
  int decode_floor(Bits& b, const Floor1& f, float* out, int n) {
    if (!b.get(1)) return 1;
    static const int kRange[4] = {256, 128, 86, 64};
    const int range = kRange[f.multiplier - 1];
    const int nx = int(f.x.size());
    int y[65];
    y[0] = b.get(ilog(uint32_t(range - 1)));
    y[1] = b.get(ilog(uint32_t(range - 1)));
    int off = 2;
    for (int c : f.partition_class) {
      const int cdim = f.class_dims[c], cbits = f.class_sub[c];
      const int csub = (1 << cbits) - 1;
      // a class codeword the book lacks reads as -1 (every subclass the
      // last), a value codeword fails the packet, as in FFmpeg
      int cval = cbits ? books_[f.class_master[c]].decode(b) : 0;
      for (int j = 0; j < cdim; j++) {
        const int book = f.sub_books[c][cval & csub];
        cval >>= cbits;
        int v = 0;
        if (book >= 0) {
          v = books_[book].decode(b);
          if (v < 0) throw Malformed();
        }
        y[off + j] = v;
      }
      off += cdim;
    }
    int fy[65];
    bool used[65];
    used[0] = used[1] = true;
    fy[0] = y[0];
    fy[1] = y[1];
    for (int i = 2; i < nx; i++) {
      const int lo = f.low[i], hi = f.high[i];
      const int dy = fy[hi] - fy[lo], adx = f.x[hi] - f.x[lo];
      const int err = std::abs(dy) * (f.x[i] - f.x[lo]);
      const int predicted = dy < 0 ? fy[lo] - err / adx : fy[lo] + err / adx;
      // the rooms in unsigned arithmetic, as FFmpeg computes them: a
      // prediction above the range (a damaged stream) wraps
      const uint32_t val = uint32_t(y[i]);
      const uint32_t highroom = uint32_t(range - predicted), lowroom = uint32_t(predicted);
      const uint32_t room = (highroom < lowroom ? highroom : lowroom) * 2;
      auto clip16 = [](uint32_t u) {
        const int v = static_cast<int>(u);
        return v < 0 ? 0 : v > 65535 ? 65535 : v;
      };
      const uint32_t p = uint32_t(predicted);
      if (val) {
        used[lo] = used[hi] = used[i] = true;
        if (val >= room)
          fy[i] = clip16(highroom > lowroom ? val - lowroom + p : p - val + highroom - 1);
        else
          fy[i] = clip16(val & 1 ? p - (val + 1) / 2 : p + val / 2);
      } else {
        used[i] = false;
        fy[i] = clip16(predicted);
      }
    }
    // the curve, in dB-table steps, up to X[1]
    const int samples = f.x[1];
    std::vector<int> curve(std::max(samples, n) + 1, 0);
    int lx = 0, ly = fy[0] * f.multiplier;
    for (int i = 1; i < nx; i++) {
      const int p = f.order[i];
      if (used[p]) {
        const int x1 = f.x[p], y1 = fy[p] * f.multiplier;
        if (lx < samples && x1 > lx) render_line(lx, ly, std::min(x1, samples), y1, curve.data());
        lx = x1;
        ly = y1;
      }
      if (lx >= samples) break;
    }
    if (lx < samples) render_line(lx, ly, samples, ly, curve.data());
    const int m = std::min(n, samples);
    for (int i = 0; i < m; i++) {
      const int v = curve[i] < 0 ? 0 : curve[i] > 255 ? 255 : curve[i];
      out[i] = audio_tables::kFloor1InverseDb[v];
    }
    return 0;
  }

  void decode_residue(Bits& b, const Residue& r, std::vector<float*>& vecs,
                      std::vector<char>& skip, int vlen) {
    const int ch = int(vecs.size());
    const Codebook& cb = books_[r.classbook];
    const int cpc = cb.dims;
    if (cpc <= 0) throw Malformed();
    int ch_used = ch;
    std::vector<float> inter;
    // the residue must lie within the block (the interleaved one for type 2)
    if (r.end > uint32_t(r.type == 2 ? vlen * ch : vlen)) throw Malformed();
    int64_t max_output = int64_t(ch - 1) * vlen;
    if (r.type == 2) {
      bool all = true;
      for (char s : skip) all = all && s;
      if (all) return;
      ch_used = 1;
      max_output += r.end / ch;
    } else {
      max_output += r.end;
    }
    const int64_t ptns = (r.end - r.begin) / r.partition_size;
    if (max_output > int64_t(ch) * vlen) throw Malformed();  // a residue past the block
    std::vector<float*> dst = vecs;
    std::vector<char> dnd = skip;
    if (r.type == 2) {
      inter.assign(size_t(vlen) * ch, 0.0f);
      dst = {inter.data()};
      dnd = {0};
    }
    std::vector<int> classes(size_t(ch_used) * std::max<int64_t>(ptns, 0) + cpc, 0);
    int maxpass = -1;
    for (int c = 0; c < r.classifications; c++)
      for (int p = 0; p < 8; p++)
        if (r.books[c][p] >= 0) maxpass = std::max(maxpass, p);
    for (int pass = 0; pass <= maxpass; pass++) {
      int64_t pc = 0;
      uint32_t voffset = r.begin;
      while (pc < ptns) {
        if (pass == 0) {
          for (int j = 0; j < ch_used; j++) {
            if (dnd[j]) continue;
            int temp = cb.decode(b);
            if (temp < 0) throw Malformed();
            for (int64_t i = pc + cpc - 1; i >= pc; i--) {
              const int q = temp / r.classifications;
              if (i < ptns) classes[size_t(j) * ptns + i] = temp - q * r.classifications;
              temp = q;
            }
          }
        }
        for (int i = 0; i < cpc && pc < ptns; i++) {
          for (int j = 0; j < ch_used; j++) {
            if (dnd[j]) continue;
            const int book = r.books[classes[size_t(j) * ptns + pc]][pass];
            if (book < 0 || !books_[book].has_vq) continue;
            const Codebook& vb = books_[book];
            const int dim = vb.dims;
            const uint32_t step = r.partition_size / dim;
            float* v = dst[j];
            if (r.type == 0) {
              for (uint32_t k = 0; k < step; k++) {
                const int e = vb.decode(b);
                if (e < 0) throw Malformed();
                for (int l = 0; l < dim; l++) v[voffset + k + l * step] += vb.vq[size_t(e) * dim + l];
              }
            } else {
              uint32_t o = voffset;
              for (uint32_t k = 0; k < step; k++) {
                const int e = vb.decode(b);
                if (e < 0) throw Malformed();
                for (int l = 0; l < dim; l++, o++) v[o] += vb.vq[size_t(e) * dim + l];
              }
            }
          }
          pc++;
          voffset += r.partition_size;
        }
      }
    }
    if (r.type == 2)
      for (int i = 0; i < vlen; i++)
        for (int c = 0; c < ch; c++) vecs[c][i] = inter[size_t(i) * ch + c];
  }

  // inverse MDCT of n / 2 coefficients to n samples, through a DCT-IV of
  // size n / 2 computed with a complex FFT of size n / 4
  void init_imdct(int k) {
    const int m = bs_[k] / 2, q = m / 2;
    pre_[k].resize(q);
    post_[k].resize(q);
    for (int i = 0; i < q; i++) {
      pre_[k][i] = std::polar(1.0, -kPi * (i + 0.25) / m);
      post_[k][i] = std::polar(1.0, -kPi * i / m);
    }
    tw_[k].resize(q / 2 > 0 ? q / 2 : 1);
    for (int i = 0; i < q / 2; i++) tw_[k][i] = std::polar(1.0, -2 * kPi * i / q);
  }

  void fft(std::vector<std::complex<double>>& a, int k) const {
    const int n = int(a.size());
    for (int i = 1, j = 0; i < n; i++) {
      int bit = n >> 1;
      for (; j & bit; bit >>= 1) j ^= bit;
      j ^= bit;
      if (i < j) std::swap(a[i], a[j]);
    }
    for (int len = 2; len <= n; len <<= 1) {
      const int stride = n / len;
      for (int i = 0; i < n; i += len)
        for (int j = 0; j < len / 2; j++) {
          const std::complex<double> u = a[i + j];
          const std::complex<double> v = a[i + j + len / 2] * tw_[k][size_t(j) * stride];
          a[i + j] = u + v;
          a[i + j + len / 2] = u - v;
        }
    }
  }

  void imdct(int k, const float* x, float* y) const {
    const int n = bs_[k], m = n / 2, q = m / 2;
    std::vector<std::complex<double>> v(q);
    for (int i = 0; i < q; i++) v[i] = std::complex<double>(x[2 * i], x[m - 1 - 2 * i]) * pre_[k][i];
    fft(v, k);
    std::vector<double> u(m);
    for (int i = 0; i < q; i++) {
      const std::complex<double> c = v[i] * post_[k][i];
      u[2 * i] = c.real();
      u[m - 1 - 2 * i] = -c.imag();
    }
    // y[i] = sum_k x[k] cos(2 pi / n (i + 1/2 + n/4)(k + 1/2)), from the DCT-IV u
    for (int i = 0; i < m / 2; i++) y[i] = static_cast<float>(u[i + m / 2]);
    for (int i = m / 2; i < 3 * m / 2; i++) y[i] = static_cast<float>(-u[3 * m / 2 - 1 - i]);
    for (int i = 3 * m / 2; i < n; i++) y[i] = static_cast<float>(-u[i - 3 * m / 2]);
  }

  int channels_ = 0, rate_ = 0, bs_[2] = {0, 0};
  std::vector<Codebook> books_;
  std::vector<Floor1> floors_;
  std::vector<Residue> residues_;
  std::vector<Mapping> mappings_;
  std::vector<Mode> modes_;
  std::vector<float> slope_[2];
  std::vector<std::complex<double>> pre_[2], post_[2], tw_[2];
  std::vector<std::vector<float>> saved_;
  int prev_flag_ = -1;
  bool started_ = false;
};

constexpr int Decoder::kOutIndex[8][8];

}  // namespace

int vorbis_decode(const uint8_t* data, size_t len, Pcm& out) {
  try {
    OggStream os;
    const int rc = ogg_read(data, len, os);
    if (rc != kOk) return rc;
    const auto& pk = os.packets;
    if (pk.size() < 3) return kMalformed;
    const uint8_t* base = os.data.data();
    if (pk[0].size < 7 || std::memcmp(base + pk[0].offset, "\x01vorbis", 7)) return kMalformed;
    Decoder dec;
    dec.ident(base + pk[0].offset, pk[0].size);
    if (pk[1].size < 7 || std::memcmp(base + pk[1].offset, "\x03vorbis", 7)) return kMalformed;
    dec.setup(base + pk[2].offset, pk[2].size);
    const int nch = dec.channels();
    std::vector<float>& pcm = out.samples;
    pcm.clear();
    // FFmpeg's timestamps: each packet lasts (previous + own block size) / 4,
    // the first counted from the short size; the first packet's timestamp
    // is the granule of its page less the durations of the packets that end
    // there, or (where that page ends the stream) that of the header pages
    const size_t first = 3;
    auto duration = [&](size_t i, int& prevbs) {
      const int f = dec.packet_blockflag(base + pk[i].offset, pk[i].size);
      if (f < 0) return int64_t(-1);
      const int bs = dec.blocksize(f);
      const int64_t d = (prevbs + bs) / 4;
      prevbs = bs;
      return d;
    };
    int64_t pts0 = pk[first - 1].granule;
    if (first < pk.size() && !(pk[first].page_flags & 4) && pk[first].granule >= 0) {
      int prevbs = dec.blocksize(0);
      int64_t sum = 0;
      for (size_t i = first; i < pk.size() && pk[i].page == pk[first].page; i++) {
        const int64_t d = duration(i, prevbs);
        if (d < 0) {
          sum = pk[first].granule;
          break;
        }
        sum += d;
      }
      pts0 = pk[first].granule - sum;
      if (pk[first].granule == 0 && sum) pts0 = 0;
    }
    int prevbs = dec.blocksize(0);
    int64_t pts = pts0;
    int64_t final_pts = 0, final_duration = 0;
    bool final_started = false;
    for (size_t i = first; i < pk.size(); i++) {
      const OggPacket& p = pk[i];
      const int64_t d = duration(i, prevbs);
      const size_t before = pcm.size();
      const int64_t got = dec.packet(base + p.offset, p.size, pcm);
      if (p.page_flags & 4) {  // the last page: cut its last packet at its granule
        if (!final_started) {
          final_pts = pk[i - 1].last_on_page ? pk[i - 1].granule : pts;
          final_started = true;
        }
        if (i + 1 == pk.size()) {
          const int64_t skip = final_pts + final_duration + d - p.granule;
          if (skip > 0 && skip <= got) pcm.resize(before + size_t(got - skip) * nch);
        }
        final_duration += d;
      }
      pts += d;
    }
    if (pcm.empty()) return kMalformed;
    out.channels = nch;
    out.rate = dec.rate();
  } catch (const Malformed&) {
    return kMalformed;
  } catch (const Unsupported&) {
    return kUnsupported;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
  return kOk;
}

}  // namespace audio_codecs
