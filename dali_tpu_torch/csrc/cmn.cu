// Crop + mirror + normalise + layout + cast of an image batch, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel dali_tpu/kernels/cmn_pallas.py (cmn_pallas,
// body _kernel) and computes the whole 2-D function of dali_tpu/kernels/cmn.py
// crop_mirror_normalize: uint8, float16 or float32 input with 1-4 channels;
// float32, float16, uint8, int8, int16 or int32 output, CHW or HWC;
// pad_output; the pad policy. Volumes and sequences fold their depth or
// frames into the batch before the launch (kernels/cmn.py).
//
//   out[n, y, x, c] = in[n, cy + y, cx + col(x), c] * a[c] + b[c]
//                   = fill[c]  under the pad policy, for a source pixel
//                              outside [0, ext_h) x [0, ext_w)
//                   = 0        for c >= C (the pad_output channels)
//   a = scale / std,  b = shift - mean * scale / std      (folded on the host)
//   x * a + b is a product and a sum, each rounded (no FMA): the reference's
//   and the plain version's order, so an integer output truncates the same
//   value. Integer outputs convert as XLA's convert does: toward zero,
//   saturated to the type's range, NaN to 0.
//   col(x) = x                          without mirror
//          = vw - 1 - x        (x < vw) with mirror: the first vw columns
//          = crop_w - 1 + vw - x (x >= vw) reverse among themselves, the rest too
//   vw = clip(ext_w - crop_x, 0, crop_w), origins clamped into the canvas,
//   without the pad policy; vw = crop_w (the whole window), origins as given,
//   with it.
//
// What bounds it on this card: HBM bytes. Each output element costs 1-4
// bytes read and 1-4 bytes written against a multiply and an add, far
// below the H100's ridge point. The first version of this kernel ran one thread per output
// pixel: C one-byte loads and C four-byte stores a thread, 64-bit index
// arithmetic and the per-sample scalars re-read by every thread, about 30
// instructions for 15 bytes. This one moves each byte once with few
// instructions and transactions per byte:
//  * one block per (sample, band of output rows), 2048-4096 output pixels,
//    on a 1-D grid (no cap on the batch). The block reads the sample's
//    origin, mirror flag and extents once, clamps the origin and derives the
//    valid width itself, so the wrapper launches nothing else;
//  * the band's window rows are staged in shared memory with 16-byte
//    cp.async loads from a 16-byte-aligned-down start (cx * C bytes is
//    rarely aligned); the partial chunks at the two ends of a row are copied
//    byte by byte, so no byte outside the window is read from HBM. Under the
//    pad policy only the in-extent columns are staged, the rest take fill;
//  * the mirror is a reversed index into the staged row, with no extra pass:
//    each block maps its output columns to source offsets in the staged row
//    once (-1 outside the extent), so a pixel costs two shared loads, an add
//    and its channels' loads and FMAs; the channel count is a template
//    parameter;
//  * the band's output is one contiguous run per CHW plane (one run in HWC).
//    A thread takes a group of pixels, computes each pixel's address in the
//    staged row once and all its channels from it, and writes 16-byte
//    streaming stores (st.global.cs): 4 float32, 8 float16 or 4-16
//    integers per plane in CHW (integers packed into words as they are
//    computed, which keeps registers and occupancy as float16's), whole
//    4-channel pixels in HWC, with a scalar head and tail where a
//    run does not start or end on 16 bytes. Forms whose runs do not line up
//    that way (CHW planes that are not a multiple of 16 bytes, HWC with 1-3
//    channels) go element by element, still with 16-byte stores;
//  * quotients by crop_w, the channel count, the band count and the chunks
//    of a staged row are a multiply and a shift.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 64;           // output rows of one band
constexpr int kMinPixels = 2048;       // output pixels a block takes at least
constexpr int kHeaderBytes = 4 * kMaxRows;  // the staged rows' offsets
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemMax = 227 * 1024;

// n / d for 0 <= n < 2^31 as a multiply and a shift:
// mul = ceil(2^p / d), p = 31 + ceil(log2 d).
struct FastDiv {
  unsigned d, mul, shr;
};

FastDiv make_div(unsigned d) {
  FastDiv f = {d, 0u, 0u};
  if (d > 1) {
    unsigned l = 0;
    while ((1ull << l) < d) ++l;
    const unsigned p = 31 + l;
    f.mul = static_cast<unsigned>(((1ull << p) + d - 1) / d);
    f.shr = p - 32;
  }
  return f;
}

__device__ __forceinline__ int quot(const FastDiv& f, int n) {
  return f.d == 1 ? n
                  : static_cast<int>(__umulhi(static_cast<unsigned>(n), f.mul) >> f.shr);
}

struct Params {
  const uint8_t* in;  // [n_in, H, W, C] elements of the input type
  const int* src;     // null: output sample n reads input sample n; else src[n]
  void* out;          // [n, c_out, crop_h, crop_w] or [n, crop_h, crop_w, c_out]
  const int* crop_y;
  const int* crop_x;
  const int* mirror;  // null: no mirroring
  const int* ext_h;   // null: the canvas height
  const int* ext_w;   // null: the canvas width
  int H, W, C, crop_h, crop_w, c_out;
  int rows;        // output rows of one band
  int bands;       // bands of one sample
  int row_stride;      // bytes of one staged window row, a multiple of 16
  int col_bytes;       // bytes of the column offsets, a multiple of 16
  int pad;             // the pad policy
  int planes_aligned;  // CHW planes are a multiple of 16 bytes
  FastDiv div_w, div_c, div_bands, div_chunks;
  float consts[12];  // a[4], b[4], fill[4]
};

__device__ __forceinline__ float to_float(uint8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T>
struct IntRange;
template <>
struct IntRange<uint8_t> {
  static constexpr int lo = 0, hi = 255;
};
template <>
struct IntRange<int8_t> {
  static constexpr int lo = -128, hi = 127;
};
template <>
struct IntRange<int16_t> {
  static constexpr int lo = -32768, hi = 32767;
};
template <>
struct IntRange<int32_t> {
  static constexpr int lo = INT_MIN, hi = INT_MAX;
};

// Integer outputs: 16 bytes of converted values a vector store.
template <typename OutT>
struct Store {
  static_assert(std::is_integral<OutT>::value, "integer output");
  static constexpr int kVec = 16 / static_cast<int>(sizeof(OutT));
  static __device__ __forceinline__ OutT cvt(float v) {
    // __float2int_rz truncates and saturates to int32; narrower types clamp
    const int t = v != v ? 0 : __float2int_rz(v);
    return static_cast<OutT>(min(max(t, IntRange<OutT>::lo), IntRange<OutT>::hi));
  }
  // the converted value's bits in the low bytes of a word
  static __device__ __forceinline__ unsigned bits(float v) {
    return static_cast<unsigned>(static_cast<typename std::make_unsigned<OutT>::type>(cvt(v)));
  }
  static __device__ __forceinline__ void vec(OutT* p, const float (&v)[kVec]) {
    constexpr int per = 4 / static_cast<int>(sizeof(OutT));
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned x = 0;
#pragma unroll
      for (int k = 0; k < per; ++k) x |= bits(v[i * per + k]) << (8 * sizeof(OutT) * k);
      w[i] = x;
    }
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
  static __device__ __forceinline__ void one(OutT* p, float v) { *p = cvt(v); }
};

template <>
struct Store<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void vec(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
  static __device__ __forceinline__ void one(float* p, float v) { __stcs(p, v); }
};

template <>
struct Store<__half> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ unsigned bits(float v) {
    return static_cast<unsigned>(__half_as_ushort(__float2half_rn(v)));
  }
  static __device__ __forceinline__ void vec(__half* p, const float (&v)[8]) {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(bits(v[0]) | bits(v[1]) << 16, bits(v[2]) | bits(v[3]) << 16,
                      bits(v[4]) | bits(v[5]) << 16, bits(v[6]) | bits(v[7]) << 16));
  }
  static __device__ __forceinline__ void one(__half* p, float v) {
    __stcs(reinterpret_cast<unsigned short*>(p), __half_as_ushort(__float2half_rn(v)));
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename InT, typename OutT, bool kHWC, int kC>
__global__ void __launch_bounds__(kThreads) cmn_kernel(const Params p) {
  // offset of each band row's source row in `stage`, of each output
  // column's source pixel in a staged row; -1: none (fill)
  extern __shared__ __align__(16) uint8_t smem[];
  int* row_off = reinterpret_cast<int*>(smem);
  int* col_off = reinterpret_cast<int*>(smem + kHeaderBytes);
  uint8_t* stage = smem + kHeaderBytes + p.col_bytes;

  const int tile = blockIdx.x;
  const int n = quot(p.div_bands, tile);
  const int y0 = (tile - n * p.bands) * p.rows;
  const int nrows = min(p.rows, p.crop_h - y0);

  // The sample's window, once per block: origin (cy, cx), mirrored width
  // vw, and the source rows [0, row_end) and columns [cs, ce) that are read.
  const int oy = p.crop_y[n], ox = p.crop_x[n];
  const int eh = p.ext_h ? min(p.ext_h[n], p.H) : p.H;
  const int ew = p.ext_w ? min(p.ext_w[n], p.W) : p.W;
  const bool mirror = p.mirror != nullptr && p.mirror[n] != 0;
  int cy, cx, vw, row_end, cs, ce;
  if (p.pad) {
    cy = oy;
    cx = ox;
    vw = p.crop_w;
    row_end = eh;
    cs = max(ox, 0);
    ce = min(ox + p.crop_w, ew);
  } else {
    cy = min(max(oy, 0), p.H - p.crop_h);
    cx = min(max(ox, 0), p.W - p.crop_w);
    vw = min(max(ew - ox, 0), p.crop_w);
    row_end = p.H;
    cs = cx;
    ce = cx + p.crop_w;
  }
  constexpr int pix = kC * static_cast<int>(sizeof(InT));
  const int span = max(ce - cs, 0) * pix;  // bytes staged of each source row
  const size_t n_in = p.src ? p.src[n] : n;
  const uintptr_t src0 =
      reinterpret_cast<uintptr_t>(p.in) + (n_in * p.H * p.W + cs) * pix;
  const size_t src_row = static_cast<size_t>(p.W) * pix;

  for (int r = threadIdx.x; r < nrows; r += kThreads) {
    const int sy = cy + y0 + r;
    row_off[r] = sy >= 0 && sy < row_end && span > 0
                     ? r * p.row_stride + static_cast<int>((src0 + sy * src_row) & 15)
                     : -1;
  }
  for (int x = threadIdx.x; x < p.crop_w; x += kThreads) {
    const int sx = cx + (mirror ? (x < vw ? vw - 1 - x : p.crop_w - 1 + vw - x) : x);
    col_off[x] = sx >= cs && sx < ce ? (sx - cs) * pix : -1;
  }
  const int chunks = p.row_stride / 16;
  for (int t = threadIdx.x; t < nrows * chunks; t += kThreads) {
    const int r = quot(p.div_chunks, t);
    const int q = t - r * chunks;
    const int sy = cy + y0 + r;
    if (sy < 0 || sy >= row_end || span == 0) continue;
    const uintptr_t lo = src0 + sy * src_row, hi = lo + span;
    const uintptr_t c0 = (lo & ~uintptr_t(15)) + 16 * q;
    if (c0 >= hi) continue;
    uint8_t* dst = stage + r * p.row_stride + 16 * q;
    if (c0 >= lo && c0 + 16 <= hi) {
      cp_async16(dst, reinterpret_cast<const void*>(c0));
    } else {
      for (int b = 0; b < 16; ++b) {
        if (c0 + b >= lo && c0 + b < hi) dst[b] = *reinterpret_cast<const uint8_t*>(c0 + b);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // All channels of output pixel (band row y, column x): the normalised
  // source pixel, fill outside the extent (pad policy), 0 past C.
  auto pixel = [&](int y, int x, float* v) {
    const int off = row_off[y], co = col_off[x];
    const bool valid = (off | co) >= 0;
    const InT* src = reinterpret_cast<const InT*>(stage + (valid ? off + co : 0));
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      v[c] = valid ? __fadd_rn(__fmul_rn(to_float(src[c]), p.consts[c]), p.consts[4 + c])
                    : p.consts[8 + c];
    }
#pragma unroll
    for (int c = kC; c < 4; ++c) v[c] = 0.f;
  };

  constexpr int V = Store<OutT>::kVec;
  OutT* out = static_cast<OutT*>(p.out);
  const int npx = nrows * p.crop_w;  // output pixels of the band
  // the band's first output element (of plane 0 in CHW), and the elements
  // before its first 16-byte boundary
  OutT* run = out + (kHWC ? (static_cast<size_t>(n) * p.crop_h + y0) * p.crop_w * p.c_out
                          : (static_cast<size_t>(n) * p.c_out * p.crop_h + y0) * p.crop_w);
  const int lead =
      static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(run) & 15)) & 15) / sizeof(OutT));
  const size_t plane = static_cast<size_t>(p.crop_h) * p.crop_w;

  if (kHWC ? p.c_out == 4 && lead % 4 == 0 : p.planes_aligned) {
    // Groups of G pixels: one 16-byte store per plane (CHW, every plane on
    // the same alignment) or one store of whole 4-channel pixels (HWC).
    constexpr int G = kHWC ? V / 4 : V;
    const int head = min(npx, kHWC ? lead / 4 : lead);
    const int ngroups = (npx - head) / G;
    const int tail = head + ngroups * G;
    for (int g = threadIdx.x; g < ngroups; g += kThreads) {
      const int e = head + g * G;
      int y = quot(p.div_w, e), x = e - y * p.crop_w;
      if constexpr (!kHWC && std::is_integral<OutT>::value) {
        // CHW integers: up to 16 pixels a group, each converted and packed
        // into its plane's four words as it is computed (16 x 4 floats
        // held to the store would cost occupancy)
        constexpr int per = 4 / static_cast<int>(sizeof(OutT));
        unsigned words[4][4] = {};
#pragma unroll
        for (int i = 0; i < G; ++i) {
          float v[4];
          pixel(y, x, v);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            words[c][i / per] |= Store<OutT>::bits(v[c]) << (8 * sizeof(OutT) * (i % per));
          }
          if (++x == p.crop_w) {
            x = 0;
            ++y;
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c < p.c_out) {
            __stcs(reinterpret_cast<uint4*>(run + c * plane + e),
                   make_uint4(words[c][0], words[c][1], words[c][2], words[c][3]));
          }
        }
        continue;
      }
      float v[G][4];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        pixel(y, x, v[i]);
        if (++x == p.crop_w) {
          x = 0;
          ++y;
        }
      }
      if constexpr (kHWC) {
        Store<OutT>::vec(run + 4 * e, reinterpret_cast<const float(&)[V]>(v));
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c < p.c_out) {
            float w[V];
#pragma unroll
            for (int i = 0; i < V; ++i) w[i] = v[i][c];
            Store<OutT>::vec(run + c * plane + e, w);
          }
        }
      }
    }
    for (int s = threadIdx.x; s < head + npx - tail; s += kThreads) {
      const int e = s < head ? s : tail + s - head;
      const int y = quot(p.div_w, e);
      float v[4];
      pixel(y, e - y * p.crop_w, v);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c < p.c_out) Store<OutT>::one(kHWC ? run + 4 * e + c : run + c * plane + e, v[c]);
      }
    }
  } else {
    // Any other form (planes off the 16-byte grid, HWC with 1-3 channels):
    // element by element, still 16-byte stores inside each run.
    auto element = [&](int e, int pl) -> float {
      int px = e, c = pl;
      if (kHWC) {
        px = quot(p.div_c, e);
        c = e - px * p.c_out;
      }
      const int y = quot(p.div_w, px);
      float v[4];
      pixel(y, px - y * p.crop_w, v);
      return c == 0 ? v[0] : c == 1 ? v[1] : c == 2 ? v[2] : v[3];
    };
    const int len = kHWC ? npx * p.c_out : npx;
    for (int pl = 0; pl < (kHWC ? 1 : p.c_out); ++pl) {
      OutT* r = run + pl * plane;
      const int head = min(len, static_cast<int>(
                                    ((16 - (reinterpret_cast<uintptr_t>(r) & 15)) & 15) /
                                    sizeof(OutT)));
      const int nvec = (len - head) / V;
      const int tail = head + nvec * V;
      for (int g = threadIdx.x; g < nvec; g += kThreads) {
        const int e = head + g * V;
        float w[V];
#pragma unroll
        for (int i = 0; i < V; ++i) w[i] = element(e + i, pl);
        Store<OutT>::vec(r + e, w);
      }
      for (int s = threadIdx.x; s < head + len - tail; s += kThreads) {
        const int e = s < head ? s : tail + s - head;
        Store<OutT>::one(r + e, element(e, pl));
      }
    }
  }
}

template <typename InT, typename OutT, bool kHWC, int kC>
cudaError_t launch(const Params& p, int tiles, int smem, cudaStream_t stream) {
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        cmn_kernel<InT, OutT, kHWC, kC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  cmn_kernel<InT, OutT, kHWC, kC><<<tiles, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename InT, typename OutT, bool kHWC>
cudaError_t launch_c(const Params& p, int tiles, int smem, cudaStream_t stream) {
  switch (p.C) {
    case 1:
      return launch<InT, OutT, kHWC, 1>(p, tiles, smem, stream);
    case 2:
      return launch<InT, OutT, kHWC, 2>(p, tiles, smem, stream);
    case 3:
      return launch<InT, OutT, kHWC, 3>(p, tiles, smem, stream);
    default:
      return launch<InT, OutT, kHWC, 4>(p, tiles, smem, stream);
  }
}

template <typename InT, typename OutT>
cudaError_t launch_layout(const Params& p, int hwc, int tiles, int smem, cudaStream_t stream) {
  return hwc ? launch_c<InT, OutT, true>(p, tiles, smem, stream)
             : launch_c<InT, OutT, false>(p, tiles, smem, stream);
}

template <typename InT>
cudaError_t launch_in(const Params& p, int out_type, int hwc, int tiles, int smem,
                      cudaStream_t stream) {
  switch (out_type) {
    case 0:
      return launch_layout<InT, float>(p, hwc, tiles, smem, stream);
    case 1:
      return launch_layout<InT, __half>(p, hwc, tiles, smem, stream);
    case 2:
      return launch_layout<InT, uint8_t>(p, hwc, tiles, smem, stream);
    case 3:
      return launch_layout<InT, int8_t>(p, hwc, tiles, smem, stream);
    case 4:
      return launch_layout<InT, int16_t>(p, hwc, tiles, smem, stream);
    default:
      return launch_layout<InT, int32_t>(p, hwc, tiles, smem, stream);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched, or nothing to do).
// n is the number of output samples; `src_index` (may be null) gives, for
// each, the input sample it reads: a volume's depth window or a sequence's
// frames, folded into the batch without a copy.
// in_dtype: 0 uint8, 1 float16, 2 float32; out_type: 0 float32, 1 float16,
// 2 uint8, 3 int8, 4 int16, 5 int32. `mirror`, `ext_h` and `ext_w`
// may be null. `consts` is a host array of 12 floats: a[4], b[4], fill[4]
// (the folded constants and the pad policy's output values, zero-padded
// past C). c_out is C, or 4 with pad_output.
extern "C" int dali_tpu_torch_cmn(const void* in, const int* src_index, void* out,
                                  const int* crop_y, const int* crop_x, const int* mirror,
                                  const int* ext_h, const int* ext_w, int n, int H, int W, int C,
                                  int crop_h, int crop_w, int c_out, int in_dtype, int out_type,
                                  int hwc, int pad_policy, const float* consts, void* stream) {
  if (n <= 0 || crop_h <= 0 || crop_w <= 0) return 0;
  if (C < 1 || C > 4 || c_out < C || c_out > 4 || in_dtype < 0 || in_dtype > 2 ||
      out_type < 0 || out_type > 5 ||
      (!pad_policy && (crop_h > H || crop_w > W))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const int kInSize[3] = {1, 2, 4};
  static const int kOutSize[6] = {4, 2, 1, 1, 2, 4};
  const int out_size = kOutSize[out_type];
  const long long stride =
      16 * ((static_cast<long long>(crop_w) * C * kInSize[in_dtype] + 15) / 16 + 1);
  // A block takes at least two store groups a thread (a group is the pixels
  // of one 16-byte store per plane: 16 / the output's size in CHW, a quarter
  // of that in HWC) and at least kMinPixels. On [256, 224, 224, 3] (NVIDIA
  // H100 80GB HBM3, 700 W; PERF.md) fewer pixels or more threads a block
  // measured slower, and f16 CHW took 11% less time with 4096 pixels than
  // with 2048.
  const int group = hwc ? std::max(1, 4 / out_size) : 16 / out_size;
  // one-byte outputs take one group a thread (16 pixels in CHW)
  const int pixels = std::max(kMinPixels, (out_size == 1 ? 1 : 2) * kThreads * group);
  int rows = std::max(1, std::min(std::min(crop_h, kMaxRows), pixels / crop_w));
  const long long col_bytes = 16 * ((4LL * crop_w + 15) / 16);
  while (rows > 1 && kHeaderBytes + col_bytes + rows * stride > kSmemDefault) --rows;
  const long long smem = kHeaderBytes + col_bytes + rows * stride;
  const long long bands = (crop_h + rows - 1) / rows;
  const long long tiles = static_cast<long long>(n) * bands;
  if (smem > kSmemMax || tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);

  Params p;
  p.in = static_cast<const uint8_t*>(in);
  p.src = src_index;
  p.out = out;
  p.crop_y = crop_y;
  p.crop_x = crop_x;
  p.mirror = mirror;
  p.ext_h = ext_h;
  p.ext_w = ext_w;
  p.H = H;
  p.W = W;
  p.C = C;
  p.crop_h = crop_h;
  p.crop_w = crop_w;
  p.c_out = c_out;
  p.rows = rows;
  p.bands = static_cast<int>(bands);
  p.row_stride = static_cast<int>(stride);
  p.col_bytes = static_cast<int>(col_bytes);
  p.pad = pad_policy != 0;
  p.planes_aligned = static_cast<long long>(crop_h) * crop_w * out_size % 16 == 0;
  p.div_w = make_div(crop_w);
  p.div_c = make_div(c_out);
  p.div_bands = make_div(p.bands);
  p.div_chunks = make_div(p.row_stride / 16);
  for (int i = 0; i < 12; ++i) p.consts[i] = consts[i];

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int t = static_cast<int>(tiles), sm = static_cast<int>(smem);
  cudaError_t err;
  switch (in_dtype) {
    case 0:
      err = launch_in<uint8_t>(p, out_type, hwc, t, sm, s);
      break;
    case 1:
      err = launch_in<__half>(p, out_type, hwc, t, sm, s);
      break;
    default:
      err = launch_in<float>(p, out_type, hwc, t, sm, s);
      break;
  }
  return static_cast<int>(err);
}
