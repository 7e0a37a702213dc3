// Crop + mirror + normalise + HWC->CHW + cast of a uint8 image batch, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dali_tpu/kernels/cmn_pallas.py (cmn_pallas,
// body _kernel) and computes the function of dali_tpu/kernels/cmn.py
// crop_mirror_normalize for uint8 input, no pad policy, CHW output:
//
//   out[n, c, y, x] = in[n, cy + y, cx + col(x), c] * a[c] + b[c]
//   a = scale / std,  b = shift - mean * scale / std      (folded on the host)
//   col(x) = x                          without mirror
//          = vw - 1 - x        (x < vw) with mirror: the VALID width vw is
//          = crop_w - 1 + vw - x (x >= vw) reversed and realigned to column 0
//
// What bounds it on this card: HBM bytes. Each output element costs one byte
// read and four (fp32) or two (fp16) bytes written, against one FMA, so the
// kernel sits far below the H100's ridge point; the only gain is to move each
// byte once. The design answers that:
//  * one thread per output pixel; a warp covers 32 neighbouring columns of one
//    row, so each of the C plane stores is one coalesced 128-byte (fp32)
//    transaction and the 3-byte pixel reads of a warp fall in one or two
//    96-byte spans;
//  * the crop origin, mirror flag and valid width of each sample are read from
//    int32 device arrays, so the window offset is exact: unlike the TPU kernel
//    there is no 8-column alignment slack, no over-read and no epilogue pass;
//  * the HWC->CHW transpose happens in registers on the way out.
// Grid: (column tiles of 32, row tiles of 8, N).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct CmnConsts {
  float a[4];
  float b[4];
};

template <typename OutT>
__device__ __forceinline__ OutT to_out(float v);

template <>
__device__ __forceinline__ float to_out<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __half to_out<__half>(float v) {
  return __float2half_rn(v);
}

template <typename OutT, int C>
__global__ void cmn_u8_chw_kernel(const uint8_t* __restrict__ in,
                                  OutT* __restrict__ out,
                                  const int* __restrict__ crop_y,
                                  const int* __restrict__ crop_x,
                                  const int* __restrict__ mirror,
                                  const int* __restrict__ valid_w,
                                  CmnConsts k, int H, int W, int crop_h,
                                  int crop_w) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  const int n = blockIdx.z;
  if (ox >= crop_w || oy >= crop_h) return;
  int col = ox;
  if (mirror != nullptr && mirror[n] != 0) {
    const int vw = valid_w[n];
    col = ox < vw ? vw - 1 - ox : crop_w - 1 + vw - ox;
  }
  const size_t row = (size_t)n * H + (size_t)(crop_y[n] + oy);
  const uint8_t* src = in + (row * W + (size_t)(crop_x[n] + col)) * C;
  const size_t plane = (size_t)crop_h * crop_w;
  OutT* dst = out + (size_t)n * C * plane + (size_t)oy * crop_w + ox;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    dst[c * plane] = to_out<OutT>(__fmaf_rn((float)src[c], k.a[c], k.b[c]));
  }
}

template <typename OutT>
cudaError_t launch(int C, const uint8_t* in, void* out, const int* crop_y,
                   const int* crop_x, const int* mirror, const int* valid_w,
                   const CmnConsts& k, int n, int H, int W, int crop_h,
                   int crop_w, cudaStream_t stream) {
  const dim3 block(32, 8, 1);
  const dim3 grid((crop_w + 31) / 32, (crop_h + 7) / 8, n);
  OutT* o = static_cast<OutT*>(out);
  switch (C) {
    case 1:
      cmn_u8_chw_kernel<OutT, 1><<<grid, block, 0, stream>>>(
          in, o, crop_y, crop_x, mirror, valid_w, k, H, W, crop_h, crop_w);
      break;
    case 3:
      cmn_u8_chw_kernel<OutT, 3><<<grid, block, 0, stream>>>(
          in, o, crop_y, crop_x, mirror, valid_w, k, H, W, crop_h, crop_w);
      break;
    case 4:
      cmn_u8_chw_kernel<OutT, 4><<<grid, block, 0, stream>>>(
          in, o, crop_y, crop_x, mirror, valid_w, k, H, W, crop_h, crop_w);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched). `mirror` and
// `valid_w` may be null together (no mirroring). a/b are the folded
// per-channel constants, passed by value (C <= 4).
extern "C" int dali_tpu_torch_cmn_u8_chw(
    const uint8_t* in, void* out, const int* crop_y, const int* crop_x,
    const int* mirror, const int* valid_w, int n, int H, int W, int C,
    int crop_h, int crop_w, float a0, float a1, float a2, float a3, float b0,
    float b1, float b2, float b3, int out_fp16, void* stream) {
  if (n <= 0 || crop_h <= 0 || crop_w <= 0) return 0;
  CmnConsts k = {{a0, a1, a2, a3}, {b0, b1, b2, b3}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_fp16 ? launch<__half>(C, in, out, crop_y, crop_x, mirror, valid_w,
                                k, n, H, W, crop_h, crop_w, s)
               : launch<float>(C, in, out, crop_y, crop_x, mirror, valid_w, k,
                               n, H, W, crop_h, crop_w, s);
  return static_cast<int>(err);
}
