// Full-precision coefficient read of a JPEG stream (jpeg_huff.cc), shared by
// the int16 coefficient wire (coefficient batch entry in jpeg_huff.cc) and
// the pixel decoder (jpeg_decode.cc). libjpeg-free.
#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace dali_tpu_torch {

// The colour space libjpeg infers from the frame (jdapimin.c
// default_decompress_parms): its component count, JFIF/Adobe markers and
// component ids.
enum JpegColor { kGray, kYCbCr, kRGB, kCMYK, kYCCK, kUnknown };

struct JpegFull {
  int H = 0, W = 0;   // image size
  int ncomp = 0;      // 1 to 4
  int color = kGray;  // JpegColor
  int hmax = 1, vmax = 1;
  bool progressive = false;
  int h[4] = {1, 1, 1, 1}, v[4] = {1, 1, 1, 1};  // sampling factors
  int bh[4] = {0, 0, 0, 0}, bw[4] = {0, 0, 0, 0};  // blocks: libjpeg's height/width_in_blocks
  uint16_t q[4][64];  // quantisation table of each component, natural order
  std::vector<short> coef[4];  // [bh][bw][64] quantised coefficients, natural order
  // Progressive streams: libjpeg's progression status of coefficients 0-9
  // of each component after the last scan (cinfo->coef_bits: -1 unknown,
  // else the point transform Al of the last scan that coded it), the same
  // before the last scan that touched the component, the number of scans
  // started, and the last iMCU row decoded before the data ran out
  // (master->last_good_iMCU_row). They drive block smoothing.
  int coef_bits[4][10], prev_bits[4][10];
  int nscans = 0;
  int last_good_row = 0;
  // The EOI marker was reached. A stream without it makes a suspending
  // data source (OpenCV's) fail where libjpeg's memory source inserts one.
  bool eoi = false;

  // The forms the coefficient wires carry: grayscale, or YCbCr with 1x1
  // chroma and luma at 1x1, 2x1, 1x2 or 2x2.
  bool wire_form() const {
    if (ncomp == 1) return true;
    if (ncomp != 3 || color != kYCbCr) return false;
    for (int i = 1; i < 3; i++)
      if (h[i] != 1 || v[i] != 1) return false;
    return h[0] <= 2 && v[0] <= 2;
  }
};

// Entropy-decode every coefficient of every component: baseline and
// extended-sequential (interleaved, partly interleaved or one scan per
// component) and progressive 8-bit streams of 1 to 4 components, Huffman
// or arithmetic coded, any sampling factors from 1 to 4, restart markers
// included. A Huffman stream that ends early keeps libjpeg's zero fill; an
// arithmetic one decodes on from zero bytes, as libjpeg does. Returns 0; 1
// for a stream this reader does not take (12-bit, lossless or hierarchical
// coding, DNL); -1 for a corrupt header.
int jpeg_read_full(const uint8_t* data, size_t len, JpegFull* out);

// The frame header only (through the first SOS): image size, component
// count, colour space and sampling factors (out->coef stays empty). Same
// return codes.
int jpeg_read_header(const uint8_t* data, size_t len, JpegFull* out);

// The pixels of f's coefficients at 1/denom scale (jpeg_decode.cc), into a
// strided destination of ceil(H/denom) x ceil(W/denom) pixels: RGB, or one
// byte a pixel with gray. Returns 0 for libjpeg's output, 2 for the cv2
// route (CMYK and YCCK), -1 where libjpeg or cv2 fails.
int jpeg_decode_pixels(const JpegFull& f, int denom, unsigned char* dst, long dst_stride,
                       int fancy, int gray);

// One arithmetic-coded scan (jpeg_arith.cc): its header and the
// conditioning of its statistics (DAC; libjpeg's defaults L=0, U=1, Kx=5).
struct ArithScan {
  int ns = 0;                 // components in the scan
  int td[4], ta[4];           // DC and AC conditioning table of each slot
  int ss = 0, se = 63, ah = 0, al = 0;
  int ri = 0;                 // restart interval in MCUs
  bool progressive = false;
  const uint8_t* dc_l;        // [16] DC lower bound L
  const uint8_t* dc_u;        // [16] DC upper bound U
  const uint8_t* ac_k;        // [16] AC split Kx
};

// Where a scan slot's blocks go: block (r, c) of the component at coef +
// (r * stride + c) * 64 when r < rows and c < stride (else decoded and
// dropped); natural coefficient order for sequential scans, zigzag for
// progressive ones. h, v are the sampling factors, bw x bh the component's
// own block grid (a single-component scan's MCUs).
struct ArithPlane {
  short* coef;
  int stride, rows;
  int h, v, bw, bh;
};

// Decode one scan whose entropy data starts at scan_start. Returns the
// position the marker search goes on from: the unread marker that stopped
// the data, or the first byte not read.
const uint8_t* arith_decode_scan(const uint8_t* data, size_t len, const uint8_t* scan_start,
                                 const ArithScan& s, const ArithPlane* planes, int mcus_x,
                                 int mcus_y);

}  // namespace dali_tpu_torch
