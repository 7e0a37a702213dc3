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
// component) and progressive 8-bit Huffman streams of 1 to 4 components,
// any sampling factors from 1 to 4, restart markers included. A stream that
// ends early keeps libjpeg's zero fill. Returns 0; 1 for a stream this reader
// does not take (12-bit, arithmetic or lossless coding, DNL); -1 for a
// corrupt header.
int jpeg_read_full(const uint8_t* data, size_t len, JpegFull* out);

// The frame header only (through the first SOS): image size, component
// count, colour space and sampling factors (out->coef stays empty). Same
// return codes.
int jpeg_read_header(const uint8_t* data, size_t len, JpegFull* out);

}  // namespace dali_tpu_torch
