// Full-precision coefficient read of a JPEG stream (jpeg_huff.cc), shared by
// the int16 coefficient wire (coefficient batch entry in jpeg_huff.cc) and
// the pixel decoder (jpeg_decode.cc). libjpeg-free.
#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace dali_tpu_torch {

struct JpegFull {
  int H = 0, W = 0;   // image size
  int ncomp = 0;      // 1 (grayscale) or 3 (YCbCr)
  int hmax = 1, vmax = 1;
  bool progressive = false;
  int h[3] = {1, 1, 1}, v[3] = {1, 1, 1};  // sampling factors
  int bh[3] = {0, 0, 0}, bw[3] = {0, 0, 0};  // blocks: libjpeg's height/width_in_blocks
  uint16_t q[3][64];  // quantisation table of each component, natural order
  std::vector<short> coef[3];  // [bh][bw][64] quantised coefficients, natural order
};

// Entropy-decode every coefficient of every component: baseline and
// extended-sequential (interleaved or one scan per component) and
// progressive 8-bit Huffman streams, restart markers included. A stream that
// ends early keeps libjpeg's zero fill. Returns 0; 1 for a stream this reader
// does not take (12-bit, arithmetic or lossless coding, CMYK/YCCK, RGB
// colour, sampling other than 4:4:4, 4:2:2, 4:2:0 or 4:4:0, DNL); -1 for a
// corrupt header.
int jpeg_read_full(const uint8_t* data, size_t len, JpegFull* out);

// The frame header only (through the first SOS): image size, component
// count and sampling factors (out->coef stays empty). Same return codes.
int jpeg_read_header(const uint8_t* data, size_t len, JpegFull* out);

}  // namespace dali_tpu_torch
