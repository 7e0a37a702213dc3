// Internal interface between the WebP decoder's parts: the VP8 key-frame
// decoder (webp_vp8.cc), the VP8L lossless decoder (webp_vp8l.cc) and the
// RIFF container with the colour conversion (webp_decode.cc).

#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace dali_webp {

// A decoded VP8 frame cropped to its size: Y [h, w], U and V
// [(h + 1) / 2, (w + 1) / 2], rows contiguous.
struct Yuv {
  int w = 0, h = 0;
  std::vector<uint8_t> y, u, v;
};

// The frame size from the 10-byte key-frame header; false if it is not one.
bool vp8_size(const uint8_t* data, size_t len, int* w, int* h);

// Decode a VP8 key frame (the payload of a ``VP8 `` chunk). 0, or -1 for a
// stream libwebp rejects.
int vp8_decode(const uint8_t* data, size_t len, Yuv* out);

// The image size from the 5-byte VP8L header; false if it is not one.
bool vp8l_size(const uint8_t* data, size_t len, int* w, int* h);

// Decode a VP8L stream (the payload of a ``VP8L`` chunk) to ARGB, one
// uint32 per pixel (alpha << 24 | red << 16 | green << 8 | blue). 0, or -1
// for a stream libwebp rejects.
int vp8l_decode(const uint8_t* data, size_t len, int* w, int* h, std::vector<uint32_t>* argb);

// Decode the lossless stream of an ``ALPH`` chunk (no VP8L header; the
// frame's ``w`` x ``h``) to its alpha values, filter not undone. 0, or -1
// for a stream libwebp rejects.
int vp8l_decode_alpha(const uint8_t* data, size_t len, int w, int h, std::vector<uint8_t>* alpha);

}  // namespace dali_webp
