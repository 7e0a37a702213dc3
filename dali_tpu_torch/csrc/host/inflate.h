// Interface of inflate.cc, the zlib-stream decoder of tiff_decode.cc's
// Deflate strips and tiles.

#pragma once

#include <cstddef>
#include <cstdint>

namespace dali_inflate {

// Results of ``inflate_zlib``.
enum Status { kEnd = 0, kFull = 1, kInput = 2, kError = -1 };

// Inflate the zlib stream ``src[0, n)`` into ``dst[0, cap)``. ``*written``:
// the bytes written, kept when the stream fails. Returns kEnd (the stream
// ended and its Adler-32 matched), kFull (the buffer is full and nothing
// failed before the next symbol to write), kInput (the input ended first) or
// kError (zlib's Z_DATA_ERROR, or a preset dictionary).
int inflate_zlib(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, size_t* written);

}  // namespace dali_inflate
