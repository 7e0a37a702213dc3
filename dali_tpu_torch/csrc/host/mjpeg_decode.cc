// Motion JPEG frames as FFmpeg 5.1's ``mjpeg`` decoder gives them: the
// planes of a 4:2:0, 4:2:2 or 4:4:4 frame, not upsampled (yuvj420p,
// yuvj422p, yuvj444p: full range), or one grey plane (gray).
//
// The entropy decode is the port's own JPEG reader (jpeg_huff.cc,
// ``jpeg_read_full``); dequantisation and the inverse DCT follow
// mjpegdec.c's ``decode_block`` and the IDCT ``ff_idctdsp_init`` selects on
// x86-64, not libjpeg-turbo's:
//   * the DC coefficient is the quantised DC times its quantiser plus the
//     level shift of 1024, clipped to int16; an AC coefficient is its level
//     times its quantiser, wrapped to int16 (no clamp);
//   * the inverse DCT is FFmpeg's simple IDCT (mpeg4_decode.cc), put into
//     the plane with saturation.
// A frame without Huffman or quantisation tables (AVI1 MJPEG commonly
// omits DHT) takes those of the last frame that had them, else the
// default tables of ITU-T T.81 Annex K.3, as FFmpeg's decoder keeps them.
// Interlaced two-field frames (a frame under 3/4 of the container's
// height) and other samplings (4:1:1, 4:4:0, ...) are left to item 8b.

#include <cstring>
#include <string>
#include <vector>

#include "jpeg_full.h"
#include "video.h"

namespace video {
namespace {

// DHT segment body: DC 0, DC 1, AC 0, AC 1 of ITU-T T.81 K.3
const uint8_t kDefaultDht[] = {
    0x00, 0x00, 0x01, 0x05, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a, 0x0b, 0x01,
    0x00, 0x03, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a, 0x0b, 0x10, 0x00,
    0x02, 0x01, 0x03, 0x03, 0x02, 0x04, 0x03, 0x05, 0x05, 0x04, 0x04, 0x00, 0x00, 0x01, 0x7d,
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa, 0x11, 0x00, 0x02,
    0x01, 0x02, 0x04, 0x04, 0x03, 0x04, 0x07, 0x05, 0x04, 0x04, 0x00, 0x01, 0x02, 0x77, 0x00,
    0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52,
    0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19,
    0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82,
    0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5,
    0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2,
    0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

inline int16_t clip_int16(int v) { return int16_t(v < -32768 ? -32768 : (v > 32767 ? 32767 : v)); }

// marker segments of one kind before the first SOS, concatenated with
// their markers and lengths
std::vector<uint8_t> segments(const uint8_t* p, size_t n, uint8_t kind) {
  std::vector<uint8_t> out;
  size_t i = 2;
  while (i + 4 <= n) {
    if (p[i] != 0xff) {
      i++;
      continue;
    }
    uint8_t m = p[i + 1];
    if (m == 0xff || m == 0x01 || (m >= 0xd0 && m <= 0xd8)) {
      i += m == 0xff ? 1 : 2;
      continue;
    }
    if (m == 0xda || m == 0xd9) break;
    size_t len = (size_t(p[i + 2]) << 8) | p[i + 3];
    if (len < 2 || i + 2 + len > n) break;
    if (m == kind) out.insert(out.end(), p + i, p + i + 2 + len);
    i += 2 + len;
  }
  return out;
}

}  // namespace

struct MjpegDecoder::Impl {
  std::vector<uint8_t> dht, dqt;  // the tables of the last frame that had them
  std::vector<uint8_t> frame;
  Picture pic;
};

MjpegDecoder::MjpegDecoder() : impl_(new Impl) {
  const size_t n = sizeof(kDefaultDht);
  impl_->dht = {0xff, 0xc4, uint8_t((n + 2) >> 8), uint8_t((n + 2) & 0xff)};
  impl_->dht.insert(impl_->dht.end(), kDefaultDht, kDefaultDht + n);
}
MjpegDecoder::~MjpegDecoder() { delete impl_; }
const Picture& MjpegDecoder::picture() const { return impl_->pic; }

int MjpegDecoder::decode(const uint8_t* p, size_t n, int container_height, std::string* msg) {
  Impl& d = *impl_;
  if (n < 4 || p[0] != 0xff || p[1] != 0xd8) {
    *msg = "damaged Motion JPEG frame (no SOI)";
    return kInvalid;
  }
  // the tables this frame lacks, from the frames before it
  std::vector<uint8_t> dht = segments(p, n, 0xc4), dqt = segments(p, n, 0xdb);
  const uint8_t* src = p;
  size_t len = n;
  if (!dht.empty()) d.dht = dht;
  if (!dqt.empty()) d.dqt = dqt;
  if (dht.empty() || dqt.empty()) {
    d.frame.assign(p, p + 2);
    if (dqt.empty()) d.frame.insert(d.frame.end(), d.dqt.begin(), d.dqt.end());
    if (dht.empty()) d.frame.insert(d.frame.end(), d.dht.begin(), d.dht.end());
    d.frame.insert(d.frame.end(), p + 2, p + n);
    src = d.frame.data();
    len = d.frame.size();
  }
  dali_tpu_torch::JpegFull f;
  int r = dali_tpu_torch::jpeg_read_full(src, len, &f);
  if (r == 1 || (r == 0 && f.progressive)) {
    *msg = "Motion JPEG frame coding other than baseline: ROADMAP.md Queue 1 item 8b";
    return kUnsupported;
  }
  if (r != 0) {
    *msg = "damaged Motion JPEG frame";
    return kInvalid;
  }
  // FFmpeg's pixel format by the sampling factors: luma at the largest,
  // both chroma alike at half or full width and height (its encoder writes
  // 4:2:2 as luma 2x2, chroma 1x2)
  int format = -1;
  if (f.ncomp == 1) {
    format = kGray8;
  } else if (f.ncomp == 3 && f.color == dali_tpu_torch::kYCbCr && f.h[0] == f.hmax &&
             f.v[0] == f.vmax && f.h[1] == f.h[2] && f.v[1] == f.v[2]) {
    const int rh = f.hmax / f.h[1], rv = f.vmax / f.v[1];
    const bool exact = f.h[1] * rh == f.hmax && f.v[1] * rv == f.vmax;
    if (exact && rh == 2 && rv == 2) format = kYuv420p;
    else if (exact && rh == 2 && rv == 1) format = kYuv422p;
    else if (exact && rh == 1 && rv == 1) format = kYuv444p;
  }
  if (format < 0) {
    *msg = "Motion JPEG other than 4:2:0, 4:2:2 or 4:4:4 YCbCr or grey: ROADMAP.md Queue 1 "
           "item 8b";
    return kUnsupported;
  }
  if (container_height > 0 && f.H < container_height * 3 / 4) {
    *msg = "interlaced (two-field) Motion JPEG: ROADMAP.md Queue 1 item 8b";
    return kUnsupported;
  }
  // the planes on the MCU-aligned canvas
  Picture& pic = d.pic;
  const int mx = (f.W + 8 * f.hmax - 1) / (8 * f.hmax), my = (f.H + 8 * f.vmax - 1) / (8 * f.vmax);
  pic.format = format;
  pic.width = f.W;
  pic.height = f.H;
  pic.stride_y = mx * 8 * f.h[0];
  pic.rows_y = my * 8 * f.v[0];
  pic.stride_c = format == kGray8 ? 0 : mx * 8 * f.h[1];
  pic.rows_c = format == kGray8 ? 0 : my * 8 * f.v[1];
  pic.y.assign(size_t(pic.stride_y) * pic.rows_y, 0);
  pic.u.assign(size_t(pic.stride_c) * pic.rows_c, 0);
  pic.v.assign(size_t(pic.stride_c) * pic.rows_c, 0);
  uint8_t* planes[3] = {pic.y.data(), pic.u.data(), pic.v.data()};
  const int strides[3] = {pic.stride_y, pic.stride_c, pic.stride_c};
  int16_t blk[64];
  for (int c = 0; c < f.ncomp; c++) {
    const uint16_t* q = f.q[c];
    for (int by = 0; by < f.bh[c]; by++)
      for (int bx = 0; bx < f.bw[c]; bx++) {
        const short* coef = f.coef[c].data() + (size_t(by) * f.bw[c] + bx) * 64;
        blk[0] = clip_int16(int(q[0]) * coef[0] + 1024);
        for (int k = 1; k < 64; k++) blk[k] = int16_t(int(coef[k]) * int(q[k]));
        simple_idct_put(blk, planes[c] + size_t(by) * 8 * strides[c] + bx * 8, strides[c]);
      }
  }
  return 1;
}

}  // namespace video
