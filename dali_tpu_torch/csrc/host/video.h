// Shared declarations of the host video stack: the ISO BMFF and AVI
// demuxers (mp4_demux.cc, avi_demux.cc), the MPEG-4 Part 2 decoder
// (mpeg4_decode.cc), the Motion JPEG frame decoder (mjpeg_decode.cc) and
// the frame-accurate reader over them (video_decode.cc).
#pragma once

#include <cstddef>
#include <cstdint>
#include <string>
#include <vector>

namespace video {

// A RIFF FourCC as the little-endian word AVI stores ("XVID").
constexpr uint32_t riff_fourcc(const char* s) {
  return uint32_t(uint8_t(s[0])) | (uint32_t(uint8_t(s[1])) << 8) |
         (uint32_t(uint8_t(s[2])) << 16) | (uint32_t(uint8_t(s[3])) << 24);
}

// Status of the demuxer and the decoder. kUnsupported marks a stream that
// FFmpeg reads and this port does not yet (ROADMAP item 8b); the message
// names the form.
enum Status { kOk = 0, kInvalid = -1, kUnsupported = -2 };

struct Sample {
  int64_t offset;
  int64_t size;
  int64_t dts;
  int64_t pts;
  bool key;
  bool discard;  // past the edit list's end: decoded, its picture dropped
};

struct Track {
  bool avi = false;
  uint32_t codec_tag = 0;    // AVI: the BITMAPINFOHEADER's compression FourCC
  int width = 0, height = 0; // AVI: the BITMAPINFOHEADER's frame size
  int64_t timescale = 0;
  int64_t start_time = 0;  // pts of the first sample, in timescale units
  int64_t nb_frames = 0;   // samples counted by stts
  int64_t duration = 0;    // mdhd duration
  double fps = 0.0;        // avg_frame_rate as libavformat's mov demuxer computes it
  std::vector<uint8_t> config;  // esds DecoderSpecificInfo (VOS/VO/VOL headers)
  std::vector<Sample> samples;
};

// Parses an ISO BMFF file held in memory; picks the first video track.
// Returns kOk, kInvalid (the file cannot be read as a video) or
// kUnsupported (another container or codec; ``msg`` says which).
int demux_mp4(const uint8_t* data, size_t n, Track* track, std::string* msg);
// The same from an open file of ``size`` bytes, reading its first bytes,
// its top-level box headers and its ``moov`` boxes only: the samples stay
// on disk.
int demux_mp4_fd(int fd, uint64_t size, Track* track, std::string* msg);
// Reads ``k`` bytes at ``pos`` of an open file; false when they are not all there.
bool read_at(int fd, uint64_t pos, uint8_t* dst, size_t k);

// The same for an AVI file: the packets of its first video stream (a
// sample's dts is its frame slot, ``key`` the index's keyframe flag),
// fps = dwRate / dwScale and the frame count dwLength.
int demux_avi(const uint8_t* data, size_t n, Track* track, std::string* msg);
int demux_avi_fd(int fd, uint64_t size, Track* track, std::string* msg);
bool is_avi(const uint8_t* head, size_t n);

// Planar 4:2:0 picture on a macroblock-aligned canvas.
struct Picture {
  int width = 0, height = 0;     // display size
  int stride_y = 0, stride_c = 0;
  int rows_y = 0, rows_c = 0;    // macroblock-aligned heights
  std::vector<uint8_t> y, u, v;
  int64_t tag = -1;  // the VOP it holds: packet << 32 | start code offset
};

// FFmpeg's simple IDCT (13-bit row, 20-bit column pass) of one 8x8 block,
// put into or added to a plane; shared by the MPEG-4 and MJPEG decoders.
void simple_idct_put(int16_t* blk, uint8_t* dst, int stride);
void simple_idct_add(int16_t* blk, uint8_t* dst, int stride);

// What FFmpeg's MPEG-4 decoder carries from one VOP to the next: whether
// pictures leave with a delay of one (B-VOPs), the VOP count, the encoder
// builds its user data name, DivX's packed-bitstream flag and the IDCT
// they select.
struct Mpeg4State {
  bool low_delay = true;
  int64_t picture_number = 0;
  int xvid_build = -1, divx_version = -1, divx_build = -1, lavc_build = -1;
  bool packed = false;
  bool xvid_idct = false;
};

class Mpeg4Decoder {
 public:
  Mpeg4Decoder();
  ~Mpeg4Decoder();
  Mpeg4Decoder(const Mpeg4Decoder&) = delete;
  Mpeg4Decoder& operator=(const Mpeg4Decoder&) = delete;
  // Parses the headers of a DecoderSpecificInfo (VOS, VO, VOL).
  int configure(const uint8_t* p, size_t n, std::string* msg);
  // Decodes one sample. Returns 1 with a new picture in ``picture()``, 0
  // when the sample holds no picture (a VOP with vop_coded 0, or headers
  // only), kInvalid when the stream is damaged, kUnsupported for a tool
  // outside the Simple Profile forms the port decodes.
  int decode(const uint8_t* p, size_t n, std::string* msg);
  // Drops the reference pictures (after a seek).
  void flush();
  const Picture& picture() const;
  // AVI: B-VOPs, packed bitstreams and output in display order, with the
  // bug workarounds the container's codec tag (upper case) selects.
  void set_packet_mode(uint32_t codec_tag);
  // One packet, ``index`` of the stream, as FFmpeg 5.1's decoder takes it
  // (h263dec.c): 1 when a picture is shown (``output()``), 0 when none,
  // kInvalid or kUnsupported. ``headers_only`` parses the VOP headers and
  // decodes no macroblock: the shown pictures' tags come out the same.
  int decode_packet(const uint8_t* p, size_t n, int64_t index, bool headers_only,
                    std::string* msg);
  // The end of the stream: 1 when the future reference is still to show.
  int drain();
  const Picture& output() const;
  Mpeg4State state() const;
  void restore(const Mpeg4State& s);
  int width() const;
  int height() const;
  bool full_range() const;

 private:
  struct Impl;
  Impl* impl_;
};

// One Motion JPEG frame as FFmpeg's mjpeg decoder gives it (yuvj420p).
class MjpegDecoder {
 public:
  MjpegDecoder();
  ~MjpegDecoder();
  MjpegDecoder(const MjpegDecoder&) = delete;
  MjpegDecoder& operator=(const MjpegDecoder&) = delete;
  // 1 with the frame in ``picture()``, kInvalid or kUnsupported;
  // ``container_height`` is the stream header's (a frame far shorter is a
  // field of an interlaced frame).
  int decode(const uint8_t* p, size_t n, int container_height, std::string* msg);
  const Picture& picture() const;

 private:
  struct Impl;
  Impl* impl_;
};

}  // namespace video
