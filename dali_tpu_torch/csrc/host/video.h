// Shared declarations of the host video stack: the ISO BMFF demuxer
// (mp4_demux.cc), the MPEG-4 Part 2 Simple Profile decoder
// (mpeg4_decode.cc) and the frame-accurate reader over both
// (video_decode.cc).
#pragma once

#include <cstddef>
#include <cstdint>
#include <string>
#include <vector>

namespace video {

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

// Planar 4:2:0 picture on a macroblock-aligned canvas.
struct Picture {
  int width = 0, height = 0;     // display size
  int stride_y = 0, stride_c = 0;
  int rows_y = 0, rows_c = 0;    // macroblock-aligned heights
  std::vector<uint8_t> y, u, v;
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
  // Drops the reference picture (after a seek).
  void flush();
  const Picture& picture() const;
  int width() const;
  int height() const;
  bool full_range() const;

 private:
  struct Impl;
  Impl* impl_;
};

}  // namespace video
