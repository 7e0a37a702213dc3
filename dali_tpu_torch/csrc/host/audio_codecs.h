// The compressed audio decoders of dali_tpu_torch's host decode: FLAC
// (flac_decode.cc), MPEG-1/2/2.5 Layer III (mp3_decode.cc) and Ogg Vorbis
// (ogg.cc, vorbis_decode.cc), called a batch at a time by
// audio_decode_batch.cc. Each fills ``out`` with
// interleaved float32 PCM and returns 0, or one of the codes below.
#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace audio_codecs {

constexpr int kOk = 0;
constexpr int kMalformed = -1;    // the reference's decoder fails or yields nothing
constexpr int kUnsupported = -2;  // a form this port does not decode (ROADMAP item 4c)
constexpr int kNoMemory = -3;

struct Pcm {
  std::vector<float> samples;  // interleaved
  int channels = 0;
  int rate = 0;
};

int flac_decode(const uint8_t* data, size_t len, Pcm& out);  // kMalformed on a failed CRC too
int mp3_decode(const uint8_t* data, size_t len, Pcm& out);

// The packets of the first logical stream of an Ogg file (RFC 3533), each
// with the page it ends on. Returns kOk or kMalformed.
struct OggPacket {
  size_t offset, size;  // into ``OggStream::data``
  int64_t granule;      // of the page the packet ends on
  int page;             // that page's index among the stream's pages
  uint8_t page_flags;   // its header type: 1 continued, 2 first, 4 last
  bool last_on_page;
};

struct OggStream {
  std::vector<uint8_t> data;
  std::vector<OggPacket> packets;
  uint32_t serial = 0;
};

int ogg_read(const uint8_t* data, size_t len, OggStream& out);

int vorbis_decode(const uint8_t* data, size_t len, Pcm& out);

}  // namespace audio_codecs
