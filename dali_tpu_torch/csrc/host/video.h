// Shared declarations of the host video stack: the ISO BMFF, AVI, MPEG-PS,
// MPEG-TS and Matroska demuxers (mp4_demux.cc, avi_demux.cc,
// mpeg_ps_demux.cc, mpeg_ts_demux.cc, mkv_demux.cc), the MPEG-4 Part 2 and MPEG-1/2 decoders
// (mpeg4_decode.cc, mpeg12_decode.cc), the Motion JPEG, HuffYUV and FFV1 frame decoders
// (mjpeg_decode.cc, huffyuv_decode.cc, ffv1_decode.cc), the rebuild of
// libswscale's RGB24 conversion (sws_rgb.cc) and the frame-accurate reader
// over them (video_decode.cc).
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

constexpr int64_t kNoPts = INT64_MIN;

struct Sample {
  int64_t offset;  // MPEG-PS / TS / elementary stream: the offset in the stream's bytes
  int64_t size;
  int64_t dts;
  int64_t pts;
  bool key;
  bool discard;  // past the edit list's end: decoded, its picture dropped
};

// Where an elementary stream carried in MPEG-PS or MPEG-TS packets lies in
// the file: the demuxer's walk over the container's packets from
// ``file_offset`` (a PES packet's start code in PS, the first TS packet of
// a PES in TS) gives the stream's bytes from ``es_offset`` on, after
// ``skip`` bytes (TS: the PES header). A PS track keeps one piece for each
// PES packet a picture starts in (the walk goes on through the packets
// after it), a TS track one for each PES packet (the walk ends at the
// next), an elementary stream one for the whole file.
struct EsPiece {
  int64_t es_offset, file_offset, skip;
};

// The containers and the stream codecs of a Track
enum Container { kMp4 = 0, kAvi = 1, kMpegPs = 2, kMpegTs = 3, kMpegEs = 4, kMkv = 5 };
enum EsCodec { kEsMpeg12 = 1, kEsMpeg4 = 4 };

struct Track {
  int container = kMp4;
  int es_codec = 0;             // MPEG-PS / TS / elementary stream: an EsCodec
  std::vector<EsPiece> pieces;  // MPEG-PS / TS / elementary stream: where the stream's bytes lie
  int es_id = -1;               // MPEG-PS: the video stream id; MPEG-TS: the video PID
  int psi_pid = -1;             // MPEG-TS: the program map table's PID
  uint32_t codec_tag = 0;    // AVI: the BITMAPINFOHEADER's compression FourCC
  int width = 0, height = 0; // AVI: the BITMAPINFOHEADER's frame size
  int bits = 0;              // AVI: biBitCount (bits_per_coded_sample)
  int64_t timescale = 0;
  int64_t tb_num = 1;      // the time base is tb_num / timescale seconds
  int64_t start_time = 0;  // pts of the first sample, in timescale units
  int64_t nb_frames = 0;   // samples counted by stts
  int64_t duration = 0;    // mdhd duration
  double fps = 0.0;        // avg_frame_rate as libavformat's mov demuxer computes it
  std::vector<uint8_t> config;  // esds DecoderSpecificInfo (VOS/VO/VOL headers)
  std::vector<Sample> samples;
  // Matroska: a V_MS/VFW/FOURCC track (its block timestamps are dts, its
  // codec the BITMAPINFOHEADER's FourCC in codec_tag), the frames'
  // ContentEncoding (-1 none, 0 zlib, 3 header stripping, whose bytes
  // comp_settings holds) and the file's duration in microseconds
  bool ms_compat = false;
  int content_comp = -1;
  std::vector<uint8_t> comp_settings;
  int64_t format_duration = kNoPts;
};

// Parses an ISO BMFF file held in memory; picks the first video track.
// Returns kOk, kInvalid (the file cannot be read as a video) or
// kUnsupported (another container or codec; ``msg`` says which).
int demux_mp4(const uint8_t* data, size_t n, Track* track, std::string* msg);
// The same from an open file of ``size`` bytes, reading its first bytes,
// its top-level box headers and its ``moov`` boxes only: the samples stay
// on disk.
int demux_mp4_fd(int fd, uint64_t size, Track* track, std::string* msg);
// Whether a file starts with a box the MP4 demuxer reads (ftyp, moov, mdat...)
bool is_mp4(const uint8_t* head, size_t n);
// Reads ``k`` bytes at ``pos`` of an open file; false when they are not all there.
bool read_at(int fd, uint64_t pos, uint8_t* dst, size_t k);

// The same for an AVI file: the packets of its first video stream (a
// sample's dts is its frame slot, ``key`` the index's keyframe flag),
// fps = dwRate / dwScale and the frame count dwLength.
int demux_avi(const uint8_t* data, size_t n, Track* track, std::string* msg);
int demux_avi_fd(int fd, uint64_t size, Track* track, std::string* msg);
bool is_avi(const uint8_t* head, size_t n);

// Matroska (mkv_demux.cc): the frames of the first video track, each lace
// a sample at its place in the file (pts, or for V_MS/VFW/FOURCC dts, in
// units of tb_num / timescale s; ``key`` a key frame); fps from the
// track's DefaultDuration (0 without one), the file's duration from the
// Segment's. V_MPEG4/ISO/* and V_MPEG1/2 set es_codec, every codec a
// codec_tag for open_avi's dispatch (MP4V, MPG1, MPG2, MJPG, FFV1, or the
// BITMAPINFOHEADER's FourCC).
bool is_mkv(const uint8_t* head, size_t n);
int demux_mkv_fd(int fd, const uint8_t* mem, uint64_t size, Track* track, std::string* msg);
// A frame's ContentEncoding undone: ``algo`` 3 puts ``settings`` before it,
// 0 inflates it (zlib); false when it does not inflate.
bool mkv_decode_frame(uint64_t algo, const std::vector<uint8_t>& settings, const uint8_t* p,
                      size_t n, std::vector<uint8_t>* out);

// MPEG-PS (mpeg_ps_demux.cc) and MPEG-TS (mpeg_ts_demux.cc): the pictures
// of the first video stream (MPEG-1/2; in TS also MPEG-4 Part 2) as
// libavformat 5.1 hands them to the decoder: the elementary stream split
// into pictures by its mpegvideo (mpeg4video) parser, a PES packet's PTS
// and DTS given to the first picture that starts in it and the missing ones
// filled in as compute_pkt_fields fills them (timescale 90 kHz; a sample's
// ``key`` is an I-picture); ``start_time`` the first picture's pts and
// ``duration`` the stream duration its estimate_timings_from_pts gives
// (the last PES timestamps of the file's tail). A raw elementary stream
// (``00 00 01 B3``) is split the same way, without timestamps.
// A file of ``size`` bytes (``fd``, or ``mem`` when the file is in memory)
// read forward in blocks of a MiB: the MPEG demuxers' pass over it.
struct BlockReader {
  int fd = -1;
  const uint8_t* mem = nullptr;
  uint64_t size = 0;
  size_t block = size_t(1) << 20;  // the least a read from the file takes
  std::vector<uint8_t> buf;
  uint64_t buf_pos = 0;
  // the bytes at [pos, pos + k), or null past the end of the file
  const uint8_t* at(uint64_t pos, size_t k);
};

// What sees each picture the MPEG demuxers' split hands on, in order, with
// its bytes and whether the split calls it an I-picture (I-VOP): the
// open's header pass (video_decode.cc), so that the open reads the file
// once.
struct PictureSink {
  virtual ~PictureSink() = default;
  virtual void picture(const uint8_t* p, size_t n, bool key) = 0;
};

// A PES header's 33-bit PTS or DTS (its five bytes)
int64_t pes_timestamp(const uint8_t* p);

// libavformat's probe scores (0-100) of the first ``n`` bytes of a file as
// MPEG-PS (mpeg.c's mpegps_probe) and as MPEG-TS (mpegts.c's mpegts_probe):
// a file cut mid-stream scores by its packets, not by its first bytes.
int mpegps_probe(const uint8_t* head, size_t n);
int mpegts_probe(const uint8_t* head, size_t n);
bool is_mpeg_es(const uint8_t* head, size_t n);
// ``sink`` sees each picture as the split hands it on.
int demux_mpeg_ps_fd(int fd, const uint8_t* mem, uint64_t size, Track* track, std::string* msg,
                     PictureSink* sink);
int demux_mpeg_ts_fd(int fd, const uint8_t* mem, uint64_t size, Track* track, std::string* msg,
                     PictureSink* sink);
int demux_mpeg_es_fd(int fd, const uint8_t* mem, uint64_t size, Track* track, std::string* msg,
                     PictureSink* sink);
// The stream's bytes [from, from + n) of an MPEG-PS, MPEG-TS or elementary
// stream ``track`` into ``dst``, walked from its pieces as its demuxer
// walked the file; false when they are not all there.
bool read_es(BlockReader* in, const Track& track, int64_t from, int64_t n, uint8_t* dst);

// What the MPEG demuxers share (mpeg_ps_demux.cc): the elementary stream's
// split into the decoder's packets with their timestamps, fed one PES
// packet at a time, and the duration estimate.
class MpegEsSplitter {
 public:
  // ``codec``: an EsCodec; ``timescale``: the stream's time base (90 kHz in
  // PS and TS, 1.2 MHz for an elementary stream); ``sink``: what sees each
  // picture
  MpegEsSplitter(int codec, int64_t timescale, PictureSink* sink);
  ~MpegEsSplitter();
  MpegEsSplitter(const MpegEsSplitter&) = delete;
  MpegEsSplitter& operator=(const MpegEsSplitter&) = delete;
  // One PES packet: its payload ``p`` (n bytes), its PTS and DTS (kNoPts
  // when absent) and the file position of its header.
  void feed(const uint8_t* p, size_t n, int64_t pts, int64_t dts, int64_t pos);
  // The stream offset of the first byte no picture handed on holds yet:
  // the next picture starts there.
  int64_t pending() const;
  // The pictures handed on so far, and where the i-th starts in the stream.
  size_t pictures() const;
  int64_t picture_offset(size_t i) const;
  // The end of the stream: fills ``track``'s samples, start_time, duration
  // (estimate_timings_from_pts over the PES packets from ``file_size``'s
  // tail; for an elementary stream, ``file_size`` over an MPEG-1 header's
  // bit rate) and fps (the sequence header's frame rate, or the pictures'
  // timestamps for MPEG-4 Part 2).
  void finish(uint64_t file_size, Track* track);

 private:
  struct Impl;
  Impl* impl_;
};

// Bits over a buffer, most significant first, 32 at a time; reads past the
// end give zeros and leave ``over()`` true (HuffYUV's and FFV1's Golomb-Rice
// bitstreams).
struct MsbBits {
  const uint8_t* p = nullptr;
  size_t n = 0;    // bytes
  size_t pos = 0;  // bits read
  void init(const uint8_t* d, size_t k) {
    p = d;
    n = k;
    pos = 0;
  }
  uint32_t peek32() const {
    const size_t byte = pos >> 3;
    uint64_t w = 0;
    for (size_t i = 0; i < 5; i++) w = (w << 8) | (byte + i < n ? p[byte + i] : 0u);
    return uint32_t(w >> (8 - (pos & 7)));
  }
  uint32_t get(int k) {
    const uint32_t v = k ? peek32() >> (32 - k) : 0;
    pos += size_t(k);
    return v;
  }
  void skip(int k) { pos += size_t(k); }
  long left() const { return long(n * 8) - long(pos); }
  bool over() const { return pos > n * 8; }
};

// The pixel formats the decoders emit, by FFmpeg's names: planar YUV
// (chroma planes at half width for 4:2:2, at half width and height for
// 4:2:0), one grey plane, or packed 8-bit RGB in ``y`` (bgr0 and bgra:
// B, G, R, then a byte that is ignored or alpha; 0rgb: that byte first).
enum PixFmt { kYuv420p, kYuv422p, kYuv444p, kGray8, kBgr0, kBgra, kBgr24, k0rgb };

// A decoded picture: planar 4:2:0 on a macroblock-aligned canvas from the
// MPEG-4 decoder, any PixFmt from the others.
struct Picture {
  int format = kYuv420p;
  int width = 0, height = 0;     // display size
  int stride_y = 0, stride_c = 0;
  int rows_y = 0, rows_c = 0;    // macroblock-aligned heights
  std::vector<uint8_t> y, u, v;
  int64_t tag = -1;  // the VOP it holds: packet << 32 | start code offset
  // The planes for ``format`` at ``w`` x ``h`` (chroma rows rounded up).
  void allocate(int fmt, int w, int h);
};

// libswscale 6.7's sws_scale to RGB24 at 1:1 size (sws_rgb.cc) of a
// picture whose format and size sws_takes (4:2:2 but at an odd width and
// height, 4:4:4, grey, packed RGB); ``full_range`` selects the yuvj*
// forms. ``dst`` is width*height*3 bytes.
bool sws_takes(int format, int width, int height);
void sws_rgb(const Picture& p, bool full_range, uint8_t* dst);

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

// The parameters an MPEG-1/2 stream carries from one picture to the next:
// the sequence header and its extensions with the quantiser matrices
// (raster order), and the last picture coding extension's coding tools. A
// seek restores them as the whole-stream decode had them.
struct Mpeg12State {
  bool seen = false;  // a sequence header has been read
  bool mpeg2 = false;
  int width = 0, height = 0, aspect = 0;
  int frame_rate_index = 0, frame_rate_ext_n = 1, frame_rate_ext_d = 1;
  int64_t bit_rate = 0;
  int progressive_sequence = 1, chroma_format = 1, low_delay = 0;
  uint16_t intra[64] = {}, inter[64] = {}, chroma_intra[64] = {}, chroma_inter[64] = {};
  int full_pel[2] = {0, 0};
  int f_code[2][2] = {{1, 1}, {1, 1}};
  int intra_dc_precision = 0, picture_structure = 3, frame_pred_frame_dct = 1;
  int concealment_mv = 0, q_scale_type = 0, intra_vlc_format = 0, alternate_scan = 0;
  int progressive_frame = 1;
};

// MPEG-1/2 video as FFmpeg 5.1's mpeg1video / mpeg2video decoder gives it
// (mpeg12_decode.cc): one packet is one picture with the headers before it.
class Mpeg12Decoder {
 public:
  Mpeg12Decoder();
  ~Mpeg12Decoder();
  Mpeg12Decoder(const Mpeg12Decoder&) = delete;
  Mpeg12Decoder& operator=(const Mpeg12Decoder&) = delete;
  // One packet, ``tag`` naming it: 1 when a picture is shown (``output()``,
  // its ``tag`` that of the packet it was coded in), 0 when none, kInvalid
  // or kUnsupported. ``headers_only`` reads the headers and decodes no
  // macroblock: the shown pictures' tags come out the same.
  int decode_packet(const uint8_t* p, size_t n, int64_t tag, bool headers_only,
                    std::string* msg);
  // The end of the stream: 1 when the held anchor is still to show.
  int drain();
  // Drops the pictures and the GOP state, as avcodec_flush_buffers does.
  void flush();
  const Picture& output() const;
  Mpeg12State state() const;
  void restore(const Mpeg12State& s);
  // The picture type (1 I, 2 P, 3 B, 4 D, 0 none) of the last packet's
  // picture header, and whether that picture was decoded (not skipped).
  int last_type() const;
  bool last_decoded() const;

 private:
  struct Impl;
  Impl* impl_;
};

// One Motion JPEG frame as FFmpeg's mjpeg decoder gives it: yuvj420p,
// yuvj422p, yuvj444p or gray.
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

// HuffYUV (``HFYU``) and FFmpeg's HuffYUV v2 (``FFVH``) frames at 8 bits
// as FFmpeg 5.1's huffyuvdec.c gives them.
class HuffyuvDecoder {
 public:
  HuffyuvDecoder();
  ~HuffyuvDecoder();
  HuffyuvDecoder(const HuffyuvDecoder&) = delete;
  HuffyuvDecoder& operator=(const HuffyuvDecoder&) = delete;
  // The stream: the BITMAPINFOHEADER's biBitCount and the extradata after
  // it. kOk, kInvalid or kUnsupported.
  int configure(int bits, const uint8_t* extra, size_t n, int width, int height,
                std::string* msg);
  int format() const;
  // 1 with the frame in ``picture()``, or kInvalid.
  int decode(const uint8_t* p, size_t n, std::string* msg);
  const Picture& picture() const;

 private:
  struct Impl;
  Impl* impl_;
};

// FFV1 (RFC 9043) versions 0, 1 and 3 at 8 bits as FFmpeg 5.1's ffv1dec.c
// gives them. A frame that is not a key frame keeps the context states of
// the frames before it.
class Ffv1Decoder {
 public:
  Ffv1Decoder();
  ~Ffv1Decoder();
  Ffv1Decoder(const Ffv1Decoder&) = delete;
  Ffv1Decoder& operator=(const Ffv1Decoder&) = delete;
  // The extradata (versions 2 and up) and the frame size.
  int configure(const uint8_t* extra, size_t n, int width, int height, std::string* msg);
  // Whether a packet starts a key frame (its first range-coded bit).
  static bool is_key(const uint8_t* p, size_t n);
  // The format of the stream, known after the first key frame (or the
  // extradata): -1 before.
  int format() const;
  // 1 with the frame in ``picture()``, kInvalid (damage: a bad CRC, a
  // slice that ends early, a non-key frame without its key frame) or
  // kUnsupported.
  int decode(const uint8_t* p, size_t n, std::string* msg);
  void flush();
  const Picture& picture() const;

 private:
  struct Impl;
  Impl* impl_;
};

}  // namespace video
