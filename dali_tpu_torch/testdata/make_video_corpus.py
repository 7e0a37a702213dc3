"""The MP4 / MPEG-4 Part 2 fixtures of dali_tpu_torch's video decode
(``testdata/video``) and the card's video corpus.

Every file is written by OpenCV's ``cv2.VideoWriter`` with the ``mp4v``
fourcc, the form the reference's tests and recipes write (FFmpeg's
``mpeg4`` encoder at its defaults: Simple Profile, I- and P-VOPs, a GOP of
12, ``mdat`` before ``moov``):

* ``flat_48x32.mp4`` — 24 flat frames of rising brightness, the clip of
  ``tests/test_video.py``;
* ``pan_64x48.mp4`` — 12 frames of a random texture panned a column a
  frame, the clip of ``tests/test_video_yuv_wire.py``;
* ``recipe_160x120.mp4`` — 40 frames at the size the video training recipe
  resizes from (120 rows: not a multiple of 16);
* ``odd_170x98.mp4`` — 30 frames at a size that is a multiple of neither 16
  nor 2, with sub-pixel motion and a scene cut;
* ``corpus/<class>/<clip>.mp4`` — 4 classes of 8 clips at 320x240 and
  25 fps (UCF101's frame size and rate), 48-96 frames each: sub-pixel pans,
  a zoom, noise and, in some clips, a scene cut, so that half-sample motion,
  both rounding modes, intra macroblocks in P-VOPs and AC prediction all
  occur. This is the corpus of the ``video_clip_train`` path on the card.

The AVI set (``--avi``) comes from cv2 (its ``XVID`` and ``MJPG``
fourccs, which the reference's own tests write) and from FFmpeg's encoders
through a small C helper compiled at run time against this machine's
libavformat and libavcodec (as ``make_audio_codecs.py`` compiles its own):

* ``avi/xvid_bf_160x120.avi`` — ``libxvid`` with two B-frames: Xvid's
  user data (``XviD0069``, ``DivX503b1393p``), a packed bitstream with
  N-VOP placeholders, zero-size chunks at its start;
* ``avi/xvid_160x120.avi`` — ``libxvid`` without B-frames;
* ``avi/mpeg4_bf_170x98.avi`` — FFmpeg's ``mpeg4`` with two B-frames,
  unpacked, tagged ``XVID``, at a size no multiple of 16;
* ``avi/mpeg4_bf_4mv_160x120.avi`` — the same with 4MV and resync markers
  (direct mode from 8x8 vectors, B-VOP video packets);
* ``avi/mjpeg_160x120.avi`` — ``mjpeg`` (yuvj420p, optimal Huffman tables);
  ``avi/mjpeg_nodht_160x120.avi`` — default tables, every DHT segment
  stripped, as AVI1 Motion JPEG writes it;
* ``avi/raw_i420_64x48.avi`` — ``rawvideo`` tagged ``I420``;
* ``avi/noindex_xvid_160x120.avi`` — the Xvid file without its ``idx1``
  and OpenDML indexes;
* ``avi/cv2_xvid_64x48.avi``, ``avi/cv2_mjpg_64x48.avi`` — cv2's writers;
* ``avi_corpus/<class>/<clip>.avi`` — the 32 clips of ``corpus``
  re-encoded by ``libxvid`` with B-frames (UCF101's form: XviD in AVI,
  320x240 at 25 fps), the corpus of the ``ucf_avi_train`` path on the card.

The swscale-route set (``--capture``: video that is not 4:2:0, which the
reference converts to RGB through libswscale) comes from FFmpeg's
``huffyuv``, ``ffvhuff``, ``ffv1`` and ``mjpeg`` encoders through the same
helper (``CAPTURE``: each predictor, pixel format, coder, version and slice
form, a 480-row interlaced HuffYUV, a 10-bit FFVH and a 10-bit FFV1 left
to item 8b), cv2's
``HFYU`` and ``FFV1`` writers, cv2's grey JPEGs and two-field JPEG pairs
muxed as they are, and a HuffYUV 1.x stream coded here with the classic
tables (``classic_huffyuv_frame``):

* ``capture/*.avi`` — the fixtures, 64x48 (66x47, 64x480 for some forms);
* ``capture_corpus/<codec>/<clip>.avi`` — 320x240 at 25 fps: 4 HuffYUV
  4:2:2 and 24 Motion JPEG 4:2:2 clips of 10 frames, 2 of cv2's FFV1 of 16
  frames (past the second key frame), the corpus of the
  ``capture_avi_train`` path on the card.

The MPEG-1/2 set (``--mpeg``) comes from cv2's four MPEG writes (``mpg2``
into MPEG-TS, ``MPEG`` and ``mpg1`` into MPEG-PS, ``PIM1`` into AVI) and
from FFmpeg's ``mpeg1video`` and ``mpeg2video`` encoders through the same
helper (``MPEG``: B-pictures, the intra VLC table, the non-linear
quantiser, the alternate scan, 10-bit intra DC, custom matrices, an odd
size, interlaced (field DCT and field motion), 4:2:2, the DVD and AVI
forms, raw elementary streams, a 90-frame clip), and two cv2 TS segments
of different sizes spliced:

* ``mpeg/*`` — the fixtures, 64x48 (170x98, 96x64, 160x120 for some);
* ``mpeg_corpus/ts/*.ts``, ``mpeg_corpus/ps/*.mpg`` — 16 MPEG-2 TS and 16
  MPEG-1 PS clips of cv2's at 320x240 and 25 fps, 48 frames each, the
  corpus of the ``mpeg_ts_train`` path on the card.

``--tables`` writes ``csrc/host/huffyuv_tables.h`` and
``csrc/host/mpeg12_tables.h`` from this machine's libavcodec.

The reference decode of each fixture (``video/reference.npz``,
``video/avi_reference.npz``, ``video/capture_reference.npz``: what the
card's machine, which has no FFmpeg, holds the port against) is written
afterwards by
``tests/write_video_reference.py``, outside this package, since it runs
dali_tpu.

Run on a machine with OpenCV and FFmpeg's libraries and headers, from the
repo root:

    python dali_tpu_torch/testdata/make_video_corpus.py [out_dir]
    python dali_tpu_torch/testdata/make_video_corpus.py --avi [out_dir]
    python dali_tpu_torch/testdata/make_video_corpus.py --capture [out_dir]
    python dali_tpu_torch/testdata/make_video_corpus.py --mpeg [out_dir]
    python tests/write_video_reference.py [out_dir]
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "video")
CLASSES = ("pan", "drift", "zoom", "cut")
CLIPS_PER_CLASS = 8
CORPUS_SIZE = (320, 240)
FPS = 25


def _texture(rng, h, w):
    """A smooth random colour texture: blurred noise at two scales."""
    import cv2

    coarse = cv2.resize(rng.integers(0, 256, (h // 32 + 2, w // 32 + 2, 3), np.uint8), (w, h),
                        interpolation=cv2.INTER_CUBIC)
    fine = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8), (0, 0), 3.0)
    return cv2.addWeighted(coarse, 0.7, fine, 0.3, 0)


def write_clip(path, frames, fps=FPS):
    import cv2

    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not wr.isOpened():
        raise RuntimeError("cv2 cannot write mp4v")
    for f in frames:
        wr.write(np.ascontiguousarray(f))
    wr.release()


def moving_frames(rng, n, w, h, motion, noise=3.0, cut_at=None):
    """``n`` frames of a texture under ``motion`` ("pan", "drift" or
    "zoom"), with Gaussian noise and an optional scene cut."""
    import cv2

    scenes = [_texture(rng, h + 96, w + 160), _texture(rng, h + 96, w + 160)]
    out = []
    for i in range(n):
        src = scenes[1 if cut_at is not None and i >= cut_at else 0]
        if motion == "pan":
            m = np.float32([[1, 0, -(8 + 1.37 * i)], [0, 0, 0]])
            m[1] = [0, 1, -(16 + 0.31 * i)]
        elif motion == "drift":
            m = np.float32([[1, 0, -(60 + 23 * np.sin(i / 9.0))],
                            [0, 1, -(40 + 17 * np.cos(i / 7.0))]])
        else:
            s = 1.0 + 0.004 * i
            cx, cy = (w + 160) / 2, (h + 96) / 2
            m = np.float32([[s, 0, w / 2 - s * cx], [0, s, h / 2 - s * cy]])
        f = cv2.warpAffine(src, m, (w, h), flags=cv2.INTER_LINEAR,
                           borderMode=cv2.BORDER_REFLECT)
        f = np.clip(f + rng.normal(0, noise, f.shape), 0, 255).astype(np.uint8)
        out.append(f)
    return out


def write_fixtures(out_dir=OUT):
    os.makedirs(out_dir, exist_ok=True)
    # tests/test_video.py _write_video
    write_clip(os.path.join(out_dir, "flat_48x32.mp4"),
               [np.full((32, 48, 3), i * 8 % 256, np.uint8) for i in range(24)])
    # tests/test_video_yuv_wire.py _write_video
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (48, 64 * 3, 3), np.uint8)
    write_clip(os.path.join(out_dir, "pan_64x48.mp4"),
               [np.ascontiguousarray(base[:, i: i + 64]) for i in range(12)])
    rng = np.random.default_rng(160)
    write_clip(os.path.join(out_dir, "recipe_160x120.mp4"),
               moving_frames(rng, 40, 160, 120, "pan"))
    rng = np.random.default_rng(170)
    write_clip(os.path.join(out_dir, "odd_170x98.mp4"),
               moving_frames(rng, 30, 170, 98, "drift", cut_at=17))


def corpus_files(root):
    return [os.path.join(root, c, f"{c}_{k:02d}.mp4") for c in CLASSES
            for k in range(CLIPS_PER_CLASS)]


def write_corpus(root):
    w, h = CORPUS_SIZE
    for ci, cls in enumerate(CLASSES):
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        for k in range(CLIPS_PER_CLASS):
            rng = np.random.default_rng(1000 * ci + k)
            n = 48 + 6 * k  # 48-90 frames
            motion = cls if cls != "cut" else ("pan", "drift", "zoom")[k % 3]
            frames = moving_frames(rng, n, w, h, motion, noise=1.0,
                                   cut_at=n // 2 if cls == "cut" else None)
            write_clip(os.path.join(root, cls, f"{cls}_{k:02d}.mp4"), frames)


_AVI_HELPER_C = r"""
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <string.h>

/* Encodes n frames of pixel format ``pixfmt`` (each packed as
   av_image_fill_arrays lays it out with alignment 1: planar 4:2:0 is Y,
   then U, then V) with encoder ``codec`` (FourCC ``tag`` when not empty,
   "k=v:k=v" options, custom intra and non-intra quantiser matrices when
   not null) into the muxer ``muxer`` (AVI when empty) at ``path``;
   ``strip_dht`` drops every DHT segment of a JPEG packet; ``global_header``
   1 asks the encoder for global headers (as ffmpeg does for a muxer that
   wants them), 0 not, -1 as the muxer wants; ``timing`` gives every packet
   a duration of one frame and the stream its frame rate, as ffmpeg does.
   Returns 0, or a negative code. */
int encode_avi(const unsigned char* yuv, int n, int w, int h, int fps, const char* path,
               const char* codec, const char* tag, const char* opts, int pixfmt,
               long bit_rate, int strip_dht, const char* muxer, const unsigned short* intra,
               const unsigned short* inter, int global_header, int timing) {
  AVFormatContext* fmt = NULL;
  if (avformat_alloc_output_context2(&fmt, NULL, *muxer ? muxer : "avi", path) < 0) return -1;
  /* Matroska: segment and track UIDs from the file's contents, not drawn */
  if (!strcmp(fmt->oformat->name, "matroska")) fmt->flags |= AVFMT_FLAG_BITEXACT;
  const AVCodec* cd = avcodec_find_encoder_by_name(codec);
  if (!cd) return -2;
  AVStream* st = avformat_new_stream(fmt, NULL);
  AVCodecContext* c = avcodec_alloc_context3(cd);
  c->width = w;
  c->height = h;
  c->pix_fmt = pixfmt;
  c->time_base = (AVRational){1, fps};
  c->framerate = (AVRational){fps, 1};
  c->gop_size = 12;
  if (bit_rate > 0) c->bit_rate = bit_rate;
  if (global_header > 0 || (global_header < 0 && (fmt->oformat->flags & AVFMT_GLOBALHEADER)))
    c->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (*tag) c->codec_tag = MKTAG(tag[0], tag[1], tag[2], tag[3]);
  if (intra) {
    c->intra_matrix = av_malloc(64 * sizeof(uint16_t));
    memcpy(c->intra_matrix, intra, 64 * sizeof(uint16_t));
  }
  if (inter) {
    c->inter_matrix = av_malloc(64 * sizeof(uint16_t));
    memcpy(c->inter_matrix, inter, 64 * sizeof(uint16_t));
  }
  AVDictionary* d = NULL;
  if (*opts) av_dict_parse_string(&d, opts, "=", ":", 0);
  int rc = avcodec_open2(c, cd, &d);
  av_dict_free(&d);
  if (rc < 0) return -3;
  avcodec_parameters_from_context(st->codecpar, c);
  st->time_base = c->time_base;
  if (timing) st->avg_frame_rate = c->framerate;
  if (avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) return -4;
  if (avformat_write_header(fmt, NULL) < 0) return -5;
  AVFrame* f = av_frame_alloc();
  f->width = w;
  f->height = h;
  f->format = pixfmt;
  av_frame_get_buffer(f, 0);
  AVPacket* pkt = av_packet_alloc();
  long fs = av_image_get_buffer_size(pixfmt, w, h, 1);
  for (int i = 0; i <= n; i++) {
    if (i < n) {
      av_frame_make_writable(f);
      uint8_t* sd[4];
      int sl[4];
      av_image_fill_arrays(sd, sl, yuv + i * fs, pixfmt, w, h, 1);
      av_image_copy(f->data, f->linesize, (const uint8_t**)sd, sl, pixfmt, w, h);
      f->pts = i;
      rc = avcodec_send_frame(c, f);
    } else {
      rc = avcodec_send_frame(c, NULL);
    }
    if (rc < 0) return -6;
    while (avcodec_receive_packet(c, pkt) == 0) {
      if (strip_dht) {
        int o = 2, k = 2;
        while (o + 4 <= pkt->size && pkt->data[o] == 0xff && pkt->data[o + 1] != 0xda) {
          int len = 2 + ((pkt->data[o + 2] << 8) | pkt->data[o + 3]);
          if (pkt->data[o + 1] != 0xc4) {
            memmove(pkt->data + k, pkt->data + o, len);
            k += len;
          }
          o += len;
        }
        memmove(pkt->data + k, pkt->data + o, pkt->size - o);
        pkt->size = k + pkt->size - o;
      }
      if (timing) pkt->duration = 1;
      av_packet_rescale_ts(pkt, c->time_base, st->time_base);
      pkt->stream_index = 0;
      av_interleaved_write_frame(fmt, pkt);
    }
  }
  av_write_trailer(fmt);
  avio_closep(&fmt->pb);
  av_frame_free(&f);
  av_packet_free(&pkt);
  avcodec_free_context(&c);
  avformat_free_context(fmt);
  return 0;
}

/* Writes n packets already coded (``data``, ``sizes``, key flags ``keys``)
   as the video stream of an AVI at ``path``: codec ``codec`` with FourCC
   ``tag``, frame size w x h, biBitCount ``bits`` and ``extra`` as the
   extradata after the BITMAPINFOHEADER (none when extra_size is 0). */
int mux_avi(const char* path, const char* codec, const char* tag, int w, int h, int bits,
            int fps, const unsigned char* extra, int extra_size, const unsigned char* data,
            const int* sizes, const int* keys, int n) {
  AVFormatContext* fmt = NULL;
  if (avformat_alloc_output_context2(&fmt, NULL, "avi", path) < 0) return -1;
  const AVCodecDescriptor* cd = avcodec_descriptor_get_by_name(codec);
  if (!cd) return -2;
  AVStream* st = avformat_new_stream(fmt, NULL);
  st->codecpar->codec_type = AVMEDIA_TYPE_VIDEO;
  st->codecpar->codec_id = cd->id;
  st->codecpar->codec_tag = MKTAG(tag[0], tag[1], tag[2], tag[3]);
  st->codecpar->width = w;
  st->codecpar->height = h;
  st->codecpar->bits_per_coded_sample = bits;
  if (extra_size > 0) {
    st->codecpar->extradata = av_mallocz(extra_size + AV_INPUT_BUFFER_PADDING_SIZE);
    memcpy(st->codecpar->extradata, extra, extra_size);
    st->codecpar->extradata_size = extra_size;
  }
  st->time_base = (AVRational){1, fps};
  if (avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) return -3;
  if (avformat_write_header(fmt, NULL) < 0) return -4;
  AVPacket* pkt = av_packet_alloc();
  long pos = 0;
  for (int i = 0; i < n; i++) {
    if (av_new_packet(pkt, sizes[i]) < 0) return -5;
    memcpy(pkt->data, data + pos, sizes[i]);
    pos += sizes[i];
    pkt->pts = pkt->dts = av_rescale_q(i, (AVRational){1, fps}, st->time_base);
    pkt->duration = 1;
    pkt->flags = keys[i] ? AV_PKT_FLAG_KEY : 0;
    pkt->stream_index = 0;
    if (av_interleaved_write_frame(fmt, pkt) < 0) return -6;
  }
  av_write_trailer(fmt);
  avio_closep(&fmt->pb);
  av_packet_free(&pkt);
  avformat_free_context(fmt);
  return 0;
}
"""

YUV420P, YUVJ420P = 0, 12


class AviWriter:
    """FFmpeg's encoders into the AVI muxer through the compiled helper."""

    def __init__(self):
        import ctypes
        import subprocess
        import tempfile

        self._dir = tempfile.mkdtemp(prefix="avi_writer_")
        src, so = os.path.join(self._dir, "h.c"), os.path.join(self._dir, "h.so")
        with open(src, "w") as f:
            f.write(_AVI_HELPER_C)
        subprocess.run(["gcc", "-O2", "-shared", "-fPIC", "-o", so, src,
                        "-I/usr/include/x86_64-linux-gnu", "-lavformat", "-lavcodec", "-lavutil"],
                       check=True, capture_output=True)
        self._lib = ctypes.CDLL(so)
        c = ctypes
        self._lib.encode_avi.argtypes = [c.c_void_p, c.c_int, c.c_int, c.c_int, c.c_int,
                                         c.c_char_p, c.c_char_p, c.c_char_p, c.c_char_p, c.c_int,
                                         c.c_long, c.c_int, c.c_char_p, c.c_void_p, c.c_void_p,
                                         c.c_int, c.c_int]
        self._lib.mux_avi.argtypes = [c.c_char_p, c.c_char_p, c.c_char_p, c.c_int, c.c_int,
                                      c.c_int, c.c_int, c.c_void_p, c.c_int, c.c_void_p,
                                      c.c_void_p, c.c_void_p, c.c_int]
        self._avutil = ctypes.CDLL("libavutil.so.57")
        self._avutil.av_get_pix_fmt.restype = c.c_int
        self._avutil.av_get_pix_fmt.argtypes = [c.c_char_p]

    def write(self, path, frames, codec, tag="", opts="", pixfmt=YUV420P, bit_rate=0,
              strip_dht=False, fps=FPS, size=None, muxer="", matrices=None, global_header=-1,
              timing=False):
        """``frames``: BGR images of one size, coded from planar 4:2:0; or,
        with ``pixfmt`` an FFmpeg pixel format name, frames of ``size``
        (w, h) already in that format's bytes (``planes``). ``muxer``: an
        FFmpeg muxer name (AVI when empty); ``matrices``: custom intra and
        non-intra quantiser matrices (64 values each, raster order);
        ``global_header``: 1 or 0 asks the encoder for global headers or
        not, -1 (the default) as the muxer wants them; ``timing``: packet
        durations and the stream's frame rate, as ffmpeg writes them."""
        w, h = size or frames[0].shape[1::-1]
        if isinstance(pixfmt, str):
            data = np.ascontiguousarray(np.stack([np.asarray(f).reshape(-1) for f in frames]))
            pixfmt = self._avutil.av_get_pix_fmt(pixfmt.encode())
        else:
            data = np.ascontiguousarray(np.stack([i420(f) for f in frames]))
        mats = [None if matrices is None else np.ascontiguousarray(m, np.uint16)
                for m in (matrices or (None, None))]
        rc = self._lib.encode_avi(data.ctypes.data, len(data), w, h, fps, path.encode(),
                                  codec.encode(), tag.encode(), opts.encode(), pixfmt,
                                  bit_rate, int(strip_dht), muxer.encode(),
                                  *[None if m is None else m.ctypes.data for m in mats],
                                  global_header, int(timing))
        if rc != 0:
            raise RuntimeError(f"{codec} into {path} failed: {rc}")
        return path

    def mux(self, path, packets, codec, tag, w, h, bits=24, extradata=b"", keys=None, fps=FPS):
        """Packets already coded into an AVI, without re-encoding."""
        data = np.frombuffer(b"".join(packets), np.uint8)
        sizes = np.array([len(p) for p in packets], np.int32)
        keys = np.array([1] * len(packets) if keys is None else keys, np.int32)
        extra = np.frombuffer(extradata or b"\0", np.uint8)
        rc = self._lib.mux_avi(path.encode(), codec.encode(), tag.encode(), w, h, bits, fps,
                               extra.ctypes.data, len(extradata), data.ctypes.data,
                               sizes.ctypes.data, keys.ctypes.data, len(packets))
        if rc != 0:
            raise RuntimeError(f"muxing {codec} into {path} failed: {rc}")
        return path


def i420(bgr):
    """The planar 4:2:0 bytes (Y, then U, then V) of a BGR image of even size."""
    import cv2

    return cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV_I420).reshape(-1)


def without_index(data: bytes) -> bytes:
    """An AVI of FFmpeg's muxer with its ``idx1`` chunk cut and its OpenDML
    ``indx`` chunk renamed ``JUNK``: a file that is read by scanning
    ``movi``."""
    import struct

    data = bytearray(data)
    i = data.find(b"indx")
    while i >= 0:
        data[i: i + 4] = b"JUNK"
        i = data.find(b"indx", i + 4)
    j = data.rfind(b"idx1")
    size = struct.unpack("<I", data[j + 4: j + 8])[0]
    del data[j: j + 8 + size + (size & 1)]
    struct.pack_into("<I", data, 4, len(data) - 8)
    return bytes(data)


def write_avi_fixtures(out_dir=OUT):
    import cv2

    d = os.path.join(out_dir, "avi")
    os.makedirs(d, exist_ok=True)
    wr = AviWriter()
    pan = moving_frames(np.random.default_rng(240), 40, 160, 120, "pan")
    drift = moving_frames(np.random.default_rng(241), 30, 170, 98, "drift", cut_at=17)
    wr.write(os.path.join(d, "xvid_bf_160x120.avi"), pan, "libxvid", opts="bf=2")
    wr.write(os.path.join(d, "xvid_160x120.avi"), pan, "libxvid", opts="bf=0")
    wr.write(os.path.join(d, "mpeg4_bf_170x98.avi"), drift, "mpeg4", tag="XVID", opts="bf=2")
    wr.write(os.path.join(d, "mpeg4_bf_4mv_160x120.avi"), pan, "mpeg4", tag="XVID",
             opts="bf=2:flags=+mv4:ps=200")
    wr.write(os.path.join(d, "mjpeg_160x120.avi"), pan[:16], "mjpeg", pixfmt=YUVJ420P)
    wr.write(os.path.join(d, "mjpeg_nodht_160x120.avi"), pan[:16], "mjpeg", pixfmt=YUVJ420P,
             opts="huffman=default", strip_dht=True)
    wr.write(os.path.join(d, "raw_i420_64x48.avi"),
             moving_frames(np.random.default_rng(242), 10, 64, 48, "zoom"), "rawvideo",
             tag="I420")
    with open(os.path.join(d, "xvid_160x120.avi"), "rb") as f:
        data = without_index(f.read())
    with open(os.path.join(d, "noindex_xvid_160x120.avi"), "wb") as f:
        f.write(data)
    small = moving_frames(np.random.default_rng(243), 12, 64, 48, "drift")
    for fourcc in ("XVID", "MJPG"):
        cw = cv2.VideoWriter(os.path.join(d, f"cv2_{fourcc.lower()}_64x48.avi"),
                             cv2.VideoWriter_fourcc(*fourcc), FPS, (64, 48))
        if not cw.isOpened():
            raise RuntimeError(f"cv2 cannot write {fourcc}")
        for f in small:
            cw.write(np.ascontiguousarray(f))
        cw.release()


def avi_corpus_files(root):
    return [os.path.join(root, c, f"{c}_{k:02d}.avi") for c in CLASSES
            for k in range(CLIPS_PER_CLASS)]


def write_avi_corpus(root, bit_rate=600_000):
    """The MP4 corpus's clips, frame for frame, as Xvid with B-frames."""
    w, h = CORPUS_SIZE
    wr = AviWriter()
    for ci, cls in enumerate(CLASSES):
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        for k in range(CLIPS_PER_CLASS):
            rng = np.random.default_rng(1000 * ci + k)
            n = 48 + 6 * k
            motion = cls if cls != "cut" else ("pan", "drift", "zoom")[k % 3]
            frames = moving_frames(rng, n, w, h, motion, noise=1.0,
                                   cut_at=n // 2 if cls == "cut" else None)
            wr.write(os.path.join(root, cls, f"{cls}_{k:02d}.avi"), frames, "libxvid",
                     opts="bf=2", bit_rate=bit_rate)


def planes(bgr, pixfmt):
    """The bytes of a BGR image in FFmpeg's ``pixfmt``, planes one after
    the other (av_image_fill_arrays at alignment 1)."""
    import cv2

    h, w = bgr.shape[:2]
    if pixfmt in ("yuv420p", "yuvj420p"):
        return i420(bgr)
    if pixfmt == "gray":
        return cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY).reshape(-1)
    if pixfmt == "rgb24":
        return np.ascontiguousarray(bgr[..., ::-1]).reshape(-1)
    if pixfmt in ("bgra", "bgr0"):
        return np.concatenate([bgr, np.full((h, w, 1), 255 if pixfmt == "bgra" else 0,
                                            np.uint8)], 2).reshape(-1)
    yuv = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV)
    y, u, v = (np.ascontiguousarray(yuv[..., k]) for k in range(3))
    if pixfmt.startswith(("yuv422p", "yuvj422p")):
        u, v = u[:, ::2], v[:, ::2]
    out = np.concatenate([y.reshape(-1), u.reshape(-1), v.reshape(-1)])
    if pixfmt.endswith("10le"):
        return (out.astype("<u2") << 2).view(np.uint8)
    return out


def write_frames(wr, path, frames, codec, pixfmt, opts=""):
    """BGR ``frames`` coded by ``codec`` from FFmpeg's ``pixfmt``."""
    return wr.write(path, [planes(f, pixfmt) for f in frames], codec, opts=opts, pixfmt=pixfmt,
                    size=frames[0].shape[1::-1])


def cv2_avi(path, frames, fourcc):
    import cv2

    h, w = frames[0].shape[:2]
    cw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), FPS, (w, h))
    if not cw.isOpened():
        raise RuntimeError(f"cv2 cannot write {fourcc}")
    for f in frames:
        cw.write(np.ascontiguousarray(f))
    cw.release()
    return path


# The lossless and Motion JPEG fixtures of the swscale route
# (``video/capture``): name -> (codec, pixel format, options, size, frames)
CAPTURE = {
    "hfyu_422_64x48": ("huffyuv", "yuv422p", "", (64, 48), 12),
    "hfyu_422_median_64x48": ("huffyuv", "yuv422p", "pred=median", (64, 48), 12),
    "hfyu_422_plane_ilme_64x480": ("huffyuv", "yuv422p", "pred=plane:flags=+ilme", (64, 480), 3),
    "hfyu_rgb24_plane_64x48": ("huffyuv", "rgb24", "pred=plane", (64, 48), 12),
    "hfyu_rgba_left_64x48": ("huffyuv", "bgra", "", (64, 48), 12),
    "ffvh_420_median_64x48": ("ffvhuff", "yuv420p", "pred=median", (64, 48), 12),
    "ffvh_420_plane_ilme_64x480": ("ffvhuff", "yuv420p", "pred=plane:flags=+ilme", (64, 480), 3),
    "ffvh_444_plane_64x48": ("ffvhuff", "yuv444p", "pred=plane", (64, 48), 12),
    "ffvh_444_median_ilme_64x480": ("ffvhuff", "yuv444p", "pred=median:flags=+ilme", (64, 480), 3),
    "ffvh_gray_median_64x48": ("ffvhuff", "gray", "pred=median", (64, 48), 12),
    "ffvh_422_context_64x48": ("ffvhuff", "yuv422p", "pred=median:context=1", (64, 48), 12),
    "ffv1_v0_420_rice_64x48": ("ffv1", "yuv420p", "level=0:coder=rice", (64, 48), 30),
    "ffv1_v1_422_range_66x47": ("ffv1", "yuv422p", "level=1:coder=range_def", (66, 47), 30),
    "ffv1_v1_rgb_tab_64x48": ("ffv1", "bgr0", "level=1:coder=range_tab:context=1", (64, 48), 30),
    "ffv1_v3_444_tab_slices_64x48": ("ffv1", "yuv444p",
                                     "level=3:coder=range_tab:context=1:slices=4", (64, 48), 30),
    "ffv1_v3_gray_rice_slices_64x48": ("ffv1", "gray", "level=3:coder=rice:slices=6", (64, 48),
                                       30),
    "ffv1_v3_rgba_range_64x48": ("ffv1", "bgra", "level=3:coder=range_def:slices=4", (64, 48), 30),
    "mjpeg_422_64x48": ("mjpeg", "yuvj422p", "", (64, 48), 12),
    "mjpeg_422_66x47": ("mjpeg", "yuvj422p", "", (66, 47), 12),
    "mjpeg_444_64x48": ("mjpeg", "yuvj444p", "", (64, 48), 12),
    # forms left to item 8b
    "ffvh_422p10_64x48": ("ffvhuff", "yuv422p10le", "", (64, 48), 2),
}


def write_capture_fixtures(out_dir=OUT):
    import cv2

    d = os.path.join(out_dir, "capture")
    os.makedirs(d, exist_ok=True)
    wr = AviWriter()
    for k, (name, (codec, pixfmt, opts, (w, h), n)) in enumerate(sorted(CAPTURE.items())):
        frames = moving_frames(np.random.default_rng(300 + k), n, w, h,
                               ("pan", "drift", "zoom")[k % 3])
        write_frames(wr, os.path.join(d, name + ".avi"), frames, codec, pixfmt, opts)
    small = moving_frames(np.random.default_rng(299), 30, 64, 48, "drift")
    cv2_avi(os.path.join(d, "cv2_hfyu_64x48.avi"), small[:12], "HFYU")
    cv2_avi(os.path.join(d, "cv2_ffv1_64x48.avi"), small, "FFV1")
    # grey Motion JPEG (FFmpeg's mjpeg encoder writes no grey): cv2's JPEGs
    grey = [cv2.imencode(".jpg", cv2.cvtColor(f, cv2.COLOR_BGR2GRAY))[1].tobytes()
            for f in small[:12]]
    wr.mux(os.path.join(d, "mjpeg_gray_64x48.avi"), grey, "mjpeg", "MJPG", 64, 48)
    # HuffYUV 1.x: no extradata, biBitCount 16 (4:2:2, left), classic tables
    codes = _classic_codes()
    yuv = [np.frombuffer(planes(f, "yuv422p"), np.uint8) for f in small[:6]]
    wr.mux(os.path.join(d, "hfyu_classic_422_64x48.avi"),
           [classic_huffyuv_frame(p[:3072], p[3072:4608], p[4608:], codes) for p in yuv],
           "huffyuv", "HFYU", 64, 48, bits=16)
    # two-field Motion JPEG: each packet the two 64x24 fields of a 64x48 frame
    fields = [cv2.imencode(".jpg", f[::2])[1].tobytes() + cv2.imencode(".jpg", f[1::2])[1].tobytes()
              for f in small[:4]]
    wr.mux(os.path.join(d, "mjpeg_fields_64x48.avi"), fields, "mjpeg", "MJPG", 64, 48)
    # FFV1 at 10 bits, a form left to item 8b
    write_frames(wr, os.path.join(d, "ffv1_422p10_64x48.avi"), small[:3], "ffv1", "yuv422p10le",
                 "level=1")


def _classic_codes():
    """HuffYUV's classic codes (code, length) for luma and chroma, from
    ``csrc/host/huffyuv_tables.h``."""
    import re

    src = open(os.path.join(os.path.dirname(HERE), "csrc", "host", "huffyuv_tables.h")).read()
    tab = {m.group(1): [int(x) for x in re.findall(r"\d+", m.group(2))]
           for m in re.finditer(r"(kClassic\w+)\[\d+\] = \{([^}]*)\}", src)}

    def lengths(rle):
        bits = "".join(f"{b:08b}" for b in rle)
        out, i = [], 0
        while len(out) < 256:
            rep, val = int(bits[i: i + 3], 2), int(bits[i + 3: i + 8], 2)
            i += 8
            if rep == 0:
                rep, i = int(bits[i: i + 8], 2), i + 8
            out += [val] * rep
        return out

    return (list(zip(tab["kClassicAddLuma"], lengths(tab["kClassicShiftLuma"]))),
            list(zip(tab["kClassicAddChroma"], lengths(tab["kClassicShiftChroma"]))))


def classic_huffyuv_frame(y, u, v, codes):
    """A HuffYUV 1.x frame of planar 4:2:2 with the left predictor and the
    classic tables, as FFmpeg's encoder lays out its version-2 form: V0, Y1,
    U0, Y0 raw, then Y U Y V residuals, each plane predicted from the sample
    before it in raster order; the bits in 32-bit little-endian words."""
    luma, chroma = codes
    ys, us, vs = (np.asarray(p, np.int64).reshape(-1) for p in (y, u, v))
    ry = (ys[2:] - ys[1:-1]) & 255
    ru = (us[1:] - us[:-1]) & 255
    rv = (vs[1:] - vs[:-1]) & 255
    parts = [f"{vs[0]:08b}{ys[1]:08b}{us[0]:08b}{ys[0]:08b}"]
    for i in range(len(ru)):
        for val, table in ((ry[2 * i], luma), (ru[i], chroma), (ry[2 * i + 1], luma),
                           (rv[i], chroma)):
            code, n = table[val]
            parts.append(format(code, f"0{n}b"))
    bits = "".join(parts)
    bits += "0" * (-len(bits) % 32)
    words = np.frombuffer(int(bits, 2).to_bytes(len(bits) // 8, "big"), ">u4")
    return words.astype("<u4").tobytes()


# The capture_avi_train corpus: class folder, writer, pixel format (FFmpeg
# encoder) or FourCC (cv2), clips, frames a clip; 320x240 at 25 fps. Many
# short clips, so that a batch of 32 sequences of 8 rarely takes two from one
# file; the FFV1 clips (cv2's GOP is 12) run past their second key frame, so
# a sequence may start up to 8 frames into a GOP
CAPTURE_CORPUS = (("hfyu", "huffyuv", "yuv422p", 4, 10), ("ffv1", "cv2", "FFV1", 2, 16),
                  ("mjpeg", "mjpeg", "yuvj422p", 24, 10))


def write_capture_corpus(root):
    w, h = CORPUS_SIZE
    wr = AviWriter()
    for ci, (cls, codec, form, clips, n) in enumerate(CAPTURE_CORPUS):
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        for k in range(clips):
            frames = moving_frames(np.random.default_rng(5000 + 100 * ci + k), n,
                                   w, h, ("pan", "drift", "zoom")[(ci + k) % 3], noise=1.0)
            path = os.path.join(root, cls, f"{cls}_{k:02d}.avi")
            if codec == "cv2":
                cv2_avi(path, frames, form)
            else:
                write_frames(wr, path, frames, codec, form,
                             "pred=median" if codec == "huffyuv" else "")


# The MPEG-1/2 fixtures (``video/mpeg``) FFmpeg's encoders write: name ->
# (encoder, muxer, options, size, frames, pixel format, custom matrices)
MPEG = {
    "mpeg1_bf2_64x48.mpg": ("mpeg1video", "mpeg", "bf=2", (64, 48), 30, "yuv420p", False),
    "mpeg1_matrices_64x48.m1v": ("mpeg1video", "mpeg1video", "bf=1", (64, 48), 30, "yuv420p",
                                 True),
    "mpeg1_odd_170x98.mpg": ("mpeg1video", "mpeg", "bf=2", (170, 98), 30, "yuv420p", False),
    "mpeg2_intra_vlc_64x48.ts": ("mpeg2video", "mpegts", "bf=2:intra_vlc=1", (64, 48), 30,
                                 "yuv420p", False),
    "mpeg2_nonlinear_64x48.ts": ("mpeg2video", "mpegts", "bf=2:non_linear_quant=1:qmax=28",
                                 (64, 48), 30, "yuv420p", False),
    "mpeg2_altscan_64x48.ts": ("mpeg2video", "mpegts", "bf=2:alternate_scan=1", (64, 48), 30,
                               "yuv420p", False),
    "mpeg2_dc10_64x48.m2v": ("mpeg2video", "mpeg2video", "bf=2:dc=10", (64, 48), 30, "yuv420p",
                             False),
    "mpeg2_matrices_64x48.ts": ("mpeg2video", "mpegts", "bf=2", (64, 48), 30, "yuv420p", True),
    "mpeg2_odd_170x98.ts": ("mpeg2video", "mpegts", "bf=2", (170, 98), 30, "yuv420p", False),
    "mpeg2_interlaced_64x48.ts": ("mpeg2video", "mpegts", "bf=2:flags=+ildct+ilme", (64, 48),
                                  30, "yuv420p", False),
    "mpeg2_422_64x48.ts": ("mpeg2video", "mpegts", "bf=2", (64, 48), 30, "yuv422p", False),
    "mpeg2_dvd_64x48.vob": ("mpeg2video", "vob", "bf=2", (64, 48), 30, "yuv420p", False),
    "mpeg2_bf2_64x48.avi": ("mpeg2video", "avi", "bf=2", (64, 48), 30, "yuv420p", False),
    "mpeg2_long_96x64.ts": ("mpeg2video", "mpegts", "bf=2", (96, 64), 90, "yuv420p", False),
}
# cv2's four MPEG-1/2 writes: name -> FourCC
MPEG_CV2 = {"cv2_mpg2_160x120.ts": "mpg2", "cv2_mpeg_160x120.mpg": "MPEG",
            "cv2_mpg1_160x120.mpg": "mpg1", "cv2_pim1_160x120.avi": "PIM1"}


def mpeg_matrices():
    """The custom intra and non-intra matrices of the ``*_matrices``
    fixtures (raster order; the intra DC entry 8)."""
    rng = np.random.default_rng(64)
    intra = rng.integers(8, 60, 64).astype(np.uint16)
    intra[0] = 8
    return intra, rng.integers(10, 40, 64).astype(np.uint16)


def cv2_video(path, frames, fourcc, fps=FPS):
    import cv2

    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    if not wr.isOpened():
        raise RuntimeError(f"cv2 cannot write {fourcc} into {path}")
    for f in frames:
        wr.write(np.ascontiguousarray(f))
    wr.release()
    return path


def write_mpeg_fixtures(out_dir=OUT):
    d = os.path.join(out_dir, "mpeg")
    os.makedirs(d, exist_ok=True)
    wr = AviWriter()
    for k, (name, (codec, muxer, opts, (w, h), n, pixfmt, mats)) in enumerate(sorted(MPEG.items())):
        frames = moving_frames(np.random.default_rng(400 + k), n, w, h,
                               ("pan", "drift", "zoom")[k % 3], cut_at=n // 2 if k % 4 == 0 else None)
        if pixfmt == "yuv420p":
            wr.write(os.path.join(d, name), frames, codec, opts=opts, muxer=muxer,
                     matrices=mpeg_matrices() if mats else None)
        else:
            wr.write(os.path.join(d, name), [planes(f, pixfmt) for f in frames], codec, opts=opts,
                     pixfmt=pixfmt, size=(w, h), muxer=muxer)
    pan = moving_frames(np.random.default_rng(420), 40, 160, 120, "pan")
    for name, fourcc in MPEG_CV2.items():
        cv2_video(os.path.join(d, name), pan, fourcc)
    # two cv2 TS segments of different sizes, byte-concatenated: a real
    # mid-stream change of the sequence header
    a = cv2_video(os.path.join(d, "a.ts"), moving_frames(np.random.default_rng(421), 10, 64, 48,
                                                          "drift"), "mpg2")
    b = cv2_video(os.path.join(d, "b.ts"), moving_frames(np.random.default_rng(422), 10, 32, 24,
                                                          "zoom"), "mpg2")
    with open(os.path.join(d, "spliced_64x48_32x24.ts"), "wb") as f:
        f.write(open(a, "rb").read() + open(b, "rb").read())
    os.remove(a)
    os.remove(b)


def mpeg_corpus_files(root):
    return [os.path.join(root, c, f"{c}_{k:02d}.{ext}") for c, ext in (("ts", "ts"), ("ps", "mpg"))
            for k in range(16)]


def write_mpeg_corpus(root):
    """The mpeg_ts_train corpus: 16 MPEG-2 clips in TS (cv2's ``mpg2``: a GOP
    of 12, two B-pictures, open GOPs) and 16 MPEG-1 clips in PS (cv2's
    ``mpg1``: I- and P-pictures), 320x240 at 25 fps, 48 frames each."""
    w, h = CORPUS_SIZE
    for ci, (cls, fourcc) in enumerate((("ts", "mpg2"), ("ps", "mpg1"))):
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        for k in range(16):
            frames = moving_frames(np.random.default_rng(7000 + 100 * ci + k), 48, w, h,
                                   ("pan", "drift", "zoom")[(ci + k) % 3], noise=1.0,
                                   cut_at=24 if k % 5 == 4 else None)
            cv2_video(os.path.join(root, cls, f"{cls}_{k:02d}." + ("ts" if cls == "ts" else "mpg")),
                      frames, fourcc)


# --------------------------------------------------------------------------- Matroska
# EBML IDs the rewrites read or write
MKV_SEGMENT, MKV_SEEKHEAD, MKV_CUES, MKV_TRACKS, MKV_CLUSTER = (0x18538067, 0x114D9B74,
                                                              0x1C53BB6B, 0x1654AE6B, 0x1F43B675)
MKV_TRACK_ENTRY, MKV_TRACK_NUMBER, MKV_DEFAULT_DURATION = 0xAE, 0xD7, 0x23E383
MKV_SIMPLE_BLOCK, MKV_BLOCK_GROUP, MKV_BLOCK, MKV_REFERENCE_BLOCK = 0xA3, 0xA0, 0xA1, 0xFB
# the master elements the rewrites descend into
_MKV_MASTERS = {MKV_SEGMENT, MKV_TRACKS, MKV_TRACK_ENTRY, MKV_CLUSTER, MKV_BLOCK_GROUP}


def _ebml_num(data, pos, keep_marker):
    """An EBML variable-length number at ``pos``: (value, length)."""
    first = data[pos]
    n = 1
    while not first & (0x80 >> (n - 1)):
        n += 1
    v = first if keep_marker else first & (0xFF >> n)
    for b in data[pos + 1: pos + n]:
        v = (v << 8) | b
    return v, n


def ebml_parse(data, start=0, end=None):
    """The elements of ``data[start:end]`` as [id, body] pairs, a master's
    body (``_MKV_MASTERS``) a list of its children, any other's its bytes."""
    end = len(data) if end is None else end
    out, pos = [], start
    while pos < end:
        eid, il = _ebml_num(data, pos, True)
        size, sl = _ebml_num(data, pos + il, False)
        body = pos + il + sl
        if size == (1 << (7 * sl)) - 1:  # unknown: to the end of the parent
            size = end - body
        out.append([eid, ebml_parse(data, body, body + size) if eid in _MKV_MASTERS
                    else bytes(data[body: body + size])])
        pos = body + size
    return out


def _ebml_size(n, unknown=False):
    if unknown:
        return bytes([0x01]) + b"\xff" * 7
    k = 1
    while n >= (1 << (7 * k)) - 1:
        k += 1
    return ((1 << (7 * k)) | n).to_bytes(k, "big") if k < 8 else (
        (1 << 56) | n).to_bytes(8, "big")


def ebml_write(elements, unknown=()):
    """The bytes of [id, body] elements; the IDs in ``unknown`` are written
    with an unknown size (all ones), as a live writer leaves them."""
    out = bytearray()
    for eid, body in elements:
        b = ebml_write(body, unknown) if isinstance(body, list) else bytes(body)
        out += eid.to_bytes((eid.bit_length() + 7) // 8, "big")
        out += _ebml_size(len(b), eid in unknown) + b
    return bytes(out)


def ebml_uint(eid, v):
    return [eid, v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big")]


def mkv_segment(elements):
    return next(body for eid, body in elements if eid == MKV_SEGMENT)


def mkv_without_index(elements):
    """The file without its SeekHead and Cues (whose offsets a rewrite
    would break): libavformat then finds the clusters by reading them."""
    seg = mkv_segment(elements)
    seg[:] = [e for e in seg if e[0] not in (MKV_SEEKHEAD, MKV_CUES)]
    return elements


def mkv_blocks(elements, track=1):
    """The video track's SimpleBlocks: (cluster, index in it, body)."""
    for eid, cl in mkv_segment(elements):
        if eid != MKV_CLUSTER:
            continue
        for i, (bid, body) in enumerate(cl):
            if bid == MKV_SIMPLE_BLOCK and body[0] == 0x80 | track:
                yield cl, i, body


def mkv_track_entry(elements, number=1):
    tracks = next(b for e, b in mkv_segment(elements) if e == MKV_TRACKS)
    return next(t for e, t in tracks if e == MKV_TRACK_ENTRY and
                any(i == MKV_TRACK_NUMBER and int.from_bytes(v, "big") == number for i, v in t))


def mkv_one_cluster(elements):
    """Every Cluster's blocks in the first Cluster, their 16-bit timestamps
    restated against its Timestamp (FFmpeg's muxer starts a Cluster a
    frame for large frames)."""
    seg = mkv_segment(elements)
    clusters = [cl for eid, cl in seg if eid == MKV_CLUSTER]
    base = None
    blocks = []
    for cl in clusters:
        t = int.from_bytes(next(b for i, b in cl if i == 0xE7), "big")
        base = t if base is None else base
        for i, b in cl:
            if i == MKV_SIMPLE_BLOCK:
                rel = t + int.from_bytes(b[1:3], "big", signed=True) - base
                blocks.append([i, b[:1] + rel.to_bytes(2, "big", signed=True) + b[3:]])
    first = clusters[0]
    first[:] = [[i, b] for i, b in first if i == 0xE7] + blocks
    seg[:] = [e for e in seg if e[0] != MKV_CLUSTER or e[1] is first]
    return elements


def mkv_laced(elements, kind, per_block=4):
    """Runs of ``per_block`` SimpleBlocks merged into one block with Xiph
    (``xiph``), EBML (``ebml``) or fixed-size (``fixed``) lacing, in one
    Cluster; the frames after a block's first take their timestamps from
    the track's DefaultDuration."""
    mkv_one_cluster(elements)
    for eid, cl in mkv_segment(elements):
        if eid != MKV_CLUSTER:
            continue
        out, run = [], []

        def flush():
            if not run:
                return
            if len(run) == 1:
                out.append([MKV_SIMPLE_BLOCK, run[0]])
            else:
                frames = [b[4:] for b in run]
                sizes = [len(f) for f in frames]
                head = bytearray(run[0][:3]) + bytes([run[0][3] | {"xiph": 2, "fixed": 4,
                                                                   "ebml": 6}[kind]])
                head.append(len(frames) - 1)
                if kind == "xiph":
                    for n in sizes[:-1]:
                        head += b"\xff" * (n // 255) + bytes([n % 255])
                elif kind == "ebml":
                    head += _ebml_size(sizes[0])
                    for a, b in zip(sizes[:-2], sizes[1:-1]):
                        # a signed difference in two bytes: 14 bits, biased
                        head += ((1 << 14) | (b - a + (1 << 13) - 1)).to_bytes(2, "big")
                elif len(set(sizes)) != 1:
                    raise ValueError("fixed lacing needs frames of one size")
                out.append([MKV_SIMPLE_BLOCK, bytes(head) + b"".join(frames)])
            run.clear()

        for bid, body in cl:
            if bid == MKV_SIMPLE_BLOCK and body[0] == 0x81:
                run.append(body)
                if len(run) == per_block:
                    flush()
            else:
                flush()
                out.append([bid, body])
        flush()
        cl[:] = out
    return elements


def mkv_compressed(elements, algo):
    """Every video frame stored with a ContentEncoding: header stripping
    (``algo`` 3: the bytes every frame starts with go into the track's
    ContentCompSettings) or zlib (``algo`` 0)."""
    import zlib

    blocks = list(mkv_blocks(elements))
    frames = [b[4:] for _, _, b in blocks]
    if algo == 3:
        k = 0
        while all(len(f) > k + 1 and f[k] == frames[0][k] for f in frames):
            k += 1
        prefix = frames[0][:k]
        for cl, i, b in blocks:
            cl[i][1] = b[:4] + b[4 + k:]
        comp = [ebml_uint(0x4254, 3), [0x4255, prefix]]
    else:
        for cl, i, b in blocks:
            cl[i][1] = b[:4] + zlib.compress(b[4:], 9)
        comp = [ebml_uint(0x4254, 0)]
    encoding = [0x6240, [ebml_uint(0x5031, 0), ebml_uint(0x5032, 1), ebml_uint(0x5033, 0),
                         [0x5034, comp]]]
    mkv_track_entry(elements).append([0x6D80, [encoding]])
    return elements


def mkv_block_groups(elements):
    """Every video SimpleBlock as a BlockGroup: its Block, and a
    ReferenceBlock (one frame back) unless it is a key frame."""
    for cl, i, b in list(mkv_blocks(elements)):
        group = [[MKV_BLOCK, b[:3] + bytes([b[3] & 0x7F]) + b[4:]]]
        if not b[3] & 0x80:
            group.append([MKV_REFERENCE_BLOCK, (-40 & 0xFF).to_bytes(1, "big")])
        cl[i] = [MKV_BLOCK_GROUP, group]
    return elements


def mkv_with_audio_first(elements):
    """An A_PCM/INT/LIT track (8 kHz mono, 16 bits) as track 1, the video
    renumbered 2, and a block of silence beside each video block."""
    import struct

    tracks = next(b for e, b in mkv_segment(elements) if e == MKV_TRACKS)
    video = mkv_track_entry(elements)
    for item in video:
        if item[0] == MKV_TRACK_NUMBER:
            item[1] = b"\x02"
        if item[0] == 0x73C5:  # TrackUID
            item[1] = b"\x02"
    audio = [MKV_TRACK_ENTRY, [ebml_uint(MKV_TRACK_NUMBER, 1), ebml_uint(0x73C5, 1),
                               ebml_uint(0x83, 2), [0x86, b"A_PCM/INT/LIT"],
                               [0xE1, [[0xB5, struct.pack(">d", 8000.0)],
                                       ebml_uint(0x9F, 1), ebml_uint(0x6264, 16)]]]]
    tracks.insert(0, audio)
    for eid, cl in mkv_segment(elements):
        if eid != MKV_CLUSTER:
            continue
        out = []
        for bid, body in cl:
            if bid == MKV_SIMPLE_BLOCK and body[0] == 0x81:
                out.append([MKV_SIMPLE_BLOCK, bytes([0x81]) + body[1:3] + b"\x80" + bytes(640)])
                body = bytes([0x82]) + body[1:]
            out.append([bid, body])
        cl[:] = out
    return elements


def mkv_vfw_i420(elements, w, h):
    """A V_UNCOMPRESSED I420 track restated as V_MS/VFW/FOURCC with a
    BITMAPINFOHEADER (the form a VfW capture remuxed from AVI takes)."""
    import struct

    entry = mkv_track_entry(elements)
    bih = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 12, b"I420", w * h * 3 // 2, 0, 0, 0, 0)
    entry[:] = [[e, b] for e, b in entry if e not in (0x86, 0x63A2)]
    entry += [[0x86, b"V_MS/VFW/FOURCC"], [0x63A2, bih]]
    return elements


# The Matroska fixtures (``video/mkv``) FFmpeg's encoders write through the
# helper's ``matroska`` muxer: name -> (encoder, options, size, frames, pixel
# format, timing (packet durations and DefaultDuration), global headers)
MKV = {
    "mpeg4_bf_160x120.mkv": ("mpeg4", "bf=2", (160, 120), 40, "yuv420p", True, -1),
    "mpeg4_bf_long_96x64.mkv": ("mpeg4", "bf=2", (96, 64), 90, "yuv420p", True, -1),
    "xvid_bf_160x120.mkv": ("libxvid", "bf=2", (160, 120), 40, "yuv420p", True, -1),
    "xvid_packed_160x120.mkv": ("libxvid", "bf=2", (160, 120), 40, "yuv420p", True, 0),
    "ffv1_v3_420_64x48.mkv": ("ffv1", "level=3:g=1:slicecrc=1:slices=4", (64, 48), 80,
                              "yuv420p", True, -1),
    "mpeg2_bf2_64x48.mkv": ("mpeg2video", "bf=2", (64, 48), 30, "yuv420p", True, -1),
    "nodefault_mpeg4_64x48.mkv": ("mpeg4", "bf=2", (64, 48), 30, "yuv420p", False, -1),
    "nodefault_ffv1_64x48.mkv": ("ffv1", "level=1", (64, 48), 20, "yuv420p", False, -1),
    "h264_64x48.mkv": ("libx264", "", (64, 48), 12, "yuv420p", True, -1),
}
# cv2's Matroska writes: name -> (FourCC, fps)
MKV_CV2 = {"cv2_xvid_64x48.mkv": ("XVID", FPS), "cv2_mjpg_64x48.mkv": ("MJPG", FPS),
           "cv2_ffv1_64x48.mkv": ("FFV1", FPS), "cv2_mpg2_64x48.mkv": ("MPG2", FPS),
           "cv2_mpg1_64x48.mkv": ("MPG1", FPS), "cv2_hfyu_64x48.mkv": ("HFYU", FPS),
           "cv2_mp4v_2997_64x48.mkv": ("mp4v", 30000 / 1001),
           "vp8_64x48.webm": ("VP80", FPS), "vp9_64x48.webm": ("VP90", FPS)}
# the forms FFmpeg's muxer does not write, rewritten from its files: name ->
# (source encoder, options, pixel format, the rewrite)
MKV_REWRITES = {
    "unknown_sizes_mpeg4_64x48.mkv": ("mpeg4", "bf=2", "yuv420p", "unknown"),
    "lace_xiph_mjpeg_64x48.mkv": ("mjpeg", "", "yuvj420p", "xiph"),
    "lace_ebml_mjpeg_64x48.mkv": ("mjpeg", "", "yuvj420p", "ebml"),
    "lace_fixed_i420_64x48.mkv": ("rawvideo", "", "yuv420p", "fixed"),
    "headerstrip_mjpeg_64x48.mkv": ("mjpeg", "", "yuvj420p", "strip"),
    "zlib_mpeg4_64x48.mkv": ("mpeg4", "bf=2", "yuv420p", "zlib"),
    "audio_first_mpeg4_64x48.mkv": ("mpeg4", "bf=2", "yuv420p", "audio"),
    "blockgroups_mpeg4_64x48.mkv": ("mpeg4", "bf=2", "yuv420p", "groups"),
}


def mkv_rewrite(data, form, size):
    """One of ``MKV_REWRITES``' forms of an FFmpeg Matroska file."""
    el = mkv_without_index(ebml_parse(data))
    unknown = ()
    if form == "unknown":
        unknown = (MKV_SEGMENT, MKV_CLUSTER)
    elif form in ("xiph", "ebml"):
        mkv_laced(el, form)
    elif form == "fixed":
        mkv_laced(mkv_vfw_i420(el, *size), form)
    elif form == "strip":
        mkv_compressed(el, 3)
    elif form == "zlib":
        mkv_compressed(el, 0)
    elif form == "audio":
        mkv_with_audio_first(el)
    elif form == "groups":
        mkv_block_groups(el)
    return ebml_write(el, unknown)


def write_mkv_fixtures(out_dir=OUT):
    import tempfile

    d = os.path.join(out_dir, "mkv")
    os.makedirs(d, exist_ok=True)
    wr = AviWriter()
    for k, (name, (codec, opts, (w, h), n, pixfmt, timing, gh)) in enumerate(sorted(MKV.items())):
        frames = moving_frames(np.random.default_rng(500 + k), n, w, h,
                               ("pan", "drift", "zoom")[k % 3],
                               cut_at=n // 2 if k % 4 == 0 else None)
        wr.write(os.path.join(d, name), [planes(f, pixfmt) for f in frames], codec, opts=opts,
                 pixfmt=pixfmt, size=(w, h), muxer="matroska", timing=timing, global_header=gh)
    small = moving_frames(np.random.default_rng(520), 30, 64, 48, "drift")
    for name, (fourcc, fps) in MKV_CV2.items():
        # HuffYUV is as large as raw video: 12 frames
        cv2_video(os.path.join(d, name), small[:12] if fourcc == "HFYU" else small, fourcc,
                  fps=fps)
    with tempfile.TemporaryDirectory() as tmp:
        for k, (name, (codec, opts, pixfmt, form)) in enumerate(sorted(MKV_REWRITES.items())):
            # raw frames: 12
            frames = moving_frames(np.random.default_rng(540 + k), 12 if form == "fixed" else 24,
                                   64, 48, ("pan", "drift", "zoom")[k % 3])
            src = wr.write(os.path.join(tmp, name), [planes(f, pixfmt) for f in frames], codec,
                           opts=opts, pixfmt=pixfmt, size=(64, 48), muxer="matroska",
                           timing=True)
            with open(src, "rb") as f:
                data = mkv_rewrite(f.read(), form, (64, 48))
            with open(os.path.join(d, name), "wb") as f:
                f.write(data)


def mkv_corpus_files(root):
    return [os.path.join(root, c, f"{c}_{k:02d}.mkv") for c in ("xvid", "ffv1") for k in range(16)]


# The mkv_archive_train corpus: 16 Xvid clips with B-frames at 600 kbit/s
# (48 frames) and 16 FFV1 version 3 clips at 4:2:0 with the archival
# settings (intra-only, slice CRCs, 16 slices; 12 frames: FFV1 at 320x240
# is ~36 KB a frame), 320x240 at 25 fps, in Matroska
MKV_CORPUS = (("xvid", "libxvid", "bf=2", 48, 600_000),
              ("ffv1", "ffv1", "level=3:g=1:slicecrc=1:slices=16", 12, 0))


def write_mkv_corpus(root):
    w, h = CORPUS_SIZE
    wr = AviWriter()
    for ci, (cls, codec, opts, n, rate) in enumerate(MKV_CORPUS):
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        for k in range(16):
            frames = moving_frames(np.random.default_rng(8000 + 100 * ci + k), n, w, h,
                                   ("pan", "drift", "zoom")[(ci + k) % 3], noise=1.0,
                                   cut_at=n // 2 if k % 5 == 4 else None)
            wr.write(os.path.join(root, cls, f"{cls}_{k:02d}.mkv"), frames, codec, opts=opts,
                     bit_rate=rate, muxer="matroska", timing=True)


def write_huffyuv_tables(path=os.path.join(os.path.dirname(HERE), "csrc", "host",
                                           "huffyuv_tables.h")):
    """``csrc/host/huffyuv_tables.h`` from this machine's libavcodec: its
    four classic HuffYUV tables, found by their first bytes."""
    import ctypes.util

    lib = ctypes.util.find_library("avcodec") or "libavcodec.so.59"
    if not os.path.isabs(lib):
        lib = os.path.join("/usr/lib/x86_64-linux-gnu", lib)
    data = open(lib, "rb").read()

    def table(name, head, size):
        i = data.find(bytes(head))
        if i < 0 or data.count(bytes(head)) != 1:
            raise RuntimeError(f"{name} not found once in {lib}")
        rows = [", ".join(str(x) for x in data[i + k: i + min(k + 16, size)])
                for k in range(0, size, 16)]
        return (f"const uint8_t {name}[{size}] = {{\n" + "".join(f"    {r},\n" for r in rows)
                + "};\n")

    body = "\n".join([
        table("kClassicShiftLuma", [34, 36, 35, 69, 135, 232, 9, 16, 10, 24], 42),
        table("kClassicShiftChroma", [66, 36, 37, 38, 39, 40, 41, 75, 76, 77], 59),
        table("kClassicAddLuma", [3, 9, 5, 12, 10, 35, 32, 29, 27, 50], 256),
        table("kClassicAddChroma", [3, 1, 2, 2, 2, 2, 3, 3, 7, 5], 256)])
    head = ("// HuffYUV's classic Huffman tables, which a stream without tables in its\n"
            "// extradata (HuffYUV 1.x) codes with: the code lengths run-length coded as\n"
            "// read_len_table reads them, and the codes. Written by\n"
            "// ``python dali_tpu_torch/testdata/make_video_corpus.py --tables`` from the\n"
            "// tables of this machine's libavcodec (huffyuvdec.c's classic_shift_luma,\n"
            "// classic_shift_chroma, classic_add_luma and classic_add_chroma).\n"
            "#pragma once\n\n#include <cstdint>\n\nnamespace video {\n\n")
    with open(path, "w") as f:
        f.write(head + body + "\n}  // namespace video\n")
    return path


def write_mpeg12_tables(path=os.path.join(os.path.dirname(HERE), "csrc", "host",
                                          "mpeg12_tables.h")):
    """``csrc/host/mpeg12_tables.h`` from this machine's libavcodec: the
    MPEG-1/2 video VLC tables of ISO/IEC 13818-2 Annex B as FFmpeg holds
    them (mpeg12data.c, mpeg12.c), each found once by its first bytes."""
    import ctypes.util
    import struct

    lib = ctypes.util.find_library("avcodec") or "libavcodec.so.59"
    if not os.path.isabs(lib):
        lib = os.path.join("/usr/lib/x86_64-linux-gnu", lib)
    data = open(lib, "rb").read()

    def find(name, head, size, check=None):
        # copies of one table (the encoder's and the decoder's) count once
        i, hits = data.find(bytes(head)), {}
        while i >= 0:
            if check is None or check(i):
                hits.setdefault(data[i: i + size], i)
            i = data.find(bytes(head), i + 1)
        if len(hits) != 1:
            raise RuntimeError(f"{name} not found once in {lib}")
        return next(iter(hits.values()))

    def u8(name, head, n, check=None):
        i = find(name, head, n, check)
        return list(data[i: i + n])

    def u16(name, head, n, check=None):
        i = find(name, head, 2 * n, check)
        return list(struct.unpack(f"<{n}H", data[i: i + 2 * n]))

    def eob_is(code, length):
        return lambda i: struct.unpack("<2H", data[i + 4 * 112: i + 4 * 113]) == (code, length)

    tables = [
        ("uint16_t", "kMpeg1Vlc", "[113][2]",
         u16("ff_mpeg1_vlc_table", struct.pack("<8H", 3, 2, 4, 4, 5, 5, 6, 7), 226, eob_is(2, 2))),
        ("uint16_t", "kMpeg2Vlc", "[113][2]",
         u16("ff_mpeg2_vlc_table", struct.pack("<8H", 2, 2, 6, 3, 7, 4, 28, 5), 226, eob_is(6, 4))),
        ("uint8_t", "kRun", "[111]", u8("ff_mpeg12_run", [0] * 40 + [1] * 18 + [2] * 5, 111)),
        ("uint8_t", "kLevel", "[111]",
         u8("ff_mpeg12_level", list(range(1, 41)) + list(range(1, 19)) + list(range(1, 6)), 111)),
        ("uint8_t", "kMbAddrIncr", "[36][2]",
         u8("ff_mpeg12_mbAddrIncrTable", [1, 1, 3, 3, 2, 3, 3, 4, 2, 4, 3, 5, 2, 5, 7, 7], 72)),
        ("uint8_t", "kMbPattern", "[64][2]",
         u8("ff_mpeg12_mbPatTable", [1, 9, 11, 5, 9, 5, 13, 6, 13, 4, 23, 7, 19, 7, 31, 8], 128)),
        ("uint8_t", "kMotion", "[17][2]",
         u8("ff_mpeg12_mbMotionVectorTable", [1, 1, 1, 2, 1, 3, 1, 4, 3, 6, 5, 7, 4, 7, 3, 7, 11, 9,
                                              10, 9, 9, 9, 17, 10, 16, 10, 15, 10, 14, 10, 13, 10, 12, 10, 0, 0],
            34)),
        ("uint16_t", "kDcLumCode", "[12]",
         u16("ff_mpeg12_vlc_dc_lum_code", struct.pack("<6H", 4, 0, 1, 5, 6, 14), 12)),
        ("uint8_t", "kDcLumBits", "[12]",
         u8("ff_mpeg12_vlc_dc_lum_bits", [3, 2, 2, 3, 3, 4, 5, 6, 7, 8, 9, 9], 12)),
        ("uint16_t", "kDcChromaCode", "[12]",
         u16("ff_mpeg12_vlc_dc_chroma_code", struct.pack("<6H", 0, 1, 2, 6, 14, 30), 12)),
        ("uint8_t", "kDcChromaBits", "[12]",
         u8("ff_mpeg12_vlc_dc_chroma_bits", [2, 2, 2, 3, 4, 5, 6, 7, 8, 9, 10, 10], 12)),
        ("uint16_t", "kDefaultIntraMatrix", "[64]",
         u16("ff_mpeg1_default_intra_matrix", struct.pack("<8H", 8, 16, 19, 22, 26, 27, 29, 34),
             64)),
        ("uint8_t", "kNonLinearQscale", "[32]",
         u8("ff_mpeg2_non_linear_qscale", [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 18, 20], 32)),
        ("uint8_t", "kAlternateScan", "[64]",
         u8("ff_alternate_vertical_scan", [0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40], 64)),
        ("uint8_t", "kZigzag", "[64]",
         u8("ff_zigzag_direct", [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25], 64)),
    ]
    body = []
    for typ, name, dims, vals in tables:
        rows = [", ".join(str(x) for x in vals[k: k + 16]) for k in range(0, len(vals), 16)]
        flat = "".join(f"    {r},\n" for r in rows)
        if dims.count("[") == 2:
            # pairs
            pairs = [f"{{{vals[k]}, {vals[k + 1]}}}" for k in range(0, len(vals), 2)]
            flat = "".join("    " + ", ".join(pairs[k: k + 8]) + ",\n" for k in range(0, len(pairs), 8))
        body.append(f"const {typ} {name}{dims} = {{\n{flat}}};\n")
    head = ("// The MPEG-1/2 video tables of ISO/IEC 11172-2 / 13818-2 Annex B as FFmpeg's\n"
            "// decoder holds them: the DCT coefficient codes of Tables B.14 and B.15\n"
            "// (code, length; escape and end of block last) with their runs and levels,\n"
            "// the macroblock address increment (increments 1-33, escape, stuffing, an\n"
            "// end of slice), coded block pattern, motion code and DC size codes, the\n"
            "// default intra matrix (raster order), the non-linear quantiser scales and\n"
            "// the two scans. Written by ``python\n"
            "// dali_tpu_torch/testdata/make_video_corpus.py --tables`` from this machine's\n"
            "// libavcodec (mpeg12data.c, mpeg12.c, mpegvideodata.c).\n"
            "#pragma once\n\n#include <cstdint>\n\nnamespace video {\nnamespace mpeg12_tables {\n\n")
    with open(path, "w") as f:
        f.write(head + "\n".join(body) + "\n}  // namespace mpeg12_tables\n}  // namespace video\n")
    return path


def main(argv):
    args = [a for a in argv[1:] if not a.startswith("--")]
    out_dir = args[0] if args else OUT
    if "--tables" in argv:
        print(write_huffyuv_tables())
        print(write_mpeg12_tables())
        return
    if "--capture" in argv:
        write_capture_fixtures(out_dir)
        write_capture_corpus(os.path.join(out_dir, "capture_corpus"))
        total = sum(os.path.getsize(os.path.join(dd, f)) for sub in ("capture", "capture_corpus")
                    for dd, _, fs in os.walk(os.path.join(out_dir, sub)) for f in fs)
        print(f"{out_dir}: capture set {total} bytes")
        return
    if "--mkv" in argv:
        write_mkv_fixtures(out_dir)
        write_mkv_corpus(os.path.join(out_dir, "mkv_corpus"))
        total = sum(os.path.getsize(os.path.join(dd, f)) for sub in ("mkv", "mkv_corpus")
                    for dd, _, fs in os.walk(os.path.join(out_dir, sub)) for f in fs)
        print(f"{out_dir}: Matroska set {total} bytes")
        return
    if "--mpeg" in argv:
        write_mpeg_fixtures(out_dir)
        write_mpeg_corpus(os.path.join(out_dir, "mpeg_corpus"))
        total = sum(os.path.getsize(os.path.join(dd, f)) for sub in ("mpeg", "mpeg_corpus")
                    for dd, _, fs in os.walk(os.path.join(out_dir, sub)) for f in fs)
        print(f"{out_dir}: MPEG-1/2 set {total} bytes")
        return
    if "--avi" in argv:
        write_avi_fixtures(out_dir)
        write_avi_corpus(os.path.join(out_dir, "avi_corpus"))
        total = sum(os.path.getsize(os.path.join(dd, f)) for sub in ("avi", "avi_corpus")
                    for dd, _, fs in os.walk(os.path.join(out_dir, sub)) for f in fs)
        print(f"{out_dir}: AVI set {total} bytes")
        return
    write_fixtures(out_dir)
    write_corpus(os.path.join(out_dir, "corpus"))
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(out_dir)
                for f in fs)
    print(f"{out_dir}: {total} bytes")


if __name__ == "__main__":
    main(sys.argv)
