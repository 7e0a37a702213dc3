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

The reference decode of each fixture (``video/reference.npz``,
``video/avi_reference.npz``: what the card's machine, which has no FFmpeg,
holds the port against) is written afterwards by
``tests/write_video_reference.py``, outside this package, since it runs
dali_tpu.

Run on a machine with OpenCV and FFmpeg's libraries and headers, from the
repo root:

    python dali_tpu_torch/testdata/make_video_corpus.py [out_dir]
    python dali_tpu_torch/testdata/make_video_corpus.py --avi [out_dir]
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
#include <string.h>

/* Encodes n planar 4:2:0 frames with encoder ``codec`` (FourCC ``tag``
   when not empty, "k=v:k=v" options, pixel format ``pixfmt``) into the
   AVI muxer at ``path``; ``strip_dht`` drops every DHT segment of a JPEG
   packet. Returns 0, or a negative code. */
int encode_avi(const unsigned char* yuv, int n, int w, int h, int fps, const char* path,
               const char* codec, const char* tag, const char* opts, int pixfmt,
               long bit_rate, int strip_dht) {
  AVFormatContext* fmt = NULL;
  if (avformat_alloc_output_context2(&fmt, NULL, "avi", path) < 0) return -1;
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
  if (*tag) c->codec_tag = MKTAG(tag[0], tag[1], tag[2], tag[3]);
  AVDictionary* d = NULL;
  if (*opts) av_dict_parse_string(&d, opts, "=", ":", 0);
  int rc = avcodec_open2(c, cd, &d);
  av_dict_free(&d);
  if (rc < 0) return -3;
  avcodec_parameters_from_context(st->codecpar, c);
  st->time_base = c->time_base;
  if (avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) return -4;
  if (avformat_write_header(fmt, NULL) < 0) return -5;
  AVFrame* f = av_frame_alloc();
  f->width = w;
  f->height = h;
  f->format = pixfmt;
  av_frame_get_buffer(f, 0);
  AVPacket* pkt = av_packet_alloc();
  int cw = (w + 1) / 2, ch = (h + 1) / 2;
  long fs = (long)w * h + 2L * cw * ch;
  for (int i = 0; i <= n; i++) {
    if (i < n) {
      av_frame_make_writable(f);
      const unsigned char* s = yuv + i * fs;
      for (int y = 0; y < h; y++) memcpy(f->data[0] + y * f->linesize[0], s + y * w, w);
      for (int y = 0; y < ch; y++)
        memcpy(f->data[1] + y * f->linesize[1], s + (long)w * h + y * cw, cw);
      for (int y = 0; y < ch; y++)
        memcpy(f->data[2] + y * f->linesize[2], s + (long)w * h + (long)cw * ch + y * cw, cw);
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
                                         c.c_long, c.c_int]

    def write(self, path, frames, codec, tag="", opts="", pixfmt=YUV420P, bit_rate=0,
              strip_dht=False, fps=FPS):
        """``frames``: BGR images of one size."""
        yuv = np.ascontiguousarray(np.stack([i420(f) for f in frames]))
        h, w = frames[0].shape[:2]
        rc = self._lib.encode_avi(yuv.ctypes.data, len(yuv), w, h, fps, path.encode(),
                                  codec.encode(), tag.encode(), opts.encode(), pixfmt,
                                  bit_rate, int(strip_dht))
        if rc != 0:
            raise RuntimeError(f"{codec} into {path} failed: {rc}")
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


def main(argv):
    args = [a for a in argv[1:] if a != "--avi"]
    out_dir = args[0] if args else OUT
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
