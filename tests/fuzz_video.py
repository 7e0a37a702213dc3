"""Mutation probe of dali_tpu_torch's host video stack (``csrc/host/
mp4_demux.cc``, ``avi_demux.cc``, ``mpeg_ps_demux.cc``, ``mpeg_ts_demux.cc``,
``mkv_demux.cc`` with ``inflate.cc``,
``mpeg4_decode.cc``, ``mpeg12_decode.cc``, ``mjpeg_decode.cc`` with the JPEG
reader it takes, ``huffyuv_decode.cc``, ``ffv1_decode.cc``, ``sws_rgb.cc``,
``video_decode.cc``) under
AddressSanitizer and UndefinedBehaviorSanitizer, with libstdc++'s vector
annotations on (so a read past a vector's size within its capacity is
caught too).

It compiles those sources and ``tasking.cc`` with a small C++ harness,
then, for every input file, opens it unchanged and then ``--iters``
damaged copies (bit flips, random bytes, fake start codes: MPEG-4 VOLs,
MPEG-1/2 pictures, slices, sequence, GOP, extension, end and pack headers;
EBML sizes of all ones (unknown) and IDs of Clusters, SimpleBlocks and
BlockGroups; cuts, flips in the last 2 KiB where cv2's files keep
``moov``), alternately
from a path
and from memory, and reads each through RGB, planar and batched reads at
several starts and strides. Inputs: the committed MP4 and AVI fixtures
(Xvid with packed B-VOPs, FFmpeg's unpacked ones, Motion JPEG with and
without DHT, raw I420, a file without an index, the HuffYUV, FFV1 and
Motion JPEG 4:2:2/4:4:4/grey files of ``capture``, the MPEG-1/2 files of
``mpeg``: TS, PS, VOB, elementary streams and AVI, a splice, the Matroska
files of ``mkv``: every codec, lacing, ContentEncoding and unknown size),
one clip of each corpus, a TS and a PS cut mid-stream, and three
files whose frame size changes mid-stream (a smaller clip spliced in after
frame 5, one of the same macroblock grid, a smaller VOL before one P-VOP),
written with cv2 here, and cv2's MPEG-2 TS with its program map sections
damaged (section_length 0, program_info_length past the section). The swscale rebuild is also called on its own at
random sizes and strides of every format it takes. Any sanitizer report
ends the run non-zero.

    python tests/fuzz_video.py [--iters 150] [--work DIR]
"""

import argparse
import glob
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = os.path.join(ROOT, "dali_tpu_torch", "csrc", "host")

_HARNESS = r'''
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <string>
#include <vector>
extern "C" {
void* dali_tpu_torch_video_open(const char*, const unsigned char*, size_t, char*, int, int*);
int dali_tpu_torch_video_info(void*, int*, int*, long*, double*);
int dali_tpu_torch_video_read_frames(void*, long, int, int, unsigned char*);
int dali_tpu_torch_video_read_frames_yuv(void*, long, int, int, unsigned char*, unsigned char*, unsigned char*);
void dali_tpu_torch_video_read_batch(void*, void* const*, const long*, const int*, const int*,
                                     unsigned char* const*, unsigned char* const*, unsigned char* const*, int, int, int*);
void dali_tpu_torch_video_close(void*);
int dali_tpu_torch_sws_rgb(int, int, int, int, const unsigned char* const*, const int*,
                           unsigned char*);
void* dali_tpu_pool_create(int);
void dali_tpu_pool_destroy(void*);
}
static std::vector<unsigned char> load(const char* p) {
  FILE* f = fopen(p, "rb"); std::vector<unsigned char> d;
  if (!f) return d; fseek(f, 0, SEEK_END); d.resize(ftell(f)); fseek(f, 0, SEEK_SET);
  if (fread(d.data(), 1, d.size(), f) != d.size()) d.clear(); fclose(f); return d;
}
static long exercise(void* h, void* pool, std::mt19937& rng) {
  int w, hh; long n; double fps;
  dali_tpu_torch_video_info(h, &w, &hh, &n, &fps);
  if (w <= 0 || hh <= 0 || (long)w * hh > 4096L * 4096) return 0;
  long total = 0;
  int cnt = 8;
  std::vector<unsigned char> rgb((size_t)w * hh * 3 * cnt), y((size_t)w * hh * cnt),
      u((size_t)((w + 1) / 2) * ((hh + 1) / 2) * cnt), v(u.size());
  long starts[] = {0, 5, 2, 80, 1, 40, 0};
  for (long s : starts) {
    int g = dali_tpu_torch_video_read_frames(h, s, cnt, 1 + (rng() % 3), rgb.data());
    if (g > 0) total += g;
    g = dali_tpu_torch_video_read_frames_yuv(h, s, cnt, 1, y.data(), u.data(), v.data());
    if (g > 0) total += g;
  }
  void* hs[2] = {h, h}; long st[2] = {3, 0}; int co[2] = {cnt, cnt}, sr[2] = {1, 2}, res[2];
  unsigned char* ys[2] = {y.data(), rgb.data()};
  unsigned char* us[2] = {u.data(), u.data()};
  unsigned char* vs[2] = {v.data(), v.data()};
  // both into the same buffers: the read order is fixed within one handle
  dali_tpu_torch_video_read_batch(pool, hs, st, co, sr, ys, us, vs, 1, 1, res);
  return total;
}
int main(int argc, char** argv) {
  int iters = atoi(argv[1]);
  std::mt19937 rng(1234);
  void* pool = dali_tpu_pool_create(2);
  long opened = 0, frames = 0, cases = 0;
  char err[512]; int kind;
  for (int a = 2; a < argc; a++) {
    std::vector<unsigned char> base = load(argv[a]);
    if (base.empty()) continue;
    for (int it = 0; it < iters; it++) {
      std::vector<unsigned char> d = base;
      int mode = it % 6;
      int flips = it == 0 ? 0 : 1 + int(rng() % 8);
      for (int k = 0; k < flips; k++) {
        size_t pos = rng() % d.size();
        if (mode == 0) d[pos] ^= 1u << (rng() % 8);
        else if (mode == 1) d[pos] = rng();
        else if (mode == 2 && pos + 4 < d.size()) {
          static const unsigned char codes[] = {0x20, 0x2f, 0x00, 0x01, 0x07, 0xaf, 0xb3, 0xb5,
                                                0xb7, 0xb8, 0xba, 0xe0};
          d[pos] = 0; d[pos+1] = 0; d[pos+2] = 1; d[pos+3] = codes[rng() % 12];
        }
        else if (mode == 3) d.resize(pos + 1);
        else if (mode == 5 && pos + 9 < d.size()) {
          // EBML: a size of all ones, or a Cluster, SimpleBlock or BlockGroup ID
          static const unsigned char ids[][4] = {{0x1f, 0x43, 0xb6, 0x75}, {0xa3, 0x88, 0x81, 0},
                                                 {0xa0, 0x8c, 0xa1, 0x8a}};
          if (rng() & 1) {
            d[pos] = 0x01;
            for (int q = 1; q < 8; q++) d[pos + q] = 0xff;
          } else {
            memcpy(&d[pos], ids[rng() % 3], 4);
          }
        }
        else d[(d.size() - 1 - pos % 2048)] ^= 1u << (rng() % 8);  // the tail: moov in cv2's files
        if (d.empty()) break;
      }
      cases++;
      void* h;
      if (it & 1) {
        h = dali_tpu_torch_video_open(nullptr, d.data(), d.size(), err, sizeof err, &kind);
      } else {
        const char* tmp = getenv("FUZZ_CASE");
        FILE* f = fopen(tmp, "wb"); fwrite(d.data(), 1, d.size(), f); fclose(f);
        h = dali_tpu_torch_video_open(tmp, nullptr, 0, err, sizeof err, &kind);
      }
      if (!h) continue;
      opened++;
      frames += exercise(h, pool, rng);
      dali_tpu_torch_video_close(h);
    }
  }
  // the swscale rebuild alone: every format, sizes 1..80, padded strides
  long converted = 0;
  for (int it = 0; it < 40 * iters; it++) {
    int fmt = 1 + int(rng() % 7), w = 1 + int(rng() % 80), hh = 1 + int(rng() % 80);
    int pad = int(rng() % 9), bpp = fmt == 6 ? 3 : (fmt >= 4 ? 4 : 1);
    int strides[3] = {w * bpp + pad, (fmt == 1 ? (w + 1) / 2 : w) + pad, 0};
    strides[2] = strides[1];
    std::vector<unsigned char> pl[3];
    for (int k = 0; k < 3; k++) {
      pl[k].resize((size_t)strides[k] * hh + 1);
      for (auto& b : pl[k]) b = rng();
    }
    const unsigned char* ptr[3] = {pl[0].data(), pl[1].data(), pl[2].data()};
    std::vector<unsigned char> out((size_t)w * hh * 3);
    if (dali_tpu_torch_sws_rgb(fmt, it & 1, w, hh, ptr, strides, out.data()) == 0) converted++;
  }
  dali_tpu_pool_destroy(pool);
  printf("cases %ld opened %ld frames %ld sws %ld\n", cases, opened, frames, converted);
  return 0;
}
'''


def cut_files(work):
    """A TS and a PS cut mid-stream (F10's form): off the TS sync, and
    inside a pack."""
    out = []
    for name, cut in (("ts/ts_00.ts", 37 * 188 + 61), ("ps/ps_00.mpg", 9 * 2048 + 700)):
        data = open(os.path.join(ROOT, "dali_tpu_torch", "testdata", "video", "mpeg_corpus",
                                 name), "rb").read()
        path = os.path.join(work, "cut_" + os.path.basename(name))
        with open(path, "wb") as f:
            f.write(data[cut:])
        out.append(path)
    return out


def size_change_files(work):
    """The three files whose frame size changes mid-stream."""
    sys.path.insert(0, ROOT)
    from tests.test_torch_mpeg4 import _texture_clip
    from tests.write_video_reference import samples, stream_headers, with_samples

    big = open(_texture_clip(os.path.join(work, "big.mp4"), 24, 96, 64, seed=7), "rb").read()
    out = []
    for name, (w, h), vol_only in (("splice_small", (48, 32), False),
                                   ("splice_same_grid", (90, 60), False),
                                   ("vol_in_p_vop", (48, 32), True)):
        small = open(_texture_clip(os.path.join(work, f"s{w}.mp4"), 24, w, h, seed=8),
                     "rb").read()
        sb, ss = samples(big), samples(small)
        hdr = stream_headers(small)
        pay = (sb[:5] + [hdr + sb[5]] + sb[6:]) if vol_only else \
            (sb[:6] + [hdr + ss[0]] + ss[1:18])
        path = os.path.join(work, f"{name}.mp4")
        with open(path, "wb") as f:
            f.write(with_samples(big, pay))
        out.append(path)
    return out


def pmt_damage_files(work):
    """cv2's MPEG-2 TS with its program map sections damaged: section_length
    0 and program_info_length past the section, in every PMT and in the
    first only (the later ones name the stream)."""
    data = open(os.path.join(ROOT, "dali_tpu_torch", "testdata", "video", "mpeg",
                             "cv2_mpg2_160x120.ts"), "rb").read()
    pids = [((data[k + 1] & 0x1f) << 8 | data[k + 2], k) for k in range(0, len(data), 188)]
    pat = next(k for pid, k in pids if pid == 0 and data[k + 1] & 0x40)
    s = pat + 5 + data[pat + 4]
    pmt_pid = (data[s + 10] & 0x1f) << 8 | data[s + 11]
    sections = [k + 5 + data[k + 4] for pid, k in pids if pid == pmt_pid and data[k + 1] & 0x40]
    out = []
    for name, fields in (("pmt_len0", ((1, 0xf0, 0), (2, 0, 0))),
                         ("pmt_info_past", ((10, 0xff, 0x0f), (11, 0, 0xff)))):
        for which in ("all", "first"):
            d = bytearray(data)
            for sec in sections[:1] if which == "first" else sections:
                for off, keep, put in fields:
                    d[sec + off] = (d[sec + off] & keep) | put
            path = os.path.join(work, f"{name}_{which}.ts")
            with open(path, "wb") as f:
                f.write(bytes(d))
            out.append(path)
    return out


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--work", default=None)
    args = ap.parse_args(argv)
    work = args.work or tempfile.mkdtemp(prefix="video_fuzz_")
    os.makedirs(work, exist_ok=True)
    drv = os.path.join(work, "fuzz.cc")
    exe = os.path.join(work, "fuzz")
    with open(drv, "w") as f:
        f.write(_HARNESS)
    srcs = [os.path.join(HOST, s) for s in ("mp4_demux.cc", "avi_demux.cc", "mpeg_ps_demux.cc",
                                            "mpeg_ts_demux.cc", "mkv_demux.cc", "inflate.cc",
                                            "mpeg4_decode.cc",
                                            "mpeg12_decode.cc", "mjpeg_decode.cc", "jpeg_huff.cc",
                                            "jpeg_arith.cc", "huffyuv_decode.cc",
                                            "ffv1_decode.cc", "sws_rgb.cc", "video_decode.cc",
                                            "tasking.cc")]
    subprocess.run(["g++", "-O1", "-g", "-fsanitize=address,undefined",
                    "-D_GLIBCXX_SANITIZE_VECTOR", "-fno-sanitize-recover=all",
                    "-ffp-contract=off", "-std=c++17", "-I", HOST] + srcs + [drv, "-o", exe,
                                                                            "-lpthread"],
                   check=True)
    fixtures = os.path.join(ROOT, "dali_tpu_torch", "testdata", "video")
    files = sorted(glob.glob(os.path.join(fixtures, "*.mp4")))
    files += [os.path.join(fixtures, "corpus", c, f"{c}_00.mp4") for c in ("cut", "pan", "drift")]
    files += sorted(glob.glob(os.path.join(fixtures, "avi", "*.avi")))
    files += [os.path.join(fixtures, "avi_corpus", "cut", "cut_00.avi")]
    files += sorted(glob.glob(os.path.join(fixtures, "capture", "*.avi")))
    files += [os.path.join(fixtures, "capture_corpus", c, f"{c}_00.avi")
              for c in ("hfyu", "ffv1", "mjpeg")]
    files += sorted(glob.glob(os.path.join(fixtures, "mpeg", "*")))
    files += [os.path.join(fixtures, "mpeg_corpus", "ts", "ts_00.ts"),
              os.path.join(fixtures, "mpeg_corpus", "ps", "ps_00.mpg")]
    files += sorted(glob.glob(os.path.join(fixtures, "mkv", "*")))
    files += [os.path.join(fixtures, "mkv_corpus", c, f"{c}_00.mkv") for c in ("xvid", "ffv1")]
    files += cut_files(work)
    files += size_change_files(work)
    files += pmt_damage_files(work)
    env = dict(os.environ, FUZZ_CASE=os.path.join(work, "case.mp4"))
    return subprocess.run([exe, str(args.iters)] + files, env=env).returncode


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
