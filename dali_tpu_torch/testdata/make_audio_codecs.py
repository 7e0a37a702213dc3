"""The MP3 and Ogg Vorbis fixtures of dali_tpu_torch's audio decode
(``testdata/audio_codecs``) and the card's MP3 and Vorbis corpora.

The streams come from FFmpeg 5's encoders (libmp3lame through the ``mp3``
muxer, libvorbis through the ``ogg`` muxer), reached through a small C
helper compiled at run time against this machine's libavformat,
libavcodec and libswresample. The forms no encoder writes (intensity
stereo, mixed blocks, CRC-protected frames) are made from LAME's frames
by editing their header and side-info bits or by re-packing their main
data (``Mp3Frames``), and the damaged streams by cutting or corrupting
whole streams. The card's corpora: ``corpus_mp3`` (32 clips of
make_audio_corpus's signals, 48 kHz mono MP3 at 64 kbit/s, Common Voice's
form) and ``corpus_vorbis`` (8 clips, 48 kHz mono Vorbis).

The reference decode of each short fixture (``reference.npz``, what the
card's machine, which has no FFmpeg, holds the port against) is written
afterwards by ``tests/write_audio_codecs_reference.py``, outside this
package, since it runs dali_tpu.

Run on a machine with FFmpeg's libraries and headers, from the repo root:

    python dali_tpu_torch/testdata/make_audio_codecs.py [out_dir]
    python tests/write_audio_codecs_reference.py [out_dir]
    python dali_tpu_torch/testdata/make_audio_codecs.py --tables
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "audio_codecs")
CORPUS_CLIPS = 32

_HELPER_C = r"""
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
#include <string.h>

/* Encode interleaved float32 PCM with encoder ``codec`` into container
   ``format`` at ``path``. ``codec_opts`` and ``mux_opts`` are "k=v:k=v"
   option strings; ``bit_rate`` > 0 sets CBR/ABR, ``quality`` > -99 sets
   the encoder's VBR quality (qscale). Returns 0, or a negative code. */
int encode_file(const float *pcm, long frames, int channels, int rate, const char *codec,
                const char *format, const char *path, long bit_rate, double quality,
                const char *codec_opts, const char *mux_opts) {
  const AVCodec *c = avcodec_find_encoder_by_name(codec);
  if (!c) return -1;
  AVFormatContext *fmt = NULL;
  if (avformat_alloc_output_context2(&fmt, NULL, format, path) < 0 || !fmt) return -2;
  AVCodecContext *enc = avcodec_alloc_context3(c);
  AVStream *st = avformat_new_stream(fmt, c);
  av_channel_layout_default(&enc->ch_layout, channels);
  enc->sample_rate = rate;
  enc->sample_fmt = c->sample_fmts[0];
  for (int i = 0; c->sample_fmts[i] != AV_SAMPLE_FMT_NONE; i++)
    if (c->sample_fmts[i] == AV_SAMPLE_FMT_FLTP) enc->sample_fmt = AV_SAMPLE_FMT_FLTP;
  enc->time_base = (AVRational){1, rate};
  if (bit_rate > 0) enc->bit_rate = bit_rate;
  if (quality > -99) {
    enc->flags |= AV_CODEC_FLAG_QSCALE;
    enc->global_quality = (int)(quality * FF_QP2LAMBDA);
  }
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER) enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  AVDictionary *copts = NULL, *mopts = NULL;
  av_dict_parse_string(&copts, codec_opts, "=", ":", 0);
  av_dict_parse_string(&mopts, mux_opts, "=", ":", 0);
  int rc = -3;
  SwrContext *swr = NULL;
  AVFrame *frm = av_frame_alloc();
  AVPacket *pkt = av_packet_alloc();
  do {
    if (avcodec_open2(enc, c, &copts) < 0) break;
    if (avcodec_parameters_from_context(st->codecpar, enc) < 0) break;
    st->time_base = enc->time_base;
    if (avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) break;
    if (avformat_write_header(fmt, &mopts) < 0) break;
    if (swr_alloc_set_opts2(&swr, &enc->ch_layout, enc->sample_fmt, rate, &enc->ch_layout,
                            AV_SAMPLE_FMT_FLT, rate, 0, NULL) < 0 || swr_init(swr) < 0) break;
    const int chunk = enc->frame_size > 0 ? enc->frame_size : 1024;
    long pos = 0;
    int fail = 0;
    for (;;) {
      AVFrame *send = NULL;
      if (pos < frames) {
        int n = (int)(frames - pos < chunk ? frames - pos : chunk);
        frm->nb_samples = n;
        av_channel_layout_copy(&frm->ch_layout, &enc->ch_layout);
        frm->format = enc->sample_fmt;
        frm->sample_rate = rate;
        if (av_frame_get_buffer(frm, 0) < 0) { fail = 1; break; }
        const uint8_t *src[1] = {(const uint8_t *)(pcm + (size_t)pos * channels)};
        if (swr_convert(swr, frm->extended_data, n, src, n) < 0) { fail = 1; break; }
        frm->pts = pos;
        pos += n;
        send = frm;
      }
      if (avcodec_send_frame(enc, send) < 0) { fail = 1; break; }
      int r;
      while ((r = avcodec_receive_packet(enc, pkt)) == 0) {
        av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
        pkt->stream_index = 0;
        if (av_interleaved_write_frame(fmt, pkt) < 0) { fail = 1; break; }
      }
      if (send) av_frame_unref(frm);
      if (fail || r == AVERROR_EOF) break;
      if (r != AVERROR(EAGAIN)) { fail = 1; break; }
    }
    if (fail) break;
    if (av_write_trailer(fmt) < 0) break;
    rc = 0;
  } while (0);
  av_dict_free(&copts);
  av_dict_free(&mopts);
  av_frame_free(&frm);
  av_packet_free(&pkt);
  swr_free(&swr);
  avcodec_free_context(&enc);
  if (fmt->pb) avio_closep(&fmt->pb);
  avformat_free_context(fmt);
  return rc;
}
"""


class Encoder:
    """FFmpeg's encoders through the compiled helper."""

    def __init__(self):
        self._dir = tempfile.mkdtemp(prefix="audio_codecs_")
        src = os.path.join(self._dir, "helper.c")
        so = os.path.join(self._dir, "helper.so")
        with open(src, "w") as f:
            f.write(_HELPER_C)
        subprocess.run(["gcc", "-O2", "-shared", "-fPIC", "-o", so, src,
                        "-I/usr/include/x86_64-linux-gnu", "-lavformat", "-lavcodec",
                        "-lavutil", "-lswresample"], check=True)
        self._lib = ctypes.CDLL(so)
        f = self._lib.encode_file
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
                      ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long,
                      ctypes.c_double, ctypes.c_char_p, ctypes.c_char_p]

    def encode(self, pcm, rate, codec, fmt, bit_rate=0, quality=-100.0, codec_opts="",
               mux_opts=""):
        pcm = np.ascontiguousarray(pcm, np.float32)
        ch = 1 if pcm.ndim == 1 else pcm.shape[1]
        path = os.path.join(self._dir, "out." + fmt)
        rc = self._lib.encode_file(pcm.ctypes.data, pcm.shape[0], ch, int(rate), codec.encode(),
                                   fmt.encode(), path.encode(), int(bit_rate), float(quality),
                                   codec_opts.encode(), mux_opts.encode())
        if rc != 0:
            raise RuntimeError(f"encode {codec}/{fmt} failed: {rc}")
        with open(path, "rb") as f:
            return f.read()

    def mp3(self, pcm, rate, bit_rate=0, quality=-100.0, joint=True, xing=True):
        return self.encode(pcm, rate, "libmp3lame", "mp3", bit_rate, quality,
                           f"joint_stereo={int(joint)}", f"write_xing={int(xing)}")

    def vorbis(self, pcm, rate, quality):
        # pages of 0.1 s, so that short streams span several
        return self.encode(pcm, rate, "libvorbis", "ogg", 0, quality,
                           mux_opts="page_duration=100000")


# ------------------------------------------------------------------ normative tables
# The decoders' constant tables are those of the standards: the Huffman code
# tables of ISO/IEC 11172-3 Annex B (Table B.7), its synthesis window (Table
# B.3, whose values are integers over 2^16) and the floor-1 inverse dB table
# of the Vorbis I specification (section 10.1). No machine-readable copy of
# either document is at hand, so ``write_codec_tables`` reads them from the
# data of this machine's libmp3lame (its Huffman tables, which carry each
# code's sign bits in its length) and libavcodec (the window and the dB
# table), checks them (every Huffman table a complete prefix code, the
# window's last value 75038 / 2^16), and writes ``csrc/host/audio_tables.h``.

_LIBDIR = "/usr/lib/x86_64-linux-gnu"
_BIG_VALUE_SIZES = {1: 2, 2: 3, 3: 3, 5: 4, 6: 4, 7: 6, 8: 6, 9: 6, 10: 8, 11: 8, 12: 8, 13: 16,
                    15: 16, 16: 16, 24: 16}


def _elf_relative_relocs(path):
    out = subprocess.run(["readelf", "-rW", path], capture_output=True, text=True,
                         check=True).stdout
    rel = {}
    for line in out.splitlines():
        f = line.split()
        if len(f) >= 4 and f[2] == "R_X86_64_RELATIVE":
            rel[int(f[0], 16)] = int(f[3], 16)
    return rel


def _elf_va_to_offset(path):
    out = subprocess.run(["readelf", "-lW", path], capture_output=True, text=True,
                         check=True).stdout
    loads = []
    for line in out.splitlines():
        f = line.split()
        if f and f[0] == "LOAD":
            loads.append((int(f[2], 16), int(f[1], 16), int(f[5], 16)))  # va, offset, filesz

    def conv(va):
        for v, o, n in loads:
            if v <= va < v + n:
                return va - v + o
        raise ValueError(hex(va))
    return conv


def _find_all(blob, pat):
    out, i = [], blob.find(pat)
    while i >= 0:
        out.append(i)
        i = blob.find(pat, i + 1)
    return out


def mp3_huffman_tables():
    """{table: (codes, lengths)} for the big-value tables 1-24 (index x * size
    + y) and the count1 tables 32-33 (index vwxy), sign bits excluded."""
    path = os.path.join(_LIBDIR, "libmp3lame.so.0")
    blob = open(path, "rb").read()
    conv = _elf_va_to_offset(path)
    rel = _elf_relative_relocs(path)
    # table 1's codes {1, 1, 1, 0}: the entry pointing at them is ht[1]
    t1 = [i for i in _find_all(blob, np.array([1, 1, 1, 0], "<u2").tobytes())]
    entry = [a for a, t in rel.items() if conv(t) in t1 and rel.get(a + 8) is not None]
    if len(entry) != 1:
        raise RuntimeError("libmp3lame's Huffman table list not found")
    ht0 = entry[0] - 8 - 24
    tables = {}
    for t in list(_BIG_VALUE_SIZES) + [32, 33]:
        e = ht0 + 24 * t
        n = 16 if t >= 32 else _BIG_VALUE_SIZES[t] ** 2
        codes = np.frombuffer(blob[conv(rel[e + 8]):][:2 * n], "<u2").astype(np.int64)
        lens = np.frombuffer(blob[conv(rel[e + 16]):][:n], np.uint8).astype(np.int64)
        if t >= 32:
            nz = np.array([bin(v).count("1") for v in range(16)])
            codes = codes >> nz  # LAME stores the count1 codes shifted by their sign bits
        else:
            s = _BIG_VALUE_SIZES[t]
            x, y = np.divmod(np.arange(n), s)
            nz = (x != 0).astype(np.int64) + (y != 0)
        lens = lens - nz
        words = sorted(format(int(c), f"0{int(ln)}b") for c, ln in zip(codes, lens))
        if (sum(2.0 ** -int(ln) for ln in lens) != 1.0 or any(c >= 1 << ln for c, ln in zip(
                codes, lens)) or any(b.startswith(a) for a, b in zip(words, words[1:]))):
            raise RuntimeError(f"Huffman table {t} is not a complete prefix code")
        tables[t] = (codes, lens)
    return tables


def mp3_synth_window():
    """D[0..256] of the synthesis window, in units of 2^-16."""
    blob = open(os.path.join(_LIBDIR, "libavcodec.so.59"), "rb").read()
    at = _find_all(blob, np.array([0, -1, -1, -1, -1, -1, -1, -2, -2, -2, -2, -3], "<i4").tobytes())
    if len(at) != 1:
        raise RuntimeError("synthesis window not found")
    d = np.frombuffer(blob[at[0]:at[0] + 257 * 4], "<i4")
    if d[256] != 75038:
        raise RuntimeError("synthesis window misread")
    return d


def vorbis_floor1_db_table():
    blob = open(os.path.join(_LIBDIR, "libavcodec.so.59"), "rb").read()
    at = _find_all(blob, np.array([1.0649863e-07, 1.1341951e-07, 1.2079015e-07], "<f4").tobytes())
    if len(at) != 1:
        raise RuntimeError("floor-1 dB table not found")
    t = np.frombuffer(blob[at[0]:at[0] + 1024], "<f4")
    if t[255] != 1.0:
        raise RuntimeError("floor-1 dB table misread")
    return t


def write_codec_tables(path):
    lines = ["// The constant tables of the MP3 and Vorbis decoders, from their standards:",
             "// ISO/IEC 11172-3 Annex B Table B.7 (Huffman codes; big-value tables indexed",
             "// x * size + y, count1 tables by vwxy; lengths without the sign bits) and",
             "// Table B.3 (the synthesis window D[0..256], in units of 2^-16), and the",
             "// floor-1 inverse dB table of the Vorbis I specification, section 10.1.",
             "// Written by dali_tpu_torch/testdata/make_audio_codecs.py --tables.",
             "#pragma once", "#include <cstdint>", "", "namespace audio_tables {", ""]
    tabs = mp3_huffman_tables()
    for t, (codes, lens) in tabs.items():
        lines.append(f"static const uint16_t kHuffCodes{t}[{len(codes)}] = {{"
                     + ", ".join(str(int(c)) for c in codes) + "};")
        lines.append(f"static const uint8_t kHuffLens{t}[{len(lens)}] = {{"
                     + ", ".join(str(int(c)) for c in lens) + "};")
    d = mp3_synth_window()
    lines.append("static const int32_t kSynthWindow[257] = {"
                 + ", ".join(str(int(v)) for v in d) + "};")
    db = vorbis_floor1_db_table()
    lines.append("static const float kFloor1InverseDb[256] = {"
                 + ", ".join(f"{float(v):.8e}f" for v in db) + "};")
    if not np.array_equal(np.array([float(f"{float(v):.8e}") for v in db], np.float32), db):
        raise RuntimeError("dB table does not round-trip")
    lines += ["", "}  // namespace audio_tables", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))


# ------------------------------------------------------------------ MP3 frame editing
class Mp3Frames:
    """The Layer III frames of a stream (after its ID3v2 tag), with the bit
    offset of each side-information field, for making the forms no encoder
    writes out of LAME's frames."""

    _RATES = (44100, 48000, 32000)
    _KBPS = ((0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320),
             (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160))

    def __init__(self, data: bytes):
        self.data = bytearray(data)
        pos = 0
        if data[:3] == b"ID3":
            size = 0
            for b in data[6:10]:
                size = (size << 7) | (b & 0x7F)
            pos = 10 + size
        self.start = pos
        self.frames = []
        while pos + 4 <= len(data):
            h = int.from_bytes(data[pos:pos + 4], "big")
            if h >> 21 != 0x7FF:
                break
            f = self._header(h)
            f["offset"] = pos
            f["fields"] = self._side_info(pos, f)
            self.frames.append(f)
            pos += f["size"]
        self.end = pos

    def _header(self, h):
        mpeg1 = (h >> 19) & 3 == 3
        mpeg25 = not (h >> 20) & 1
        rate = self._RATES[(h >> 10) & 3] >> (0 if mpeg1 else 2 if mpeg25 else 1)
        kbps = self._KBPS[0 if mpeg1 else 1][(h >> 12) & 15]
        size = (144000 if mpeg1 else 72000) * kbps // rate + ((h >> 9) & 1)
        mode = (h >> 6) & 3
        return {"mpeg1": mpeg1, "rate": rate, "size": size, "mode": mode,
                "channels": 1 if mode == 3 else 2, "crc": not (h >> 16) & 1}

    def _side_info(self, pos, f):
        """{(gr, ch, name): (bit offset from the frame start, width)} and the
        frame-level fields under (None, None, name)."""
        bit = 32 + (16 if f["crc"] else 0)
        out = {}

        def take(key, n):
            nonlocal bit
            out[key] = (bit, n)
            bit += n
        nch = f["channels"]
        take((None, None, "main_data_begin"), 9 if f["mpeg1"] else 8)
        take((None, None, "private"), (5 if nch == 1 else 3) if f["mpeg1"] else nch)
        if f["mpeg1"]:
            for ch in range(nch):
                take((None, ch, "scfsi"), 4)
        for gr in range(2 if f["mpeg1"] else 1):
            for ch in range(nch):
                for name, n in (("part2_3_length", 12), ("big_values", 9), ("global_gain", 8),
                                ("scalefac_compress", 4 if f["mpeg1"] else 9),
                                ("window_switching", 1)):
                    take((gr, ch, name), n)
                if self.get(pos, out[(gr, ch, "window_switching")]):
                    for name, n in (("block_type", 2), ("mixed", 1), ("tables", 10),
                                    ("subblock_gain", 9)):
                        take((gr, ch, name), n)
                else:
                    for name, n in (("tables", 15), ("region0", 4), ("region1", 3)):
                        take((gr, ch, name), n)
                if f["mpeg1"]:
                    take((gr, ch, "preflag"), 1)
                take((gr, ch, "scalefac_scale"), 1)
                take((gr, ch, "count1table"), 1)
        out[(None, None, "end")] = (bit, 0)
        return out

    def get(self, pos, field):
        bit, n = field
        v = 0
        for i in range(n):
            b = pos * 8 + bit + i
            v = (v << 1) | ((self.data[b >> 3] >> (7 - (b & 7))) & 1)
        return v

    def set(self, pos, field, value):
        bit, n = field
        for i in range(n):
            b = pos * 8 + bit + i
            mask = 1 << (7 - (b & 7))
            if (value >> (n - 1 - i)) & 1:
                self.data[b >> 3] |= mask
            else:
                self.data[b >> 3] &= ~mask & 0xFF

    def field(self, f, key):
        return self.get(f["offset"], f["fields"][key])

    def put(self, f, key, value):
        self.set(f["offset"], f["fields"][key], value)

    def audio_frames(self):
        """The frames after a Xing/Info frame."""
        fr = self.frames
        if fr and (b"Xing" in self.data[fr[0]["offset"]:fr[0]["offset"] + 64]
                   or b"Info" in self.data[fr[0]["offset"]:fr[0]["offset"] + 64]):
            return fr[1:]
        return fr

    def main_data(self, f):
        """This frame's main data bits (its granules, in order) as a bit
        string, read through the reservoir."""
        fr = self.frames
        i = fr.index(f)
        side_end = f["offset"] + f["fields"][(None, None, "end")][0] // 8
        # the stream of main-data bytes up to this frame's own
        stream = bytearray()
        for g in fr[:i]:
            s = g["offset"] + g["fields"][(None, None, "end")][0] // 8
            stream += self.data[s:g["offset"] + g["size"]]
        begin = len(stream) - self.field(f, (None, None, "main_data_begin"))
        stream += self.data[side_end:f["offset"] + f["size"]]
        nbits = sum(self.field(f, (gr, ch, "part2_3_length"))
                    for gr in range(2 if f["mpeg1"] else 1) for ch in range(f["channels"]))
        bits = "".join(format(b, "08b") for b in stream[begin:begin + (nbits + 7) // 8])
        return bits[:nbits]


def _crc16(data: bytes, crc=0xFFFF):
    for byte in data:
        for i in range(8):
            bit = ((byte >> (7 - i)) & 1) ^ (crc >> 15)
            crc = ((crc << 1) & 0xFFFF) ^ (0x8005 if bit else 0)
    return crc


_SLEN1 = (0, 0, 0, 0, 3, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4)


def mp3_repacked(data: bytes, crc: bool = False, mixed: bool = False) -> bytes:
    """Each audio frame of an MPEG-1 stream re-packed as a 320 kbit/s frame
    holding its own main data (main_data_begin 0); the Info frame kept as it
    was. ``crc``: frames protected by a CRC-16. ``mixed``: every short-block
    granule made a mixed block, its first 18 scale factors (slen1 each)
    rewritten as the 17 a mixed block reads (the ninth dropped)."""
    m = Mp3Frames(data)
    out = bytearray(m.data[:m.start])
    audio = m.audio_frames()
    for f in m.frames:
        if f not in audio:
            out += m.data[f["offset"]:f["offset"] + f["size"]]
    n_mixed = 0
    for f in audio:
        assert f["mpeg1"]
        bits = m.main_data(f)
        head = bytearray(m.data[f["offset"]:f["offset"] + 4])
        h = int.from_bytes(head, "big")
        h = (h & ~(0xF << 12) & ~(1 << 9)) | (14 << 12)
        h = h & ~(1 << 16) if crc else h | (1 << 16)
        # the frame's side info moved to a frame without its CRC state
        side_at, side_end = (32 + (16 if f["crc"] else 0)), f["fields"][(None, None, "end")][0]
        side_bits = side_end - side_at
        frame = Mp3Frames.__new__(Mp3Frames)
        frame.data = bytearray(h.to_bytes(4, "big") + (b"\0\0" if crc else b"")
                               + m.get(f["offset"], (side_at, side_bits)).to_bytes(
                                   side_bits // 8, "big"))
        g = dict(f, crc=crc, offset=0)
        g["fields"] = frame._side_info(0, g)
        frame.put(g, (None, None, "main_data_begin"), 0)
        granules, at = [], 0
        for gr in range(2):
            for ch in range(f["channels"]):
                n = frame.field(g, (gr, ch, "part2_3_length"))
                gb = bits[at:at + n]
                at += n
                if (mixed and (gr, ch, "block_type") in g["fields"]
                        and frame.field(g, (gr, ch, "block_type")) == 2
                        and not frame.field(g, (gr, ch, "mixed"))):
                    slen1 = _SLEN1[frame.field(g, (gr, ch, "scalefac_compress"))]
                    gb = gb[:8 * slen1] + gb[9 * slen1:]
                    frame.put(g, (gr, ch, "mixed"), 1)
                    frame.put(g, (gr, ch, "part2_3_length"), len(gb))
                    n_mixed += 1
                granules.append(gb)
        bits = "".join(granules)
        if crc:
            side = bytes(frame.data[6:])
            frame.data[4:6] = _crc16(bytes(frame.data[2:4]) + side).to_bytes(2, "big")
        body = (int(bits + "0" * (-len(bits) % 8), 2).to_bytes((len(bits) + 7) // 8, "big")
                if bits else b"")
        size = 144000 * 320 // f["rate"]
        frame_bytes = bytes(frame.data) + body
        assert len(frame_bytes) <= size, (len(frame_bytes), size)
        out += frame_bytes + bytes(size - len(frame_bytes))
    assert not mixed or n_mixed > 0, "no short-block granule"
    out += m.data[m.end:]
    return bytes(out)


def mp3_with_intensity_stereo(data: bytes) -> bytes:
    """The intensity-stereo bit set in the mode extension of each joint
    stereo frame. In MPEG-2, where it changes how the right channel's scale
    factors read, only in frames whose right channel has scalefac_compress
    0 (no scale-factor bits either way)."""
    m = Mp3Frames(data)
    n = 0
    for f in m.audio_frames():
        if f["mode"] != 1:
            continue
        if not f["mpeg1"] and m.field(f, (0, 1, "scalefac_compress")) != 0:
            continue
        m.data[f["offset"] + 3] |= 0x10
        n += 1
    assert n > 0
    return bytes(m.data)


# ------------------------------------------------------------------ the fixtures
def _signal(rng, seconds, rate, channels=1):
    """Speech-like float32 PCM (make_audio_corpus's clip) with three noise
    bursts of sharp onset, so that encoders switch to short blocks; further
    channels follow the first closely (as joint stereo wants), each with a
    tone of its own."""
    from dali_tpu_torch.testdata.make_audio_corpus import speech_clip

    x = speech_clip(rng, seconds, rate)
    n = len(x)
    for t in (0.2, 0.5, 0.8):
        a = int(t * seconds * rate)
        m = min(n - a, int(0.03 * rate))
        env = np.exp(-np.arange(m) / (0.008 * rate)).astype(np.float32)
        x[a:a + m] += rng.standard_normal(m).astype(np.float32) * 0.3 * env
    if channels == 1:
        return x
    t = np.arange(n) / rate
    cols = [x] + [(0.8 * x + 0.05 * np.sin(2 * np.pi * (300 + 150 * c) * t)).astype(np.float32)
                  for c in range(1, channels)]
    return np.stack(cols, 1)


def id3v1_tag() -> bytes:
    return (b"TAG" + b"Fixture".ljust(30, b"\0") + b"dali_tpu_torch".ljust(30, b"\0")
            + bytes(30) + b"2026" + bytes(30) + b"\x0c")


def apev2_tag() -> bytes:
    """An APEv2 tag with a header, one text item and a footer."""
    item = (6).to_bytes(4, "little") + bytes(4) + b"Artist\0" + b"seeded"
    body_len = 32 + len(item)

    def block(flags):
        return (b"APETAGEX" + (2000).to_bytes(4, "little") + body_len.to_bytes(4, "little")
                + (1).to_bytes(4, "little") + flags.to_bytes(4, "little") + bytes(8))
    return block(0xA0000000) + item + block(0x80000000)


def mp3_fixtures(enc: Encoder, seed: int = 19):
    """{name: bytes} of every MP3 form, 0.1 s each (MPEG-2.5: 0.15 s)."""
    rng = np.random.default_rng(seed)
    sec = 0.1
    out = {}
    out["mpeg1_48k_mono_cbr64"] = enc.mp3(_signal(rng, sec, 48000), 48000, bit_rate=64000)
    js = enc.mp3(_signal(rng, sec, 44100, 2), 44100, bit_rate=128000)
    out["mpeg1_44k_joint_cbr128"] = js
    out["mpeg1_44k_stereo_vbr"] = enc.mp3(_signal(rng, sec, 44100, 2), 44100, quality=4.0,
                                          joint=False)
    out["mpeg1_32k_mono_cbr48"] = enc.mp3(_signal(rng, sec, 32000), 32000, bit_rate=48000)
    for rate in (16000, 22050, 24000):
        out[f"mpeg2_{rate // 1000}k_mono"] = enc.mp3(_signal(rng, sec, rate), rate, bit_rate=32000)
        out[f"mpeg2_{rate // 1000}k_joint"] = enc.mp3(_signal(rng, sec, rate, 2), rate,
                                                      bit_rate=48000)
    for rate in (8000, 11025, 12000):
        out[f"mpeg25_{rate // 1000}k_mono"] = enc.mp3(_signal(rng, 0.15, rate), rate,
                                                      bit_rate=16000)
    out["mpeg25_11k_joint"] = enc.mp3(_signal(rng, 0.15, 11025, 2), 11025, bit_rate=24000)
    base = enc.mp3(_signal(rng, sec, 48000), 48000, bit_rate=64000)
    out["no_lame_frame"] = enc.mp3(_signal(rng, sec, 48000), 48000, bit_rate=64000, xing=False)
    out["id3v1_apev2"] = base + apev2_tag() + id3v1_tag()
    # damaged: the last frame cut inside its main data; a frame's main data
    # overwritten with noise; the stream cut where a frame reaches back into
    # the reservoir of frames that are gone
    m = Mp3Frames(base)
    audio = m.audio_frames()
    last = audio[-1]
    side_end = last["offset"] + last["fields"][(None, None, "end")][0] // 8
    out["truncated"] = base[:side_end + 20]
    bad = bytearray(base)
    f = audio[len(audio) // 2]
    noise_at = f["offset"] + f["fields"][(None, None, "end")][0] // 8 + 8
    bad[noise_at:noise_at + 40] = rng.integers(0, 256, 40, dtype=np.uint8).tobytes()
    out["corrupt_frame"] = bytes(bad)
    cut = next(g for g in audio[2:] if m.field(g, (None, None, "main_data_begin")) > 0)
    out["cut_mid_reservoir"] = base[cut["offset"]:]
    # forms LAME never writes
    out["intensity_stereo_mpeg1"] = mp3_with_intensity_stereo(js)
    out["intensity_stereo_mpeg2"] = mp3_with_intensity_stereo(
        enc.mp3(_signal(rng, 0.2, 22050, 2), 22050, bit_rate=48000))
    out["mixed_blocks"] = mp3_repacked(js, mixed=True)
    out["crc_protected"] = mp3_repacked(js, crc=True)
    return out


def mp3_failing_fixtures(enc: Encoder, seed: int = 20):
    """Streams the reference rejects: a frame whose side info holds
    big_values > 288 mid-stream; and an MPEG-1 Layer II stream, which the
    port does not decode (ROADMAP item 4c)."""
    rng = np.random.default_rng(seed)
    base = enc.mp3(_signal(rng, 0.15, 48000), 48000, bit_rate=64000)
    m = Mp3Frames(base)
    f = m.audio_frames()[3]
    m.put(f, (0, 0, "big_values"), 300)
    return {"bad_side_info": bytes(m.data),
            "layer2": enc.encode(_signal(rng, 0.15, 48000), 48000, "mp2", "mp2", bit_rate=64000)}


def ogg_other_fixtures(enc: Encoder, seed: int = 22):
    """Ogg streams of codecs the reference reads and the port does not
    (ROADMAP item 4c): Opus and FLAC."""
    rng = np.random.default_rng(seed)
    return {"opus": enc.encode(_signal(rng, 0.1, 48000), 48000, "libopus", "ogg",
                               bit_rate=32000),
            "flac": enc.encode(_signal(rng, 0.1, 16000), 16000, "flac", "ogg")}


def vorbis_fixtures(enc: Encoder, seed: int = 21):
    rng = np.random.default_rng(seed)
    out = {}
    out["mono_16k"] = enc.vorbis(_signal(rng, 0.3, 16000), 16000, 3.0)
    out["mono_48k"] = enc.vorbis(_signal(rng, 0.15, 48000), 48000, 3.0)
    for name, q in (("low", -1.0), ("mid", 4.0), ("high", 9.0)):
        out[f"stereo_44k_q_{name}"] = enc.vorbis(_signal(rng, 0.15, 44100, 2), 44100, q)
    out["surround_51_22k"] = enc.vorbis(_signal(rng, 0.1, 22050, 6), 22050, 3.0)
    whole = enc.vorbis(_signal(rng, 0.4, 16000), 16000, 3.0)
    pages = [i for i in range(len(whole)) if whole.startswith(b"OggS", i)]
    out["truncated"] = whole[:pages[-2] + (pages[-1] - pages[-2]) // 2]
    return out


def card_corpus(enc: Encoder, root: str, n_clips: int = CORPUS_CLIPS):
    """The first ``n_clips`` clips of make_audio_corpus's corpus (seed 99,
    4-10 s, its int16 PCM) at 48 kHz as mono MP3, CBR 64 kbit/s (Common
    Voice's form), written as ``root/clips/cNNNN.mp3``."""
    from dali_tpu_torch.testdata.make_audio_corpus import speech_clip, to_int16

    os.makedirs(os.path.join(root, "clips"), exist_ok=True)
    rng = np.random.default_rng(99)
    for i in range(n_clips):
        pcm = to_int16(speech_clip(rng, float(rng.uniform(4.0, 10.0)), 48000))
        data = enc.mp3(pcm.astype(np.float32) / 32768.0, 48000, bit_rate=64000)
        with open(os.path.join(root, "clips", f"c{i:04d}.mp3"), "wb") as f:
            f.write(data)


def card_corpus_vorbis(enc: Encoder, root: str, n_clips: int = 8):
    """``n_clips`` speech-like clips of 1-2 s (seed 98) at 48 kHz as mono
    Ogg Vorbis at quality 3, written as ``root/clips/cNNNN.ogg``: the card's
    Vorbis batch."""
    from dali_tpu_torch.testdata.make_audio_corpus import speech_clip

    os.makedirs(os.path.join(root, "clips"), exist_ok=True)
    rng = np.random.default_rng(98)
    for i in range(n_clips):
        data = enc.vorbis(speech_clip(rng, float(rng.uniform(1.0, 2.0)), 48000), 48000, 3.0)
        with open(os.path.join(root, "clips", f"c{i:04d}.ogg"), "wb") as f:
            f.write(data)


def main(out_dir=OUT):
    enc = Encoder()
    os.makedirs(out_dir, exist_ok=True)
    streams = {**{f"mp3_{k}.mp3": v for k, v in mp3_fixtures(enc).items()},
               **{f"vorbis_{k}.ogg": v for k, v in vorbis_fixtures(enc).items()},
               **{f"fail_{k}.mp3": v for k, v in mp3_failing_fixtures(enc).items()},
               **{f"fail_ogg_{k}.ogg": v for k, v in ogg_other_fixtures(enc).items()}}
    for name, data in streams.items():
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)
    card_corpus(enc, os.path.join(out_dir, "corpus_mp3"))
    card_corpus_vorbis(enc, os.path.join(out_dir, "corpus_vorbis"))

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    if sys.argv[1:2] == ["--tables"]:
        write_codec_tables(os.path.join(os.path.dirname(HERE), "csrc", "host", "audio_tables.h"))
    else:
        main(*sys.argv[1:2])
