"""Regenerate the committed image-form fixtures (``testdata/codecs``).

The forms an ImageNet-like corpus holds besides baseline YCbCr JPEGs, each
once, at ImageNet-like sizes (333-640 px), made from files of the ``rn50``
corpus:

* CMYK JPEGs with Adobe-inverted samples, 4:4:4 and 4:2:0 (PIL), and a YCCK
  JPEG (Adobe transform 2);
* an RGB-colour JPEG (Adobe transform 0), a 4:1:1 JPEG (cv2) and a YCbCr JPEG
  whose luma has h=4, v=2;
* a baseline JPEG whose first scan interleaves two of its three components;
* an 8-bit RGB PNG stored under a ``.JPEG`` name, as ImageNet's
  ``n02105855_2933.JPEG`` is; a 16-bit RGB PNG; a palette PNG with tRNS;
* a 24-bit BMP and an 8-bit RLE8 BMP;
* a progressive JPEG cut at 60% of its bytes;
* GIFs (PIL, and ``gif_bytes`` here): a 256-colour GIF87a, an interlaced
  16-colour one, a GIF89a with a transparent index, a 4-colour local colour
  table on an image offset in a larger screen, and a two-frame animation;
* WebPs (cv2): lossy at quality 85, lossless, and a VP8X file with an alpha
  chunk (PIL);
* TIFFs (``tiff_bytes`` here): LZW with predictor 2, tiled Deflate, 16-bit
  RGB and RGBA with unassociated alpha;
* a binary PPM (``pnm_bytes`` here).

``webp_corpus`` writes the ``rn50`` corpus again as WebP at quality 85
(``testdata/webp``, the input of the card's webdataset WebP path), and
``arith_corpus`` losslessly re-codes it with arithmetic coding
(``testdata/arith``, SOF9 and SOF10 in turn, the card's rn50_arith_train
path) through ``Transcoder``, a one-off libjpeg transcoder that the
arithmetic-coding tests build too.

Forms neither cv2 nor PIL writes (YCCK, RGB colour, h=4 luma, partly
interleaved scans) come from a one-off writer built here against the system
libjpeg (``jpeglib.h``, ``-ljpeg``); it is not part of the package. Needs
OpenCV (cv2), PIL, a C compiler and the libjpeg headers; reading the fixtures
needs none of them.

Usage: python dali_tpu_torch/testdata/make_codec_corpus.py [out_dir]
(``out_dir`` for the fixtures; the WebP and arithmetic corpora go to
``testdata/webp`` and ``testdata/arith``)
"""

from __future__ import annotations

import io
import os
import struct
import subprocess
import sys
import tempfile
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "codecs")
WEBP_CORPUS = os.path.join(HERE, "webp")
ARITH_CORPUS = os.path.join(HERE, "arith")

# A libjpeg writer for forms cv2 and PIL do not write. Arguments: raw input
# (rows of W*C bytes), output, W, H, C (3 RGB or 4 CMYK), colour space
# (ycc, rgb, ycck), quality, progressive (0/1), sampling "h,v;h,v;...",
# scans ("full" or "partial": the first scan interleaves components 0 and 1).
WRITER_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

int main(int argc, char** argv) {
  if (argc != 11) return 2;
  int W = atoi(argv[3]), H = atoi(argv[4]), C = atoi(argv[5]);
  unsigned char* px = malloc((size_t)W * H * C);
  FILE* in = fopen(argv[1], "rb");
  if (!in || fread(px, 1, (size_t)W * H * C, in) != (size_t)W * H * C) return 3;
  fclose(in);
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  FILE* out = fopen(argv[2], "wb");
  jpeg_stdio_dest(&c, out);
  c.image_width = W;
  c.image_height = H;
  c.input_components = C;
  c.in_color_space = C == 4 ? JCS_CMYK : JCS_RGB;
  jpeg_set_defaults(&c);
  jpeg_set_colorspace(&c, strcmp(argv[6], "rgb") == 0    ? JCS_RGB
                          : strcmp(argv[6], "ycck") == 0 ? JCS_YCCK
                                                          : JCS_YCbCr);
  jpeg_set_quality(&c, atoi(argv[7]), TRUE);
  const char* s = argv[9];
  for (int i = 0; i < c.num_components && *s; i++) {
    c.comp_info[i].h_samp_factor = atoi(s);
    s = strchr(s, ',') + 1;
    c.comp_info[i].v_samp_factor = atoi(s);
    while (*s && *s != ';') s++;
    if (*s) s++;
  }
  static jpeg_scan_info scans[2];
  if (strcmp(argv[10], "partial") == 0) {
    scans[0].comps_in_scan = 2;
    scans[0].component_index[0] = 0;
    scans[0].component_index[1] = 1;
    scans[1].comps_in_scan = 1;
    scans[1].component_index[0] = 2;
    for (int i = 0; i < 2; i++) {
      scans[i].Ss = 0;
      scans[i].Se = 63;
      scans[i].Ah = scans[i].Al = 0;
    }
    c.scan_info = scans;
    c.num_scans = 2;
  }
  if (atoi(argv[8])) jpeg_simple_progression(&c);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = px + (size_t)c.next_scanline * W * C;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  fclose(out);
  jpeg_destroy_compress(&c);
  return 0;
}
"""


# A lossless libjpeg transcoder (jpeg_read_coefficients, then
# jpeg_write_coefficients): the same quantised coefficients re-coded.
# Arguments: input JPEG, output, arithmetic (0/1), progressive (0/1: libjpeg's
# simple progression, successive approximation included), restart interval
# in MCUs, and the DAC conditioning of every table as "L,U,K" ("-" keeps
# libjpeg's defaults 0,1,5).
TRANSCODE_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>

int main(int argc, char** argv) {
  if (argc != 7) return 2;
  struct jpeg_decompress_struct d;
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr de, ce;
  d.err = jpeg_std_error(&de);
  jpeg_create_decompress(&d);
  FILE* in = fopen(argv[1], "rb");
  if (!in) return 3;
  jpeg_stdio_src(&d, in);
  jpeg_read_header(&d, TRUE);
  jvirt_barray_ptr* coefs = jpeg_read_coefficients(&d);
  c.err = jpeg_std_error(&ce);
  jpeg_create_compress(&c);
  FILE* out = fopen(argv[2], "wb");
  jpeg_stdio_dest(&c, out);
  jpeg_copy_critical_parameters(&d, &c);
  c.arith_code = atoi(argv[3]);
  c.optimize_coding = !c.arith_code;
  if (atoi(argv[4])) jpeg_simple_progression(&c);
  c.restart_interval = atoi(argv[5]);
  if (argv[6][0] != '-') {
    int L, U, K;
    if (sscanf(argv[6], "%d,%d,%d", &L, &U, &K) != 3) return 4;
    for (int t = 0; t < NUM_ARITH_TBLS; t++) {
      c.arith_dc_L[t] = L;
      c.arith_dc_U[t] = U;
      c.arith_ac_K[t] = K;
    }
  }
  jpeg_write_coefficients(&c, coefs);
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(out);
  jpeg_finish_decompress(&d);
  jpeg_destroy_decompress(&d);
  fclose(in);
  return 0;
}
"""


def _source(i, h, w):
    """An RGB uint8 image of h x w from the i-th rn50 corpus file."""
    import cv2

    root = os.path.join(HERE, "rn50")
    files = sorted(os.path.join(r, f) for r, _, fs in os.walk(root) for f in fs
                   if f.endswith(".jpg"))
    return np.ascontiguousarray(cv2.resize(cv2.imread(files[i]), (w, h))[:, :, ::-1])


class Writer:
    """The one-off libjpeg writer, compiled into a temporary directory."""

    def __init__(self, tmp):
        self.tmp = tmp
        src = os.path.join(tmp, "writer.c")
        self.exe = os.path.join(tmp, "writer")
        with open(src, "w") as f:
            f.write(WRITER_C)
        subprocess.run(["cc", "-O1", "-o", self.exe, src, "-ljpeg"], check=True)

    def __call__(self, px, color, sampling, quality=90, progressive=False, scans="full"):
        raw = os.path.join(self.tmp, "in.raw")
        out = os.path.join(self.tmp, "out.jpg")
        px.tofile(raw)
        h, w, c = px.shape
        subprocess.run([self.exe, raw, out, str(w), str(h), str(c), color, str(quality),
                        str(int(progressive)), sampling, scans], check=True)
        with open(out, "rb") as f:
            return f.read()


class Transcoder:
    """The lossless libjpeg transcoder, compiled into a temporary directory:
    ``t(jpeg, arith=True, progressive=False, restart=0, dac=None)`` returns
    the stream re-coded (``dac`` = (L, U, K) for every table)."""

    def __init__(self, tmp):
        self.tmp = tmp
        src = os.path.join(tmp, "transcode.c")
        self.exe = os.path.join(tmp, "transcode")
        with open(src, "w") as f:
            f.write(TRANSCODE_C)
        subprocess.run(["cc", "-O1", "-o", self.exe, src, "-ljpeg"], check=True)

    def __call__(self, jpeg, arith=True, progressive=False, restart=0, dac=None):
        src = os.path.join(self.tmp, "t_in.jpg")
        out = os.path.join(self.tmp, "t_out.jpg")
        with open(src, "wb") as f:
            f.write(jpeg)
        subprocess.run([self.exe, src, out, str(int(arith)), str(int(progressive)),
                        str(restart), "-" if dac is None else "%d,%d,%d" % tuple(dac)],
                       check=True)
        with open(out, "rb") as f:
            return f.read()


def arith_corpus(out=ARITH_CORPUS):
    """The rn50 corpus losslessly re-coded with arithmetic coding, in the same
    class folders: sorted file i is extended sequential (SOF9) for even i,
    progressive (SOF10) for odd i."""
    root = os.path.join(HERE, "rn50")
    files = sorted(os.path.relpath(os.path.join(r, f), root) for r, _, fs in os.walk(root)
                   for f in fs if f.endswith(".jpg"))
    with tempfile.TemporaryDirectory() as tmp:
        t = Transcoder(tmp)
        for i, rel in enumerate(files):
            with open(os.path.join(root, rel), "rb") as f:
                data = t(f.read(), arith=True, progressive=i % 2 == 1)
            os.makedirs(os.path.dirname(os.path.join(out, rel)), exist_ok=True)
            with open(os.path.join(out, rel), "wb") as f:
                f.write(data)


def rle8_bmp(index, palette):
    """A bottom-up 8-bit BI_RLE8 BMP of a palette-index image: encoded runs,
    absolute runs, an end of line per row and an end of bitmap."""
    h, w = index.shape
    body = bytearray()
    for row in index[::-1]:
        x = 0
        while x < w:
            run = 1
            while x + run < w and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 3 or w - x < 3:
                body += bytes([run, row[x]])
                x += run
                continue
            n = 3
            while x + n < w and n < 255 and not (x + n + 2 < w and row[x + n] == row[x + n + 1]
                                                  == row[x + n + 2]):
                n += 1
            body += bytes([0, n]) + bytes(row[x:x + n]) + (b"\0" if n % 2 else b"")
            x += n
        body += b"\0\0"
    body += b"\0\1"
    pal = b"".join(bytes([b, g, r, 0]) for r, g, b in palette)
    off = 14 + 40 + len(pal)
    info = (40).to_bytes(4, "little") + w.to_bytes(4, "little") + h.to_bytes(4, "little", signed=True)
    info += (1).to_bytes(2, "little") + (8).to_bytes(2, "little") + (1).to_bytes(4, "little")
    info += len(body).to_bytes(4, "little") + (2835).to_bytes(4, "little") * 2
    info += len(palette).to_bytes(4, "little") + (0).to_bytes(4, "little")
    head = b"BM" + (off + len(body)).to_bytes(4, "little") + b"\0\0\0\0" + off.to_bytes(4, "little")
    return head + info + pal + bytes(body)


def lzw_gif(indices, min_code_size: int) -> bytes:
    """GIF's variable-width LZW of palette indices (codes LSB first, a clear
    code first and when the table fills), in sub-blocks of 255 bytes."""
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    codes = [(clear, min_code_size + 1)]
    table, size, nxt = {}, min_code_size + 1, eoi + 1
    data = np.asarray(indices, np.uint8).reshape(-1).tolist()
    prefix = data[0]
    for k in data[1:]:
        key = (prefix, k)
        if key in table:
            prefix = table[key]
            continue
        codes.append((prefix, size))
        if nxt < 4096:
            table[key] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        else:
            codes.append((clear, size))
            table, size, nxt = {}, min_code_size + 1, eoi + 1
        prefix = k
    codes += [(prefix, size), (eoi, size)]
    acc = nbits = 0
    out = bytearray()
    for code, width in codes:
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc)
    blocks = b"".join(bytes([len(out[i:i + 255])]) + out[i:i + 255]
                      for i in range(0, len(out), 255))
    return bytes([min_code_size]) + blocks + b"\0"


def _table_bits(n: int) -> int:
    """GIF's colour table size field for ``n`` entries (2^(field + 1) >= n)."""
    return max(int(np.ceil(np.log2(max(n, 2)))) - 1, 0)


def gif_bytes(frames, width, height, global_palette=None, background=0, version=b"GIF89a",
              loop=None, comment=None):
    """A GIF file. ``frames``: dicts with ``index`` (uint8 [h, w]),
    optional ``palette`` (a local colour table, [n, 3]), ``left``/``top``,
    ``interlace``, ``transparent`` (an index, written in a Graphic Control
    Extension), ``disposal``, ``delay`` and ``min_code_size``."""
    out = bytearray(version + width.to_bytes(2, "little") + height.to_bytes(2, "little"))
    if global_palette is not None:
        gb = _table_bits(len(global_palette))
        gpal = np.zeros((2 << gb, 3), np.uint8)
        gpal[:len(global_palette)] = global_palette
        out += bytes([0x80 | (7 << 4) | gb, background, 0]) + gpal.tobytes()
    else:
        out += bytes([0x70, background, 0])
    if loop is not None:
        out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + loop.to_bytes(2, "little") + b"\0"
    if comment is not None:
        out += b"\x21\xfe" + bytes([len(comment)]) + comment + b"\0"
    for f in frames:
        idx = np.asarray(f["index"], np.uint8)
        h, w = idx.shape
        if "transparent" in f or "disposal" in f or "delay" in f:
            t = f.get("transparent")
            out += bytes([0x21, 0xF9, 4, (f.get("disposal", 0) << 2) | (t is not None)])
            out += f.get("delay", 0).to_bytes(2, "little") + bytes([t or 0, 0])
        packed = 0x40 if f.get("interlace") else 0
        pal = f.get("palette")
        if pal is not None:
            lb = _table_bits(len(pal))
            lpal = np.zeros((2 << lb, 3), np.uint8)
            lpal[:len(pal)] = pal
            packed |= 0x80 | lb
        out += b"\x2c" + b"".join(v.to_bytes(2, "little") for v in
                                   (f.get("left", 0), f.get("top", 0), w, h)) + bytes([packed])
        if pal is not None:
            out += lpal.tobytes()
        rows = idx
        if f.get("interlace"):
            rows = np.concatenate([idx[0::8], idx[4::8], idx[2::4], idx[1::2]])
        ncolors = len(pal if pal is not None else global_palette)
        out += lzw_gif(rows, f.get("min_code_size", max(_table_bits(ncolors) + 1, 2)))
    return bytes(out + b"\x3b")


# -- TIFF and PNM writers (forms PIL and cv2 do not write) --------------------------------------
def _lzw_tiff(data: bytes) -> bytes:
    """TIFF LZW (MSB-first codes, the code width growing one code early,
    a clear code before the table fills), as libtiff writes it."""
    out, acc, nacc = bytearray(), 0, 0
    width = 9

    def put(code):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)

    def reset():
        return {bytes([i]): i for i in range(256)}, 258

    table, nxt = reset()
    put(256)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = nxt
        nxt += 1
        if nxt == 4094:
            put(256)
            table, nxt = reset()
            width = 9
        elif nxt > (1 << width) - 1:
            width += 1
        w = bytes([c])
    if w:
        put(table[w])
        nxt += 1
        if nxt > (1 << width) - 1 and width < 12:
            width += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def _packbits(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _pack_rows(samples, bps):
    """Rows of samples [rows, n] to bytes: MSB-first bit packing below 8
    bits, each row to a byte boundary."""
    if bps >= 8:
        return samples.tobytes()
    rows, n = samples.shape
    bits = ((samples[:, :, None] >> np.arange(bps - 1, -1, -1)) & 1).reshape(rows, n * bps)
    return np.packbits(bits.astype(np.uint8), axis=1).tobytes()


def tiff_bytes(img, bps=8, photometric=None, compression=1, predictor=1, planar=1, tile=None,
               rows_per_strip=None, big_endian=False, bigtiff=False, extra=None, orientation=None,
               colormap=None, sample_format=None):
    """One TIFF image of ``img`` ([h, w] or [h, w, spp]; uint8 samples for
    ``bps`` <= 8, uint16 for 16, float32 for 32 with ``sample_format`` 3).
    ``compression``: 1, 5 (LZW), 8 (Deflate) or 32773 (PackBits); ``tile``:
    (tile_h, tile_w), else strips of ``rows_per_strip``; ``extra``: the
    ExtraSamples value of a fourth (or second) sample; ``colormap``: [3, 2**bps]
    uint16 for photometric 3."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, spp = img.shape
    bo = ">" if big_endian else "<"
    if photometric is None:
        photometric = 3 if colormap is not None else (2 if spp >= 3 else 1)
    dt = {16: bo + "u2", 32: bo + ("f4" if sample_format == 3 else "u4")}.get(bps, "u1")
    planes = [img[:, :, k:k + 1] for k in range(spp)] if planar == 2 else [img]
    th, tw = tile if tile else (rows_per_strip or h, w)
    chunks = []
    for plane in planes:
        c = plane.shape[2]
        for y0 in range(0, h, th):
            for x0 in range(0, w if tile else 1, tw):
                part = plane[y0:y0 + th, x0:x0 + tw] if tile else plane[y0:y0 + th]
                if tile:  # edge tiles are padded to the full tile
                    full = np.zeros((th, tw, c), plane.dtype)
                    full[:part.shape[0], :part.shape[1]] = part
                    part = full
                rows = part.shape[0]
                if predictor == 2:
                    wide = part.astype(np.int64)
                    part = np.concatenate([wide[:, :1], np.diff(wide, axis=1)], axis=1)
                    part = (part % (1 << bps)).astype(plane.dtype)
                raw = _pack_rows(part.reshape(rows, -1).astype(dt) if bps >= 8
                                 else part.reshape(rows, -1).astype(np.uint8), bps)
                chunks.append(raw if compression == 1 else _lzw_tiff(raw) if compression == 5
                              else zlib.compress(raw) if compression == 8 else _packbits(raw))
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bps] * spp), (259, 3, [compression]),
               (262, 3, [photometric]), (277, 3, [spp]), (284, 3, [planar])]
    if tile:
        entries += [(322, 3, [tw]), (323, 3, [th]), (324, 16 if bigtiff else 4, None),
                    (325, 4, [len(c) for c in chunks])]
    else:
        entries += [(273, 16 if bigtiff else 4, None), (278, 4, [th]),
                    (279, 4, [len(c) for c in chunks])]
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if orientation:
        entries.append((274, 3, [orientation]))
    if colormap is not None:
        entries.append((320, 3, list(np.asarray(colormap, np.uint16).reshape(-1))))
    if extra is not None:
        entries.append((338, 3, [extra]))
    if sample_format:
        entries.append((339, 3, [sample_format] * spp))
    entries.sort()
    size = {3: 2, 4: 4, 16: 8}
    off_fmt, cnt_fmt, ent_len, inline = ("Q", "Q", 20, 8) if bigtiff else ("I", "I", 12, 4)
    head = 16 if bigtiff else 8
    ifd_len = (8 if bigtiff else 2) + ent_len * len(entries) + (8 if bigtiff else 4)
    data_at = head + ifd_len
    blobs, offsets = bytearray(), []
    for c in chunks:
        offsets.append(data_at + len(blobs))
        blobs += c + (b"\0" if len(c) % 2 else b"")
    extra_at = data_at + len(blobs)
    tail = bytearray()
    ifd = bytearray(struct.pack(bo + ("Q" if bigtiff else "H"), len(entries)))
    for tag, typ, vals in entries:
        if vals is None:
            vals = offsets
        raw = b"".join(struct.pack(bo + {3: "H", 4: "I", 16: "Q"}[typ], int(v)) for v in vals)
        ifd += struct.pack(bo + "HH" + cnt_fmt, tag, typ, len(vals))
        if len(raw) <= inline:
            ifd += raw.ljust(inline, b"\0")
        else:
            ifd += struct.pack(bo + off_fmt, extra_at + len(tail))
            tail += raw + (b"\0" if len(raw) % 2 else b"")
        assert size[typ]
    ifd += struct.pack(bo + off_fmt, 0)
    magic = (b"MM" if big_endian else b"II") + struct.pack(bo + "H", 43 if bigtiff else 42)
    if bigtiff:
        header = magic + struct.pack(bo + "HHQ", 8, 0, head)
    else:
        header = magic + struct.pack(bo + "I", head)
    return bytes(header + ifd + blobs + tail)


def pnm_bytes(kind, img, maxval=255, comment=False):
    """A PNM of ``img`` ([h, w] for P1/P2/P4/P5, [h, w, 3] for P3/P6):
    ASCII (P1-P3) or binary (P4-P6, 16-bit big-endian above maxval 255)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    head = f"P{kind}\n" + ("# written by make_codec_corpus\n" if comment else "") + f"{w} {h}\n"
    if kind not in (1, 4):
        head += f"{maxval}\n"
    if kind <= 3:
        body = "\n".join(" ".join(str(int(v)) for v in row.reshape(-1)) for row in img) + "\n"
        return head.encode() + body.encode()
    if kind == 4:
        return head.encode() + np.packbits(img.astype(bool), axis=1).tobytes()
    return head.encode() + img.astype(">u2" if maxval > 255 else np.uint8).tobytes()


def build(out=OUT):
    import cv2
    from PIL import Image

    os.makedirs(out, exist_ok=True)
    files = {}

    def pil_jpeg(img, **kw):
        buf = io.BytesIO()
        img.save(buf, "JPEG", **kw)
        return buf.getvalue()

    files["cmyk_444.jpg"] = pil_jpeg(Image.fromarray(_source(0, 375, 500)).convert("CMYK"),
                                     quality=90, subsampling=0)
    files["cmyk_420.jpg"] = pil_jpeg(Image.fromarray(_source(1, 500, 375)).convert("CMYK"),
                                     quality=90, subsampling=2)
    with tempfile.TemporaryDirectory() as tmp:
        write = Writer(tmp)
        cmyk = 255 - np.asarray(Image.fromarray(_source(2, 333, 500)).convert("CMYK"))
        files["ycck.jpg"] = write(np.ascontiguousarray(cmyk), "ycck", "2,2;1,1;1,1;2,2")
        files["rgb.jpg"] = write(_source(3, 400, 600), "rgb", "1,1;1,1;1,1")
        files["h4v2.jpg"] = write(_source(4, 480, 640), "ycc", "4,2;1,1;1,1")
        files["partial_scans.jpg"] = write(_source(5, 500, 500), "ycc", "2,2;1,1;1,1",
                                           scans="partial")
    files["s411.jpg"] = cv2.imencode(".jpg", _source(6, 375, 500)[:, :, ::-1], [
        cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])[1].tobytes()
    # ImageNet's n02105855_2933.JPEG is a PNG: an 8-bit RGB PNG under a .JPEG name
    files["png_rgb8.JPEG"] = cv2.imencode(".png", _source(7, 333, 500)[:, :, ::-1])[1].tobytes()
    files["png_rgb16.png"] = cv2.imencode(
        ".png", (_source(8, 340, 352)[:, :, ::-1].astype(np.uint16) * 256
                 + np.arange(352, dtype=np.uint16)[None, :, None] % 256))[1].tobytes()
    pal = Image.fromarray(_source(9, 375, 500)).quantize(64)
    buf = io.BytesIO()
    pal.save(buf, "PNG", transparency=3)
    files["png_palette_trns.png"] = buf.getvalue()
    files["bmp24.bmp"] = cv2.imencode(".bmp", _source(10, 350, 333)[:, :, ::-1])[1].tobytes()
    q = Image.fromarray(_source(11, 340, 480)).quantize(32)
    rgb = np.asarray(q.getpalette()[:96], np.uint8).reshape(32, 3)
    files["bmp_rle8.bmp"] = rle8_bmp(np.asarray(q), [tuple(int(v) for v in c) for c in rgb])
    prog = cv2.imencode(".jpg", _source(12, 375, 500)[:, :, ::-1], [
        cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    files["progressive_cut60.jpg"] = prog[:int(len(prog) * 0.6)]
    files.update(gif_fixtures())
    files.update(webp_tiff_pnm_fixtures())
    for name, data in files.items():
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
    return files


def gif_fixtures():
    """The GIF forms, each from an rn50 corpus file at an ImageNet-like size
    (PIL's writer; ``gif_bytes`` for the local colour table on an offset
    image, which PIL does not write first)."""
    from PIL import Image

    def quantized(i, h, w, colors):
        # blocks of 4 pixels, as an upscaled photo has, keep each file small
        img = Image.fromarray(_source(i, -(-h // 4), -(-w // 4))).quantize(colors)
        return img.resize((w, h), Image.Resampling.NEAREST)

    def pil_gif(img, **kw):
        buf = io.BytesIO()
        img.save(buf, "GIF", **kw)
        return buf.getvalue()

    files = {"gif87a_palette.gif": pil_gif(quantized(13, 375, 500, 256), interlace=False),
             "gif_interlaced.gif": pil_gif(quantized(14, 500, 333, 16), interlace=True),
             "gif89a_transparent.gif": pil_gif(quantized(15, 333, 500, 64), transparency=5,
                                               interlace=False)}
    # a local colour table of 4 entries on an image offset in a larger screen,
    # whose global table holds the background colour
    q = quantized(16, 240, 320, 4)
    local = np.asarray(q.getpalette()[:12], np.uint8).reshape(4, 3)
    files["gif_local_offset.gif"] = gif_bytes(
        [{"index": np.asarray(q), "palette": local, "left": 90, "top": 70, "transparent": 2}],
        500, 375, global_palette=np.array([[30, 60, 90], [200, 10, 10]], np.uint8))
    first = quantized(17, 375, 500, 128)
    second = first.copy()
    second.paste(quantized(18, 120, 160, 128), (40, 30))
    buf = io.BytesIO()
    first.save(buf, "GIF", save_all=True, append_images=[second], duration=80, loop=0,
               interlace=False)
    files["gif_animated.gif"] = buf.getvalue()
    return files


def webp_tiff_pnm_fixtures():
    """One file of each WebP, TIFF and PNM form, from rn50 corpus files."""
    import cv2
    from PIL import Image

    files = {}
    bgr = _source(19, 375, 500)[:, :, ::-1]
    files["webp_lossy.webp"] = cv2.imencode(".webp", bgr, [cv2.IMWRITE_WEBP_QUALITY, 85])[1].tobytes()
    files["webp_lossless.webp"] = cv2.imencode(".webp", _source(20, 240, 320)[:, :, ::-1],
                                               [cv2.IMWRITE_WEBP_QUALITY, 101])[1].tobytes()
    rgba = np.dstack([_source(21, 333, 500), np.tile(np.arange(500, dtype=np.uint8)[None] // 2,
                                                     (333, 1))])
    buf = io.BytesIO()
    Image.fromarray(rgba, "RGBA").save(buf, "WEBP", quality=80)
    files["webp_alpha.webp"] = buf.getvalue()
    files["tiff_lzw_pred.tif"] = tiff_bytes(_source(22, 240, 320), compression=5, predictor=2,
                                            rows_per_strip=16)
    files["tiff_tiled_deflate.tif"] = tiff_bytes(_source(23, 375, 500), compression=8,
                                                 tile=(128, 128))
    files["tiff_rgb16.tif"] = tiff_bytes(
        _source(24, 180, 240).astype(np.uint16) * 257 + np.arange(240, dtype=np.uint16)[None, :, None],
        bps=16, compression=8, predictor=2, rows_per_strip=32, big_endian=True)
    alpha = np.tile(np.arange(180, dtype=np.uint8)[:, None] + 60, (1, 240))
    files["tiff_rgba.tif"] = tiff_bytes(np.dstack([_source(25, 180, 240), alpha]), compression=5,
                                        extra=2, rows_per_strip=64)
    files["ppm_binary.ppm"] = pnm_bytes(6, _source(26, 192, 256), comment=True)
    return files


def webp_corpus(out=WEBP_CORPUS):
    """The rn50 corpus as WebP at quality 85, in the same class folders."""
    import cv2

    root = os.path.join(HERE, "rn50")
    for r, _, fs in os.walk(root):
        for f in sorted(fs):
            if not f.endswith(".jpg"):
                continue
            d = os.path.join(out, os.path.relpath(r, root))
            os.makedirs(d, exist_ok=True)
            cv2.imwrite(os.path.join(d, f[:-4] + ".webp"), cv2.imread(os.path.join(r, f)),
                        [cv2.IMWRITE_WEBP_QUALITY, 85])


if __name__ == "__main__":
    build(sys.argv[1] if len(sys.argv) > 1 else OUT)
    webp_corpus()
    arith_corpus()
