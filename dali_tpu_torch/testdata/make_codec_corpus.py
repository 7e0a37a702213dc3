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
* a progressive JPEG cut at 60% of its bytes.

Forms neither cv2 nor PIL writes (YCCK, RGB colour, h=4 luma, partly
interleaved scans) come from a one-off writer built here against the system
libjpeg (``jpeglib.h``, ``-ljpeg``); it is not part of the package. Needs
OpenCV (cv2), PIL, a C compiler and the libjpeg headers; reading the fixtures
needs none of them.

Usage: python dali_tpu_torch/testdata/make_codec_corpus.py [out_dir]
"""

from __future__ import annotations

import io
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "codecs")

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
    for name, data in files.items():
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
    return files


if __name__ == "__main__":
    build(sys.argv[1] if len(sys.argv) > 1 else OUT)
