"""Every image form an ImageNet-like corpus holds, decoded by dali_tpu_torch on
the CPU against dali_tpu with the libjpeg-turbo (2.1.5) and cv2 (5.0) it
loads.

The reference decodes a sample through libjpeg-turbo (``dali_tpu.native``)
or, where libjpeg declines it, through ``cv2.imdecode``; the port has
neither library and gives each route's output from its own C++
(``csrc/host/``):

* the committed fixtures (``dali_tpu_torch/testdata/codecs``, made by
  ``make_codec_corpus.py``): CMYK (4:4:4, 4:2:0) and YCCK JPEGs, an
  RGB-colour JPEG, 4:1:1 and h=4 luma JPEGs, partly interleaved scans, a PNG
  under a ``.JPEG`` name, 16-bit and palette PNGs, 24-bit and RLE8 BMPs, a
  progressive JPEG cut at 60%;
* small variants made here: every PNG colour type and bit depth, tRNS, Adam7,
  gAMA/sRGB and eXIf; every BMP form OpenCV reads; CMYK/YCCK JPEGs that are
  progressive, cut short or carry an EXIF orientation, unequal chroma
  factors;
* pipelines over a directory that mixes every form with baseline JPEGs:
  ``decoders.image``, ``image_random_crop`` (including the reference's
  second window draw for CMYK/YCCK), ``image_crop``, ``image_slice`` and
  ``peek_image_shape`` on cpu and mixed, the eager ``ndd`` decoders, and the
  hybrid decoders' rejections.

Contract: uint8, uint16 and float outputs bit-equal, for every output type,
dtype, JPEG scale and upsampling mode."""

import io
import os
import shutil
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

import dali_tpu
import dali_tpu.experimental.dynamic as ref_ndd
import dali_tpu_torch
import dali_tpu_torch.experimental.dynamic as ndd
from dali_tpu import imgcodec as ref_codec
from dali_tpu_torch import imgcodec as port_codec
from dali_tpu_torch import native as port_native

from .test_torch_image_decoders import _assert_same, _close, _host, _pair, _run_pair, \
    _with_exif_orientation

HERE = os.path.dirname(__file__)
TESTDATA = os.path.join(HERE, "..", "dali_tpu_torch", "testdata")
CODECS = os.path.join(TESTDATA, "codecs")
CORPUS = os.path.join(TESTDATA, "rn50")
sys.path.insert(0, TESTDATA)
import make_codec_corpus  # noqa: E402

FIXTURES = sorted(os.listdir(CODECS))
OUTPUT_TYPES = ["RGB", "BGR", "GRAY", "YCbCr"]
DTYPES = [None, "UINT16", "FLOAT"]


def _decode_both(data, output_type, denom=1, fancy=True, dtype=None, adjust=True):
    out = []
    for codec, pkg in ((ref_codec, dali_tpu), (port_codec, dali_tpu_torch)):
        try:
            out.append(codec.decode(
                data, getattr(pkg.types.DALIImageType, output_type), denom, adjust, fancy,
                getattr(pkg.types.DALIDataType, dtype) if dtype else None))
        except (ValueError, NotImplementedError) as e:
            out.append(type(e))
    return out


def _assert_decodes_equal(data, output_types=OUTPUT_TYPES, denoms=(1, 2, 4, 8),
                          fancies=(True, False), dtypes=DTYPES, adjust=True, may_fail=False):
    """Bit-equal outputs; with ``may_fail``, a stream the reference fails on
    must fail in the port with the same exception type."""
    for ot in output_types:
        for dt in dtypes:
            for denom in denoms:
                for fancy in fancies:
                    want, got = _decode_both(data, ot, denom, fancy, dt, adjust)
                    if may_fail and isinstance(want, type):
                        assert got is want, (ot, dt, denom, fancy, want, got)
                        continue
                    assert not isinstance(want, type), (ot, dt, denom, fancy, want)
                    assert not isinstance(got, type), (ot, dt, denom, fancy, got)
                    assert got.shape == want.shape and got.dtype == want.dtype, \
                        (ot, dt, denom, fancy, got.shape, want.shape)
                    np.testing.assert_array_equal(got, want, err_msg=str((ot, dt, denom, fancy)))


def _source(h, w, seed=0):
    """A smooth RGB uint8 image (upscaled noise, as the corpus is)."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, ((h + 3) // 4, (w + 3) // 4, 3), np.uint8)
    return np.ascontiguousarray(cv2.resize(small, (w, h)))


# -- the committed fixtures --------------------------------------------------------------------
@pytest.mark.parametrize("output_type", OUTPUT_TYPES)
@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_decodes_as_dali_tpu(name, output_type):
    data = open(os.path.join(CODECS, name), "rb").read()
    jpeg = data[:2] == b"\xff\xd8"
    _assert_decodes_equal(data, [output_type], denoms=(1, 2, 4, 8) if jpeg else (1, 2),
                          fancies=(True, False) if jpeg else (True,))


def test_fixture_routes():
    """The route the C++ decoder reports is the one the reference takes:
    libjpeg (dali_tpu.native decodes it) or cv2 (it returns None)."""
    for name in FIXTURES:
        data = open(os.path.join(CODECS, name), "rb").read()
        if data[:2] != b"\xff\xd8":
            continue
        _, route = port_native.decode_jpeg_routed(data)
        want = (port_native.ROUTE_LIBJPEG if dali_tpu.native.decode_jpeg(data) is not None
                else port_native.ROUTE_CV2)
        assert route == want, name
    assert port_native.jpeg_scaled_dims(
        open(os.path.join(CODECS, "cmyk_444.jpg"), "rb").read())[2] == 4


# -- PNG: every colour type and bit depth, tRNS, Adam7, gamma, eXIf -----------------------------
_ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2)]


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _filter_row(raw, prev, bpp, ft):
    out = bytearray(len(raw))
    for i, x in enumerate(raw):
        a = raw[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if ft == 1:
            x -= a
        elif ft == 2:
            x -= b
        elif ft == 3:
            x -= (a + b) >> 1
        elif ft == 4:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            x -= a if pa <= pb and pa <= pc else b if pb <= pc else c
        out[i] = x & 0xFF
    return bytes(out)


def _pack(samples, bd):
    """One row of samples [n] at bit depth bd, as PNG packs them."""
    if bd == 16:
        return samples.astype(">u2").tobytes()
    if bd == 8:
        return samples.astype(np.uint8).tobytes()
    bits = np.unpackbits(samples.astype(np.uint8)[:, None], axis=1)[:, 8 - bd:].reshape(-1)
    return np.packbits(bits).tobytes()


def make_png(samples, color_type, bd, interlace=False, plte=b"", extra=(), seed=0):
    """A PNG of ``samples`` [h, w, ch] with a random filter type per row."""
    rng = np.random.default_rng(seed)
    h, w, ch = samples.shape
    bpp = max(1, ch * bd // 8)
    raw = b""
    for x0, y0, dx, dy in (_ADAM7 if interlace else [(0, 0, 1, 1)]):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        prev = bytes(len(_pack(sub[0].reshape(-1), bd)))
        for row in sub:
            line = _pack(row.reshape(-1), bd)
            ft = int(rng.integers(0, 5))
            raw += bytes([ft]) + _filter_row(line, prev, bpp, ft)
            prev = line
    body = struct.pack(">IIBBBBB", w, h, bd, color_type, 0, 0, int(interlace))
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", body)
    for kind, data in extra:
        out += _chunk(kind, data)
    if plte:
        out += _chunk(b"PLTE", plte)
    comp = zlib.compress(raw)
    out += _chunk(b"IDAT", comp[:len(comp) // 2]) + _chunk(b"IDAT", comp[len(comp) // 2:])
    return out + _chunk(b"IEND", b"")


_PNG_FORMS = ([(0, b) for b in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16), (4, 8), (4, 16), (6, 8),
                                                    (6, 16)] + [(3, b) for b in (1, 2, 4, 8)])


def _png_case(color_type, bd, h=23, w=37, seed=0):
    rng = np.random.default_rng(seed)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    top = (1 << bd) - 1
    samples = rng.integers(0, top + 1, (h, w, ch))
    if color_type in (2, 6):  # some grey pixels: equal channels pass rgb_to_gray unchanged
        samples[::3, :, 1] = samples[::3, :, 0]
        samples[::3, :, 2] = samples[::3, :, 0]
    plte = b""
    if color_type == 3:
        n = min(1 << bd, 200)  # indices past the palette decode black
        plte = rng.integers(0, 256, 3 * n, np.uint8).tobytes()
    return samples, plte


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("form", _PNG_FORMS, ids=[f"ct{c}_{b}bit" for c, b in _PNG_FORMS])
def test_png_forms(form, interlace):
    color_type, bd = form
    for h, w in ((23, 37), (5, 9)):
        samples, plte = _png_case(color_type, bd, h, w)
        extra = []
        if color_type == 0:
            extra = [(b"tRNS", struct.pack(">H", int(samples[0, 0, 0])))]
        elif color_type == 2:
            extra = [(b"tRNS", struct.pack(">HHH", *[int(v) for v in samples[0, 0]]))]
        elif color_type == 3:
            extra = [(b"tRNS", bytes(range(0, 250, 25)))]
        data = make_png(samples, color_type, bd, interlace, plte, extra)
        _assert_decodes_equal(data, denoms=(1,), fancies=(True,))


@pytest.mark.parametrize("case", ["gamma_045", "gamma_1", "srgb", "exif_6", "exif_3",
                                  "bad_ancillary_crc"])
def test_png_gamma_exif_and_crc(case):
    samples, _ = _png_case(2, 8, 31, 17, seed=3)
    extra = {"gamma_045": [(b"gAMA", struct.pack(">I", 45455))],
             "gamma_1": [(b"gAMA", struct.pack(">I", 100000))],
             "srgb": [(b"sRGB", b"\0")]}.get(case, [])
    if case.startswith("exif"):
        tiff = (b"MM\0*" + (8).to_bytes(4, "big") + (1).to_bytes(2, "big")
                + (0x0112).to_bytes(2, "big") + (3).to_bytes(2, "big") + (1).to_bytes(4, "big")
                + int(case[-1]).to_bytes(2, "big") + b"\0\0" + (0).to_bytes(4, "big"))
        extra = [(b"eXIf", tiff)]
    data = make_png(samples, 2, 8, extra=extra)
    if case == "bad_ancillary_crc":
        data = data.replace(_chunk(b"IEND", b""), b"") + struct.pack(">I", 4) + b"tEXt" \
            + b"a\0bc" + b"\0\0\0\0" + _chunk(b"IEND", b"")
    _assert_decodes_equal(data, denoms=(1,), fancies=(True,))


def test_png_corrupt_streams_fail_as_in_dali_tpu():
    samples, _ = _png_case(2, 8)
    data = make_png(samples, 2, 8)
    idat = data.index(b"IDAT")
    bad_crc = data[:idat + 10] + bytes([data[idat + 10] ^ 1]) + data[idat + 11:]
    for bad in (data[:len(data) // 2], bad_crc, data.replace(b"IEND", b"IENX")):
        want, got = _decode_both(bad, "RGB")
        assert want is ValueError and got is ValueError


@pytest.mark.parametrize("chunks", [
    [(b"gAMA", struct.pack(">I", 45455))], [(b"gAMA", struct.pack(">I", 220000))],
    [(b"sRGB", b"\0")], [(b"gAMA", struct.pack(">I", 45455)), (b"sBIT", b"\x0c\x0c\x0c")],
    [(b"gAMA", struct.pack(">I", 45455)), (b"sBIT", b"\x0a\x0b\x05")]],
    ids=["gamma_045", "gamma_22", "srgb", "sbit_12", "sbit_mixed"])
@pytest.mark.parametrize("color_type", [2, 6])
def test_png_16bit_grey_under_gamma(color_type, chunks):
    """A 16-bit colour PNG decoded to grey under a significant gamma: libpng's
    16-bit linear tables, at the precision sBIT leaves (and the rescale of
    grey pixels through its gamma_16_table)."""
    samples, _ = _png_case(color_type, 16, seed=5)
    if color_type == 6:
        chunks = [(k, v + b"\x08" if k == b"sBIT" else v) for k, v in chunks]
    data = make_png(samples, color_type, 16, extra=chunks)
    _assert_decodes_equal(data, denoms=(1,), fancies=(True,))


# -- BMP: every form OpenCV's reader takes -----------------------------------------------------
def make_bmp(w, h, bpp, pixels, palette=None, compression=0, masks=None, top_down=False,
             core=False):
    """A BMP with ``pixels`` the raw bottom-up (or top-down) pixel bytes."""
    pal = b""
    if palette is not None:
        pal = b"".join(bytes([b, g, r] + ([] if core else [0])) for r, g, b in palette)
    if core:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp, compression,
                           len(pixels), 2835, 2835, len(palette) if palette else 0, 0)
        if masks:
            info += struct.pack("<III", *masks)
    off = 14 + len(info) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off) + info + pal + pixels


def _rows(idx_or_px, bpp):
    out = b""
    for row in idx_or_px:
        if bpp < 8:
            bits = np.unpackbits(row.astype(np.uint8)[:, None], axis=1)[:, 8 - bpp:].reshape(-1)
            line = np.packbits(bits).tobytes()
        else:
            line = row.astype(np.uint8).tobytes() if row.dtype != np.uint16 else \
                row.astype("<u2").tobytes()
        out += line + b"\0" * (-len(line) % 4)
    return out


def _rle(rows, bpp, early_eof=True):
    """RLE8/RLE4 of index rows (bottom-up), with encoded and absolute runs,
    an end of line cut short, a delta and an early end of bitmap (the pixels
    they skip take palette entry 0)."""
    out = bytearray()
    h, x0 = len(rows), 0
    for y, row in enumerate(rows):
        w = len(row)
        end = w - 3 if y == 2 else w  # row 2: end of line before its end
        x, x0 = x0, 0
        while x < end:
            if y == 4 and x >= 5:  # delta: 3 right, 1 down
                out += bytes([0, 2, 3, 1])
                x0 = x + 3
                break
            run = 1
            while x + run < end and run < 40 and row[x + run] == row[x]:
                run += 1
            if bpp == 4:
                run = min(end - x, 6) if run >= 2 or end - x < 4 else 0
            if run >= 2 or end - x < 4:
                nxt = row[x + 1] if x + 1 < end else row[x]
                out += bytes([run, row[x] if bpp == 8 else (row[x] << 4) | nxt])
                x += run
                continue
            n = min(end - x, 7)
            if bpp == 8:
                out += bytes([0, n]) + bytes(int(v) for v in row[x:x + n]) + b"\0" * (n % 2)
            else:
                vals = [int(v) for v in row[x:x + n]] + [0]
                packed = bytes((vals[i] << 4) | vals[i + 1] for i in range(0, n, 2))
                out += bytes([0, n]) + packed + b"\0" * (len(packed) % 2)
            x += n
        if y == h - 2 and early_eof:
            return bytes(out + b"\0\1")  # the last row takes palette 0
        if x0 == 0:
            out += b"\0\0"
    return bytes(out + b"\0\1")


_BMP_FORMS = ["1bit", "4bit", "8bit", "8bit_short_palette", "24bit", "24bit_top_down", "32bit",
              "32bit_bitfields", "16bit_555", "16bit_565", "rle8", "rle4", "core_8bit"]


@pytest.mark.parametrize("form", _BMP_FORMS)
def test_bmp_forms(form):
    rng = np.random.default_rng(_BMP_FORMS.index(form))
    w, h = 13, 9
    pal = [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(256)]
    bpp = int(form.split("bit")[0]) if form[0].isdigit() else 8 if form != "rle4" else 4
    if form == "core_8bit":
        bpp = 8
    if form.startswith("rle"):
        idx = rng.integers(0, 1 << bpp, (h, w))
        idx[:, 3:8] = idx[:, 3:4]
        # OpenCV's RLE4 reader reads on after an end of bitmap before the
        # last row, and fails; its RLE8 reader fills the rest
        data = make_bmp(w, h, bpp, _rle(idx[::-1], bpp, early_eof=bpp == 8), pal[:1 << bpp],
                        compression=1 if bpp == 8 else 2)
    elif bpp <= 8:
        n = 20 if form == "8bit_short_palette" else 1 << bpp
        idx = rng.integers(0, min(n, 1 << bpp), (h, w))
        data = make_bmp(w, h, bpp, _rows(idx[::-1], bpp), pal[:n], core=form == "core_8bit")
    elif bpp in (24, 32):
        px = rng.integers(0, 256, (h, w * bpp // 8))
        top = form.endswith("top_down")
        data = make_bmp(w, h, bpp, _rows(px if top else px[::-1], 8), top_down=top,
                        compression=3 if form.endswith("bitfields") else 0,
                        masks=(0xFF0000, 0xFF00, 0xFF) if form.endswith("bitfields") else None)
    else:
        px = rng.integers(0, 1 << 16, (h, w)).astype(np.uint16)
        masks = (0xF800, 0x7E0, 0x1F) if form == "16bit_565" else None
        data = make_bmp(w, h, 16, _rows(px[::-1], 16), compression=3 if masks else 0,
                        masks=masks)
    _assert_decodes_equal(data, denoms=(1,), fancies=(True,))


def test_bmp_corrupt_streams_fail_as_in_dali_tpu():
    px = np.zeros((9, 13 * 3))
    data = make_bmp(13, 9, 24, _rows(px, 8))
    idx = np.arange(9 * 13).reshape(9, 13) % 16
    rle4_eof = make_bmp(13, 9, 4, _rle(idx, 4), [(i, i, i) for i in range(16)], compression=2)
    run_past_row = make_bmp(13, 9, 8, bytes([20, 1, 0, 1]), [(i, i, i) for i in range(256)],
                            compression=1)
    for bad in (data[:len(data) - 40], data[:30], rle4_eof, run_past_row):
        want, got = _decode_both(bad, "RGB")
        assert want is ValueError and got is ValueError


# -- JPEG forms beyond the fixtures ------------------------------------------------------------
def _pil_jpeg(img, **kw):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).convert(kw.pop("mode", "RGB")).save(buf, "JPEG", **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def writer(tmp_path_factory):
    return make_codec_corpus.Writer(str(tmp_path_factory.mktemp("writer")))


_JPEG_FORMS = ["cmyk_progressive", "cmyk_cut", "cmyk_exif_6", "ycck_progressive", "ycck_cut",
               "rgb_progressive", "rgb_h2v1", "chroma_2x2_luma_1x1", "unequal_chroma",
               "h3_fractional", "partial_progressive_dc", "gray_2x2_factors"]


@pytest.mark.parametrize("form", _JPEG_FORMS)
def test_jpeg_forms(form, writer):
    img = _source(61, 83, seed=_JPEG_FORMS.index(form))
    if form.startswith("cmyk"):
        data = _pil_jpeg(img, mode="CMYK", quality=90, progressive=form.endswith("progressive")
                         or form.endswith("cut"))
    elif form.startswith("ycck"):
        cmyk = 255 - np.asarray(__import__("PIL.Image").Image.fromarray(img).convert("CMYK"))
        data = writer(np.ascontiguousarray(cmyk), "ycck", "1,2;1,1;2,1;1,1", progressive=True)
    elif form == "rgb_progressive":
        data = writer(img, "rgb", "1,1;1,1;1,1", progressive=True)
    elif form == "rgb_h2v1":
        data = writer(img, "rgb", "2,1;1,1;1,1")
    elif form == "chroma_2x2_luma_1x1":
        data = writer(img, "ycc", "1,1;2,2;1,1")
    elif form == "unequal_chroma":
        data = writer(img, "ycc", "2,2;2,1;1,1", progressive=True)
    elif form == "h3_fractional":  # libjpeg fails on 3:2, and so does cv2
        data = writer(img, "ycc", "1,1;1,1;1,1")
        sof = data.index(b"\xff\xc0")
        data = data[:sof + 11] + b"\x31" + data[sof + 12:sof + 14] + b"\x21" + data[sof + 15:]
    elif form == "partial_progressive_dc":
        data = writer(img, "ycc", "2,2;1,1;1,1", scans="partial")
        data = data[:int(len(data) * 0.7)]
    else:
        data = writer(img, "ycc", "2,2;1,1;1,1")
        gray = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))[1].tobytes()
        sof = gray.index(b"\xff\xc0")
        data = gray[:sof + 11] + b"\x22" + gray[sof + 12:]  # grey with 2x2 factors
    if form.endswith("cut"):
        data = data[:int(len(data) * 0.55)]
    if form.endswith("exif_6"):
        data = _with_exif_orientation(data, 6)
    if form == "h3_fractional":  # grey needs no chroma, and decodes
        for ot in ("RGB", "BGR", "YCbCr"):
            want, got = _decode_both(data, ot)
            assert want is ValueError and got is ValueError
        _assert_decodes_equal(data, ["GRAY"])
        return
    if form in ("cmyk_cut", "ycck_cut"):  # OpenCV's data source suspends: cv2 fails
        for ot in OUTPUT_TYPES:
            want, got = _decode_both(data, ot)
            assert want is ValueError and got is ValueError
        return
    for adjust in (True, False):
        _assert_decodes_equal(data, adjust=adjust, dtypes=(None,) if not adjust else DTYPES)


@pytest.mark.parametrize("frac", [0.05, 0.15, 0.3, 0.45, 0.6, 0.75, 0.9, 0.97])
@pytest.mark.parametrize("rst", [0, 2])
def test_truncated_progressive_cmyk_and_444(frac, rst):
    """Block smoothing on 4:4:4, with restarts; a cut CMYK stream fails as in
    the reference."""
    img = _source(75, 90, seed=int(frac * 100))
    data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                                      cv2.IMWRITE_JPEG_RST_INTERVAL, rst])[1].tobytes()
    cut = data[:int(len(data) * frac)]
    _assert_decodes_equal(cut, ["RGB", "GRAY"], dtypes=(None,), may_fail=True)
    # the reference reads a CMYK stream through cv2, which fails on one cut short
    cmyk = _pil_jpeg(img, mode="CMYK", progressive=True)
    want, got = _decode_both(cmyk[:int(len(cmyk) * frac)], "RGB")
    assert want is ValueError and got is ValueError


# -- pipelines over a directory that mixes every form ------------------------------------------
@pytest.fixture(scope="module")
def mixed_root(tmp_path_factory):
    """Baseline corpus JPEGs and every fixture, in one class folder."""
    root = tmp_path_factory.mktemp("mixed")
    d = root / "c"
    d.mkdir()
    files = sorted(os.path.join(r, f) for r, _, fs in os.walk(CORPUS) for f in fs
                   if f.endswith(".jpg"))[:5]
    for i, f in enumerate(files):
        shutil.copy(f, d / f"base_{i}.jpg")
    for name in FIXTURES:
        shutil.copy(os.path.join(CODECS, name), d / name)
    return str(root)


N_MIXED = 5 + len(FIXTURES)


@pytest.mark.parametrize("device", ["cpu", "mixed"])
@pytest.mark.parametrize("output_type", ["RGB", "GRAY", "YCbCr"])
def test_mixed_image(mixed_root, device, output_type):
    for dtype in ("UINT8", "FLOAT"):
        _run_pair(lambda pkg, j: pkg.fn.decoders.image(
            j, device=device, output_type=getattr(pkg.types.DALIImageType, output_type),
            dtype=getattr(pkg.types, dtype)), iters=N_MIXED // 4 + 1, root=mixed_root)


@pytest.mark.parametrize("device", ["cpu", "mixed"])
@pytest.mark.parametrize("hint", [0, 100])
def test_mixed_image_batch_paths(mixed_root, device, hint):
    """One batch holding every form: the mixed decoder falls to the per-sample
    path for PNG/BMP and takes the CMYK/YCCK samples from the batch call."""
    _run_pair(lambda pkg, j: (
        pkg.fn.decoders.image(j, device=device, downscale_shorter_hint=hint),
        pkg.fn.decoders.image(j, device=device, jpeg_fancy_upsampling=False)),
        iters=1, batch=N_MIXED, root=mixed_root)


@pytest.mark.parametrize("device", ["cpu", "mixed"])
@pytest.mark.parametrize("hint", [0, 60])
def test_mixed_image_random_crop(mixed_root, device, hint):
    """The same windows as the reference: from the header for the JPEGs
    libjpeg reads; for CMYK/YCCK a first draw from the header and, after
    libjpeg declines the stream, a second from the decoded size with the same
    generator; one draw from the decoded size for PNG and BMP."""
    _run_pair(lambda pkg, j: (
        pkg.fn.decoders.image_random_crop(j, device=device, seed=7, downscale_shorter_hint=hint),
        pkg.fn.decoders.image_random_crop(j, device=device, random_area=[0.1, 1.0],
                                          random_aspect_ratio=[0.8, 1.25], num_attempts=100,
                                          downscale_shorter_hint=hint),
        pkg.fn.decoders.image_random_crop(j, device=device, output_type=pkg.types.GRAY)),
        iters=N_MIXED // 4 + 1, root=mixed_root)


@pytest.mark.parametrize("name", ["cmyk_420.jpg", "ycck.jpg"])
def test_image_random_crop_draws_twice_for_cmyk(tmp_path, name):
    """A CMYK or YCCK sample's window is the second draw of its generator:
    the first, from the header, is made and thrown away when libjpeg declines
    the stream. The crop is the second window of the whole decode, as in
    the reference."""
    from dali_tpu_torch.backend.decoders import sample_rrc_window

    (tmp_path / "c").mkdir()
    shutil.copy(os.path.join(CODECS, name), tmp_path / "c" / "a.jpg")
    _run_pair(lambda pkg, j: pkg.fn.decoders.image_random_crop(j, seed=3), iters=1, batch=1,
              root=str(tmp_path))
    ref, port = _pair(lambda pkg, j: pkg.fn.decoders.image_random_crop(j, seed=3), batch=1,
                      root=str(tmp_path))
    try:
        got = _host(port.run()[0])[0]
    finally:
        _close(ref, port)
    data = open(os.path.join(CODECS, name), "rb").read()
    full = port_codec.decode(data)
    # the operator's Philox stream: key (seed, iteration | sample << 40)
    rng = np.random.Generator(np.random.Philox(key=np.array([3, 0], dtype=np.uint64)))
    args = ([0.08, 1.0], [3 / 4, 4 / 3], 10)
    first = sample_rrc_window(rng, *port_codec.peek_shape(data)[:2], *args)
    y, x, ch, cw = sample_rrc_window(rng, *full.shape[:2], *args)
    np.testing.assert_array_equal(got, full[y:y + ch, x:x + cw])
    assert first != (y, x, ch, cw)


@pytest.mark.parametrize("device", ["cpu", "mixed"])
def test_mixed_image_crop_slice_peek(mixed_root, device):
    def graph(pkg, j):
        return (pkg.fn.decoders.image_crop(j, device=device, crop=(101, 123), crop_pos_x=0.3),
                pkg.fn.decoders.image_crop(j, device=device, crop=(64, 64),
                                           output_type=pkg.types.BGR),
                pkg.fn.decoders.image_slice(j, device=device),
                pkg.fn.peek_image_shape(j),
                pkg.fn.peek_image_shape(j, image_type=pkg.types.GRAY))

    _run_pair(graph, iters=N_MIXED // 4 + 1, root=mixed_root)


def _np(b):
    host = b.cpu()
    return [np.asarray(host.at(i)) for i in range(len(host))]


@pytest.mark.parametrize("device", ["cpu", "mixed"])
def test_mixed_eager_decoders(mixed_root, device):
    outs = []
    for m, types, ctx in ((ref_ndd, dali_tpu.types, ref_ndd.EvalContext(seed=5)),
                          (ndd, dali_tpu_torch.types, ndd.EvalContext(seed=5, device="cpu"))):
        with ctx:
            jpegs, _ = m.readers.file(file_root=mixed_root, batch_size=N_MIXED, name="R")
            res = [m.decoders.image(jpegs, device=device),
                   m.decoders.image_random_crop(jpegs, device=device, seed=3),
                   m.decoders.image_crop(jpegs, device=device, crop=(50, 70)),
                   m.decoders.image_slice(jpegs, device=device),
                   m.decoders.image(jpegs, device=device, output_type=types.GRAY),
                   m.peek_image_shape(jpegs)]
            outs.append([_np(r) for r in res])
    for want, got in zip(*outs):
        assert len(want) == len(got) == N_MIXED
        for w, g in zip(want, got):
            assert w.shape == g.shape and w.dtype == g.dtype
            np.testing.assert_array_equal(g, w)


def test_corrupt_sample_fails_its_batch_as_in_dali_tpu(tmp_path):
    """A truncated PNG beside decodable forms: both packages raise ValueError
    for the batch; without it the same batch decodes."""
    d = tmp_path / "c"
    d.mkdir()
    for name in ("cmyk_444.jpg", "png_rgb8.JPEG", "bmp24.bmp"):
        shutil.copy(os.path.join(CODECS, name), d / name)
    data = open(os.path.join(CODECS, "png_palette_trns.png"), "rb").read()
    (d / "z.png").write_bytes(data[:len(data) // 3])
    ref, port = _pair(lambda pkg, j: pkg.fn.decoders.image(j, device="mixed"), batch=4,
                      root=str(tmp_path))
    try:
        for pipe in (ref, port):
            with pytest.raises(ValueError):
                pipe.run()
    finally:
        _close(ref, port)


# -- the hybrid decoders reject every new form as the reference does ---------------------------
_HYBRID = {
    "int16": lambda pkg, j: pkg.fn.decoders.image(j, device="mixed", hybrid_device_decode=True),
    "int16_cache": lambda pkg, j: pkg.fn.decoders.image(j, device="mixed",
                                                        hybrid_device_decode=True, cache_size=8),
    "int8": lambda pkg, j: pkg.fn.decoders.image(j, device="mixed", hybrid_device_decode=True,
                                                 hybrid_scale=2, hybrid_wire="int8"),
    "int8_cache": lambda pkg, j: pkg.fn.decoders.image(j, device="mixed",
                                                       hybrid_device_decode=True, hybrid_scale=2,
                                                       hybrid_wire="int8", cache_size=8),
    "int8_rrc": lambda pkg, j: pkg.fn.decoders.image_random_crop(
        j, device="mixed", hybrid_device_decode=True, hybrid_scale=2, seed=1),
}
_REJECTED = ["cmyk_444.jpg", "cmyk_420.jpg", "ycck.jpg", "rgb.jpg", "s411.jpg", "h4v2.jpg",
             "png_rgb8.JPEG", "png_rgb16.png", "bmp24.bmp", "bmp_rle8.bmp"]


@pytest.mark.parametrize("hybrid", sorted(_HYBRID))
def test_hybrid_decoders_reject_new_forms_as_dali_tpu(tmp_path, hybrid):
    base = sorted(os.path.join(r, f) for r, _, fs in os.walk(CORPUS) for f in fs
                  if f.endswith(".jpg"))[0]
    for k, name in enumerate(_REJECTED):
        root = tmp_path / str(k)
        (root / "c").mkdir(parents=True)
        shutil.copy(os.path.join(CODECS, name), root / "c" / ("a" + os.path.splitext(name)[1]))
        shutil.copy(base, root / "c" / "b.jpg")
        errors = []
        ref, port = _pair(_HYBRID[hybrid], batch=2, root=str(root))
        try:
            for pipe in (ref, port):
                with pytest.raises(Exception) as e:
                    pipe.run()
                errors.append(e.value)
        finally:
            _close(ref, port)
        assert type(errors[1]) is type(errors[0]), (name, errors)
        assert "4:2:0/4:2:2/4:4:4" in str(errors[0]) and "4:2:0/4:2:2/4:4:4" in str(errors[1])


@pytest.mark.parametrize("hybrid", ["int16", "int8"])
def test_hybrid_decoders_read_partly_interleaved_scans(tmp_path, hybrid):
    """A 4:2:0 stream whose first scan interleaves two components rides both
    wires, as the reference's libjpeg fallback reads it."""
    (tmp_path / "c").mkdir()
    shutil.copy(os.path.join(CODECS, "partial_scans.jpg"), tmp_path / "c" / "a.jpg")
    _run_pair(_HYBRID[hybrid], iters=1, batch=1, root=str(tmp_path))


@pytest.mark.parametrize("width", [8, 13, 16, 24])
@pytest.mark.parametrize("sampling", ["420", "444"])
def test_truncated_progressive_narrow(width, sampling):
    """Block smoothing where a component is one, two or three blocks wide:
    libjpeg's sliding DC registers keep column 0 in the fifth register of a
    component two blocks wide. Cut inside the first (DC) scan, every
    estimate runs."""
    flag = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}[sampling]
    for h in (9, 24, 41):
        data = cv2.imencode(".jpg", _source(h, width, seed=h), [
            cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])[1].tobytes()
        sos = data.index(b"\xff\xda")
        cut = data[:(sos + data.index(b"\xff\xc4", sos + 2)) // 2]
        _assert_decodes_equal(cut, ["RGB", "GRAY"], dtypes=(None,), may_fail=True)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_jpeg_forms(seed, writer):
    """Random colour spaces (YCbCr, RGB, YCCK), sampling factors of 1, 2 or 4
    per component, baseline or progressive, whole or cut short."""
    rng = np.random.default_rng(seed)
    for _ in range(12):
        h, w = int(rng.integers(9, 80)), int(rng.integers(9, 80))
        img = _source(h, w, seed=int(rng.integers(1 << 30)))
        color = str(rng.choice(["ycc", "rgb", "ycck"]))
        nc = 4 if color == "ycck" else 3
        while True:
            fac = [(int(rng.choice([1, 2, 4])), int(rng.choice([1, 2, 4]))) for _ in range(nc)]
            if sum(a * b for a, b in fac) <= 10:  # libjpeg's blocks per MCU
                break
        px = img if nc == 3 else np.ascontiguousarray(np.concatenate([img, img[..., :1]], -1))
        data = writer(px, color, ";".join(f"{a},{b}" for a, b in fac),
                      quality=int(rng.integers(50, 100)), progressive=bool(rng.integers(0, 2)))
        if rng.random() < 0.4:
            data = data[:int(len(data) * rng.uniform(0.2, 1.0))]
        _assert_decodes_equal(data, ["RGB", "GRAY"], dtypes=(None,), may_fail=True)
