"""TIFF in dali_tpu_torch (ROADMAP.md Queue 1 item 1d): the native decoder
(``csrc/host/tiff_decode.cc``, Deflate chunks through ``inflate.cc``)
against dali_tpu, which decodes TIFF through ``cv2.imdecode``
(OpenCV 5.0, over its bundled libtiff).

Contract: bit-equal, for every output type and dtype, through
``imgcodec.decode`` and through ``decoders.image`` and its crop forms on
the cpu and mixed placements, and a batch decoded in one native call on the
task pool equal to its samples decoded one at a time. cv2 is the oracle, not
the writers: PIL's files (every compression, palette, bilevel, RGBA, 16-bit,
float32, several pages, Orientation 1-8), cv2's own, and forms PIL does not
write from ``make_codec_corpus.tiff_bytes`` (tiles, planar configuration 2,
big-endian, BigTIFF, predictor 2, LZW, PackBits, min-is-white, separate
alpha kinds). A file cv2 refuses raises ``ValueError`` in both packages; a
form the decoder does not read raises ``NotImplementedError`` naming ROADMAP
item 1h; truncated and corrupt files raise the same exception class in both.
"""

import io
import itertools
import os
import shutil
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

import dali_tpu
import dali_tpu_torch
from dali_tpu import imgcodec as ref_codec
from dali_tpu_torch import imgcodec as port_codec
from dali_tpu_torch import native as port_native

from .test_torch_image_decoders import _assert_same, _close
from .test_torch_webp import (DTYPES, OUTPUT_TYPES, _assert_batch_equals_one_at_a_time,
                              _assert_equal, _corpus_rgb)

HERE = os.path.dirname(__file__)
TESTDATA = os.path.join(HERE, "..", "dali_tpu_torch", "testdata")
CODECS = os.path.join(TESTDATA, "codecs")
CORPUS = os.path.join(TESTDATA, "rn50")
sys.path.insert(0, TESTDATA)
from make_codec_corpus import tiff_bytes  # noqa: E402

FIXTURES = sorted(f for f in os.listdir(CODECS) if f.endswith(".tif"))
RNG = np.random.default_rng(17)
SIZES = [(1, 1), (17, 9), (37, 53)]


def _outcome(fn):
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return None, type(e)


def _assert_same_outcome(data, output_types=OUTPUT_TYPES, dtypes=DTYPES):
    """Every output type and dtype decodes bit-equal in both packages, or
    fails in both with the same exception class."""
    for ot in output_types:
        for dt in dtypes:
            outs = []
            for codec, pkg in ((ref_codec, dali_tpu), (port_codec, dali_tpu_torch)):
                outs.append(_outcome(lambda: codec.decode(
                    data, getattr(pkg.types.DALIImageType, ot), 1, True, True,
                    getattr(pkg.types.DALIDataType, dt) if dt else None)))
            (want, werr), (got, gerr) = outs
            assert werr == gerr, (ot, dt, werr, gerr)
            if want is not None:
                assert got.shape == want.shape and got.dtype == want.dtype, (ot, dt)
                np.testing.assert_array_equal(got, want, err_msg=str((ot, dt)))


def _pil_tiff(img, **kw):
    buf = io.BytesIO()
    img.save(buf, "TIFF", **kw)
    return buf.getvalue()


def _pil_forms(h, w, seed):
    rng = np.random.default_rng(seed)
    rgb = _corpus_rgb(seed % 32, h, w)
    pal = Image.fromarray(rng.integers(0, 200, (h, w), np.uint8), "P")
    pal.putpalette(rng.integers(0, 256, 768).astype(np.uint8).tobytes())
    return {
        "RGB": Image.fromarray(rgb),
        "L": Image.fromarray(rgb[..., 1]),
        "RGBA": Image.fromarray(np.dstack([rgb, rng.integers(0, 256, (h, w), np.uint8)]), "RGBA"),
        "LA": Image.fromarray(np.dstack([rgb[..., 0], rgb[..., 2]]), "LA"),
        "1": Image.fromarray(rng.integers(0, 2, (h, w)).astype(bool)),
        "P": pal,
        "I;16": Image.fromarray(rng.integers(0, 65536, (h, w), np.uint16)),
        "F": Image.fromarray(rng.random((h, w), np.float32)),
    }


# -- the committed fixtures -----------------------------------------------------------------------
def test_fixtures_are_present():
    assert FIXTURES == ["tiff_lzw_pred.tif", "tiff_rgb16.tif", "tiff_rgba.tif",
                        "tiff_tiled_deflate.tif"]


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_decodes_as_dali_tpu(name):
    _assert_equal(open(os.path.join(CODECS, name), "rb").read())


def test_fixtures_hold_the_forms_they_name():
    shapes = {}
    for name in FIXTURES:
        data = open(os.path.join(CODECS, name), "rb").read()
        shapes[name] = port_native.tiff_info(data)
    assert shapes["tiff_rgb16.tif"][3] == np.uint16
    assert all(shapes[n][3] == np.uint8 for n in FIXTURES if n != "tiff_rgb16.tif")
    assert shapes["tiff_tiled_deflate.tif"][4] == 12  # 3 x 4 Deflate tiles of 128 px
    assert open(os.path.join(CODECS, "tiff_rgb16.tif"), "rb").read()[:2] == b"MM"


# -- PIL's writer ---------------------------------------------------------------------------------
@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "tiff_deflate", "tiff_adobe_deflate",
                                         "packbits", "jpeg"])
@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "LA", "1", "P", "I;16", "F"])
def test_pil_forms(mode, compression):
    for k, (h, w) in enumerate(SIZES):
        img = _pil_forms(h, w, 3 + k)[mode]
        if compression == "jpeg":
            if mode not in ("RGB", "L"):
                continue
            # JPEG-in-TIFF is not read (item 1h); the reference decodes it
            data = _pil_tiff(img, compression="jpeg")
            assert ref_codec.decode(data).shape == (h, w, 3)
            with pytest.raises(NotImplementedError, match=r"Queue 1 item 1h"):
                port_codec.decode(data)
            continue
        _assert_same_outcome(_pil_tiff(img, compression=compression))


def test_pil_float_decodes_grey_and_fails_colour_in_both():
    """cv2 reads a one-sample float TIFF into one channel only."""
    data = _pil_tiff(Image.fromarray(RNG.random((20, 30), np.float32)))
    _assert_same_outcome(data)
    with pytest.raises(ValueError):
        port_codec.decode(data)
    g = port_codec.decode(data, dali_tpu_torch.types.DALIImageType.GRAY,
                          dtype=dali_tpu_torch.types.DALIDataType.FLOAT)
    assert g.dtype == np.float32 and g.shape == (20, 30, 1)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_pil_orientation(orientation):
    for img in (Image.fromarray(_corpus_rgb(5, 30, 44)),
                Image.fromarray(RNG.integers(0, 65536, (30, 44), np.uint16))):
        data = _pil_tiff(img, tiffinfo={274: orientation})
        _assert_equal(data, ["RGB", "GRAY"], [None, "UINT16"])
        want = ref_codec.peek_shape(data)
        assert port_codec.peek_shape(data) == want == ((44, 30, 3) if orientation >= 5
                                                        else (30, 44, 3))


def test_pil_several_pages_give_the_first():
    pages = [Image.fromarray(_corpus_rgb(i, 40, 60)) for i in (6, 7, 8)]
    data = _pil_tiff(pages[0], save_all=True, append_images=pages[1:], compression="tiff_lzw")
    _assert_equal(data)
    np.testing.assert_array_equal(port_codec.decode(data), np.asarray(pages[0]))


def test_cv2_written():
    """cv2's encoder: LZW with predictor 2 (8 and 16 bits) and the
    floating-point predictor 3 (float32)."""
    for dt, scale in ((np.uint8, 255), (np.uint16, 65535), (np.float32, 1)):
        for ch in (1, 3):
            img = (RNG.random((23, 31, ch)) * scale).astype(dt)
            data = cv2.imencode(".tiff", img)[1].tobytes()
            _assert_same_outcome(data)


# -- forms PIL does not write ---------------------------------------------------------------------
LAYOUTS = {
    "strips": {"rows_per_strip": 5},
    "one_strip": {},
    "tiles": {"tile": (32, 32)},
    "tiles_16x64": {"tile": (16, 64)},
    "tile_past_edge": {"tile": (64, 64)},
}


def _writer_forms(h, w, seed):
    rng = np.random.default_rng(seed)
    rgb = _corpus_rgb(seed % 32, h, w)
    a = rng.integers(0, 256, (h, w, 1), np.uint8)
    u16 = rng.integers(0, 65536, (h, w, 4), np.uint16)
    f32 = rng.random((h, w, 3)).astype(np.float32)
    cm8 = rng.integers(0, 256, (3, 256)).astype(np.uint16)
    return {
        "rgb8": (rgb, {}),
        "rgba8_unassociated": (np.concatenate([rgb, a], 2), {"extra": 2}),
        "rgba8_associated": (np.concatenate([rgb, a], 2), {"extra": 1}),
        "rgba8_unspecified": (np.concatenate([rgb, a], 2), {"extra": 0}),
        "grey8": (rgb[..., 0], {}),
        "grey8_min_is_white": (rgb[..., 0], {"photometric": 0}),
        "grey_alpha8": (np.concatenate([rgb[..., :1], a], 2), {"extra": 2}),
        "rgb16": (u16[..., :3], {"bps": 16}),
        "rgba16": (u16, {"bps": 16, "extra": 2}),
        "grey16": (u16[..., 0], {"bps": 16}),
        "grey16_min_is_white": (u16[..., 0], {"bps": 16, "photometric": 0}),
        "rgb_float": (f32, {"bps": 32, "sample_format": 3}),
        "palette8": (rng.integers(0, 256, (h, w), np.uint8), {"colormap": cm8}),
        "palette8_16bit_map": (rng.integers(0, 256, (h, w), np.uint8), {"colormap": cm8 * 257}),
        "palette4": (rng.integers(0, 16, (h, w), np.uint8),
                     {"bps": 4, "colormap": cm8[:, :16] * 257}),
        "palette1": (rng.integers(0, 2, (h, w), np.uint8), {"bps": 1, "colormap": cm8[:, :2]}),
        "bilevel": (rng.integers(0, 2, (h, w), np.uint8), {"bps": 1}),
        "bilevel_min_is_white": (rng.integers(0, 2, (h, w), np.uint8),
                                 {"bps": 1, "photometric": 0}),
    }


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_writer_forms(compression, layout):
    for k, (h, w) in enumerate(SIZES):
        for name, (img, kw) in _writer_forms(h, w, 20 + k).items():
            preds = [1, 2] if compression in (5, 8) and kw.get("bps", 8) >= 8 else [1]
            if compression in (5, 8) and name == "rgb_float":
                preds.append(3)
            for pred in preds:
                data = tiff_bytes(img, compression=compression, predictor=pred,
                                  **LAYOUTS[layout], **kw)
                try:
                    _assert_same_outcome(data, ["RGB", "GRAY", "BGR"], [None, "FLOAT"])
                except AssertionError as e:
                    raise AssertionError(f"{name} predictor {pred}: {e}") from None


@pytest.mark.parametrize("big_endian", [False, True])
@pytest.mark.parametrize("bigtiff", [False, True])
@pytest.mark.parametrize("planar", [1, 2])
def test_byte_orders_bigtiff_and_planes(big_endian, bigtiff, planar):
    rgb = _corpus_rgb(9, 45, 61)
    a = np.linspace(0, 255, 45 * 61, dtype=np.uint8).reshape(45, 61, 1)
    for img, kw in ((rgb, {}), (np.concatenate([rgb, a], 2), {"extra": 2}),
                    (np.concatenate([rgb, a], 2), {"extra": 1}),
                    (np.concatenate([rgb[..., :1], a], 2), {"extra": 2}),
                    (rgb.astype(np.uint16) * 257, {"bps": 16})):
        for compression, layout in itertools.product((1, 5, 8), ("strips", "tiles")):
            data = tiff_bytes(img, compression=compression, planar=planar, big_endian=big_endian,
                              bigtiff=bigtiff, predictor=2 if compression != 1 else 1,
                              **LAYOUTS[layout], **kw)
            if planar == 2 and kw.get("bps") == 16:
                # 16-bit planes stored separately are not read (item 1h)
                with pytest.raises(NotImplementedError, match=r"Queue 1 item 1h"):
                    port_codec.decode(data)
                continue
            _assert_same_outcome(data, ["RGB", "GRAY"], [None])


@pytest.mark.parametrize("orientation", range(1, 9))
def test_writer_orientation(orientation):
    """Tiles and 16-bit strips turned by the Orientation tag."""
    for img, kw in ((_corpus_rgb(10, 40, 70), {"tile": (32, 32), "compression": 5}),
                    (RNG.integers(0, 65536, (40, 70, 3), np.uint16), {"bps": 16})):
        data = tiff_bytes(img, orientation=orientation, **kw)
        _assert_equal(data, ["RGB", "GRAY"], [None])
        assert port_codec.peek_shape(data) == ref_codec.peek_shape(data)


def test_forms_cv2_refuses_raise_value_error_in_both():
    """2-bit samples, 4-bit grey, an uncompressed tile whose byte size is not
    a multiple of 1024, float into three channels from one sample."""
    rng = np.random.default_rng(5)
    for data in (tiff_bytes(rng.integers(0, 4, (20, 30), np.uint8), bps=2),
                 tiff_bytes(rng.integers(0, 16, (20, 30), np.uint8), bps=4),
                 tiff_bytes(rng.integers(0, 256, (40, 40), np.uint8), tile=(16, 16)),
                 tiff_bytes(rng.random((20, 30)).astype(np.float32), bps=32, sample_format=3)):
        for pkg_codec in (ref_codec, port_codec):
            with pytest.raises(ValueError):
                pkg_codec.decode(data)


def test_signature_alone_raises_value_error_in_both():
    """A TIFF signature with nothing behind it: read as a TIFF now, and
    refused as cv2 refuses it."""
    data = b"II*\x00" + bytes(28)
    for codec in (ref_codec, port_codec):
        with pytest.raises(ValueError):
            codec.decode(data)


def test_forms_not_read_raise_not_implemented():
    """CMYK (PIL), predictor 3 on integers and 16-bit separate planes:
    NotImplementedError naming the item; the reference decodes each."""
    cmyk = _pil_tiff(Image.fromarray(_corpus_rgb(11, 20, 30)).convert("CMYK"))
    planes16 = tiff_bytes(RNG.integers(0, 65536, (20, 30, 3), np.uint16), bps=16, planar=2)
    for data in (cmyk, planes16):
        ref_codec.decode(data)
        with pytest.raises(NotImplementedError, match=r"Queue 1 item 1h"):
            port_codec.decode(data)


# -- truncated and corrupt files ------------------------------------------------------------------
@pytest.mark.parametrize("name", FIXTURES)
def test_truncated_files(name):
    data = open(os.path.join(CODECS, name), "rb").read()
    for cut in (4, 7, 9, 30, len(data) // 4, len(data) // 2, len(data) - 200, len(data) - 1):
        _assert_same_outcome(data[:cut], ["RGB"], [None])


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
def test_corrupt_files(compression):
    """Byte flips in the strips. libtiff's RGBA reader goes on past a codec
    error with what the codec wrote before it, the predictor not undone:
    LZW, PackBits, Deflate (``inflate.cc`` stops where zlib does) and short
    uncompressed strips come out bit-equal; Deflate in every output type and
    dtype."""
    data = tiff_bytes(_corpus_rgb(12, 24, 40), compression=compression, rows_per_strip=6,
                      predictor=2 if compression in (5, 8) else 1)
    offsets, counts, _ = port_native.tiff_chunks(data, 4)
    lo, hi = int(offsets[0]), int(offsets[-1] + counts[-1])
    rng = np.random.default_rng(compression)
    for _ in range(60):
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(lo, hi))] ^= int(rng.integers(1, 256))
        if compression == 8:
            _assert_same_outcome(bytes(b))
        else:
            _assert_same_outcome(bytes(b), ["RGB"], [None])


@pytest.mark.parametrize("bps", [8, 16])
def test_corrupt_deflate_predictor_2(bps):
    """250 random corruptions of a Deflate TIFF with predictor 2 (bit flips
    and byte overwrites anywhere in its strips, the zlib headers and Adler-32
    trailers included): bit-equal to ``dali_tpu`` or failing alike, in the
    8-bit RGBA route (codec errors kept) and the 16-bit raw route (codec
    errors fail the file)."""
    img = _corpus_rgb(14, 30, 44) if bps == 8 else \
        (_corpus_rgb(14, 30, 44).astype(np.uint16) * 257)
    data = tiff_bytes(img, bps=bps, compression=8, rows_per_strip=5, predictor=2)
    offsets, counts, _ = port_native.tiff_chunks(data, 6)
    rng = np.random.default_rng(100 + bps)
    for k in range(250):
        b = bytearray(data)
        c = int(rng.integers(0, 6))
        lo, hi = int(offsets[c]), int(offsets[c] + counts[c])
        for _ in range(int(rng.integers(1, 3))):
            pos = int(rng.integers(lo, hi))
            if k % 2:
                b[pos] ^= 1 << int(rng.integers(0, 8))
            else:
                b[pos] = int(rng.integers(0, 256))
        _assert_same_outcome(bytes(b), ["RGB"], [None])


def test_corrupt_tiled_deflate_fixture():
    """100 byte flips in the tiles of the tiled Deflate fixture (12 tiles of
    128 px, predictor 2): bit-equal to ``dali_tpu``, tile by tile."""
    data = open(os.path.join(CODECS, "tiff_tiled_deflate.tif"), "rb").read()
    n = port_native.tiff_info(data)[4]
    offsets, counts, _ = port_native.tiff_chunks(data, n)
    rng = np.random.default_rng(8)
    for _ in range(100):
        b = bytearray(data)
        c = int(rng.integers(0, n))
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(int(offsets[c]), int(offsets[c] + counts[c])))] ^= \
                int(rng.integers(1, 256))
        _assert_same_outcome(bytes(b), ["RGB"], [None])


def test_truncated_deflate_stream():
    """A Deflate strip whose stream stops short (its byte count cut, so the
    file stays well formed): cv2 keeps what inflated in the 8-bit route and
    fails the 16-bit one; the port does the same, at every cut."""
    for bps in (8, 16):
        img = _corpus_rgb(15, 20, 36)
        img = img if bps == 8 else img.astype(np.uint16) * 257
        data = bytearray(tiff_bytes(img, bps=bps, compression=8, predictor=2))
        count = int(port_native.tiff_chunks(bytes(data), 1)[1][0])
        # the StripByteCounts entry (tag 279, one LONG): its value follows tag, type and count
        field = bytes(data).index((279).to_bytes(2, "little") + (4).to_bytes(2, "little")
                                  + (1).to_bytes(4, "little")) + 8
        for cut in (1, 2, 3, 7, count // 3, count // 2, count - 5, count - 4, count - 1):
            b = bytearray(data)
            b[field:field + 4] = cut.to_bytes(4, "little")
            assert int(port_native.tiff_chunks(bytes(b), 1)[1][0]) == cut
            _assert_same_outcome(bytes(b), ["RGB"], [None, "FLOAT"])


def test_inflate_matches_zlib():
    """``inflate.cc`` against this box's zlib on valid streams of every
    level (stored, fixed and dynamic blocks) and on corrupted ones: the same
    error, or the same bytes, with the output capped at the data's size."""
    import zlib
    rng = np.random.default_rng(3)
    for k in range(400):
        n = int(rng.integers(1, 3000))
        raw = [rng.integers(0, 256, n, np.uint8).tobytes(), bytes(rng.integers(0, 3, n, np.uint8)),
               (b"abcabcab" * 400)[:n]][k % 3]
        comp = zlib.compress(raw, k % 10)
        status, out = port_native.inflate_zlib(comp, n)
        assert out == raw and status in (port_native.INFLATE_END, port_native.INFLATE_FULL)
        b = bytearray(comp)
        b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
        status, out = port_native.inflate_zlib(bytes(b), n)
        try:
            want = zlib.decompressobj().decompress(bytes(b), n)
        except zlib.error:
            assert status == port_native.INFLATE_ERROR, k
            continue
        assert status != port_native.INFLATE_ERROR and out == want, k


# -- batches and pipelines ------------------------------------------------------------------------
def test_batch_on_the_pool_equals_one_at_a_time():
    datas = [open(os.path.join(CODECS, n), "rb").read() for n in FIXTURES]
    datas += [tiff_bytes(img, compression=8, orientation=6, **kw)
              for img, kw in list(_writer_forms(33, 47, 40).values())[:10]]
    _assert_batch_equals_one_at_a_time(datas, port_native.KIND_TIFF)


@pytest.fixture(scope="module")
def tiff_root(tmp_path_factory):
    """The TIFF fixtures, four writer forms and three corpus JPEGs in one
    class folder."""
    root = tmp_path_factory.mktemp("tiffs")
    d = root / "c"
    d.mkdir()
    for name in FIXTURES:
        shutil.copy(os.path.join(CODECS, name), d / name)
    forms = _writer_forms(150, 200, 50)
    for name in ("grey8_min_is_white", "palette4", "rgb_float", "grey16"):
        img, kw = forms[name]
        (d / f"{name}.tiff").write_bytes(tiff_bytes(img, compression=5, rows_per_strip=40, **kw))
    (d / "turned.tif").write_bytes(tiff_bytes(_corpus_rgb(13, 120, 90), orientation=6))
    jpgs = sorted(os.path.join(r, f) for r, _, fs in os.walk(CORPUS) for f in fs)[:3]
    for i, f in enumerate(jpgs):
        shutil.copy(f, d / f"base_{i}.jpg")
    return str(root)


def _run_pair(graph, root, iters=3, batch=4):
    pipes = []
    for pkg, extra in ((dali_tpu, {"debug": True}), (dali_tpu_torch, {"device": "cpu"})):
        @pkg.pipeline_def(batch_size=batch, num_threads=2, seed=42, **extra)
        def p():
            data, labels = pkg.fn.readers.file(file_root=root, random_shuffle=True, name="Reader",
                                               seed=1234)
            outs = graph(pkg, data)
            return (*outs, labels) if isinstance(outs, tuple) else (outs, labels)

        pipe = p()
        pipe.build()
        pipes.append(pipe)
    try:
        _assert_same(*pipes, iters)
    finally:
        _close(*pipes)


@pytest.mark.parametrize("device", ["cpu", "mixed"])
@pytest.mark.parametrize("output_type", ["RGB", "BGR", "YCbCr", "ANY_DATA"])
def test_decoders_image(tiff_root, device, output_type):
    for dtype in ("UINT8", "UINT16", "FLOAT"):
        _run_pair(lambda pkg, j: pkg.fn.decoders.image(
            j, device=device, output_type=getattr(pkg.types.DALIImageType, output_type),
            dtype=getattr(pkg.types, dtype)), tiff_root)


@pytest.mark.parametrize("device", ["cpu", "mixed"])
def test_decoders_crop_forms(tiff_root, device):
    _run_pair(lambda pkg, j: (
        pkg.fn.decoders.image_random_crop(j, device=device, seed=5),
        pkg.fn.decoders.image_crop(j, device=device, crop=(64, 80), crop_pos_x=0.2,
                                   crop_pos_y=0.7),
        pkg.fn.decoders.image_slice(j, pkg.types.Constant(np.float32([0.1, 0.25])),
                                    pkg.types.Constant(np.float32([0.5, 0.6])),
                                    device=device)), tiff_root)


def test_peek_image_shape_turns_by_orientation(tiff_root):
    for pkg, extra in ((dali_tpu, {"debug": True}), (dali_tpu_torch, {"device": "cpu"})):
        @pkg.pipeline_def(batch_size=1, num_threads=1, **extra)
        def p():
            data = pkg.fn.external_source(source=lambda: [np.frombuffer(open(
                os.path.join(tiff_root, "c", "turned.tif"), "rb").read(), np.uint8)], batch=True)
            return pkg.fn.peek_image_shape(data)

        pipe = p()
        pipe.build()
        try:
            assert [int(v) for v in np.asarray(pipe.run()[0].at(0))] == [90, 120, 3]
        finally:
            if pkg is dali_tpu:
                pipe._executor.shutdown()
            else:
                pipe.shutdown()
