"""PNM in dali_tpu_torch (ROADMAP.md Queue 1 item 1f): the native decoder
(``csrc/host/pnm_decode.cc``) against dali_tpu, which decodes PBM, PGM and
PPM through ``cv2.imdecode`` (OpenCV 5.0).

Contract: bit-equal, for every output type and dtype, through
``imgcodec.decode`` and through ``decoders.image`` and its crop forms on
the cpu and mixed placements, and a batch decoded in one native call on the
task pool equal to its samples decoded one at a time. The inputs: P1-P6,
ASCII and binary, at maxval 1, 15, 255, 1000 and 65535 (8-bit below 256,
16-bit above, unscaled in binary files and, at 8 bits, scaled in ASCII ones,
as cv2 reads them), with and without comments, at odd and tiny sizes, from
``make_codec_corpus.pnm_bytes``; the committed PPM fixture. Truncated and
malformed files raise the same exception class in both packages.
"""

import os
import shutil
import sys

import numpy as np
import pytest

import dali_tpu_torch
from dali_tpu import imgcodec as ref_codec
from dali_tpu_torch import imgcodec as port_codec
from dali_tpu_torch import native as port_native

from .test_torch_tiff import _assert_same_outcome, _outcome, _run_pair
from .test_torch_webp import _assert_batch_equals_one_at_a_time, _assert_equal, _corpus_rgb

HERE = os.path.dirname(__file__)
TESTDATA = os.path.join(HERE, "..", "dali_tpu_torch", "testdata")
CODECS = os.path.join(TESTDATA, "codecs")
CORPUS = os.path.join(TESTDATA, "rn50")
sys.path.insert(0, TESTDATA)
from make_codec_corpus import pnm_bytes  # noqa: E402

SIZES = [(1, 1), (9, 17), (31, 45)]
MAXVALS = [1, 15, 255, 1000, 65535]


def _image(kind, h, w, maxval, seed):
    rng = np.random.default_rng(seed)
    shape = (h, w, 3) if kind in (3, 6) else (h, w)
    return rng.integers(0, (1 if kind in (1, 4) else maxval) + 1, shape)


def test_fixture_decodes_as_dali_tpu():
    data = open(os.path.join(CODECS, "ppm_binary.ppm"), "rb").read()
    assert data[:2] == b"P6"
    _assert_equal(data)


# bitmaps (P1, P4) have no maxval
FORMS = [(1, 1), (4, 1)] + [(kind, m) for kind in (2, 3, 5, 6) for m in MAXVALS]


@pytest.mark.parametrize("kind,maxval", FORMS)
def test_forms(kind, maxval):
    for k, (h, w) in enumerate(SIZES):
        for comment in (False, True):
            data = pnm_bytes(kind, _image(kind, h, w, maxval, 10 * kind + k), maxval, comment)
            _assert_equal(data)


@pytest.mark.parametrize("kind", [5, 6])
def test_binary_samples_above_maxval_pass_unscaled(kind):
    """A binary sample above maxval comes out as stored; an ASCII one is
    clipped to maxval (and, at 8 bits, scaled by 255 / maxval)."""
    img = _image(kind, 6, 7, 255, kind)
    data = pnm_bytes(kind, img, 255).replace(b"\n255\n", b"\n15\n", 1)
    _assert_equal(data)
    ascii_ = pnm_bytes(kind - 3, img, 255).replace(b"\n255\n", b"\n15\n", 1)
    _assert_equal(ascii_)
    got = port_codec.decode(ascii_, dali_tpu_torch.types.DALIImageType.ANY_DATA)
    assert got.max() == 255 and got.dtype == np.uint8


def test_header_forms():
    """Comments between every header number, CR line ends, tabs, a comment
    closed by CR."""
    img = _image(6, 5, 4, 255, 3)
    body = img.astype(np.uint8).tobytes()
    for head in (b"P6\n# a\n4\n# b\n5 # c\n255\n", b"P6\r\n4\t5\r\n255\r", b"P6 4 5 255\t",
                 b"P6\n#x\r4 5\n255\n"):
        _assert_equal(head + body, ["RGB", "GRAY"], [None])


def test_peek_shape():
    for kind in range(1, 7):
        data = pnm_bytes(kind, _image(kind, 13, 21, 1000, kind), 1000)
        assert port_codec.peek_shape(data) == ref_codec.peek_shape(data) == (13, 21, 3)


# -- truncated and malformed files ----------------------------------------------------------------
@pytest.mark.parametrize("kind", range(1, 7))
def test_truncated_files(kind):
    data = pnm_bytes(kind, _image(kind, 12, 19, 1000 if kind in (2, 5) else 255, kind),
                     1000 if kind in (2, 5) else 255)
    for cut in (3, 5, 9, len(data) // 2, len(data) - 2, len(data) - 1):
        _assert_same_outcome(data[:cut], ["RGB"], [None])


def test_malformed_headers():
    body = bytes(64)
    for data in (b"P6\n4 5\n70000\n" + body, b"P6\n0 5\n255\n" + body, b"P6\n4 0\n255\n" + body,
                 b"P6\n4 5\n0\n" + body, b"P6\nx 5\n255\n" + body, b"P5\n4 5 255\n",
                 b"P5 99999999999 2 255\n" + body):
        _assert_same_outcome(data, ["RGB"], [None])
        with pytest.raises(ValueError):
            port_codec.decode(data)


def test_signature_needs_whitespace():
    """``P6`` not followed by whitespace is no PNM to cv2 (the reference fails
    it); the port does not read it either."""
    data = b"P6#x\n4 5\n255\n" + bytes(60)
    with pytest.raises(ValueError):
        ref_codec.decode(data)
    assert port_codec.native_kind(data) is None
    with pytest.raises(NotImplementedError):
        port_codec.decode(data)


# -- batches and pipelines ------------------------------------------------------------------------
def test_batch_on_the_pool_equals_one_at_a_time():
    datas = [pnm_bytes(kind, _image(kind, h, w, m, kind + h), m)
             for kind in range(1, 7) for (h, w) in SIZES for m in (255, 1000)]
    _assert_batch_equals_one_at_a_time(datas, port_native.KIND_PNM)


@pytest.fixture(scope="module")
def pnm_root(tmp_path_factory):
    """The PPM fixture, one file of each other kind (``.pbm``, ``.pgm``,
    ``.pnm``) and three corpus JPEGs in one class folder."""
    root = tmp_path_factory.mktemp("pnms")
    d = root / "c"
    d.mkdir()
    shutil.copy(os.path.join(CODECS, "ppm_binary.ppm"), d / "fixture.ppm")
    rgb = _corpus_rgb(20, 90, 120)
    grey = rgb[..., 1]
    (d / "ascii.pbm").write_bytes(pnm_bytes(1, grey > 128))
    (d / "binary.pbm").write_bytes(pnm_bytes(4, grey > 100))
    (d / "ascii.pgm").write_bytes(pnm_bytes(2, grey, 255, comment=True))
    (d / "wide.pgm").write_bytes(pnm_bytes(5, grey.astype(np.uint16) * 200, 65535))
    (d / "ascii.pnm").write_bytes(pnm_bytes(3, rgb // 16, 15))
    (d / "wide.ppm").write_bytes(pnm_bytes(6, rgb.astype(np.uint16) * 3, 1000))
    jpgs = sorted(os.path.join(r, f) for r, _, fs in os.walk(CORPUS) for f in fs)[:3]
    for i, f in enumerate(jpgs):
        shutil.copy(f, d / f"base_{i}.jpg")
    return str(root)


@pytest.mark.parametrize("device", ["cpu", "mixed"])
@pytest.mark.parametrize("output_type", ["RGB", "BGR", "GRAY", "YCbCr", "ANY_DATA"])
def test_decoders_image(pnm_root, device, output_type):
    for dtype in ("UINT8", "UINT16", "FLOAT"):
        _run_pair(lambda pkg, j: pkg.fn.decoders.image(
            j, device=device, output_type=getattr(pkg.types.DALIImageType, output_type),
            dtype=getattr(pkg.types, dtype)), pnm_root)


@pytest.mark.parametrize("device", ["cpu", "mixed"])
def test_decoders_crop_forms(pnm_root, device):
    _run_pair(lambda pkg, j: (
        pkg.fn.decoders.image_random_crop(j, device=device, seed=5),
        pkg.fn.decoders.image_crop(j, device=device, crop=(64, 80), crop_pos_x=0.2,
                                   crop_pos_y=0.7),
        pkg.fn.decoders.image_slice(j, pkg.types.Constant(np.float32([0.1, 0.25])),
                                    pkg.types.Constant(np.float32([0.5, 0.6])),
                                    device=device)), pnm_root)


def test_outcome_helper_reports_the_class():
    assert _outcome(lambda: 1) == (1, None)
    assert _outcome(lambda: port_codec.decode(b"P6\n"))[1] is ValueError
