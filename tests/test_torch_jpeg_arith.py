"""Arithmetic-coded JPEG (SOF9 extended sequential, SOF10 progressive, DAC
conditioning) in dali_tpu_torch's libjpeg-free reader
(``csrc/host/jpeg_arith.cc``) against dali_tpu, whose route for these
streams is libjpeg-turbo 2.1.5 (cv2 5.0 for CMYK), and against cv2 5.0.

The fixtures are corpus images re-coded losslessly by libjpeg's transcoder
(``testdata/make_codec_corpus.py`` ``Transcoder``, compiled into a temporary
directory): SOF9 4:2:0 / 4:2:2 / 4:4:4 / grayscale / CMYK, SOF10 with
successive approximation, restart intervals, non-default DAC conditioning,
and SOF9 and SOF10 cut at 60% of their bytes. ``testdata/arith`` is the
rn50 corpus re-coded the same way (SOF9 and SOF10 in turn).

Contract: bit-equal, every decoder placement, cpu and mixed, both hybrid
wires at scales 1 and 2; the int16 coefficient read equal to libjpeg's
``jpeg_read_coefficients``. Lossless, SOF11 (arithmetic) and hierarchical
frames raise in both packages."""

import os
import sys

import cv2
import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch
from dali_tpu import imgcodec as ref_codec
from dali_tpu import native as ref_native
from dali_tpu_torch import imgcodec as port_codec
from dali_tpu_torch import native as port_native

from .test_torch_image_decoders import _close, _host, _run_pair
from .test_torch_image_formats import _HYBRID, _assert_decodes_equal, _pil_jpeg, _source
from .test_torch_jpeg_decode import _assert_decode_equal, _assert_read_equal

TESTDATA = os.path.join(os.path.dirname(__file__), "..", "dali_tpu_torch", "testdata")
sys.path.insert(0, TESTDATA)
import make_codec_corpus  # noqa: E402

ARITH = os.path.join(TESTDATA, "arith")
HUFFMAN = os.path.join(TESTDATA, "rn50")
SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}


def _huffman(img, sampling="420", quality=90):
    return cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality,
                                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])[1]\
        .tobytes()


def _sof(data):
    """The frame marker's code byte and its offset."""
    for m in (0xC9, 0xCA, 0xC0, 0xC1, 0xC2):
        i = data.find(bytes([0xFF, m]))
        if i >= 0:
            return m, i
    raise AssertionError("no frame header")


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    t = make_codec_corpus.Transcoder(str(tmp_path_factory.mktemp("transcode")))
    img = _source(75, 97, seed=3)[:, :, ::-1]
    out = {f"sof9_{s}": t(_huffman(img, s)) for s in SAMPLING}
    out["sof9_gray"] = t(cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))[1].tobytes())
    out["sof9_cmyk"] = t(_pil_jpeg(_source(61, 83, seed=4), mode="CMYK", quality=90))
    out["sof10_sa"] = t(_huffman(img), progressive=True)
    out["sof10_gray"] = t(out["sof9_gray"], progressive=True)
    out["sof9_restart"] = t(_huffman(img, "422"), restart=3)
    out["sof10_restart"] = t(_huffman(img), progressive=True, restart=2)
    out["sof9_dac"] = t(_huffman(img), dac=(2, 4, 12))
    out["sof10_dac"] = t(_huffman(img, "444"), progressive=True, dac=(1, 3, 30))
    for k in ("sof9_420", "sof10_sa"):
        out[k.split("_")[0] + "_cut60"] = out[k][:int(len(out[k]) * 0.6)]
    return out


NAMES = ["sof9_420", "sof9_422", "sof9_444", "sof9_gray", "sof9_cmyk", "sof10_sa", "sof10_gray",
         "sof9_restart", "sof10_restart", "sof9_dac", "sof10_dac", "sof9_cut60", "sof10_cut60"]
CUT = {"sof9_cut60", "sof10_cut60"}
CMYK = {"sof9_cmyk"}


def test_fixtures_are_the_forms_named(fixtures):
    assert sorted(fixtures) == sorted(NAMES)
    for name, data in fixtures.items():
        m, i = _sof(data)
        assert m == (0xCA if name.startswith("sof10") else 0xC9), name
        nc = data[i + 9]
        assert nc == {"sof9_gray": 1, "sof10_gray": 1, "sof9_cmyk": 4}.get(name, 3), name
        assert (b"\xff\xdd" in data) == ("restart" in name), name
        assert (data[-2:] == b"\xff\xd9") == (name not in CUT), name
    for name in ("sof9_dac", "sof10_dac"):
        dac = fixtures[name].index(b"\xff\xcc")
        assert fixtures[name][dac + 5] != 0x10, name  # not the default L=0, U=1


@pytest.mark.parametrize("name", [n for n in NAMES if n not in CMYK])
def test_read_and_pixels_equal_libjpeg(fixtures, name):
    """The int16 coefficients equal libjpeg's jpeg_read_coefficients (cut
    streams: libjpeg decodes on from zero bytes past the end), and the
    pixels at every scale, RGB and grey, fancy upsampling on and off."""
    data = fixtures[name]
    if ref_native.jpeg_coef_info(data) is not None:
        _assert_read_equal(data, ks=[(8, 8), (2, 2)])
    _assert_decode_equal(data)


@pytest.mark.parametrize("name", NAMES)
def test_image_decode_equals_dali_tpu(fixtures, name):
    _assert_decodes_equal(fixtures[name], output_types=["RGB", "GRAY"], denoms=(1, 2, 8),
                          dtypes=[None, "FLOAT"])


@pytest.mark.parametrize("name", [n for n in NAMES if n not in CUT])
def test_image_decode_equals_cv2(fixtures, name):
    """cv2 5.0 (libjpeg-turbo 3.1.2) reads the whole streams alike. It fails
    on a stream that ends before EOI, so the cut ones are held to dali_tpu
    above."""
    data = fixtures[name]
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    got = port_native.decode_jpeg(data)
    np.testing.assert_array_equal(got, want[:, :, ::-1])


@pytest.fixture(scope="module")
def fixture_roots(fixtures, tmp_path_factory):
    """Directories of fixtures for the pipelines: every form together, and
    one per sampling the hybrid wires carry (a wire batch has one)."""
    groups = {"all": NAMES,
              "420": ["sof9_420", "sof10_sa", "sof10_restart", "sof9_dac", "sof9_cut60",
                      "sof10_cut60"],
              "422": ["sof9_422", "sof9_restart"],
              "444": ["sof9_444", "sof10_dac"],
              "gray": ["sof9_gray"]}
    roots = {}
    for g, names in groups.items():
        root = tmp_path_factory.mktemp(f"arith_{g}")
        (root / "c").mkdir()
        for n in names:
            (root / "c" / f"{n}.jpg").write_bytes(fixtures[n])
        roots[g] = (str(root), len(names))
    return roots


@pytest.mark.parametrize("device", ["cpu", "mixed"])
def test_decoder_placements_equal_dali_tpu(fixture_roots, device):
    root, n = fixture_roots["all"]

    def graph(pkg, j):
        return (pkg.fn.decoders.image(j, device=device),
                pkg.fn.decoders.image(j, device=device, output_type=pkg.types.GRAY,
                                      jpeg_fancy_upsampling=False),
                pkg.fn.decoders.image_random_crop(j, device=device, seed=7),
                pkg.fn.decoders.image_crop(j, device=device, crop=(40, 50), crop_pos_x=0.3),
                pkg.fn.decoders.image_slice(j, device=device),
                pkg.fn.peek_image_shape(j))

    _run_pair(graph, iters=1, batch=n, root=root)


@pytest.mark.parametrize("group", ["420", "422", "444", "gray"])
@pytest.mark.parametrize("hybrid", ["int16", "int8", "int8_rrc", "int16_scale2", "int8_scale1"])
def test_hybrid_wires_equal_dali_tpu(fixture_roots, group, hybrid):
    """Both hybrid wires at scales 1 and 2 read the arithmetic streams
    through the full read, as the reference's libjpeg fallback does (the
    int8 wire takes no progressive grayscale in either package)."""
    graphs = dict(_HYBRID)
    graphs["int16_scale2"] = lambda pkg, j: pkg.fn.decoders.image(
        j, device="mixed", hybrid_device_decode=True, hybrid_scale=2)
    graphs["int8_scale1"] = lambda pkg, j: pkg.fn.decoders.image(
        j, device="mixed", hybrid_device_decode=True, hybrid_scale=1, hybrid_wire="int8")
    root, n = fixture_roots[group]
    _run_pair(graphs[hybrid], iters=1, batch=n, root=root)


# -- the frames still declined ----------------------------------------------------------------
@pytest.mark.parametrize("marker", [0xCB, 0xCD, 0xCE, 0xCF])
def test_lossless_and_hierarchical_arithmetic_frames_raise_in_both(fixtures, marker):
    """SOF11 (lossless arithmetic) and SOF13-15 (hierarchical), patched into
    an SOF9 stream's frame: libjpeg refuses them, and the port raises (item
    1b for the lossless forms, as for SOF3)."""
    data = fixtures["sof9_420"]
    _, i = _sof(data)
    bad = data[:i + 1] + bytes([marker]) + data[i + 2:]
    assert ref_native.decode_jpeg(bad) is None
    with pytest.raises(NotImplementedError, match="item 1b"):
        port_native.decode_jpeg(bad)
    for codec in (ref_codec, port_codec):
        with pytest.raises((ValueError, NotImplementedError)):
            codec.decode(bad)


# -- the twin corpus through rn50_train's recipe -----------------------------------------------
def _rn50(pkg, root, batch=8, **kw):
    fn, types = pkg.fn, pkg.types

    @pkg.pipeline_def(batch_size=batch, num_threads=2, seed=42, **kw)
    def rn50_train():
        jpegs, labels = fn.readers.file(file_root=root, random_shuffle=True, name="Reader",
                                        seed=1234)
        crops = fn.decoders.image_random_crop(jpegs, device="mixed", hybrid_device_decode=True,
                                              hybrid_scale=2, seed=77)
        images = fn.resize(crops, resize_x=64, resize_y=64)
        mirror = fn.random.coin_flip(probability=0.5, seed=5)
        images = fn.crop_mirror_normalize(images, mirror=mirror, dtype=types.FLOAT,
                                          output_layout="CHW", mean=[123.675, 116.28, 103.53],
                                          std=[58.395, 57.12, 57.375])
        return crops, images, labels

    pipe = rn50_train()
    pipe.build()
    return pipe


def test_twin_corpus_is_the_rn50_corpus_recoded():
    names = sorted(os.path.relpath(os.path.join(r, f), HUFFMAN)
                   for r, _, fs in os.walk(HUFFMAN) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(r, f), ARITH)
                           for r, _, fs in os.walk(ARITH) for f in fs)
    assert len(names) == 32
    for i, rel in enumerate(names):
        data = open(os.path.join(ARITH, rel), "rb").read()
        assert _sof(data)[0] == (0xCA if i % 2 else 0xC9), rel
    # the same coefficients as the Huffman file
    data = open(os.path.join(ARITH, names[1]), "rb").read()
    want = open(os.path.join(HUFFMAN, names[1]), "rb").read()
    info = ref_native.jpeg_coef_info(want)
    _, _, ybh, ybw, cbh, cbw, _ = info
    for g, w in zip(port_native.jpeg_read_coeffs(data, 8, 8, ybh, ybw, cbh, cbw),
                    ref_native.jpeg_read_coeffs(want, 8, 8, ybh, ybw, cbh, cbw)):
        np.testing.assert_array_equal(g, w)


def test_twin_corpus_gives_the_huffman_corpus_bits_in_rn50_train():
    """The port's rn50_train over the arithmetic twins: its uint8 crops and
    FLOAT CHW batches equal its batches over the Huffman originals, bit for
    bit, with the same seeds and file order."""
    arith = _rn50(dali_tpu_torch, ARITH, device="cpu")
    huff = _rn50(dali_tpu_torch, HUFFMAN, device="cpu")
    try:
        for _ in range(2):
            a, h = arith.run(), huff.run()
            for x, y in zip(a, h):
                for u, v in zip(_host(x), _host(y)):
                    np.testing.assert_array_equal(u, v)
    finally:
        arith.shutdown()
        huff.shutdown()


def test_twin_corpus_rn50_train_crops_equal_dali_tpu():
    """The same recipe's decoded crops over the twins in dali_tpu (its
    libjpeg fallback) and the port: bit-equal."""
    ref = _rn50(dali_tpu, ARITH, debug=True)
    port = _rn50(dali_tpu_torch, ARITH, device="cpu")
    try:
        want, got = ref.run(), port.run()
        for u, v in zip(_host(got[0]), _host(want[0])):
            np.testing.assert_array_equal(u, v)
        np.testing.assert_array_equal(np.asarray(got[2].as_array()),
                                      np.asarray(want[2].as_array()))
    finally:
        _close(ref, port)

