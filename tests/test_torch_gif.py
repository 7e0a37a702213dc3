"""GIF in dali_tpu_torch (ROADMAP.md Queue 1 item 1c): the native decoder
(``csrc/host/gif_decode.cc``) against dali_tpu, which decodes GIF through
``cv2.imdecode`` (OpenCV 5.0 on this machine).

Contract: bit-equal, for every output type and dtype, through
``imgcodec.decode`` and through ``decoders.image`` and its
``image_random_crop``, ``image_crop`` and ``image_slice`` forms on the cpu
and mixed placements. The inputs: the committed fixtures
(``testdata/codecs/*.gif``, made by ``make_codec_corpus.py``) and GIFs
written here by ``make_codec_corpus.gif_bytes``, which reach each LZW code
size, interlacing, transparency, background colours and offset images.
GIF is lossless, so each decode is also held against the palette lookup of
the indices written.
"""

import os
import shutil
import sys

import cv2
import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch
from dali_tpu import imgcodec as ref_codec
from dali_tpu_torch import imgcodec as port_codec
from dali_tpu_torch import native as port_native

from .test_torch_image_decoders import _assert_same, _close

HERE = os.path.dirname(__file__)
TESTDATA = os.path.join(HERE, "..", "dali_tpu_torch", "testdata")
CODECS = os.path.join(TESTDATA, "codecs")
CORPUS = os.path.join(TESTDATA, "rn50")
sys.path.insert(0, TESTDATA)
from make_codec_corpus import gif_bytes  # noqa: E402

GIFS = sorted(f for f in os.listdir(CODECS) if f.endswith(".gif"))
OUTPUT_TYPES = ["RGB", "BGR", "GRAY", "YCbCr", "ANY_DATA"]
DTYPES = [None, "UINT16", "FLOAT"]
RNG = np.random.default_rng(71)
PALETTE = RNG.integers(0, 256, (256, 3), np.uint8)


def _decode_both(data, output_type, dtype=None):
    out = []
    for codec, pkg in ((ref_codec, dali_tpu), (port_codec, dali_tpu_torch)):
        out.append(codec.decode(data, getattr(pkg.types.DALIImageType, output_type), 1, True,
                                True, getattr(pkg.types.DALIDataType, dtype) if dtype else None))
    return out


def _assert_equal(data, output_types=OUTPUT_TYPES, dtypes=DTYPES):
    for ot in output_types:
        for dt in dtypes:
            want, got = _decode_both(data, ot, dt)
            assert got.shape == want.shape and got.dtype == want.dtype, (ot, dt)
            np.testing.assert_array_equal(got, want, err_msg=str((ot, dt)))


def _smooth_index(h, w, colors, seed):
    """Palette indices with runs, as a quantized photo has."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, colors, (-(-h // 3), -(-w // 3)), np.uint8)
    return np.repeat(np.repeat(small, 3, 0), 3, 1)[:h, :w]


# -- the committed fixtures -----------------------------------------------------------------------


def test_fixtures_are_present():
    assert GIFS == ["gif87a_palette.gif", "gif89a_transparent.gif", "gif_animated.gif",
                    "gif_interlaced.gif", "gif_local_offset.gif"]


@pytest.mark.parametrize("name", GIFS)
def test_fixture_decodes_as_dali_tpu(name):
    data = open(os.path.join(CODECS, name), "rb").read()
    _assert_equal(data)
    h, w, c = port_codec.peek_shape(data)
    assert (h, w, c) == ref_codec.peek_shape(data)
    assert port_native.decode_gif(data).shape == (h, w, 3)


def test_fixtures_hold_the_forms_they_name():
    """Header bits of each fixture: the version, interlacing, a transparent
    index in use, a local table on an offset image, a second frame."""
    read = {n: open(os.path.join(CODECS, n), "rb").read() for n in GIFS}
    assert read["gif87a_palette.gif"][:6] == b"GIF87a"
    assert read["gif89a_transparent.gif"][:6] == b"GIF89a"
    assert b"\x21\xf9\x04\x01" in read["gif89a_transparent.gif"]
    desc = read["gif_interlaced.gif"].index(b"\x2c", 13 + 3 * 16)
    assert read["gif_interlaced.gif"][desc + 9] & 0x40
    off = read["gif_local_offset.gif"]
    desc = off.index(b"\x2c", 13 + 6)
    assert off[desc + 1:desc + 5] == bytes([90, 0, 70, 0]) and off[desc + 9] & 0x80
    assert read["gif_animated.gif"].count(b"\x21\xf9\x04") >= 2


# -- forms written here ------------------------------------------------------------------------


@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("interlace", [False, True])
def test_code_sizes_and_interlacing(bits, interlace):
    """Minimum code sizes 2-8 (1- and 2-bit palettes both take 2), against
    the palette lookup and dali_tpu."""
    idx = _smooth_index(61, 83, 1 << bits, bits)
    data = gif_bytes([{"index": idx, "interlace": interlace}], 83, 61, PALETTE[:1 << bits])
    np.testing.assert_array_equal(port_native.decode_gif(data), PALETTE[idx])
    _assert_equal(data)


def test_full_table_and_clear_codes():
    """A large noisy 256-colour image fills the 4096-entry table many times
    (a clear code after each)."""
    idx = RNG.integers(0, 256, (300, 400), np.uint8)
    data = gif_bytes([{"index": idx}], 400, 300, PALETTE)
    np.testing.assert_array_equal(port_native.decode_gif(data), PALETTE[idx])
    _assert_equal(data, ["RGB", "GRAY"], [None])


@pytest.mark.parametrize("background", [0, 9])
@pytest.mark.parametrize("global_table", [True, False])
@pytest.mark.parametrize("transparent", [None, 1])
def test_background_offset_and_transparency(background, global_table, transparent):
    """An image smaller than the screen and offset in it: the rest of the
    screen is the global table's background colour (black without one);
    transparent pixels keep the screen's colour."""
    idx = _smooth_index(40, 52, 4, 3)
    frame = {"index": idx, "palette": PALETTE[100:104], "left": 17, "top": 11}
    if transparent is not None:
        frame["transparent"] = transparent
    data = gif_bytes([frame], 90, 70, PALETTE[:16] if global_table else None,
                     background=background)
    want = np.zeros((70, 90, 3), np.uint8)
    if global_table:
        want[:] = PALETTE[background]
    sub = PALETTE[100:104][idx]
    keep = idx == transparent
    sub[keep] = want[11:51, 17:69][keep]
    want[11:51, 17:69] = sub
    np.testing.assert_array_equal(port_native.decode_gif(data), want)
    _assert_equal(data)


def test_first_frame_of_an_animation():
    first = _smooth_index(50, 60, 16, 5)
    frames = [{"index": first, "delay": 10, "disposal": 1},
              {"index": first[::-1], "left": 0, "top": 0, "delay": 10}]
    data = gif_bytes(frames, 60, 50, PALETTE[:16], loop=0, comment=b"two frames")
    np.testing.assert_array_equal(port_native.decode_gif(data), PALETTE[first])
    _assert_equal(data)


def test_gif87a_and_pil_writes():
    from PIL import Image
    import io

    idx = _smooth_index(64, 48, 32, 7)
    data = gif_bytes([{"index": idx}], 48, 64, PALETTE[:32], version=b"GIF87a")
    _assert_equal(data)
    buf = io.BytesIO()
    im = Image.fromarray(idx, "P")
    im.putpalette(PALETTE[:32].reshape(-1).tolist())
    im.save(buf, "GIF", transparency=3)
    _assert_equal(buf.getvalue())


def test_against_cv2_directly():
    """cv2.imdecode itself, colour and grey (cvtColor's 15-bit weights)."""
    for name in GIFS:
        data = open(os.path.join(CODECS, name), "rb").read()
        buf = np.frombuffer(data, np.uint8)
        np.testing.assert_array_equal(port_native.decode_gif(data),
                                      cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1])
        np.testing.assert_array_equal(port_native.decode_gif(data, gray=True)[..., 0],
                                      cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE))


def test_malformed_streams_raise_value_error():
    data = open(os.path.join(CODECS, "gif_interlaced.gif"), "rb").read()
    rng = np.random.default_rng(3)
    for cut in (6, 13, 40, len(data) // 2, len(data) - 3):
        with pytest.raises(ValueError):
            port_codec.decode(data[:cut])
    for _ in range(200):  # byte flips: a decoded image or ValueError, nothing else
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 6))):
            b[int(rng.integers(6, len(b)))] ^= int(rng.integers(1, 256))
        try:
            port_codec.decode(bytes(b))
        except ValueError:
            pass


# -- pipelines, cpu and mixed -------------------------------------------------------------------


@pytest.fixture(scope="module")
def gif_root(tmp_path_factory):
    """The GIF fixtures and three corpus JPEGs in one class folder (the
    readers' default ``file_filters`` leave GIF out, as DALI's do: the
    pipelines name ``*.gif``)."""
    root = tmp_path_factory.mktemp("gifs")
    d = root / "c"
    d.mkdir()
    for name in GIFS:
        shutil.copy(os.path.join(CODECS, name), d / name)
    jpgs = sorted(os.path.join(r, f) for r, _, fs in os.walk(CORPUS) for f in fs
                  if f.endswith(".jpg"))[:3]
    for i, f in enumerate(jpgs):
        shutil.copy(f, d / f"base_{i}.jpg")
    return str(root)


def _run_pair(graph, root, iters=2, batch=4):
    """The same graph over ``root``'s GIFs and JPEGs in dali_tpu (debug) and
    in the port (CPU), outputs bit-equal; every GIF is read."""
    pipes = []
    for pkg, extra in ((dali_tpu, {"debug": True}), (dali_tpu_torch, {"device": "cpu"})):
        @pkg.pipeline_def(batch_size=batch, num_threads=2, seed=42, **extra)
        def p():
            data, labels = pkg.fn.readers.file(file_root=root, file_filters=["*.gif", "*.jpg"],
                                               random_shuffle=True, name="Reader", seed=1234)
            outs = graph(pkg, data)
            return (*outs, labels) if isinstance(outs, tuple) else (outs, labels)

        pipe = p()
        pipe.build()
        pipes.append(pipe)
    try:
        assert len(GIFS) + 3 <= iters * batch
        _assert_same(*pipes, iters)
    finally:
        _close(*pipes)


@pytest.mark.parametrize("device", ["cpu", "mixed"])
@pytest.mark.parametrize("output_type", ["RGB", "GRAY"])
def test_decoders_image(gif_root, device, output_type):
    _run_pair(lambda pkg, j: pkg.fn.decoders.image(
        j, device=device, output_type=getattr(pkg.types.DALIImageType, output_type)), gif_root)


@pytest.mark.parametrize("device", ["cpu", "mixed"])
def test_decoders_crop_forms(gif_root, device):
    _run_pair(lambda pkg, j: (
        pkg.fn.decoders.image_random_crop(j, device=device, seed=5),
        pkg.fn.decoders.image_crop(j, device=device, crop=(96, 128), crop_pos_x=0.2,
                                   crop_pos_y=0.7),
        pkg.fn.decoders.image_slice(j, pkg.types.Constant(np.float32([0.1, 0.25])),
                                    pkg.types.Constant(np.float32([0.5, 0.6])),
                                    device=device)), gif_root)


def test_readers_list_every_gif(gif_root):
    """The pipelines above read the five GIFs: the reader's index holds them."""
    fn = dali_tpu_torch.fn

    @dali_tpu_torch.pipeline_def(batch_size=8, num_threads=1, device="cpu")
    def p():
        data, _ = fn.readers.file(file_root=gif_root, file_filters=["*.gif", "*.jpg"])
        return fn.peek_image_shape(data)

    pipe = p()
    pipe.build()
    try:
        shapes = pipe.run()[0]
        got = sorted(tuple(int(v) for v in np.asarray(shapes.at(i))) for i in range(8))
    finally:
        pipe.shutdown()
    want = sorted(port_codec.peek_shape(open(os.path.join(gif_root, "c", f), "rb").read())
                  for f in sorted(os.listdir(os.path.join(gif_root, "c"))))
    assert got == want
