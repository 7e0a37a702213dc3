"""WebP in dali_tpu_torch (ROADMAP.md Queue 1 item 1e): the native decoder
(``csrc/host/webp_vp8.cc`` lossy, ``webp_vp8l.cc`` lossless,
``webp_decode.cc`` the container and libwebp's colour conversion) against
dali_tpu, which decodes WebP through ``cv2.imdecode`` (OpenCV 5.0 on this
machine: libwebp's ``WebPDecodeBGR``).

Contract: bit-equal, for every output type and dtype, through
``imgcodec.decode`` and through ``decoders.image`` and its crop forms on
the cpu and mixed placements, and a batch decoded in one native call on the
task pool equal to its samples decoded one at a time. The inputs: cv2's
encoder at qualities 5, 50, 85 and 100 and lossless; libwebp's advanced
encoder (``libwebp.so.7`` through ctypes, where it is installed; ``WebPConfig`` of
``webp/encode.h``) for filter types, token partitions, segments, sharpness,
sharp YUV, near-lossless, exact and alpha; PIL's animated and ``exif=``
files; the committed fixtures. Truncated and corrupt streams raise the same
exception class in both packages.
"""

import ctypes
import io
import os
import shutil

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

HERE = os.path.dirname(__file__)
TESTDATA = os.path.join(HERE, "..", "dali_tpu_torch", "testdata")
CODECS = os.path.join(TESTDATA, "codecs")
CORPUS = os.path.join(TESTDATA, "rn50")
WEBP_CORPUS = os.path.join(TESTDATA, "webp")
FIXTURES = sorted(f for f in os.listdir(CODECS) if f.endswith(".webp"))
OUTPUT_TYPES = ["RGB", "BGR", "GRAY", "YCbCr", "ANY_DATA"]
DTYPES = [None, "UINT16", "FLOAT"]
SIZES = [(1, 1), (17, 9), (9, 17), (31, 47), (75, 100)]


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


def _corpus_rgb(i, h=None, w=None):
    files = sorted(os.path.join(r, f) for r, _, fs in os.walk(CORPUS) for f in fs)
    img = cv2.imread(files[i])[:, :, ::-1]
    return np.ascontiguousarray(img if h is None else cv2.resize(img, (w, h)))


def _smooth(h, w, seed, channels=3):
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, ((h + 3) // 4, (w + 3) // 4, channels), np.uint8)
    return np.ascontiguousarray(cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)
                                .reshape(h, w, channels))


def _cv2_webp(rgb, quality):
    return cv2.imencode(".webp", rgb[:, :, ::-1], [cv2.IMWRITE_WEBP_QUALITY, quality])[1].tobytes()


# -- libwebp's advanced encoder, through ctypes ---------------------------------------------------
class _Config(ctypes.Structure):
    _fields_ = [(n, ctypes.c_float if n in ("quality", "target_PSNR") else ctypes.c_int) for n in (
        "lossless", "quality", "method", "image_hint", "target_size", "target_PSNR", "segments",
        "sns_strength", "filter_strength", "filter_sharpness", "filter_type", "autofilter",
        "alpha_compression", "alpha_filtering", "alpha_quality", "pass", "show_compressed",
        "preprocessing", "partitions", "partition_limit", "emulate_jpeg_size", "thread_level",
        "low_memory", "near_lossless", "exact", "use_delta_palette", "use_sharp_yuv", "qmin",
        "qmax")]


class _Picture(ctypes.Structure):
    vp, ci, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    _fields_ = [("use_argb", ci), ("colorspace", ci), ("width", ci), ("height", ci), ("y", vp),
                ("u", vp), ("v", vp), ("y_stride", ci), ("uv_stride", ci), ("a", vp),
                ("a_stride", ci), ("pad1", u32 * 2), ("argb", vp), ("argb_stride", ci),
                ("pad2", u32 * 3), ("writer", vp), ("custom_ptr", vp), ("extra_info_type", ci),
                ("extra_info", vp), ("stats", vp), ("error_code", ci), ("progress_hook", vp),
                ("user_data", vp), ("pad3", u32 * 3), ("pad4", vp), ("pad5", vp), ("pad6", u32 * 8),
                ("memory_", vp), ("memory_argb_", vp), ("pad7", vp * 2)]


class _MemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32 * 1)]


_ABI = 0x020F


def _libwebp():
    try:
        return ctypes.CDLL("libwebp.so.7")
    except OSError:
        pytest.skip("libwebp.so.7, the encoder these tests drive, is not installed")


def _libwebp_encode(px, quality=75.0, **options):
    """``px`` (RGB or RGBA uint8) through WebPEncode with ``options`` set on
    the WebPConfig (names of ``webp/encode.h``)."""
    lib = _libwebp()
    cfg = _Config()
    assert lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, ctypes.c_float(quality), _ABI)
    for k, v in options.items():
        setattr(cfg, k, v)
    assert lib.WebPValidateConfig(ctypes.byref(cfg)), options
    pic = _Picture()
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), _ABI)
    h, w, c = px.shape
    pic.width, pic.height = w, h
    pic.use_argb = 1 if options.get("lossless") else 0
    px = np.ascontiguousarray(px)
    imp = lib.WebPPictureImportRGBA if c == 4 else lib.WebPPictureImportRGB
    assert imp(ctypes.byref(pic), px.ctypes.data_as(ctypes.c_void_p), w * c)
    wr = _MemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(wr))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
    pic.custom_ptr = ctypes.cast(ctypes.byref(wr), ctypes.c_void_p).value
    try:
        assert lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic)), pic.error_code
        return ctypes.string_at(wr.mem, wr.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(wr))


# -- the committed fixtures and cv2's encoder -----------------------------------------------------
def test_fixtures_are_present():
    assert FIXTURES == ["webp_alpha.webp", "webp_lossless.webp", "webp_lossy.webp"]
    corpus = sorted(f for _, _, fs in os.walk(WEBP_CORPUS) for f in fs)
    assert len(corpus) == 32 and all(f.endswith(".webp") for f in corpus)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_decodes_as_dali_tpu(name):
    data = open(os.path.join(CODECS, name), "rb").read()
    _assert_equal(data)


def test_fixtures_hold_the_forms_they_name():
    read = {n: open(os.path.join(CODECS, n), "rb").read() for n in FIXTURES}
    assert read["webp_lossy.webp"][12:16] == b"VP8 "
    assert read["webp_lossless.webp"][12:16] == b"VP8L"
    assert read["webp_alpha.webp"][12:16] == b"VP8X" and b"ALPH" in read["webp_alpha.webp"]


def test_corpus_decodes_as_dali_tpu():
    for r, _, fs in os.walk(WEBP_CORPUS):
        for f in sorted(fs):
            _assert_equal(open(os.path.join(r, f), "rb").read(), ["RGB", "GRAY"], [None])


@pytest.mark.parametrize("quality", [5, 50, 85, 100, 101])
def test_cv2_qualities(quality):
    """Lossy at four qualities and lossless (101), a corpus image and odd,
    tiny and non-multiple-of-16 sizes."""
    _assert_equal(_cv2_webp(_corpus_rgb(quality % 32), quality))
    for k, (h, w) in enumerate(SIZES):
        _assert_equal(_cv2_webp(_smooth(h, w, k), quality), ["RGB", "GRAY"], [None])


def test_against_cv2_directly():
    for q in (20, 90, 101):
        data = _cv2_webp(_corpus_rgb(3), q)
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[:, :, ::-1]
        np.testing.assert_array_equal(port_codec.decode(data), want)


# -- libwebp's options ----------------------------------------------------------------------------
LIBWEBP_OPTIONS = [
    {"filter_type": 0, "filter_strength": 60},          # simple loop filter
    {"filter_type": 1, "filter_strength": 60},          # normal loop filter
    {"filter_strength": 0},                             # no loop filter
    {"filter_type": 1, "filter_strength": 80, "filter_sharpness": 3},
    {"filter_type": 1, "filter_strength": 100, "filter_sharpness": 7},
    {"filter_type": 0, "filter_strength": 100, "filter_sharpness": 6},
    {"partitions": 0}, {"partitions": 1}, {"partitions": 2}, {"partitions": 3},
    {"segments": 1}, {"segments": 2}, {"segments": 3}, {"segments": 4, "sns_strength": 100},
    {"autofilter": 1}, {"use_sharp_yuv": 1}, {"method": 0}, {"method": 6},
    {"lossless": 1, "method": 0}, {"lossless": 1, "method": 6},
    {"lossless": 1, "near_lossless": 40}, {"lossless": 1, "near_lossless": 80},
]


@pytest.mark.parametrize("options", LIBWEBP_OPTIONS, ids=lambda o: "-".join(f"{k}{v}" for k, v in o.items()))
def test_libwebp_options(options):
    _libwebp()
    q = 40.0 if not options.get("lossless") else 60.0
    _assert_equal(_libwebp_encode(_corpus_rgb(7, 240, 320), q, **options))
    for k, (h, w) in enumerate(SIZES[1:]):
        _assert_equal(_libwebp_encode(_smooth(h, w, 10 + k), q, **options), ["RGB", "GRAY"],
                      [None])


@pytest.mark.parametrize("lossless", [0, 1])
@pytest.mark.parametrize("exact", [0, 1])
def test_libwebp_alpha(lossless, exact):
    """RGBA input: lossy gives VP8X with an ALPH chunk, lossless a VP8L with
    alpha; colour under alpha 0 kept or not (``exact``). The colour output
    drops alpha, unblended."""
    _libwebp()
    rgb = _corpus_rgb(9, 150, 200)
    alpha = np.zeros((150, 200, 1), np.uint8)
    alpha[:, 60:] = np.linspace(0, 255, 140, dtype=np.uint8)[None, :, None]
    data = _libwebp_encode(np.concatenate([rgb, alpha], 2), 70.0, lossless=lossless,
                           exact=exact, alpha_quality=90)
    assert data[12:16] == (b"VP8L" if lossless else b"VP8X")
    _assert_equal(data)


def _libwebp_alpha(data):
    """The alpha channel [h, w] of libwebp's own WebPDecodeRGBA."""
    lib = _libwebp()
    lib.WebPDecodeRGBA.restype = ctypes.c_void_p
    w, h = ctypes.c_int(), ctypes.c_int()
    p = lib.WebPDecodeRGBA(data, len(data), ctypes.byref(w), ctypes.byref(h))
    assert p
    try:
        rgba = np.frombuffer(ctypes.string_at(p, 4 * w.value * h.value), np.uint8)
    finally:
        lib.WebPFree(ctypes.c_void_p(p))
    return rgba.reshape(h.value, w.value, 4)[:, :, 3]


def _alpha_webps():
    """Lossy RGBA WebPs with every ALPH form libwebp writes: raw or lossless
    (a palette of few levels, or many), each filter, and the fixture."""
    rgb = _corpus_rgb(21, 70, 90)
    yy, xx = np.mgrid[0:70, 0:90]
    planes = {"ramp": (xx * 255 // 89).astype(np.uint8),
              "levels": ((yy // 18) * 80 % 256).astype(np.uint8),
              "noise": np.random.default_rng(21).integers(0, 256, (70, 90), np.uint8)}
    out = {"fixture": open(os.path.join(CODECS, "webp_alpha.webp"), "rb").read()}
    for pname, a in planes.items():
        for comp in (0, 1):
            for filt in (0, 1, 2):
                out[f"{pname}_c{comp}_f{filt}"] = _libwebp_encode(
                    np.dstack([rgb, a]), 75.0, alpha_compression=comp, alpha_filtering=filt,
                    alpha_quality=100, method=4 + comp)
    return out


def test_alpha_chunk_decodes_as_libwebp():
    """``webp_decode.cc``'s ALPH decode gives libwebp's alpha plane for raw
    and lossless payloads under each of the four filters (the header's
    filter bits rewritten: the payload stays valid, only its unfiltering
    changes), and the colour output stays dali_tpu's."""
    for name, data in _alpha_webps().items():
        i = data.index(b"ALPH") + 8
        for filt in range(4):
            b = bytearray(data)
            b[i] = (b[i] & ~0x0c) | filt << 2
            b = bytes(b)
            np.testing.assert_array_equal(port_native.webp_alpha(b), _libwebp_alpha(b),
                                          err_msg=f"{name} filter {filt}")
        _assert_equal(data, ["RGB"], [None])
    assert port_native.webp_alpha(_cv2_webp(_corpus_rgb(3, 20, 30), 80)) == 1


def test_corrupt_alpha_chunks():
    """Bit flips across the ALPH header and payload, a payload cut short
    inside a well-formed container, every header byte's compression, filter,
    pre-processing and reserved values: libwebp fails the frame where
    the chunk fails (cv2, and so dali_tpu, raise), and the port with it."""
    rng = np.random.default_rng(31)
    for name, data in _alpha_webps().items():
        i = data.index(b"ALPH")
        size = int.from_bytes(data[i + 4:i + 8], "little")
        flips = 40 if name == "fixture" else 8
        for _ in range(flips):
            b = bytearray(data)
            b[i + 8 + int(rng.integers(0, size))] ^= 1 << int(rng.integers(0, 8))
            _same_outcome(bytes(b))
        # the chunk's size and the RIFF size shrunk together: the payload ends early
        for cut in (1, 2, size // 2, size - 1):
            short = size - cut
            body = data[i + 8:i + 8 + short]
            b = data[:i + 4] + short.to_bytes(4, "little") + body + bytes(short & 1) \
                + data[i + 8 + size + (size & 1):]
            b = b[:4] + (len(b) - 8).to_bytes(4, "little") + b[8:]
            _same_outcome(b)
    data = _alpha_webps()["ramp_c1_f1"]
    i = data.index(b"ALPH") + 8
    outcomes = {}
    for v in range(256):
        b = bytearray(data)
        b[i] = v
        outcomes[v] = _same_outcome(bytes(b))
    # compression 2-3, pre-processing 2-3 and the reserved bits fail
    assert not any(outcomes[v] for v in range(256)
                   if (v & 3) > 1 or ((v >> 4) & 3) > 1 or v >> 6)
    assert outcomes[data[i]]


# -- PIL: animations, EXIF ------------------------------------------------------------------------
def _pil_webp(img, **kw):
    buf = io.BytesIO()
    img.save(buf, "WEBP", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("lossless", [False, True])
def test_first_frame_of_an_animation(lossless):
    """An opaque first frame over the whole canvas, as PIL writes one."""
    a, b = _corpus_rgb(11, 120, 160), _corpus_rgb(12, 120, 160)
    data = _pil_webp(Image.fromarray(a), save_all=True, append_images=[Image.fromarray(b)],
                     duration=100, loop=0, lossless=lossless, quality=80)
    assert b"ANIM" in data and b"ANMF" in data
    _assert_equal(data)


def test_animation_with_alpha_raises_not_implemented():
    """A first frame with alpha is blended onto the canvas by cv2's animation
    decoder: not read (ROADMAP item 1i)."""
    frames = [Image.fromarray(np.dstack([_corpus_rgb(i, 64, 80), np.full((64, 80), 128, np.uint8)]),
                              "RGBA") for i in (13, 14)]
    data = _pil_webp(frames[0], save_all=True, append_images=frames[1:], duration=50, quality=80)
    assert b"ANMF" in data and b"ALPH" in data
    assert ref_codec.decode(data).shape == (64, 80, 3)
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 1i"):
        port_codec.decode(data)


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("lossless", [False, True])
def test_exif_orientation(orientation, lossless):
    exif = Image.Exif()
    exif[0x0112] = orientation
    data = _pil_webp(Image.fromarray(_corpus_rgb(14, 45, 70)), exif=exif.tobytes(),
                     lossless=lossless, quality=80)
    assert b"EXIF" in data
    _assert_equal(data, ["RGB", "GRAY"], [None, "FLOAT"])
    assert port_codec.peek_shape(data) == ref_codec.peek_shape(data)


def test_peek_shape():
    for name in FIXTURES:
        data = open(os.path.join(CODECS, name), "rb").read()
        assert port_codec.peek_shape(data) == ref_codec.peek_shape(data)


# -- truncated and corrupt streams ----------------------------------------------------------------
def _same_outcome(data):
    """Both decode (bit-equal) or both raise the same exception class."""
    try:
        want = ref_codec.decode(data)
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        with pytest.raises(type(e)):
            port_codec.decode(data)
        return False
    np.testing.assert_array_equal(port_codec.decode(data), want)
    return True


@pytest.mark.parametrize("name", FIXTURES)
def test_truncated_streams(name):
    data = open(os.path.join(CODECS, name), "rb").read()
    for cut in (4, 12, 20, 31, 33, 40, len(data) // 3, len(data) // 2, len(data) - 9,
                len(data) - 1):
        assert not _same_outcome(data[:cut]), cut


@pytest.mark.parametrize("quality", [30, 101])
def test_corrupt_streams(quality):
    """Byte flips past the headers: each stream decodes alike or fails alike."""
    data = _cv2_webp(_corpus_rgb(15, 64, 96), quality)
    rng = np.random.default_rng(quality)
    for _ in range(150):
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(20, len(b)))] ^= int(rng.integers(1, 256))
        _same_outcome(bytes(b))


def test_container_errors_raise_value_error():
    data = _cv2_webp(_corpus_rgb(16, 32, 32), 80)
    bad_riff = data[:4] + (len(data) + 100).to_bytes(4, "little") + data[8:]
    bad_tag = data[:12] + b"VP9 " + data[16:]
    for d in (bad_riff, bad_tag, data[:8] + b"WEBQ" + data[12:]):
        _same_outcome(d)
        with pytest.raises(ValueError):
            port_codec.decode(d)


# -- batches and pipelines ------------------------------------------------------------------------
def _assert_batch_equals_one_at_a_time(datas, kind):
    """``datas`` decoded by one native call on a pool of four threads equal
    each decoded alone through ``imgcodec.decode`` (RGB and GRAY)."""
    for gray in (False, True):
        bufs, orients = zip(*[port_codec.prepare_native(d, kind, gray) for d in datas])
        rcs = port_native.decode_images_batch(port_native.shared_pool(4), datas,
                                              [kind] * len(datas), bufs, gray)
        assert rcs == [0] * len(datas)
        ot = dali_tpu_torch.types.DALIImageType.GRAY if gray else \
            dali_tpu_torch.types.DALIImageType.RGB
        for d, b, o in zip(datas, bufs, orients):
            np.testing.assert_array_equal(
                port_codec.cv2_route_output(b, o, ot, None), port_codec.decode(d, ot))


def test_batch_on_the_pool_equals_one_at_a_time():
    datas = [open(os.path.join(CODECS, n), "rb").read() for n in FIXTURES]
    datas += [_cv2_webp(_smooth(h, w, 30 + k), q) for k, (h, w) in enumerate(SIZES)
              for q in (40, 101)]
    _assert_batch_equals_one_at_a_time(datas, port_native.KIND_WEBP)


@pytest.fixture(scope="module")
def webp_root(tmp_path_factory):
    """The WebP fixtures, six corpus WebPs and three corpus JPEGs in one
    class folder."""
    root = tmp_path_factory.mktemp("webps")
    d = root / "c"
    d.mkdir()
    for name in FIXTURES:
        shutil.copy(os.path.join(CODECS, name), d / name)
    webps = sorted(os.path.join(r, f) for r, _, fs in os.walk(WEBP_CORPUS) for f in fs)[:6]
    for i, f in enumerate(webps):
        shutil.copy(f, d / f"corpus_{i}.webp")
    jpgs = sorted(os.path.join(r, f) for r, _, fs in os.walk(CORPUS) for f in fs)[:3]
    for i, f in enumerate(jpgs):
        shutil.copy(f, d / f"base_{i}.jpg")
    return str(root)


def _run_pair(graph, root, iters=3, batch=4):
    """The same graph over ``root`` in dali_tpu (debug) and in the port
    (CPU), outputs bit-equal; every file is read."""
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
        assert len(FIXTURES) + 9 <= iters * batch
        _assert_same(*pipes, iters)
    finally:
        _close(*pipes)


@pytest.mark.parametrize("device", ["cpu", "mixed"])
@pytest.mark.parametrize("output_type", OUTPUT_TYPES)
def test_decoders_image(webp_root, device, output_type):
    for dtype in ("UINT8", "FLOAT"):
        _run_pair(lambda pkg, j: pkg.fn.decoders.image(
            j, device=device, output_type=getattr(pkg.types.DALIImageType, output_type),
            dtype=getattr(pkg.types, dtype)), webp_root)


@pytest.mark.parametrize("device", ["cpu", "mixed"])
def test_decoders_crop_forms(webp_root, device):
    _run_pair(lambda pkg, j: (
        pkg.fn.decoders.image_random_crop(j, device=device, seed=5),
        pkg.fn.decoders.image_crop(j, device=device, crop=(96, 128), crop_pos_x=0.2,
                                   crop_pos_y=0.7),
        pkg.fn.decoders.image_slice(j, pkg.types.Constant(np.float32([0.1, 0.25])),
                                    pkg.types.Constant(np.float32([0.5, 0.6])),
                                    device=device)), webp_root)


def test_readers_list_every_webp(webp_root):
    """readers.file's default filters take ``*.webp``; peek_image_shape reads
    each header."""
    fn = dali_tpu_torch.fn

    @dali_tpu_torch.pipeline_def(batch_size=12, num_threads=1, device="cpu")
    def p():
        data, _ = fn.readers.file(file_root=webp_root)
        return fn.peek_image_shape(data)

    pipe = p()
    pipe.build()
    try:
        shapes = pipe.run()[0]
        got = sorted(tuple(int(v) for v in np.asarray(shapes.at(i))) for i in range(12))
    finally:
        pipe.shutdown()
    files = sorted(os.listdir(os.path.join(webp_root, "c")))
    assert len(files) == 12
    want = sorted(port_codec.peek_shape(open(os.path.join(webp_root, "c", f), "rb").read())
                  for f in files)
    assert got == want
