"""The host operators of dali_tpu_torch whose reference calls cv2, held both
against dali_tpu's cpu placement and against cv2 5.0 directly:
JpegCompressionDistortion (``cv2.imencode``/``imdecode``), experimental.Remap
and experimental.WarpPerspective (``cv2.remap``, ``cv2.warpPerspective``),
the edge-aware experimental.Debayer (cv2's ``_EA`` Bayer codes), and
MedianBlur, Dilate and Erode on types other than uint8 (``cv2.medianBlur``,
``cv2.dilate``, ``cv2.erode``).

Everything is bit-equal. The JPEG's quantised coefficients are equal to
those of cv2's stream, read back with the port's coefficient reader
(``native.jpeg_read_coeffs``), at qualities 1, 8, 50, 95 and 100 and sizes
that are not multiples of 16. cv2 5.0's warps take one of two routes by type
and channel count (a float route for uint8, uint16 and float32 images of 1,
3 or 4 channels, fixed point otherwise; ``csrc/host/warp_affine.cc``); the
cases cover both, nearest and linear, constant and replicate borders.
"""

import cv2
import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch
from dali_tpu_torch import native

N = 4
RNG = np.random.default_rng(909)
QUALITIES = [1, 8, 50, 95, 100]
SIZES = [(1, 1), (7, 13), (16, 16), (17, 33), (40, 23), (64, 48)]


def _run(build, data, layout, args=(), iters=1):
    """(port, reference) outputs of the same host graph, each a list per
    iteration of outputs as lists of arrays."""
    res = []
    for pkg, kw in ((dali_tpu_torch, {"device": "cpu"}), (dali_tpu, {"debug": True})):
        @pkg.pipeline_def(batch_size=len(data), num_threads=2, seed=7, **kw)
        def p():
            x = pkg.fn.external_source(source=lambda: data, batch=True, layout=layout)
            a = [pkg.fn.external_source(source=lambda v=v: v, batch=True) for v in args]
            outs = build(pkg.fn, pkg.types, x, *a)
            return outs if isinstance(outs, tuple) else (outs,)

        pipe = p()
        pipe.build()
        try:
            res.append([[[np.asarray(tl.at(i)) for i in range(len(tl))] for tl in pipe.run()]
                        for _ in range(iters)])
        finally:
            (pipe.shutdown if pkg is dali_tpu_torch else pipe._executor.shutdown)()
    return res


def _same(build, data, layout, args=(), iters=1):
    got, want = _run(build, data, layout, args, iters)
    for g_it, w_it in zip(got, want):
        for g_out, w_out in zip(g_it, w_it):
            for g, w in zip(g_out, w_out):
                assert g.dtype == w.dtype and g.shape == w.shape, (g.shape, w.shape)
                np.testing.assert_array_equal(g, w)


def _image(h, w, c, smooth):
    img = RNG.integers(0, 256, (h, w, c)).astype(np.float32)
    if smooth:  # smooth content: many nonzero low-frequency coefficients
        img = cv2.GaussianBlur(img, (5, 5), 1.5).reshape(h, w, c)
    return np.clip(img, 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ JpegCompressionDistortion


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("channels", [3, 1])
def test_jpeg_coefficients_equal_cv2_stream(quality, channels):
    for k, (h, w) in enumerate(SIZES):
        img = _image(h, w, channels, smooth=k % 2 == 0)
        ok, buf = cv2.imencode(".jpg", img[:, :, ::-1] if channels == 3 else img,
                               [cv2.IMWRITE_JPEG_QUALITY, quality])
        assert ok
        planes, tables = native.jpeg_encode_coefs(img, quality)
        cbh, cbw = planes[1].shape[:2] if channels == 3 else (1, 1)
        y, c, q = native.jpeg_read_coeffs(buf.tobytes(), 8, 8, *planes[0].shape[:2], cbh, cbw)
        np.testing.assert_array_equal(planes[0], y)
        np.testing.assert_array_equal(tables[0], q[:64])
        if channels == 3:
            np.testing.assert_array_equal(planes[1], c[0])
            np.testing.assert_array_equal(planes[2], c[1])
            np.testing.assert_array_equal(tables[1], q[64:])
        want = cv2.imdecode(buf, cv2.IMREAD_COLOR)[:, :, ::-1]
        np.testing.assert_array_equal(native.jpeg_roundtrip(img, quality), want)


def test_jpeg_compression_distortion_cpu_bit_equal():
    imgs = [_image(*hw, 3, smooth=i % 2 == 1) for i, hw in enumerate(SIZES)]
    qual = [np.float32(q) for q in (1.0, 8.9, 50.0, 95.5, 100.0, 30.2)]
    _same(lambda fn, t, x, q: fn.jpeg_compression_distortion(x, quality=q), imgs, "HWC", (qual,))
    _same(lambda fn, t, x: fn.jpeg_compression_distortion(x), imgs, "HWC")
    _same(lambda fn, t, x: fn.jpeg_compression_distortion(x, quality=20.0),
          [im[..., :1].copy() for im in imgs], "HWC")


@pytest.mark.parametrize("form", ["rgba", "uint16", "float"])
def test_jpeg_compression_distortion_cpu_other_inputs(form):
    """Four channels and other types reach cv2's encoder as its conversions
    leave them."""
    rgb = [_image(33, 21, 3, True), _image(16, 40, 3, False)]
    if form == "rgba":
        data = [np.concatenate([im, im[..., :1] // 2], -1) for im in rgb]
    elif form == "uint16":
        data = [im.astype(np.uint16) * 2 for im in rgb]
    else:
        data = [im.astype(np.float32) * 1.3 - 20.25 for im in rgb]
    _same(lambda fn, t, x: fn.jpeg_compression_distortion(x, quality=60.0), data, "HWC")


# ------------------------------------------------------------------ Remap


def _maps(oh, ow, h, w, ties):
    mx = RNG.uniform(-3, w + 3, (oh, ow)).astype(np.float32)
    my = RNG.uniform(-3, h + 3, (oh, ow)).astype(np.float32)
    if ties:  # half-pixel coordinates: the roundings' ties
        mx[::3], my[::4] = np.round(mx[::3] * 2) / 2, np.round(my[::4] * 2) / 2
    return mx, my


DTYPES = [np.uint8, np.uint16, np.int16, np.float32, np.float64]


def _img(dtype, h, w, c):
    if np.issubdtype(dtype, np.floating):
        return RNG.uniform(-50, 300, (h, w, c)).astype(dtype)
    info = np.iinfo(dtype)
    return RNG.integers(max(info.min, -300), min(info.max, 70000), (h, w, c)).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("nearest", [False, True], ids=["linear", "nearest"])
@pytest.mark.parametrize("replicate", [False, True], ids=["constant", "replicate"])
def test_remap_equals_cv2(dtype, channels, nearest, replicate):
    img = _img(dtype, 29, 37, channels)
    mx, my = _maps(31, 45, 29, 37, ties=True)
    want = cv2.remap(img, mx, my, cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_REPLICATE if replicate else cv2.BORDER_CONSTANT)
    got = native.remap(img, mx, my, nearest, replicate)
    np.testing.assert_array_equal(got, want.reshape(got.shape))


@pytest.mark.parametrize("interp", ["INTERP_LINEAR", "INTERP_NN", None])
@pytest.mark.parametrize("data", ["rgb", "gray", "float"])
def test_remap_cpu_bit_equal(interp, data):
    src = {"rgb": [_img(np.uint8, 20 + i, 30 - i, 3) for i in range(N)],
           "gray": [_img(np.uint8, 20 + i, 30 - i, 1) for i in range(N)],
           "float": [_img(np.float32, 20 + i, 30 - i, 3) for i in range(N)]}[data]
    maps = [_maps(18 + i, 25, 20 + i, 30 - i, ties=i % 2 == 0) for i in range(N)]
    mx, my = [m[0] for m in maps], [m[1] for m in maps]

    def build(fn, t, x, a, b):
        return fn.experimental.remap(x, a, b, **({} if interp is None else
                                                  {"interp": t.DALIInterpType[interp]}))

    _same(build, src, "HWC", (mx, my))


def test_remap_cpu_refuses_pixel_origin():
    with pytest.raises(NotImplementedError, match="pixel_origin"):
        _run(lambda fn, t, x, a, b: fn.experimental.remap(x, a, b, pixel_origin="center"),
             [_img(np.uint8, 8, 8, 3)], "HWC", ([np.zeros((8, 8), np.float32)],) * 2)


# ------------------------------------------------------------------ WarpPerspective


def _homographies(n):
    out = []
    for _ in range(n):
        a = RNG.uniform(-0.3, 0.3, (3, 3))
        a[0, 0] += 1
        a[1, 1] += 1
        a[2] = [*RNG.uniform(-0.004, 0.004, 2), 1.0]
        a[:2, 2] = RNG.uniform(-10, 10, 2)
        out.append(a)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("nearest", [False, True], ids=["linear", "nearest"])
@pytest.mark.parametrize("replicate", [False, True], ids=["constant", "replicate"])
def test_warp_perspective_equals_cv2(dtype, channels, nearest, replicate):
    img = _img(dtype, 31, 43, channels)
    flags = (cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR) | cv2.WARP_INVERSE_MAP
    border = cv2.BORDER_REPLICATE if replicate else cv2.BORDER_CONSTANT
    for (oh, ow), m in zip(((29, 70), (40, 17), (9, 64)), _homographies(3)):
        want = cv2.warpPerspective(img, m, (ow, oh), flags=flags, borderMode=border,
                                   borderValue=[5.5] * 4)
        got = native.warp_perspective(img, m, oh, ow, nearest, replicate, 5.5)
        np.testing.assert_array_equal(got, want.reshape(got.shape))


WP_CASES = {
    "default": dict(),
    "nn_replicate": dict(interp_type="INTERP_NN", border_mode="replicate"),
    "forward_center": dict(inverse_map=False, pixel_origin="center", fill_value=77.0),
    "size": dict(size=[30.0, 41.0], fill_value=3.0),
}


@pytest.mark.parametrize("case", sorted(WP_CASES))
@pytest.mark.parametrize("data", ["rgb", "gray", "float"])
def test_warp_perspective_cpu_bit_equal(case, data):
    src = {"rgb": [_img(np.uint8, 20 + i, 30 - i, 3) for i in range(N)],
           "gray": [_img(np.uint8, 20 + i, 30 - i, 1) for i in range(N)],
           "float": [_img(np.float32, 20 + i, 30 - i, 3) for i in range(N)]}[data]
    mats = [m.astype(np.float32).reshape(-1) for m in _homographies(N)]

    def build(fn, t, x, m):
        kw = dict(WP_CASES[case])
        if "interp_type" in kw:
            kw["interp_type"] = t.DALIInterpType[kw["interp_type"]]
        return (fn.experimental.warp_perspective(x, m, **kw),
                fn.experimental.warp_perspective(x, matrix=[1.0, 0.1, -2.0, 0.05, 0.9, 3.0,
                                                            0.001, -0.002, 1.0], **kw))

    _same(build, src, "HWC", (mats,))


# ------------------------------------------------------------------ Debayer edge_aware


_CODES = {(0, 0): cv2.COLOR_BayerRG2RGB, (0, 1): cv2.COLOR_BayerGR2RGB,
          (1, 0): cv2.COLOR_BayerGB2RGB, (1, 1): cv2.COLOR_BayerBG2RGB}


@pytest.mark.parametrize("bp", sorted(_CODES))
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_debayer_edge_aware_equals_cv2(bp, dtype):
    """The reference's cv2 code of each blue position (its ``_EA`` form)."""
    from dali_tpu_torch.backend.enhance2 import _EA_PATTERN

    code = _CODES[bp] - cv2.COLOR_BayerBG2RGB + cv2.COLOR_BayerBG2RGB_EA
    top = 256 if dtype == np.uint8 else 65536
    for h, w in ((20, 30), (17, 23), (3, 3), (4, 5), (2, 7), (64, 96), (1, 9)):
        x = RNG.integers(0, top, (h, w)).astype(dtype)
        np.testing.assert_array_equal(native.debayer_edge_aware(x, *_EA_PATTERN[bp]),
                                      cv2.cvtColor(x, code))


@pytest.mark.parametrize("bp", sorted(_CODES))
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_debayer_edge_aware_cpu_bit_equal(bp, dtype):
    top = 256 if dtype == np.uint8 else 65536
    data = [RNG.integers(0, top, (2 * (8 + i), 2 * (11 - i))).astype(dtype) for i in range(N)]
    _same(lambda fn, t, x: fn.experimental.debayer(x, blue_position=list(bp),
                                                   algorithm="edge_aware"), data, "HW")


# ------------------------------------------------------------------ MedianBlur and morphology


@pytest.mark.parametrize("dtype", [np.uint16, np.int16, np.float32])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_median_blur_other_types_equal_cv2(dtype, k, channels):
    from dali_tpu_torch.backend.distortion import median_np

    img = _img(dtype, 23, 31, channels)
    want = cv2.medianBlur(img, k)
    np.testing.assert_array_equal(median_np(img, k), want.reshape(img.shape))


@pytest.mark.parametrize("dtype", [np.uint16, np.int16, np.float32, np.float64])
@pytest.mark.parametrize("op", ["dilate", "erode"])
@pytest.mark.parametrize("ms,iters,border", [((3, 3), 1, "constant"), ((5, 2), 2, "constant"),
                                             ((4, 7), 3, "replicate"), ((1, 1), 2, "constant")])
def test_morphology_other_types_equal_cv2(dtype, op, ms, iters, border):
    from dali_tpu_torch.backend.distortion import morph_np

    img = _img(dtype, 21, 26, 3)
    want = getattr(cv2, op)(img, np.ones(ms, np.uint8), iterations=iters,
                            borderType=cv2.BORDER_REPLICATE if border == "replicate"
                            else cv2.BORDER_CONSTANT)
    np.testing.assert_array_equal(morph_np(img, ms[0], ms[1], iters, op == "dilate"), want)


@pytest.mark.parametrize("data", ["u16", "i16", "float"])
def test_median_and_morphology_cpu_other_types_bit_equal(data):
    dt = {"u16": np.uint16, "i16": np.int16, "float": np.float32}[data]
    src = [_img(dt, 20 + i, 27 - i, 3) for i in range(N)]
    _same(lambda fn, t, x: (fn.experimental.median_blur(x, window_size=5),
                            fn.experimental.dilate(x, mask_size=[3, 5], iterations=2),
                            fn.experimental.erode(x, border_mode="replicate")), src, "HWC")
