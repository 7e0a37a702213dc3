"""OpticalFlow of dali_tpu_torch (ROADMAP Queue 1 item 8b, registry part)
against dali_tpu's, which calls cv2 (``COLOR_RGB2GRAY``, then
``calcOpticalFlowFarneback(a, b, None, 0.5, 3, 15, 3, 5, 1.2, 0)`` on each
consecutive pair): the port runs its C++ copy (``optical_flow.cc``).

Tolerance: none on a machine whose cv2 dispatches AVX2 code, which is where
the port's rounding was taken from: the flow is bit-equal for frames up to
255 pixels on their shorter side (three pyramid levels). Larger frames add
a fourth level, whose 19-tap blur can sum a pixel of its last columns in
another order (one pixel of a 128x171 plane, 7.6e-6 apart): there the tests
hold the flow to ``BOUND`` px (observed 0 at 257x300). Without AVX2, cv2's
own blur rounds differently (observed within 3e-6 px of the AVX2 flow), and
the tests hold every case to ``BOUND``. The pyramid's blur and resize, and
the grey conversion, are held against cv2 on their own as well."""

import os

import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch
from dali_tpu_torch import native

cv2 = pytest.importorskip("cv2")

VIDEO = os.path.join(os.path.dirname(__file__), "..", "dali_tpu_torch", "testdata", "video")
BOUND = 1e-4  # px
EXACT = bool(cv2.checkHardwareSupport(11))  # cv::CPU_AVX2, as cv2 dispatches it


def _clip(path, n=4, size=None):
    cap = cv2.VideoCapture(path)
    frames = []
    while len(frames) < n:
        ok, f = cap.read()
        if not ok:
            break
        f = cv2.cvtColor(f, cv2.COLOR_BGR2RGB)
        frames.append(cv2.resize(f, size, interpolation=cv2.INTER_AREA) if size else f)
    cap.release()
    return np.stack(frames)


def _pan(f=4):
    """The sequence of docs/examples/debug_and_optical_flow.py: a blurred
    64x64 texture moving 2 px to the right each frame."""
    rng = np.random.default_rng(4)
    base = cv2.GaussianBlur(rng.integers(0, 255, (64, 64), np.uint8), (0, 0), 2)
    f0 = np.repeat(base[:, :, None], 3, 2)
    return np.stack([f0] + [np.roll(f0, 2 * k, axis=1) for k in range(1, f)])


def _flow(pkg, seqs, **kw):
    opts = {"device": "cpu"} if pkg is dali_tpu_torch else {"debug": True}

    @pkg.pipeline_def(batch_size=len(seqs), num_threads=2, seed=1, **opts)
    def p():
        x = pkg.fn.external_source(source=lambda: seqs, batch=True, cycle=True, layout="FHWC")
        return pkg.fn.optical_flow(x, **kw)

    pipe = p()
    pipe.build()
    try:
        (out,) = pipe.run()
        return [np.asarray(out.at(i)) for i in range(len(seqs))]
    finally:
        if hasattr(pipe, "shutdown"):
            pipe.shutdown()


def _assert_flow_equal(seqs, exact=EXACT, **kw):
    want = _flow(dali_tpu, seqs, **kw)
    got = _flow(dali_tpu_torch, seqs, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=BOUND)
    return got


CASES = {
    "pan_grid1": (lambda: [_pan()], dict(output_grid=1)),
    "corpus_320x240": (lambda: [_clip(os.path.join(VIDEO, "corpus", "pan", "pan_00.mp4"), 3),
                                _clip(os.path.join(VIDEO, "corpus", "cut", "cut_03.mp4"), 3)],
                       dict(output_grid=4)),
    "corpus_171x128": (lambda: [_clip(os.path.join(VIDEO, "corpus", "zoom", "zoom_01.mp4"), 4,
                                      (171, 128))], dict(output_grid=4)),
    "odd_170x98_grid5": (lambda: [_clip(os.path.join(VIDEO, "odd_170x98.mp4"), 3)],
                         dict(output_grid=5)),
    "one_channel": (lambda: [_pan(3)[..., :1], _pan(3)[:, :40, :48, :1]], dict(output_grid=1)),
    "float32_rgb": (lambda: [_pan(3).astype(np.float32) * np.float32(0.7)], dict(output_grid=4)),
    "uint16_rgb": (lambda: [_pan(3).astype(np.uint16) * 257], dict()),
    "float64_one_channel": (lambda: [_pan(3)[..., :1].astype(np.float64) / 3], dict()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optical_flow_matches_dali_tpu(case):
    make, kw = CASES[case]
    got = _assert_flow_equal(make(), **kw)
    assert all(np.isfinite(g).all() for g in got)


def test_debug_and_optical_flow_example_graph():
    """The flow graph of docs/examples/debug_and_optical_flow.py through
    both packages: equal flows, whose median matches the true motion."""
    (fl,) = _assert_flow_equal([_pan()], output_grid=1)
    assert fl.shape == (3, 64, 64, 2)
    med_dx = [float(np.median(fl[k][16:48, 16:48, 0])) for k in range(3)]
    assert all(abs(d - 2.0) < 1.0 for d in med_dx), med_dx


def test_large_frames_hold_to_the_bound():
    rng = np.random.default_rng(5)
    a = cv2.GaussianBlur(rng.integers(0, 255, (257, 300), np.uint8), (5, 5), 1.5)
    b = cv2.warpAffine(a, np.float32([[1, 0.02, 1.5], [-0.01, 1, 0.7]]), (300, 257))
    _assert_flow_equal([np.stack([a, b])[..., None]], exact=False, output_grid=3)


@pytest.mark.parametrize("seq", [np.zeros((1, 32, 40, 3), np.uint8),
                                 np.zeros((2, 32, 40, 3), np.float64),
                                 np.zeros((2, 32, 40, 3), np.int16),
                                 np.zeros((2, 32, 40, 2), np.uint8)],
                         ids=["one_frame", "float64_rgb", "int16_rgb", "two_channels"])
def test_optical_flow_raises_where_the_reference_raises(seq):
    for pkg in (dali_tpu, dali_tpu_torch):
        with pytest.raises(Exception):
            _flow(pkg, [seq])


@pytest.mark.parametrize("ksize,sigma", [(3, 0.0), (3, 0.5), (9, 1.5)])
@pytest.mark.parametrize("hw", [(64, 64), (128, 171), (98, 170), (49, 85), (33, 43)])
def test_pyramid_blur_equals_cv2(hw, ksize, sigma):
    x = (np.random.default_rng(hw[1]).random(hw) * 255).astype(np.float32)
    want = cv2.GaussianBlur(x, (ksize, ksize), sigma, sigmaY=sigma)
    got = native.flow_gaussian_blur(x, ksize, sigma)
    if EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("src,dst", [((240, 320), (120, 160)), ((240, 320), (60, 80)),
                                     ((128, 171), (64, 86)), ((128, 171), (32, 43)),
                                     ((98, 170), (49, 85)), ((64, 64), (128, 127))])
def test_pyramid_resize_equals_cv2(src, dst):
    rng = np.random.default_rng(src[1])
    x = (rng.random(src) * 255).astype(np.float32)
    np.testing.assert_array_equal(native.flow_resize(x, *dst),
                                  cv2.resize(x, dst[::-1], interpolation=cv2.INTER_LINEAR))
    # the flow: two channels, up one level
    f = rng.standard_normal(dst + (2,)).astype(np.float32)
    np.testing.assert_array_equal(native.flow_resize(f, *src),
                                  cv2.resize(f, src[::-1], interpolation=cv2.INTER_LINEAR))


def test_grey_conversion_equals_cv2():
    from dali_tpu_torch.backend.enhance2 import _gray

    rng = np.random.default_rng(0)
    for img in (rng.integers(0, 256, (33, 67, 3)).astype(np.uint8),
                rng.integers(0, 65536, (33, 67, 3)).astype(np.uint16),
                (rng.random((33, 67, 3)) * 255).astype(np.float32)):
        want = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY).astype(np.float32)
        np.testing.assert_array_equal(_gray(img), want)
