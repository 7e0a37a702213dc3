"""The port's rebuild of libswscale's RGB24 route (``csrc/host/sws_rgb.cc``,
``native.sws_rgb``) against libswscale 6.7 itself, called through ctypes as
the reference's video_decode.cc calls it: ``sws_getContext(w, h, fmt, w, h,
AV_PIX_FMT_RGB24, SWS_BILINEAR)`` then ``sws_scale``, on random planes from
a numpy seed, bit-equal. The rebuild is what dali_tpu_torch converts every
frame that is not 4:2:0 with (HuffYUV, FFV1, Motion JPEG 4:2:2/4:4:4/grey).

Two behaviours of the library are pinned on their own: the SIMD converter
of 4:2:2 at an even height leaves the columns past its last block of 16
unwritten at some widths (the reference's output buffer keeps whatever it
held there; the port converts them with the same arithmetic), and with its
SIMD off libswscale's C converter reads chroma row y & ~1 (ROADMAP Queue 3).
"""

import ctypes

import numpy as np
import pytest

from dali_tpu_torch import native


def _lib(name):
    try:
        return ctypes.CDLL(name)
    except OSError:
        pytest.skip(f"{name} not on this machine")


@pytest.fixture(scope="module")
def sws():
    avu, lib = _lib("libavutil.so.57"), _lib("libswscale.so.6")
    avu.av_get_pix_fmt.restype = ctypes.c_int
    avu.av_get_pix_fmt.argtypes = [ctypes.c_char_p]
    avu.av_force_cpu_flags.argtypes = [ctypes.c_int]
    lib.sws_getContext.restype = ctypes.c_void_p
    lib.sws_getContext.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3
    lib.sws_scale.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    lib.sws_freeContext.argtypes = [ctypes.c_void_p]
    rgb24 = avu.av_get_pix_fmt(b"rgb24")

    def convert(fmt, planes, w, h, fill=0, simd=True):
        """libswscale's RGB24 of ``planes``; the output buffer is filled
        with ``fill`` first and has room past the frame, which the SIMD
        converter writes into at some widths."""
        if not simd:
            avu.av_force_cpu_flags(0)
        try:
            ctx = lib.sws_getContext(w, h, avu.av_get_pix_fmt(fmt.encode()), w, h, rgb24, 2,
                                     None, None, None)
            buf = np.full(h * w * 3 + 4096, fill, np.uint8)
            src = (ctypes.c_void_p * 4)(*[p.ctypes.data for p in planes],
                                        *[None] * (4 - len(planes)))
            strides = (ctypes.c_int * 4)(*[p.strides[0] for p in planes],
                                         *[0] * (4 - len(planes)))
            dst = (ctypes.c_void_p * 4)(buf.ctypes.data, None, None, None)
            dstride = (ctypes.c_int * 4)(w * 3, 0, 0, 0)
            lib.sws_scale(ctx, src, strides, 0, h, dst, dstride)
            lib.sws_freeContext(ctx)
        finally:
            avu.av_force_cpu_flags(-1)
        return buf[: h * w * 3].reshape(h, w, 3)

    return convert


def _planes(fmt, w, h, seed):
    """Random planes of ``fmt`` at w x h, each row padded by 24 bytes (the
    SIMD converter reads past a row's end)."""
    rng = np.random.default_rng(seed)
    if fmt == "gray":
        widths = [w]
    elif fmt in ("bgr0", "bgra", "0rgb"):
        widths = [4 * w]
    elif fmt == "bgr24":
        widths = [3 * w]
    else:
        cw = (w + 1) // 2 if "422" in fmt else w
        widths = [w, cw, cw]
    return [rng.integers(0, 256, (h, k + 24), np.uint8)[:, :k] for k in widths]


FORMATS = sorted(native.SWS_FORMATS)


def _check(sws, fmt, w, h, seed):
    planes = _planes(fmt, w, h, seed)
    a = sws(fmt, planes, w, h, fill=0)
    b = sws(fmt, planes, w, h, fill=255)
    written = (a == b).all(-1)
    mine = native.sws_rgb(fmt, planes, w, h)
    np.testing.assert_array_equal(np.where(written[..., None], mine, a), a,
                                  err_msg=f"{fmt} {w}x{h}")
    return written


@pytest.mark.parametrize("h", [48, 47])
@pytest.mark.parametrize("w", [64, 66, 170])
@pytest.mark.parametrize("fmt", FORMATS)
def test_bit_equal_to_libswscale(sws, fmt, w, h):
    """Every format the decoders emit, at widths 64, 66 and 170, an even
    and an odd height: each byte libswscale writes equals the port's. Only
    4:2:2 at width 66 and an even height leaves bytes unwritten
    (test_simd_converter_leaves_columns_unwritten)."""
    written = _check(sws, fmt, w, h, seed=w * 100 + h)
    if not ("422" in fmt and w == 66 and h % 2 == 0):
        assert written.all()


@pytest.mark.parametrize("fmt", FORMATS)
def test_small_heights_and_widths(sws, fmt):
    """Heights 1, 2 and 3 (the route switches on height parity) and widths
    below one SIMD block."""
    for w, h in ((66, 1), (66, 2), (66, 3), (6, 2), (8, 4), (2, 1), (17, 2)):
        if "422" in fmt and w % 2 and h % 2:
            continue
        _check(sws, fmt, w, h, seed=w + 7 * h)


def test_yuv444_blue_wraps_to_zero(sws):
    """4:4:4 takes libswscale's full-chroma packer, whose 32-bit sums wrap:
    Y 238, U 254, V 118 gives blue 0 where BT.601 gives 255. The port wraps
    alike, limited range and full."""
    y = np.full((2, 16), 238, np.uint8)
    u = np.full((2, 16), 254, np.uint8)
    v = np.full((2, 16), 118, np.uint8)
    for fmt in ("yuv444p", "yuvj444p"):
        want = sws(fmt, [y, u, v], 16, 2)
        np.testing.assert_array_equal(native.sws_rgb(fmt, [y, u, v], 16, 2), want)
    assert (sws("yuv444p", [y, u, v], 16, 2)[..., 2] == 0).all()
    rng = np.random.default_rng(444)
    planes = [rng.integers(0, 256, (96, 96), np.uint8) for _ in range(3)]
    want = sws("yuv444p", planes, 96, 96)
    np.testing.assert_array_equal(native.sws_rgb("yuv444p", planes, 96, 96), want)
    yf, uf = planes[0].astype(int) - 16, planes[1].astype(int) - 128
    wrapped = (want[..., 2] == 0) & (1.164 * yf + 2.018 * uf > 255)
    assert wrapped.sum() > 0


def test_simd_converter_leaves_columns_unwritten(sws):
    """4:2:2 at an even height: libswscale's SIMD converter runs in blocks
    of 16 pixels over h_size = ((w + 7) & ~7) columns, less 8 when 3 h_size
    passes the row, and never writes the columns from min(w, max(16,
    16 ceil(h_size / 16))) on; the port converts them all."""
    for w in (66, 34, 18, 321, 170, 64, 10):
        hs = (w + 7) & ~7
        if hs * 3 > w * 3:
            hs -= 8
        first = min(w, max(16, 16 * -(-hs // 16)))
        written = _check(sws, "yuv422p", w, 2, seed=w)
        assert written[:, :first].all() and not written[:, first:].any(), w


def test_c_converter_reads_chroma_rows_in_pairs(sws):
    """Pinned reference quirk (ROADMAP Queue 3): with its SIMD off
    (av_force_cpu_flags(0)) libswscale converts 4:2:2 at an even height with
    its C converter, which reads chroma row y & ~1: its output is the table
    packer's on the pairs' chroma, and differs from the SIMD route's (the
    port's) in most bytes, by up to 255."""
    w, h = 64, 48
    y, u, v = _planes("yuv422p", w, h, seed=5)
    c = sws("yuv422p", [y, u, v], w, h, simd=False)
    mine = native.sws_rgb("yuv422p", [y, u, v], w, h)
    np.testing.assert_array_equal(mine, sws("yuv422p", [y, u, v], w, h))
    assert (c != mine).mean() > 0.5 and np.abs(c.astype(int) - mine).max() == 255
    pairs = np.arange(h) & ~1
    odd = native.sws_rgb("yuv422p", [y[: h - 1], u[pairs][: h - 1], v[pairs][: h - 1]], w, h - 1)
    np.testing.assert_array_equal(c[: h - 1], odd)


def test_odd_width_and_height_422_is_refused():
    """4:2:2 at an odd width and an odd height takes libswscale's
    full-chroma bilinear route, which the port does not rebuild: the call
    refuses it (the reader raises NotImplementedError naming item 8b)."""
    planes = _planes("yuv422p", 65, 47, seed=1)
    with pytest.raises(ValueError, match="yuv422p"):
        native.sws_rgb("yuv422p", planes, 65, 47)
    native.sws_rgb("yuv422p", _planes("yuv422p", 65, 48, seed=1), 65, 48)


def test_port_links_no_ffmpeg():
    """The host library is built from the port's own sources with no FFmpeg
    header included and no FFmpeg library linked: the rebuild and the
    decoders stand alone (the card's machine has no FFmpeg)."""
    import re

    from dali_tpu_torch.native import build

    for src in build.HOST_SOURCES + build.HOST_CONTRACT_SOURCES + build.HOST_HEADERS:
        with open(src) as f:
            assert not re.search(r"#include\s*[<\"]lib(av|sw)", f.read()), src
    with open(build.__file__) as f:
        assert not re.search(r"-l(av|sw)", f.read())
