"""The MPEG-1/2 video decoder of dali_tpu_torch (``csrc/host/mpeg12_decode.cc``,
ROADMAP Queue 1 item 8b(a)) against dali_tpu's FFmpeg 5.1 route, on streams
written here: cv2's four MPEG writes, and FFmpeg's ``mpeg1video`` and
``mpeg2video`` encoders through ``tests/write_video_reference.py``'s
``FFmpegTools`` under the tools cv2 leaves off (B-pictures in MPEG-1, the
intra VLC table, the non-linear quantiser, the alternate scan, intra DC at
8-11 bits, custom matrices, interlaced field DCT and field motion, 4:2:2,
closed GOPs, low delay, odd sizes, large vectors, escapes at fine
quantisers), in elementary streams, MPEG-PS, MPEG-TS and AVI. Every frame
is bit-equal to dali_tpu's read from frame 0 (the read the reference gets
right), and the port's reads after seeks equal FFmpeg's display-order
decode. Forms FFmpeg reads that the port leaves to item 8b (field pictures,
4:4:4, MPEG-1 D-pictures, scalable extensions), made by editing headers,
raise NotImplementedError naming it."""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from dali_tpu import native as ref_native  # noqa: E402

from dali_tpu_torch import native  # noqa: E402

from .write_video_reference import FIXTURES, FFmpegTools, frame_hashes, yuv_hashes  # noqa: E402


@pytest.fixture(scope="module")
def tools():
    try:
        return FFmpegTools()
    except Exception as e:  # no compiler or FFmpeg headers
        pytest.skip(f"FFmpeg helper unavailable: {e}")


def _info(vf):
    return (vf.width, vf.height, vf.num_frames, vf.fps, vf.pixfmt_class)


def _texture(rng, h, w):
    small = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2), np.uint8)
    big = cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC).astype(np.float32)
    fine = cv2.GaussianBlur(rng.integers(0, 256, (h, w), np.uint8), (0, 0), 1.5)
    return np.clip(0.75 * big + 0.25 * fine, 0, 255).astype(np.uint8)


def _frames(n, w, h, seed, speed=(1.7, 0.6), chroma="420", cut=None):
    """Planar frames of a texture panned ``speed`` pixels a frame (a scene
    cut at ``cut``): Y, then U and V at half width (and height for 4:2:0),
    rounded up, one row per frame."""
    rng = np.random.default_rng(seed)
    pad = int(max(abs(speed[0]), abs(speed[1])) * n) + 8
    scenes = [[_texture(rng, h + 2 * pad, w + 2 * pad) for _ in range(3)] for _ in range(2)]
    cw, ch = (w + 1) // 2, (h + 1) // 2 if chroma == "420" else h
    out = []
    for i in range(n):
        y0, u0, v0 = scenes[1 if cut is not None and i >= cut else 0]
        m = np.float32([[1, 0, -(pad + speed[0] * i)], [0, 1, -(pad + speed[1] * i)]])
        planes = [cv2.warpAffine(p, m, (w, h), flags=cv2.INTER_LINEAR) for p in (y0, u0, v0)]
        u = cv2.resize(planes[1], (cw, ch), interpolation=cv2.INTER_AREA)
        v = cv2.resize(planes[2], (cw, ch), interpolation=cv2.INTER_AREA)
        out.append(np.concatenate([planes[0].reshape(-1), u.reshape(-1), v.reshape(-1)]))
    return np.stack(out)


def _display(tools, path, w, h):
    """FFmpeg's whole-stream decode in display order, as 4:2:0 hashes."""
    frames, _, types = tools.decode(path)
    n = len(frames)
    cw, ch = (w + 1) // 2, (h + 1) // 2
    y = frames[:, : w * h].reshape(n, h, w)
    u = frames[:, w * h: w * h + cw * ch].reshape(n, ch, cw)
    v = frames[:, w * h + cw * ch:].reshape(n, ch, cw)
    return yuv_hashes(y, u, v), types


def _yuv_sha(vf, start, count, stride=1):
    y, u, v, got = vf.read_yuv(start, count, stride, pad=False)
    return yuv_hashes(y[:got], u[:got], v[:got])


def _check_bit_equal(path, n, display=None, avi=False):
    """Info, every frame in RGB and YUV from frame 0 against dali_tpu's live
    read, new-handle reads at starts within 64 frames (which dali_tpu
    reaches without a seek) against dali_tpu's too; with ``display``
    reads after seeks through one handle against it."""
    mine, ref = native.VideoFile(path), ref_native.VideoFile(path)
    assert _info(mine) == _info(ref)
    count = mine.num_frames or n
    a, b = mine.read(0, count, pad=False), ref.read(0, count, pad=False)
    assert len(a) >= min(count, n) - 2 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    if mine.pixfmt_class:
        np.testing.assert_array_equal(_yuv_sha(native.VideoFile(path), 0, count),
                                      _yuv_sha(ref_native.VideoFile(path), 0, count))
    if not avi:
        for s in (3, 7, 13):
            np.testing.assert_array_equal(native.VideoFile(path).read(s, 3, pad=False),
                                          ref_native.VideoFile(path).read(s, 3, pad=False),
                                          err_msg=str(s))
    if display is not None:
        vf = native.VideoFile(path)
        for s in (n - 5, 2, 14, 9, 0, n // 2):
            np.testing.assert_array_equal(_yuv_sha(vf, s, 3), display[s: s + 3], err_msg=str(s))


@pytest.mark.parametrize("fourcc,ext", [("mpg2", "ts"), ("MPEG", "mpg"), ("mpg1", "mpg"),
                                        ("PIM1", "avi")])
def test_cv2_writes_bit_equal(tmp_path, fourcc, ext):
    """cv2's four MPEG-1/2 writes (MPEG-2 in TS with open GOPs and two
    B-pictures; MPEG-2 and MPEG-1 in PS; MPEG-1 in AVI) at a size no
    multiple of 16, written here."""
    rng = np.random.default_rng(len(fourcc))
    base = cv2.resize(rng.integers(0, 256, (12, 16, 3), np.uint8), (200, 150),
                      interpolation=cv2.INTER_CUBIC)
    path = str(tmp_path / f"v.{ext}")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), 25, (104, 72))
    if not wr.isOpened():
        pytest.skip(f"cv2 cannot write {fourcc}")
    for i in range(26):
        m = np.float32([[1, 0, -(7 * i % 90)], [0, 1, -(i % 60)]])
        wr.write(cv2.warpAffine(base, m, (104, 72), borderMode=cv2.BORDER_REFLECT))
    wr.release()
    _check_bit_equal(path, 26, avi=ext == "avi")


# name -> (encoder, muxer, options, size, frames, chroma, custom matrices, speed)
ENCODER_FORMS = {
    "mpeg1_b_pictures_es": ("mpeg1video", "mpeg1video", "bf=2", (64, 48), 24, "420", False,
                            (1.7, 0.6)),
    "mpeg1_three_b_pictures_ps": ("mpeg1video", "mpeg", "bf=3:g=15", (80, 48), 30, "420", False,
                                  (2.3, -1.1)),
    "mpeg1_all_intra_ts": ("mpeg1video", "mpegts", "g=1", (64, 48), 18, "420", False,
                           (1.7, 0.6)),
    "mpeg1_fine_quantiser_escapes_ps": ("mpeg1video", "mpeg", "bf=2:qmin=1:qmax=2", (64, 48),
                                        18, "420", False, (1.3, 0.4)),
    "mpeg1_matrices_ts": ("mpeg1video", "mpegts", "bf=2", (48, 32), 18, "420", True, (0.9, 1.2)),
    "mpeg2_closed_gops_ts": ("mpeg2video", "mpegts",
                             "bf=2:flags=+cgop:sc_threshold=1000000000", (64, 48), 30, "420",
                             False, (1.7, 0.6)),
    "mpeg2_vlc_nonlinear_altscan_ps": ("mpeg2video", "mpeg",
                                       "bf=2:intra_vlc=1:non_linear_quant=1:qmax=28:"
                                       "alternate_scan=1", (64, 48), 24, "420", False,
                                       (1.7, 0.6)),
    "mpeg2_dc8_es": ("mpeg2video", "mpeg2video", "bf=2:dc=8", (64, 48), 18, "420", False,
                     (1.7, 0.6)),
    "mpeg2_dc9_es": ("mpeg2video", "mpeg2video", "bf=2:dc=9", (64, 48), 18, "420", False,
                     (1.7, 0.6)),
    "mpeg2_dc11_ts": ("mpeg2video", "mpegts", "bf=2:dc=11:qmin=1:qmax=4", (64, 48), 18, "420",
                      False, (1.7, 0.6)),
    "mpeg2_fine_quantiser_escapes_es": ("mpeg2video", "mpeg2video", "bf=1:qmin=1:qmax=2",
                                        (64, 48), 18, "420", False, (1.3, 0.4)),
    "mpeg2_matrices_ps": ("mpeg2video", "mpeg", "bf=2", (64, 48), 24, "420", True, (1.7, 0.6)),
    "mpeg2_low_delay_ts": ("mpeg2video", "mpegts", "bf=0:flags=+low_delay", (64, 48), 18,
                           "420", False, (1.7, 0.6)),
    "mpeg2_interlaced_alternate_ts": ("mpeg2video", "mpegts",
                                      "bf=2:flags=+ildct+ilme:alternate_scan=1", (64, 64), 24,
                                      "420", False, (2.5, 1.5)),
    "mpeg2_interlaced_422_ts": ("mpeg2video", "mpegts", "bf=2:flags=+ildct+ilme", (64, 48), 18,
                                "422", False, (1.7, 0.6)),
    "mpeg2_422_ps": ("mpeg2video", "mpeg", "bf=2", (48, 32), 18, "422", False, (1.7, 0.6)),
    "mpeg2_odd_size_ts": ("mpeg2video", "mpegts", "bf=2", (66, 34), 24, "420", False,
                          (1.1, -0.7)),
    "mpeg2_large_vectors_ts": ("mpeg2video", "mpegts", "bf=2", (160, 96), 20, "420", False,
                               (9.5, 4.5)),
    "mpeg2_gop15_three_b_vob": ("mpeg2video", "vob", "bf=3:g=15", (64, 48), 36, "420", False,
                                (1.7, 0.6)),
    "mpeg1_b_pictures_avi": ("mpeg1video", "avi", "bf=2", (64, 48), 24, "420", False,
                             (1.7, 0.6)),
    # a constant rate: libavformat counts an elementary stream's frames from
    # its bit rate
    "mpeg1_constant_rate_es": ("mpeg1video", "mpeg1video",
                               "bf=0:b=300000:maxrate=300000:minrate=300000:bufsize=200000",
                               (176, 144), 40, "420", False, (1.7, 0.6)),
    "mpeg2_constant_rate_es": ("mpeg2video", "mpeg2video",
                               "bf=2:b=300000:maxrate=300000:minrate=300000:bufsize=200000",
                               (176, 144), 40, "420", False, (1.7, 0.6)),
}


@pytest.mark.parametrize("form", sorted(ENCODER_FORMS))
def test_encoder_forms_bit_equal(tmp_path, tools, form):
    codec, muxer, opts, (w, h), n, chroma, mats, speed = ENCODER_FORMS[form]
    ext = {"mpegts": "ts", "mpeg": "mpg", "vob": "vob", "avi": "avi", "mpeg1video": "m1v",
           "mpeg2video": "m2v"}[muxer]
    rng = np.random.default_rng(len(form))
    intra = np.concatenate([[8], rng.integers(9, 70, 63)]) if mats else None
    inter = rng.integers(12, 45, 64) if mats else None
    path = tools.encode(tmp_path / f"v.{ext}", _frames(n, w, h, len(form), speed, chroma,
                                                       cut=n // 2 if "cut" in form else None),
                        w, h, opts=opts, fmt=muxer, codec=codec,
                        pixfmt="yuv422p" if chroma == "422" else "yuv420p",
                        intra_matrix=intra, inter_matrix=inter)
    display = None
    if chroma == "420" and ext not in ("m1v", "m2v"):
        display, _ = _display(tools, path, w, h)
    _check_bit_equal(path, n, display, avi=ext == "avi")


def test_default_idct_is_the_simple_idct(tmp_path, tools):
    """FFmpeg's mpeg2video decoder on x86-64 takes its simple IDCT by
    default (its SSE2 form, bit-equal to the C one): the port's."""
    path = tools.encode(tmp_path / "v.m2v", _frames(12, 64, 48, 3, chroma="420"), 64, 48,
                        opts="bf=2:qmin=1:qmax=3", fmt="mpeg2video", codec="mpeg2video")
    a, _, _ = tools.decode(path)
    for opts, cpu in (("idct=simple", -1), ("", 0)):
        b, _, _ = tools.decode(path, opts, cpu)
        np.testing.assert_array_equal(a, b, err_msg=opts or "SIMD off")
    y, u, v, got = native.VideoFile(path).read_yuv(0, 12, pad=False)
    np.testing.assert_array_equal(
        np.concatenate([y[:got].reshape(got, -1), u[:got].reshape(got, -1),
                        v[:got].reshape(got, -1)], 1), a)


# --------------------------------------------------------------------------- item 8b

def _es(name):
    return bytearray(open(os.path.join(FIXTURES, "mpeg", name), "rb").read())


def _ext(data, ext_id, nth=0):
    """The offset of the ``nth`` extension of id ``ext_id`` after its start code."""
    k = -1
    for _ in range(nth + 1):
        k = data.find(b"\x00\x00\x01\xb5", k + 1)
        while k >= 0 and data[k + 4] >> 4 != ext_id:
            k = data.find(b"\x00\x00\x01\xb5", k + 1)
    return k + 4


def _field_pictures():
    data = _es("mpeg2_dc10_64x48.m2v")
    data[_ext(data, 1) + 1] &= ~0x08  # progressive_sequence 0
    p = _ext(data, 8)
    data[p + 2] = (data[p + 2] & ~3) | 1  # picture_structure: top field
    data[p + 4] &= 0x7f  # progressive_frame 0
    return data


def _chroma_444():
    data = _es("mpeg2_dc10_64x48.m2v")
    p = _ext(data, 1)
    data[p + 1] = (data[p + 1] & ~0x06) | (3 << 1)
    return data


def _d_picture():
    data = _es("mpeg1_matrices_64x48.m1v")
    k = data.find(b"\x00\x00\x01\x00")
    k = data.find(b"\x00\x00\x01\x00", k + 1)
    data[k + 5] = (data[k + 5] & ~0x38) | (4 << 3)
    return data


def _scalable():
    data = _es("mpeg2_dc10_64x48.m2v")
    p = _ext(data, 1) + 6  # after the sequence extension
    return data[:p] + b"\x00\x00\x01\xb5\x50\x00\x00\x00" + data[p:]


LEFT_FORMS = {"field_pictures": (_field_pictures, "field pictures"),
              "chroma_444": (_chroma_444, "4:4:4"),
              "d_pictures": (_d_picture, "D-picture"),
              "scalable_extension": (_scalable, "scalable extension")}


@pytest.mark.parametrize("form", sorted(LEFT_FORMS))
def test_forms_left_to_item_8b_raise(form):
    """Field pictures, 4:4:4, MPEG-1 D-pictures and the scalable
    extensions, made by editing the headers of committed elementary
    streams: NotImplementedError naming the form and item 8b, at open."""
    make, what = LEFT_FORMS[form]
    with pytest.raises(NotImplementedError, match=f"{what}.*item 8b"):
        native.VideoFile(bytes(make())).read(0, 4)


def test_damaged_elementary_stream_raises_value_error():
    """A picture whose slice runs into garbage, and one cut short: the port
    names the damage (ValueError) where FFmpeg conceals it."""
    data = _es("mpeg2_dc10_64x48.m2v")
    k = data.find(b"\x00\x00\x01\x01")
    k = data.find(b"\x00\x00\x01\x01", k + 1)
    bad = bytearray(data)
    bad[k + 8: k + 30] = b"\xff" * 22
    with pytest.raises(ValueError, match="damaged MPEG-1/2 stream"):
        native.VideoFile(bytes(bad)).read(0, 8)
    cut = data[: k + 12] + data[k + 12 + 40:]
    with pytest.raises(ValueError, match="damaged MPEG-1/2 stream"):
        native.VideoFile(bytes(cut)).read(0, 8)
    np.testing.assert_array_equal(frame_hashes(native.VideoFile(bytes(data)).read(0, 2)),
                                  frame_hashes(ref_native.VideoFile(
                                      os.path.join(FIXTURES, "mpeg",
                                                   "mpeg2_dc10_64x48.m2v")).read(0, 2)))
