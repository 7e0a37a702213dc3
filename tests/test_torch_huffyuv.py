"""HuffYUV in dali_tpu_torch (``csrc/host/huffyuv_decode.cc``): HuffYUV
(``HFYU``) and FFmpeg's HuffYUV v2 (``FFVH``) AVIs, against dali_tpu's
FFmpeg 5.1 route (huffyuvdec.c, then libswscale's RGB24 for the files that
are not 4:2:0).

The committed fixtures (``dali_tpu_torch/testdata/video/capture``, written
by ``make_video_corpus.py --capture``) cover cv2's form (RGB with
decorrelation, left predictor), FFmpeg's encoders in yuv422p (left, median,
plane with the interlace flag at 480 rows), RGB24 and RGBA, FFVH in
yuv420p, yuv444p and grey (version 3) and with per-frame tables, and a
HuffYUV 1.x stream without extradata coded with the classic tables. Each
decodes to ``capture_reference.npz`` and to dali_tpu's read, from frame 0
and after seeks. The port's counterpart of the reference's
``test_yuv_wire_dense_alternation`` runs over cv2's HFYU."""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import dali_tpu  # noqa: E402
import dali_tpu_torch  # noqa: E402
from dali_tpu import native as ref_native  # noqa: E402

from dali_tpu_torch import native  # noqa: E402

from .test_torch_video import _samples  # noqa: E402
from .write_video_reference import (FIXTURES, capture_names, frame_hashes,  # noqa: E402
                                    yuv_hashes)

CAP = np.load(os.path.join(FIXTURES, "capture_reference.npz"))
# the forms left to item 8b (test_torch_avi.py raises on them)
LEFT = ("capture/ffvh_422p10_64x48", "capture/ffv1_422p10_64x48",
        "capture/mjpeg_fields_64x48")


def path_of(name):
    return os.path.join(FIXTURES, name + ".avi")


def info(vf):
    return (vf.width, vf.height, vf.num_frames, vf.fps, vf.pixfmt_class)


def names_of(*prefixes):
    return [n for n in capture_names() if n not in LEFT
            and os.path.basename(n).startswith(prefixes)]


def check_fixture(name):
    """The frame size, count, fps and pixel-format class, every frame's
    RGB (and, for 4:2:0, its planes): the committed hashes and dali_tpu's
    read. A stream that is not 4:2:0 refuses the planar read in both."""
    mine, ref = native.VideoFile(path_of(name)), ref_native.VideoFile(path_of(name))
    assert info(mine) == info(ref) == tuple(CAP[name + ":info"].tolist())
    n = mine.num_frames
    rgb = mine.read(0, n, pad=False)
    np.testing.assert_array_equal(frame_hashes(rgb), CAP[name + ":rgb_sha"])
    np.testing.assert_array_equal(rgb, ref.read(0, n, pad=False))
    if mine.pixfmt_class:
        y, u, v, got = native.VideoFile(path_of(name)).read_yuv(0, n, pad=False)
        np.testing.assert_array_equal(yuv_hashes(y[:got], u[:got], v[:got]),
                                      CAP[name + ":yuv_sha"])
    else:
        for vf in (mine, ref):
            with pytest.raises(RuntimeError, match="4:2:0"):
                vf.read_yuv(0, 2)


def check_seeks(name):
    """Reads that seek back and forth through one handle, with strides, and
    from fresh handles: the committed frames at every start, and dali_tpu's
    own reads through one handle."""
    want = CAP[name + ":rgb_sha"]
    n = len(want)
    mine, ref = native.VideoFile(path_of(name)), ref_native.VideoFile(path_of(name))
    for start, count, stride in ((n - 4, 4, 1), (1, 3, 2), (n // 2, 4, 1), (0, 3, 3),
                                 (n // 3, 3, 2), (n - 1, 1, 1), (5, 4, 1), (2, 2, 1)):
        start = max(0, min(start, n - 1))
        got = mine.read(start, count, stride, pad=False)
        np.testing.assert_array_equal(frame_hashes(got),
                                      want[start: start + count * stride: stride][:count],
                                      err_msg=str((name, start, stride)))
        np.testing.assert_array_equal(got, ref.read(start, count, stride, pad=False))
        fresh = native.VideoFile(path_of(name)).read(start, 1, pad=False)
        np.testing.assert_array_equal(fresh, got[:1])


HUFFYUV = names_of("hfyu_", "ffvh_", "cv2_hfyu")


@pytest.mark.parametrize("name", HUFFYUV)
def test_fixture_bit_equal_to_the_reference(name):
    check_fixture(name)


@pytest.mark.parametrize("name", HUFFYUV)
def test_seeks(name):
    check_seeks(name)


def _extradata(path):
    """The bytes after the BITMAPINFOHEADER of the video stream's strf."""
    data = open(path, "rb").read()
    i = data.find(b"strf")
    size = int.from_bytes(data[i + 4: i + 8], "little")
    return data[i + 8 + 40: i + 8 + size]


def test_fixture_forms():
    """What the fixtures hold, read from their headers: the interlace flag
    at 480 rows, per-frame tables, cv2's RGB with decorrelation, version 3,
    and a HuffYUV 1.x file with no extradata (the classic tables)."""
    ex = {n: _extradata(path_of(n)) for n in HUFFYUV}
    assert ex["capture/hfyu_422_plane_ilme_64x480"][2] & 0x30 == 0x10
    assert ex["capture/hfyu_422_64x48"][2] & 0x30 == 0x20
    assert ex["capture/ffvh_422_context_64x48"][2] & 0x40
    assert ex["capture/cv2_hfyu_64x48"][:2] == bytes([0x40, 24])  # left, decorrelated RGB
    assert ex["capture/ffvh_444_plane_64x48"][3] != 0  # version 3
    assert ex["capture/hfyu_classic_422_64x48"] == b""
    assert CAP["capture/ffvh_420_median_64x48:info"][4] == 1  # 4:2:0: class 1


def test_per_frame_tables_decode_each_frame_alone():
    """FFVH with per-frame tables (context=1) carries each frame's tables in
    the frame: every frame read alone from a fresh handle is the frame of
    the whole-stream decode."""
    name = "capture/ffvh_422_context_64x48"
    want = CAP[name + ":rgb_sha"]
    for k in (7, 3, 11, 0):
        got = native.VideoFile(path_of(name)).read(k, 1, pad=False)
        np.testing.assert_array_equal(frame_hashes(got), want[k: k + 1])


@pytest.mark.parametrize("size", [(64, 48), (96, 64)])
def test_cv2_written_now(tmp_path, size):
    """cv2 5.0's HFYU writer run in the test (RGB, left predictor,
    decorrelation): dali_tpu's frames."""
    w, h = size
    path = str(tmp_path / "v.avi")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"HFYU"), 25, (w, h))
    if not wr.isOpened():
        pytest.skip("cv2 cannot write HFYU")
    rng = np.random.default_rng(w)
    for _ in range(5):
        wr.write(rng.integers(0, 256, (h, w, 3), np.uint8))
    wr.release()
    mine, ref = native.VideoFile(path), ref_native.VideoFile(path)
    assert info(mine) == info(ref)
    np.testing.assert_array_equal(mine.read(0, 5), ref.read(0, 5))


def test_damaged_frame_raises_value_error():
    """The per-frame tables of the fourth FFVH frame overwritten: FFmpeg
    drops the frame, the port raises ValueError naming the codec and the
    damage."""
    data = bytearray(open(path_of("capture/ffvh_422_context_64x48"), "rb").read())
    i = data.find(b"movi")
    for _ in range(4):
        i = data.find(b"00dc", i + 4)
    data[i + 8: i + 24] = b"\xff" * 16
    with pytest.raises(ValueError, match="HuffYUV.*tables"):
        native.VideoFile(bytes(data)).read(0, 12)


def _write_mp4(path, n, w=64, h=48, seed=21):
    rng = np.random.default_rng(seed)
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25, (w, h))
    base = rng.integers(0, 256, (h, w * 3, 3), np.uint8)
    for i in range(n):
        wr.write(np.ascontiguousarray(base[:, i: i + w]))
    wr.release()
    return str(path)


def test_yuv_wire_dense_alternation(tmp_path):
    """The port's counterpart of the reference's
    test_yuv_wire_dense_alternation: batches that alternate between a 4:2:0
    MP4 (the planar YUV wire) and cv2's HFYU (class 0: the dense RGB path)
    on one edge, through decoders.Video and then through
    experimental.inputs.Video: cpu and mixed bit-equal, and equal to
    dali_tpu's."""
    p420 = _write_mp4(tmp_path / "a.mp4", 6)
    pflat = path_of("capture/cv2_hfyu_64x48")
    assert native.VideoFile(pflat).pixfmt_class == 0
    blobs_420 = [np.frombuffer(open(p420, "rb").read(), np.uint8)] * 2
    blobs_flat = [np.frombuffer(open(pflat, "rb").read(), np.uint8)] * 2
    batches = [blobs_420, blobs_flat, blobs_420, blobs_flat]
    outs = {}
    for pkg in (dali_tpu, dali_tpu_torch):
        for device in ("cpu", "mixed"):
            it = iter(batches)
            opts = {"device": "cpu"} if pkg is dali_tpu_torch else {"debug": True}

            @pkg.pipeline_def(batch_size=2, num_threads=1, seed=5, **opts)
            def p():
                buf = pkg.fn.external_source(source=lambda: next(it), batch=True)
                return pkg.fn.decoders.video(buf, sequence_length=3, device=device)
            pipe = p()
            pipe.build()
            outs[(pkg.__name__, device)] = [_samples(pipe.run()[0]) for _ in batches]
    want = outs[("dali_tpu", "cpu")]
    for key, got in outs.items():
        for b, (g, w) in enumerate(zip(got, want)):
            for i, (x, y) in enumerate(zip(g, w)):
                np.testing.assert_array_equal(x, y, err_msg=str((key, b, i)))

    feeds = {}
    for device in ("cpu", "mixed"):
        @dali_tpu_torch.pipeline_def(batch_size=4, num_threads=1, seed=5, device="cpu")
        def pin():
            return dali_tpu_torch.fn.experimental.inputs.video(sequence_length=3, name="vin",
                                                               device=device)
        pipe = pin()
        pipe.build()
        got = []
        for blob in (open(p420, "rb").read(), open(pflat, "rb").read(), open(p420, "rb").read()):
            pipe.feed_input("vin", blob)
            got.append(_samples(pipe.run()[0]))
        feeds[device] = got
    for b, (c, m) in enumerate(zip(feeds["cpu"], feeds["mixed"])):
        assert len(c) == len(m)
        for x, y in zip(c, m):
            np.testing.assert_array_equal(x, y, err_msg=str(b))
