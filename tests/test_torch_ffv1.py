"""FFV1 in dali_tpu_torch (``csrc/host/ffv1_decode.cc``, RFC 9043) in AVI,
against dali_tpu's FFmpeg 5.1 route (ffv1dec.c, then libswscale's RGB24 for
the files that are not 4:2:0).

The committed fixtures (``dali_tpu_torch/testdata/video/capture``) cover
cv2's form (RGB32 with the reversible colour transform, version 3 with
slice CRCs, a GOP of 12), versions 0, 1 and 3, Golomb-Rice and both range
coder tables, the small and large context sets, slices, yuv420p (class 1:
the planar YUV wire), yuv422p at an odd height, yuv444p, grey, RGB and
RGBA. Reads that start mid-GOP decode from the key frame before them, as
FFmpeg's seek does. More encoder forms are written in the test by
FFmpeg's ffv1 encoder through ``make_video_corpus.AviWriter``."""

import os

import numpy as np
import pytest

pytest.importorskip("cv2")

import dali_tpu  # noqa: E402
import dali_tpu_torch  # noqa: E402
from dali_tpu import native as ref_native  # noqa: E402

from dali_tpu_torch import native  # noqa: E402

from .test_torch_huffyuv import CAP, check_fixture, check_seeks, info, names_of, path_of  # noqa
from .test_torch_video import _assert_same, _run_all  # noqa: E402
from .write_video_reference import frame_hashes  # noqa: E402

FFV1 = names_of("ffv1_", "cv2_ffv1")


@pytest.mark.parametrize("name", FFV1)
def test_fixture_bit_equal_to_the_reference(name):
    check_fixture(name)


@pytest.mark.parametrize("name", FFV1)
def test_seeks(name):
    check_seeks(name)


@pytest.mark.parametrize("name", ["capture/cv2_ffv1_64x48", "capture/ffv1_v0_420_rice_64x48",
                                  "capture/ffv1_v3_444_tab_slices_64x48"])
def test_reads_from_mid_gop(name):
    """A GOP of 12: frames 1-11, 13-23 and 25-29 are not key frames and
    keep the context states of the frames before them. A read from a fresh
    handle at any of them decodes from the key frame before it and gives
    the whole-stream decode's frames."""
    want = CAP[name + ":rgb_sha"]
    data = open(path_of(name), "rb").read()
    keys = 0
    i = data.rfind(b"idx1")
    for k in range(int.from_bytes(data[i + 4: i + 8], "little") // 16):
        keys += (int.from_bytes(data[i + 12 + 16 * k: i + 16 + 16 * k], "little") & 0x10) > 0
    assert keys == 3
    for start in (5, 13, 17, 25, 11, 23):
        got = native.VideoFile(path_of(name)).read(start, 3, pad=False)
        np.testing.assert_array_equal(frame_hashes(got), want[start: start + 3], err_msg=start)
    mine = native.VideoFile(path_of(name))
    for start in (20, 6, 27, 2):  # back and forth through one handle
        np.testing.assert_array_equal(frame_hashes(mine.read(start, 2, pad=False)),
                                      want[start: start + 2])


def test_yuv420_takes_the_planar_wire():
    """FFV1 in yuv420p is pixel-format class 1, as the reference opens it:
    its planar read equals dali_tpu's, and readers.Video mixed (which ships
    it over the planar YUV wire) equals dali_tpu's cpu and mixed reads."""
    name = "capture/ffv1_v0_420_rice_64x48"
    mine, ref = native.VideoFile(path_of(name)), ref_native.VideoFile(path_of(name))
    assert mine.pixfmt_class == ref.pixfmt_class == 1
    for got, want in zip(mine.read_yuv(3, 5)[:3], ref.read_yuv(3, 5)[:3]):
        np.testing.assert_array_equal(got, want)

    def build(fn, types, device):
        return fn.readers.video(device=device, name="v", filenames=[path_of(name)],
                                sequence_length=4, step=7)
    runs = _run_all(build, 2, 2)
    for key, got in runs.items():
        for it in range(2):
            _assert_same(got[it], runs[("dali_tpu", "cpu")][it], (key, it))


def _slice_chunk(data, frame):
    i = data.find(b"movi")
    for _ in range(frame + 1):
        i = data.find(b"00dc", i + 4)
    return i + 8, int.from_bytes(data[i + 4: i + 8], "little")


def test_bad_slice_crc_raises_value_error():
    """A byte flipped inside a slice of cv2's FFV1 (version 3, slice CRCs):
    FFmpeg conceals the slice with the previous picture, the port raises
    ValueError naming the CRC."""
    data = bytearray(open(path_of("capture/cv2_ffv1_64x48"), "rb").read())
    off, size = _slice_chunk(data, 2)
    data[off + size // 3] ^= 0x10
    with pytest.raises(ValueError, match="FFV1.*CRC"):
        native.VideoFile(bytes(data)).read(0, 6)


@pytest.fixture(scope="module")
def writer():
    from dali_tpu_torch.testdata.make_video_corpus import AviWriter

    try:
        return AviWriter()
    except Exception as e:  # no compiler or FFmpeg headers
        pytest.skip(f"FFmpeg helper unavailable: {e}")


ENCODER_FORMS = {
    "v1_rice_444_large": ("yuv444p", "level=1:coder=rice:context=1", (48, 40)),
    "v3_range_def_420_slices": ("yuv420p", "level=3:coder=range_def:slices=9", (96, 64)),
    "v3_tab_422_no_crc": ("yuv422p", "level=3:coder=range_tab:slicecrc=0:slices=4", (64, 47)),
    "v0_tab_gray": ("gray", "level=0:coder=range_tab", (70, 33)),
    "v3_rice_rgb_gop_1": ("bgr0", "level=3:coder=rice:g=1:slices=4", (40, 30)),
}


@pytest.mark.parametrize("form", sorted(ENCODER_FORMS))
def test_encoder_forms_written_now(tmp_path, writer, form):
    """FFmpeg's ffv1 encoder under other options, written in the test:
    the port's frames equal dali_tpu's, from frame 0 and mid-GOP."""
    from dali_tpu_torch.testdata.make_video_corpus import moving_frames, write_frames

    pixfmt, opts, (w, h) = ENCODER_FORMS[form]
    frames = moving_frames(np.random.default_rng(len(form)), 16, w, h, "drift")
    path = write_frames(writer, str(tmp_path / "v.avi"), frames, "ffv1", pixfmt, opts)
    mine, ref = native.VideoFile(path), ref_native.VideoFile(path)
    assert info(mine) == info(ref)
    np.testing.assert_array_equal(mine.read(0, 16), ref.read(0, 16))
    np.testing.assert_array_equal(native.VideoFile(path).read(14, 2),
                                  ref_native.VideoFile(path).read(14, 2))


@pytest.mark.parametrize("device", ["cpu", "mixed"])
def test_decoder_and_inputs_video_fed_ffv1(device):
    """decoders.Video and experimental.inputs.Video fed cv2's FFV1: dali_tpu's
    frames (the dense RGB path in both packages)."""
    blob = open(path_of("capture/cv2_ffv1_64x48"), "rb").read()
    outs = {}
    for pkg in (dali_tpu, dali_tpu_torch):
        opts = {"device": "cpu"} if pkg is dali_tpu_torch else {"debug": True}

        @pkg.pipeline_def(batch_size=2, num_threads=1, seed=5, **opts)
        def p():
            buf = pkg.fn.external_source(source=lambda: [np.frombuffer(blob, np.uint8)] * 2,
                                         batch=True, cycle=True)
            return pkg.fn.decoders.video(buf, device=device, start_frame=14, sequence_length=5)

        @pkg.pipeline_def(batch_size=2, num_threads=1, seed=5, **opts)
        def q():
            return pkg.fn.experimental.inputs.video(sequence_length=7, name="vin", device=device)
        pipe, pin = p(), q()
        pipe.build()
        pin.build()
        pin.feed_input("vin", blob)
        outs[pkg.__name__] = [pipe.run(), pin.run(), pin.run()]
    for k, (g, w) in enumerate(zip(outs["dali_tpu_torch"], outs["dali_tpu"])):
        _assert_same(g, w, (device, k))
