"""AVI in dali_tpu_torch (ROADMAP Queue 1 item 8b, AVI part): the RIFF
demuxer (``csrc/host/avi_demux.cc``), MPEG-4 Part 2 with B-VOPs and packed
bitstreams and Xvid's IDCT (``mpeg4_decode.cc``), Motion JPEG
(``mjpeg_decode.cc``; 4:2:2, 4:4:4 and grey through the swscale route) and
raw I420, against dali_tpu's FFmpeg 5.1 route. HuffYUV and FFV1 have
files of their own (test_torch_huffyuv.py, test_torch_ffv1.py).

The committed fixtures (``dali_tpu_torch/testdata/video/avi``, written by
``make_video_corpus.py --avi``) and the AVI corpus decode to the frames of
``avi_reference.npz``: FFmpeg's whole-stream decode in display order, with
dali_tpu's ``info()``. Where dali_tpu misplaces frames (a read after a seek
in a stream with B-VOPs: its frame index is the dts of the packet a
picture leaves the decoder with) the port keeps display order, and
``test_reference_misplaces_frames_after_a_seek`` pins the departure. The
operators, cpu and mixed, are bit-equal to dali_tpu's on the files without
B-VOPs and equal to the display-order frames on the others. Streams of
FFmpeg's mpeg4 encoder in AVI with B-VOPs under more tools, and the AVI
forms left to item 8b, come last."""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import dali_tpu  # noqa: E402
import dali_tpu_torch  # noqa: E402
from dali_tpu import native as ref_native  # noqa: E402

from dali_tpu_torch import native  # noqa: E402

from .test_torch_video import _assert_same, _pipe, _run_all, _samples  # noqa: E402
from .write_video_reference import (FIXTURES, FFmpegTools, avi_names,  # noqa: E402
                                    display_order_decode, frame_hashes, yuv420_to_rgb,
                                    yuv_hashes)

REF = np.load(os.path.join(FIXTURES, "avi_reference.npz"))
FIXTURE_NAMES = [n for n in avi_names() if n.startswith("avi/")]
CORPUS_NAMES = [n for n in avi_names() if n.startswith("avi_corpus/")]
# the files with B-VOPs, and how many frames dali_tpu's read after a seek
# lies behind the one asked for (Xvid's packed stream by 3, FFmpeg's by 1)
B_VOP_SHIFT = {"avi/xvid_bf_160x120": 3, "avi/mpeg4_bf_170x98": 1,
               "avi/mpeg4_bf_4mv_160x120": 1}
NO_B_VOPS = [n for n in FIXTURE_NAMES if n not in B_VOP_SHIFT]


def _path(name):
    return os.path.join(FIXTURES, name + ".avi")


@pytest.fixture(scope="module")
def tools():
    try:
        return FFmpegTools()
    except Exception as e:  # no compiler or FFmpeg headers
        pytest.skip(f"FFmpeg helper unavailable: {e}")


def _info(vf):
    return (vf.width, vf.height, vf.num_frames, vf.fps, vf.pixfmt_class)


def _yuv_sha(vf, start, count, stride=1):
    y, u, v, got = vf.read_yuv(start, count, stride, pad=False)
    return yuv_hashes(y[:got], u[:got], v[:got])


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_bit_equal_to_the_reference(name):
    """Every frame in RGB and planar YUV, the frame count, fps and the
    pixel-format class: equal to the committed display-order decode and to
    dali_tpu's info; dali_tpu's own sequential read from frame 0 gives the
    same frames."""
    mine, ref = native.VideoFile(_path(name)), ref_native.VideoFile(_path(name))
    assert _info(mine) == _info(ref) == tuple(REF[name + ":info"].tolist())
    n = mine.num_frames
    rgb = mine.read(0, n, pad=False)
    np.testing.assert_array_equal(frame_hashes(rgb), REF[name + ":rgb_sha"])
    np.testing.assert_array_equal(rgb, ref.read(0, n, pad=False))
    np.testing.assert_array_equal(_yuv_sha(native.VideoFile(_path(name)), 0, n),
                                  REF[name + ":yuv_sha"])


def test_avi_corpus_bit_equal_to_the_reference():
    """The 32 Xvid clips of the card's ``ucf_avi_train`` corpus."""
    assert len(CORPUS_NAMES) == 32
    for name in CORPUS_NAMES:
        vf = native.VideoFile(_path(name))
        assert _info(vf) == tuple(REF[name + ":info"].tolist()), name
        np.testing.assert_array_equal(_yuv_sha(vf, 0, vf.num_frames), REF[name + ":yuv_sha"],
                                      err_msg=name)


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_seeks_read_display_order(name):
    """Reads that seek back and forth through one handle, with strides:
    the display-order frames at every start; dali_tpu's frames too where
    the file has no B-VOPs."""
    want = REF[name + ":yuv_sha"]
    n = len(want)
    mine, ref = native.VideoFile(_path(name)), ref_native.VideoFile(_path(name))
    for start, stride in ((n - 4, 1), (1, 2), (n // 2, 1), (0, 3), (n // 3, 2), (n - 1, 1),
                          (5, 1), (2, 1)):
        got = _yuv_sha(mine, start, 4, stride)
        np.testing.assert_array_equal(got, want[start: start + 4 * stride: stride][:4],
                                      err_msg=str((start, stride)))
        if name in NO_B_VOPS:
            y, u, v, k = ref.read_yuv(start, 4, stride, pad=False)
            np.testing.assert_array_equal(got, yuv_hashes(y[:k], u[:k], v[:k]))


@pytest.mark.parametrize("name", sorted(B_VOP_SHIFT))
def test_reference_misplaces_frames_after_a_seek(name):
    """Pinned departure (ROADMAP Queue 3): dali_tpu numbers a picture by
    the dts of the packet it leaves the decoder with
    (dali_tpu/native/src/video_decode.cc:221-224), so after a seek
    (:264, :335) in a stream with B-VOPs its read(s, 4) returns frames
    s - k ... s + 3 - k: k = 3 for Xvid's packed stream, 1 for FFmpeg's.
    The port returns frames s ... s + 3 of the display order."""
    want = REF[name + ":yuv_sha"]
    k = B_VOP_SHIFT[name]
    for s in (10, 20, 25):
        np.testing.assert_array_equal(_yuv_sha(native.VideoFile(_path(name)), s, 4),
                                      want[s: s + 4])
        np.testing.assert_array_equal(_yuv_sha(ref_native.VideoFile(_path(name)), s, 4),
                                      want[s - k: s - k + 4])
    # from frame 0 both read the display order, tail included
    n = int(REF[name + ":info"][2])
    np.testing.assert_array_equal(_yuv_sha(ref_native.VideoFile(_path(name)), 0, n), want)
    np.testing.assert_array_equal(REF[name + ":ref_rgb_sha"], REF[name + ":rgb_sha"])


def test_packed_tail_and_zero_size_chunks():
    """Xvid's packed stream: 40 chunks (two of them empty, 13 N-VOP
    placeholders) and dwLength 40; FFmpeg shows 38 pictures (the B-VOPs
    packed into the last chunk are never shown), so a read from frame 0
    pads from frame 38 in both packages. A read that starts in that tail
    gets the last shown picture in the port (once: the caller pads the
    rest), where dali_tpu's, after its seek, gets misplaced pictures; so a
    reader's sequence there never fails in either."""
    name = "avi/xvid_bf_160x120"
    want = REF[name + ":rgb_sha"]
    assert len(want) == 38 and REF[name + ":info"][2] == 40
    for pkg in (native, ref_native):
        got = pkg.VideoFile(_path(name)).read(0, 40)
        np.testing.assert_array_equal(frame_hashes(got[:38]), want)
        assert (got[38] == got[37]).all() and (got[39] == got[37]).all()
    got = native.VideoFile(_path(name)).read(38, 2, pad=False)
    np.testing.assert_array_equal(frame_hashes(got), want[37:38])
    assert ref_native.VideoFile(_path(name)).read(38, 2, pad=False).shape[0] >= 1


ENCODER_FORMS = {
    "b_vops_1": "bf=1",
    "b_vops_3_mpeg_quant": "bf=3:mpeg_quant=1",
    "b_vops_4mv_resync_markers": "bf=2:flags=+mv4:ps=120",
    "b_vops_ac_prediction": "bf=2:flags=+aic:g=30",
    "b_vops_no_rounding_p": "bf=2:flags=+mv4:lumi_mask=0.5",
}


@pytest.mark.parametrize("form", sorted(ENCODER_FORMS))
def test_mpeg4_encoder_b_vop_forms_in_avi(tmp_path, tools, form):
    """FFmpeg's mpeg4 encoder in AVI with B-VOPs under other tools: the
    port's frames equal FFmpeg's display-order decode, every frame and
    after seeks."""
    rng = np.random.default_rng(len(form))
    base = cv2.resize(rng.integers(0, 256, (20, 28, 3), np.uint8), (176, 128),
                      interpolation=cv2.INTER_CUBIC)
    frames = []
    for i in range(30):
        m = np.float32([[1, 0, -(3 + 1.7 * i)], [0, 1, -(2 + 0.6 * i)]])
        f = cv2.warpAffine(base, m, (112, 80), borderMode=cv2.BORDER_REFLECT)
        frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420).reshape(-1))
    path = tools.encode(tmp_path / "v.avi", np.stack(frames), 112, 80,
                        opts=ENCODER_FORMS[form], fmt="avi")
    y, u, v = display_order_decode(tools, path)
    want = yuv_hashes(y, u, v)
    mine = native.VideoFile(path)
    assert _info(mine) == _info(ref_native.VideoFile(path))
    np.testing.assert_array_equal(_yuv_sha(mine, 0, 40), want)
    for s in (17, 4, 26):
        np.testing.assert_array_equal(_yuv_sha(mine, s, 3), want[s: s + 3])
    np.testing.assert_array_equal(frame_hashes(native.VideoFile(path).read(0, 40, pad=False)),
                                  frame_hashes(yuv420_to_rgb(y, u, v, False)))


# --------------------------------------------------------------------------- the operators

def _avi_reader(files, **kw):
    def build(fn, types, device):
        out = fn.readers.video(device=device, name="v", filenames=[_path(f) for f in files], **kw)
        return tuple(out) if isinstance(out, (list, tuple)) else out
    return build


READER_CASES = {
    "xvid_stride_step": (dict(files=["avi/xvid_160x120"], sequence_length=4, stride=2,
                              step=5), 2, 3),
    "mjpeg_no_dht_edge_pad": (dict(files=["avi/mjpeg_nodht_160x120"], sequence_length=5, step=4,
                                   pad_mode="edge"), 2, 3),
    "mjpeg_reflect_pad": (dict(files=["avi/mjpeg_160x120"], sequence_length=6, step=5,
                               pad_mode="reflect_101", enable_frame_num=True), 2, 2),
    "raw_i420_constant_pad": (dict(files=["avi/raw_i420_64x48"], sequence_length=4, step=3,
                                   pad_mode="constant", fill_value=[7, 8, 9]), 1, 3),
    "no_index_and_cv2_shuffled": (dict(files=["avi/noindex_xvid_160x120", "avi/cv2_xvid_64x48",
                                              "avi/cv2_mjpg_64x48"], labels=[0, 1, 2],
                                       sequence_length=3, random_shuffle=True), 3, 3),
}


@pytest.mark.parametrize("case", sorted(READER_CASES))
def test_reader_matches_dali_tpu(case):
    """readers.Video, cpu and mixed, on the files without B-VOPs: bit-equal
    to dali_tpu's cpu and mixed placements."""
    kw, batch, iters = READER_CASES[case]
    runs = _run_all(_avi_reader(**kw), batch, iters)
    want = runs[("dali_tpu", "cpu")]
    for key, got in runs.items():
        for it in range(iters):
            _assert_same(got[it], want[it], (case, key, it))


@pytest.mark.parametrize("device", ["cpu", "mixed"])
def test_reader_b_vops_display_order(device):
    """readers.Video over the files with B-VOPs, shuffled, with a stride:
    each sequence holds the display-order frames from its frame number on,
    on the cpu and on the planar wire."""
    names = sorted(B_VOP_SHIFT)
    pipe = _pipe(dali_tpu_torch, _avi_reader(names, labels=[0, 1, 2], sequence_length=4,
                                             stride=2, step=3, random_shuffle=True,
                                             enable_frame_num=True), 3, device)
    seen = 0
    for _ in range(4):
        seqs, labels, nums = (_samples(o) for o in pipe.run())
        for seq, label, num in zip(seqs, labels, nums):
            want = REF[names[int(label.reshape(-1)[0])] + ":rgb_sha"]
            f0 = int(num.reshape(-1)[0])
            np.testing.assert_array_equal(frame_hashes(seq), want[f0: f0 + 8: 2])
            seen += 1
    pipe.shutdown()
    assert seen == 12


def test_reader_file_root_of_avi_classes(tmp_path):
    """file_root over class directories of AVI files (every file whatever
    its extension, as UCF101's tree is read), with a label per class."""
    for cls, names in (("a", ["avi/xvid_160x120", "avi/raw_i420_64x48"]),
                       ("b", ["avi/mjpeg_nodht_160x120"])):
        os.makedirs(tmp_path / cls)
        for n in names:
            os.symlink(_path(n), tmp_path / cls / os.path.basename(_path(n)))

    def build(fn, types, device):
        return tuple(fn.readers.video(device=device, name="v", file_root=str(tmp_path),
                                      sequence_length=3, random_shuffle=True))
    runs = _run_all(build, 2, 3)
    want = runs[("dali_tpu", "cpu")]
    for key, got in runs.items():
        for it in range(3):
            _assert_same(got[it], want[it], (key, it))


def test_video_resize_reader_on_avi():
    """readers.VideoResize (and its VideoReaderResize alias), cpu and mixed,
    on Motion JPEG and Xvid files: dali_tpu's frames."""
    files = [_path("avi/mjpeg_160x120"), _path("avi/xvid_160x120")]
    got = {}
    for pkg in (dali_tpu, dali_tpu_torch):
        for device in ("cpu", "mixed"):
            def build(fn, types, device=device):
                return tuple(fn.readers.video_resize(device=device, filenames=files,
                                                     labels=[0, 1], sequence_length=3, step=7,
                                                     resize_x=72, resize_y=40, name="v"))
            pipe = _pipe(pkg, build, 2, device)
            got[(pkg.__name__, device)] = [pipe.run() for _ in range(2)]
            if hasattr(pipe, "shutdown"):
                pipe.shutdown()
    want = got[("dali_tpu", "cpu")]
    for key, outs in got.items():
        for it, (g, w) in enumerate(zip(outs, want)):
            _assert_same(g, w, (key, it))


@pytest.mark.parametrize("device", ["cpu", "mixed"])
def test_decoder_fed_avi_bytes(device):
    """decoders.Video and experimental.decoders.Video fed the bytes of AVI
    files (the reference writes them to a temporary file FFmpeg opens by
    its content): dali_tpu's frames; and the display-order frames of an
    Xvid file with B-VOPs."""
    blobs = [np.frombuffer(open(_path(n), "rb").read(), np.uint8)
             for n in ("avi/raw_i420_64x48", "avi/cv2_mjpg_64x48")]
    outs = {}
    for pkg in (dali_tpu, dali_tpu_torch):
        def build(fn, types, device=device):
            buf = fn.external_source(source=lambda: blobs, batch=True, cycle=True)
            return (fn.decoders.video(buf, device=device, sequence_length=6, pad_mode="edge"),
                    fn.experimental.decoders.video(buf, device=device, start_frame=2,
                                                   sequence_length=4, stride=2))
        pipe = _pipe(pkg, build, 2, device)
        outs[pkg.__name__] = [pipe.run() for _ in range(2)]
        if hasattr(pipe, "shutdown"):
            pipe.shutdown()
    for it in range(2):
        _assert_same(outs["dali_tpu_torch"][it], outs["dali_tpu"][it], (device, it))
    blob = np.frombuffer(open(_path("avi/xvid_bf_160x120"), "rb").read(), np.uint8)

    def build(fn, types):
        buf = fn.external_source(source=lambda: [blob], batch=True, cycle=True)
        return fn.decoders.video(buf, device=device, start_frame=9, sequence_length=5)
    pipe = _pipe(dali_tpu_torch, lambda fn, types, d: build(fn, types), 1, device)
    got = _samples(pipe.run()[0])[0]
    pipe.shutdown()
    np.testing.assert_array_equal(frame_hashes(got), REF["avi/xvid_bf_160x120:rgb_sha"][9:14])


@pytest.mark.parametrize("policy", ["partial", "pad"])
def test_inputs_video_fed_avi(policy):
    """experimental.inputs.Video fed an Xvid and a Motion JPEG file without
    B-VOPs, one after the other: dali_tpu's batches, cpu and mixed."""
    blobs = [open(_path("avi/cv2_xvid_64x48"), "rb").read(),
             open(_path("avi/mjpeg_nodht_160x120"), "rb").read()]
    got = {}
    for pkg in (dali_tpu, dali_tpu_torch):
        for device in ("cpu", "mixed"):
            def build(fn, types, device=device):
                return fn.experimental.inputs.video(sequence_length=5, name="vin", device=device,
                                                    last_sequence_policy=policy)
            pipe = _pipe(pkg, build, 2, device)
            for blob in blobs:
                pipe.feed_input("vin", blob)
            got[(pkg.__name__, device)] = [pipe.run() for _ in range(3)]
            if hasattr(pipe, "shutdown"):
                pipe.shutdown()
    want = got[("dali_tpu", "cpu")]
    for key, outs in got.items():
        for k, (g, w) in enumerate(zip(outs, want)):
            _assert_same(g, w, (policy, key, k))


# --------------------------------------------------------------------------- the swscale route

from .test_torch_huffyuv import CAP, check_fixture, check_seeks, names_of  # noqa: E402

MJPEG_CAPTURE = names_of("mjpeg_")
CAPTURE_CORPUS = [n for n in names_of("") if n.startswith("capture_corpus/")]


@pytest.mark.parametrize("name", MJPEG_CAPTURE)
def test_mjpeg_sampling_bit_equal_to_the_reference(name):
    """Motion JPEG 4:2:2 (FFmpeg's encoder writes luma 2x2, chroma 1x2), at
    an even and an odd height, 4:4:4 and grey: pixel-format class 0, every
    frame libswscale's RGB24 of FFmpeg's planes, from frame 0 and after
    seeks."""
    check_fixture(name)
    check_seeks(name)


def test_capture_corpus_bit_equal_to_the_reference():
    """The card's capture_avi_train corpus: 320x240 HuffYUV 4:2:2, cv2's
    FFV1 and Motion JPEG 4:2:2 clips, every frame's RGB hash and info."""
    assert len(CAPTURE_CORPUS) == 30
    for name in CAPTURE_CORPUS:
        vf = native.VideoFile(_path(name))
        assert _info(vf) == tuple(CAP[name + ":info"].tolist()), name
        assert vf.pixfmt_class == 0
        np.testing.assert_array_equal(frame_hashes(vf.read(0, vf.num_frames, pad=False)),
                                      CAP[name + ":rgb_sha"], err_msg=name)


def test_reader_over_capture_corpus():
    """readers.Video, cpu and mixed, over the capture corpus's class
    folders (file_root), shuffled, edge padding: class 0 takes the dense
    RGB path in both packages, bit-equal to dali_tpu's."""
    root = os.path.join(FIXTURES, "capture_corpus")

    def build(fn, types, device):
        return tuple(fn.readers.video(device=device, name="v", file_root=root,
                                      sequence_length=3, stride=2, step=5, random_shuffle=True,
                                      pad_mode="edge"))
    runs = _run_all(build, 2, 2)
    want = runs[("dali_tpu", "cpu")]
    for key, got in runs.items():
        for it in range(2):
            _assert_same(got[it], want[it], (key, it))


@pytest.mark.parametrize("device", ["cpu", "mixed"])
def test_decoder_fed_capture_bytes(device):
    """decoders.Video and experimental.decoders.Video fed the bytes of a
    Motion JPEG 4:2:2, a grey Motion JPEG and a HuffYUV RGBA file:
    dali_tpu's frames."""
    blobs = [np.frombuffer(open(_path(n), "rb").read(), np.uint8)
             for n in ("capture/mjpeg_422_66x47", "capture/mjpeg_gray_64x48",
                       "capture/hfyu_rgba_left_64x48")]
    outs = {}
    for pkg in (dali_tpu, dali_tpu_torch):
        def build(fn, types, device=device):
            buf = fn.external_source(source=lambda: blobs, batch=True, cycle=True)
            return (fn.decoders.video(buf, device=device, sequence_length=4, pad_mode="edge"),
                    fn.experimental.decoders.video(buf, device=device, start_frame=3,
                                                   sequence_length=3, stride=2))
        pipe = _pipe(pkg, build, 3, device)
        outs[pkg.__name__] = [pipe.run() for _ in range(2)]
        if hasattr(pipe, "shutdown"):
            pipe.shutdown()
    for it in range(2):
        _assert_same(outs["dali_tpu_torch"][it], outs["dali_tpu"][it], (device, it))


# --------------------------------------------------------------------------- item 8b

def _h264_avi(path):
    """H.264 in AVI, by libx264 through the AVI helper (MPEG-1/2, once this
    form, reads since part (a) of item 8b)."""
    from dali_tpu_torch.testdata.make_video_corpus import AviWriter, moving_frames

    try:
        wr = AviWriter()
    except Exception as e:  # no compiler or FFmpeg headers
        pytest.skip(f"FFmpeg helper unavailable: {e}")
    return wr.write(str(path), moving_frames(np.random.default_rng(3), 6, 64, 48, "pan"),
                    "libx264", opts="bf=0")


# the forms of AVI left to item 8b: what writes them, what the message names
LEFT_FORMS = {
    "HuffYUV-HFYU": (lambda tmp: _path("capture/ffvh_422p10_64x48"), "HuffYUV at 10 bits"),
    "FFV1-FFV1": (lambda tmp: _path("capture/ffv1_422p10_64x48"), "FFV1 at 10 bits"),
    "H.264-libx264": (lambda tmp: _h264_avi(tmp / "v.avi"), "H.264 video in AVI"),
    "MJPEG-fields": (lambda tmp: _path("capture/mjpeg_fields_64x48"),
                     "interlaced .two-field. Motion JPEG"),
}


@pytest.mark.parametrize("form", list(LEFT_FORMS))
def test_avi_codecs_left_to_item_8b_raise(tmp_path, form):
    """The AVI forms still left to item 8b: HuffYUV and FFV1 beyond 8 bits
    (the committed 10-bit FFVH and FFV1; 8-bit HuffYUV and FFV1 decode since
    the swscale route came), H.264 (MPEG-1, this case before, decodes since
    part (a) of item 8b) and interlaced two-field Motion JPEG.
    The reference reads them, the port raises NotImplementedError naming
    the form and item 8b, at open and through the reader."""
    write, what = LEFT_FORMS[form]
    path = write(tmp_path)
    assert ref_native.VideoFile(path).read(0, 3).shape == (3, 48, 64, 3)
    with pytest.raises(NotImplementedError, match=f"{what}.*item 8b"):
        native.VideoFile(path)

    def build(fn, types, device):
        return fn.readers.video(device=device, filenames=[path], sequence_length=2)
    with pytest.raises(NotImplementedError, match="item 8b"):
        _pipe(dali_tpu_torch, build, 1, "cpu").run()


@pytest.mark.parametrize("form,opts,what", [("quarter_sample", "bf=2:flags=+qpel",
                                             "quarter-sample"),
                                            ("interlaced", "flags=+ildct+ilme", "interlaced")])
def test_mpeg4_tools_left_to_item_8b_raise_in_avi(tmp_path, tools, form, opts, what):
    """Quarter-sample motion and interlaced MPEG-4 in AVI: FFmpeg decodes
    them, the port raises naming the tool and item 8b."""
    yuv = np.random.default_rng(4).integers(0, 256, (8, 64 * 48 * 3 // 2), np.uint8)
    path = tools.encode(tmp_path / f"{form}.avi", yuv, 64, 48, opts=opts, fmt="avi")
    assert ref_native.VideoFile(path).read(0, 3).shape == (3, 48, 64, 3)
    with pytest.raises(NotImplementedError, match=f"{what}.*item 8b"):
        native.VideoFile(path).read(0, 3)


@pytest.mark.parametrize("opts,what", [("gmc=1", "GMC"), ("flags=+qpel", "quarter-sample")])
def test_xvid_gmc_and_quarter_sample_raise_item_8b(tmp_path, opts, what):
    """Xvid's global motion compensation (S-VOPs) and quarter-sample
    motion, written by libxvid: FFmpeg decodes them, the port raises naming
    the tool and item 8b at open."""
    from dali_tpu_torch.testdata.make_video_corpus import AviWriter, moving_frames

    try:
        wr = AviWriter()
    except Exception as e:  # no compiler or FFmpeg headers
        pytest.skip(f"FFmpeg helper unavailable: {e}")
    path = wr.write(str(tmp_path / "v.avi"), moving_frames(np.random.default_rng(1), 10, 64, 48,
                                                           "zoom"), "libxvid", opts=opts)
    assert ref_native.VideoFile(path).read(0, 3).shape == (3, 48, 64, 3)
    with pytest.raises(NotImplementedError, match=f"{what}.*item 8b"):
        native.VideoFile(path)


def test_damaged_avi_raises_value_error():
    """The third Motion JPEG frame without its SOI marker and an AVI cut
    inside its headers: the port names the damage (ValueError) and the
    codec."""
    data = bytearray(open(_path("avi/mjpeg_160x120"), "rb").read())
    i = data.find(b"movi")
    for _ in range(3):
        i = data.find(b"00dc", i + 4)
    data[i + 8: i + 10] = b"\0\0"
    with pytest.raises(ValueError, match="Motion JPEG"):
        native.VideoFile(bytes(data)).read(0, 16)
    with pytest.raises(ValueError):
        native.VideoFile(bytes(data[:100]))
