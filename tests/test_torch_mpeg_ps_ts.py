"""MPEG program and transport streams in dali_tpu_torch (ROADMAP Queue 1
item 8b(a)): the MPEG-PS and MPEG-TS demuxers (``csrc/host/mpeg_ps_demux.cc``,
``mpeg_ts_demux.cc``), raw MPEG-1/2 elementary streams and MPEG-1/2 in AVI,
with the MPEG-1/2 decoder (``mpeg12_decode.cc``), against dali_tpu's FFmpeg
5.1 route.

The committed fixtures (``dali_tpu_torch/testdata/video/mpeg``, written by
``make_video_corpus.py --mpeg``) and the ``mpeg_ts_train`` corpus decode to
the frames of ``mpeg_reference.npz`` and of the live ``dali_tpu`` read from
frame 0, with its ``info()``: the frame count too, which in PS and TS is
libavformat's duration estimate from the PES timestamps of the file's tail
(short of the frames a PS holds). Where dali_tpu misplaces frames (after a
backward seek in PS and TS, or a seek past 64 frames, it lands one GOP late;
in AVI it numbers MPEG-1/2 pictures one frame early) the port reads the
display order, and tests pin the departures. The operators, cpu and mixed,
are bit-equal to dali_tpu's where its handles only move forward. The port's
counterpart of the reference's spliced-TS test closes the file."""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import dali_tpu  # noqa: E402
import dali_tpu_torch  # noqa: E402
from dali_tpu import native as ref_native  # noqa: E402

from dali_tpu_torch import native  # noqa: E402

from .test_torch_video import _assert_same, _pipe, _run_all, _samples  # noqa: E402
from .write_video_reference import FIXTURES, frame_hashes, mpeg_names, yuv_hashes  # noqa: E402

REF = np.load(os.path.join(FIXTURES, "mpeg_reference.npz"))
FIXTURE_NAMES = [n for n in mpeg_names() if n.startswith("mpeg/")]
CORPUS_NAMES = [n for n in mpeg_names() if n.startswith("mpeg_corpus/")]
SEEKABLE = [n for n in FIXTURE_NAMES if n + ":display_sha" in REF.files]


def _path(name):
    return os.path.join(FIXTURES, name)


def _info(vf):
    return (vf.width, vf.height, vf.num_frames, vf.fps, vf.pixfmt_class)


def _yuv_sha(vf, start, count, stride=1):
    y, u, v, got = vf.read_yuv(start, count, stride, pad=False)
    return yuv_hashes(y[:got], u[:got], v[:got])


def _frames(name):
    """The frames a read from frame 0 takes: the frame count, or for a raw
    elementary stream (which counts none) every frame."""
    return len(REF[name + ":rgb_sha"])


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_bit_equal_to_the_reference(name):
    """Every frame in RGB and planar YUV from frame 0, the frame count, fps
    and the pixel-format class: equal to the committed reference and to
    dali_tpu's live read."""
    mine, ref = native.VideoFile(_path(name)), ref_native.VideoFile(_path(name))
    assert _info(mine) == _info(ref) == tuple(REF[name + ":info"].tolist())
    n = _frames(name)
    rgb = mine.read(0, n, pad=False)
    np.testing.assert_array_equal(frame_hashes(rgb), REF[name + ":rgb_sha"])
    np.testing.assert_array_equal(rgb, ref.read(0, n, pad=False))
    if name + ":yuv_sha" in REF.files:
        np.testing.assert_array_equal(_yuv_sha(native.VideoFile(_path(name)), 0, n),
                                      REF[name + ":yuv_sha"])


@pytest.mark.parametrize("name", [n for n in SEEKABLE
                                  if not n.endswith((".avi", ".m1v", ".m2v"))])
def test_new_handle_reads_into_open_gops(name):
    """A new handle's reads that start in the leading B-pictures of an open
    GOP (frames 10-11 and 22-23 before the I-pictures at 12 and 24 of cv2's
    and FFmpeg's GOP of 12), which dali_tpu reaches decoding forward: its
    frames, FFmpeg's display order, in both packages."""
    want = REF[name + ":display_sha"]
    for s in (10, 11, 22, 23):
        if s + 3 > len(REF[name + ":rgb_sha"]):
            continue
        got = _yuv_sha(native.VideoFile(_path(name)), s, 3)
        np.testing.assert_array_equal(got, want[s: s + 3], err_msg=str(s))
        np.testing.assert_array_equal(got, _yuv_sha(ref_native.VideoFile(_path(name)), s, 3),
                                      err_msg=str(s))


def test_mpeg_corpus_bit_equal_to_the_reference():
    """The 32 clips of the card's ``mpeg_ts_train`` corpus: 16 MPEG-2 TS
    and 16 MPEG-1 PS clips of cv2's, every frame and info."""
    assert len(CORPUS_NAMES) == 32
    for name in CORPUS_NAMES:
        vf = native.VideoFile(_path(name))
        assert _info(vf) == tuple(REF[name + ":info"].tolist()), name
        np.testing.assert_array_equal(_yuv_sha(vf, 0, vf.num_frames), REF[name + ":yuv_sha"],
                                      err_msg=name)


@pytest.mark.parametrize("name", SEEKABLE)
def test_seeks_read_display_order(name):
    """Reads that seek back and forth through one handle, with strides,
    into the leading B-pictures of open GOPs too: FFmpeg's display-order
    frames at every start. A raw elementary stream has no timestamps, and
    the reference numbers its frames by the ones libavformat makes up (a
    B-picture's from its place in decoding order): there the port reads at
    every start the frames dali_tpu's new handle reads."""
    want = REF[name + ":display_sha"]
    n = len(want)
    raw = name.endswith((".m1v", ".m2v"))
    mine = native.VideoFile(_path(name))
    for start, stride in ((n - 4, 1), (1, 2), (n // 2, 1), (0, 3), (n // 3, 2), (13, 1),
                          (n - 1, 1), (5, 1), (2, 1), (25 % n, 1), (11, 1)):
        got = _yuv_sha(mine, start, 4, stride)
        expect = (_yuv_sha(ref_native.VideoFile(_path(name)), start, 4, stride) if raw
                  else want[start: start + 4 * stride: stride][:len(got)])
        np.testing.assert_array_equal(got, expect, err_msg=str((start, stride)))
        assert len(got) >= 1


@pytest.mark.parametrize("name", ["mpeg/cv2_mpg2_160x120.ts", "mpeg/cv2_mpeg_160x120.mpg"])
def test_reference_misplaces_frames_after_a_backward_seek(name):
    """Pinned departure (ROADMAP Queue 3): in MPEG-TS and MPEG-PS,
    dali_tpu's seek (av_seek_frame backward,
    dali_tpu/native/src/video_decode.cc:255-268) lands one GOP late and its
    read takes the first frame at or past the target (:273): on a handle
    that has read frames 20-22, read(0, 3) returns frames 12-14 and then
    read(13, 3) frames 24-26. The port reads frames 0-2 and 13-15."""
    want = REF[name + ":display_sha"]
    mine, ref = native.VideoFile(_path(name)), ref_native.VideoFile(_path(name))
    for vf in (mine, ref):
        np.testing.assert_array_equal(_yuv_sha(vf, 20, 3), want[20:23])
    np.testing.assert_array_equal(_yuv_sha(mine, 0, 3), want[0:3])
    np.testing.assert_array_equal(_yuv_sha(ref, 0, 3), want[12:15])
    np.testing.assert_array_equal(_yuv_sha(mine, 13, 3), want[13:16])
    np.testing.assert_array_equal(_yuv_sha(ref, 13, 3), want[24:27])


def test_reference_seek_past_64_frames_lands_a_gop_late():
    """Pinned departure: a read more than 64 frames ahead of a new handle
    seeks, and dali_tpu's seek lands one GOP late (GOP 12): read(66, 4)
    returns frames 72-75. The port reads frames 66-69."""
    name = "mpeg/mpeg2_long_96x64.ts"
    want = REF[name + ":display_sha"]
    np.testing.assert_array_equal(_yuv_sha(native.VideoFile(_path(name)), 66, 4), want[66:70])
    np.testing.assert_array_equal(_yuv_sha(ref_native.VideoFile(_path(name)), 66, 4),
                                  want[72:76])


@pytest.mark.parametrize("name", ["mpeg/cv2_pim1_160x120.avi", "mpeg/mpeg2_bf2_64x48.avi"])
def test_reference_numbers_mpeg_in_avi_one_frame_early(name):
    """Pinned departure: AVI stores no presentation times and dali_tpu
    numbers an MPEG-1/2 picture by the dts of the packet it leaves the
    decoder with, one frame behind (B-pictures or not): a new handle's
    read(5, 4) returns frames 4-7. The port reads frames 5-8; from frame 0
    both read the display order."""
    want = REF[name + ":display_sha"]
    np.testing.assert_array_equal(_yuv_sha(native.VideoFile(_path(name)), 5, 4), want[5:9])
    np.testing.assert_array_equal(_yuv_sha(ref_native.VideoFile(_path(name)), 5, 4), want[4:8])
    np.testing.assert_array_equal(REF[name + ":yuv_sha"], want[: len(REF[name + ":yuv_sha"])])


def test_ps_frame_count_is_libavformats_estimate():
    """In MPEG-PS, libavformat counts frames from the PES timestamps of the
    file's tail (a PES packet of 2048 bytes holds several small pictures,
    its PTS only the first's): cv2's 40-frame MPEG-1 and MPEG-2 programs
    count 38 and 39, FFmpeg's small MPEG-1 one 20 of 30; the TS counts all
    40. Both packages count alike, and a read from frame 0 stops there."""
    counts = {"mpeg/cv2_mpg1_160x120.mpg": 38, "mpeg/cv2_mpeg_160x120.mpg": 39,
              "mpeg/mpeg1_bf2_64x48.mpg": 20, "mpeg/cv2_mpg2_160x120.ts": 40}
    for name, n in counts.items():
        assert native.VideoFile(_path(name)).num_frames == n, name
        assert ref_native.VideoFile(_path(name)).num_frames == n, name
        assert len(REF[name + ":display_sha"]) >= n


# --------------------------------------------------------------------------- F10: cut mid-stream

# F10's fixtures: cut at every TS packet (188 bytes) or 2048-byte PS pack
# boundary, and at a few offsets on no boundary
CUT_FIXTURES = {"mpeg_corpus/ts/ts_00.ts": 188, "mpeg/cv2_mpg2_160x120.ts": 188,
                "mpeg_corpus/ps/ps_00.mpg": 2048, "mpeg/cv2_mpeg_160x120.mpg": 2048}
CUT_PARTS = 3


def _cuts(name, part):
    unit = CUT_FIXTURES[name]
    size = os.path.getsize(_path(name))
    cuts = list(range(unit, size, unit)) + list(range(unit // 3 + 7, size, 1777))
    return cuts[part::CUT_PARTS]


def _planes(vf):
    """Every frame a read from frame 0 gets, as planar YUV hashes."""
    return _yuv_sha(vf, 0, vf.num_frames + 2) if vf.num_frames else np.zeros((0, 32), np.uint8)


@pytest.mark.parametrize("part", range(CUT_PARTS))
@pytest.mark.parametrize("name", sorted(CUT_FIXTURES))
def test_stream_cut_mid_way_reads_as_the_reference(tmp_path, name, part):
    """F10 (ROADMAP Queue 3): a TS or PS cut mid-stream, as a broadcast
    capture started mid-programme or a split file is, opens as dali_tpu
    opens it. libavformat finds the format by its probe scores (mpegps_probe,
    mpegts_probe: a cut file starts with no pack header, or off the TS
    sync), scans the first 5 MB for the program tables then reads from the
    first PES start, gives the decoder the first sequence header it finds as
    extradata (so the pictures before it decode with it), takes the first
    PTS as the start time and estimates the duration from the tail's
    timestamps. Every cut: the info and every frame equal, from a path and
    from memory; where the reference fails to open the cut, the port raises
    ValueError."""
    data = open(_path(name), "rb").read()
    path = tmp_path / ("cut" + os.path.splitext(name)[1])
    opened = 0
    for cut in _cuts(name, part):
        path.write_bytes(data[cut:])
        try:
            ref = ref_native.VideoFile(str(path))
        except ValueError:
            for src in (str(path), data[cut:]):
                with pytest.raises(ValueError):
                    native.VideoFile(src)
            continue
        want = _planes(ref)
        for src in (str(path), data[cut:]):
            mine = native.VideoFile(src)
            assert _info(mine) == _info(ref), cut
            np.testing.assert_array_equal(_planes(mine), want, err_msg=str(cut))
        opened += 1
    assert opened >= 5


@pytest.mark.parametrize("name,cut", [("mpeg_corpus/ts/ts_00.ts", 37 * 188),
                                      ("mpeg_corpus/ts/ts_00.ts", 101 * 188),
                                      ("mpeg_corpus/ps/ps_00.mpg", 9 * 2048),
                                      ("mpeg_corpus/ps/ps_00.mpg", 20 * 2048)])
def test_f10_cuts_it_was_found_on(name, cut):
    """The cuts F10 was found on: dali_tpu counts 45, 38, 33 and 19 frames
    and reads them; the port, which raised ValueError, gives the same
    count, fps and RGB frames."""
    data = open(_path(name), "rb").read()[cut:]
    mine = native.VideoFile(data)
    assert mine.num_frames == {37 * 188: 45, 101 * 188: 38, 9 * 2048: 33, 20 * 2048: 19}[cut]
    got = mine.read(0, 4)
    assert got.shape == (4, 240, 320, 3)
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=os.path.splitext(name)[1]) as f:
        f.write(data)
        f.flush()
        ref = ref_native.VideoFile(f.name)
        assert _info(mine) == _info(ref)
        np.testing.assert_array_equal(got, ref.read(0, 4))


@pytest.mark.parametrize("form", ["cv2_fmp4", "mpeg4_bf2"])
def test_mpeg4_ts_cut_mid_stream_reads_as_the_reference(tmp_path, form):
    """F10 in MPEG-4 Part 2 in TS: cut at every third TS packet. The VOL
    comes from the first packet with headers before its VOP, as
    libavformat's extract_extradata takes it; the P-VOPs before the first
    I-VOP are predicted from FFmpeg's grey dummy picture (0x80 over the
    frame, zeros below it in the macroblock rows), which a stream with
    B-VOPs also shows, as of the first P-VOP's packet. cv2's FMP4 (no
    B-VOPs) and FFmpeg's mpeg4 with two B-frames: dali_tpu's info and
    frames."""
    from dali_tpu_torch.testdata.make_video_corpus import AviWriter, moving_frames

    frames = moving_frames(np.random.default_rng(4), 60, 96, 64, "drift")
    src = tmp_path / "src.ts"
    if form == "cv2_fmp4":
        wr = cv2.VideoWriter(str(src), cv2.VideoWriter_fourcc(*"FMP4"), 25, (96, 64))
        if not wr.isOpened():
            pytest.skip("cv2 cannot write FMP4 into TS")
        for f in frames:
            wr.write(f)
        wr.release()
    else:
        try:
            AviWriter().write(str(src), frames, "mpeg4", opts="bf=2", muxer="mpegts")
        except Exception as e:  # no compiler or FFmpeg headers
            pytest.skip(f"FFmpeg helper unavailable: {e}")
    data = src.read_bytes()
    path = tmp_path / "cut.ts"
    opened = 0
    for cut in range(188, len(data), 3 * 188):
        path.write_bytes(data[cut:])
        try:
            ref = ref_native.VideoFile(str(path))
        except ValueError:
            with pytest.raises(ValueError):
                native.VideoFile(data[cut:])
            continue
        mine = native.VideoFile(data[cut:])
        assert _info(mine) == _info(ref), cut
        np.testing.assert_array_equal(_planes(mine), _planes(ref), err_msg=str(cut))
        opened += 1
    assert opened >= 20


def test_ps_cut_the_reference_reads_as_an_elementary_stream_departs(tmp_path):
    """Pinned departure (ROADMAP Queue 3): FFmpeg's small MPEG-1 program
    cut two packs in leaves 2 KiB, on which libavformat's probe gives the
    raw video demuxer (mpegvideo_probe) a higher score than the program
    stream's, and dali_tpu (dali_tpu/native/src/video_decode.cc:133-136)
    reads the packs as one elementary stream. The port reads MPEG-PS by
    its packets only and raises ValueError."""
    data = open(_path("mpeg/mpeg1_bf2_64x48.mpg"), "rb").read()[4096:]
    path = tmp_path / "cut.mpg"
    path.write_bytes(data)
    ref = ref_native.VideoFile(str(path))
    assert ref.fps == 25.0 and len(ref.read(0, 4, pad=False)) >= 1
    with pytest.raises(ValueError):
        native.VideoFile(data)


# --------------------------------------------------------------------------- the spliced TS

def _write_ts(path, w, h, num_frames, seed):
    """One MPEG-TS segment by cv2 (``mpg2``); TS is byte-concatenable."""
    rng = np.random.default_rng(seed)
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mpg2"), 25, (w, h))
    if not wr.isOpened():
        return None
    for _ in range(num_frames):
        wr.write(rng.integers(0, 255, (h, w, 3), np.uint8))
    wr.release()
    return str(path) if os.path.getsize(path) > 0 else None


def test_real_midstream_reconfiguration_spliced_ts(tmp_path):
    """The counterpart of the reference's spliced-TS test
    (tests/test_video_yuv_wire.py): two cv2 TS segments of different sizes
    byte-concatenated. The open-time contract is the first segment's; the
    planar read raises VideoPixfmtChanged after the frames before the
    splice (the second segment's sequence header drops the held anchor, as
    FFmpeg's decoder does); the mixed pipeline falls back to the dense path
    and stays bit-equal to cpu, and to dali_tpu's."""
    a = _write_ts(tmp_path / "a.ts", 64, 48, 10, seed=50)
    b = _write_ts(tmp_path / "b.ts", 32, 24, 10, seed=51)
    if not (a and b):
        pytest.skip("cv2 build cannot write MPEG-TS")
    spliced = tmp_path / "ab.ts"
    spliced.write_bytes(open(a, "rb").read() + open(b, "rb").read())
    got = {}
    for pkg in (native, ref_native):
        vf = pkg.VideoFile(str(spliced))
        assert (vf.width, vf.height) == (64, 48)
        assert vf.pixfmt_class == 1
        with pytest.raises(pkg.VideoPixfmtChanged) as ei:
            vf.read_yuv(0, 20, 1, pad=True)
        assert 0 < ei.value.got < 20
        got[pkg.__name__] = ei.value.got
        vf.close()
    assert got["dali_tpu_torch.native"] == got["dali_tpu.native"] == 9
    blob = open(spliced, "rb").read()

    def make(pkg, device):
        def build(fn, types, device):
            buf = fn.external_source(source=lambda: [np.frombuffer(blob, np.uint8)], batch=True,
                                     cycle=True)
            return fn.decoders.video(buf, sequence_length=20, device=device)
        return _pipe(pkg, build, 1, device)

    outs = {}
    for pkg in (dali_tpu, dali_tpu_torch):
        for device in ("cpu", "mixed"):
            pipe = make(pkg, device)
            outs[(pkg.__name__, device)] = np.asarray(_samples(pipe.run()[0])[0])
            if hasattr(pipe, "shutdown"):
                pipe.shutdown()
    want = outs[("dali_tpu", "cpu")]
    for key, x in outs.items():
        assert x.shape == want.shape, key
        np.testing.assert_array_equal(x, want, err_msg=str(key))


def test_committed_splice_against_the_reference():
    """The committed splice (two cv2 segments, 64x48 then 32x24): the RGB
    read ends at the size change after 9 frames, the planar read raises
    VideoPixfmtChanged there, in both packages."""
    name = "mpeg/spliced_64x48_32x24.ts"
    assert len(REF[name + ":rgb_sha"]) == 9
    np.testing.assert_array_equal(frame_hashes(native.VideoFile(_path(name)).read(0, 20,
                                                                                 pad=False)),
                                  REF[name + ":rgb_sha"])
    with pytest.raises(native.VideoPixfmtChanged) as ei:
        native.VideoFile(_path(name)).read_yuv(0, 20, pad=False)
    assert ei.value.got == int(REF[name + ":yuv_changed_at"][0])


# --------------------------------------------------------------------------- the operators

def _reader(files, **kw):
    def build(fn, types, device):
        out = fn.readers.video(device=device, name="v", filenames=[_path(f) for f in files], **kw)
        return tuple(out) if isinstance(out, (list, tuple)) else out
    return build


READER_CASES = {
    "ts_mpeg2_stride_step": (dict(files=["mpeg/cv2_mpg2_160x120.ts"], sequence_length=4,
                                  stride=2, step=8), 2, 2),
    "ps_mpeg1_edge_pad": (dict(files=["mpeg/cv2_mpg1_160x120.mpg"], sequence_length=5, step=7,
                               pad_mode="edge", enable_frame_num=True), 2, 2),
    "vob_and_ts_labels": (dict(files=["mpeg/mpeg2_dvd_64x48.vob", "mpeg/mpeg2_odd_170x98.ts"],
                               labels=[3, 4], sequence_length=3, step=6), 2, 3),
    "interlaced_and_matrices": (dict(files=["mpeg/mpeg2_interlaced_64x48.ts",
                                            "mpeg/mpeg2_matrices_64x48.ts"], sequence_length=4,
                                     step=9), 2, 2),
    "mpeg2_422_dense_path": (dict(files=["mpeg/mpeg2_422_64x48.ts"], sequence_length=3,
                                  step=8), 1, 3),
}


@pytest.mark.parametrize("case", sorted(READER_CASES))
def test_reader_matches_dali_tpu(case):
    """readers.Video, cpu and mixed, in file order (dali_tpu's handles move
    forward only): bit-equal to dali_tpu's cpu and mixed placements; 4:2:2
    takes the dense RGB path in both."""
    kw, batch, iters = READER_CASES[case]
    runs = _run_all(_reader(**kw), batch, iters)
    want = runs[("dali_tpu", "cpu")]
    for key, got in runs.items():
        for it in range(iters):
            _assert_same(got[it], want[it], (case, key, it))


@pytest.mark.parametrize("device", ["cpu", "mixed"])
def test_reader_shuffled_over_the_corpus_display_order(device):
    """readers.Video over the corpus's class folders (file_root), shuffled
    with a stride: each sequence holds the display-order frames from its
    frame number on, on the cpu and on the planar wire (the port's handle
    cache seeks back and forth through the GOPs)."""
    root = os.path.join(FIXTURES, "mpeg_corpus")
    pipe = _pipe(dali_tpu_torch, lambda fn, types, d: tuple(fn.readers.video(
        device=d, name="v", file_root=root, sequence_length=4, stride=2, step=5,
        random_shuffle=True, enable_frame_num=True, file_list_include_preceding_frame=False)),
        4, device)
    seen = 0
    for _ in range(3):
        seqs, labels, nums = (_samples(o) for o in pipe.run())
        for seq, label, num in zip(seqs, labels, nums):
            f0 = int(num.reshape(-1)[0])
            hashes = frame_hashes(seq)
            # the clip is the one of its class whose frames match
            cls = ("ps", "ts")[int(label.reshape(-1)[0])]
            hits = [n for n in CORPUS_NAMES if n.split("/")[1] == cls and np.array_equal(
                hashes, REF[n + ":rgb_sha"][f0: f0 + 8: 2])]
            assert hits, (cls, f0)
            seen += 1
    pipe.shutdown()
    assert seen == 12


@pytest.mark.parametrize("device", ["cpu", "mixed"])
def test_decoder_fed_mpeg_bytes(device):
    """decoders.Video and experimental.decoders.Video fed the bytes of a TS,
    a PS and a raw elementary stream (each sample a new handle): dali_tpu's
    frames."""
    blobs = [np.frombuffer(open(_path(n), "rb").read(), np.uint8)
             for n in ("mpeg/mpeg2_altscan_64x48.ts", "mpeg/mpeg1_bf2_64x48.mpg",
                       "mpeg/mpeg2_dc10_64x48.m2v")]
    outs = {}
    for pkg in (dali_tpu, dali_tpu_torch):
        def build(fn, types, device=device):
            buf = fn.external_source(source=lambda: blobs, batch=True, cycle=True)
            return (fn.decoders.video(buf, device=device, sequence_length=6, pad_mode="edge"),
                    fn.experimental.decoders.video(buf, device=device, start_frame=2,
                                                   sequence_length=4, stride=2))
        pipe = _pipe(pkg, build, 3, device)
        outs[pkg.__name__] = [pipe.run() for _ in range(2)]
        if hasattr(pipe, "shutdown"):
            pipe.shutdown()
    for it in range(2):
        _assert_same(outs["dali_tpu_torch"][it], outs["dali_tpu"][it], (device, it))


@pytest.mark.parametrize("policy", ["partial", "pad"])
def test_inputs_video_fed_mpeg(policy):
    """experimental.inputs.Video fed a TS and a PS file one after the
    other: dali_tpu's batches, cpu and mixed."""
    blobs = [open(_path("mpeg/cv2_mpg2_160x120.ts"), "rb").read(),
             open(_path("mpeg/mpeg1_odd_170x98.mpg"), "rb").read()]
    got = {}
    for pkg in (dali_tpu, dali_tpu_torch):
        for device in ("cpu", "mixed"):
            def build(fn, types, device=device):
                return fn.experimental.inputs.video(sequence_length=7, name="vin", device=device,
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


# --------------------------------------------------------------------------- containers

def test_elementary_stream_from_memory():
    """A raw MPEG-1/2 elementary stream (``00 00 01 B3``), once named no
    video file, opens from its bytes too: as dali_tpu reads the file (it
    counts no frames: libavformat's estimate from the header's bit rate)."""
    for name in ("mpeg/mpeg2_dc10_64x48.m2v", "mpeg/mpeg1_matrices_64x48.m1v"):
        data = open(_path(name), "rb").read()
        assert data[:4] == b"\x00\x00\x01\xb3"
        vf = native.VideoFile(data)
        assert _info(vf) == tuple(REF[name + ":info"].tolist())
        assert vf.num_frames == 0
        np.testing.assert_array_equal(frame_hashes(vf.read(0, _frames(name), pad=False)),
                                      REF[name + ":rgb_sha"])


def _m2ts(data):
    """A 188-byte TS as M2TS: each packet behind a 4-byte timestamp."""
    return b"".join(b"\x00\x00\x00\x00" + data[k: k + 188] for k in range(0, len(data), 188))


def test_ts_forms_left_to_item_8b_raise(tmp_path):
    """192-byte packets (M2TS, Blu-ray's form) and H.264 in MPEG-TS: FFmpeg
    reads them, the port raises NotImplementedError naming item 8b, at open
    and through the reader."""
    path = tmp_path / "v.m2ts"
    path.write_bytes(_m2ts(open(_path("mpeg/cv2_mpg2_160x120.ts"), "rb").read()))
    assert ref_native.VideoFile(str(path)).read(0, 3).shape == (3, 120, 160, 3)
    with pytest.raises(NotImplementedError, match="192- or 204-byte.*item 8b"):
        native.VideoFile(str(path))
    from dali_tpu_torch.testdata.make_video_corpus import AviWriter, moving_frames

    try:
        wr = AviWriter()
    except Exception as e:  # no compiler or FFmpeg headers
        pytest.skip(f"FFmpeg helper unavailable: {e}")
    h264 = wr.write(str(tmp_path / "h264.ts"), moving_frames(np.random.default_rng(2), 8, 64, 48,
                                                             "pan"), "libx264", muxer="mpegts")
    assert ref_native.VideoFile(h264).read(0, 3).shape == (3, 48, 64, 3)
    with pytest.raises(NotImplementedError, match="H.264 video in MPEG-TS.*item 8b"):
        native.VideoFile(h264)

    def build(fn, types, device):
        return fn.readers.video(device=device, filenames=[h264], sequence_length=2)
    with pytest.raises(NotImplementedError, match="item 8b"):
        _pipe(dali_tpu_torch, build, 1, "cpu").run()


def test_damaged_streams_raise_value_error():
    """Damage FFmpeg would conceal: slice data overwritten in a TS and a
    PS, a PS cut inside its first pack. The port names the damage
    (ValueError), and the codec."""
    for name, unit in (("mpeg/cv2_mpg2_160x120.ts", 188), ("mpeg/cv2_mpg1_160x120.mpg", 2048)):
        data = bytearray(open(_path(name), "rb").read())
        # the first slice whose first 40 bytes lie in one packet (the
        # packet headers stay whole; cv2's pictures are one slice each)
        i = data.find(b"\x00\x00\x01\x01")
        while not 16 < i % unit < unit - 48:
            i = data.find(b"\x00\x00\x01\x01", i + 1)
        data[i + 6: i + 40] = bytes(range(0x90, 0xb2))
        with pytest.raises(ValueError, match="damaged MPEG-1/2 stream"):
            native.VideoFile(bytes(data)).read(0, 8)
    data = open(_path("mpeg/cv2_mpg1_160x120.mpg"), "rb").read()
    with pytest.raises(ValueError):
        native.VideoFile(data[:40])


def _pmt_sections(data):
    """The offsets in ``data`` of each program map section that starts in a
    packet (cv2's TS: one program, its PMT in the packets that PAT names)."""
    pat = next(k for k in range(0, len(data), 188)
               if data[k] == 0x47 and ((data[k + 1] & 0x1f) << 8 | data[k + 2]) == 0
               and data[k + 1] & 0x40)
    s = pat + 5 + data[pat + 4]
    pmt_pid = (data[s + 10] & 0x1f) << 8 | data[s + 11]
    out = []
    for k in range(0, len(data), 188):
        if ((data[k + 1] & 0x1f) << 8 | data[k + 2]) == pmt_pid and data[k + 1] & 0x40:
            assert (data[k + 3] >> 4) & 3 == 1  # payload only
            out.append(k + 5 + data[k + 4])
    assert out and all(data[s] == 0x02 for s in out)
    return out


@pytest.mark.parametrize("damage", ["section_length_0", "program_info_past_section"])
def test_damaged_program_map_raises_value_error(damage, tmp_path):
    """A program map section whose section_length is 0 (once read as
    ending past the section: the stream loop ran over the heap) or whose
    program_info_length runs past it: no video stream is found in the map.
    The port once raised ValueError here; libavformat then takes the PES
    stream no map declared as a stream of its own (mpegts.c's auto_guess),
    and since F10's fix so does the port: dali_tpu's frames, from memory
    and from a path."""
    data = bytearray(open(_path("mpeg/cv2_mpg2_160x120.ts"), "rb").read())
    for s in _pmt_sections(data):
        if damage == "section_length_0":
            data[s + 1] &= 0xf0
            data[s + 2] = 0
        else:
            data[s + 10] |= 0x0f
            data[s + 11] = 0xff
    path = tmp_path / "damaged.ts"
    path.write_bytes(bytes(data))
    ref = ref_native.VideoFile(str(path))
    want = ref.read(0, ref.num_frames, pad=False)
    for mine in (native.VideoFile(bytes(data)), native.VideoFile(str(path))):
        assert _info(mine) == _info(ref)
        np.testing.assert_array_equal(mine.read(0, ref.num_frames, pad=False), want)


def _noise_clip(path, fourcc, frames=12, w=320, h=240, seed=7):
    """cv2's write of random frames: pictures of tens of KiB, hundreds of
    TS packets (or several PS packs) each."""
    rng = np.random.default_rng(seed)
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 25, (w, h))
    if not wr.isOpened():
        pytest.skip(f"cv2 build cannot write {fourcc}")
    for _ in range(frames):
        wr.write(rng.integers(0, 255, (h, w, 3), np.uint8))
    wr.release()
    return str(path)


@pytest.mark.parametrize("ext,fourcc", [("ts", "mpg2"), ("mpg", "mpg1")])
def test_index_grows_by_picture_not_by_packet(tmp_path, ext, fourcc):
    """A handle's index (sample table, pieces, numbering, seek points with
    their decoder states) costs a few hundred bytes a picture, whatever the
    bit rate: one piece per PES packet in TS and per picture in PS, the
    decoder's state kept at I-pictures only. Random frames make pictures
    of tens of KiB; their frames still read equal to the reference's."""
    path = _noise_clip(tmp_path / f"noise.{ext}", fourcc)
    vf = native.VideoFile(path)
    got = vf.read_yuv(0, 40, 1, pad=False)[3]
    assert got == 12
    assert os.path.getsize(path) / got > 20000
    assert vf.index_bytes() <= 256 * got + 4096, vf.index_bytes()
    ref = ref_native.VideoFile(path)
    np.testing.assert_array_equal(native.VideoFile(path).read(0, 12, pad=False),
                                  ref.read(0, 12, pad=False))


def _moving_clip(path, fourcc, frames, seed, w=64, h=48):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (2 * h, 2 * w, 3), np.uint8)
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 25, (w, h))
    if not wr.isOpened():
        pytest.skip(f"cv2 build cannot write {fourcc} into TS")
    for i in range(frames):
        y, x = (3 * i) % h, (2 * i) % w
        wr.write(np.ascontiguousarray(base[y: y + h, x: x + w]))
    wr.release()
    return open(path, "rb").read()


@pytest.mark.parametrize("fourcc", ["mpg2", "FMP4"])
def test_splice_seeks_read_as_the_forward_decode(tmp_path, fourcc):
    """Two TS segments of one size spliced (MPEG-2, and MPEG-4 Part 2 in
    TS): the second's timestamps start again, so frame indices repeat. A
    read after a seek back gives the frames a new handle's forward decode
    gives (the first picture in display order at or past the target), for
    both codecs: one seek rule for every stream numbered by timestamps."""
    a = _moving_clip(tmp_path / "a.ts", fourcc, 30, seed=1)
    b = _moving_clip(tmp_path / "b.ts", fourcc, 30, seed=2)
    path = tmp_path / "ab.ts"
    path.write_bytes(a + b)
    used = native.VideoFile(str(path))
    for t in (26, 2, 13, 5, 20):
        fresh = native.VideoFile(str(path)).read(t, 3, pad=False)
        assert len(fresh) == 3
        used.read(25, 3)
        np.testing.assert_array_equal(used.read(t, 3, pad=False), fresh, err_msg=str(t))


@pytest.mark.parametrize("name", ["mpeg/cv2_mpg2_160x120.ts", "mpeg/cv2_mpg1_160x120.mpg",
                                  "mpeg/mpeg2_dvd_64x48.vob"])
def test_from_memory_reads_as_from_the_path(name):
    """A PS or TS opened from its bytes walks the same pieces as from its
    path: the same info, index and frames, after seeks too."""
    data = open(_path(name), "rb").read()
    mem, disk = native.VideoFile(data), native.VideoFile(_path(name))
    assert _info(mem) == _info(disk)
    assert mem.index_bytes() == disk.index_bytes()
    for start in (0, 17, 3, 11):
        np.testing.assert_array_equal(mem.read(start, 4, pad=False), disk.read(start, 4, pad=False))


def test_bench_open_cost_on_the_cpu(tmp_path):
    """``bench_mpeg.open_cost`` (phase 45's reading of the open against the
    file's length) runs here: the open's time grows with the file, the
    index by a few hundred bytes a picture."""
    from dali_tpu_torch.tools import bench_mpeg

    rows = bench_mpeg.open_cost(lengths=(1, 4), reps=1, work=str(tmp_path))
    assert [(r["container"], r["clips"]) for r in rows] == [("ts", 1), ("ts", 4), ("ps", 1),
                                                             ("ps", 4)]
    for r in rows:
        assert r["open_ms"] > 0 and r["pictures"] == 48 * r["clips"]
        assert r["index_bytes_per_picture"] < 300
