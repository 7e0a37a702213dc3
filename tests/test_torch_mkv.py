"""Matroska in dali_tpu_torch (ROADMAP Queue 1 item 8b(b)): the EBML demuxer
(``csrc/host/mkv_demux.cc``) feeding the decoders the port already has
(MPEG-4 Part 2, MPEG-1/2, Motion JPEG, FFV1, and the V_MS/VFW/FOURCC forms
read as in AVI: HuffYUV, raw I420), against dali_tpu's FFmpeg 5.1 route.

The committed fixtures (``dali_tpu_torch/testdata/video/mkv``, written by
``make_video_corpus.py --mkv``: FFmpeg's encoders through its ``matroska``
muxer, cv2's Matroska writes, and rewrites of FFmpeg's files for the forms
its muxer does not write) and the ``mkv_archive_train`` corpus decode to the
frames of ``mkv_reference.npz`` and of the live ``dali_tpu`` read, with its
``info()``: the frame count from the Segment's duration, the fps from the
track's DefaultDuration or, without one, libavformat's guess. Reads after
seeks (backward, more than 64 frames ahead, into open GOPs) match the
reference's, which in Matroska numbers frames by their pts; in a packed
Xvid stream the reference misplaces frames after a seek, where the port
keeps display order (a pinned departure). WebM's VP8/VP9 and H.264 in
Matroska raise NotImplementedError naming their items."""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import dali_tpu  # noqa: E402
import dali_tpu_torch  # noqa: E402
from dali_tpu import native as ref_native  # noqa: E402

from dali_tpu_torch import native  # noqa: E402
from dali_tpu_torch.testdata import make_video_corpus as corpus  # noqa: E402

from .test_torch_video import _assert_same, _pipe, _run_all, _samples  # noqa: E402
from .write_video_reference import (FIXTURES, MKV_UNPORTED, frame_hashes,  # noqa: E402
                                    mkv_names, yuv_hashes)

REF = np.load(os.path.join(FIXTURES, "mkv_reference.npz"))
FIXTURE_NAMES = [n for n in mkv_names() if n.startswith("mkv/") and n not in MKV_UNPORTED]
CORPUS_NAMES = [n for n in mkv_names() if n.startswith("mkv_corpus/")]
PACKED = "mkv/xvid_packed_160x120.mkv"
# 4:2:0 files whose frames a seek reads as the reference's
SEEKABLE = [n for n in FIXTURE_NAMES if n + ":display_sha" in REF.files and n != PACKED]


def _path(name):
    return os.path.join(FIXTURES, name)


def _info(vf):
    return (vf.width, vf.height, vf.num_frames, vf.fps, vf.pixfmt_class)


def _yuv_sha(vf, start, count, stride=1):
    y, u, v, got = vf.read_yuv(start, count, stride, pad=False)
    return yuv_hashes(y[:got], u[:got], v[:got])


def _segment(name):
    with open(_path(name), "rb") as f:
        data = f.read()
    return data, corpus.mkv_segment(corpus.ebml_parse(data))


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_bit_equal_to_the_reference(name):
    """Every frame in RGB (and planar YUV for 4:2:0) from frame 0, the frame
    count, fps and the pixel-format class: equal to the committed reference
    and to dali_tpu's live read, from the path and from memory."""
    mine, ref = native.VideoFile(_path(name)), ref_native.VideoFile(_path(name))
    assert _info(mine) == _info(ref) == tuple(REF[name + ":info"].tolist())
    n = mine.num_frames
    rgb = mine.read(0, n, pad=False)
    np.testing.assert_array_equal(frame_hashes(rgb), REF[name + ":rgb_sha"])
    np.testing.assert_array_equal(rgb, ref.read(0, n, pad=False))
    with open(_path(name), "rb") as f:
        mem = native.VideoFile(f.read())
    assert _info(mem) == _info(mine)
    np.testing.assert_array_equal(mem.read(0, n, pad=False), rgb)
    if name + ":yuv_sha" in REF.files:
        np.testing.assert_array_equal(_yuv_sha(native.VideoFile(_path(name)), 0, n),
                                      REF[name + ":yuv_sha"])


def test_mkv_corpus_bit_equal_to_the_reference():
    """The 32 clips of the card's ``mkv_archive_train`` corpus: 16 Xvid
    clips with B-frames and 16 FFV1 version 3 clips, every frame and
    info."""
    assert len(CORPUS_NAMES) == 32
    assert sum(n.startswith("mkv_corpus/xvid/") for n in CORPUS_NAMES) == 16
    for name in CORPUS_NAMES:
        vf = native.VideoFile(_path(name))
        assert _info(vf) == tuple(REF[name + ":info"].tolist()), name
        np.testing.assert_array_equal(_yuv_sha(vf, 0, vf.num_frames), REF[name + ":yuv_sha"],
                                      err_msg=name)
    name = CORPUS_NAMES[0]
    np.testing.assert_array_equal(frame_hashes(native.VideoFile(_path(name)).read(0, 8)),
                                  REF[name + ":rgb_sha"][:8])


def _has(elements, eid):
    return any(e == eid or (isinstance(b, list) and _has(b, eid)) for e, b in elements)


@pytest.mark.parametrize("name,form", [
    ("mkv/unknown_sizes_mpeg4_64x48.mkv", "unknown sizes"),
    ("mkv/lace_xiph_mjpeg_64x48.mkv", "xiph"), ("mkv/lace_ebml_mjpeg_64x48.mkv", "ebml"),
    ("mkv/lace_fixed_i420_64x48.mkv", "fixed"),
    ("mkv/headerstrip_mjpeg_64x48.mkv", "header stripping"),
    ("mkv/zlib_mpeg4_64x48.mkv", "zlib"), ("mkv/nodefault_mpeg4_64x48.mkv", "no DefaultDuration"),
    ("mkv/nodefault_ffv1_64x48.mkv", "no DefaultDuration"),
    ("mkv/cv2_mp4v_2997_64x48.mkv", "30000/1001"),
    ("mkv/audio_first_mpeg4_64x48.mkv", "audio track first"),
    ("mkv/blockgroups_mpeg4_64x48.mkv", "BlockGroups"),
    ("mkv/cv2_hfyu_64x48.mkv", "V_MS/VFW/FOURCC"),
])
def test_fixture_holds_its_form(name, form):
    """Each fixture of a Matroska form holds it (the rewrites are checked,
    not assumed), and reads as the reference does (above)."""
    data, seg = _segment(name)
    entry = next(b for e, b in seg if e == corpus.MKV_TRACKS)
    blocks = [b for e, cl in seg if e == corpus.MKV_CLUSTER for i, b in cl
              if i == corpus.MKV_SIMPLE_BLOCK]
    if form == "unknown sizes":
        # the Segment's and each Cluster's size field is all ones
        assert data.count(bytes.fromhex("18538067 01ffffffffffffff")) == 1
        assert data.count(bytes.fromhex("1f43b675 01ffffffffffffff")) >= 1
    elif form in ("xiph", "fixed", "ebml"):
        lacing = {"xiph": 1, "fixed": 2, "ebml": 3}[form]
        assert sum(((b[3] >> 1) & 3) == lacing for b in blocks) >= 2
    elif form == "header stripping":
        # ContentCompAlgo 3, and no frame starts with its SOI any more
        assert bytes.fromhex("6d80") in data and bytes.fromhex("4254 81 03") in data
        assert not any(b[4:6] == b"\xff\xd8" for b in blocks)
    elif form == "zlib":
        assert bytes.fromhex("4254 81 00") in data and all(b[4] == 0x78 for b in blocks)
    elif form == "no DefaultDuration":
        assert not _has(entry, corpus.MKV_DEFAULT_DURATION)
    elif form == "30000/1001":
        # cv2's DefaultDuration, 33366700 ns, reduced as libavformat reduces it
        assert bytes.fromhex("23e383 84") + (33366700).to_bytes(4, "big") in data
        assert native.VideoFile(_path(name)).fps == 29.97
    elif form == "audio track first":
        first = next(b for e, b in entry if e == corpus.MKV_TRACK_ENTRY)
        assert [v for i, v in first if i == 0x83] == [b"\x02"]  # TrackType audio
        assert {b[0] for b in blocks} == {0x81, 0x82}
    elif form == "BlockGroups":
        groups = [b for e, cl in seg if e == corpus.MKV_CLUSTER for i, b in cl
                  if i == corpus.MKV_BLOCK_GROUP]
        assert not blocks and len(groups) == 24
        assert sum(any(i == corpus.MKV_REFERENCE_BLOCK for i, _ in g) for g in groups) >= 20
    elif form == "V_MS/VFW/FOURCC":
        assert b"V_MS/VFW/FOURCC" in data and b"HFYU" in data


@pytest.mark.parametrize("name", SEEKABLE)
def test_seeks_match_the_reference(name):
    """Reads that seek back and forth through one handle (backward, more
    than 64 frames ahead, into the leading B-frames of open GOPs, to the
    end): the frames of the reference's reads recorded in
    ``mkv_reference.npz``, which in Matroska are right (libavformat seeks
    through the Cues to the key frame at or before the target and numbers
    frames by their pts: where an encoder dropped a frame, its number is
    skipped); then the same with strides against the live reference."""
    mine = native.VideoFile(_path(name))
    got = np.concatenate([_yuv_sha(mine, int(s), int(k)) for s, k in REF[name + ":seeks"]])
    np.testing.assert_array_equal(got, REF[name + ":seek_sha"])
    want = REF[name + ":display_sha"]
    assert all((want == g).all(1).any() for g in got)
    n = len(REF[name + ":rgb_sha"])
    mine, ref = native.VideoFile(_path(name)), ref_native.VideoFile(_path(name))
    for start, stride in ((1, 2), (0, 3), (n // 3, 2), (n - 6, 2)):
        got = _yuv_sha(mine, start, 4, stride)
        y, u, v, k = ref.read_yuv(start, 4, stride, pad=False)
        np.testing.assert_array_equal(got, yuv_hashes(y[:k], u[:k], v[:k]),
                                      err_msg=str((start, stride)))


def test_reference_misplaces_frames_after_a_seek_in_a_packed_stream():
    """Pinned departure (ROADMAP Queue 3): libxvid's packed bitstream
    (B-VOPs packed with the P-VOP before them, N-VOP placeholders) in
    Matroska, the form an Xvid AVI remuxed as it is takes. dali_tpu numbers
    a picture by its best-effort timestamp
    (dali_tpu/native/src/video_decode.cc:218-226), which in a packed stream
    is the pts of the packet it was decoded in, not its own; after a seek
    (:255-268) its read takes the wrong frames. From frame 0 both read the
    display order; after a seek the port reads frames s, s+1, ... of it."""
    want = REF[PACKED + ":display_sha"]
    n = int(REF[PACKED + ":info"][2])
    np.testing.assert_array_equal(REF[PACKED + ":yuv_sha"], want[: len(REF[PACKED + ":yuv_sha"])])
    differs = 0
    for s in (10, 20, 25, 3):
        mine = _yuv_sha(native.VideoFile(_path(PACKED)), s, 4)
        np.testing.assert_array_equal(mine, want[s: s + 4], err_msg=str(s))
        theirs = _yuv_sha(ref_native.VideoFile(_path(PACKED)), s, 4)
        differs += not np.array_equal(theirs, mine)
    assert differs >= 2
    assert len(_yuv_sha(ref_native.VideoFile(_path(PACKED)), 0, n)) < n


def test_unported_forms_raise_with_their_item(tmp_path):
    """VP8 and VP9 in WebM raise NotImplementedError naming item 8b(f),
    H.264 in Matroska item 8b(e), at open and through readers.Video; the
    reference reads each."""
    for name, what in (("mkv/vp8_64x48.webm", r"VP8 video in WebM.*item 8b\(f\)"),
                       ("mkv/vp9_64x48.webm", r"VP9 video in WebM.*item 8b\(f\)"),
                       ("mkv/h264_64x48.mkv", r"H.264 video in Matroska.*item 8b\(e\)")):
        assert len(ref_native.VideoFile(_path(name)).read(0, 4, pad=False)) == 4
        with pytest.raises(NotImplementedError, match=what):
            native.VideoFile(_path(name))

        def build(fn, types, device, name=name):
            return fn.readers.video(device=device, filenames=[_path(name)], sequence_length=2)
        with pytest.raises(NotImplementedError, match=what):
            _pipe(dali_tpu_torch, build, 1, "cpu").run()
    # bzlib-compressed frames (ContentCompAlgo 1) name item 8b
    data, _ = _segment("mkv/zlib_mpeg4_64x48.mkv")
    i = data.index(bytes.fromhex("4254 81 00"))
    bz = data[:i + 3] + b"\x01" + data[i + 4:]
    with pytest.raises(NotImplementedError, match="bzlib.*item 8b"):
        native.VideoFile(bz)


def _reader(files, **kw):
    def build(fn, types, device):
        out = fn.readers.video(device=device, name="v", filenames=[_path(f) for f in files], **kw)
        return tuple(out) if isinstance(out, (list, tuple)) else out
    return build


READER_CASES = {
    "xvid_and_mpeg4_b_frames": (dict(files=["mkv/xvid_bf_160x120.mkv",
                                            "mkv/mpeg4_bf_160x120.mkv"], labels=[0, 1],
                                     sequence_length=4, stride=2, step=7), 2, 3),
    "ffv1_intra_edge_pad": (dict(files=["mkv/ffv1_v3_420_64x48.mkv"], sequence_length=5, step=19,
                                 pad_mode="edge", enable_frame_num=True), 2, 3),
    "laced_and_stripped_mjpeg": (dict(files=["mkv/lace_xiph_mjpeg_64x48.mkv",
                                             "mkv/headerstrip_mjpeg_64x48.mkv"],
                                      sequence_length=3, step=5), 2, 2),
    "rgb_ffv1_dense_path": (dict(files=["mkv/cv2_ffv1_64x48.mkv"], sequence_length=3, step=8),
                            1, 3),
}


@pytest.mark.parametrize("case", sorted(READER_CASES))
def test_reader_matches_dali_tpu(case):
    """readers.Video, cpu and mixed, in file order: bit-equal to dali_tpu's
    cpu and mixed placements; cv2's RGB FFV1 takes the dense RGB path in
    both."""
    kw, batch, iters = READER_CASES[case]
    runs = _run_all(_reader(**kw), batch, iters)
    want = runs[("dali_tpu", "cpu")]
    for key, got in runs.items():
        for it in range(iters):
            _assert_same(got[it], want[it], (case, key, it))


def test_reader_over_the_corpus_on_the_cpu():
    """readers.Video over the corpus's class folders (file_root), shuffled,
    on the cpu placement: each sequence holds the reference's frames from
    its frame number on, in both classes."""
    root = os.path.join(FIXTURES, "mkv_corpus")
    pipe = _pipe(dali_tpu_torch, lambda fn, types, d: tuple(fn.readers.video(
        device=d, name="v", file_root=root, sequence_length=4, step=3, random_shuffle=True,
        enable_frame_num=True)), 4, "cpu")
    seen = set()
    for _ in range(3):
        seqs, labels, nums = (_samples(o) for o in pipe.run())
        for seq, label, num in zip(seqs, labels, nums):
            f0 = int(num.reshape(-1)[0])
            cls = ("ffv1", "xvid")[int(label.reshape(-1)[0])]
            # the clip of its class whose frames hold the first one; the
            # reference's read from the frame number on gives the rest
            first = frame_hashes(seq[:1])[0]
            hits = [n for n in CORPUS_NAMES if n.split("/")[1] == cls and
                    (REF[n + ":rgb_sha"] == first).all(1).any()]
            assert hits, (cls, f0)
            ref = ref_native.VideoFile(_path(hits[0])).read(f0, 4)
            np.testing.assert_array_equal(seq, ref, err_msg=str((hits[0], f0)))
            seen.add(cls)
    pipe.shutdown()
    assert seen == {"ffv1", "xvid"}


@pytest.mark.parametrize("device", ["cpu", "mixed"])
def test_decoder_fed_mkv_bytes(device):
    """decoders.Video and experimental.decoders.Video fed the bytes of
    Matroska files (each sample a new handle): dali_tpu's frames."""
    blobs = [np.frombuffer(open(_path(n), "rb").read(), np.uint8)
             for n in ("mkv/mpeg4_bf_160x120.mkv", "mkv/lace_ebml_mjpeg_64x48.mkv",
                       "mkv/zlib_mpeg4_64x48.mkv")]
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


@pytest.mark.parametrize("name", ["mkv/mpeg4_bf_long_96x64.mkv", "mkv/ffv1_v3_420_64x48.mkv",
                                  "mkv/lace_fixed_i420_64x48.mkv"])
def test_index_is_a_few_integers_a_frame(name):
    """A handle's index holds one sample (offset, size, timestamps, key)
    and, for MPEG-4 Part 2 and the intra-only codecs, one frame number a
    frame: well under 200 bytes a frame, whatever the frame's size."""
    vf = native.VideoFile(_path(name))
    frames = len(REF[name + ":rgb_sha"])
    assert vf.index_bytes() <= 200 * frames + 2048, vf.index_bytes()


def test_cut_recording_reads_as_the_reference(tmp_path):
    """A recording that stopped mid-Cluster (the file cut inside a frame,
    its Segment and Cluster sizes past the end, no Cues): both packages
    open it with the Segment's stated duration, and read the frames that
    are whole."""
    data = open(_path("mkv/unknown_sizes_mpeg4_64x48.mkv"), "rb").read()
    for cut in (len(data) * 2 // 3, len(data) - 7):
        path = tmp_path / f"cut{cut}.mkv"
        path.write_bytes(data[:cut])
        mine, ref = native.VideoFile(str(path)), ref_native.VideoFile(str(path))
        assert _info(mine) == _info(ref)
        np.testing.assert_array_equal(mine.read(0, 30, pad=False), ref.read(0, 30, pad=False))


def test_damaged_matroska_raises_value_error():
    """A file whose EBML header or Segment is damaged fails to open, as the
    reference's does."""
    data = open(_path("mkv/cv2_xvid_64x48.mkv"), "rb").read()
    with pytest.raises(ValueError, match="Failed to open"):
        native.VideoFile(data[:40])
    with pytest.raises(ValueError, match="Failed to open"):
        native.VideoFile(data[:4] + b"\x00" * 60)


def test_bench_open_cost_on_the_cpu(tmp_path):
    """``bench_mkv.open_cost`` (phase 46's reading of the open against the
    file's length) runs here: corpus clips joined into one Matroska file
    read as their frames in a row, the index a few integers a frame."""
    from dali_tpu_torch.tools import bench_mkv

    rows = bench_mkv.open_cost(lengths=(1, 4), reps=1, work=str(tmp_path))
    assert [(r["codec"], r["clips"]) for r in rows] == [("xvid", 1), ("xvid", 4), ("ffv1", 1),
                                                         ("ffv1", 4)]
    for r in rows:
        per_clip = len(REF[f"mkv_corpus/{r['codec']}/{r['codec']}_00.mkv:rgb_sha"])
        assert r["open_ms"] > 0 and r["pictures"] >= per_clip * r["clips"] - 2 * r["clips"]
        assert r["index_bytes_per_picture"] < 120
