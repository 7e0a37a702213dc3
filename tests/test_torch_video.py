"""The video operators of dali_tpu_torch (ROADMAP Queue 1 item 8a):
readers.Video, decoders.Video (and experimental.decoders.Video) and
experimental.inputs.Video, cpu and mixed, against dali_tpu's cpu and mixed
placements (``debug=True``) on the mp4v clips of ``tests/test_video.py``
and ``tests/test_video_yuv_wire.py``, written by cv2 in the test. uint8
frames are bit-equal across all four runs; floats (timestamps, normalized
frames) hold to rtol 1e-6, since dali_tpu's mixed placement returns its
floats as float32 (JAX without x64) where the port keeps float64.

Also: serialize round trips, the mixed decoder's dense/YUV alternation,
checkpoints, the video-clip training recipe at a small size, and the forms
the port leaves to item 8b."""

import os

import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch

cv2 = pytest.importorskip("cv2")

from .write_video_reference import samples, stream_headers, with_samples  # noqa: E402


def _write(path, num_frames, w, h, fps=25, seed=0, flat=False):
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    assert wr.isOpened()
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w * 3, 3), np.uint8)
    for i in range(num_frames):
        if flat:  # tests/test_video.py's clip
            wr.write(np.full((h, w, 3), i * 8 % 256, np.uint8))
        else:  # tests/test_video_yuv_wire.py's clip
            wr.write(np.ascontiguousarray(base[:, i: i + w]))
    wr.release()
    return str(path)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    c = {
        "flat": _write(d / "flat.mp4", 24, 48, 32, flat=True),
        "a": _write(d / "a.mp4", 12, 64, 48, seed=1),
        "b": _write(d / "b.mp4", 12, 80, 56, seed=2),
        "v20": _write(d / "v20.mp4", 20, 64, 48, fps=10, seed=3),
        "v7": _write(d / "v7.mp4", 7, 64, 48, fps=10, seed=4),
        "v15": _write(d / "v15.mp4", 15, 64, 48, seed=5),
        "v8": _write(d / "v8.mp4", 8, 64, 48, seed=11),
        "v6": _write(d / "v6.mp4", 6, 80, 56, seed=12),
        "odd": _write(d / "odd.mp4", 10, 70, 38, seed=13),
    }
    # a 48x32 clip spliced in after frame 5: an in-band VOL changes the size
    big = open(_write(d / "big.mp4", 12, 64, 48, seed=14), "rb").read()
    small = open(_write(d / "small.mp4", 12, 48, 32, seed=15), "rb").read()
    sb, ss = samples(big), samples(small)
    (d / "spliced.mp4").write_bytes(with_samples(big, sb[:6] + [stream_headers(small) + ss[0]]
                                                 + ss[1:6]))
    c["spliced"] = str(d / "spliced.mp4")
    with open(d / "list_frames.txt", "w") as f:
        f.write(f"{c['v20']} 0 2 14\n{c['a']} 1 1 9\n")
    with open(d / "list_secs.txt", "w") as f:
        f.write(f"{c['v20']} 0 0.25 1.42\n{c['a']} 1 0.1 0.3\n")
    root = d / "root"
    for k, cls in (("a", "x"), ("b", "y"), ("odd", "y")):
        os.makedirs(root / cls, exist_ok=True)
        os.symlink(c[k], root / cls / f"{k}.mp4")
    c["list_frames"] = str(d / "list_frames.txt")
    c["list_secs"] = str(d / "list_secs.txt")
    c["root"] = str(root)
    return c


def _samples(tl):
    if hasattr(tl, "as_cpu"):
        tl = tl.as_cpu()
    return [np.asarray(tl.at(i)) for i in range(len(tl))]


def _pipe(pkg, build, batch, device, seed=5, **kw):
    opts = {"device": "cpu"} if pkg is dali_tpu_torch else {"debug": True}

    @pkg.pipeline_def(batch_size=batch, num_threads=2, seed=seed, **opts, **kw)
    def p():
        return build(pkg.fn, pkg.types, device)

    pipe = p()
    pipe.build()
    return pipe


def _assert_same(got, want, what):
    assert len(got) == len(want), what
    for j, (g, w) in enumerate(zip(got, want)):
        sg, sw = _samples(g), _samples(w)
        assert len(sg) == len(sw), (what, j)
        for i, (a, b) in enumerate(zip(sg, sw)):
            assert a.shape == b.shape, (what, j, i, a.shape, b.shape)
            if a.dtype.kind == "f" or b.dtype.kind == "f":
                np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64), rtol=1e-6,
                                           atol=0, err_msg=str((what, j, i)))
            else:
                assert a.dtype == b.dtype, (what, j, i, a.dtype, b.dtype)
                np.testing.assert_array_equal(a, b, err_msg=str((what, j, i)))


def _reader(c, **kw):
    files = kw.pop("files", None)

    def build(fn, types, device):
        args = dict(kw)
        if files:
            args["filenames"] = [c[f] for f in files]
        for k in ("file_list", "file_root"):
            if k in args:
                args[k] = c[args[k]]
        if "dtype" in args:
            args["dtype"] = getattr(types, args["dtype"])
        out = fn.readers.video(device=device, name="v", **args)
        return tuple(out) if isinstance(out, (list, tuple)) else out
    return build


def _decoder(c, files, **kw):
    blobs = [np.frombuffer(open(c[f], "rb").read(), np.uint8) for f in files]

    def build(fn, types, device):
        buf = fn.external_source(source=lambda: blobs, batch=True, cycle=True)
        return fn.decoders.video(buf, device=device, **kw)
    return build


# (clips, batch, iterations, builder arguments): the mp4v cases of
# tests/test_video.py and tests/test_video_yuv_wire.py
READER_CASES = {
    "flat_clip": (dict(files=["flat"], sequence_length=4), 2, 3),
    "stride_and_step": (dict(files=["flat"], sequence_length=3, stride=2, step=5), 2, 3),
    "labels_shuffled_ragged": (dict(files=["a", "b"], labels=[3, 9], sequence_length=4,
                                    random_shuffle=True), 4, 4),
    "frame_num_timestamps_stride": (dict(files=["v20"], sequence_length=3, stride=2, step=4,
                                         enable_frame_num=True, enable_timestamps=True), 2, 3),
    "padded_tail_reflect": (dict(files=["v7"], sequence_length=4, step=4,
                                 pad_mode="reflect_101"), 1, 2),
    "padded_tail_edge": (dict(files=["v7", "odd"], labels=[0, 1], sequence_length=4, step=3,
                              pad_mode="edge", enable_frame_num=True), 2, 4),
    "pad_sequences": (dict(files=["v7"], sequence_length=3, step=2, pad_sequences=True,
                           enable_timestamps=True), 2, 3),
    "pad_constant_dense": (dict(files=["v7"], sequence_length=4, step=4, pad_mode="constant",
                                fill_value=[10, 20, 30]), 1, 2),
    "pad_none_dense": (dict(files=["v7"], sequence_length=4, step=4, pad_mode="none"), 1, 2),
    "uniform_sample": (dict(files=["v15"], sequence_length=5, uniform_sample=True), 1, 1),
    "file_list_frames": (dict(file_list="list_frames", sequence_length=3, file_list_frame_num=True,
                              enable_frame_num=True), 2, 3),
    "file_list_seconds": (dict(file_list="list_secs", sequence_length=2,
                               enable_timestamps=True), 2, 3),
    "file_list_format_rounding": (dict(file_list="list_secs", sequence_length=2,
                                       file_list_format="timestamps",
                                       file_list_rounding="all_up", pad_mode="edge"), 2, 3),
    "file_root_odd_size": (dict(file_root="root", sequence_length=3, random_shuffle=True), 3, 3),
    "sharded_shuffled": (dict(files=["a", "b", "v15"], labels=[0, 1, 2], sequence_length=3,
                              shard_id=1, num_shards=2, random_shuffle=True), 2, 4),
    "luma_dense": (dict(files=["a"], sequence_length=2, channels=1), 2, 2),
    "normalized_dense": (dict(files=["a"], sequence_length=2, normalized=True), 2, 2),
    "dtype_float_dense": (dict(files=["a"], sequence_length=2, dtype="FLOAT"), 2, 2),
}

DECODER_CASES = {
    "whole_file": dict(),
    "start_and_length": dict(start_frame=2, sequence_length=3),
    "eof_edge_pad": dict(sequence_length=10, pad_mode="edge"),
    "eof_constant_zero_pad": dict(sequence_length=10),
    "shrink_pad_none": dict(sequence_length=10, pad_mode="none"),
    "stride": dict(start_frame=1, sequence_length=3, stride=2),
    "end_frame": dict(start_frame=1, end_frame=6),
    "constant_fill_dense": dict(sequence_length=10, fill_value=50.0),
    "reflect_pad": dict(sequence_length=11, pad_mode="reflect_1001"),
    "huge_shrink": dict(sequence_length=100000, pad_mode="none"),
}
# decoders.Video on these two clips; the spliced one in the size-change case
DECODER_FILES = {"size_change_mid_stream": ["spliced", "v6"]}
DECODER_CASES["size_change_mid_stream"] = dict(sequence_length=8, pad_mode="edge")
DECODER_ITERS = {"size_change_mid_stream": 1}


def _run_all(build, batch, iters, seed=5):
    """The outputs of every iteration, for (package, placement) in the four
    combinations."""
    out = {}
    for pkg in (dali_tpu, dali_tpu_torch):
        for device in ("cpu", "mixed"):
            pipe = _pipe(pkg, build, batch, device, seed=seed)
            try:
                out[(pkg.__name__, device)] = [pipe.run() for _ in range(iters)]
            finally:
                if hasattr(pipe, "shutdown"):
                    pipe.shutdown()
    return out


@pytest.mark.parametrize("case", sorted(READER_CASES) + [f"decoder_{k}" for k in
                                                         sorted(DECODER_CASES)])
def test_video_operator_matches_dali_tpu(clips, case):
    if case.startswith("decoder_"):
        build = _decoder(clips, DECODER_FILES.get(case[8:], ["v8", "v6"]),
                         **DECODER_CASES[case[8:]])
        batch, iters = 2, DECODER_ITERS.get(case[8:], 2)
    else:
        kw, batch, iters = READER_CASES[case]
        build = _reader(clips, **kw)
    runs = _run_all(build, batch, iters)
    want = runs[("dali_tpu", "cpu")]
    for key, got in runs.items():
        for it in range(iters):
            _assert_same(got[it], want[it], (case, key, it))


def test_reader_size_change_mid_stream(clips):
    """readers.Video on a clip whose frame size changes after frame 5 (an
    in-band VOL): the cpu reader pads the 6 frames before the change. The
    port's mixed reader meets the change on the planar wire and decodes the
    batch densely from a handle opened anew, so it gives the cpu reader's
    frames; dali_tpu's mixed reader re-reads through the handle that met the
    change, whose decoder keeps the spliced clip's size, and fails (pinned
    departure: the port keeps cpu == mixed). One batch: a second read of
    the file seeks back and fails in both packages."""
    build = _reader(clips, files=["spliced", "v8"], labels=[0, 1], sequence_length=8, step=100)
    want = _pipe(dali_tpu, build, 2, "cpu").run()
    assert _samples(want[0])[0].shape == (8, 48, 64, 3)
    for device in ("cpu", "mixed"):
        pipe = _pipe(dali_tpu_torch, build, 2, device)
        _assert_same(pipe.run(), want, ("port", device))
        pipe.shutdown()
    with pytest.raises(ValueError, match="Failed to read frames"):
        _pipe(dali_tpu, build, 2, "mixed").run()


@pytest.mark.parametrize("device", ["cpu", "mixed"])
def test_reader_keeps_few_files_open(clips, monkeypatch, device):
    """With room for one open file, a shuffled reader over three files
    drops the least recently used handle and opens it anew on its next
    read, which seeks: the frames stay dali_tpu's, and no more handles stay
    open than the room and one batch's reads."""
    import weakref

    from dali_tpu_torch import native
    from dali_tpu_torch.backend import video as port_video

    opened = []

    class Counted(native.VideoFile):
        def __init__(self, path):
            super().__init__(path)
            opened.append(weakref.ref(self))

    monkeypatch.setattr(port_video, "_MAX_OPEN_FILES", 1)
    monkeypatch.setattr(port_video.native, "VideoFile", Counted)
    build = _reader(clips, files=["a", "b", "v15"], labels=[0, 1, 2], sequence_length=3,
                    random_shuffle=True)
    ref = _pipe(dali_tpu, build, 4, "cpu")
    port = _pipe(dali_tpu_torch, build, 4, device)
    for it in range(4):
        _assert_same(port.run(), ref.run(), (device, it))
        alive = [r() for r in opened]
        assert sum(1 for v in alive if v is not None and v._h) <= 1 + 4
    port.shutdown()
    assert len(opened) > 3 + 3  # the index's opens, then reopens


@pytest.mark.parametrize("policy", ["partial", "pad"])
def test_inputs_video_matches_dali_tpu(clips, policy):
    """experimental.inputs.Video: the batch outline (full batches, then the
    leftover full sequences and a partial or padded one), two files fed one
    after the other."""
    blobs = [open(clips["v15"], "rb").read(), open(clips["odd"], "rb").read()]
    got = {}
    for pkg in (dali_tpu, dali_tpu_torch):
        for device in ("cpu", "mixed"):
            def build(fn, types, device=device):
                return fn.experimental.inputs.video(sequence_length=4, name="vin", device=device,
                                                    last_sequence_policy=policy)
            pipe = _pipe(pkg, build, 3, device)
            for blob in blobs:
                pipe.feed_input("vin", blob)
            got[(pkg.__name__, device)] = [pipe.run() for _ in range(3)]
    want = got[("dali_tpu", "cpu")]
    assert [len(_samples(o[0])) for o in want] == [3, 1, 3]
    for key, outs in got.items():
        for k, (g, w) in enumerate(zip(outs, want)):
            _assert_same(g, w, (policy, key, k))


def test_serialize_round_trips_between_the_packages(clips):
    """A mixed reader serialized by either package runs in the other with
    the same frames."""
    build = _reader(clips, files=["a", "b"], labels=[1, 2], sequence_length=3,
                    random_shuffle=True)
    port = _pipe(dali_tpu_torch, build, 2, "mixed")
    ref = _pipe(dali_tpu, build, 2, "mixed")
    want = [ref.run() for _ in range(2)]
    blob_port, blob_ref = port.serialize(), ref.serialize()
    a = dali_tpu_torch.Pipeline.deserialize(blob_ref, batch_size=2, num_threads=1, seed=5,
                                            device="cpu")
    a.build()
    b = dali_tpu.Pipeline.deserialize(blob_port, batch_size=2, num_threads=1, seed=5,
                                      debug=True)
    b.build()
    for it in range(2):
        wa, wb = a.run(), b.run()
        _assert_same(wa, want[it], ("port from dali_tpu", it))
        _assert_same(wb, want[it], ("dali_tpu from port", it))
    port.shutdown()
    a.shutdown()


def test_decoder_dense_yuv_alternation_and_undercount(clips, monkeypatch):
    """decoders.Video mixed on one edge alternating between the planar wire
    and the dense path (a batch whose container count undercounts its
    frames: the filled plan probes one frame on and falls back), against the
    cpu placement, in both packages."""
    import dali_tpu.native as ref_native

    from dali_tpu_torch import native

    short = open(clips["v8"], "rb").read()
    long_ = open(clips["v15"], "rb").read()
    for mod in (native, ref_native):
        orig = mod.VideoFile.__init__

        def init(self, path, orig=orig):
            orig(self, path)
            if self.num_frames == 15:  # the long clip's count, 5 short
                self.num_frames = 10
        monkeypatch.setattr(mod.VideoFile, "__init__", init)
    batches = [[short, short], [long_, short], [short, short], [long_, long_]]
    got = {}
    for pkg in (dali_tpu, dali_tpu_torch):
        for device in ("cpu", "mixed"):
            it = iter(batches)

            def build(fn, types, device=device, it=it):
                buf = fn.external_source(
                    source=lambda: [np.frombuffer(b, np.uint8) for b in next(it)], batch=True)
                return fn.decoders.video(buf, sequence_length=100000, pad_mode="none",
                                         device=device)
            pipe = _pipe(pkg, build, 2, device)
            got[(pkg.__name__, device)] = [pipe.run() for _ in batches]
    want = got[("dali_tpu", "cpu")]
    assert [s.shape[0] for s in _samples(want[1][0])] == [15, 8]
    for key, outs in got.items():
        for k, (g, w) in enumerate(zip(outs, want)):
            _assert_same(g, w, (key, k))


def test_experimental_decoder_alias_and_legacy_reader(clips):
    blobs = [np.frombuffer(open(clips["v8"], "rb").read(), np.uint8)]
    outs = []
    for name in ("decoders", "experimental"):
        @dali_tpu_torch.pipeline_def(batch_size=1, num_threads=1, seed=1, device="cpu")
        def p():
            buf = dali_tpu_torch.fn.external_source(source=lambda: blobs, batch=True, cycle=True)
            mod = dali_tpu_torch.fn.decoders if name == "decoders" else \
                dali_tpu_torch.fn.experimental.decoders
            return mod.video(buf, sequence_length=4, device="mixed")
        pipe = p()
        pipe.build()
        outs.append(_samples(pipe.run()[0])[0])
    np.testing.assert_array_equal(outs[0], outs[1])

    @dali_tpu_torch.pipeline_def(batch_size=1, num_threads=1, seed=1, device="cpu")
    def legacy():
        return dali_tpu_torch.fn.video_reader(filenames=[clips["v8"]], sequence_length=4)
    pipe = legacy()
    pipe.build()
    np.testing.assert_array_equal(_samples(pipe.run()[0])[0], outs[0])


@pytest.mark.parametrize("device", ["cpu", "mixed"])
def test_checkpoint_resumes_in_both_packages(clips, device):
    """A shuffled reader's checkpoint after two batches, from dali_tpu and
    from the port, resumes the port's reader on the same sequences."""
    build = _reader(clips, files=["a", "b", "v15"], sequence_length=3, random_shuffle=True)
    kw = {"enable_checkpointing": True}
    ref = _pipe(dali_tpu, build, 2, device, **kw)
    port = _pipe(dali_tpu_torch, build, 2, device, **kw)
    for _ in range(2):
        ref.run()
        port.run()
    cks = {"dali_tpu": ref.checkpoint(), "port": port.checkpoint()}
    want = [ref.run() for _ in range(3)]
    port.shutdown()
    for name, ck in cks.items():
        resumed = _pipe(dali_tpu_torch, build, 2, device, checkpoint=ck, **kw)
        for it in range(3):
            _assert_same(resumed.run(), want[it], (name, it))
        resumed.shutdown()


def test_video_training_recipe_small(tmp_path):
    """docs/examples/video_training.py's recipe (readers.video, resize 112,
    rotate and gaussian blur with per-sequence draws, CMN to FCHW float) at
    2 classes x 2 clips of 160x120, batch 2, 2 iterations, through both
    packages: the uint8 frames equal; the resize and blur hold to the uint8
    contract (equal but for the resampler's one-step flips, ~4e-6 of the
    values); CMN's float output to atol 1e-4 where its input agrees."""
    root = tmp_path / "root"
    rng = np.random.default_rng(7)
    for c in range(2):
        os.makedirs(root / f"class{c}")
        for v in range(2):
            wr = cv2.VideoWriter(str(root / f"class{c}" / f"v{v}.mp4"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), 12, (160, 120))
            base = rng.integers(0, 200, (120, 160, 3), np.uint8)
            for f in range(int(rng.integers(24, 32))):
                wr.write(np.roll(base, shift=3 * f, axis=1))
            wr.release()

    def recipe(pkg, reader_device):
        fn, types = pkg.fn, pkg.types
        opts = {"device": "cpu"} if pkg is dali_tpu_torch else {"debug": True}

        @pkg.pipeline_def(batch_size=2, num_threads=2, seed=7, **opts)
        def p():
            frames, labels = fn.readers.video(
                file_root=str(root), sequence_length=8, stride=2, random_shuffle=True,
                pad_mode="edge", name="Reader", device=reader_device)
            raw = frames if reader_device == "mixed" else frames.gpu()
            resized = fn.resize(raw, resize_x=112, resize_y=112)
            angle = fn.random.uniform(range=[-8.0, 8.0])
            rotated = fn.rotate(resized, angle=angle, keep_size=True, fill_value=0.0)
            sigma = fn.random.uniform(range=[0.1, 1.1])
            blurred = fn.gaussian_blur(rotated, sigma=sigma)
            mirror = fn.random.coin_flip(probability=0.5)
            out = fn.crop_mirror_normalize(
                blurred, mirror=mirror, dtype=types.FLOAT, output_layout="FCHW",
                mean=[0.45 * 255] * 3, std=[0.225 * 255] * 3)
            return out, labels, raw, resized, blurred
        pipe = p()
        pipe.build()
        return pipe

    ref = recipe(dali_tpu, "cpu")
    ports = [recipe(dali_tpu_torch, "cpu"), recipe(dali_tpu_torch, "mixed")]
    for it in range(2):
        want = [_samples(o) for o in ref.run()]
        for k, port in enumerate(ports):
            got = [_samples(o) for o in port.run()]
            for i in range(2):
                assert got[0][i].shape == (8, 3, 112, 112) and got[0][i].dtype == np.float32
                np.testing.assert_array_equal(got[1][i], want[1][i])
                np.testing.assert_array_equal(got[2][i], want[2][i])
                if k == 1:
                    # the mixed reader's graph has no copy node: its random
                    # operators draw other streams, so only the frames compare
                    continue
                for j in (3, 4):
                    flips = got[j][i].astype(np.int16) - want[j][i]
                    assert np.abs(flips).max() <= 1 and np.mean(flips != 0) < 1e-3, (it, i, j)
                # where the blurred pixel and its mirror image agree
                same = got[4][i] == want[4][i]
                close = (same & same[:, :, ::-1]).transpose(0, 3, 1, 2)
                np.testing.assert_allclose(got[0][i][close], want[0][i][close], atol=1e-4)
    for port in ports:
        port.shutdown()


def test_full_range_source_cpu_and_mixed(tmp_path):
    """A clip whose VO header says full range (``with_full_range``): the
    full-range BT.601 on the host and on the planar wire, bit-equal across
    the packages and placements, as dali_tpu's MJPG full-range test holds
    its own."""
    from .write_video_reference import with_full_range

    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "dali_tpu_torch", "testdata", "video", "recipe_160x120.mp4")
    path = tmp_path / "full.mp4"
    path.write_bytes(with_full_range(open(src, "rb").read()))
    runs = _run_all(_reader({"full": str(path)}, files=["full"], sequence_length=3,
                            random_shuffle=True), 2, 2)
    want = runs[("dali_tpu", "cpu")]
    for key, got in runs.items():
        for it in range(2):
            _assert_same(got[it], want[it], (key, it))


@pytest.mark.parametrize("fmt,fourcc", [("avi", "MJPG"), ("avi", "XVID"), ("mkv", "mp4v"),
                                        ("webm", "VP80")])
def test_other_containers_raise_item_8b(tmp_path, fmt, fourcc):
    """VP8 in WebM, which dali_tpu's FFmpeg reads, raises
    NotImplementedError naming item 8b (its part f) in the port, at open
    and through the reader. cv2's AVIs (MJPG and XVID) and its MPEG-4
    Part 2 in Matroska, once among them, read since the AVI part and part
    (b) of item 8b: the same frames as dali_tpu's, from the file and
    through the reader, cpu and mixed."""
    from dali_tpu import native as ref_native

    from dali_tpu_torch import native

    path = str(tmp_path / f"v.{fmt}")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), 25, (64, 48))
    if not wr.isOpened():
        pytest.skip(f"cv2 cannot write {fourcc} in {fmt}")
    for i in range(6):
        wr.write(np.full((48, 64, 3), 20 * i, np.uint8))
    wr.release()
    ref_native.VideoFile(path).close()  # the reference reads it
    if fmt in ("avi", "mkv"):
        mine, ref = native.VideoFile(path), ref_native.VideoFile(path)
        assert (mine.num_frames, mine.fps, mine.pixfmt_class) == (ref.num_frames, ref.fps,
                                                                  ref.pixfmt_class)
        np.testing.assert_array_equal(mine.read(0, 6), ref.read(0, 6))
        runs = _run_all(_reader({"v": path}, files=["v"], sequence_length=2, step=2), 1, 2)
        for key, got in runs.items():
            for it in range(2):
                _assert_same(got[it], runs[("dali_tpu", "cpu")][it], (fourcc, key, it))
        return
    with pytest.raises(NotImplementedError, match="item 8b"):
        native.VideoFile(path)

    @dali_tpu_torch.pipeline_def(batch_size=1, num_threads=1, device="cpu")
    def p():
        return dali_tpu_torch.fn.readers.video(filenames=[path], sequence_length=2)
    pipe = p()
    with pytest.raises(NotImplementedError, match="item 8b"):
        pipe.build()
        pipe.run()


def test_unported_video_names_name_item_8b(tmp_path):
    """readers.VideoResize and OpticalFlow came with item 8b's registry part;
    the rest of item 8b, here VP8 in WebM (item 8b(f); Motion JPEG, HuffYUV
    and MPEG-1 in AVI and then Xvid in Matroska, this test's files before,
    read since the AVI part, the swscale route and parts (a) and (b)), still
    raises naming it, through the resizing reader too."""
    assert callable(dali_tpu_torch.fn.readers.video_resize)
    assert callable(dali_tpu_torch.fn.optical_flow)
    path = str(tmp_path / "v.webm")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"VP80"), 25, (64, 48))
    if not wr.isOpened():
        pytest.skip("cv2 cannot write VP80 in webm")
    for i in range(4):
        wr.write(np.full((48, 64, 3), 30 * i, np.uint8))
    wr.release()

    @dali_tpu_torch.pipeline_def(batch_size=1, num_threads=1, device="cpu")
    def p():
        return dali_tpu_torch.fn.readers.video_resize(filenames=[path], sequence_length=2,
                                                      resize_x=32)
    pipe = p()
    with pytest.raises(NotImplementedError, match=r"item 8b"):
        pipe.build()
        pipe.run()
