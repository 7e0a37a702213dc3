"""readers.VideoResize and its alias VideoReaderResize of dali_tpu_torch
(ROADMAP Queue 1 item 8b, registry part), cpu and mixed, against dali_tpu's
cpu and mixed placements (``debug=True``) on the committed clips of
``dali_tpu_torch/testdata/video``: the 320x240 corpus, ``odd_170x98.mp4``
and ``pan_64x48.mp4``.

Tolerance: none. uint8 frames, labels and frame numbers are bit-equal
across the four runs; timestamps hold to rtol 1e-6 (dali_tpu's mixed
placement returns them as float32, the port keeps float64)."""

import os

import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch
from dali_tpu_torch.types import DALIInterpType

VIDEO = os.path.join(os.path.dirname(__file__), "..", "dali_tpu_torch", "testdata", "video")
CORPUS = os.path.join(VIDEO, "corpus")
ODD = os.path.join(VIDEO, "odd_170x98.mp4")
PAN = os.path.join(VIDEO, "pan_64x48.mp4")


def _samples(tl):
    if hasattr(tl, "as_cpu"):
        tl = tl.as_cpu()
    return [np.asarray(tl.at(i)) for i in range(len(tl))]


def _run(pkg, device, name, batch, iters, **kw):
    opts = {"device": "cpu"} if pkg is dali_tpu_torch else {"debug": True}

    @pkg.pipeline_def(batch_size=batch, num_threads=2, seed=7, **opts)
    def p():
        reader = pkg.fn.readers.video_resize if name == "readers.VideoResize" else \
            pkg.fn.video_reader_resize
        return reader(device=device, **kw)

    pipe = p()
    pipe.build()
    try:
        return [[_samples(o) for o in pipe.run()] for _ in range(iters)]
    finally:
        if hasattr(pipe, "shutdown"):
            pipe.shutdown()


def _assert_same(got, want, what):
    assert len(got) == len(want), what
    for it, (g_it, w_it) in enumerate(zip(got, want)):
        assert len(g_it) == len(w_it), (what, it)
        for j, (g, w) in enumerate(zip(g_it, w_it)):
            for i, (a, b) in enumerate(zip(g, w)):
                assert a.shape == b.shape, (what, it, j, i, a.shape, b.shape)
                if a.dtype.kind == "f" or b.dtype.kind == "f":
                    np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64),
                                               rtol=1e-6, atol=0, err_msg=str((what, it, j, i)))
                else:
                    assert a.dtype == b.dtype, (what, it, j, i, a.dtype, b.dtype)
                    np.testing.assert_array_equal(a, b, err_msg=str((what, it, j, i)))


SEQ = dict(sequence_length=3, enable_frame_num=True, enable_timestamps=True)
LINEAR, CUBIC = DALIInterpType.INTERP_LINEAR, DALIInterpType.INTERP_CUBIC
# (reader arguments, batch, iterations)
CASES = {
    "corpus_xy": (dict(file_root=CORPUS, stride=2, random_shuffle=True, resize_x=171,
                       resize_y=128, **SEQ), 2, 2),
    "corpus_shorter_cubic": (dict(file_root=CORPUS, resize_shorter=100, interp_type=CUBIC,
                                  **SEQ), 2, 1),
    "odd_size_default": (dict(filenames=[ODD], size=[64, 80], **SEQ), 2, 1),
    "odd_size_stretch": (dict(filenames=[ODD], size=[64, 80], mode="stretch", **SEQ), 2, 1),
    "odd_size_not_larger": (dict(filenames=[ODD], size=[64, 80], mode="not_larger", **SEQ),
                            2, 1),
    "odd_size_not_smaller": (dict(filenames=[ODD], size=[64, 80], mode="not_smaller", **SEQ),
                             2, 1),
    "odd_linear_no_antialias": (dict(filenames=[ODD], resize_x=61, resize_y=37,
                                     interp_type=LINEAR, antialias=False, **SEQ), 2, 1),
    "odd_cubic_no_antialias": (dict(filenames=[ODD], resize_x=61, resize_y=37,
                                    interp_type=CUBIC, antialias=False, **SEQ), 2, 1),
    "pan_upscale_cubic": (dict(filenames=[PAN], resize_x=100, resize_y=75,
                               interp_type=CUBIC, **SEQ), 2, 1),
    "pan_roi_relative": (dict(filenames=[PAN], roi_start=[0.1, 0.25], roi_end=[0.9, 0.8],
                              roi_relative=True, resize_shorter=32, **SEQ), 2, 1),
    "pan_roi_absolute": (dict(filenames=[PAN], roi_start=[5.4, 7.6], roi_end=[40.2, 50.5],
                              resize_x=40, **SEQ), 2, 1),
    "pan_roi_only": (dict(filenames=[PAN], roi_start=[4, 8], **SEQ), 2, 1),
    "pan_pad_stride": (dict(filenames=[PAN], sequence_length=6, stride=5, step=40,
                            pad_mode="constant", fill_value=[9], resize_y=24,
                            enable_frame_num=True), 2, 1),
    "pan_no_extents": (dict(filenames=[PAN], **SEQ), 2, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_video_resize_matches_dali_tpu(case):
    kw, batch, iters = CASES[case]
    want = _run(dali_tpu, "cpu", "readers.VideoResize", batch, iters, **kw)
    for pkg in (dali_tpu, dali_tpu_torch):
        for device in ("cpu", "mixed"):
            if (pkg, device) != (dali_tpu, "cpu"):
                got = _run(pkg, device, "readers.VideoResize", batch, iters, **kw)
                _assert_same(got, want, (case, pkg.__name__, device))


def test_video_reader_resize_alias_runs_as_its_target():
    kw = dict(filenames=[PAN], resize_x=32, resize_y=24, **SEQ)
    want = _run(dali_tpu_torch, "cpu", "readers.VideoResize", 2, 1, **kw)
    for device in ("cpu", "mixed"):
        _assert_same(_run(dali_tpu_torch, device, "VideoReaderResize", 2, 1, **kw), want,
                     device)
    _assert_same(_run(dali_tpu, "cpu", "VideoReaderResize", 2, 1, **kw), want, "dali_tpu")


def test_video_resize_schema_equals_the_references():
    from dali_tpu import _schema as ref_schema
    from dali_tpu_torch import _schema

    for name in ("readers.VideoResize", "VideoReaderResize"):
        mine, ref = _schema.GetSchema(name), ref_schema.GetSchema(name)
        assert set(mine.args) == set(ref.args), name
        for k, a in mine.args.items():
            r = ref.args[k]
            assert (a.type, a.default, a.required) == (r.type, r.default, r.required), (name, k)
        assert (set(mine.devices), mine.min_inputs, mine.max_inputs, mine.is_reader) == (
            set(ref.devices), ref.min_inputs, ref.max_inputs, ref.is_reader)
    assert _schema.GetSchema("VideoReaderResize") is _schema.GetSchema("readers.VideoResize")


def test_video_resize_mixed_takes_the_dense_path():
    """The mixed placement is the plain reader's, as in the reference: the
    frames cross as dense RGB, never as readers.Video's planar YUV wire."""
    from dali_tpu_torch.backend.parity import VideoResizeReader
    from dali_tpu_torch.backend.video import VideoReaderMixed
    from dali_tpu_torch._schema import get_operator_impl

    impl = get_operator_impl("readers.VideoResize", "mixed")
    assert impl is VideoResizeReader and not issubclass(impl, VideoReaderMixed)
