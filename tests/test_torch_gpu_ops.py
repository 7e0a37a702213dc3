"""The gpu operators of ROADMAP.md Queue 1 item 5g in dali_tpu_torch on the
CPU, against dali_tpu's gpu lowerings with ``debug=True``.

Inputs come from a numpy seed, ragged wherever the operator takes ragged
batches; both packages build the same graph node for node. Tolerances:

* bit-equal: ElementExtract, SequenceRearrange, PerFrame (and their cpu
  placements), MultiPaste, Dilate/Erode, MedianBlur, Remap and
  WarpPerspective with nearest taps, Debayer;
* within one uint8 step on at most 1e-3 of values: ResizeCropMirror and
  FastResizeCropMirror (the resampler's known rounding ties), Clahe,
  TensorResize, Filter and the linear warps;
* JpegCompressionDistortion: at most 1e-3 of the 8x8 blocks differ (a DCT
  coefficient on the other side of round(coef / q) moves its whole block);
* PowerSpectrum within 1e-5 relative; NonsilentRegion's begin and length
  equal.

Where the reference's lowering ignores an argument or reads canvas padding
of a ragged batch, the port raises or departs on purpose; those tests say
``departs`` or ``raise`` in their names (ROADMAP.md Queue 3).
"""

import os

import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch
from dali_tpu_torch.tools import bench_rcm_jpeg

SEED = 31
RNG = np.random.default_rng(13)
IMGS = [RNG.integers(0, 256, (20 + 4 * i, 26 - 2 * i, 3), np.uint8) for i in range(5)]
GRAY = [RNG.integers(0, 256, (18 + 2 * i, 22 - 2 * i, 1), np.uint8) for i in range(5)]
SMOOTH = [np.clip(np.cumsum(RNG.normal(0, 6, (96 + 16 * i, 120 - 8 * i, 3)), 1) % 256, 0, 255)
          .astype(np.uint8) for i in range(4)]


def _build(pkg, graph, batch, seed=SEED, **kw):
    if pkg is dali_tpu_torch:
        kw.setdefault("device", "cpu")
    else:
        kw.setdefault("debug", True)

    @pkg.pipeline_def(batch_size=batch, num_threads=1, seed=seed, **kw)
    def pipe():
        out = graph(pkg.fn, pkg.types)
        return out if isinstance(out, tuple) else (out,)

    p = pipe()
    p.build()
    return p


def _close(pipe):
    if isinstance(pipe, dali_tpu_torch.Pipeline):
        pipe.shutdown()
    else:
        pipe._executor.shutdown()


def _runs(pkg, graph, batch, n=1, **kw):
    pipe = _build(pkg, graph, batch, **kw)
    try:
        res = []
        for _ in range(n):
            outs = []
            for tl in pipe.run():
                tl = tl.as_cpu() if hasattr(tl, "as_cpu") else tl
                outs.append([np.asarray(tl.at(i)) for i in range(len(tl))])
            res.append(outs)
        return res
    finally:
        _close(pipe)


def _both(graph, batch, n=1, ref_kw=None, **kw):
    return (_runs(dali_tpu_torch, graph, batch, n, **kw),
            _runs(dali_tpu, graph, batch, n, **dict(kw, **(ref_kw or {}))))


def _pairs(got, want):
    assert len(got) == len(want)
    for g_it, w_it in zip(got, want):
        assert len(g_it) == len(w_it)
        for g_out, w_out in zip(g_it, w_it):
            assert len(g_out) == len(w_out)
            for g, w in zip(g_out, w_out):
                assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, g.shape, w.dtype,
                                                                     w.shape)
                yield g, w


def _bit_equal(got, want):
    for g, w in _pairs(got, want):
        np.testing.assert_array_equal(g, w)


def _within_step(got, want, frac=1e-3):
    """At most one step apart, on at most ``frac`` of the values."""
    diffs = [np.abs(g.astype(np.float64) - w.astype(np.float64)).reshape(-1)
             for g, w in _pairs(got, want)]
    d = np.concatenate(diffs)
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= frac, (d > 0).mean()
    return float(d.max()), float((d > 0).mean())


def _src(fn, samples, layout="HWC"):
    return fn.external_source(source=lambda: samples, batch=True, layout=layout)


# ------------------------------------------------------------------ schemas and registry

ITEM_5G = ["ResizeCropMirror", "FastResizeCropMirror", "JpegCompressionDistortion",
           "experimental.Dilate", "experimental.Erode", "experimental.MedianBlur",
           "experimental.Clahe", "experimental.Debayer", "experimental.Filter",
           "experimental.Remap", "experimental.WarpPerspective", "TensorResize",
           "experimental.TensorResize", "experimental.Resize", "MultiPaste", "ElementExtract",
           "SequenceRearrange", "PerFrame", "PowerSpectrum", "NonsilentRegion", "Clahe",
           "Filter", "Debayer"]


@pytest.mark.parametrize("name", ITEM_5G)
def test_schemas_declare_the_references_arguments(name):
    from dali_tpu import _schema as ref_schema
    from dali_tpu_torch import _schema

    mine, ref = _schema.GetSchema(name), ref_schema.GetSchema(name)
    assert set(mine.args) == set(ref.args)
    for k, a in mine.args.items():
        r = ref.args[k]
        assert (a.type, a.default, a.tensor_ok, a.per_sample, a.required) == (
            r.type, r.default, r.tensor_ok, r.per_sample, r.required), (name, k)
    assert (mine.min_inputs, mine.max_inputs, set(mine.devices), mine.has_random_seed) == (
        ref.min_inputs, ref.max_inputs, set(ref.devices), ref.has_random_seed)


def test_registry_lacks_only_audio_resample_and_the_renamed_jax_function_on_gpu():
    from dali_tpu import _schema as ref_schema
    from dali_tpu.backend import parity as ref_parity
    from dali_tpu_torch import _schema

    # operators of dali_tpu's own modules: tests register others into its registry
    missing = {(n, d) for (n, d), impl in ref_schema._impl_registry.items()
               if (n, d) not in _schema._impl_registry and n not in ref_parity._LEGACY
               and impl.__module__.startswith("dali_tpu.")}
    # AudioResample came with item 4: on the gpu only the renamed _JaxFunction is left
    assert {n for n, d in missing if d == "gpu"} == {"_JaxFunction"}
    assert {n for n, d in missing if d == "mixed"} == {
        "decoders.Video", "experimental.decoders.Video", "experimental.inputs.Video",
        "readers.Video", "readers.VideoResize", "VideoReaderResize"}
    cpu = {n for n, d in missing if d == "cpu"}
    # items 4 and 5h: every cpu placement but video's (item 8)
    assert cpu == {"decoders.Video", "experimental.decoders.Video", "experimental.inputs.Video",
                   "readers.Video", "readers.VideoResize", "VideoReaderResize", "OpticalFlow"}
    for name in ITEM_5G:
        assert _schema.has_operator_impl(name, "gpu"), name


# the gpu paths of sequences and volumes the port does not run yet (item 5h.7)
_ITEM_5H7 = {
    "GaussianBlur": lambda fn, x: fn.gaussian_blur(x, sigma=1.0),
    "experimental.Equalize": lambda fn, x: fn.experimental.equalize(x),
    "WarpAffine": lambda fn, x: fn.warp_affine(x, matrix=[1.0, 0.0, 1.0, 0.0, 1.0, 0.0]),
    "Rotate": lambda fn, x: fn.rotate(x, angle=15.0),
    "Resize": lambda fn, x: fn.resize(x, size=fn.external_source(
        source=lambda: [np.array([2 + i, 4, 4], np.float32) for i in range(2)], batch=True)),
}


@pytest.mark.parametrize("name", sorted(_ITEM_5H7))
def test_cpu_placements_name_item_5h(name):
    """Every cpu placement of item 5h is ported; what names it still is the
    gpu path of DHWC volumes (5h.7), which dali_tpu runs on the cpu only."""
    from dali_tpu_torch._schema import get_operator_impl

    assert get_operator_impl(name, "cpu")
    vols = [np.zeros((3 + i, 6, 8, 1), np.uint8) for i in range(2)]
    pipe = _build(dali_tpu_torch, lambda fn, t: _ITEM_5H7[name](fn, _src(fn, vols, "DHWC").gpu()),
                  2)
    try:
        with pytest.raises(NotImplementedError, match=r"Queue 1, item 5h\.7"):
            pipe.run()
    finally:
        _close(pipe)


# ------------------------------------------------------------------ sequences

SEQS = [RNG.integers(0, 256, (4, 6 + i, 5, 3), np.uint8) for i in range(3)]
ORDERS = [np.array(o, np.int32) for o in ([3, 0, 1, 2], [1, 1, 0, 2], [2, 3, 0, 1])]


@pytest.mark.parametrize("device", ["cpu", "gpu"])
@pytest.mark.parametrize("case", ["extract", "rearrange", "rearrange_per_sample", "per_frame"])
def test_sequence_ops_bit_equal(case, device):
    def graph(fn, types):
        x = _src(fn, SEQS, "FHWC")
        x = x.gpu() if device == "gpu" else x
        if case == "extract":
            return fn.element_extract(x, element_map=[0, 3, 1])
        if case == "rearrange":
            return fn.sequence_rearrange(x, new_order=[2, 0, 3, 1])
        if case == "rearrange_per_sample":
            return fn.sequence_rearrange(x, new_order=_src(fn, ORDERS, ""))
        return fn.per_frame(fn.element_extract(x, element_map=[1]), replace=True)

    got, want = _both(graph, 3)
    _bit_equal(got, want)


# ------------------------------------------------------------------ morphology and median


@pytest.mark.parametrize("op,kw", [
    ("dilate", {}), ("erode", {}), ("dilate", {"mask_size": [4, 2]}),
    ("erode", {"mask_size": [3, 5], "iterations": 2}),
    ("dilate", {"border_mode": "replicate"}), ("erode", {"border_mode": "replicate",
                                                         "mask_size": [5, 3]}),
])
def test_morphology_bit_equal(op, kw):
    got, want = _both(lambda fn, t: getattr(fn.experimental, op)(_src(fn, IMGS).gpu(), **kw), 5)
    _bit_equal(got, want)


def test_morphology_anchor_raises():
    with pytest.raises(NotImplementedError, match="anchor"):
        _runs(dali_tpu_torch, lambda fn, t: fn.experimental.dilate(_src(fn, IMGS).gpu(),
                                                                   anchor=[0, 0]), 5)


@pytest.mark.parametrize("window", [3, 5])
@pytest.mark.parametrize("imgs", ["rgb", "gray"])
def test_median_blur_bit_equal(window, imgs):
    data = IMGS if imgs == "rgb" else GRAY
    got, want = _both(lambda fn, t: fn.experimental.median_blur(_src(fn, data).gpu(),
                                                                window_size=[window]), 5)
    _bit_equal(got, want)


def test_median_blur_chunks_equal_one_pass(monkeypatch):
    from dali_tpu_torch.backend import straggler_gpu

    graph = lambda fn, t: fn.experimental.median_blur(_src(fn, IMGS).gpu(),  # noqa: E731
                                                      window_size=[5])
    whole = _runs(dali_tpu_torch, graph, 5)
    monkeypatch.setattr(straggler_gpu, "MEDIAN_CHUNK_BYTES", 1)
    _bit_equal(_runs(dali_tpu_torch, graph, 5), whole)


# ------------------------------------------------------------------ Clahe, Debayer, Filter


@pytest.mark.parametrize("kw", [{}, {"luma_only": False}, {"tiles_x": 3, "tiles_y": 2,
                                                          "clip_limit": 2.0, "bins": 64}])
def test_clahe_within_one_step(kw):
    got, want = _both(lambda fn, t: fn.experimental.clahe(_src(fn, SMOOTH).gpu(), **kw), 4)
    _within_step(got, want)


def test_clahe_gray_within_one_step():
    got, want = _both(lambda fn, t: fn.experimental.clahe(_src(fn, GRAY).gpu(), tiles_x=2,
                                                          tiles_y=2), 5)
    _within_step(got, want)


BAYER = [RNG.integers(0, 256, (16, 20, 1), np.uint8) for _ in range(4)]
BAYER16 = [RNG.integers(0, 4096, (12, 14), np.uint16) for _ in range(4)]


@pytest.mark.parametrize("blue", [[0, 0], [0, 1], [1, 0], [1, 1]])
@pytest.mark.parametrize("data", ["u8", "u16"])
def test_debayer_bit_equal(blue, data):
    src = BAYER if data == "u8" else BAYER16
    layout = "HWC" if data == "u8" else "HW"
    got, want = _both(lambda fn, t: fn.experimental.debayer(_src(fn, src, layout).gpu(),
                                                            blue_position=blue), 4)
    _bit_equal(got, want)


RAGGED_BAYER = [RNG.integers(0, 256, (10 + 2 * i, 16 - 2 * i), np.uint8) for i in range(4)]


def _alone(op_graph, samples, layout):
    """Each sample through ``op_graph`` in a batch of its own (the port)."""
    return [_runs(dali_tpu_torch, lambda fn, t, s=s: op_graph(fn, _src(fn, [s], layout).gpu()),
                  1)[0][0][0] for s in samples]


def test_debayer_departs_on_ragged_batches_each_sample_as_alone():
    op = lambda fn, x: fn.experimental.debayer(x, blue_position=[1, 0])  # noqa: E731
    batch = _runs(dali_tpu_torch, lambda fn, t: op(fn, _src(fn, RAGGED_BAYER, "HW").gpu()), 4)
    for got, want in zip(batch[0][0], _alone(op, RAGGED_BAYER, "HW")):
        np.testing.assert_array_equal(got, want)
    ref = _runs(dali_tpu, lambda fn, t: op(fn, _src(fn, RAGGED_BAYER, "HW").gpu()), 4)
    assert any(not np.array_equal(g, w) for g, w in zip(batch[0][0], ref[0][0]))


def test_debayer_edge_aware_raises():
    with pytest.raises(NotImplementedError, match="algorithm"):
        _runs(dali_tpu_torch, lambda fn, t: fn.experimental.debayer(
            _src(fn, BAYER).gpu(), algorithm="edge_aware"), 4)


KERNELS = [RNG.uniform(-0.3, 0.5, (5, 5)).astype(np.float32) for _ in range(5)]
UNIFORM = [RNG.integers(0, 256, (24, 28, 3), np.uint8) for _ in range(5)]


@pytest.mark.parametrize("ksize", [(3, 3), (5, 5), (2, 4)])
def test_filter_within_one_step(ksize):
    ks = [k[:ksize[0], :ksize[1]].copy() for k in KERNELS]
    got, want = _both(lambda fn, t: fn.experimental.filter(_src(fn, UNIFORM).gpu(),
                                                           _src(fn, ks, "").gpu()), 5)
    _within_step(got, want)


def test_filter_departs_on_ragged_batches_each_sample_as_alone():
    ks = [k[:3, :3].copy() for k in KERNELS]
    batch = _runs(dali_tpu_torch, lambda fn, t: fn.experimental.filter(
        _src(fn, IMGS).gpu(), _src(fn, ks, "").gpu()), 5)
    for i, s in enumerate(IMGS):
        alone = _runs(dali_tpu_torch, lambda fn, t: fn.experimental.filter(
            _src(fn, [s]).gpu(), _src(fn, [ks[i]], "").gpu()), 1)[0][0][0]
        np.testing.assert_array_equal(batch[0][0][i], alone)


@pytest.mark.parametrize("kw", [{"border": "constant"}, {"mode": "valid"}, {"anchor": [0, 0]},
                                {"fill_value": 3.0}, "fill_input", "ragged_kernels"])
def test_filter_unserved_arguments_raise(kw):
    ks = KERNELS
    if kw == "ragged_kernels":
        ks = [k[:3 + i % 2, :3].copy() for i, k in enumerate(KERNELS)]

    def graph(fn, t):
        args = [_src(fn, UNIFORM).gpu(), _src(fn, ks, "").gpu()]
        if kw == "fill_input":
            args.append(_src(fn, [np.float32(1)] * 5, "").gpu())
        return fn.experimental.filter(*args, **(kw if isinstance(kw, dict) else {}))

    with pytest.raises(NotImplementedError, match="Queue 3"):
        _runs(dali_tpu_torch, graph, 5)


# ------------------------------------------------------------------ Remap, WarpPerspective

MAPS = []
for _s in UNIFORM:
    _yy, _xx = np.mgrid[0:20, 0:22].astype(np.float32)
    MAPS.append((_xx * 1.1 + RNG.uniform(-2, 2, _xx.shape).astype(np.float32),
                 _yy * 1.05 + RNG.uniform(-2, 2, _yy.shape).astype(np.float32)))


@pytest.mark.parametrize("interp", ["nn", "linear"])
def test_remap_center_origin_matches(interp):
    def graph(fn, types):
        it = types.INTERP_NN if interp == "nn" else types.INTERP_LINEAR
        return fn.experimental.remap(_src(fn, UNIFORM).gpu(), _src(fn, [m[0] for m in MAPS],
                                                                   "").gpu(),
                                     _src(fn, [m[1] for m in MAPS], "").gpu(), interp=it,
                                     pixel_origin="center")

    got, want = _both(graph, 5)
    (_bit_equal if interp == "nn" else _within_step)(got, want)


def test_remap_departs_with_corner_origin_by_half_a_pixel():
    def graph(mx, my, **kw):
        return lambda fn, t: fn.experimental.remap(_src(fn, UNIFORM).gpu(), _src(fn, mx, "").gpu(),
                                                   _src(fn, my, "").gpu(), **kw)

    mx, my = [m[0] for m in MAPS], [m[1] for m in MAPS]
    corner = _runs(dali_tpu_torch, graph(mx, my), 5)
    center = _runs(dali_tpu_torch, graph([m - 0.5 for m in mx], [m - 0.5 for m in my],
                                         pixel_origin="center"), 5)
    _bit_equal(corner, center)


HOMOG = [np.array([[1.05, 0.08, -2.0], [-0.06, 0.97, 1.5], [1e-3, -8e-4, 1.0]], np.float32)
         + RNG.uniform(-0.01, 0.01, (3, 3)).astype(np.float32) for _ in range(5)]


@pytest.mark.parametrize("kw", [
    {"interp_type": "nn"}, {"interp_type": "nn", "pixel_origin": "center"},
    {"interp_type": "nn", "border_mode": "replicate", "size": [18, 30]},
    {"interp_type": "linear"}, {"interp_type": "linear", "inverse_map": False},
    {"interp_type": "linear", "fill_value": 7.0, "border_mode": "constant"},
])
@pytest.mark.parametrize("matrix", ["arg", "input"])
def test_warp_perspective(kw, matrix):
    kw = dict(kw)
    nn = kw.pop("interp_type") == "nn"

    def graph(fn, types):
        x = _src(fn, IMGS).gpu()
        it = types.INTERP_NN if nn else types.INTERP_LINEAR
        if matrix == "input":
            return fn.experimental.warp_perspective(x, _src(fn, HOMOG, "").gpu(), interp_type=it,
                                                    **kw)
        return fn.experimental.warp_perspective(x, matrix=_src(fn, [h.reshape(-1) for h in HOMOG],
                                                               ""), interp_type=it, **kw)

    got, want = _both(graph, 5)
    (_bit_equal if nn and kw.get("inverse_map", True) else _within_step)(got, want)


# ------------------------------------------------------------------ TensorResize, MultiPaste

VOLS = [RNG.uniform(0, 200, (6 + i, 9 - i, 5)).astype(np.float32) for i in range(3)]


@pytest.mark.parametrize("name", ["tensor_resize", "experimental.tensor_resize"])
@pytest.mark.parametrize("kw", [{"scales": [0.5, 1.5], "axes": [0, 1]},
                                {"sizes": [7, 4], "axes": [1, 2], "interp_type": "nn"},
                                {"scales": [2.0], "axis_names": "W", "dtype": "u8"}])
def test_tensor_resize_within_one_step(name, kw):
    kw = dict(kw)

    def graph(fn, types):
        k = dict(kw)
        if k.get("interp_type") == "nn":
            k["interp_type"] = types.INTERP_NN
        if k.get("dtype") == "u8":
            k["dtype"] = types.UINT8
        op = fn.experimental.tensor_resize if "." in name else fn.tensor_resize
        return op(_src(fn, VOLS, "HWC").gpu(), **k)

    got, want = _both(graph, 3)
    _within_step(got, want)


def test_tensor_resize_per_sample_scales_and_unserved_arguments():
    scales = [np.array([0.5 + 0.25 * i, 1.0], np.float32) for i in range(3)]
    got, want = _both(lambda fn, t: fn.tensor_resize(_src(fn, VOLS, "HWC").gpu(),
                                                     scales=_src(fn, scales, ""), axes=[0, 1]), 3)
    _within_step(got, want)
    for kw in ({"mode": "not_larger"}, {"roi_start": [1.0, 1.0]}, {"size_rounding": "ceil"}):
        with pytest.raises(NotImplementedError, match="Queue 3"):
            _runs(dali_tpu_torch, lambda fn, t: fn.tensor_resize(
                _src(fn, VOLS, "HWC").gpu(), scales=[0.5, 0.5], axes=[0, 1], **kw), 3)


IDS = [np.array(v, np.int32) for v in ([1, 0], [2, 2], [0, 3], [3, 1])]
OUT_ANCH = [np.array(v, np.int32).reshape(-1) for v in ([[0, 0], [10, 6]], [[2, 3], [20, 1]],
                                                        [[5, 5], [20, 12]], [[1, 1], [12, 14]])]
SHAPES = [np.array(v, np.int32).reshape(-1) for v in ([[12, 10], [20, 30]], [[40, 40], [3, 4]],
                                                      [[10, 12], [6, 6]], [[18, 13], [9, 9]])]


@pytest.mark.parametrize("case", ["abs", "rel", "size_per_sample", "defaults"])
def test_multi_paste_bit_equal(case):
    def graph(fn, types):
        x = _src(fn, IMGS[:4]).gpu()
        ids = _src(fn, IDS, "")
        if case == "abs":
            return fn.multi_paste(x, in_ids=ids, out_anchors=_src(fn, OUT_ANCH, ""),
                                  shapes=_src(fn, SHAPES, ""), output_size=[36, 40])
        if case == "rel":
            rel = [np.full(2 * len(v), 0.25, np.float32) for v in IDS]
            return fn.multi_paste(x, in_ids=ids, in_anchors_rel=_src(fn, rel, ""),
                                  out_anchors_rel=_src(fn, rel, ""), output_size=[33, 27])
        if case == "size_per_sample":
            sizes = [np.array([30 + i, 25 + 2 * i], np.int32) for i in range(4)]
            return fn.multi_paste(x, in_ids=ids, out_anchors=_src(fn, OUT_ANCH, ""),
                                  output_size=_src(fn, sizes, ""))
        return fn.multi_paste(x, in_ids=ids)

    # the reference's lowering indexes its numpy parameters with traced
    # sample indices, which only its jitted program takes; a paste has no
    # arithmetic for the jit to fuse
    got, want = _both(graph, 4, ref_kw={"debug": False})
    _bit_equal(got, want)


RAGGED_IDS = [np.array(v, np.int32) for v in ([1], [2, 0, 3], [3, 1], [0, 1, 2, 3])]


def test_multi_paste_departs_to_take_ragged_region_lists():
    """The reference's executor stacks ``in_ids`` and fails on a ragged
    batch of them; here a mosaic of 1 to 4 regions per output, against the
    same composition in numpy."""
    anchors = [np.array([[3 * j, 5 * j] for j in range(len(v))], np.int32).reshape(-1)
               for v in RAGGED_IDS]
    got = _runs(dali_tpu_torch, lambda fn, t: fn.multi_paste(
        _src(fn, IMGS[:4]).gpu(), in_ids=_src(fn, RAGGED_IDS, ""),
        out_anchors=_src(fn, anchors, ""), output_size=[30, 32]), 4)[0][0]
    for i, ids in enumerate(RAGGED_IDS):
        want = np.zeros((30, 32, 3), np.uint8)
        for j, sid in enumerate(ids):
            oy, ox = anchors[i][2 * j:2 * j + 2]
            src = IMGS[sid]
            h, w = min(src.shape[0], 30 - oy), min(src.shape[1], 32 - ox)
            want[oy:oy + h, ox:ox + w] = src[:h, :w]
        np.testing.assert_array_equal(got[i], want)


def test_multi_paste_departs_to_honour_dtype():
    got = _runs(dali_tpu_torch, lambda fn, t: fn.multi_paste(
        _src(fn, IMGS[:4]).gpu(), in_ids=_src(fn, IDS, ""), dtype=t.FLOAT), 4)
    plain = _runs(dali_tpu_torch, lambda fn, t: fn.multi_paste(
        _src(fn, IMGS[:4]).gpu(), in_ids=_src(fn, IDS, "")), 4)
    for g, p in zip(got[0][0], plain[0][0]):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, p.astype(np.float32))


# ------------------------------------------------------------------ ResizeCropMirror

CROP_X = [np.float32(v) for v in (0.0, 0.3, 1.0, 0.61, 0.5)]
MIRROR = [np.int32(v) for v in (1, 0, 1, 1, 0)]


@pytest.mark.parametrize("name", ["resize_crop_mirror", "fast_resize_crop_mirror"])
@pytest.mark.parametrize("kw", [
    {"resize_shorter": 20.0, "crop": [14, 12], "mirror": "tensor", "crop_pos_x": "tensor"},
    {"resize_x": 30.0, "resize_y": 18.0, "crop": [16, 16], "mirror": 1, "crop_pos_y": 0.2},
    {"resize_shorter": 15.0, "crop_h": 10.0, "crop_w": 9.0, "rounding": "truncate"},
    {"size": [22.0, 19.0], "interp_type": "nn"},
    {"resize_longer": 40.0, "crop": [20, 20], "min_filter": "triangular", "antialias": True},
    {"resize_shorter": 20.0, "crop": [12, 12], "roi_start": [2.0, 3.0], "roi_end": [18.0, 20.0]},
])
def test_resize_crop_mirror_within_one_step(name, kw):
    def graph(fn, types):
        k = dict(kw)
        if k.get("mirror") == "tensor":
            k["mirror"] = _src(fn, MIRROR, "")
        if k.get("crop_pos_x") == "tensor":
            k["crop_pos_x"] = _src(fn, CROP_X, "")
        if k.get("interp_type") == "nn":
            k["interp_type"] = types.INTERP_NN
        if k.get("min_filter") == "triangular":
            k["min_filter"] = types.INTERP_TRIANGULAR
        return getattr(fn, name)(_src(fn, IMGS).gpu(), **k)

    got, want = _both(graph, 5)
    _within_step(got, want)


def test_resize_crop_mirror_rejections():
    with pytest.raises(NotImplementedError, match="crop_d"):
        _runs(dali_tpu_torch, lambda fn, t: fn.resize_crop_mirror(
            _src(fn, IMGS).gpu(), resize_shorter=20.0, crop=[8, 8], crop_d=4.0), 5)
    with pytest.raises(ValueError, match="per-sample tensor crop_h"):
        _runs(dali_tpu_torch, lambda fn, t: fn.resize_crop_mirror(
            _src(fn, IMGS).gpu(), resize_shorter=20.0,
            crop_h=_src(fn, [np.float32(8)] * 5, ""), crop_w=8.0), 5)
    with pytest.raises(ValueError, match="batch-uniform output size"):
        _runs(dali_tpu_torch, lambda fn, t: fn.resize_crop_mirror(_src(fn, IMGS).gpu(),
                                                                  resize_shorter=20.0), 5)


def test_experimental_resize_is_resize():
    got, want = _both(lambda fn, t: fn.experimental.resize(_src(fn, IMGS).gpu(), resize_x=17,
                                                           resize_y=13), 5)
    _within_step(got, want)
    with pytest.raises(NotImplementedError, match="Queue 3"):
        _runs(dali_tpu_torch, lambda fn, t: fn.experimental.resize(
            _src(fn, IMGS).gpu(), resize_x=17, resize_y=13, roi_start=[1.0, 1.0]), 5)


# ------------------------------------------------------------------ JpegCompressionDistortion


def block_diff(got, want):
    """(share of the 8x8 blocks of the images that differ anywhere, max abs
    difference)."""
    return bench_rcm_jpeg.block_diff(_pairs(got, want))


QUALITY = [np.float32(q) for q in (30, 95, 50, 71)]


@pytest.mark.parametrize("quality", ["tensor", 10.0, 50.0, 90.0])
def test_jpeg_compression_distortion_block_bound(quality):
    q = quality

    def graph(fn, types):
        return fn.jpeg_compression_distortion(
            _src(fn, SMOOTH).gpu(), quality=_src(fn, QUALITY, "") if q == "tensor" else q)

    got, want = _both(graph, 4)
    share, worst = block_diff(got, want)
    assert share <= 1e-3, (share, worst)


# ------------------------------------------------------------------ PowerSpectrum, NonsilentRegion

SIGNALS = [RNG.normal(0, 1, (400,)).astype(np.float32) for _ in range(3)]
RAGGED_SIGNALS = [RNG.normal(0, 1, (300 + 50 * i,)).astype(np.float32) for i in range(3)]
FRAMES = [RNG.normal(0, 1, (6, 64)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("device", ["cpu", "gpu"])
@pytest.mark.parametrize("case", ["power", "magnitude_nfft", "ragged", "frames_axis0"])
def test_power_spectrum_within_1e5_relative(case, device):
    def graph(fn, types):
        data = {"ragged": RAGGED_SIGNALS, "frames_axis0": FRAMES}.get(case, SIGNALS)
        x = _src(fn, data, "")
        x = x.gpu() if device == "gpu" else x
        kw = {"magnitude_nfft": {"power": 1, "nfft": 256}, "frames_axis0": {"axis": 0}}
        return fn.power_spectrum(x, **kw.get(case, {}))

    got, want = _both(graph, 3)
    for g, w in _pairs(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()))


def _clip(rng, n, lead, tail, scale=0.5):
    x = np.zeros(n, np.float32)
    x[lead:n - tail] = rng.normal(0, scale, n - lead - tail)
    return x + rng.normal(0, 1e-5, n).astype(np.float32)


CLIPS = [_clip(RNG, 3000 + 500 * i, 400 + 100 * i, 300 * i) for i in range(4)]


@pytest.mark.parametrize("kw", [{}, {"window_length": 256, "cutoff_db": -30.0},
                                {"reference_power": 0.01, "window_length": 100},
                                {"window_length": 5000}])
def test_nonsilent_region_equal_begin_and_length(kw):
    got, want = _both(lambda fn, t: fn.nonsilent_region(_src(fn, CLIPS, "").gpu(), **kw), 4)
    _bit_equal(got, want)


def test_jpeg_compression_distortion_near_a_real_jpeg_round_trip():
    """Against an independent encoder: libjpeg through cv2 at the same
    integer quality, on corpus crops (mean absolute difference under 1.5
    levels, where the distortion itself moves the images by 5 or more)."""
    import glob

    import cv2

    files = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "dali_tpu_torch",
                                          "testdata", "rn50", "*", "*.jpg")))[:4]
    imgs = [np.ascontiguousarray(cv2.imread(f)[:160, :200, ::-1]) for f in files]
    got = _runs(dali_tpu_torch, lambda fn, t: fn.jpeg_compression_distortion(
        _src(fn, imgs).gpu(), quality=50.0), 4)[0][0]
    for img, out in zip(imgs, got):
        ok, buf = cv2.imencode(".jpg", img[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, 50])
        ref = cv2.imdecode(buf, cv2.IMREAD_COLOR)[:, :, ::-1].astype(np.int32)
        moved = np.abs(out.astype(np.int32) - img).mean()
        assert moved > 2.0 and np.abs(out.astype(np.int32) - ref).mean() < 1.5, moved


# ------------------------------------------------------------------ the augmentation gallery

GALLERY_RANDOM = ("gaussian_noise", "jitter", "salt_pepper")


def _gallery(fn, types, samples):
    """``docs/examples/augmentation_gallery.py``'s ``augment_all`` on a
    ``.gpu()`` input, its outputs in name order."""
    x = fn.external_source(source=lambda: samples, batch=True, cycle=True, layout="HWC").gpu()
    outs = {
        "rotate": fn.rotate(x, angle=fn.random.uniform(range=[-30., 30.]), keep_size=True,
                            fill_value=0.0),
        "warp_affine": fn.warp_affine(x, matrix=[1.0, 0.15, 0.0, 0.05, 1.0, 2.0],
                                      fill_value=128.0),
        "water": fn.water(x), "sphere": fn.sphere(x), "jitter": fn.jitter(x, nDegree=2),
        "flip": fn.flip(x, horizontal=1),
        "brightness_contrast": fn.brightness_contrast(x, brightness=1.2, contrast=1.3),
        "hsv": fn.hsv(x, hue=30.0, saturation=1.2, value=1.0),
        "color_twist": fn.color_twist(x, hue=15.0, saturation=0.8, brightness=1.1,
                                      contrast=1.05),
        "grayscale": fn.color_space_conversion(x, image_type=types.RGB, output_type=types.GRAY),
        "equalize": fn.experimental.equalize(x),
        "grid_mask": fn.grid_mask(x, tile=16, ratio=0.4, angle=0.3),
        "erase": fn.erase(x, anchor=[0.2, 0.3], shape=[0.4, 0.3], axis_names="HW",
                          normalized=True, fill_value=100.0),
        "gaussian_noise": fn.noise.gaussian(x, stddev=12.0),
        "salt_pepper": fn.noise.salt_and_pepper(x, prob=0.03),
        "jpeg_artifacts": fn.jpeg_compression_distortion(x, quality=8),
        "gaussian_blur": fn.gaussian_blur(x, sigma=1.4),
        "laplacian": fn.laplacian(x, window_size=3, dtype=types.FLOAT),
    }
    return tuple(outs[k] for k in sorted(outs))


def test_augmentation_gallery_on_gpu_input_runs_whole():
    """Every output of the gallery's graph on a ``.gpu()`` input: the
    deterministic ones against dali_tpu (uint8 within one step on at most
    1e-3 of values, JPEG by the block bound, the float Laplacian within 1e-4
    relative), the device-random ones (noise, jitter) by shape and dtype."""
    rng = np.random.default_rng(21)
    samples = [rng.integers(0, 256, (48, 64, 3), np.uint8) for _ in range(4)]
    names = sorted(["rotate", "warp_affine", "water", "sphere", "jitter", "flip",
                    "brightness_contrast", "hsv", "color_twist", "grayscale", "equalize",
                    "grid_mask", "erase", "gaussian_noise", "salt_pepper", "jpeg_artifacts",
                    "gaussian_blur", "laplacian"])
    got, want = _both(lambda fn, t: _gallery(fn, t, samples), 4, seed=33)
    for name, g_out, w_out in zip(names, got[0], want[0]):
        for g, w in zip(g_out, w_out):
            assert g.shape == w.shape and g.dtype == w.dtype, name
        if name in GALLERY_RANDOM:
            continue
        if name == "jpeg_artifacts":
            share, worst = block_diff([[g_out]], [[w_out]])
            assert share <= 1e-3, (share, worst)
        elif name == "laplacian":
            for g, w in zip(g_out, w_out):
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
        else:
            _within_step([[g_out]], [[w_out]])
