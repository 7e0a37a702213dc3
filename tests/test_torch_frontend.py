"""The front end and the PyTorch plugin of dali_tpu_torch against dali_tpu,
on the CPU: the Pipeline constructor, its output contracts, serialization
across the two packages, the dot file, ``epoch_size`` and executor
statistics, the ``ops`` class API, custom operators, the legacy and
experimental names, the ``types`` names, ``feed_ndarray`` and the
iterator's ``prepare_first_batch``, ``fill_last_batch`` and checkpoints.

Serialization: a payload written by either package loads in the other
(``"dali_tpu.graph.v1"``), and the rebuilt pipeline's outputs are bit-equal
to those of the pipeline it was written from, in the same package. The
graphs are tests/test_torch_pipeline.py's rn50_train at batch 8 and copies
of the graphs of docs/examples/serialization.py (with its operators on the
device: the port has no cpu Resize, Rotate or CropMirrorNormalize yet) and
docs/examples/reductions_join.py.
"""

import inspect
import json
import os
import sys

import numpy as np
import pytest
import torch

import dali_tpu
import dali_tpu.plugin.pytorch
import dali_tpu_torch
from dali_tpu_torch import plugin_manager
from dali_tpu_torch.plugin.pytorch import (DALIClassificationIterator, LastBatchPolicy,
                                           feed_ndarray, to_torch_type)

CORPUS = os.path.join(os.path.dirname(__file__), "..", "dali_tpu_torch", "testdata", "rn50")
MEAN = [123.675, 116.28, 103.53]
STD = [58.395, 57.12, 57.375]
LSB = 1.0 / min(STD) + 1e-4
BATCH = 8
SERIAL_SAMPLES = [np.random.default_rng(4).integers(0, 256, (40, 56, 3), np.uint8)
                  for _ in range(4)]
REDUCE_SAMPLES = [np.random.default_rng(9).random((6, 8, 3)).astype(np.float32)
                  for _ in range(3)]


def _shutdown(pipe):
    (pipe.shutdown if isinstance(pipe, dali_tpu_torch.Pipeline) else pipe._executor.shutdown)()


def _kw(pkg):
    return {"device": "cpu"} if pkg is dali_tpu_torch else {}


def _rn50_graph(pkg):
    fn, types = pkg.fn, pkg.types
    jpegs, labels = fn.readers.file(file_root=CORPUS, random_shuffle=True, name="Reader",
                                    seed=1234)
    images = fn.decoders.image_random_crop(jpegs, device="mixed", hybrid_device_decode=True,
                                           hybrid_scale=2, seed=77)
    images = fn.resize(images, resize_x=64, resize_y=64)
    mirror = fn.random.coin_flip(probability=0.5, seed=5)
    images = fn.crop_mirror_normalize(images, mirror=mirror, dtype=types.FLOAT,
                                      output_layout="CHW", mean=MEAN, std=STD)
    return images, labels


def _serialization_graph(pkg):
    """docs/examples/serialization.py's graph, its operators on the device."""
    fn, types = pkg.fn, pkg.types
    img = fn.external_source(source=lambda: SERIAL_SAMPLES, batch=True, cycle=True,
                             layout="HWC", name="input").gpu()
    img = fn.resize(img, resize_x=32, resize_y=32)
    img = fn.rotate(img, angle=fn.random.uniform(range=[-20.0, 20.0]), fill_value=0.0,
                    keep_size=True)
    return fn.crop_mirror_normalize(img, dtype=types.FLOAT, output_layout="CHW",
                                    mean=[127.0] * 3, std=[64.0] * 3)


def _reductions_join_graph(pkg):
    """docs/examples/reductions_join.py's graph."""
    fn, types = pkg.fn, pkg.types
    x = fn.external_source(source=lambda: REDUCE_SAMPLES, batch=True, cycle=True, layout="HWC",
                           name="input")
    widened = fn.expand_dims(x, axes=[0], new_axis_names="F")
    return (fn.reductions.mean(x), fn.reductions.max(x, axes=[1]),
            fn.reductions.std_dev(x, fn.reductions.mean(x, axis_names="HW"), axis_names="HW"),
            fn.reductions.sum(x, axes=[0, 1], keep_dims=True), fn.cat(x, x, axis=1),
            fn.stack(x, x, axis=0), fn.reshape(x, shape=[-1, 3], layout="NC"),
            fn.squeeze(widened, axis_names="F"), fn.reinterpret(x, dtype=types.INT32))


GRAPHS = {"rn50_train": (_rn50_graph, {"num_threads": 2, "seed": 42}, BATCH),
          "serialization": (_serialization_graph, {"num_threads": 1, "seed": 123}, 4),
          "reductions_join": (_reductions_join_graph, {"num_threads": 1, "seed": 2}, 3)}


def _pipe(pkg, graph, **kw):
    make, ctor, batch = GRAPHS[graph]

    @pkg.pipeline_def(batch_size=batch, **ctor, **_kw(pkg), **kw)
    def p():
        outs = make(pkg)
        return outs if isinstance(outs, tuple) else (outs,)

    pipe = p()
    pipe.build()
    return pipe


def _outputs(outs):
    res = []
    for tl in outs:
        if hasattr(tl, "as_cpu"):
            tl = tl.as_cpu()
        res.append([np.asarray(tl.at(i)) for i in range(len(tl))])
    return res


def _run_twice(pipe, feed=False):
    res = []
    for _ in range(2):
        if feed:
            pipe.feed_input("input", SERIAL_SAMPLES if pipe.max_batch_size == 4
                            else REDUCE_SAMPLES, layout="HWC")
        res.append(_outputs(pipe.run()))
    return res


def _bit_equal(got, want):
    for g_it, w_it in zip(got, want):
        for g_out, w_out in zip(g_it, w_it):
            for g, w in zip(g_out, w_out):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------ the constructor


def test_positional_parameters_are_the_references():
    """The fault: positional exec_pipelined used to land in
    prefetch_queue_depth."""
    port = dali_tpu_torch.Pipeline(8, 2, None, 42, True, device="cpu")
    ref = dali_tpu.Pipeline(8, 2, None, 42, True)
    assert port.prefetch_queue_depth == ref.prefetch_queue_depth == 2
    ref_params = [p for p in inspect.signature(dali_tpu.Pipeline.__init__).parameters
                  if p != "transfer_chunk_bytes"]
    port_params = list(inspect.signature(dali_tpu_torch.Pipeline.__init__).parameters)
    assert port_params == ref_params + ["device"]
    kinds = {n: p.kind
             for n, p in inspect.signature(dali_tpu.Pipeline.__init__).parameters.items()}
    assert all(p.kind == kinds[n] for n, p in
               inspect.signature(dali_tpu_torch.Pipeline.__init__).parameters.items()
               if n != "device")


def test_every_reference_parameter_is_accepted():
    kw = dict(exec_pipelined=False, exec_async=False, bytes_per_sample=16, set_affinity=True,
              max_streams=4, default_cuda_stream_priority=1, enable_conditionals=True,
              enable_checkpointing=True, py_num_workers=2, py_start_method="spawn",
              output_dtype=dali_tpu_torch.types.FLOAT, output_ndim=3, pad_align=16,
              max_batch_size=6, exec_dynamic=True, debug=True)
    pipe = dali_tpu_torch.Pipeline(batch_size=2, num_threads=1, device_id=None, seed=1,
                                   prefetch_queue_depth={"cpu_size": 1, "gpu_size": 3},
                                   device="cpu", **kw)
    assert pipe.max_batch_size == pipe.batch_size == 6
    assert pipe.enable_conditionals and pipe.debug and pipe.pad_align == 16
    assert (pipe.cpu_queue_depth, pipe.gpu_queue_depth) == (1, 3)
    assert pipe.output_ndim == 3 and pipe.output_dtype == dali_tpu_torch.types.FLOAT


def test_pipeline_def_passes_enable_conditionals_and_reference_names():
    @dali_tpu_torch.pipeline_def(enable_conditionals=True, batch_size=2, device="cpu")
    def p():
        return dali_tpu_torch.fn.random.coin_flip()

    pipe = p(exec_pipelined=False, max_batch_size=3, pad_align=8)
    assert pipe.enable_conditionals and pipe.max_batch_size == 3 and pipe.pad_align == 8


@pytest.mark.parametrize("pad_align", [16, 64])
def test_pad_align_sets_the_canvas(pad_align):
    """A ragged batch's canvas rounds its spatial dims up to ``pad_align``,
    as the reference's does."""
    samples = [np.zeros((20 + 7 * i, 30 - 5 * i, 3), np.uint8) for i in range(3)]
    shapes = []
    for pkg in (dali_tpu_torch, dali_tpu):
        @pkg.pipeline_def(batch_size=3, num_threads=1, pad_align=pad_align, **_kw(pkg))
        def p():
            return pkg.fn.external_source(source=lambda: samples, batch=True, layout="HWC").gpu()

        pipe = p()
        pipe.build()
        try:
            shapes.append(tuple(pipe.run()[0].as_tensor().shape))
        finally:
            _shutdown(pipe)
    assert shapes[0] == shapes[1] == (3, -(-34 // pad_align) * pad_align,
                                      -(-30 // pad_align) * pad_align, 3)


@pytest.mark.parametrize("kw", [{"output_dtype": 7}, {"output_ndim": 2},
                                {"output_dtype": [9, 7], "output_ndim": [3, 1]},
                                {"output_ndim": [None, 2]}],
                         ids=["dtype", "ndim", "lists", "ndim_second"])
@pytest.mark.parametrize("on_device", [False, True])
def test_output_contracts_raise_as_the_reference(kw, on_device):
    data = np.zeros((2, 4, 4, 3), np.float32)
    labels = np.zeros((2, 1), np.uint8)
    errors = []
    for pkg in (dali_tpu_torch, dali_tpu):
        @pkg.pipeline_def(batch_size=2, num_threads=1, **_kw(pkg), **kw)
        def p():
            x = pkg.fn.external_source(source=lambda: data, batch=True, layout="HWC")
            y = pkg.fn.external_source(source=lambda: labels, batch=True)
            return (x.gpu() if on_device else x), y

        pipe = p()
        pipe.build()
        try:
            with pytest.raises(RuntimeError) as e:
                pipe.run()
            errors.append(str(e.value).replace("dali_tpu_torch", "dali_tpu"))
        finally:
            _shutdown(pipe)
    assert errors[0] == errors[1]
    assert "declared output_" in errors[0]


def test_output_contracts_that_hold_pass():
    @dali_tpu_torch.pipeline_def(batch_size=2, num_threads=1, device="cpu",
                                 output_dtype=[dali_tpu_torch.types.FLOAT, None],
                                 output_ndim=[3, 1])
    def p():
        x = dali_tpu_torch.fn.external_source(source=lambda: np.zeros((2, 4, 4, 3), np.float32),
                                              batch=True)
        return x.gpu(), dali_tpu_torch.fn.external_source(
            source=lambda: np.zeros((2, 1), np.int32), batch=True)

    pipe = p()
    pipe.build()
    try:
        assert len(pipe.run()) == 2
    finally:
        pipe.shutdown()


# ------------------------------------------------------------------ serialization


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("direction", ["dali_tpu_to_port", "port_to_dali_tpu"])
def test_payloads_cross_between_packages(graph, direction):
    """The rebuilt pipeline gives its package's own pipeline's outputs."""
    src_pkg, dst_pkg = ((dali_tpu, dali_tpu_torch) if direction == "dali_tpu_to_port"
                        else (dali_tpu_torch, dali_tpu))
    src = _pipe(src_pkg, graph)
    payload = src.serialize()
    _shutdown(src)
    doc = json.loads(payload)
    assert doc["format"] == "dali_tpu.graph.v1"
    assert set(doc) == {"format", "params", "ops", "outputs"}
    assert all(set(op) == {"name", "schema", "device", "args", "inputs", "arg_inputs",
                           "num_outputs"} for op in doc["ops"])
    rebuilt = dst_pkg.Pipeline.deserialize(payload, **_kw(dst_pkg))
    rebuilt.build()
    own = _pipe(dst_pkg, graph)
    feed = graph != "rn50_train"
    try:
        got, want = _run_twice(rebuilt, feed), _run_twice(own, feed)
    finally:
        _shutdown(rebuilt)
        _shutdown(own)
    _bit_equal(got, want)


def test_serialized_documents_agree_but_for_the_tpu_transfer_setting():
    docs = []
    for pkg in (dali_tpu_torch, dali_tpu):
        pipe = _pipe(pkg, "rn50_train")
        docs.append(json.loads(pipe.serialize()))
        _shutdown(pipe)
    port, ref = docs
    assert port["ops"] == ref["ops"] and port["outputs"] == ref["outputs"]
    assert port["params"] == {k: v for k, v in ref["params"].items()
                              if k != "transfer_chunk_bytes"}


def test_deserialize_drops_only_transfer_chunk_bytes(tmp_path):
    pipe = _pipe(dali_tpu_torch, "reductions_join")
    path = str(tmp_path / "pipe.json")
    payload = pipe.serialize(filename=path)
    pipe.shutdown()
    doc = json.loads(payload)
    doc["params"]["transfer_chunk_bytes"] = 1 << 20
    again = dali_tpu_torch.Pipeline.deserialize(json.dumps(doc), device="cpu")
    assert again.max_batch_size == 3 and again.seed == 2
    doc["params"]["not_a_parameter"] = 1
    with pytest.raises(TypeError, match="not_a_parameter"):
        dali_tpu_torch.Pipeline.deserialize(json.dumps(doc), device="cpu")
    from_file = dali_tpu_torch.Pipeline.deserialize(filename=path, device="cpu", seed=7)
    assert from_file.seed == 7 and from_file.max_batch_size == 3


@pytest.mark.parametrize("src_pkg", [dali_tpu_torch, dali_tpu], ids=["port", "dali_tpu"])
def test_include_callables_restores_a_runnable_pipeline(src_pkg):
    """The external source's callable travels by value: the port runs the
    rebuilt pipeline with nothing fed."""
    src = _pipe(src_pkg, "reductions_join")
    payload = src.serialize(include_callables=True)
    _shutdown(src)
    assert all("pickled_extra" in op for op in json.loads(payload)["ops"]
               if op["schema"] == "ExternalSource")
    rebuilt = dali_tpu_torch.Pipeline.deserialize(payload, device="cpu")
    rebuilt.build()
    own = _pipe(dali_tpu_torch, "reductions_join")
    try:
        got, want = _run_twice(rebuilt), _run_twice(own)
    finally:
        rebuilt.shutdown()
        own.shutdown()
    _bit_equal(got, want)


def test_dot_file(tmp_path):
    pipe = _pipe(dali_tpu_torch, "rn50_train")
    path = tmp_path / "pipe.dot"
    try:
        pipe.save_graph_to_dot_file(str(path))
        ref = _pipe(dali_tpu, "rn50_train")
        want = ref._graph.to_dot()
        ref._executor.shutdown()
    finally:
        pipe.shutdown()
    txt = path.read_text()
    assert txt == want
    assert txt.startswith("digraph pipeline {") and '"__Resize_0" -> "__CropMirrorNormalize_0"' in txt
    assert "CropMirrorNormalize\\ngpu" in txt


def test_epoch_size_and_executor_statistics():
    port, ref = _pipe(dali_tpu_torch, "rn50_train"), _pipe(dali_tpu, "rn50_train")
    try:
        assert port.epoch_size() == ref.epoch_size() == {"Reader": 32}
        assert port.epoch_size("Reader") == 32
        port.run()
        ref.run()
        stats, ref_stats = port.executor_statistics(), ref.executor_statistics()
        assert port.share_outputs is not None
    finally:
        port.shutdown()
        ref._executor.shutdown()
    # the reference's keys, but for its jit cache and its staging arena
    assert set(ref_stats) - set(stats) == {"device_program_variants", "staging_arena"}
    assert stats["iterations_completed"] >= 1 and stats["host_batches"] >= 1
    assert stats["device_stall_seconds"] == stats["device_wait_seconds"]
    assert "_JpegCoeffsSplitRRC" in stats["host_breakdown_seconds"]
    assert stats["canvases"] and all(isinstance(v, list) for v in stats["canvases"].values())


# ------------------------------------------------------------------ ops, plugins, names


def test_ops_api_builds_the_fn_graph():
    """The class API over rn50_train's graph: the same operators in the same
    order as ``fn``'s, and the same batches."""
    from dali_tpu_torch import ops, types

    pipe = dali_tpu_torch.Pipeline(batch_size=BATCH, num_threads=2, seed=42, device="cpu")
    decode = ops.decoders.ImageRandomCrop(device="mixed", hybrid_device_decode=True,
                                          hybrid_scale=2, seed=77)
    cmn = ops.CropMirrorNormalize(dtype=types.FLOAT, output_layout="CHW", mean=MEAN, std=STD)
    with pipe:
        jpegs, labels = ops.readers.File(file_root=CORPUS, random_shuffle=True, name="Reader",
                                         seed=1234)()
        images = ops.Resize(resize_x=64, resize_y=64)(decode(jpegs))
        images = cmn(images, mirror=ops.random.CoinFlip(probability=0.5, seed=5)())
        pipe.set_outputs(images, labels)
    pipe.build()
    own = _pipe(dali_tpu_torch, "rn50_train")
    try:
        seq = [(n.spec.schema_name, n.device, n.id, n.spec.args) for n in pipe._graph.ops]
        assert seq == [(n.spec.schema_name, n.device, n.id, n.spec.args)
                       for n in own._graph.ops]
        _bit_equal(_run_twice(pipe), _run_twice(own))
    finally:
        pipe.shutdown()
        own.shutdown()
    assert ops.ExternalSource is dali_tpu_torch.ExternalSource
    assert ops.readers.File().schema is dali_tpu_torch.GetSchema("readers.File")


@pytest.mark.parametrize("api", ["fn", "ops"])
def test_unported_names_name_their_roadmap_item(api):
    mod = getattr(dali_tpu_torch, api)
    # item 8b's registry part ported the last names dali_tpu registers: they
    # resolve, and a name neither package has names Queue 1 with no item
    names = ("optical_flow", "readers.video_resize", "video_reader_resize")
    if api == "ops":
        names = ("OpticalFlow", "readers.VideoResize", "VideoReaderResize")
    for path in names:
        obj = mod
        for part in path.split("."):
            obj = getattr(obj, part)
        assert callable(obj), path
    from dali_tpu_torch.backend import parity

    assert parity.QUEUE_ITEMS == {}
    unknown = "readers.video_warp" if api == "fn" else "readers.VideoWarp"
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md \(Queue 1\)"):
        getattr(mod.readers, unknown.split(".")[1])


PLUGIN = '''
import dali_tpu_torch
from dali_tpu_torch._schema import ArgType
from dali_tpu_torch.backend.base import Operator

dali_tpu_torch.DALI_SCHEMA("TestScaleBy").DocStr("Multiplies by `factor`.").NumInput(1) \\
    .NumOutput(1).AddOptionalArg("factor", ArgType.FLOAT, "Scale.", 2.0)


@dali_tpu_torch.register_operator("TestScaleBy", "cpu")
class ScaleBy(Operator):
    def run_sample(self, ctx, idx, x):
        return (x * self.spec.GetArgument("factor")).astype(x.dtype)
'''


@pytest.fixture
def plugin_file(tmp_path):
    """A plugin file in a directory of its own; its operator is unregistered
    afterwards."""
    (tmp_path / "scale_by.py").write_text(PLUGIN)
    yield str(tmp_path)
    from dali_tpu_torch import _schema, fn, ops

    _schema._registry.pop("TestScaleBy", None)
    _schema._impl_registry.pop(("TestScaleBy", "cpu"), None)
    fn.__dict__.pop("test_scale_by", None)
    ops.__dict__.pop("TestScaleBy", None)
    sys.modules.pop("scale_by", None)


def test_custom_operator_from_a_plugin_file(plugin_file):
    mods = plugin_manager.load_directory(plugin_file)
    assert len(mods) == 1
    assert "TestScaleBy" in dali_tpu_torch.RegisteredSchemas()
    assert dali_tpu_torch._schema.has_operator_impl("TestScaleBy", "cpu")
    data = np.arange(12, dtype=np.int32).reshape(2, 6)

    @dali_tpu_torch.pipeline_def(batch_size=2, num_threads=1, device="cpu")
    def p():
        x = dali_tpu_torch.fn.external_source(source=lambda: data, batch=True)
        return (dali_tpu_torch.fn.test_scale_by(x, factor=3.0),
                dali_tpu_torch.ops.TestScaleBy()(x))

    pipe = p()
    pipe.build()
    try:
        a, b = pipe.run()
    finally:
        pipe.shutdown()
    np.testing.assert_array_equal(a.as_array(), data * 3)
    np.testing.assert_array_equal(b.as_array(), data * 2)


def test_load_library_by_module_name(plugin_file, monkeypatch):
    monkeypatch.syspath_prepend(plugin_file)
    mod = plugin_manager.load_library("scale_by")
    assert mod.ScaleBy.schema_name == "TestScaleBy"
    assert callable(dali_tpu_torch.fn.test_scale_by)


RESOLVING = ["FileReader", "COCOReader", "CaffeReader", "Caffe2Reader", "MXNetReader",
             "TFRecordReader", "NumpyReader", "SequenceReader", "NemoAsrReader", "ImageDecoder",
             "ImageDecoderCrop", "ImageDecoderRandomCrop", "ImageDecoderSlice", "AudioDecoder",
             "Uniform", "CoinFlip", "NormalDistribution", "Equalize", "experimental.decoders.Image",
             "experimental.decoders.ImageCrop", "experimental.decoders.ImageRandomCrop",
             "experimental.decoders.ImageSlice", "experimental.Inflate",
             "experimental.readers.Fits", "experimental.PeekImageShape", "reductions.RMS",
             "Clahe", "Filter", "Debayer", "AudioResample", "VideoReader",
             "experimental.readers.Video"]


def test_legacy_names_register_where_the_target_runs():
    from dali_tpu.backend import parity as ref_parity
    from dali_tpu_torch import _schema
    from dali_tpu_torch.backend import parity

    assert parity._LEGACY == ref_parity._LEGACY
    for alias in RESOLVING:
        target = parity._LEGACY[alias]
        assert _schema.GetSchema(alias) is _schema.GetSchema(target)
        devices = {d for (n, d) in _schema._impl_registry if n == target}
        assert {d for (n, d) in _schema._impl_registry if n == alias} == devices, alias
        assert all(_schema.has_operator_impl(alias, d) for d in devices)
    assert _schema.has_operator_impl("Equalize", "cpu")  # registered later, in item 5h
    assert _schema.GetSchema("VideoReader") is _schema.GetSchema("readers.Video")  # item 8a
    assert sorted(parity._ALIAS_MISS) == sorted(set(parity._LEGACY) - set(RESOLVING))


def test_legacy_names_run_as_their_targets():
    files = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(CORPUS) for f in fs)[:4]
    outs = []
    for reader, decoder, flip in (("file_reader", "image_decoder", "coin_flip"),
                                  ("readers.file", "experimental.decoders.image",
                                   "random.coin_flip")):
        def get(path):
            obj = dali_tpu_torch.fn
            for part in path.split("."):
                obj = getattr(obj, part)
            return obj

        @dali_tpu_torch.pipeline_def(batch_size=4, num_threads=1, seed=3, device="cpu")
        def p():
            jpegs, labels = get(reader)(files=files, seed=1)
            img = get(decoder)(jpegs, device="mixed")
            return img, labels, get(flip)(seed=2), dali_tpu_torch.fn.reductions.rms(
                dali_tpu_torch.fn.cast(labels, dtype=dali_tpu_torch.types.FLOAT))

        pipe = p()
        pipe.build()
        try:
            outs.append(_outputs(pipe.run()))
        finally:
            pipe.shutdown()
    _bit_equal([outs[0]], [outs[1]])


def test_legacy_name_on_a_device_the_port_lacks_raises():
    """Equalize has both placements since item 5h, and its gpu path takes
    uniform sequences since item 5h.7; on a ragged batch of sequences, where
    dali_tpu's gpu op fails, it raises naming that fault. VideoReaderResize,
    ported with item 8b's registry part, has no gpu placement in either
    package."""
    seqs = [np.zeros((2, 4 + i, 4, 3), np.uint8) for i in range(2)]

    @dali_tpu_torch.pipeline_def(batch_size=2, num_threads=1, device="cpu")
    def p():
        return dali_tpu_torch.fn.equalize(dali_tpu_torch.fn.external_source(
            source=lambda: seqs, batch=True, layout="FHWC").gpu())

    pipe = p()
    pipe.build()
    try:
        with pytest.raises(NotImplementedError, match=r"dali_tpu's gpu op fails there"):
            pipe.run()
    finally:
        pipe.shutdown()
    from dali_tpu import _schema as ref_schema
    from dali_tpu_torch import _schema

    for name in ("VideoReaderResize", "readers.VideoResize"):
        assert not ref_schema.has_operator_impl(name, "gpu")
        assert not _schema.has_operator_impl(name, "gpu")
        with pytest.raises(NotImplementedError, match="not ported"):
            _schema.get_operator_impl(name, "gpu")


def test_schema_lookups_and_top_level_names():
    from dali_tpu_torch import _schema

    for name in ("DALI_SCHEMA", "register_operator", "GetSchema", "RegisteredSchemas", "ops",
                 "do_not_convert"):
        assert hasattr(dali_tpu_torch, name) and hasattr(dali_tpu, name), name
    assert _schema.TryGetSchema("Slice") is _schema.GetSchema("Slice")
    assert _schema.TryGetSchema("NoSuchOp") is None
    assert _schema.has_operator_impl("Slice", "gpu")

    def f():
        return 1

    assert dali_tpu_torch.do_not_convert(f) is f and f._dali_do_not_convert


def test_types_names_match_the_reference():
    t, rt = dali_tpu_torch.types, dali_tpu.types
    for name in ("STRING", "BFLOAT16", "NO_TYPE", "ANY_DATA"):
        assert int(getattr(t, name)) == int(getattr(rt, name)), name
    assert t.to_torch_type(t.BFLOAT16) is torch.bfloat16
    assert [m.name for m in t.PipelineAPIType] == [m.name for m in rt.PipelineAPIType]
    assert [m.value for m in t.PipelineAPIType] == [m.value for m in rt.PipelineAPIType]
    assert t.layout_find_dim("NHWC", "W") == rt.layout_find_dim("NHWC", "W") == 2
    for mod in (t, rt):
        with pytest.raises(ValueError, match="not found in layout"):
            mod.layout_find_dim("HWC", "D")


# ------------------------------------------------------------------ the PyTorch plugin


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32, np.int64, np.float16,
                                   np.float32, np.float64, np.bool_])
def test_to_torch_type(dtype):
    assert to_torch_type(np.dtype(dtype)) == dali_tpu.plugin.pytorch.to_torch_type(np.dtype(dtype))


def test_feed_ndarray():
    data = np.random.default_rng(2).integers(0, 256, (2, 5, 6, 3)).astype(np.uint8)

    @dali_tpu_torch.pipeline_def(batch_size=2, num_threads=1, device="cpu")
    def p():
        x = dali_tpu_torch.fn.external_source(source=lambda: data, batch=True, layout="HWC")
        return x, x.gpu()

    pipe = p()
    pipe.build()
    try:
        host, dev = pipe.run()
    finally:
        pipe.shutdown()
    for tl in (host, dev):
        arr = torch.empty((2, 5, 6, 3), dtype=torch.uint8)
        assert feed_ndarray(tl, arr) is arr
        np.testing.assert_array_equal(arr.numpy(), data)
    ref = torch.empty((2, 5, 6, 3), dtype=torch.uint8)
    dali_tpu.plugin.pytorch.feed_ndarray(dali_tpu.tensors.TensorListCPU(list(data), "HWC"), ref)
    np.testing.assert_array_equal(ref.numpy(), data)


def _rn50(pkg, **kw):
    @pkg.pipeline_def(batch_size=BATCH, num_threads=2, seed=42, **_kw(pkg), **kw)
    def p():
        return _rn50_graph(pkg)

    pipe = p()
    pipe.build()
    return pipe


def _batches(it, n):
    out = []
    for _ in range(n):
        b = next(it)[0]
        out.append((np.asarray(b["data"]).copy(), np.asarray(b["label"]).copy()))
    return out


def test_prepare_first_batch_false_runs_nothing_until_next():
    pipe = _rn50(dali_tpu_torch)
    try:
        it = DALIClassificationIterator(pipe, reader_name="Reader", prepare_first_batch=False)
        assert pipe._batches_scheduled == 0
        got = _batches(it, 2)
        assert pipe._batches_scheduled == 2 + pipe.prefetch_queue_depth
    finally:
        pipe.shutdown()
    want_pipe = _rn50(dali_tpu_torch)
    try:
        want = _batches(DALIClassificationIterator(want_pipe, reader_name="Reader"), 2)
    finally:
        want_pipe.shutdown()
    for (gd, gl), (wd, wl) in zip(got, want):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("fill,policy,last", [(True, LastBatchPolicy.FILL, 12),
                                              (False, LastBatchPolicy.PARTIAL, 8)])
def test_fill_last_batch_selects_the_policy(fill, policy, last):
    """DALI's deprecated ``fill_last_batch``: True fills the last batch,
    False returns it partial (32 files at batch 12)."""
    @dali_tpu_torch.pipeline_def(batch_size=12, num_threads=2, seed=3, device="cpu")
    def p():
        jpegs, labels = dali_tpu_torch.fn.readers.file(file_root=CORPUS, name="Reader")
        img = dali_tpu_torch.fn.decoders.image_random_crop(
            jpegs, device="mixed", hybrid_device_decode=True, hybrid_scale=4)
        return dali_tpu_torch.fn.resize(img, resize_x=8, resize_y=8), labels

    pipe = p()
    try:
        it = DALIClassificationIterator(pipe, reader_name="Reader", fill_last_batch=fill)
        assert it._last_batch_policy == policy
        assert [b[0]["data"].shape[0] for b in it] == [12, 12, last]
    finally:
        pipe.shutdown()


def test_iterator_checkpoints_resume_mid_epoch():
    """``checkpoints()`` after 2 of 4 batches; pipelines rebuilt from them
    and the counter restored give the uninterrupted run's batches, to the
    epoch's end and into the next."""
    pipe = _rn50(dali_tpu_torch, enable_checkpointing=True)
    try:
        it = DALIClassificationIterator(pipe, reader_name="Reader", auto_reset=True)
        _batches(it, 2)
        ckpt = it.checkpoints()
        want = _batches(it, 2)
        with pytest.raises(StopIteration):
            next(it)
        want += _batches(it, 1)
    finally:
        pipe.shutdown()
    assert ckpt["counter"] == 2 * BATCH and len(ckpt["pipelines"]) == 1
    again = _rn50(dali_tpu_torch, checkpoint=ckpt["pipelines"][0])
    try:
        it2 = DALIClassificationIterator(again, reader_name="Reader", auto_reset=True)
        it2.restore_counter(ckpt["counter"])
        got = _batches(it2, 2)
        with pytest.raises(StopIteration):
            next(it2)
        got += _batches(it2, 1)
    finally:
        again.shutdown()
    for (gd, gl), (wd, wl) in zip(got, want):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)


def test_dali_tpu_iterator_checkpoint_resumes_in_port():
    ref = _rn50(dali_tpu, enable_checkpointing=True)
    try:
        it = dali_tpu.plugin.pytorch.DALIClassificationIterator(ref, reader_name="Reader")
        _batches(it, 1)
        ckpt = it.checkpoints()
        want = _batches(it, 2)
    finally:
        ref._executor.shutdown()
    port = _rn50(dali_tpu_torch, checkpoint=ckpt["pipelines"][0])
    try:
        it2 = DALIClassificationIterator(port, reader_name="Reader")
        it2.restore_counter(ckpt["counter"])
        got = _batches(it2, 2)
        assert it2._counter == ckpt["counter"] + 2 * BATCH
    finally:
        port.shutdown()
    for (gd, gl), (wd, wl) in zip(got, want):
        np.testing.assert_array_equal(gl, wl)
        d = np.abs(gd - wd)
        assert d.max() <= LSB and (d > 1e-4).mean() <= 1e-3
