"""The Triton plugin of the port (``dali_tpu_torch.plugin.triton``) against
``dali_tpu.plugin.triton`` on the CPU: the four cases of
``tests/test_triton.py`` (the marker only on a ``pipeline_def``, discovery
and serialization, zero or two marked pipelines, the model repository's
layout), and a ``model.dali`` written by each package loaded by the other,
whose host pipeline gives equal outputs (host draws are bit-equal)."""

import json
import os
import types as pytypes

import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch
from dali_tpu.plugin import triton as ref_triton
from dali_tpu_torch.plugin import triton as port_triton


def _make_pipe_def(pkg, **kw):
    fn, dt = pkg.fn, pkg.types

    @pkg.pipeline_def(batch_size=4, num_threads=1, seed=3, **kw)
    def p():
        u = fn.random.uniform(range=[0.0, 1.0], shape=[8])
        j = fn.external_source(name="DALI_INPUT_0", dtype=dt.UINT8, ndim=1)
        return fn.cast(u * 255.0, dtype=dt.UINT8), fn.cast(j, dtype=dt.INT32) * 3

    return p


def _port_pipe_def():
    return _make_pipe_def(dali_tpu_torch, device="cpu")


def _run(pipe, feed=True):
    pipe.build()
    if feed:
        pipe.feed_input("DALI_INPUT_0", [np.arange(k + 1, dtype=np.uint8) for k in range(4)])
    return [[np.asarray(o.at(i)) for i in range(len(o))] for o in pipe.run()]


def test_autoserialize_requires_pipeline_def():
    with pytest.raises(TypeError):
        port_triton.autoserialize(lambda: None)


def test_invoke_autoserialize_discovers_and_serializes(tmp_path):
    mod = pytypes.ModuleType("triton_model_mod")
    mod.sub = pytypes.ModuleType("triton_model_mod.sub")
    mod.sub.pipe = port_triton.autoserialize(_port_pipe_def())
    out = tmp_path / "model.dali"
    port_triton.invoke_autoserialize(mod, str(out))
    restored = dali_tpu_torch.Pipeline.deserialize(filename=str(out), device="cpu")
    assert _run(restored)[0][0].shape == (8,)


def test_invoke_autoserialize_rejects_zero_or_many(tmp_path):
    with pytest.raises(RuntimeError, match="Found 0"):
        port_triton.invoke_autoserialize(pytypes.ModuleType("empty_mod"),
                                         str(tmp_path / "x.dali"))
    two = pytypes.ModuleType("two_mod")
    two.a = port_triton.autoserialize(_port_pipe_def())
    two.b = port_triton.autoserialize(_port_pipe_def())
    with pytest.raises(RuntimeError, match="Found 2"):
        port_triton.invoke_autoserialize(two, str(tmp_path / "x.dali"))


def test_save_model_repo_layout(tmp_path):
    pipe = _port_pipe_def()()
    mdir = port_triton.save_model_repo(pipe, str(tmp_path / "repo"), "preproc")
    cfg = open(os.path.join(mdir, "config.pbtxt")).read()
    assert 'backend: "dali"' in cfg and "max_batch_size: 4" in cfg and 'name: "preproc"' in cfg
    model_file = os.path.join(mdir, "1", "model.dali")
    ref_dir = ref_triton.save_model_repo(_make_pipe_def(dali_tpu)(), str(tmp_path / "ref"),
                                         "preproc")
    assert sorted(os.listdir(mdir)) == sorted(os.listdir(ref_dir)) == ["1", "config.pbtxt"]
    assert open(os.path.join(ref_dir, "config.pbtxt")).read() == cfg
    restored = dali_tpu_torch.Pipeline.deserialize(filename=model_file, device="cpu")
    _run(restored)


def test_model_dali_loads_in_the_other_package(tmp_path):
    """Each package's model.dali deserialized by the other: the same graph
    gives the same outputs as the writer's own run."""
    port_file = str(tmp_path / "port.dali")
    ref_file = str(tmp_path / "ref.dali")
    port_triton.invoke_autoserialize(
        pytypes.SimpleNamespace(p=port_triton.autoserialize(_port_pipe_def())), port_file)
    ref_triton.invoke_autoserialize(
        pytypes.SimpleNamespace(p=ref_triton.autoserialize(_make_pipe_def(dali_tpu))), ref_file)
    assert json.load(open(port_file))["params"]["batch_size"] == 4
    want = _run(_make_pipe_def(dali_tpu)())
    runs = [_run(dali_tpu.Pipeline.deserialize(filename=port_file)),
            _run(dali_tpu_torch.Pipeline.deserialize(filename=ref_file, device="cpu")),
            _run(_port_pipe_def()())]
    for got in runs:
        for g_out, w_out in zip(got, want):
            for g, w in zip(g_out, w_out):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
