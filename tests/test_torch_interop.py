"""The Python function operators of dali_tpu_torch against dali_tpu on the
CPU: PythonFunction (per sample on the operator's thread pool, or whole
batches), DLTensorPythonFunction, TorchPythonFunction and NumbaFunction (its
``run_fn`` as plain Python: numba is not installed) return what the
reference returns, bit for bit. ``fn.torch_function`` (the port's
``_TorchFunction``) is held against the reference's ``fn.jax_function`` with
the same function written in torch and in jax. Serialization of a graph with
a callable behaves as the reference's.
"""

import numpy as np
import pytest
import torch

import dali_tpu
import dali_tpu_torch
from dali_tpu_torch.tools import bench_affine_mixup

RNG = np.random.default_rng(2)
IMGS = [RNG.integers(0, 256, (10 + 3 * i, 12 - i, 3), np.uint8) for i in range(4)]
UNIFORM = [RNG.integers(0, 256, (9, 11, 3), np.uint8) for _ in range(4)]
FLOATS = [RNG.standard_normal((5, 4)).astype(np.float32) for _ in range(4)]


def _build(pkg, graph, batch=4, num_threads=1, **kw):
    if pkg is dali_tpu_torch:
        kw.setdefault("device", "cpu")
    else:
        kw.setdefault("debug", True)

    @pkg.pipeline_def(batch_size=batch, num_threads=num_threads, seed=9, **kw)
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


def _runs(pkg, graph, n=2, **kw):
    pipe = _build(pkg, graph, **kw)
    try:
        res = []
        for _ in range(n):
            outs = []
            for tl in pipe.run():
                tl = tl.as_cpu() if hasattr(tl, "as_cpu") else tl
                outs.append(([np.asarray(tl.at(i)) for i in range(len(tl))], tl.layout()))
            res.append(outs)
        return res
    finally:
        _close(pipe)


def _src(fn, data, layout="HWC"):
    return fn.external_source(source=lambda: data, batch=True, layout=layout)


def _equal(got, want):
    for g_it, w_it in zip(got, want):
        assert len(g_it) == len(w_it)
        for (g_out, g_lay), (w_out, w_lay) in zip(g_it, w_it):
            assert g_lay == w_lay
            for g, w in zip(g_out, w_out):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)


def _edge(img):
    f = img.astype(np.float32)
    return np.clip(f + (f - (f + np.roll(f, 1, 0) + np.roll(f, -1, 1)) / 3.0), 0,
                   255).astype(np.uint8)


def _split(img):
    return img[..., 0].copy(), (img[..., 1:].astype(np.int32) * 3)


def _batch_stats(imgs, floats):
    return ([np.asarray([im.mean(), im.max()], np.float32) for im in imgs],
            [f.T.copy() for f in floats])


def _numba_run(out0, in0):
    for i in range(in0.shape[0]):
        for j in range(in0.shape[1]):
            out0[i, j] = in0[i, j] * 2 + 1


def _numba_setup(outs, ins):
    outs[0][0] = ins[0][1]
    outs[0][1] = ins[0][0]


def _numba_transpose(out0, in0):
    out0[:] = in0.T


def _numba_batch(outs, ins):
    for o, x in zip(outs, ins):
        o[:] = x.sum()


CASES = {
    "python_function": lambda fn, t: fn.python_function(_src(fn, IMGS), function=_edge),
    "python_function_two_outputs_layouts": lambda fn, t: fn.python_function(
        _src(fn, IMGS), function=_split, num_outputs=2, output_layouts=["HW", "HWC"]),
    "python_function_batch": lambda fn, t: fn.python_function(
        _src(fn, IMGS), _src(fn, FLOATS, ""), function=_batch_stats, batch_processing=True,
        num_outputs=2, output_layouts=["", "WH"]),
    "python_function_no_input": lambda fn, t: fn.python_function(
        function=lambda: np.arange(3, dtype=np.int16)),
    "dl_tensor_python_function": lambda fn, t: fn.dl_tensor_python_function(
        _src(fn, IMGS), function=lambda xs: [255 - np.from_dlpack(x) for x in xs]),
    "dl_tensor_python_function_per_sample": lambda fn, t: fn.dl_tensor_python_function(
        _src(fn, IMGS), function=lambda x: np.from_dlpack(x)[::2], batch_processing=False),
    "torch_python_function": lambda fn, t: fn.torch_python_function(
        _src(fn, IMGS), function=lambda x: x.flip(0).to(torch.int32) + 10),
    "torch_python_function_two_outputs": lambda fn, t: fn.torch_python_function(
        _src(fn, FLOATS, ""), function=lambda x: (x * 2, x.sum(0)), num_outputs=2),
    "numba_function": lambda fn, t: fn.numba_function(
        _src(fn, FLOATS, ""), run_fn=_numba_run, out_types=[int(t.FLOAT)],
        in_types=[int(t.FLOAT)], outs_ndim=[2], ins_ndim=[2]),
    "numba_function_setup": lambda fn, t: fn.numba_function(
        _src(fn, FLOATS, ""), run_fn=_numba_transpose, setup_fn=_numba_setup,
        out_types=[int(t.FLOAT)], in_types=[int(t.FLOAT)], outs_ndim=[2], ins_ndim=[2]),
    "numba_function_batch": lambda fn, t: fn.numba_function(
        _src(fn, IMGS), run_fn=_numba_batch, out_types=[int(t.UINT8)], in_types=[int(t.UINT8)],
        batch_processing=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_python_function_ops_match_dali_tpu(case):
    _equal(_runs(dali_tpu_torch, CASES[case]), _runs(dali_tpu, CASES[case]))


def test_per_sample_calls_run_on_the_thread_pool():
    import threading

    seen = set()

    def record(x):
        seen.add(threading.current_thread().name)
        return x + 1

    got = _runs(dali_tpu_torch, lambda fn, t: fn.python_function(_src(fn, IMGS), function=record),
                num_threads=3)
    assert all(name.startswith("dali-torch-python-function") for name in seen)
    for g, x in zip(got[0][0][0], IMGS):
        np.testing.assert_array_equal(g, x + 1)


def test_python_function_error_surfaces_at_the_next_outputs():
    def bad(x):
        raise RuntimeError("intentional python_function failure")

    pipe = _build(dali_tpu_torch, lambda fn, t: fn.python_function(_src(fn, IMGS), function=bad),
                  num_threads=2)
    try:
        pipe.schedule_run()
        with pytest.raises(RuntimeError, match="intentional python_function failure"):
            pipe.outputs()
        with pytest.raises(RuntimeError, match="intentional python_function failure"):
            pipe.run()
    finally:
        pipe.shutdown()


def test_numba_function_type_validation_as_the_reference():
    for pkg in (dali_tpu_torch, dali_tpu):
        pipe = _build(pkg, lambda fn, t: fn.numba_function(
            _src(fn, IMGS), run_fn=_numba_batch, out_types=[int(t.UINT8)],
            in_types=[int(t.FLOAT)]))
        try:
            with pytest.raises(TypeError, match="numba_function input 0: expected"):
                pipe.run()
        finally:
            _close(pipe)
    with pytest.raises(ValueError, match="requires `run_fn`"):
        _build(dali_tpu_torch, lambda fn, t: fn.numba_function(_src(fn, IMGS),
                                                               out_types=[int(t.UINT8)]))


def test_numba_plugin_raises_without_numba():
    from dali_tpu_torch.plugin.numba import numba_function

    try:
        import numba  # noqa: F401
    except ImportError:
        pass
    else:
        pytest.skip("numba is installed")
    with pytest.raises(ImportError, match="requires numba"):
        _build(dali_tpu_torch, lambda fn, t: numba_function(
            _src(fn, IMGS), run_fn=_numba_batch, out_types=[t.UINT8], in_types=[t.UINT8]))


def _torch_gelu_mix(x, y):
    a = x.to(torch.float32) * 0.5 + y
    return torch.tanh(a) * 2.0, a.sum(dim=-1)


def _jax_gelu_mix(x, y):
    import jax.numpy as jnp

    a = x.astype(jnp.float32) * 0.5 + y
    return jnp.tanh(a) * 2.0, a.sum(axis=-1)


@pytest.mark.parametrize("data", [IMGS, UNIFORM], ids=["ragged", "uniform"])
def test_torch_function_matches_jax_function(data):
    """The same function in torch and in jax, on the batched device canvases
    [N, ...]: an output of the input's shape keeps its per-sample extents;
    one of another shape is a uniform batch."""
    def graph(fn, t, which):
        x = _src(fn, data).gpu()
        y = fn.cast(x, dtype=t.FLOAT) * 0.25
        f = getattr(fn, which)
        return f(x, y, function=_torch_gelu_mix if which == "torch_function" else _jax_gelu_mix,
                 num_outputs=2, output_layouts=["HWC", "HW"])

    got = _runs(dali_tpu_torch, lambda fn, t: graph(fn, t, "torch_function"))
    want = _runs(dali_tpu, lambda fn, t: graph(fn, t, "jax_function"))
    for g_it, w_it in zip(got, want):
        for (g_out, g_lay), (w_out, w_lay) in zip(g_it, w_it):
            assert g_lay == w_lay
            for g, w in zip(g_out, w_out):
                assert g.shape == w.shape and g.dtype == w.dtype
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-5)
    assert [g.shape for g in got[0][0][0]] == [d.shape for d in data]


def test_jax_function_names_torch_function():
    @dali_tpu_torch.pipeline_def(batch_size=2, device="cpu")
    def p():
        return dali_tpu_torch.fn.jax_function(_src(dali_tpu_torch.fn, IMGS[:2]).gpu(),
                                              function=lambda x: x)

    with pytest.raises(TypeError, match="fn.torch_function"):
        p().build()


def test_serialize_of_a_python_function_graph_behaves_as_the_reference():
    """The callable is not serialized: the document is the reference's, and
    deserializing it fails to build in both packages for want of the
    function; with include_callables the callable travels by value."""
    def graph(fn, t):
        return fn.python_function(_src(fn, FLOATS, ""), function=lambda a: a * 3)

    docs = []
    for pkg in (dali_tpu_torch, dali_tpu):
        pipe = _build(pkg, graph)
        try:
            docs.append(pipe.serialize())
            want = [np.asarray(pipe.run()[0].at(i)) for i in range(4)]
        finally:
            _close(pipe)
    import json

    port_doc, ref_doc = (json.loads(d) for d in docs)
    assert [o["args"] for o in port_doc["ops"]] == [o["args"] for o in ref_doc["ops"]]
    assert "function" not in json.dumps(port_doc["ops"][1]["args"])
    for pkg, doc in ((dali_tpu_torch, docs[0]), (dali_tpu, docs[1])):
        kw = {"device": "cpu"} if pkg is dali_tpu_torch else {}
        with pytest.raises(ValueError, match="requires `function`"):
            pkg.Pipeline.deserialize(doc, **kw).build()
    pipe = _build(dali_tpu_torch, graph)
    try:
        payload = pipe.serialize(include_callables=True)
    finally:
        pipe.shutdown()
    again = dali_tpu_torch.Pipeline.deserialize(payload, device="cpu")
    again.build()
    try:
        got = [np.asarray(again.run()[0].at(i)) for i in range(4)]
    finally:
        again.shutdown()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_custom_operators_example_runs_in_the_port():
    """docs/examples/custom_operators.py's graph, its device function in
    torch, to the example's asserted values."""
    assert bench_affine_mixup.custom_operators(device="cpu")["outputs_checked"] == 4


def test_eager_python_function():
    import dali_tpu_torch.experimental.dynamic as ndd

    with ndd.EvalContext(seed=1, device="cpu"):
        out = ndd.python_function(ndd.as_batch(IMGS, layout="HWC"), function=_edge)
    for g, x in zip(out.cpu()._samples, IMGS):
        np.testing.assert_array_equal(np.asarray(g), _edge(x))
