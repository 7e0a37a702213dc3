"""Per-sample conditionals (``enable_conditionals=True``) in dali_tpu_torch
against dali_tpu, on the CPU.

The same seeded batches go through ``fn.external_source`` into both
packages; dali_tpu's device ops run op by op (``debug=True``), as the
port's do. Both branches run on the whole batch and a per-sample Merge picks
the result, so outputs are bit-equal: Merge, LogicalNot and the integer and
float arithmetic here are exact."""

import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch

N = 8
RNG = np.random.default_rng(21)
IMGS = RNG.integers(0, 256, (N, 16, 12, 3)).astype(np.uint8)
VALS = np.array([0.1, 0.35, 0.45, 0.55, 0.7, 0.95, 0.2, 0.8], np.float32)
RAGGED = [RNG.integers(0, 256, (16 + 4 * i, 20 - 2 * i, 3)).astype(np.uint8) for i in range(N)]


def _branchy(pkg, where, **kw):
    fn, types = pkg.fn, pkg.types

    @pkg.pipeline_def(batch_size=N, num_threads=1, seed=5, enable_conditionals=True, **kw)
    def p():
        x = fn.external_source(source=lambda: IMGS, batch=True, layout="HWC")
        v = fn.external_source(source=lambda: VALS, batch=True)
        if where == "gpu":
            x = x.gpu()
        if v < 0.3:
            out = x
            tag = v * 2.0
        elif v < 0.6 and not (v < 0.4):
            out = fn.cast(x // 2, dtype=types.UINT8)
            tag = v + 1.0
        elif v > 0.9 or v < 0.5:
            out = fn.cast(255 - x, dtype=types.UINT8)
            tag = v - 1.0
        else:
            out = x & types.Constant(0xF0, types.UINT8)
            tag = v
        return out, tag

    pipe = p()
    pipe.build()
    return pipe


def _np(out):
    if type(out).__name__ == "TensorListGPU":
        t = out.as_tensor()
        return t.numpy() if hasattr(t, "numpy") else np.asarray(t)
    return out.as_array()


@pytest.mark.parametrize("where", ["cpu", "gpu"])
def test_if_elif_else_not_and_or_match_dali_tpu(where):
    ref = _branchy(dali_tpu, where, debug=True)
    port = _branchy(dali_tpu_torch, where, device="cpu")
    try:
        got, want = port.run(), ref.run()
    finally:
        port.shutdown()
        ref._executor.shutdown()
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    # every branch was taken by some sample
    out = _np(got[0]).astype(int)
    assert (out == IMGS).all(axis=(1, 2, 3)).any()
    assert (out == 255 - IMGS).all(axis=(1, 2, 3)).any()
    assert (out == IMGS // 2).all(axis=(1, 2, 3)).any()
    assert (out == (IMGS & 0xF0)).all(axis=(1, 2, 3)).any()


def _one_branch(pkg, **kw):
    fn = pkg.fn

    @pkg.pipeline_def(batch_size=N, num_threads=1, seed=5, enable_conditionals=True, **kw)
    def p():
        x = fn.external_source(source=lambda: IMGS, batch=True, layout="HWC")
        v = fn.external_source(source=lambda: VALS, batch=True)
        if v < 0.5:
            y = x
        return y  # noqa: F821  (defined in one branch only)

    return p()


def test_variable_defined_in_one_branch_raises_like_dali_tpu():
    errors = []
    for pkg, kw in ((dali_tpu, {}), (dali_tpu_torch, {"device": "cpu"})):
        with pytest.raises(RuntimeError) as e:
            _one_branch(pkg, **kw).build()
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert "'y' must be defined in both branches" in errors[1]


def _not_scalar(pkg, **kw):
    fn = pkg.fn

    @pkg.pipeline_def(batch_size=N, num_threads=1, seed=5, enable_conditionals=True, **kw)
    def p():
        x = fn.external_source(source=lambda: IMGS, batch=True, layout="HWC")
        if x > 3:
            x = x + 1
        return x

    pipe = p()
    pipe.build()
    return pipe


def test_condition_must_be_scalar_per_sample():
    for pkg, kw in ((dali_tpu, {}), (dali_tpu_torch, {"device": "cpu"})):
        pipe = _not_scalar(pkg, **kw)
        try:
            with pytest.raises(ValueError, match="scalar per sample"):
                pipe.run()
        finally:
            (pipe.shutdown if pkg is dali_tpu_torch else pipe._executor.shutdown)()


def _ragged(pkg, **kw):
    fn = pkg.fn

    @pkg.pipeline_def(batch_size=N, num_threads=1, seed=5, enable_conditionals=True, **kw)
    def p():
        x = fn.external_source(source=lambda: RAGGED, batch=True, layout="HWC").gpu()
        v = fn.external_source(source=lambda: VALS, batch=True)
        if v < 0.5:
            out = x
        else:
            out = fn.warp_affine(x, matrix=[0.5, 0.0, 1.0, 0.0, 0.5, 2.0], size=[20, 24],
                                 fill_value=7)
        # Rotate needs the merged per-sample shapes on the host
        return fn.rotate(out, angle=fn.external_source(source=lambda: VALS * 100, batch=True),
                         keep_size=True, fill_value=3)

    pipe = p()
    pipe.build()
    return pipe


def test_merge_shapes_are_known_on_the_host():
    """Ragged samples in one branch, a fixed 20x24 warp in the other: the
    merged per-sample shapes are host-known (a numpy array, no device
    readback) and equal dali_tpu's, and a Rotate after the Merge runs on
    them. Values within one uint8 step on at most 1e-4 of values (the
    rotation's bilinear taps)."""
    ref = _ragged(dali_tpu, debug=True)
    port = _ragged(dali_tpu_torch, device="cpu")
    try:
        got, want = port.run()[0], ref.run()[0]
    finally:
        port.shutdown()
        ref._executor.shutdown()
    assert isinstance(got._shapes, np.ndarray)
    expect = [(20, 24, 3) if v >= 0.5 else s.shape for v, s in zip(VALS, RAGGED)]
    assert got.shape() == want.shape() == expect
    assert tuple(got.as_tensor().shape) == tuple(np.asarray(want.as_tensor()).shape)
    diffs = [np.abs(got.at(i).astype(int) - np.asarray(want.at(i)).astype(int)) for i in range(N)]
    assert max(int(d.max()) for d in diffs) <= 1
    assert sum(int((d > 0).sum()) for d in diffs) <= 1e-4 * sum(d.size for d in diffs)
