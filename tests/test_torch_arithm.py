"""DataNode arithmetic in dali_tpu_torch against dali_tpu, on the CPU.

Every operator of the expression table, on the cpu op and on the gpu op,
over the dtypes a pipeline produces (bool, uint8, int16, int32, float32),
paired with each other and with Python literals (the int32, float32 and bool
``$v:t`` literals of the DSL). The same seeded numpy batches go through
``fn.external_source`` into both packages; the gpu op of dali_tpu runs op by
op (``debug=True``), as the port's does. Negative operands of ``//`` and
``%`` come from the int16/int32/float32 batches; comparisons give bool.

Tolerances: the result dtype equals the reference's; integer and bool
results are bit-equal; float results agree within 1e-6 relative, with NaN
and infinities in the same places. Results below float32's smallest normal
number (1.18e-38) count as zero: XLA on the CPU flushes them, torch keeps
them."""

import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch

DTYPES = [np.bool_, np.uint8, np.int16, np.int32, np.float32]
LITERALS = [3, -2.5, True]
N = 4

BINARY = ["add", "sub", "mul", "fdiv", "div", "mod", "pow", "fpow", "atan2", "min", "max",
          "eq", "neq", "lt", "leq", "gt", "geq", "bitand", "bitor", "bitxor"]
UNARY = ["minus", "plus", "abs", "sqrt", "rsqrt", "cbrt", "exp", "log", "log2", "log10", "sin",
         "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh", "asinh", "acosh", "atanh",
         "ceil", "floor"]
DUNDER = {"add": "__add__", "sub": "__sub__", "mul": "__mul__", "fdiv": "__truediv__",
          "div": "__floordiv__", "mod": "__mod__", "pow": "__pow__", "eq": "__eq__",
          "neq": "__ne__", "lt": "__lt__", "leq": "__le__", "gt": "__gt__", "geq": "__ge__",
          "bitand": "__and__", "bitor": "__or__", "bitxor": "__xor__", "minus": "__neg__",
          "plus": "__pos__", "abs": "__abs__"}
RDUNDER = {"add": "__radd__", "sub": "__rsub__", "mul": "__rmul__", "fdiv": "__rtruediv__",
           "div": "__rfloordiv__", "mod": "__rmod__", "pow": "__rpow__", "bitand": "__rand__",
           "bitor": "__ror__", "bitxor": "__rxor__"}


def _batch(dtype, seed, small=False):
    """Seeded [N, 3, 5] samples: no zeros (divisors), negatives where the
    dtype has them; ``small`` keeps values in [0, 3] (powers)."""
    rng = np.random.default_rng(seed)
    shape = (N, 3, 5)
    if dtype == np.bool_:
        return rng.integers(0, 2, shape).astype(bool) if seed % 2 else np.ones(shape, bool)
    if small:
        return rng.integers(0, 4, shape).astype(dtype)
    if dtype == np.float32:
        x = (rng.standard_normal(shape) * 20).astype(np.float32)
        return np.where(np.abs(x) < 0.5, np.float32(1.5), x)
    x = rng.integers(1, 256, shape) if dtype == np.uint8 else rng.integers(-300, 300, shape)
    return np.where(x == 0, 7, x).astype(dtype)


def _kind(x):
    return np.dtype(x if isinstance(x, type) else type(x))


def _valid(op, a, b):
    ka, kb = _kind(a), _kind(b)
    if op.startswith("bit"):
        return "f" not in (ka.kind, kb.kind)
    if op in ("div", "mod"):
        return kb != np.bool_  # a bool divisor may be False
    if op == "sub":
        return not (ka == np.bool_ and kb == np.bool_)
    if op in ("pow", "fpow"):
        return np.bool_ not in (ka, kb) and not (isinstance(b, float) and ka.kind != "f")
    return True


def _cases(op):
    """(lhs, rhs) operand specs: a dtype is an input batch, a value a literal."""
    out = []
    for a in DTYPES:
        out += [(a, b) for b in DTYPES if _valid(op, a, b)]
        if op in DUNDER:
            out += [(a, lit) for lit in LITERALS if _valid(op, a, lit)]
        if op in RDUNDER:
            out += [(lit, a) for lit in LITERALS if _valid(op, lit, a)]
    return out


def _pipe(pkg, where, build, small=False, **kw):
    fn = pkg.fn
    data = {np.dtype(d).name: (_batch(d, 1, small), _batch(d, 2, small)) for d in DTYPES}

    @pkg.pipeline_def(batch_size=N, num_threads=1, seed=3, **kw)
    def p():
        ins = {}
        for name, pair in data.items():
            nodes = [fn.external_source(source=lambda v=v: v, batch=True) for v in pair]
            ins[name] = [n.gpu() for n in nodes] if where == "gpu" else nodes
        return tuple(build(pkg, ins))

    pipe = p()
    pipe.build()
    return pipe


def _outputs(outs, port):
    res = []
    for o in outs:
        if type(o).__name__ == "TensorListGPU":
            res.append(o.as_tensor().numpy() if port else np.asarray(o.as_tensor()))
        else:
            res.append(o.as_array())
    return res


def _check(where, build, labels, small=False):
    ref = _pipe(dali_tpu, where, build, small, debug=True)
    port = _pipe(dali_tpu_torch, where, build, small, device="cpu")
    try:
        got, want = _outputs(port.run(), True), _outputs(ref.run(), False)
    finally:
        port.shutdown()
        ref._executor.shutdown()
    assert len(got) == len(want) == len(labels)
    for what, g, w in zip(labels, got, want):
        what = f"{what} on {where}"
        assert g.dtype == w.dtype, f"{what}: dtype {g.dtype}, the reference's {w.dtype}"
        assert g.shape == w.shape, what
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=np.finfo(np.float32).tiny,
                                       equal_nan=True, err_msg=what)
        else:
            np.testing.assert_array_equal(g, w, err_msg=what)


def _operand(ins, spec, side):
    return ins[np.dtype(spec).name][side] if isinstance(spec, type) else spec


@pytest.mark.parametrize("device", ["cpu", "gpu"])
@pytest.mark.parametrize("op", BINARY)
def test_binary_operator_matches_dali_tpu(op, device):
    cases = _cases(op)

    def build(pkg, ins):
        for a, b in cases:
            lhs, rhs = _operand(ins, a, 0), _operand(ins, b, 1)
            if op in ("fpow", "atan2", "min", "max"):
                yield getattr(pkg.math, op)(lhs, rhs)
            elif isinstance(a, type):
                yield getattr(lhs, DUNDER[op])(rhs)
            else:
                yield getattr(rhs, RDUNDER[op])(lhs)

    _check(device, build, [f"{op}({_kind(a)}, {_kind(b)})" for a, b in cases],
           small=op in ("pow", "fpow"))


@pytest.mark.parametrize("device", ["cpu", "gpu"])
@pytest.mark.parametrize("op", UNARY)
def test_unary_operator_matches_dali_tpu(op, device):
    dts = [d for d in DTYPES if not (op in ("minus", "plus", "abs") and d == np.bool_)]

    def build(pkg, ins):
        for d in dts:
            x = ins[np.dtype(d).name][0]
            yield getattr(x, DUNDER[op])() if op in DUNDER else getattr(pkg.math, op)(x)

    _check(device, build, [f"{op}({np.dtype(d)})" for d in dts])


@pytest.mark.parametrize("device", ["cpu", "gpu"])
def test_clamp_matches_dali_tpu(device):
    bounds = [(0, 100), (-1.5, 50.5)]
    dts = [d for d in DTYPES if d != np.bool_]

    def build(pkg, ins):
        for d in dts:
            x = ins[np.dtype(d).name][0]
            for lo, hi in bounds:
                yield pkg.math.clamp(x, lo, hi)
            yield pkg.math.clamp(x, ins[np.dtype(d).name][1], ins["int16"][1])

    _check(device, build, [f"clamp({np.dtype(d)}, {b})" for d in dts
                           for b in bounds + ["nodes"]])


def _scalar_pipe(pkg, where, scalar_shape, **kw):
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (N, 8, 6, 3)).astype(np.uint8)
    scale = rng.uniform(0.5, 2.0, (N,) + scalar_shape).astype(np.float32)
    fn = pkg.fn

    @pkg.pipeline_def(batch_size=N, num_threads=1, seed=3, **kw)
    def p():
        x = fn.external_source(source=lambda: img, batch=True, layout="HWC")
        s = fn.external_source(source=lambda: scale, batch=True)
        if where == "gpu":
            x = x.gpu()  # the scalar stays a CPU node: the expression copies it
        return x * s, (x > 128) | (s > 1.0)

    pipe = p()
    pipe.build()
    return pipe


@pytest.mark.parametrize("device", ["cpu", "gpu"])
def test_per_sample_scalar_broadcasts_against_images(device):
    """Bit-equal: one float32 multiply per value, and a bool expression."""
    ref = _scalar_pipe(dali_tpu, device, (), debug=True)
    port = _scalar_pipe(dali_tpu_torch, device, (), device="cpu")
    try:
        got, want = _outputs(port.run(), True), _outputs(ref.run(), False)
    finally:
        port.shutdown()
        ref._executor.shutdown()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape == (N, 8, 6, 3)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("device", ["cpu", "gpu"])
def test_broadcast_error_matches_dali_tpu(device):
    """Per-sample shapes (8, 6, 3) and (5,) do not broadcast: both raise."""
    for pkg, kw in ((dali_tpu, {"debug": True}), (dali_tpu_torch, {"device": "cpu"})):
        pipe = _scalar_pipe(pkg, device, (5,), **kw)
        try:
            with pytest.raises(ValueError, match="broadcast"):
                pipe.run()
        finally:
            (pipe.shutdown if pkg is dali_tpu_torch else pipe._executor.shutdown)()


def test_promotion_follows_jax_not_torch():
    """uint8 & an int32 literal is int32 in the reference's device program;
    torch alone would keep uint8."""
    import torch

    from dali_tpu_torch.backend.arithm import promote

    assert promote(torch.uint8, torch.int32) == torch.int32
    assert promote(torch.int32, torch.float16) == torch.float16
    assert promote(torch.uint8, torch.int8) == torch.int16
    assert promote(torch.int64, torch.float64) == torch.float32
