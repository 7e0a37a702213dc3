"""Arithmetic expression operator (counterpart of ``dali_tpu/backend/arithm.py``).

One ``_ArithmeticGenericOp`` node per Python operator, with a descriptor such
as ``add(&0 $2:9)``: ``&i`` is input i, ``$v:t`` a literal of DALI type t.
The cpu op is the reference's numpy code. The gpu op works on torch tensors
and gives every expression the dtype the reference's device program gives it:
JAX's promotion of the operand dtypes (literals are strongly typed, an integer
meeting a float takes the float, 64-bit types narrow to 32 bits), computed
up front, with every operand cast to it before torch runs the operator. Torch
would otherwise promote differently (uint8 with an int32 0-dim tensor stays
uint8 there, and is int32 in JAX).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch
from ..types import DALIDataType, to_numpy_type
from .base import Operator

DALI_SCHEMA("_ArithmeticGenericOp").DocStr(
    "Element-wise arithmetic over batches."
).NumInput(0, 16).NumOutput(1).Devices("cpu", "gpu").MakeInternal().AddArg(
    "expression_desc", ArgType.STRING, "Expression descriptor, e.g. 'add(&0 $1:9)'."
)

_TOKEN_RE = re.compile(r"&(\d+)|\$(.+?):(\d+)")


def _parse(desc: str):
    op, _, rest = desc.partition("(")
    rest = rest.rstrip(")")
    tokens = []
    for tok in rest.split():
        m = _TOKEN_RE.fullmatch(tok)
        if not m:
            raise ValueError(f"Bad expression token {tok!r} in {desc!r}")
        if m.group(1) is not None:
            tokens.append(("input", int(m.group(1))))
        else:
            dtype = DALIDataType(int(m.group(3)))
            val = eval(m.group(2), {"__builtins__": {}})  # literal repr only
            tokens.append(("const", np.asarray(val, dtype=to_numpy_type(dtype))))
    return op, tokens


# -- host (numpy), as in the reference -------------------------------------------------

def _np_is_int(a):
    return np.issubdtype(np.asarray(a).dtype, np.integer)


def _np_float(a):
    a = np.asarray(a)
    return a if np.issubdtype(a.dtype, np.floating) else a.astype(np.float32)


_NP_UNARY_FLOAT = {
    "sqrt": np.sqrt, "cbrt": np.cbrt, "exp": np.exp, "log": np.log, "log2": np.log2,
    "log10": np.log10, "sin": np.sin, "cos": np.cos, "tan": np.tan, "asin": np.arcsin,
    "acos": np.arccos, "atan": np.arctan, "sinh": np.sinh, "cosh": np.cosh,
    "tanh": np.tanh, "asinh": np.arcsinh, "acosh": np.arccosh, "atanh": np.arctanh,
    "ceil": np.ceil, "floor": np.floor,
}

_NP_OPS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "fdiv": lambda a, b: _np_float(a) / _np_float(b),
    "div": lambda a, b: a // b if _np_is_int(a) and _np_is_int(b) else a / b,
    "mod": lambda a, b: a % b,
    "pow": lambda a, b: a ** b,
    "fpow": lambda a, b: _np_float(a) ** _np_float(b),
    "minus": lambda a: -a,
    "plus": lambda a: +a,
    "abs": lambda a: abs(a),
    "rsqrt": lambda a: 1.0 / np.sqrt(_np_float(a)),
    "atan2": lambda a, b: np.arctan2(a, b),
    "min": lambda a, b: np.minimum(a, b),
    "max": lambda a, b: np.maximum(a, b),
    "clamp": lambda a, lo, hi: np.clip(a, lo, hi),
    "eq": lambda a, b: a == b,
    "neq": lambda a, b: a != b,
    "lt": lambda a, b: a < b,
    "leq": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "geq": lambda a, b: a >= b,
    "bitand": lambda a, b: a & b,
    "bitor": lambda a, b: a | b,
    "bitxor": lambda a, b: a ^ b,
}
for _name, _f in _NP_UNARY_FLOAT.items():
    _NP_OPS[_name] = (lambda f: lambda a: f(_np_float(a)))(_f)


# exactly rounded in numpy whatever the array size (no vectorized libm)
_EXACT = {"add", "sub", "mul", "fdiv", "div", "mod", "minus", "plus", "abs", "min", "max",
          "clamp", "eq", "neq", "lt", "leq", "gt", "geq", "bitand", "bitor", "bitxor",
          "ceil", "floor"}


@register_operator("_ArithmeticGenericOp", "cpu")
class ArithmCPU(Operator):
    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._op, self._tokens = _parse(spec.GetArgument("expression_desc"))
        self.elementwise = self._op in _EXACT

    def run_sample(self, ctx, idx, *inputs):
        args = [inputs[t[1]] if t[0] == "input" else t[1] for t in self._tokens]
        return np.asarray(_NP_OPS[self._op](*args))

    def output_layout(self, output_idx, inputs):
        for b in inputs:
            if b.layout:
                return b.layout
        return ""


# -- device (torch) with the reference's result dtypes ---------------------------------

_FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)
_SIGNED = (torch.int8, torch.int16, torch.int32, torch.int64)
_CANON = {torch.int64: torch.int32, torch.float64: torch.float32}


def _bits(t: torch.dtype) -> int:
    return torch.finfo(t).bits if t.is_floating_point else torch.iinfo(t).bits


def promote(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    """JAX's promotion of two strongly typed dtypes (x64 disabled)."""
    a, b = _CANON.get(a, a), _CANON.get(b, b)
    for t in (a, b):
        if t not in _FLOATS + _SIGNED + (torch.uint8, torch.bool):
            raise TypeError(f"dtype {t} is not supported by the ported arithmetic")
    if a == b:
        return a
    if a == torch.bool or b == torch.bool:
        return b if a == torch.bool else a
    if a.is_floating_point and b.is_floating_point:
        if {a, b} == {torch.float16, torch.bfloat16}:
            return torch.float32
        return a if _bits(a) >= _bits(b) else b
    if a.is_floating_point or b.is_floating_point:
        return a if a.is_floating_point else b
    if torch.uint8 in (a, b):  # uint8 with a signed type: the next signed width up
        s = b if a == torch.uint8 else a
        return s if _bits(s) > 8 else torch.int16
    return a if _bits(a) >= _bits(b) else b


def _result(*xs):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = promote(dt, x.dtype)
    return _CANON.get(dt, dt)


def _cast(dt, *xs):
    return [x.to(dt) for x in xs]


def _float(x):
    return x if x.dtype.is_floating_point else x.to(torch.float32)


def _binary(f):
    def op(a, b):
        return f(*_cast(_result(a, b), a, b))
    return op


def _int_div(a, b):
    if a.dtype.is_floating_point or b.dtype.is_floating_point or torch.bool in (a.dtype, b.dtype):
        return _true_div(a, b)
    a, b = _cast(_result(a, b), a, b)
    return torch.div(a, b, rounding_mode="floor")


def _true_div(a, b):
    # jnp.true_divide: integer and bool operands become the default float
    dt = _result(a, b)
    if not dt.is_floating_point:
        dt = torch.float32
    return torch.div(*_cast(dt, a, b))


def _inexact(f):
    def op(a, b):
        dt = _result(a, b)
        if not dt.is_floating_point:
            dt = torch.float32
        return f(*_cast(dt, a, b))
    return op


def _clamp(a, lo, hi):
    dt = _result(a, lo, hi)
    a, lo, hi = _cast(dt, a, lo, hi)
    return torch.minimum(torch.maximum(a, lo), hi)


_LOG_HALF = float(np.log(np.float32(0.5)))


def _sinh(x):
    # XLA's formula, so results and overflow points match the reference's:
    # exp(x + ln 1/2) - exp(-x + ln 1/2), and expm1 below |x| = 1
    em1 = torch.expm1(x)
    return torch.where(x.abs() < 1, 0.5 * (em1 + em1 / (em1 + 1.0)),
                       torch.exp(x + _LOG_HALF) - torch.exp(-x + _LOG_HALF))


def _cosh(x):
    return torch.clamp(torch.exp(x + _LOG_HALF) + torch.exp(-x + _LOG_HALF), min=1.0)


_TORCH_UNARY_FLOAT = {
    "sqrt": torch.sqrt, "cbrt": lambda x: torch.sign(x) * torch.abs(x) ** (1.0 / 3.0),
    "exp": torch.exp, "log": torch.log, "log2": torch.log2, "log10": torch.log10,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan, "asin": torch.asin,
    "acos": torch.acos, "atan": torch.atan, "sinh": _sinh, "cosh": _cosh,
    "tanh": torch.tanh, "asinh": torch.asinh, "acosh": torch.acosh, "atanh": torch.atanh,
    "ceil": torch.ceil, "floor": torch.floor,
}

TORCH_OPS = {
    "add": _binary(torch.add),
    "sub": _binary(torch.sub),
    "mul": _binary(torch.mul),
    "fdiv": lambda a, b: _true_div(_float(a), _float(b)),
    "div": _int_div,
    "mod": _binary(torch.remainder),
    "pow": _binary(torch.pow),
    "fpow": lambda a, b: _binary(torch.pow)(_float(a), _float(b)),
    "minus": torch.neg,
    "plus": lambda a: a,
    "abs": torch.abs,
    "rsqrt": lambda a: 1.0 / torch.sqrt(_float(a)),
    "atan2": _inexact(torch.atan2),
    "min": _binary(torch.minimum),
    "max": _binary(torch.maximum),
    "clamp": _clamp,
    "eq": _binary(torch.eq),
    "neq": _binary(torch.ne),
    "lt": _binary(torch.lt),
    "leq": _binary(torch.le),
    "gt": _binary(torch.gt),
    "geq": _binary(torch.ge),
    "bitand": _binary(torch.bitwise_and),
    "bitor": _binary(torch.bitwise_or),
    "bitxor": _binary(torch.bitwise_xor),
}
for _name, _f in _TORCH_UNARY_FLOAT.items():
    TORCH_OPS[_name] = (lambda f: lambda a: f(_float(a)))(_f)


@register_operator("_ArithmeticGenericOp", "gpu")
class ArithmGPU(Operator):
    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._op, self._tokens = _parse(spec.GetArgument("expression_desc"))
        self._consts = {}  # token index -> the literal on the pipeline's device

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        # the output's per-sample extents broadcast (right-aligned) over the
        # inputs'; every input shape must be host-known, and each dim must
        # match or be 1, as in the reference
        if not input_shapes or any(s is None for s in input_shapes):
            return None
        known = [np.asarray(s) for s in input_shapes]
        nd = max(s.shape[1] for s in known)
        n = known[0].shape[0]
        out = np.ones((n, nd), np.int64)
        for s in known:
            aligned = np.concatenate([np.ones((n, nd - s.shape[1]), np.int64),
                                      s.astype(np.int64)], axis=1)
            bad = (aligned != out) & (aligned != 1) & (out != 1)
            if bad.any():
                i = int(np.argmax(bad.any(axis=1)))
                raise ValueError(
                    f"{self.spec.schema.name}: per-sample shapes are not broadcastable "
                    f"(sample {i}: {tuple(int(v) for v in out[i])} vs "
                    f"{tuple(int(v) for v in aligned[i])})")
            out = np.maximum(out, aligned)
        return [out]

    def _const(self, i: int, device):
        if i not in self._consts:
            c = torch.from_numpy(np.array(self._tokens[i][1])).to(device)
            self._consts[i] = c.to(_CANON[c.dtype]) if c.dtype in _CANON else c
        return self._consts[i]

    def lower(self, dctx, *inputs: DeviceBatch):
        args, shapes, layout = [], None, ""
        max_ndim = max((inputs[t[1]].data.dim() for t in self._tokens if t[0] == "input"),
                       default=1)
        device = inputs[0].data.device if inputs else self.pipeline.device
        for i, t in enumerate(self._tokens):
            if t[0] == "input":
                db = inputs[t[1]]
                data = db.data
                if data.dtype in _CANON:  # the reference's device arrays are 32-bit
                    data = data.to(_CANON[data.dtype])
                if data.dim() < max_ndim:
                    # per-sample broadcasting: batch dim first, sample dims
                    # right-aligned
                    data = data.reshape(data.shape[0], *([1] * (max_ndim - data.dim())),
                                        *data.shape[1:])
                args.append(data)
                if shapes is None and db.shapes is not None and db.data.dim() == max_ndim:
                    shapes = db.shapes
                layout = layout or db.layout
            else:
                args.append(self._const(i, device))
        if (self._op == "pow" and self._tokens[1][0] == "const"
                and self._tokens[1][1].dtype.kind in "iu"):
            # jnp.power with a constant integer exponent is lax.integer_pow:
            # the base keeps its dtype
            out = torch.pow(args[0], int(self._tokens[1][1]))
        else:
            out = TORCH_OPS[self._op](*args)
        return [DeviceBatch(out, shapes, layout)]
