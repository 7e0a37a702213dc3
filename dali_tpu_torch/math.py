"""Element-wise math over DataNodes (counterpart of ``dali_tpu/math.py``):
each function emits one ``_ArithmeticGenericOp`` node; on eager ``ndd``
Batches it runs that operator at once."""

from __future__ import annotations

from .data_node import DataNode


def _arithm(op, *args):
    if isinstance(args[0], DataNode):
        return args[0]._arithm(op, *args[1:])
    if len(args) == 2 and isinstance(args[1], DataNode):
        return args[1]._arithm(op, args[0], reverse=True)
    from .experimental.dynamic import Batch, _batch_arithm

    if any(isinstance(a, Batch) for a in args):
        out = _batch_arithm(op, *args)
        if out is NotImplemented:
            raise TypeError(f"math.{op}: unsupported operand types "
                            f"{tuple(type(a).__name__ for a in args)}")
        return out
    raise TypeError(f"math.{op} requires a DataNode or dynamic Batch argument")


def _unary(op):
    def f(x):
        return _arithm(op, x)

    f.__name__ = op
    return f


def _binary(op):
    def f(x, y):
        return _arithm(op, x, y)

    f.__name__ = op
    return f


sqrt, rsqrt, cbrt = _unary("sqrt"), _unary("rsqrt"), _unary("cbrt")
exp, log, log2, log10 = _unary("exp"), _unary("log"), _unary("log2"), _unary("log10")
abs = fabs = _unary("abs")  # noqa: A001
floor, ceil = _unary("floor"), _unary("ceil")
sin, cos, tan = _unary("sin"), _unary("cos"), _unary("tan")
asin, acos, atan = _unary("asin"), _unary("acos"), _unary("atan")
sinh, cosh, tanh = _unary("sinh"), _unary("cosh"), _unary("tanh")
asinh, acosh, atanh = _unary("asinh"), _unary("acosh"), _unary("atanh")
atan2, pow, fpow = _binary("atan2"), _binary("pow"), _binary("fpow")  # noqa: A001
min, max = _binary("min"), _binary("max")  # noqa: A001


def clamp(x, lo, hi):
    return _arithm("clamp", x, lo, hi)
