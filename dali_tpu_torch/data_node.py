"""Symbolic graph edge (counterpart of ``dali_tpu/data_node.py``).

``.gpu()`` inserts a ``_CopyToDevice`` node; arithmetic and comparison
operators on DataNodes emit one ``_ArithmeticGenericOp`` node per Python
operator, with Python scalars as ``$v:t`` literals of an explicit DALI type.
An expression with any input on the device runs there, and its CPU inputs are
copied with ``.gpu()``.
"""

from __future__ import annotations

from typing import Optional

from . import types as _types


class DataNode:
    def __init__(self, name: str, device: str = "cpu", source=None, source_idx: int = 0):
        self.name = name
        self.device = device  # "cpu" or "gpu"
        self.source = source  # producing graph.OpNode
        self.source_idx = source_idx

    def gpu(self) -> "DataNode":
        """A device copy of this edge: a new ``_CopyToDevice`` node per call."""
        if self.device == "gpu":
            return self
        from . import _op_call

        return _op_call("_CopyToDevice", device="mixed", inputs=[self])

    def cpu(self) -> "DataNode":
        if self.device == "cpu":
            return self
        raise ValueError("device->host transfers inside the graph are not supported")

    def _arithm(self, op: str, *others, reverse=False):
        from . import _op_call

        operands = (others[::-1] + (self,)) if reverse else ((self,) + others)
        inputs, descs = [], []
        for o in operands:
            if isinstance(o, DataNode):
                descs.append(f"&{len(inputs)}")
                inputs.append(o)
            elif isinstance(o, _types.ScalarConstant):
                descs.append(_scalar_desc(o.value, o.dtype))
            elif isinstance(o, (bool, int, float)):
                descs.append(_scalar_desc(o, None))
            else:
                return NotImplemented
        device = "gpu" if any(i.device == "gpu" for i in inputs) else "cpu"
        if device == "gpu":
            inputs = [i if i.device == "gpu" else i.gpu() for i in inputs]
        return _op_call("_ArithmeticGenericOp", device=device, inputs=inputs,
                        expression_desc=f"{op}({' '.join(descs)})")

    def __add__(self, other):
        return self._arithm("add", other)

    def __radd__(self, other):
        return self._arithm("add", other, reverse=True)

    def __sub__(self, other):
        return self._arithm("sub", other)

    def __rsub__(self, other):
        return self._arithm("sub", other, reverse=True)

    def __mul__(self, other):
        return self._arithm("mul", other)

    def __rmul__(self, other):
        return self._arithm("mul", other, reverse=True)

    def __truediv__(self, other):
        return self._arithm("fdiv", other)

    def __rtruediv__(self, other):
        return self._arithm("fdiv", other, reverse=True)

    def __floordiv__(self, other):
        return self._arithm("div", other)

    def __rfloordiv__(self, other):
        return self._arithm("div", other, reverse=True)

    def __mod__(self, other):
        return self._arithm("mod", other)

    def __rmod__(self, other):
        return self._arithm("mod", other, reverse=True)

    def __pow__(self, other):
        return self._arithm("pow", other)

    def __rpow__(self, other):
        return self._arithm("pow", other, reverse=True)

    def __neg__(self):
        return self._arithm("minus")

    def __pos__(self):
        return self._arithm("plus")

    def __abs__(self):
        return self._arithm("abs")

    def __eq__(self, other):
        return self._arithm("eq", other)

    def __ne__(self, other):
        return self._arithm("neq", other)

    def __lt__(self, other):
        return self._arithm("lt", other)

    def __le__(self, other):
        return self._arithm("leq", other)

    def __gt__(self, other):
        return self._arithm("gt", other)

    def __ge__(self, other):
        return self._arithm("geq", other)

    def __and__(self, other):
        return self._arithm("bitand", other)

    def __rand__(self, other):
        return self._arithm("bitand", other, reverse=True)

    def __or__(self, other):
        return self._arithm("bitor", other)

    def __ror__(self, other):
        return self._arithm("bitor", other, reverse=True)

    def __xor__(self, other):
        return self._arithm("bitxor", other)

    def __rxor__(self, other):
        return self._arithm("bitxor", other, reverse=True)

    def __bool__(self):
        raise TypeError("A DataNode cannot be used in a plain Python `if`/`and`/`or`; use "
                        "@pipeline_def(enable_conditionals=True) for per-sample conditionals.")

    __hash__ = object.__hash__

    def __repr__(self):
        src = self.source.instance_name if self.source is not None else None
        return f"DataNode(name={self.name!r}, device={self.device!r}, source={src!r})"


def _scalar_desc(value, dtype: Optional[_types.DALIDataType]) -> str:
    if dtype is None:
        if isinstance(value, bool):
            dtype = _types.BOOL
        elif isinstance(value, int):
            dtype = _types.INT32
        else:
            dtype = _types.FLOAT
    return f"${repr(value)}:{int(dtype)}"
