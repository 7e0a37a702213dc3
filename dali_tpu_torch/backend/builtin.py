"""Built-in structural operators (counterpart of ``dali_tpu/backend/builtin.py``):
``_CopyToDevice`` (``DataNode.gpu()``), ``Constant`` and ``ExternalSource``.

``ExternalSource`` is ported for a callable or iterable ``source`` that
yields whole batches (``batch=True``), with ``layout`` and ``dtype``;
``fn.external_source`` raises ``NotImplementedError`` for its other options.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch, HostBatch
from ..types import BatchInfo, DALIDataType, to_numpy_type
from .base import Operator

DALI_SCHEMA("_CopyToDevice").DocStr(
    "Host->device copy inserted by DataNode.gpu(): the executor stages its "
    "output across the boundary."
).NumInput(1).NumOutput(1).Devices("mixed").MakeInternal()


@register_operator("_CopyToDevice", "mixed")
class CopyToDevice(Operator):
    def run_batch(self, ctx, inp: HostBatch):
        return [inp]


DALI_SCHEMA("Constant").DocStr(
    "A constant batch (created by types.Constant)."
).NumInput(0).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "fdata", ArgType.FLOAT_VEC, "Float payload.", None
).AddOptionalArg(
    "idata", ArgType.INT_VEC, "Int payload.", None
).AddOptionalArg(
    "shape", ArgType.INT_VEC, "Output sample shape.", None
).AddOptionalArg(
    "dtype", ArgType.DATA_TYPE, "Output dtype.", None
).AddOptionalArg(
    "layout", ArgType.TENSOR_LAYOUT, "Output layout.", ""
)


class _ConstantBase(Operator):
    def _value(self) -> np.ndarray:
        fdata = self.spec.GetArgument("fdata", None)
        idata = self.spec.GetArgument("idata", None)
        payload = fdata if fdata is not None else (idata if idata is not None else [0])
        arr = np.asarray(payload, dtype=np.float32 if fdata is not None else np.int32)
        shape = self.spec.GetArgument("shape", None)
        if shape is not None:
            shape = list(shape)
            if arr.size == int(np.prod(shape)) if shape else arr.size == 1:
                arr = arr.reshape(shape)
            else:
                arr = np.full(shape, arr.reshape(-1)[0], arr.dtype)
        dtype = self.spec.GetArgument("dtype", None)
        if dtype is not None:
            arr = arr.astype(to_numpy_type(dtype))
        return arr


@register_operator("Constant", "cpu")
class ConstantCPU(_ConstantBase):
    def run_batch(self, ctx, *unused):
        v = self._value()
        return [HostBatch([v] * ctx.batch_size, layout=self.spec.GetArgument("layout", ""))]


@register_operator("Constant", "gpu")
class ConstantGPU(_ConstantBase):
    def lower(self, dctx, *unused):
        # the pipeline's max batch size, as the reference's device program
        v = torch.from_numpy(self._value()).to(self.pipeline.device)
        data = v[None].expand(self.pipeline.max_batch_size, *v.shape)
        return [DeviceBatch(data, None, self.spec.GetArgument("layout", ""))]


DALI_SCHEMA("ExternalSource").DocStr(
    "User data injection from a callable or iterable `source` that yields "
    "whole batches."
).NumInput(0).NumOutput(1).Devices("cpu").MakeStateful().AddOptionalArg(
    "batch", ArgType.BOOL, "`source` produces whole batches.", True
).AddOptionalArg(
    "layout", ArgType.TENSOR_LAYOUT, "Layout of the produced data.", ""
).AddOptionalArg(
    "dtype", ArgType.DATA_TYPE, "Expected dtype; other data raises.", None
)


@register_operator("ExternalSource", "cpu")
class ExternalSource(Operator):
    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._source = spec._extra["_source"]
        self._layout = spec.GetArgument("layout", "") or ""
        self._iter = None
        self._iteration = 0
        self._epoch = 0
        self._accepts_arg = False
        if callable(self._source):
            try:
                # a required positional parameter takes the BatchInfo
                self._accepts_arg = any(
                    p.default is inspect.Parameter.empty
                    and p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                                   inspect.Parameter.POSITIONAL_OR_KEYWORD)
                    for p in inspect.signature(self._source).parameters.values())
            except (TypeError, ValueError):
                self._accepts_arg = False

    def run_batch(self, ctx, *unused):
        if callable(self._source):
            data = (self._source(BatchInfo(self._iteration, self._epoch)) if self._accepts_arg
                    else self._source())
        else:
            if self._iter is None:
                self._iter = iter(self._source)
            data = next(self._iter)
        if isinstance(data, tuple) and len(data) == 1:
            data = data[0]
        if isinstance(data, (list, tuple)):
            samples = [np.asarray(s) for s in data]
        else:
            arr = np.asarray(data)
            samples = [arr[i] for i in range(arr.shape[0])]
        if len(samples) > ctx.batch_size:
            raise ValueError(f"external_source produced {len(samples)} samples, more than the "
                             f"pipeline's max_batch_size={ctx.batch_size}")
        want = self.spec.GetArgument("dtype", None)
        if want is not None and samples and samples[0].dtype != to_numpy_type(DALIDataType(want)):
            raise TypeError(f"ExternalSource '{self.spec.name}': declared dtype "
                            f"{to_numpy_type(DALIDataType(want))} but source produced "
                            f"{samples[0].dtype}")
        if self._layout and samples and samples[0].ndim != len(self._layout):
            raise ValueError(f"ExternalSource '{self.spec.name}': layout {self._layout!r} but "
                             f"source produced {samples[0].ndim}-D samples")
        self._iteration += 1
        return [HostBatch(samples, layout=self._layout)]

    def save_state(self):
        return {"iteration": self._iteration, "epoch": self._epoch}

    def restore_state(self, state):
        self._iteration = int(state["iteration"])
        self._epoch = int(state.get("epoch", 0))


_PORTED_ES_ARGS = {"source", "batch", "layout", "dtype", "name", "device"}


def external_source(source=None, **kwargs):
    """fn.external_source: a callable (taking nothing or a BatchInfo) or an
    iterable ``source`` that yields whole batches; ``device='gpu'`` adds the
    host->device copy, as in the reference."""
    from .. import _op_call

    extra = sorted(k for k, v in kwargs.items() if k not in _PORTED_ES_ARGS and v is not None)
    if source is None or extra or kwargs.get("batch", True) is not True:
        what = "a per-sample source (batch=False)" if kwargs.get("batch", True) is not True else (
            "feed_input (no source)" if source is None else f"options {extra}")
        raise NotImplementedError(f"fn.external_source with {what} is not ported to "
                                  "dali_tpu_torch yet; see ROADMAP.md (Queue 1)")
    device = kwargs.get("device") or "cpu"
    if device not in ("cpu", "gpu"):
        raise ValueError(f"external_source device must be 'cpu' or 'gpu', got {device!r}")
    node = _op_call("ExternalSource", device="cpu", inputs=(), name=kwargs.get("name"),
                    batch=True, layout=kwargs.get("layout") or "", dtype=kwargs.get("dtype"),
                    _source=source)
    return node.gpu() if device == "gpu" else node
