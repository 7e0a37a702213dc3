"""reductions.Mean, Min and Max (counterpart of ``dali_tpu/backend/reductions.py``):
the cpu ops in numpy, the gpu ops in torch on uniform batches only, as in
the reference."""

from __future__ import annotations

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch
from ..types import to_numpy_type, to_torch_type
from .base import Operator

_KINDS = ("Mean", "Max", "Min")

for _k in _KINDS:
    (DALI_SCHEMA(f"reductions.{_k}").DocStr(f"{_k} reduction over `axes` (default: all).")
     .NumInput(1).NumOutput(1).Devices("cpu", "gpu")
     .AddOptionalArg("axes", ArgType.INT_VEC, "Reduction axes (default: all).", None)
     .AddOptionalArg("axis_names", ArgType.TENSOR_LAYOUT, "Axes by layout name.", None)
     .AddOptionalArg("keep_dims", ArgType.BOOL, "Keep reduced dims as size 1.", False)
     .AddOptionalArg("dtype", ArgType.DATA_TYPE, "Output dtype.", None))


def _axes_of(spec, ndim, layout=""):
    names = spec.GetArgument("axis_names", None)
    if names:
        if not layout:
            raise ValueError(f"{spec.schema.name}: axis_names={names!r} requires a layout "
                             "on the input")
        missing = [c for c in names if c not in layout]
        if missing:
            raise ValueError(f"{spec.schema.name}: axis name(s) {missing} not in input "
                             f"layout {layout!r}")
        return tuple(layout.index(c) for c in names)
    axes = spec.GetArgument("axes", None)
    if axes is not None and len(axes):
        return tuple(a % ndim for a in axes)
    return tuple(range(ndim))


def _reduce_np(kind, x, axes, keep):
    if kind == "Mean":
        return np.mean(x.astype(np.float32), axis=axes, keepdims=keep)
    return (np.max if kind == "Max" else np.min)(x, axis=axes, keepdims=keep)


def _reduce_torch(kind, x, axes, keep):
    if kind == "Mean":
        return torch.mean(x.to(torch.float32), dim=axes, keepdim=keep)
    return torch.amax(x, dim=axes, keepdim=keep) if kind == "Max" else torch.amin(
        x, dim=axes, keepdim=keep)


class _ReductionCPU(Operator):
    kind = None

    def run_batch(self, ctx, *inputs):
        self._in_layout = inputs[0].layout if inputs else ""
        return super().run_batch(ctx, *inputs)

    def run_sample(self, ctx, idx, x):
        axes = _axes_of(self.spec, x.ndim, self._in_layout)
        out = np.asarray(_reduce_np(self.kind, x, axes, self.spec.GetArgument("keep_dims")))
        dt = self.spec.GetArgument("dtype", None)
        return out.astype(to_numpy_type(dt)) if dt is not None else out

    def output_layout(self, output_idx, inputs):
        return ""


class _ReductionGPU(Operator):
    kind = None

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        sh = input_shapes[0] if input_shapes else None
        if sh is None:
            return None
        sh = np.asarray(sh)
        lays = ctx.in_layouts(self)
        axes = _axes_of(self.spec, sh.shape[1], lays[0] if lays else "")
        if self.spec.GetArgument("keep_dims"):
            out = sh.copy()
            out[:, list(axes)] = 1
            return [out]
        return [sh[:, [a for a in range(sh.shape[1]) if a not in set(axes)]]]

    def lower(self, dctx, inp: DeviceBatch):
        if inp.shapes is not None:
            raise NotImplementedError(
                f"reductions.{self.kind}(gpu) requires uniform batches (pad first)")
        axes = tuple(a + 1 for a in _axes_of(self.spec, inp.data.dim() - 1, inp.layout))
        out = _reduce_torch(self.kind, inp.data, axes, self.spec.GetArgument("keep_dims"))
        dt = self.spec.GetArgument("dtype", None)
        if dt is not None:
            out = out.to(to_torch_type(dt))
        return [DeviceBatch(out, None, "")]


for _k in _KINDS:
    register_operator(f"reductions.{_k}", "cpu")(
        type(f"Reduction{_k}CPU", (_ReductionCPU,), {"kind": _k}))
    register_operator(f"reductions.{_k}", "gpu")(
        type(f"Reduction{_k}GPU", (_ReductionGPU,), {"kind": _k}))
