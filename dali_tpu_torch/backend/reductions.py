"""The reductions Sum, Mean, Max, Min, MeanSquare, RootMeanSquare, StdDev
and Variance (counterpart of ``dali_tpu/backend/reductions.py``): the cpu
ops in numpy, the gpu ops in torch on uniform batches only, as in the
reference. StdDev and Variance take an optional second input, the mean
(with or without the reduced dims), and ``ddof``; the sum of squares is
divided by ``max(n - ddof, 1)``.

A bfloat16 host input (a ``torch.bfloat16`` tensor: numpy has none) is
computed as the reference computes its ml_dtypes array: every kind but Max
and Min upcasts it to float32 first (exact) and returns float32; Max and
Min compare the elements and return the chosen one, still bfloat16, its
bits unchanged (the float32 upcast's upper half)."""

from __future__ import annotations

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch
from ..types import cast_host, is_bfloat16, to_torch_type
from .base import Operator

_KINDS = ("Sum", "Mean", "Max", "Min", "MeanSquare", "RootMeanSquare", "StdDev", "Variance")
_WITH_MEAN = ("StdDev", "Variance")

for _k in _KINDS:
    _s = (DALI_SCHEMA(f"reductions.{_k}").DocStr(f"{_k} reduction over `axes` (default: all).")
          .NumInput(1, 2 if _k in _WITH_MEAN else 1).NumOutput(1).Devices("cpu", "gpu")
          .AddOptionalArg("axes", ArgType.INT_VEC, "Reduction axes (default: all).", None)
          .AddOptionalArg("axis_names", ArgType.TENSOR_LAYOUT, "Axes by layout name.", None)
          .AddOptionalArg("keep_dims", ArgType.BOOL, "Keep reduced dims as size 1.", False)
          .AddOptionalArg("dtype", ArgType.DATA_TYPE, "Output dtype.", None))
    if _k in _WITH_MEAN:
        _s.AddOptionalArg("ddof", ArgType.INT, "Delta degrees of freedom.", 0)


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


def _reduce_np(kind, x, axes, keep, ddof=0, mean=None):
    if kind == "Max":
        return np.max(x, axis=axes, keepdims=keep)
    if kind == "Min":
        return np.min(x, axis=axes, keepdims=keep)
    x = x.astype(np.float32)
    if kind == "Sum":
        return np.sum(x, axis=axes, keepdims=keep)
    if kind == "Mean":
        return np.mean(x, axis=axes, keepdims=keep)
    if kind == "MeanSquare":
        return np.mean(x * x, axis=axes, keepdims=keep)
    if kind == "RootMeanSquare":
        return np.sqrt(np.mean(x * x, axis=axes, keepdims=keep))
    m = np.mean(x, axis=axes, keepdims=True) if mean is None else _keep_reduced(mean, x, axes)
    n = int(np.prod([x.shape[a] for a in axes]))
    var = np.sum((x - m) ** 2, axis=axes, keepdims=keep) / max(n - ddof, 1)
    return np.sqrt(var) if kind == "StdDev" else var


def _reduce_torch(kind, x, axes, keep, ddof=0, mean=None):
    if kind == "Max":
        return torch.amax(x, dim=axes, keepdim=keep)
    if kind == "Min":
        return torch.amin(x, dim=axes, keepdim=keep)
    x = x.to(torch.float32)
    if kind == "Sum":
        return torch.sum(x, dim=axes, keepdim=keep)
    if kind == "Mean":
        return torch.mean(x, dim=axes, keepdim=keep)
    if kind == "MeanSquare":
        return torch.mean(x * x, dim=axes, keepdim=keep)
    if kind == "RootMeanSquare":
        return torch.sqrt(torch.mean(x * x, dim=axes, keepdim=keep))
    m = torch.mean(x, dim=axes, keepdim=True) if mean is None else _keep_reduced(mean, x, axes)
    n = int(np.prod([x.shape[a] for a in axes]))
    var = torch.sum((x - m) ** 2, dim=axes, keepdim=keep) / max(n - ddof, 1)
    return torch.sqrt(var) if kind == "StdDev" else var


def _keep_reduced(m, x, axes):
    """A mean given without the reduced dims, reshaped to broadcast."""
    if m.ndim == x.ndim:
        return m
    return m.reshape([1 if a in axes else x.shape[a] for a in range(x.ndim)])


def _float32(x) -> np.ndarray:
    """A host sample as numpy float32; a bfloat16 tensor upcasts exactly."""
    return x.to(torch.float32).numpy() if is_bfloat16(x) else np.asarray(x, np.float32)


class _ReductionCPU(Operator):
    kind = None
    reads_bfloat16 = True

    def run_batch(self, ctx, *inputs):
        self._in_layout = inputs[0].layout if inputs else ""
        return super().run_batch(ctx, *inputs)

    def run_sample(self, ctx, idx, x, *mean_in):
        spec = self.spec
        axes = _axes_of(spec, x.ndim, self._in_layout)
        ddof = spec.GetArgument("ddof") if self.kind in _WITH_MEAN else 0
        mean = _float32(mean_in[0]) if mean_in else None
        bf16 = is_bfloat16(x)
        out = np.asarray(_reduce_np(self.kind, _float32(x) if bf16 else x, axes,
                                    spec.GetArgument("keep_dims"), ddof, mean))
        if bf16 and self.kind in ("Max", "Min"):
            # an element of the input: its bfloat16 bits are the float32's upper half
            bits = (np.array(out, np.float32).view(np.uint32) >> 16).astype(np.uint16)
            out = torch.from_numpy(np.array(bits.view(np.int16), ndmin=1)).view(torch.bfloat16)
            out = out.reshape(bits.shape)
        dt = spec.GetArgument("dtype", None)
        return cast_host(out, dt) if dt is not None else out

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

    def lower(self, dctx, inp: DeviceBatch, *mean_in):
        if inp.shapes is not None:
            raise NotImplementedError(
                f"reductions.{self.kind}(gpu) requires uniform batches (pad first)")
        spec = self.spec
        axes = tuple(a + 1 for a in _axes_of(spec, inp.data.dim() - 1, inp.layout))
        ddof = spec.GetArgument("ddof") if self.kind in _WITH_MEAN else 0
        mean = mean_in[0].data.to(torch.float32) if mean_in else None
        out = _reduce_torch(self.kind, inp.data, axes, spec.GetArgument("keep_dims"), ddof, mean)
        dt = spec.GetArgument("dtype", None)
        if dt is not None:
            out = out.to(to_torch_type(dt))
        return [DeviceBatch(out, None, "")]


for _k in _KINDS:
    register_operator(f"reductions.{_k}", "cpu")(
        type(f"Reduction{_k}CPU", (_ReductionCPU,), {"kind": _k}))
    register_operator(f"reductions.{_k}", "gpu")(
        type(f"Reduction{_k}GPU", (_ReductionGPU,), {"kind": _k}))
