"""Normalize (counterpart of ``dali_tpu/backend/generic2.py`` ``Normalize``).

out = scale * (in - mean) / stddev + shift, with mean and stddev taken over
``axes`` unless given, or over the whole batch with ``batch=True``. On the
device the moments of a ragged batch run over each sample's valid region only.

As in the reference, the cpu op computes in float64 and honours ``ddof``; the
device op computes in float32 and ignores ``ddof`` (the reference's device
lowering does the same, ``dali_tpu/backend/generic2.py:563-619``).
"""

from __future__ import annotations

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch, HostBatch
from ..types import DALIDataType, to_numpy_type, to_torch_type
from .base import Operator

DALI_SCHEMA("Normalize").DocStr(
    """Mean/stddev normalization: out = scale * (in - mean) / stddev + shift;
    mean/stddev computed over ``axes`` unless given; ``batch=True`` normalizes
    across the whole batch."""
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "axes", ArgType.INT_VEC, "Reduction axes.", None
).AddOptionalArg(
    "axis_names", ArgType.TENSOR_LAYOUT, "Reduction axes by name.", None
).AddOptionalArg(
    "mean", ArgType.FLOAT, "Fixed mean.", None, tensor_ok=True
).AddOptionalArg(
    "stddev", ArgType.FLOAT, "Fixed stddev.", None, tensor_ok=True
).AddOptionalArg("batch", ArgType.BOOL, "Normalize across the whole batch.", False).AddOptionalArg(
    "scale", ArgType.FLOAT, "Output scale.", 1.0
).AddOptionalArg("shift", ArgType.FLOAT, "Output shift.", 0.0).AddOptionalArg(
    "epsilon", ArgType.FLOAT, "Added to variance.", 0.0
).AddOptionalArg("ddof", ArgType.INT, "Delta degrees of freedom.", 0).AddOptionalArg(
    "dtype", ArgType.DATA_TYPE, "Output dtype.", DALIDataType.FLOAT
)


def _norm_axes(spec, ndim, layout=""):
    names = spec.GetArgument("axis_names", None)
    if names and layout:
        return tuple(layout.index(c) for c in names)
    axes = spec.GetArgument("axes", None)
    if axes:
        return tuple(a % ndim for a in axes)
    return tuple(range(ndim))


@register_operator("Normalize", "cpu")
class NormalizeCPU(Operator):
    def run_batch(self, ctx, inp: HostBatch):
        spec = self.spec
        dt = to_numpy_type(spec.GetArgument("dtype"))
        scale, shift = spec.GetArgument("scale"), spec.GetArgument("shift")
        eps, ddof = spec.GetArgument("epsilon"), spec.GetArgument("ddof")
        outs = []
        if spec.GetArgument("batch"):
            flat = np.concatenate([s.astype(np.float64).reshape(-1) for s in inp.samples])
            mean = flat.mean()
            std = np.sqrt(flat.var(ddof=ddof) + eps)
            for s in inp.samples:
                outs.append((scale * (s.astype(np.float64) - mean) / max(std, 1e-12)
                             + shift).astype(dt))
            return [HostBatch(outs, layout=inp.layout)]
        for i, s in enumerate(inp.samples):
            axes = _norm_axes(spec, s.ndim, inp.layout)
            mean = ctx.arg(self, "mean", i, None)
            std = ctx.arg(self, "stddev", i, None)
            x = s.astype(np.float64)
            m = x.mean(axis=axes, keepdims=True) if mean is None else np.asarray(mean, np.float64)
            if std is None:
                var = ((x - m) ** 2).mean(axis=axes, keepdims=True)
                if ddof:
                    nred = np.prod([s.shape[a] for a in axes])
                    var = var * nred / max(nred - ddof, 1)
                sd = np.sqrt(var + eps)
            else:
                sd = np.asarray(std, np.float64)
            sd = np.where(sd == 0, 1.0, sd)
            outs.append((scale * (x - m) / sd + shift).astype(dt))
        return [HostBatch(outs, layout=inp.layout)]


@register_operator("Normalize", "gpu")
class NormalizeGPU(Operator):
    def lower(self, dctx, inp: DeviceBatch):
        spec = self.spec
        x = inp.data.to(torch.float32)
        axes = tuple(a + 1 for a in _norm_axes(spec, x.dim() - 1, inp.layout))
        if spec.GetArgument("batch"):
            axes = (0,) + axes
        eps = spec.GetArgument("epsilon")

        def fixed(name):
            """A fixed mean/stddev: a constant broadcasts as a scalar; a
            per-sample [N, ...] tensor argument broadcasts right-aligned over
            each sample's dims."""
            v = dctx.arg(self, name, None)
            if v is None:
                return None
            v = torch.as_tensor(v, dtype=torch.float32, device=x.device)
            if not dctx.has_tensor_arg(self, name):
                return v
            return v.reshape(v.shape[0], *([1] * (x.dim() - v.dim())), *v.shape[1:])

        m, sd = fixed("mean"), fixed("stddev")
        mask = inp.valid_mask()
        if mask is None:
            if m is None:
                m = x.mean(dim=axes, keepdim=True)
            if sd is None:
                sd = torch.sqrt(((x - m) ** 2).mean(dim=axes, keepdim=True) + eps)
        else:  # masked moments over each sample's valid region
            w = mask.to(torch.float32)
            count = torch.clamp(w.sum(dim=axes, keepdim=True), min=1.0)
            if m is None:
                m = (x * w).sum(dim=axes, keepdim=True) / count
            if sd is None:
                sd = torch.sqrt((((x - m) * w) ** 2).sum(dim=axes, keepdim=True) / count + eps)
        sd = torch.where(sd == 0, torch.ones_like(sd), sd)
        out = spec.GetArgument("scale") * (x - m) / sd + spec.GetArgument("shift")
        return [inp.with_data(out.to(to_torch_type(spec.GetArgument("dtype"))))]
