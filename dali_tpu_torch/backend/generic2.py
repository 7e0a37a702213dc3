"""Normalize, Cat, LookupTable and the Full family (counterpart of
``dali_tpu/backend/generic2.py``).

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


# -- Cat (cpu) ---------------------------------------------------------------------------

DALI_SCHEMA("Cat").DocStr("Concatenates samples along an axis.").NumInput(1, 16).NumOutput(
    1).Devices("cpu", "gpu").AddOptionalArg("axis", ArgType.INT, "Join axis.", 0).AddOptionalArg(
    "axis_name", ArgType.TENSOR_LAYOUT, "Join axis by name.", None)


@register_operator("Cat", "cpu")
class CatCPU(Operator):
    def run_batch(self, ctx, *inputs):
        # axis_name resolves against the first input's layout
        self._in_layout = inputs[0].layout if inputs else ""
        return super().run_batch(ctx, *inputs)

    def run_sample(self, ctx, idx, *inputs):
        axis = self.spec.GetArgument("axis", 0)
        name = self.spec.GetArgument("axis_name", None)
        if name:
            axis = self._in_layout.find(name)
            if axis < 0:
                raise ValueError(f"Cat: axis_name={name!r} not found in input layout "
                                 f"{self._in_layout!r}")
        return np.concatenate(inputs, axis=axis)


# -- LookupTable (cpu, gpu) ---------------------------------------------------------------

DALI_SCHEMA("LookupTable").DocStr(
    "Maps integer values through a table of `keys` -> `values`."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "keys", ArgType.INT_VEC, "Keys.", None
).AddOptionalArg(
    "values", ArgType.FLOAT_VEC, "Values for the keys.", None
).AddOptionalArg(
    "default_value", ArgType.FLOAT, "Value for unmapped keys.", 0.0
).AddOptionalArg("dtype", ArgType.DATA_TYPE, "Output dtype.", DALIDataType.FLOAT)


class _LUTCommon(Operator):
    """The 65,536-entry float32 table, built once per operator: it depends
    only on the operator's arguments (the reference rebuilds it per sample)."""

    _lut = None

    def _table(self) -> np.ndarray:
        if self._lut is None:
            keys = self.spec.GetArgument("keys", None) or []
            values = self.spec.GetArgument("values", None) or []
            lut = np.full(0x10000, self.spec.GetArgument("default_value", 0.0), np.float32)
            for k, v in zip(keys, values):
                lut[int(k)] = v
            self._lut = lut
        return self._lut


@register_operator("LookupTable", "cpu")
class LookupTableCPU(_LUTCommon):
    elementwise = True

    def run_sample(self, ctx, idx, x):
        dt = to_numpy_type(self.spec.GetArgument("dtype", DALIDataType.FLOAT))
        return self._table()[x.astype(np.int64)].astype(dt)


@register_operator("LookupTable", "gpu")
class LookupTableGPU(_LUTCommon):
    def lower(self, dctx, inp: DeviceBatch):
        if getattr(self, "_lut_dev", None) is None or self._lut_dev.device != inp.data.device:
            self._lut_dev = torch.from_numpy(self._table()).to(inp.data.device)
        dt = to_torch_type(self.spec.GetArgument("dtype", DALIDataType.FLOAT))
        # indexed as the reference's device program indexes: negative keys
        # wrap from the end, keys past it clamp
        idx = inp.data.to(torch.int32).to(torch.int64)
        idx = torch.where(idx < 0, idx + 0x10000, idx).clamp(0, 0xFFFF)
        return [inp.with_data(self._lut_dev[idx].to(dt))]


# -- Full / Zeros / Ones and their *Like variants (cpu) ------------------------------------

def _value_schema(name, doc):
    return (DALI_SCHEMA(name).DocStr(doc).NumInput(0, 1).NumOutput(1).Devices("cpu", "gpu")
            .AddOptionalArg("shape", ArgType.INT_VEC, "Output shape.", None, tensor_ok=True)
            .AddOptionalArg("dtype", ArgType.DATA_TYPE, "Output dtype.", None)
            .AddOptionalArg("layout", ArgType.STRING, "Layout of the output.", None))


_value_schema("Zeros", "Batch of zero tensors.")
_value_schema("Ones", "Batch of one tensors.")
_value_schema("Full", "Batch filled with `fill_value`.").AddArg(
    "fill_value", ArgType.FLOAT_VEC, "Fill value(s).", tensor_ok=True)
_value_schema("ZerosLike", "Zeros with the input's shape.")
_value_schema("OnesLike", "Ones with the input's shape.")
_value_schema("FullLike", "`fill_value` with the input's shape.").AddArg(
    "fill_value", ArgType.FLOAT_VEC, "Fill value(s).", tensor_ok=True)


class _ValueOpCPU(Operator):
    fill = 0.0
    like = False

    def output_layout(self, output_idx, inputs):
        explicit = self.spec.GetArgument("layout", None)
        if explicit:
            return explicit
        return inputs[0].layout if (self.like and inputs) else ""

    def run_sample(self, ctx, idx, *inputs):
        if self.like:
            shape, base_dt = inputs[0].shape, inputs[0].dtype
        else:
            shp = ctx.arg(self, "shape", idx, None)
            shape = tuple(int(v) for v in np.asarray(shp).reshape(-1)) if shp is not None else ()
            base_dt = np.dtype(np.int32)
        dt_arg = self.spec.GetArgument("dtype", None)
        dt = to_numpy_type(dt_arg) if dt_arg is not None else base_dt
        fv = self.fill
        if fv is None:  # Full / FullLike
            fv = np.asarray(ctx.arg(self, "fill_value", idx, 0.0))
            if fv.size > 1:
                return np.broadcast_to(fv.astype(dt), shape if shape else fv.shape).copy()
            if dt_arg is None and not self.like:
                dt = fv.dtype
            fv = fv.reshape(-1)[0]
        return np.full(shape, fv, dtype=dt)


for _nm, _fill, _like in (("Zeros", 0.0, False), ("Ones", 1.0, False), ("Full", None, False),
                          ("ZerosLike", 0.0, True), ("OnesLike", 1.0, True),
                          ("FullLike", None, True)):
    register_operator(_nm, "cpu")(type(_nm + "CPU", (_ValueOpCPU,), {"fill": _fill, "like": _like}))
