"""PowerSpectrum (cpu and gpu) and the MultiPaste schema with its region
resolution (counterpart of those parts of ``dali_tpu/backend/misc.py``;
MultiPaste's gpu placement is in ``straggler_gpu.py``, as in the reference,
its cpu placement is ROADMAP.md Queue 1 item 5h)."""

from __future__ import annotations

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch
from .base import Operator

# ====================================== PowerSpectrum ==============================================

DALI_SCHEMA("PowerSpectrum").DocStr("Power spectrum of a 1-D signal.").NumInput(1).NumOutput(
    1).Devices("cpu", "gpu").AddOptionalArg(
    "nfft", ArgType.INT, "FFT size (default: signal length).", None
).AddOptionalArg("axis", ArgType.INT, "Transform axis.", -1).AddOptionalArg(
    "power", ArgType.INT, "2 = power, 1 = magnitude.", 2)


@register_operator("PowerSpectrum", "cpu")
class PowerSpectrumCPU(Operator):
    def run_sample(self, ctx, idx, x):
        axis = self.spec.GetArgument("axis")
        nfft = self.spec.GetArgument("nfft") or x.shape[axis]
        spec = np.abs(np.fft.rfft(x.astype(np.float32), n=nfft, axis=axis))
        if self.spec.GetArgument("power") == 2:
            spec = spec * spec
        return spec.astype(np.float32)


@register_operator("PowerSpectrum", "gpu")
class PowerSpectrumGPU(Operator):
    """|rfft|, squared for ``power=2``, over the padded canvas (a ragged
    batch transforms each signal with its zero padding, as the reference's
    lowering does); the output carries no per-sample shapes."""

    def lower(self, dctx, inp: DeviceBatch):
        axis = self.spec.GetArgument("axis")
        if axis >= 0:
            axis += 1
        nfft = self.spec.GetArgument("nfft") or inp.data.shape[axis]
        spec = torch.abs(torch.fft.rfft(inp.data.to(torch.float32), n=nfft, dim=axis))
        if self.spec.GetArgument("power") == 2:
            spec = spec * spec
        return [DeviceBatch(spec, None, inp.layout)]


# ====================================== MultiPaste =================================================

DALI_SCHEMA("MultiPaste").DocStr(
    """Pastes regions of (possibly several) input samples onto an output canvas
    (the Mosaic-augmentation primitive). Regions are selected by ``in_ids`` +
    ``in_anchors``/``shapes`` and placed at ``out_anchors``."""
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddArg(
    "in_ids", ArgType.INT_VEC, "Source sample index per pasted region.", tensor_ok=True,
    per_sample=True
).AddOptionalArg(
    "in_anchors", ArgType.INT_VEC, "Flattened [k, 2] source anchors.", None, tensor_ok=True,
    per_sample=True
).AddOptionalArg(
    "shapes", ArgType.INT_VEC, "Flattened [k, 2] region shapes.", None, tensor_ok=True,
    per_sample=True
).AddOptionalArg(
    "out_anchors", ArgType.INT_VEC, "Flattened [k, 2] destination anchors.", None,
    tensor_ok=True, per_sample=True
).AddOptionalArg(
    "output_size", ArgType.INT_VEC, "Output canvas (H, W).", None, tensor_ok=True,
    per_sample=True
).AddOptionalArg("dtype", ArgType.DATA_TYPE, "Output dtype.", None).AddOptionalArg(
    "in_anchors_rel", ArgType.FLOAT_VEC,
    "Flattened [k, 2] source anchors relative to each source sample's extent.", None,
    tensor_ok=True, per_sample=True
).AddOptionalArg(
    "shapes_rel", ArgType.FLOAT_VEC,
    "Flattened [k, 2] region shapes relative to each source sample's extent.", None,
    tensor_ok=True, per_sample=True
).AddOptionalArg(
    "out_anchors_rel", ArgType.FLOAT_VEC,
    "Flattened [k, 2] destination anchors relative to the output canvas.", None,
    tensor_ok=True, per_sample=True)


def resolve_mp_regions(op, ctx, i, ids, src_hw, out_hw):
    """MultiPaste anchors and shapes of output sample ``i`` from the absolute
    or the ``*_rel`` arguments: (in_anchors [k, 2], out_anchors [k, 2],
    shapes [k, 2] or None), integers. Relative values scale by the source
    samples' extents (in_anchors, shapes) or the output canvas
    (out_anchors)."""
    k = len(ids)

    def get(name, scale):
        v = ctx.arg(op, name, i, None)
        if v is not None:
            return np.asarray(v, np.float64).reshape(k, 2).round().astype(np.int64)
        rv = ctx.arg(op, name + "_rel", i, None)
        if rv is not None:
            rv = np.asarray(rv, np.float64).reshape(k, 2) * scale
            return rv.round().astype(np.int64)
        return None

    src_hw = np.asarray(src_hw, np.float64).reshape(k, 2)
    ia = get("in_anchors", src_hw)
    oa = get("out_anchors", np.asarray(out_hw, np.float64)[None].repeat(k, 0))
    sh = get("shapes", src_hw)
    z = np.zeros((k, 2), np.int64)
    return (ia if ia is not None else z), (oa if oa is not None else z), sh
