"""ElementExtract, SequenceRearrange and PerFrame, cpu and gpu (counterpart of
``dali_tpu/backend/sequence.py``). The frame dim is the leading 'F' of the
layout; on the device it is dim 1 of the padded [N, F, ...] canvas."""

from __future__ import annotations

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch, HostBatch
from .base import BF16_BITS, Operator

DALI_SCHEMA("ElementExtract").DocStr(
    "Extracts elements (frames) from sequences; one output per entry in element_map."
).NumInput(1).OutputFn(lambda spec: max(len(spec.GetArgument("element_map") or [0]), 1)).Devices(
    "cpu", "gpu"
).AddArg("element_map", ArgType.INT_VEC, "Frame indices to extract.")


def _frame_layout(layout: str) -> str:
    return layout[1:] if layout.startswith("F") else layout


@register_operator("ElementExtract", "cpu")
class ElementExtractCPU(Operator):
    def run_batch(self, ctx, inp: HostBatch):
        layout = _frame_layout(inp.layout)
        return [HostBatch([s[e] for s in inp.samples], layout=layout)
                for e in self.spec.GetArgument("element_map")]


@register_operator("ElementExtract", "gpu")
class ElementExtractGPU(Operator):
    def host_output_layouts(self, in_layouts):
        return [_frame_layout(in_layouts[0] if in_layouts else "")]

    def lower(self, dctx, inp: DeviceBatch):
        layout = _frame_layout(inp.layout)
        shapes = inp.shapes[:, 1:] if inp.shapes is not None else None
        return [DeviceBatch(inp.data[:, e], shapes, layout)
                for e in self.spec.GetArgument("element_map")]


DALI_SCHEMA("SequenceRearrange").DocStr("Reorders frames within each sequence.").NumInput(
    1).NumOutput(1).Devices("cpu", "gpu").AddArg(
    "new_order", ArgType.INT_VEC, "New frame order.", tensor_ok=True, per_sample=True)


@register_operator("SequenceRearrange", "cpu")
class SequenceRearrangeCPU(Operator):
    def run_sample(self, ctx, idx, seq):
        order = np.asarray(ctx.arg(self, "new_order", idx), np.int64).reshape(-1)
        return np.ascontiguousarray(seq[order])


@register_operator("SequenceRearrange", "gpu")
class SequenceRearrangeGPU(Operator):
    def lower(self, dctx, inp: DeviceBatch):
        order = dctx.arg(self, "new_order")
        x = inp.data
        if torch.is_tensor(order) and order.dim() == 2:  # per-sample orders [N, k]
            nidx = torch.arange(x.shape[0], device=x.device)[:, None]
            out = x[nidx, order.to(device=x.device, dtype=torch.int64)]
        else:
            out = x[:, torch.as_tensor(order, dtype=torch.int64, device=x.device).reshape(-1)]
        return [DeviceBatch(out, inp.shapes, inp.layout)]


DALI_SCHEMA("PerFrame").DocStr(
    "Marks a tensor argument as per-frame: a layout annotation pass-through."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "replace", ArgType.BOOL, "Replace existing layout.", False)


def _per_frame_layout(spec, layout: str) -> str:
    if layout.startswith("F"):
        return layout
    return "F" + (layout[1:] if spec.GetArgument("replace") else layout)


@register_operator("PerFrame", "cpu")
class PerFrameCPU(Operator):
    reads_bfloat16 = BF16_BITS

    def run_batch(self, ctx, inp: HostBatch):
        return [HostBatch(inp.samples, layout=_per_frame_layout(self.spec, inp.layout))]


@register_operator("PerFrame", "gpu")
class PerFrameGPU(Operator):
    def host_output_layouts(self, in_layouts):
        return [_per_frame_layout(self.spec, in_layouts[0] if in_layouts else "")]

    def lower(self, dctx, inp: DeviceBatch):
        return [DeviceBatch(inp.data, inp.shapes, _per_frame_layout(self.spec, inp.layout))]
