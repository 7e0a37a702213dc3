"""Erase on the device (counterpart of ``dali_tpu/backend/generic_gpu.py``
``EraseGPU``; the schema is ``dali_tpu/backend/generic2.py``'s)."""

from __future__ import annotations

import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch
from .base import Operator

DALI_SCHEMA("Erase").DocStr("Erases (fills) regions.").NumInput(1).NumOutput(1).Devices(
    "cpu", "gpu").AddOptionalArg(
    "anchor", ArgType.FLOAT_VEC, "Region anchors (flattened).", None, tensor_ok=True
).AddOptionalArg(
    "shape", ArgType.FLOAT_VEC, "Region shapes (flattened).", None, tensor_ok=True
).AddOptionalArg(
    "axes", ArgType.INT_VEC, "Axes the regions refer to.", None
).AddOptionalArg(
    "axis_names", ArgType.TENSOR_LAYOUT, "Axes by layout name.", None
).AddOptionalArg(
    "fill_value", ArgType.FLOAT_VEC, "Fill values (one, or one per channel).", [0.0]
).AddOptionalArg(
    "normalized_anchor", ArgType.BOOL, "Anchors are relative.", False
).AddOptionalArg(
    "normalized_shape", ArgType.BOOL, "Shapes are relative.", False
).AddOptionalArg(
    "normalized", ArgType.BOOL, "Anchors and shapes are relative.", False
).AddOptionalArg(
    "centered_anchor", ArgType.BOOL, "Anchors denote region centers.", False)


@register_operator("Erase", "gpu")
class EraseGPU(Operator):
    """Each region is a mask of index comparisons against its rounded
    bounds; one ``where`` fills the union. Extents are kept, so the op
    composes with ragged canvases (relative regions scale by each sample's
    extent)."""

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        return [input_shapes[0]]

    def lower(self, dctx, inp: DeviceBatch):
        spec = self.spec
        data = inp.data
        canvas = list(data.shape[1:])
        ndim, n, dev = len(canvas), data.shape[0], data.device
        axes = spec.GetArgument("axes", None)
        names = spec.GetArgument("axis_names", None)
        if names and not axes:
            if not inp.layout:
                raise ValueError(f"Erase: axis_names={names!r} requires a layout on the input; "
                                 "pass `axes` (by index) instead")
            axes = [inp.layout.index(c) for c in names]
        if not axes:
            axes = list(range(min(2, ndim)))
        axes = sorted(a % ndim for a in axes)
        na = len(axes)

        def region_arg(name):
            v = dctx.arg(self, name, None)
            if v is None:
                return None
            if dctx.has_tensor_arg(self, name):
                return v.to(dev, torch.float32).reshape(n, -1, na)
            arr = torch.tensor(v, dtype=torch.float32, device=dev)
            return arr.reshape(1, -1, na).expand(n, arr.numel() // na, na)

        anchor, shape = region_arg("anchor"), region_arg("shape")
        if anchor is None or shape is None:
            return [inp]
        normalized = spec.GetArgument("normalized", False)
        ext = (inp.shapes if inp.shapes is not None
               else torch.tensor([canvas], dtype=torch.int32, device=dev).expand(n, ndim))
        dims = ext[:, axes].to(torch.float32)[:, None, :]  # [n, 1, na]
        if normalized or spec.GetArgument("normalized_anchor", False):
            anchor = anchor * dims
        if normalized or spec.GetArgument("normalized_shape", False):
            shape = shape * dims
        if spec.GetArgument("centered_anchor", False):
            anchor = anchor - shape / 2
        lo = torch.round(anchor)
        hi = lo + torch.round(shape)
        mshape = (n,) + tuple(canvas[a] for a in axes)
        mask = torch.zeros(mshape, dtype=torch.bool, device=dev)
        for r in range(lo.shape[1]):
            m = torch.ones(mshape, dtype=torch.bool, device=dev)
            for k in range(na):
                idx = torch.arange(mshape[1 + k], dtype=torch.float32, device=dev)
                idx = idx.reshape((1,) + (1,) * k + (-1,) + (1,) * (na - k - 1))
                bound = (n,) + (1,) * na
                m &= (idx >= lo[:, r, k].reshape(bound)) & (idx < hi[:, r, k].reshape(bound))
            mask |= m
        mask = mask.reshape([n] + [canvas[d] if d in axes else 1 for d in range(ndim)])
        fv = torch.tensor(spec.GetArgument("fill_value", [0.0]), device=dev).to(data.dtype)
        if fv.numel() > 1:
            fv = fv.reshape((1,) * ndim + (-1,))
        return [inp.with_data(torch.where(mask, fv, data))]
