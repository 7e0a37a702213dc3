"""Cast, Reshape, Transpose and Pad (counterpart of
``dali_tpu/backend/generic.py``)."""

from __future__ import annotations

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch
from ..types import to_numpy_type, to_torch_type
from .base import Operator

DALI_SCHEMA("Cast").DocStr("Casts to another dtype.").NumInput(1).NumOutput(1).Devices(
    "cpu", "gpu").AddArg("dtype", ArgType.DATA_TYPE, "Target dtype.")


@register_operator("Cast", "cpu")
class CastCPU(Operator):
    elementwise = True

    def run_sample(self, ctx, idx, x):
        return x.astype(to_numpy_type(self.spec.GetArgument("dtype")))


@register_operator("Cast", "gpu")
class CastGPU(Operator):
    def lower(self, dctx, inp: DeviceBatch):
        return [inp.with_data(inp.data.to(to_torch_type(self.spec.GetArgument("dtype"))))]


DALI_SCHEMA("Reshape").DocStr(
    "Reinterprets the sample shape without touching the data."
).NumInput(1, 2).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "shape", ArgType.FLOAT_VEC, "New sample shape (-1 infers one dim).", None, tensor_ok=True
).AddOptionalArg(
    "layout", ArgType.TENSOR_LAYOUT, "New layout.", None
).AddOptionalArg(
    "rel_shape", ArgType.FLOAT_VEC, "Shape relative to the input.", None
).AddOptionalArg(
    "src_dims", ArgType.INT_VEC, "Dimension permutation/selection.", None
)


def _resolve_shape(cur_shape, req):
    req = [int(round(v)) for v in req]
    total = int(np.prod(cur_shape))
    if -1 in req:
        known = int(np.prod([v for v in req if v != -1]))
        req[req.index(-1)] = total // max(known, 1)
    return req


@register_operator("Reshape", "cpu")
class ReshapeCPU(Operator):
    def run_sample(self, ctx, idx, x, *shape_in):
        if shape_in:
            shape = [int(v) for v in np.asarray(shape_in[0]).reshape(-1)]
        else:
            shape = ctx.arg(self, "shape", idx, None)
            if shape is not None:
                shape = [float(v) for v in np.asarray(shape).reshape(-1)]
            if shape is None:
                rel = self.spec.GetArgument("rel_shape", None)
                if rel is None:
                    return x  # layout-only change
                shape = [x.shape[i] * rel[i] for i in range(len(rel))]
        return x.reshape(_resolve_shape(x.shape, shape))

    def output_layout(self, output_idx, inputs):
        layout = self.spec.GetArgument("layout", None)
        return layout if layout is not None else ""


DALI_SCHEMA("Transpose").DocStr("Permutes the sample dims.").NumInput(1).NumOutput(1).Devices(
    "cpu", "gpu").AddArg(
    "perm", ArgType.INT_VEC, "Dimension permutation."
).AddOptionalArg(
    "transpose_layout", ArgType.BOOL, "Also permute the layout string.", True
).AddOptionalArg(
    "output_layout", ArgType.STRING, "Explicit output layout (overrides transpose_layout).", None)


def _transpose_layout(spec, in_layout: str) -> str:
    explicit = spec.GetArgument("output_layout", None)
    if explicit:
        return explicit
    if in_layout and spec.GetArgument("transpose_layout", True):
        return "".join(in_layout[p] for p in spec.GetArgument("perm"))
    return in_layout


@register_operator("Transpose", "gpu")
class TransposeGPU(Operator):
    def host_output_layouts(self, in_layouts):
        return [_transpose_layout(self.spec, in_layouts[0] if in_layouts else "")]

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        sh = input_shapes[0] if input_shapes else None
        return None if sh is None else [np.asarray(sh)[:, list(self.spec.GetArgument("perm"))]]

    def lower(self, dctx, inp: DeviceBatch):
        perm = list(self.spec.GetArgument("perm"))
        x = inp.data.permute(0, *(p + 1 for p in perm)).contiguous()
        shapes = inp.shapes[:, perm] if inp.shapes is not None else None
        return [DeviceBatch(x, shapes, _transpose_layout(self.spec, inp.layout))]


DALI_SCHEMA("Pad").DocStr(
    "Pads samples to equal (or aligned) extents with `fill_value`."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "fill_value", ArgType.FLOAT, "Padding value.", 0.0
).AddOptionalArg(
    "axes", ArgType.INT_VEC, "Axes to pad (default: all).", None
).AddOptionalArg(
    "axis_names", ArgType.TENSOR_LAYOUT, "Axes to pad by layout letter (instead of `axes`).", None
).AddOptionalArg(
    "align", ArgType.INT_VEC, "Alignment per axis.", None
).AddOptionalArg("shape", ArgType.INT_VEC, "Minimum output shape.", None)


@register_operator("Pad", "gpu")
class PadGPU(Operator):
    """The canvas already holds each sample padded, with zeros: the region
    between each extent and the pad target is rewritten with ``fill_value``,
    the canvas grows where ``shape``/``align`` ask for more and is cut to the
    target in the padded axes. Output extents are the target in padded axes,
    the input's elsewhere. The target is a host static, from the host shapes
    and the input layout (``axis_names``)."""

    def _targets(self, shapes, layout=""):
        names = self.spec.GetArgument("axis_names", None)
        ndim = shapes.shape[1]
        if names:
            if not layout:
                raise ValueError("Pad(gpu): axis_names requires an input with a known layout; "
                                 "pass `axes` instead")
            axes = [layout.index(ch) for ch in names]
        else:
            axes = self.spec.GetArgument("axes", None)
            axes = list(range(ndim)) if not axes else [a % ndim for a in axes]
        align = self.spec.GetArgument("align", None)
        req_shape = self.spec.GetArgument("shape", None)
        target = shapes.max(axis=0).astype(np.int64)
        if req_shape:
            # entries follow the order of `axes`; -1 or 0 keeps the extent
            for k, a in enumerate(axes):
                if k < len(req_shape) and req_shape[k] > 0:
                    target[a] = max(target[a], int(req_shape[k]))
        if align:
            for i, d in enumerate(axes):
                a = align[i] if i < len(align) else align[-1]
                target[d] = ((target[d] + a - 1) // a) * a
        return axes, target

    def _in_layout(self, ctx, input_batches):
        b = input_batches[0] if input_batches else None
        layout = getattr(b, "layout", "") or ""
        if not layout:  # the static layout pass covers device-to-device edges
            lays = ctx.in_layouts(self)
            layout = lays[0] if lays else ""
        return layout

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        shapes = input_shapes[0]
        if shapes is None:
            return None
        shapes = np.asarray(shapes)
        axes, target = self._targets(shapes, self._in_layout(ctx, input_batches))
        out = shapes.copy()
        for d in axes:
            out[:, d] = target[d]
        return [out]

    def device_statics(self, ctx, input_shapes, input_batches):
        axes, target = self._targets(np.asarray(input_shapes[0]),
                                     self._in_layout(ctx, input_batches))
        return tuple(axes), tuple(int(t) for t in target)

    def lower(self, dctx, inp: DeviceBatch):
        axes, target = dctx.static(self)
        data = inp.data
        canvas = list(data.shape[1:])
        ndim = len(canvas)
        fill = float(self.spec.GetArgument("fill_value", 0.0))
        grow = [max(0, target[d] - canvas[d]) if d in axes else 0 for d in range(ndim)]
        if any(grow):
            # torch's pad takes (before, after) pairs from the last dim backwards
            pads = [x for g in reversed(grow) for x in (0, g)]
            data = torch.nn.functional.pad(data, pads, value=fill)
        out_shapes = None
        if inp.shapes is not None:
            n = data.shape[0]
            mask = None
            for d in axes:
                size = data.shape[1 + d]
                m = torch.arange(size, device=data.device)[None] >= inp.shapes[:, d, None]
                m = m.reshape((n,) + (1,) * d + (size,) + (1,) * (ndim - d - 1))
                mask = m if mask is None else (mask | m)
            if mask is not None:
                data = torch.where(mask, torch.tensor(fill, device=data.device).to(data.dtype),
                                   data)
            padded = torch.tensor([d in axes for d in range(ndim)], device=data.device)
            tgt = torch.tensor(target, dtype=inp.shapes.dtype, device=data.device)
            out_shapes = torch.where(padded[None], tgt[None], inp.shapes)
        # the canvas may extend past the target: cut the padded axes to it
        crop = tuple(slice(0, int(target[d])) if d in axes and int(target[d]) < data.shape[1 + d]
                     else slice(None) for d in range(ndim))
        if any(c != slice(None) for c in crop):
            data = data[(slice(None),) + crop]
        return [DeviceBatch(data, out_shapes, inp.layout)]
