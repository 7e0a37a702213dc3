"""Cast, CastLike, Shapes, Reshape, ExpandDims, Squeeze, Transpose, OneHot,
Pad and the subscript op behind ``DataNode.__getitem__`` (counterpart of
``dali_tpu/backend/generic.py``). Shapes on the device copies the shapes the
host setup pass propagated; nothing is read back."""

from __future__ import annotations

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch
from ..types import (DALIDataType, cast_host, from_numpy_type, is_bfloat16, to_numpy_type,
                     to_torch_type)
from .base import BF16_BITS, Operator

DALI_SCHEMA("Cast").DocStr("Casts to another dtype.").NumInput(1).NumOutput(1).Devices(
    "cpu", "gpu").AddArg("dtype", ArgType.DATA_TYPE, "Target dtype.")


@register_operator("Cast", "cpu")
class CastCPU(Operator):
    elementwise = True
    reads_bfloat16 = True

    def run_sample(self, ctx, idx, x):
        return cast_host(x, self.spec.GetArgument("dtype"))


@register_operator("Cast", "gpu")
class CastGPU(Operator):
    def lower(self, dctx, inp: DeviceBatch):
        return [inp.with_data(inp.data.to(to_torch_type(self.spec.GetArgument("dtype"))))]


DALI_SCHEMA("CastLike").DocStr("Casts input 0 to the dtype of input 1.").NumInput(2).NumOutput(
    1).Devices("cpu", "gpu")


@register_operator("CastLike", "cpu")
class CastLikeCPU(Operator):
    reads_bfloat16 = True

    def run_sample(self, ctx, idx, x, like):
        if is_bfloat16(x) or is_bfloat16(like):
            return cast_host(x, from_numpy_type(like.dtype))
        return x.astype(like.dtype)


@register_operator("CastLike", "gpu")
class CastLikeGPU(Operator):
    def lower(self, dctx, a: DeviceBatch, b: DeviceBatch):
        return [a.with_data(a.data.to(b.data.dtype))]


DALI_SCHEMA("Shapes").DocStr("Per-sample shapes.").NumInput(1).NumOutput(1).Devices(
    "cpu", "gpu").AddOptionalArg("dtype", ArgType.DATA_TYPE, "Output dtype.", DALIDataType.INT64)


@register_operator("Shapes", "cpu")
class ShapesCPU(Operator):
    reads_bfloat16 = BF16_BITS

    def run_sample(self, ctx, idx, x):
        return cast_host(np.array(x.shape), self.spec.GetArgument("dtype"))

    def output_layout(self, output_idx, inputs):
        return ""


@register_operator("Shapes", "gpu")
class ShapesGPU(Operator):
    """The input's host-propagated shapes, copied to the device with the
    batch's parameters. Without them (an input whose producer propagates
    none) the device batch's own extents, or its canvas, are used."""

    def host_output_layouts(self, in_layouts):
        return [""]

    def host_params(self, ctx, input_shapes):
        sh = input_shapes[0] if input_shapes else None
        return {} if sh is None else {"shapes": np.asarray(sh, np.int64)}

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        sh = input_shapes[0] if input_shapes else None
        return None if sh is None else [np.full((len(sh), 1), np.asarray(sh).shape[1], np.int32)]

    def lower(self, dctx, inp: DeviceBatch):
        if dctx.has_param(self, "shapes"):
            shp = dctx.param(self, "shapes")
        elif inp.shapes is not None:
            shp = inp.shapes
        else:
            shp = torch.tensor(inp.data.shape[1:], device=inp.data.device).expand(
                inp.data.shape[0], -1)
        return [DeviceBatch(shp.to(to_torch_type(self.spec.GetArgument("dtype"))), None, "")]


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
    reads_bfloat16 = BF16_BITS

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


@register_operator("Reshape", "gpu")
class ReshapeGPU(Operator):
    """A constant ``shape`` reshapes a uniform batch and no ``shape`` changes
    only the layout. A per-sample ``shape`` (a cpu tensor argument) gathers
    each sample's elements, in row-major order through its input extents,
    onto a grow-only output canvas."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._canvas_latch = None

    def host_output_layouts(self, in_layouts):
        layout = self.spec.GetArgument("layout", None)
        if layout is not None:
            return [layout]
        if (self.spec.GetArgument("shape", None) is None and "shape" not in self.spec.arg_inputs
                and len(in_layouts) < 2):
            return [in_layouts[0] if in_layouts else ""]
        return [""]

    def _per_sample_shapes(self, ctx, input_shapes):
        if "shape" not in self.spec.arg_inputs:
            return None
        b = ctx._arg_batches.get(self.op_id, {}).get("shape")
        if b is None:
            return None
        ish = input_shapes[0] if input_shapes else None
        out = []
        for i, s in enumerate(b.samples):
            v = [float(x) for x in np.asarray(s).reshape(-1)]
            if ish is not None:
                out.append(_resolve_shape([int(x) for x in np.asarray(ish)[i]], v))
            elif -1 in [int(round(x)) for x in v]:
                raise ValueError("Reshape(gpu): -1 in a per-sample shape needs host-known "
                                 "input shapes")
            else:
                out.append([int(round(x)) for x in v])
        if any(len(o) != len(out[0]) for o in out):
            raise ValueError("Reshape(gpu): per-sample shapes must share a rank")
        return np.asarray(out, np.int64)

    def host_params(self, ctx, input_shapes):
        ps = self._per_sample_shapes(ctx, input_shapes)
        self._ps = ps
        if ps is None:
            return {}
        mx = ps.max(axis=0)
        self._canvas_latch = mx if self._canvas_latch is None else np.maximum(
            self._canvas_latch, mx)
        return {"reshape_shapes": ps.astype(np.int32)}

    def device_statics(self, ctx, input_shapes, input_batches):
        if self._ps is None:
            return None
        return ("ps",) + tuple(int(v) for v in self._canvas_latch)

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        if self._ps is not None:
            return [self._ps]
        sh = input_shapes[0] if input_shapes else None
        if sh is None:
            return None
        shape = self.spec.GetArgument("shape", None)
        if shape is None:  # a layout-only change keeps the extents
            return [np.asarray(sh)]
        if "shape" in self.spec.arg_inputs or len(input_shapes) > 1:
            return None
        return [np.asarray([_resolve_shape(list(row), shape) for row in np.asarray(sh)],
                           np.int32)]

    def _lower_per_sample(self, dctx, inp, oc):
        n, ic = inp.data.shape[0], list(inp.data.shape[1:])
        dev = inp.data.device
        out_ext = dctx.param(self, "reshape_shapes").to(torch.int64)  # [n, k]
        in_ext = (inp.shapes.to(torch.int64)[:, :len(ic)] if inp.shapes is not None
                  else torch.tensor([ic], dtype=torch.int64, device=dev).expand(n, -1))
        m = int(np.prod(oc))
        coords = torch.from_numpy(np.stack(np.unravel_index(np.arange(m), oc)).astype(
            np.int64)).to(dev)  # [k, m]
        ic_strides = [int(np.prod(ic[d + 1:])) for d in range(len(ic))]
        # j: each element's row-major index within its sample's output shape
        j = torch.zeros((n, m), dtype=torch.int64, device=dev)
        for d in range(len(oc)):
            j += coords[d][None] * torch.prod(out_ext[:, d + 1:], dim=1)[:, None]
        # unravel j through the sample's input extents onto the canvas
        idx = torch.zeros_like(j)
        for d in range(len(ic)):
            p = torch.prod(in_ext[:, d + 1:], dim=1)[:, None]
            q = j // p
            j = j - q * p
            idx += torch.minimum(q.clamp(min=0), in_ext[:, d:d + 1] - 1) * ic_strides[d]
        out = inp.data.reshape(n, -1).gather(1, idx).reshape(n, *oc)
        return [DeviceBatch(out, out_ext.to(torch.int32), self.spec.GetArgument("layout", None)
                            or "")]

    def lower(self, dctx, inp: DeviceBatch, *shape_in):
        st = dctx.static(self)
        if isinstance(st, tuple) and st and st[0] == "ps":
            return self._lower_per_sample(dctx, inp, tuple(st[1:]))
        if shape_in:
            raise NotImplementedError("Reshape(gpu): pass per-sample target shapes via the "
                                      "`shape` tensor argument (a positional shape input is "
                                      "cpu-only)")
        if inp.shapes is not None:
            raise NotImplementedError("Reshape(gpu) on ragged batches needs per-sample target "
                                      "shapes (pass `shape` as a tensor argument)")
        shape = self.spec.GetArgument("shape", None)
        layout = self.spec.GetArgument("layout", None)
        if shape is None:
            return [DeviceBatch(inp.data, None, layout if layout is not None else inp.layout)]
        n = inp.data.shape[0]
        new_shape = _resolve_shape(list(inp.data.shape[1:]), shape)
        return [DeviceBatch(inp.data.reshape(n, *new_shape), None, layout or "")]


DALI_SCHEMA("ExpandDims").DocStr("Inserts size-1 dims.").NumInput(1).NumOutput(1).Devices(
    "cpu", "gpu").AddArg("axes", ArgType.INT_VEC, "Positions of new dims.").AddOptionalArg(
    "new_axis_names", ArgType.TENSOR_LAYOUT, "Layout names for new dims.", None)


def _expand_layout(layout, axes, names):
    """``new_axis_names`` inserted at the new axes, each name following its
    axis when the axes are sorted."""
    if not layout:
        return ""
    names = names or ""
    if names and len(names) != len(axes):
        raise ValueError("ExpandDims: new_axis_names must have one name per entry of `axes` "
                         f"(got {len(names)} names for {len(axes)} axes)")
    out = list(layout)
    for ax, ch in sorted(zip(axes, names or "?" * len(axes))):
        out.insert(ax, ch)
    return "".join(out) if "?" not in out else ""


@register_operator("ExpandDims", "cpu")
class ExpandDimsCPU(Operator):
    def run_sample(self, ctx, idx, x):
        for ax in sorted(self.spec.GetArgument("axes")):
            x = np.expand_dims(x, ax)
        return x

    def output_layout(self, j, inputs):
        return _expand_layout(inputs[0].layout if inputs else "", self.spec.GetArgument("axes"),
                              self.spec.GetArgument("new_axis_names", None))


@register_operator("ExpandDims", "gpu")
class ExpandDimsGPU(Operator):
    def host_output_layouts(self, in_layouts):
        return [_expand_layout(in_layouts[0] if in_layouts else "", self.spec.GetArgument("axes"),
                               self.spec.GetArgument("new_axis_names", None))]

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        sh = input_shapes[0] if input_shapes else None
        if sh is None:
            return None
        sh = np.asarray(sh)
        for ax in sorted(self.spec.GetArgument("axes")):
            sh = np.insert(sh, ax, 1, axis=1)
        return [sh]

    def lower(self, dctx, inp: DeviceBatch):
        x, shapes = inp.data, inp.shapes
        for ax in sorted(self.spec.GetArgument("axes")):
            x = x.unsqueeze(ax + 1)
            if shapes is not None:  # ragged extents gain a column of ones
                shapes = torch.cat([shapes[:, :ax], torch.ones_like(shapes[:, :1]),
                                    shapes[:, ax:]], dim=1)
        return [DeviceBatch(x, shapes, _expand_layout(
            inp.layout, self.spec.GetArgument("axes"),
            self.spec.GetArgument("new_axis_names", None)))]


DALI_SCHEMA("Squeeze").DocStr("Removes size-1 dims.").NumInput(1).NumOutput(1).Devices(
    "cpu", "gpu").AddOptionalArg("axes", ArgType.INT_VEC, "Dims to remove.", None).AddOptionalArg(
    "axis_names", ArgType.TENSOR_LAYOUT, "Layout names of dims to remove.", None)


def _squeeze_axes(spec, layout, ndim):
    names = spec.GetArgument("axis_names", None)
    if names:
        if not layout:
            raise ValueError("Squeeze: axis_names requires a layout on the input")
        return [layout.index(ch) for ch in names]
    axes = spec.GetArgument("axes", None)
    return [a % ndim for a in axes] if axes else None


def _squeeze_layout(spec, layout):
    if not layout:
        return ""
    axes = _squeeze_axes(spec, layout, len(layout))
    if axes is None:
        return ""  # squeeze-all: the removed dims depend on the sample shapes
    return "".join(ch for i, ch in enumerate(layout) if i not in set(axes))


@register_operator("Squeeze", "cpu")
class SqueezeCPU(Operator):
    reads_bfloat16 = BF16_BITS

    def run_batch(self, ctx, inp):
        self._in_layout = inp.layout or ""
        return super().run_batch(ctx, inp)

    def run_sample(self, ctx, idx, x):
        axes = _squeeze_axes(self.spec, self._in_layout, x.ndim)
        return np.squeeze(x, axis=tuple(axes) if axes else None)

    def output_layout(self, j, inputs):
        return _squeeze_layout(self.spec, inputs[0].layout if inputs else "")


@register_operator("Squeeze", "gpu")
class SqueezeGPU(Operator):
    def host_output_layouts(self, in_layouts):
        return [_squeeze_layout(self.spec, in_layouts[0] if in_layouts else "")]

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        sh = input_shapes[0] if input_shapes else None
        if sh is None:
            return None
        sh = np.asarray(sh)
        lays = ctx.in_layouts(self)
        axes = _squeeze_axes(self.spec, lays[0] if lays else "", sh.shape[1])
        if axes is None:
            return None
        return [sh[:, [d for d in range(sh.shape[1]) if d not in set(axes)]]]

    def lower(self, dctx, inp: DeviceBatch):
        ndim = inp.data.dim() - 1
        axes = _squeeze_axes(self.spec, inp.layout, ndim)
        if axes is None:
            axes = [i for i, s in enumerate(inp.data.shape[1:]) if s == 1]
        keep = [d for d in range(ndim) if d not in set(axes)]
        x = inp.data.reshape(inp.data.shape[0], *(inp.data.shape[1 + d] for d in keep))
        shapes = inp.shapes[:, keep] if inp.shapes is not None else None
        layout = "".join(inp.layout[d] for d in keep) if inp.layout else ""
        return [DeviceBatch(x, shapes, layout)]


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


DALI_SCHEMA("OneHot").DocStr("One-hot encoding.").NumInput(1).NumOutput(1).Devices(
    "cpu", "gpu").AddOptionalArg(
    "num_classes", ArgType.INT, "Number of classes.", 0
).AddOptionalArg(
    "dtype", ArgType.DATA_TYPE, "Output dtype.", DALIDataType.FLOAT
).AddOptionalArg(
    "on_value", ArgType.FLOAT, "Value for the hot position.", 1.0
).AddOptionalArg(
    "off_value", ArgType.FLOAT, "Value elsewhere.", 0.0
).AddOptionalArg(
    "axis", ArgType.INT, "Axis for the new dim.", -1
).AddOptionalArg(
    "axis_name", ArgType.STRING,
    "Single-character layout name of the new axis, inserted into the input's layout.", None)


def _one_hot_layout(spec, in_layout) -> str:
    name = spec.GetArgument("axis_name", None)
    if not name:
        return ""
    if len(name) != 1:
        raise ValueError("OneHot axis_name must be a single character")
    if in_layout:
        axis = spec.GetArgument("axis", -1)
        pos = len(in_layout) if axis < 0 else axis
        return in_layout[:pos] + name + in_layout[pos:]
    return name


@register_operator("OneHot", "cpu")
class OneHotCPU(Operator):
    def output_layout(self, output_idx, inputs):
        return _one_hot_layout(self.spec, inputs[0].layout if inputs else "")

    def run_sample(self, ctx, idx, x):
        nc = self.spec.GetArgument("num_classes")
        on = self.spec.GetArgument("on_value")
        off = self.spec.GetArgument("off_value")
        want = self.spec.GetArgument("dtype")
        dt = to_numpy_type(want)
        if dt is torch.bfloat16:  # built in float32, then rounded
            dt = np.dtype(np.float32)
        if x.size == 1:
            out = np.full((nc,), off, dtype=dt)
            out[int(np.asarray(x).reshape(-1)[0])] = on
            return cast_host(out, want)
        out = np.full((*x.shape, nc), off, dtype=dt)
        np.put_along_axis(out, x[..., None].astype(np.int64), on, axis=-1)
        return cast_host(out, want)


@register_operator("OneHot", "gpu")
class OneHotGPU(Operator):
    """A class index outside [0, num_classes) gives a row of ``off_value``,
    as the reference's device program does."""

    def host_output_layouts(self, in_layouts):
        return [_one_hot_layout(self.spec, in_layouts[0] if in_layouts else "")]

    def lower(self, dctx, inp: DeviceBatch):
        nc = self.spec.GetArgument("num_classes")
        on = self.spec.GetArgument("on_value")
        off = self.spec.GetArgument("off_value")
        x = inp.data
        if x.dim() == 2 and x.shape[1] == 1:
            x = x[:, 0]
        classes = torch.arange(nc, device=x.device, dtype=torch.int32)
        oh = (x.to(torch.int32)[..., None] == classes).to(torch.float32)
        out = (oh * (on - off) + off).to(to_torch_type(self.spec.GetArgument("dtype")))
        return [DeviceBatch(out, None, _one_hot_layout(self.spec, inp.layout))]


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


def _subscript_schema():
    s = DALI_SCHEMA("_TensorSubscript").DocStr(
        "Per-sample indexing and slicing (``DataNode.__getitem__``)."
    ).NumInput(1, 8).NumOutput(1).Devices("cpu", "gpu").MakeInternal().AddOptionalArg(
        "num_subscripts", ArgType.INT, "Number of subscripted dims.", 1)
    for d in range(8):
        s.AddOptionalArg(f"at_{d}", ArgType.INT, "", None, tensor_ok=True)
        s.AddOptionalArg(f"lo_{d}", ArgType.INT, "", None, tensor_ok=True)
        s.AddOptionalArg(f"hi_{d}", ArgType.INT, "", None, tensor_ok=True)


_subscript_schema()


@register_operator("_TensorSubscript", "cpu")
class TensorSubscriptCPU(Operator):
    def run_sample(self, ctx, idx, x, *extra):
        slices = []
        for d in range(self.spec.GetArgument("num_subscripts")):
            at = ctx.arg(self, f"at_{d}", idx, None)
            if at is not None:
                slices.append(int(np.asarray(at)))
                continue
            lo = ctx.arg(self, f"lo_{d}", idx, None)
            hi = ctx.arg(self, f"hi_{d}", idx, None)
            slices.append(slice(None if lo is None else int(np.asarray(lo)),
                                None if hi is None else int(np.asarray(hi))))
        return np.ascontiguousarray(x[tuple(slices)])
