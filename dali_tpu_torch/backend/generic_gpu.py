"""Slice, the subscript op, Erase, Paste, the Zeros/Ones/Full value ops,
BbFlip, BoxEncoder and CoordFlip on the device (counterpart of
``dali_tpu/backend/generic_gpu.py``, and of
``dali_tpu/backend/straggler_gpu.py`` ``CoordFlipGPU``; the schemas of Slice,
Erase and the value ops are ``generic2.py``'s).

Ops with ragged outputs (Slice, the subscript, Paste) follow the reference's
grow-only canvas: the host setup pass computes each sample's window and
output extents, the output canvas only grows (rounded up), and the extents
ride along as the batch's shapes.

The box operators run as plain batched PyTorch over the padded ``[N, M, 4]``
box canvas, with each sample's box count from ``DeviceBatch.shapes``: the
reference computes them in XLA with no Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch
from ..types import to_torch_type
from .base import Operator
from .generic2 import _slice_axes


def _round_up(v, align=8):
    return int(-(-int(v) // align) * align)


def _gather_axis(x, axis, idx):
    """``x`` [N, ...] indexed along ``axis`` (>= 1) by the per-sample
    indices ``idx`` [N, size]."""
    size = idx.shape[1]
    idx = idx.reshape((idx.shape[0],) + (1,) * (axis - 1) + (size,) + (1,) * (x.dim() - axis - 1))
    return torch.gather(x, axis, idx.expand(*x.shape[:axis], size, *x.shape[axis + 1:]))


class _GrowCanvasOp(Operator):
    """The grow-only output canvas of a device op with ragged outputs."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._grow = {}

    def _grow_to(self, dim, value, align=8):
        self._grow[dim] = max(self._grow.get(dim, 0), _round_up(value, align))
        return self._grow[dim]


@register_operator("Slice", "gpu")
class SliceGPU(_GrowCanvasOp):
    """Each sample's (anchor, shape) is resolved on the host from the
    arguments; the device gathers the window with indices clamped to the
    canvas and, under the "pad" policy, fills what lies outside the sample.
    A batch whose windows all fill the output canvas comes out uniform."""

    def _resolve_windows(self, ctx, shapes):
        spec = self.spec
        n, ndim = shapes.shape
        lays = ctx.in_layouts(self)
        axes = _slice_axes(spec, lays[0] if lays else "", ndim)
        dims = shapes[:, axes].astype(np.float64)

        def geta(name):
            vals = []
            for i in range(n):
                v = ctx.arg(self, name, i, None)
                if v is None:
                    return None
                vals.append(np.asarray(v, np.float64).reshape(-1))
            return np.stack(vals, 0)

        anchor = geta("start")
        if anchor is None:
            ra = geta("rel_start")
            anchor = ra * dims if ra is not None else np.zeros((n, len(axes)))
        shape = geta("shape")
        if shape is None:
            rs = geta("rel_shape")
            shape = rs * dims if rs is not None else None
        if shape is None:
            end = geta("end")
            if end is None:
                re = geta("rel_end")
                end = re * dims if re is not None else None
            shape = (end - anchor) if end is not None else dims - anchor
        anchor = np.round(anchor).astype(np.int64)
        shape = np.maximum(np.round(shape).astype(np.int64), 0)
        policy = spec.GetArgument("out_of_bounds_policy")
        if policy == "error" and ((anchor < 0).any() or (anchor + shape > dims).any()):
            raise ValueError("Slice(gpu): window out of bounds (policy 'error')")
        if policy == "trim_to_shape":
            hi = np.minimum(anchor + shape, dims.astype(np.int64))
            anchor = np.maximum(anchor, 0)
            shape = np.maximum(hi - anchor, 0)
        return axes, anchor.astype(np.int32), shape.astype(np.int32)

    def host_params(self, ctx, input_shapes):
        shapes = input_shapes[0]
        if shapes is None:
            raise RuntimeError("Slice(gpu) requires host-known input shapes")
        if len(input_shapes) > 1:
            raise NotImplementedError("Slice(gpu): pass anchor/shape as arguments "
                                      "(start=/shape=/rel_*), not positional inputs")
        axes, anchor, shp = self._resolve_windows(ctx, np.asarray(shapes))
        out = np.asarray(shapes).astype(np.int32).copy()
        out[:, axes] = shp
        self._axes = axes
        sizes = tuple(self._grow_to(k, max(int(shp[:, k].max()), 1)) for k in range(len(axes)))
        self._statics = sizes + (bool((shp == np.asarray(sizes)).all()),)
        self._out = out
        return {"slice_anchor": anchor, "slice_out": out}

    def device_statics(self, ctx, input_shapes, input_batches):
        return self._statics

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        return [self._out]

    def lower(self, dctx, inp: DeviceBatch):
        anchor = dctx.param(self, "slice_anchor").to(torch.int64)
        out_ext = dctx.param(self, "slice_out")
        *sizes, exact = dctx.static(self)
        data = inp.data
        n, canvas = data.shape[0], list(data.shape[1:])
        in_ext = inp.shapes if inp.shapes is not None else torch.tensor(
            [canvas], dtype=torch.int32, device=data.device).expand(n, -1)
        pad = self.spec.GetArgument("out_of_bounds_policy") == "pad"
        out, valid = data, None
        for k, a in enumerate(self._axes):
            # the output canvas may exceed the input's ("pad" windows larger
            # than the sample): indices clamp, the mask below fills
            coord = anchor[:, k:k + 1] + torch.arange(sizes[k], device=data.device)
            out = _gather_axis(out, 1 + a, coord.clamp(0, canvas[a] - 1))
            if pad:
                v = ((coord >= 0) & (coord < in_ext[:, a:a + 1])
                     & (torch.arange(sizes[k], device=data.device) < out_ext[:, a:a + 1]))
                v = v.reshape((n,) + (1,) * a + (sizes[k],) + (1,) * (len(canvas) - a - 1))
                valid = v if valid is None else valid & v
        if valid is not None:
            fill = float(self.spec.GetArgument("fill_values")[0])
            out = torch.where(valid, out, torch.tensor(fill, device=out.device).to(out.dtype))
        dt = self.spec.GetArgument("dtype", None)
        if dt is not None:
            out = out.to(to_torch_type(dt))
        uniform = exact and inp.shapes is None
        return [DeviceBatch(out, None if uniform else out_ext, inp.layout)]


@register_operator("_TensorSubscript", "gpu")
class TensorSubscriptGPU(_GrowCanvasOp):
    """Per-sample ``lo:hi`` windows on a grow-only canvas; an index takes a
    window of one and drops the dim. Negative bounds count from each
    sample's end."""

    def _windows(self, ctx, shapes):
        nd = self.spec.GetArgument("num_subscripts")
        n = shapes.shape[0]
        lo = np.zeros((n, nd), np.int64)
        ln = np.zeros((n, nd), np.int64)
        drop = [d for d in range(nd) if ctx.arg(self, f"at_{d}", 0, None) is not None]
        for d in range(nd):
            for i in range(n):
                dim = int(shapes[i, d])
                at = ctx.arg(self, f"at_{d}", i, None)
                if at is not None:
                    lo[i, d], ln[i, d] = (int(np.asarray(at)) % dim if dim else 0), 1
                    continue
                lo_v = ctx.arg(self, f"lo_{d}", i, None)
                hi_v = ctx.arg(self, f"hi_{d}", i, None)
                l = 0 if lo_v is None else int(np.asarray(lo_v))
                l = l % (dim or 1) if l < 0 else l
                h = dim if hi_v is None else int(np.asarray(hi_v))
                h = h % (dim or 1) if h < 0 else min(h, dim)
                lo[i, d], ln[i, d] = l, max(h - l, 0)
        return lo, ln, drop

    def host_params(self, ctx, input_shapes):
        shapes = input_shapes[0]
        if shapes is None:
            raise RuntimeError("subscript(gpu) requires host-known input shapes")
        shapes = np.asarray(shapes)
        lo, ln, drop = self._windows(ctx, shapes)
        self._statics = (tuple(self._grow_to(d, max(int(ln[:, d].max()), 1))
                               for d in range(ln.shape[1])), tuple(drop))
        out = shapes.astype(np.int32).copy()
        out[:, :ln.shape[1]] = ln
        self._out = out[:, [d for d in range(shapes.shape[1]) if d not in drop]]
        return {"sub_lo": lo.astype(np.int32), "sub_out": self._out}

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        return [self._out]

    def device_statics(self, ctx, input_shapes, input_batches):
        return self._statics

    def lower(self, dctx, inp: DeviceBatch):
        lo = dctx.param(self, "sub_lo").to(torch.int64)
        out_ext = dctx.param(self, "sub_out")
        sizes, drop = dctx.static(self)
        out = inp.data
        canvas = list(out.shape[1:])
        for d, size in enumerate(sizes):
            size = 1 if d in drop else min(size, canvas[d])
            coord = (lo[:, d:d + 1] + torch.arange(size, device=out.device)).clamp(
                0, canvas[d] - 1)
            out = _gather_axis(out, 1 + d, coord)
        if drop:
            keep = [d for d in range(len(canvas)) if d not in drop]
            out = out.reshape(out.shape[0], *(out.shape[1 + d] for d in keep))
        return [DeviceBatch(out, out_ext if out_ext.shape[1] else None, "")]

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


def _per_sample_flag(dctx, op, name, default, n, device):
    """A flag argument as a bool [N] device vector (tensor argument or
    broadcast constant)."""
    v = dctx.arg(op, name, default)
    if dctx.has_tensor_arg(op, name):
        return v.to(device).reshape(n, -1)[:, 0] != 0
    return torch.full((n,), float(np.asarray(v).reshape(-1)[0]) != 0, device=device)


def _box_counts(b: DeviceBatch, m: int) -> torch.Tensor:
    """Valid boxes of each sample of an [N, M, 4] (or flattened [N, M*4])
    box batch, as int64 [N]."""
    n = b.data.shape[0]
    if b.shapes is None:
        return torch.full((n,), m, dtype=torch.int64, device=b.data.device)
    counts = b.shapes[:, 0].to(torch.int64)
    return counts if b.data.dim() == 3 else counts // 4


# ======================================== BbFlip (gpu) ============================================


@register_operator("BbFlip", "gpu")
class BbFlipGPU(Operator):
    """Elementwise on the padded box batch; padded rows keep their values."""

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        return [input_shapes[0]]

    def lower(self, dctx, inp: DeviceBatch):
        n, dev = inp.data.shape[0], inp.data.device
        boxes = inp.data.reshape(n, -1, 4).to(torch.float32)
        h = _per_sample_flag(dctx, self, "horizontal", 1, n, dev)[:, None]
        v = _per_sample_flag(dctx, self, "vertical", 0, n, dev)[:, None]
        x0, y0, x1, y1 = boxes.unbind(-1)
        if self.spec.GetArgument("ltrb"):
            fx0, fx1, fy0, fy1 = 1.0 - x1, 1.0 - x0, 1.0 - y1, 1.0 - y0
        else:
            fx0, fx1, fy0, fy1 = 1.0 - x0 - x1, x1, 1.0 - y0 - y1, y1
        out = torch.stack([torch.where(h, fx0, x0), torch.where(v, fy0, y0),
                           torch.where(h, fx1, x1), torch.where(v, fy1, y1)], dim=-1)
        if inp.shapes is not None:
            rows = torch.arange(out.shape[1], device=dev)[None, :]
            valid = rows < _box_counts(inp, out.shape[1])[:, None]
            out = torch.where(valid[..., None], out, boxes)
        return [inp.with_data(out.reshape(inp.data.shape))]


# ======================================== BoxEncoder (gpu) ========================================

# bytes of one [chunk, M, A] float32 intermediate of the IoU; about four are
# alive at once, so a chunk of the batch peaks near 1 GiB
IOU_CHUNK_BYTES = 1 << 28


def _xywh(t):
    return torch.stack([(t[..., 0] + t[..., 2]) / 2, (t[..., 1] + t[..., 3]) / 2,
                        t[..., 2] - t[..., 0], t[..., 3] - t[..., 1]], dim=-1)


def match_boxes(boxes, counts, anchors, criteria):
    """SSD matching of a padded box batch: boxes [n, M, 4] ltrb, counts
    [n], anchors [A, 4] -> (index of each anchor's box [n, A] int64,
    matched [n, A] bool). Padded rows are masked out of the argmax, and each
    valid box claims its best anchor (where two claim one anchor, the later
    box wins, as numpy's assignment of ``encode_boxes`` gives it). Float32
    in the reference's operation order, so an IoU equals its value there."""
    n, m = boxes.shape[:2]
    a = anchors.shape[0]
    valid = torch.arange(m, device=boxes.device)[None, :] < counts[:, None]
    b = boxes[..., None, :]  # [n, M, 1, 4]
    iw = torch.minimum(b[..., 2], anchors[:, 2]).sub_(torch.maximum(b[..., 0], anchors[:, 0]))
    iw.clamp_(min=0)
    ih = torch.minimum(b[..., 3], anchors[:, 3]).sub_(torch.maximum(b[..., 1], anchors[:, 1]))
    inter = iw.mul_(ih.clamp_(min=0))
    del ih
    area_b = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    area_a = (anchors[:, 2] - anchors[:, 0]) * (anchors[:, 3] - anchors[:, 1])
    union = (area_b[..., None] + area_a).sub_(inter).clamp_(min=1e-9)
    iou = inter.div_(union)
    del union
    iou.masked_fill_(~valid[..., None], -1.0)  # [n, M, A]
    best_iou, best_box = iou.max(dim=1)
    best_anchor = iou.argmax(dim=2)  # [n, M]
    del iou
    claim = torch.full((n, a + 1), -1, dtype=torch.int64, device=boxes.device)
    idx = torch.where(valid, best_anchor, a)  # padded rows claim the spare column
    claim.scatter_reduce_(1, idx, torch.arange(m, device=boxes.device).expand(n, m), "amax")
    forced = claim[:, :a] >= 0
    best_box = torch.where(forced, claim[:, :a], best_box)
    best_iou = torch.where(forced, torch.full_like(best_iou, 2.0), best_iou)
    return best_box, best_iou >= criteria


@register_operator("BoxEncoder", "gpu")
class BoxEncoderGPU(Operator):
    """Outputs dense [N, A, 4] float32 boxes and [N, A] int32 labels. The
    [N, M, A] IoU intermediate is computed over chunks of the batch of at
    most ``IOU_CHUNK_BYTES`` each."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._anchors_np = np.asarray(spec.GetArgument("anchors"), np.float32).reshape(-1, 4)
        self._anchors = None

    def host_output_layouts(self, in_layouts):
        return ["", ""]

    def lower(self, dctx, boxes_b: DeviceBatch, labels_b: DeviceBatch):
        spec = self.spec
        n, dev = boxes_b.data.shape[0], boxes_b.data.device
        if self._anchors is None or self._anchors.device != dev:
            self._anchors = torch.from_numpy(self._anchors_np).to(dev)
        anchors = self._anchors
        a = anchors.shape[0]
        boxes = boxes_b.data.reshape(n, -1, 4).to(torch.float32)
        m = boxes.shape[1]
        counts = _box_counts(boxes_b, m)
        labels = labels_b.data.reshape(n, -1).to(torch.int32)
        # the label canvas may be narrower or wider than the box canvas
        labels = torch.nn.functional.pad(labels, (0, max(0, m - labels.shape[1])))[:, :m]
        if m:
            criteria = float(spec.GetArgument("criteria"))
            chunk = max(1, IOU_CHUNK_BYTES // (m * a * 4))
            parts = [match_boxes(boxes[s:s + chunk], counts[s:s + chunk], anchors, criteria)
                     for s in range(0, n, chunk)]
            best_box = torch.cat([p[0] for p in parts])
            matched = torch.cat([p[1] for p in parts])
            gathered = torch.gather(boxes, 1, best_box[..., None].expand(n, a, 4))
            out_b = torch.where(matched[..., None], gathered, anchors)
            out_l = torch.where(matched, torch.gather(labels, 1, best_box), 0).to(torch.int32)
        else:  # no sample has a box
            out_b = anchors.expand(n, a, 4)
            out_l = torch.zeros((n, a), dtype=torch.int32, device=dev)
        scale = float(spec.GetArgument("scale"))
        if spec.GetArgument("offset"):
            g = _xywh(out_b * scale)
            aa = _xywh(anchors * scale)
            enc = torch.stack([(g[..., 0] - aa[:, 0]) / aa[:, 2],
                               (g[..., 1] - aa[:, 1]) / aa[:, 3],
                               torch.log(g[..., 2].clamp(min=1e-9) / aa[:, 2]),
                               torch.log(g[..., 3].clamp(min=1e-9) / aa[:, 3])], dim=-1)
            means = torch.tensor(spec.GetArgument("means"), dtype=torch.float32, device=dev)
            stds = torch.tensor(spec.GetArgument("stds"), dtype=torch.float32, device=dev)
            out_b = (enc - means) / stds
        else:
            out_b = out_b * scale
        return [DeviceBatch(out_b, None, ""), DeviceBatch(out_l, None, "")]


# ======================================== CoordFlip (gpu) =========================================


@register_operator("CoordFlip", "gpu")
class CoordFlipGPU(Operator):
    def host_output_shapes(self, ctx, input_shapes, input_batches):
        return [input_shapes[0]]

    def lower(self, dctx, inp: DeviceBatch):
        spec = self.spec
        layout = spec.GetArgument("layout")
        out = inp.data.to(torch.float32, copy=True)
        n, dev = out.shape[0], out.device
        for axis, default in (("x", 1), ("y", 0), ("z", 0)):
            i = layout.find(axis)
            if i < 0:
                continue
            flag = _per_sample_flag(dctx, self, f"flip_{axis}", default, n, dev)
            flag = flag.reshape((n,) + (1,) * (out.dim() - 2))
            c = float(spec.GetArgument(f"center_{axis}"))
            out[..., i] = torch.where(flag, 2.0 * c - out[..., i], out[..., i])
        return [inp.with_data(out)]


DALI_SCHEMA("Paste").DocStr("Pastes the image into a larger filled canvas.").NumInput(
    1).NumOutput(1).Devices("cpu", "gpu").AddArg(
    "ratio", ArgType.FLOAT, "Canvas enlargement ratio (>= 1).", tensor_ok=True
).AddOptionalArg(
    "paste_x", ArgType.FLOAT, "Horizontal position [0,1].", 0.5, tensor_ok=True
).AddOptionalArg(
    "paste_y", ArgType.FLOAT, "Vertical position [0,1].", 0.5, tensor_ok=True
).AddOptionalArg(
    "fill_value", ArgType.FLOAT_VEC, "Canvas fill (per channel).", [0.0]
).AddOptionalArg(
    "min_canvas_size", ArgType.FLOAT, "Minimum canvas extent.", 0.0
).AddOptionalArg(
    "n_channels", ArgType.INT,
    "Number of output channels; the fill_value list must match. Defaults to the input's "
    "channel count.", None)


@register_operator("Paste", "gpu")
class PasteGPU(_GrowCanvasOp):
    """Each HWC sample at its (paste_y, paste_x) position in a canvas of
    ``ratio`` times its size, filled elsewhere; the canvas grows in steps
    of 32."""

    def host_params(self, ctx, input_shapes):
        shapes = input_shapes[0]
        if shapes is None:
            raise RuntimeError("Paste(gpu) requires host-known input shapes")
        shapes = np.asarray(shapes)
        n = shapes.shape[0]
        mins = int(self.spec.GetArgument("min_canvas_size"))
        out = np.zeros((n, 3), np.int32)
        pos = np.zeros((n, 2), np.int32)
        for i in range(n):
            r = float(np.asarray(ctx.arg(self, "ratio", i, 1.0)))
            px = float(np.asarray(ctx.arg(self, "paste_x", i, 0.5)))
            py = float(np.asarray(ctx.arg(self, "paste_y", i, 0.5)))
            h, w = int(shapes[i, 0]), int(shapes[i, 1])
            ch = max(int(round(h * r)), mins, h)
            cw = max(int(round(w * r)), mins, w)
            out[i] = (ch, cw, shapes[i, 2] if shapes.shape[1] > 2 else 0)
            pos[i] = (int(round(py * (ch - h))), int(round(px * (cw - w))))
        self._statics = (self._grow_to(0, out[:, 0].max(), 32),
                         self._grow_to(1, out[:, 1].max(), 32))
        self._out = out
        return {"paste_pos": pos, "paste_out": out}

    def device_statics(self, ctx, input_shapes, input_batches):
        return self._statics

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        out = self._out
        nc = self.spec.GetArgument("n_channels", None)
        if nc is not None and out.shape[0] and int(nc) > int(out[0, 2]):
            out = out.copy()
            out[:, 2] = int(nc)
        return [out]

    def lower(self, dctx, inp: DeviceBatch):
        pos = dctx.param(self, "paste_pos").to(torch.int64)
        out_ext = dctx.param(self, "paste_out")
        ch, cw = dctx.static(self)
        data = inp.data
        n, H, W, C = data.shape
        dev = data.device
        fv = torch.tensor(self.spec.GetArgument("fill_value"), dtype=torch.float32,
                          device=dev).to(data.dtype)
        ext = inp.shapes if inp.shapes is not None else torch.tensor(
            [[H, W, C]], dtype=torch.int32, device=dev).expand(n, -1)
        # out[y, x] = img[y - py, x - px] inside the pasted box, fill elsewhere
        rows = torch.arange(ch, device=dev)[None] - pos[:, :1]
        cols = torch.arange(cw, device=dev)[None] - pos[:, 1:]
        g = _gather_axis(_gather_axis(data, 1, rows.clamp(0, H - 1)), 2, cols.clamp(0, W - 1))
        inside = (((rows >= 0) & (rows < ext[:, :1]))[:, :, None, None]
                  & ((cols >= 0) & (cols < ext[:, 1:2]))[:, None, :, None])
        canvas = (fv.reshape(1, 1, 1, -1) if fv.numel() > 1 else fv.reshape(1, 1, 1, 1))
        out = torch.where(inside, g, canvas)
        nc = self.spec.GetArgument("n_channels", None)
        if nc is not None and int(nc) > C:
            extra = int(nc) - C
            fpad = fv.reshape(-1)[C:] if fv.numel() >= int(nc) else fv.reshape(-1)[-1:]
            out = torch.cat([out, fpad.expand(*out.shape[:-1], extra)], dim=-1)
            out_ext = torch.cat([out_ext[:, :2], torch.full_like(out_ext[:, 2:], int(nc))], 1)
        return [DeviceBatch(out, out_ext, inp.layout or "HWC")]


class _ValueOpGPU(Operator):
    """Zeros, Ones and Full (a constant ``shape``), and their *Like forms
    (the input's shape), made on the device. A fill value of k entries fills
    the last dim. The dtype is ``dtype``, else the input's (Like), the fill
    value's (Full) or int32."""

    fill = 0.0
    like = False

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        if self.like:
            return [input_shapes[0]]
        shp = self.spec.GetArgument("shape", None)
        if shp is None:
            return None
        return [np.tile(np.asarray(shp, np.int32).reshape(-1), (ctx.batch_size, 1))]

    def _fill_value(self, dctx, n, device):
        """[n] scalar fills, or [n, k] for a k-vector ``fill_value``."""
        if self.fill is not None:
            return torch.full((n,), self.fill, dtype=torch.float32, device=device)
        v = dctx.arg(self, "fill_value", 0.0)
        if dctx.has_tensor_arg(self, "fill_value"):
            # 32-bit, as the reference's device program holds them
            v = v.reshape(n, -1)
            narrow = {torch.float64: torch.float32, torch.int64: torch.int32}
            return v.to(narrow.get(v.dtype, v.dtype))
        arr = np.asarray(v, np.float32).reshape(-1)
        if arr.size > 1:
            return torch.from_numpy(arr).to(device)[None].expand(n, -1)
        return torch.full((n,), float(arr[0]), dtype=torch.float32, device=device)

    def lower(self, dctx, *inputs):
        dt_arg = self.spec.GetArgument("dtype", None)
        if self.like:
            inp = inputs[0]
            n, device = inp.data.shape[0], inp.data.device
            dt = to_torch_type(dt_arg) if dt_arg is not None else inp.data.dtype
            fv = self._fill_value(dctx, n, device)
            nd = inp.data.dim()
            fv = (fv.reshape((n,) + (1,) * (nd - 2) + (fv.shape[1],))
                  if fv.dim() == 2 and fv.shape[1] > 1 else fv.reshape((n,) + (1,) * (nd - 1)))
            return [DeviceBatch(fv.to(dt).expand(inp.data.shape).contiguous(), inp.shapes,
                                inp.layout)]
        if dctx.has_tensor_arg(self, "shape"):
            raise NotImplementedError(f"{type(self).__name__}: per-sample `shape` on gpu is not "
                                      "supported; generate on cpu and .gpu() the result")
        n, device = dctx.batch_size, self.pipeline.device
        shp = self.spec.GetArgument("shape", None)
        shape = tuple(int(v) for v in np.asarray(shp).reshape(-1)) if shp is not None else ()
        fv = self._fill_value(dctx, n, device)
        if dt_arg is not None:
            dt = to_torch_type(dt_arg)
        else:
            dt = fv.dtype if self.fill is None else torch.int32
        if fv.dim() == 2 and fv.shape[1] > 1:
            shape = shape or (fv.shape[1],)
            fv = fv.reshape((n,) + (1,) * (len(shape) - 1) + (fv.shape[1],))
        else:
            fv = fv.reshape((n,) + (1,) * len(shape))
        return [DeviceBatch(fv.to(dt).expand((n,) + shape).contiguous(), None, "")]


for _nm, _fill, _like in (("Zeros", 0.0, False), ("Ones", 1.0, False), ("Full", None, False),
                          ("ZerosLike", 0.0, True), ("OnesLike", 1.0, True),
                          ("FullLike", None, True)):
    register_operator(_nm, "gpu")(type(_nm + "GPU", (_ValueOpGPU,), {"fill": _fill, "like": _like}))
