"""Erase, BbFlip, BoxEncoder and CoordFlip on the device (counterpart of
``dali_tpu/backend/generic_gpu.py`` ``EraseGPU``, ``BbFlipGPU`` and
``BoxEncoderGPU``, and of ``dali_tpu/backend/straggler_gpu.py``
``CoordFlipGPU``; Erase's schema is ``dali_tpu/backend/generic2.py``'s).

The box operators run as plain batched PyTorch over the padded ``[N, M, 4]``
box canvas, with each sample's box count from ``DeviceBatch.shapes``: the
reference computes them in XLA with no Pallas kernel.
"""

from __future__ import annotations

import numpy as np
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
