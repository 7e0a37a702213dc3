"""Bounding-box operators on the host: BbFlip, BBoxPaste, RandomBBoxCrop and
BoxEncoder (counterpart of ``dali_tpu/backend/bbox.py``; the gpu BbFlip and
BoxEncoder are in ``generic_gpu.py``).

Numpy, draw for draw with the reference: RandomBBoxCrop draws from
``ctx.rng(self)`` in the same order, so both packages pick the same windows.
The reference declares RandomBBoxCrop's ``ltrb``, ``bbox_layout`` and
``threshold_type`` but reads none of them: it always treats boxes as
``[l, t, r, b]`` and thresholds on IoU. The port accepts exactly the values
that behaviour computes correctly and raises ``NotImplementedError`` for the
others (ROADMAP.md, Queue 3).
"""

from __future__ import annotations

import warnings

import numpy as np

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import HostBatch
from .base import BF16_WIDEN, Operator

# ======================================== BbFlip ==================================================

DALI_SCHEMA("BbFlip").DocStr(
    "Flips bounding boxes in [0,1] relative coordinates, [x,y,w,h] or ltrb."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "ltrb", ArgType.BOOL, "Boxes are [l,t,r,b] (True) or [x,y,w,h].", False
).AddOptionalArg(
    "horizontal", ArgType.INT, "Flip horizontally.", 1, tensor_ok=True
).AddOptionalArg(
    "vertical", ArgType.INT, "Flip vertically.", 0, tensor_ok=True)


def flip_boxes(boxes: np.ndarray, ltrb: bool, h: bool, v: bool) -> np.ndarray:
    out = boxes.astype(np.float32).copy()
    if boxes.size == 0:
        return out
    if ltrb:
        if h:
            out[:, 0], out[:, 2] = 1.0 - boxes[:, 2], 1.0 - boxes[:, 0]
        if v:
            out[:, 1], out[:, 3] = 1.0 - boxes[:, 3], 1.0 - boxes[:, 1]
    else:
        if h:
            out[:, 0] = 1.0 - boxes[:, 0] - boxes[:, 2]
        if v:
            out[:, 1] = 1.0 - boxes[:, 1] - boxes[:, 3]
    return out


@register_operator("BbFlip", "cpu")
class BbFlipCPU(Operator):
    reads_bfloat16 = BF16_WIDEN

    def run_sample(self, ctx, idx, boxes):
        h = bool(np.asarray(ctx.arg(self, "horizontal", idx, 1)))
        v = bool(np.asarray(ctx.arg(self, "vertical", idx, 0)))
        return flip_boxes(boxes.reshape(-1, 4), self.spec.GetArgument("ltrb"), h, v)


# ======================================== BBoxPaste ===============================================

DALI_SCHEMA("BBoxPaste").DocStr(
    "Adjusts boxes for a paste into a larger canvas."
).NumInput(1).NumOutput(1).Devices("cpu").AddArg(
    "ratio", ArgType.FLOAT, "Canvas enlargement ratio.", tensor_ok=True
).AddOptionalArg(
    "paste_x", ArgType.FLOAT, "Paste x position in [0,1].", 0.5, tensor_ok=True
).AddOptionalArg(
    "paste_y", ArgType.FLOAT, "Paste y position in [0,1].", 0.5, tensor_ok=True
).AddOptionalArg("ltrb", ArgType.BOOL, "Box format.", False)


@register_operator("BBoxPaste", "cpu")
class BBoxPaste(Operator):
    def run_sample(self, ctx, idx, boxes):
        r = float(np.asarray(ctx.arg(self, "ratio", idx, 1.0)))
        px = float(np.asarray(ctx.arg(self, "paste_x", idx, 0.5)))
        py = float(np.asarray(ctx.arg(self, "paste_y", idx, 0.5)))
        b = boxes.reshape(-1, 4).astype(np.float32).copy()
        if b.size == 0:
            return b
        ox = px * (r - 1.0) / r
        oy = py * (r - 1.0) / r
        if self.spec.GetArgument("ltrb"):
            b[:, [0, 2]] = b[:, [0, 2]] / r + ox
            b[:, [1, 3]] = b[:, [1, 3]] / r + oy
        else:
            b[:, 0] = b[:, 0] / r + ox
            b[:, 1] = b[:, 1] / r + oy
            b[:, 2] = b[:, 2] / r
            b[:, 3] = b[:, 3] / r
        return b


# ======================================== RandomBBoxCrop ==========================================

DALI_SCHEMA("RandomBBoxCrop").DocStr(
    """SSD-style IoU-constrained random crop: samples a window whose min IoU
    with the kept boxes satisfies a randomly chosen threshold; outputs
    (anchor, shape, cropped_bboxes, labels[, bbox_indices])."""
).NumInput(1, 2).OutputFn(
    lambda spec: 4 + int(spec.GetArgument("output_bbox_indices", False))
).Devices("cpu").AddRandomSeedArg().AddOptionalArg(
    "aspect_ratio", ArgType.FLOAT_VEC, "Window aspect-ratio range.", [1.0, 1.0]
).AddOptionalArg(
    "thresholds", ArgType.FLOAT_VEC, "Candidate min-IoU thresholds.", [0.0]
).AddOptionalArg(
    "threshold_type", ArgType.STRING, "'iou' ('overlap' is not ported).", "iou"
).AddOptionalArg(
    "scaling", ArgType.FLOAT_VEC, "Window scale range (fraction of input).", [1.0, 1.0]
).AddOptionalArg(
    "ltrb", ArgType.BOOL, "Boxes are ltrb (False is not ported).", True
).AddOptionalArg(
    "bbox_layout", ArgType.TENSOR_LAYOUT, "'xyXY' (ltrb; other layouts are not ported).", None
).AddOptionalArg(
    "num_attempts", ArgType.INT, "Attempts per threshold.", 1
).AddOptionalArg(
    "total_num_attempts", ArgType.INT, "Global attempt cap (0 = unlimited).", 0
).AddOptionalArg(
    "allow_no_crop", ArgType.BOOL, "Allow keeping the whole image.", True
).AddOptionalArg(
    "all_boxes_above_threshold", ArgType.BOOL, "Require all boxes to satisfy IoU.", True
).AddOptionalArg("crop_shape", ArgType.INT_VEC, "Fixed crop shape (absolute).", None).AddOptionalArg(
    "input_shape", ArgType.INT_VEC, "Input shape for absolute crops.", None, tensor_ok=True
).AddOptionalArg(
    "shape_layout", ArgType.TENSOR_LAYOUT,
    'Meaning of crop_shape/input_shape dims ("WH" default).', None
).AddOptionalArg(
    "output_bbox_indices", ArgType.BOOL,
    "Extra output with the original indices of the kept boxes.", False
).AddOptionalArg(
    "bbox_prune_threshold", ArgType.FLOAT,
    "When set, keep boxes whose area fraction inside the window is >= this value instead of "
    "the centroid filter (0.0 keeps any overlap).", None
).AddOptionalArg(
    "quiet", ArgType.BOOL,
    "Suppress the warning emitted when no valid window is found within the attempt budget "
    "and the best candidate is used.", False)


def _ignored_by_reference(what):
    return NotImplementedError(
        f"RandomBBoxCrop({what}) is not ported to dali_tpu_torch: dali_tpu declares it but "
        "treats boxes as ltrb and thresholds on IoU whatever it says; see ROADMAP.md, Queue 3 "
        "(RandomBBoxCrop arguments the reference ignores)")


def _iou(boxes: np.ndarray, window: np.ndarray) -> np.ndarray:
    ix1 = np.maximum(boxes[:, 0], window[0])
    iy1 = np.maximum(boxes[:, 1], window[1])
    ix2 = np.minimum(boxes[:, 2], window[2])
    iy2 = np.minimum(boxes[:, 3], window[3])
    iw = np.maximum(ix2 - ix1, 0)
    ih = np.maximum(iy2 - iy1, 0)
    inter = iw * ih
    area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    area_w = (window[2] - window[0]) * (window[3] - window[1])
    return inter / np.maximum(area_b + area_w - inter, 1e-9)


def _labels_i32(labels):
    return labels.astype(np.int32) if labels is not None else None


@register_operator("RandomBBoxCrop", "cpu")
class RandomBBoxCrop(Operator):
    reads_bfloat16 = BF16_WIDEN

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        if not spec.GetArgument("ltrb"):
            raise _ignored_by_reference("ltrb=False")
        layout = spec.GetArgument("bbox_layout")
        if layout is not None and layout != "xyXY":
            raise _ignored_by_reference(f"bbox_layout={layout!r}")
        if spec.GetArgument("threshold_type") != "iou":
            raise _ignored_by_reference(f"threshold_type={spec.GetArgument('threshold_type')!r}")

    def run_batch(self, ctx, boxes_b: HostBatch, *labels_b):
        rng = ctx.rng(self)
        anchors, shapes, out_boxes, out_labels, out_idx = [], [], [], [], []
        labels_samples = labels_b[0].samples if labels_b else [None] * len(boxes_b)
        for i in range(len(boxes_b)):
            a, s, bb, lb, ki = self._one(
                ctx, i, rng, boxes_b.samples[i].reshape(-1, 4), labels_samples[i])
            anchors.append(a)
            shapes.append(s)
            out_boxes.append(bb)
            out_labels.append(lb if lb is not None else np.zeros((0,), np.int32))
            out_idx.append(ki)
        outs = [HostBatch(anchors), HostBatch(shapes), HostBatch(out_boxes), HostBatch(out_labels)]
        if self.spec.GetArgument("output_bbox_indices"):
            outs.append(HostBatch(out_idx))
        return outs

    def _fixed_window(self, ctx, i, rng):
        """crop_shape mode: an absolute pixel window inside input_shape.
        Returns (abs_anchor, abs_shape, relative ltrb window)."""
        spec = self.spec
        crop_shape = spec.GetArgument("crop_shape")
        in_shape = ctx.arg(self, "input_shape", i, None)
        if in_shape is None:
            raise ValueError("RandomBBoxCrop: crop_shape requires input_shape")
        cs = np.asarray(crop_shape, np.float64).reshape(-1)
        ins = np.asarray(in_shape, np.float64).reshape(-1)
        layout = spec.GetArgument("shape_layout") or ("WH" if cs.size == 2 else "WHD")
        wi, hi = layout.index("W"), layout.index("H")
        cw, chh = cs[wi], cs[hi]
        iw, ih = ins[wi], ins[hi]
        if cw > iw or chh > ih:
            raise ValueError(
                f"RandomBBoxCrop: crop_shape {crop_shape} exceeds input_shape "
                f"{list(np.asarray(in_shape).reshape(-1))}")
        x = float(rng.integers(0, int(iw - cw) + 1))
        y = float(rng.integers(0, int(ih - chh) + 1))
        window = np.array([x / iw, y / ih, (x + cw) / iw, (y + chh) / ih], np.float32)
        anchor = np.zeros(cs.size, np.float32)
        anchor[wi], anchor[hi] = x, y
        return anchor, cs.astype(np.float32), window

    def _filter(self, boxes, window):
        """The centroid filter, or the area-fraction filter when
        bbox_prune_threshold is set."""
        prune = self.spec.GetArgument("bbox_prune_threshold")
        if prune is None:
            centers = (boxes[:, :2] + boxes[:, 2:]) / 2
            return ((centers[:, 0] >= window[0]) & (centers[:, 0] <= window[2])
                    & (centers[:, 1] >= window[1]) & (centers[:, 1] <= window[3]))
        iw = np.maximum(np.minimum(boxes[:, 2], window[2]) - np.maximum(boxes[:, 0], window[0]), 0)
        ih = np.maximum(np.minimum(boxes[:, 3], window[3]) - np.maximum(boxes[:, 1], window[1]), 0)
        inter = iw * ih
        area = np.maximum((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]), 1e-9)
        return (inter / area >= prune) if prune > 0 else (inter > 0)

    def _one(self, ctx, i, rng, boxes, labels):
        spec = self.spec
        thresholds = list(spec.GetArgument("thresholds"))
        if spec.GetArgument("allow_no_crop"):
            thresholds = thresholds + [None]
        scaling = spec.GetArgument("scaling")
        ar_range = spec.GetArgument("aspect_ratio")
        attempts = spec.GetArgument("num_attempts")
        total_cap = spec.GetArgument("total_num_attempts")
        all_above = spec.GetArgument("all_boxes_above_threshold")
        fixed = spec.GetArgument("crop_shape") is not None
        boxes = boxes.astype(np.float32)
        all_idx = np.arange(boxes.shape[0], dtype=np.int32)
        total = 0
        best = None  # (metric, result): the fallback when the attempt budget runs out
        while True:
            thr = thresholds[int(rng.integers(0, len(thresholds)))]
            if thr is None:
                anchor = np.zeros(2, np.float32)
                shape = np.ones(2, np.float32)
                if fixed:  # no crop in fixed mode: the whole image, absolute
                    in_shape = np.asarray(ctx.arg(self, "input_shape", i), np.float32).reshape(-1)
                    anchor, shape = np.zeros_like(in_shape), in_shape
                return anchor, shape, boxes.copy(), _labels_i32(labels), all_idx
            for _ in range(attempts):
                total += 1
                if fixed:
                    anchor_abs, shape_abs, window = self._fixed_window(ctx, i, rng)
                    w, h = window[2] - window[0], window[3] - window[1]
                else:
                    scale = rng.uniform(scaling[0], scaling[1])
                    ar = rng.uniform(ar_range[0], ar_range[1])
                    w = scale * np.sqrt(ar)
                    h = scale / np.sqrt(ar)
                    if w > 1 or h > 1:
                        continue
                    x = rng.uniform(0, 1 - w)
                    y = rng.uniform(0, 1 - h)
                    window = np.array([x, y, x + w, y + h], np.float32)
                    anchor_abs = np.array([x, y], np.float32)
                    shape_abs = np.array([w, h], np.float32)
                if not boxes.shape[0]:
                    return anchor_abs, shape_abs, boxes.copy(), _labels_i32(labels), all_idx
                inside = self._filter(boxes, window)
                ious = _iou(boxes, window)
                # acceptance metric: min over the kept boxes when
                # all_boxes_above_threshold, else max
                if inside.any():
                    metric = float(ious[inside].min() if all_above else ious[inside].max())
                else:
                    metric = -1.0
                kept = boxes[inside].copy()
                # clip to the window, then rebase to window coordinates
                kept[:, 0] = np.clip(kept[:, 0], window[0], window[2])
                kept[:, 1] = np.clip(kept[:, 1], window[1], window[3])
                kept[:, 2] = np.clip(kept[:, 2], window[0], window[2])
                kept[:, 3] = np.clip(kept[:, 3], window[1], window[3])
                kept[:, [0, 2]] = (kept[:, [0, 2]] - window[0]) / w
                kept[:, [1, 3]] = (kept[:, [1, 3]] - window[1]) / h
                new_labels = labels[inside].astype(np.int32) if labels is not None else None
                result = (anchor_abs, shape_abs, kept, new_labels, all_idx[inside])
                if best is None or metric > best[0]:
                    best = (metric, result)
                if metric >= thr:
                    return result
            if total_cap and total >= total_cap:
                if not spec.GetArgument("quiet"):
                    warnings.warn(
                        "RandomBBoxCrop: no window satisfied the threshold "
                        f"within {total} attempts; using the best candidate "
                        "(pass quiet=True to silence)")
                if best is not None:
                    return best[1]
                return (np.zeros(2, np.float32), np.ones(2, np.float32), boxes.copy(),
                        _labels_i32(labels), all_idx)

    def output_layout(self, j, inputs):
        return ""


# ======================================== BoxEncoder ===============================================

DALI_SCHEMA("BoxEncoder").DocStr(
    """SSD anchor matching: matches ground-truth boxes to anchors by IoU >=
    criteria; outputs per-anchor (boxes, labels)."""
).NumInput(2).NumOutput(2).Devices("cpu", "gpu").AddArg(
    "anchors", ArgType.FLOAT_VEC, "Anchors as flattened ltrb (relative)."
).AddOptionalArg(
    "criteria", ArgType.FLOAT, "IoU matching threshold.", 0.5
).AddOptionalArg(
    "offset", ArgType.BOOL, "Output (gt - anchor) offsets.", False
).AddOptionalArg(
    "means", ArgType.FLOAT_VEC, "Offset means.", [0.0, 0.0, 0.0, 0.0]
).AddOptionalArg(
    "stds", ArgType.FLOAT_VEC, "Offset stds.", [1.0, 1.0, 1.0, 1.0]
).AddOptionalArg("scale", ArgType.FLOAT, "Coordinate scale factor.", 1.0)


def _to_xywh(b):
    return np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
                     b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], axis=1)


def iou_matrix(boxes: np.ndarray, anchors_ltrb: np.ndarray) -> np.ndarray:
    """[n_boxes, A] IoU of ltrb boxes against ltrb anchors, in the reference
    encoder's float operation order (its ties decide the matches)."""
    ix1 = np.maximum(boxes[:, None, 0], anchors_ltrb[None, :, 0])
    iy1 = np.maximum(boxes[:, None, 1], anchors_ltrb[None, :, 1])
    ix2 = np.minimum(boxes[:, None, 2], anchors_ltrb[None, :, 2])
    iy2 = np.minimum(boxes[:, None, 3], anchors_ltrb[None, :, 3])
    inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
    area_b = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))[:, None]
    area_a = ((anchors_ltrb[:, 2] - anchors_ltrb[:, 0])
              * (anchors_ltrb[:, 3] - anchors_ltrb[:, 1]))[None]
    return inter / np.maximum(area_b + area_a - inter, 1e-9)


def encode_boxes(boxes, labels, anchors_ltrb, criteria, offset, means, stds, scale):
    """The best box of each anchor at IoU >= criteria, after each box has
    claimed its best anchor (forced match)."""
    out_boxes = anchors_ltrb.copy()
    out_labels = np.zeros((anchors_ltrb.shape[0],), np.int32)
    if boxes.shape[0]:
        iou = iou_matrix(boxes, anchors_ltrb)
        best_box = iou.argmax(axis=0)
        best_iou = iou.max(axis=0)
        best_anchor = iou.argmax(axis=1)
        best_iou[best_anchor] = 2.0
        best_box[best_anchor] = np.arange(boxes.shape[0])
        matched = best_iou >= criteria
        out_boxes[matched] = boxes[best_box[matched]]
        out_labels[matched] = labels.reshape(-1)[best_box[matched]]
    if offset:
        g = _to_xywh(out_boxes * scale)
        a = _to_xywh(anchors_ltrb * scale)
        enc = np.stack([(g[:, 0] - a[:, 0]) / a[:, 2],
                        (g[:, 1] - a[:, 1]) / a[:, 3],
                        np.log(np.maximum(g[:, 2], 1e-9) / a[:, 2]),
                        np.log(np.maximum(g[:, 3], 1e-9) / a[:, 3])], axis=1)
        out = (enc - np.asarray(means, np.float32)) / np.asarray(stds, np.float32)
        return out.astype(np.float32), out_labels
    return (out_boxes * scale).astype(np.float32), out_labels


@register_operator("BoxEncoder", "cpu")
class BoxEncoderCPU(Operator):
    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._anchors = np.asarray(spec.GetArgument("anchors"), np.float32).reshape(-1, 4)

    def run_sample(self, ctx, idx, boxes, labels):
        spec = self.spec
        return encode_boxes(boxes.reshape(-1, 4).astype(np.float32), labels, self._anchors,
                            spec.GetArgument("criteria"), spec.GetArgument("offset"),
                            spec.GetArgument("means"), spec.GetArgument("stds"),
                            spec.GetArgument("scale"))

    def output_layout(self, j, inputs):
        return ""
