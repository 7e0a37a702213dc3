"""Crop-window generators and box rotation on the host: RandomCropGenerator,
ROIRandomCrop and BBoxRotate. All three come from
``dali_tpu/backend/parity.py`` (``RandomCropGenerator``, ``ROIRandomCrop``,
``BBoxRotate``), numpy and draw for draw with it: each sample draws from its
own ``ctx.rng(self, i)`` stream."""

from __future__ import annotations

import numpy as np

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import HostBatch
from .base import Operator
from .decoders import sample_rrc_window

# ====================================== RandomCropGenerator =======================================

DALI_SCHEMA("RandomCropGenerator").DocStr(
    "Samples area/aspect crop windows of [H, W] input shapes without cropping: outputs "
    "(anchor, shape)."
).NumInput(1).NumOutput(2).Devices("cpu").AddRandomSeedArg().AddOptionalArg(
    "random_area", ArgType.FLOAT_VEC, "Crop area range.", [0.08, 1.0]
).AddOptionalArg(
    "random_aspect_ratio", ArgType.FLOAT_VEC, "Aspect-ratio range.", [3 / 4, 4 / 3]
).AddOptionalArg("num_attempts", ArgType.INT, "Sampling attempts.", 10)


@register_operator("RandomCropGenerator", "cpu")
class RandomCropGenerator(Operator):
    def run_batch(self, ctx, inp: HostBatch):
        spec = self.spec
        anchors, shapes = [], []
        for i, shp in enumerate(inp.samples):
            s = np.asarray(shp).reshape(-1)
            y, x, ch, cw = sample_rrc_window(
                ctx.rng(self, i), int(s[0]), int(s[1]), spec.GetArgument("random_area"),
                spec.GetArgument("random_aspect_ratio"), spec.GetArgument("num_attempts"))
            anchors.append(np.array([y, x], np.int64))
            shapes.append(np.array([ch, cw], np.int64))
        return [HostBatch(anchors), HostBatch(shapes)]


# ====================================== ROIRandomCrop =============================================

DALI_SCHEMA("ROIRandomCrop").DocStr(
    """A fixed-shape crop window placed at random so that it covers as much of
    the given ROI as it can. Outputs the window anchor."""
).NumInput(0, 1).NumOutput(1).Devices("cpu").AddRandomSeedArg().AddArg(
    "crop_shape", ArgType.INT_VEC, "Window shape.", tensor_ok=True
).AddArg(
    "roi_start", ArgType.INT_VEC, "ROI start.", tensor_ok=True
).AddOptionalArg(
    "roi_end", ArgType.INT_VEC, "ROI end.", None, tensor_ok=True
).AddOptionalArg(
    "roi_shape", ArgType.INT_VEC, "ROI shape.", None, tensor_ok=True
).AddOptionalArg(
    "in_shape", ArgType.INT_VEC, "Input shape bounds.", None, tensor_ok=True)


@register_operator("ROIRandomCrop", "cpu")
class ROIRandomCrop(Operator):
    def run_batch(self, ctx, *inputs):
        n = len(inputs[0]) if inputs else ctx.batch_size
        out = []
        for i in range(n):
            crop = np.asarray(ctx.arg(self, "crop_shape", i), np.int64).reshape(-1)
            rs = np.asarray(ctx.arg(self, "roi_start", i), np.int64).reshape(-1)
            re_ = ctx.arg(self, "roi_end", i, None)
            if re_ is None:
                re_ = rs + np.asarray(ctx.arg(self, "roi_shape", i), np.int64).reshape(-1)
            else:
                re_ = np.asarray(re_, np.int64).reshape(-1)
            ishape = ctx.arg(self, "in_shape", i, None)
            if ishape is None and inputs:
                ishape = np.asarray(inputs[0].samples[i]).reshape(-1)
            ishape = None if ishape is None else np.asarray(ishape, np.int64).reshape(-1)
            rng = ctx.rng(self, i)
            anchor = np.zeros_like(crop)
            for d in range(len(crop)):
                # the window contains the ROI when it fits, else overlaps it most
                lo = max(int(re_[d]) - int(crop[d]), 0)
                hi = min(int(rs[d]),
                         (int(ishape[d]) - int(crop[d])) if ishape is not None else int(rs[d]))
                if ishape is not None:
                    hi = max(min(hi, int(ishape[d]) - int(crop[d])), 0)
                if hi < lo:
                    lo, hi = hi, lo
                anchor[d] = int(rng.integers(lo, hi + 1))
            out.append(anchor)
        return [HostBatch(out)]


# ====================================== BBoxRotate ================================================

DALI_SCHEMA("BBoxRotate").DocStr(
    """Rotates bounding boxes so they track an fn.rotate of the image: each
    box's corners rotate about the image center; the output is their
    axis-aligned hull, clipped to the canvas. With ``keep_size=False`` the
    canvas grows like fn.rotate's; boxes that fall below ``remove_threshold``
    are removed (labels, when given, are filtered identically)."""
).NumInput(1, 2).OutputFn(lambda spec: len(spec.inputs)).Devices("cpu").AddArg(
    "angle", ArgType.FLOAT, "Rotation angle in degrees.", tensor_ok=True
).AddArg(
    "input_shape", ArgType.INT_VEC, "Original image shape.", tensor_ok=True
).AddOptionalArg(
    "shape_layout", ArgType.TENSOR_LAYOUT, "Meaning of input_shape dims.", "HW"
).AddOptionalArg(
    "bbox_layout", ArgType.TENSOR_LAYOUT, "'xyXY' or 'xyWH'.", "xyXY"
).AddOptionalArg(
    "bbox_normalized", ArgType.BOOL, "Boxes are in [0,1] coords.", True
).AddOptionalArg(
    "keep_size", ArgType.BOOL, "Canvas keeps the input size.", False
).AddOptionalArg(
    "size", ArgType.FLOAT_VEC, "Output canvas size override: the `size` given to the paired "
    "fn.rotate.", None, tensor_ok=True
).AddOptionalArg(
    "mode", ArgType.STRING,
    'Box transform mode: "expand" (axis-aligned hull of the rotated corners), "fixed" (keep '
    'the original box extents, recentered), "halfway" (midpoint of the two).', "expand"
).AddOptionalArg(
    "remove_threshold", ArgType.FLOAT,
    "Remove boxes whose remaining area fraction after clipping to the canvas falls below this "
    "threshold (0 = never remove, 1 = remove if any part is outside).", 0.1)


@register_operator("BBoxRotate", "cpu")
class BBoxRotate(Operator):
    def run_batch(self, ctx, boxes_b, *labels_b):
        spec = self.spec
        layout = spec.GetArgument("shape_layout")
        norm = spec.GetArgument("bbox_normalized")
        ltrb = spec.GetArgument("bbox_layout") == "xyXY"
        keep = spec.GetArgument("keep_size")
        mode = spec.GetArgument("mode")
        thresh = float(spec.GetArgument("remove_threshold"))
        out_boxes, out_labels = [], []
        for i, b in enumerate(boxes_b.samples):
            angle = float(np.asarray(ctx.arg(self, "angle", i)))
            shape = np.asarray(ctx.arg(self, "input_shape", i), np.float64).reshape(-1)
            h = shape[layout.index("H")] if "H" in layout else shape[0]
            w = shape[layout.index("W")] if "W" in layout else shape[1]
            bb = np.asarray(b, np.float64).reshape(-1, 4).copy()
            if bb.size == 0:
                out_boxes.append(bb.astype(np.float32))
                out_labels.append(np.zeros((0,), np.int32))
                continue
            if not ltrb:
                bb[:, 2:] += bb[:, :2]
            bb *= np.array([w, h, w, h]) if norm else np.ones(4)
            a = np.deg2rad(angle)
            c, s = np.cos(a), np.sin(a)
            size_arg = ctx.arg(self, "size", i, None)
            if size_arg is not None:
                sz = np.asarray(size_arg, np.float64).reshape(-1)
                oh, ow = (float(sz[0]), float(sz[-1])) if sz.size > 1 else (float(sz[0]),) * 2
            elif keep:
                ow, oh = w, h
            else:
                ow = abs(w * c) + abs(h * s)
                oh = abs(w * s) + abs(h * c)
            rel = np.stack([bb[:, [0, 1]], bb[:, [2, 1]], bb[:, [0, 3]], bb[:, [2, 3]]],
                           axis=1) - [w / 2, h / 2]  # [M, 4, 2] corners about the center
            # the content map: the inverse of fn.rotate's dst->src rotation
            rx = rel[..., 0] * c + rel[..., 1] * s + ow / 2
            ry = -rel[..., 0] * s + rel[..., 1] * c + oh / 2
            nb = np.stack([rx.min(1), ry.min(1), rx.max(1), ry.max(1)], axis=1)
            if mode in ("fixed", "halfway"):
                mid = np.stack([(nb[:, 0] + nb[:, 2]) / 2, (nb[:, 1] + nb[:, 3]) / 2], axis=1)
                ow0 = bb[:, 2] - bb[:, 0]
                oh0 = bb[:, 3] - bb[:, 1]
                if mode == "halfway":
                    ow0 = (ow0 + (nb[:, 2] - nb[:, 0])) / 2
                    oh0 = (oh0 + (nb[:, 3] - nb[:, 1])) / 2
                nb = np.stack([mid[:, 0] - ow0 / 2, mid[:, 1] - oh0 / 2,
                               mid[:, 0] + ow0 / 2, mid[:, 1] + oh0 / 2], axis=1)
            area0 = np.maximum((nb[:, 2] - nb[:, 0]) * (nb[:, 3] - nb[:, 1]), 1e-9)
            nb[:, [0, 2]] = np.clip(nb[:, [0, 2]], 0, ow)
            nb[:, [1, 3]] = np.clip(nb[:, [1, 3]], 0, oh)
            area1 = (nb[:, 2] - nb[:, 0]) * (nb[:, 3] - nb[:, 1])
            valid = (area1 / area0) >= thresh
            if thresh > 0:
                valid &= (nb[:, 2] > nb[:, 0]) & (nb[:, 3] > nb[:, 1])
            nb = nb[valid]
            if norm:
                nb /= [ow, oh, ow, oh]
            if not ltrb:
                nb[:, 2:] -= nb[:, :2]
            out_boxes.append(nb.astype(np.float32))
            if labels_b:
                lab = np.asarray(labels_b[0].samples[i]).reshape(-1)
                out_labels.append(np.ascontiguousarray(lab[valid]))
        outs = [HostBatch(out_boxes)]
        if labels_b:
            outs.append(HostBatch(out_labels))
        return outs
