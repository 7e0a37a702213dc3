"""SSDRandomCrop on the host and Reinterpret (counterpart of
``dali_tpu/backend/tail.py`` ``SSDRandomCrop`` and ``Reinterpret``; the
reference's other operators of that file are not ported yet)."""

from __future__ import annotations

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch, HostBatch
from ..types import to_numpy_type, to_torch_type
from .base import Operator
from .bbox import _iou

DALI_SCHEMA("SSDRandomCrop").DocStr(
    "Legacy fused SSD crop: an IoU-constrained window applied to the image, boxes and labels "
    "together."
).NumInput(3).NumOutput(3).Devices("cpu").AddRandomSeedArg().AddOptionalArg(
    "num_attempts", ArgType.INT, "Sampling attempts.", 1)

# the legacy operator's fixed menu; None keeps the whole image
SSD_THRESHOLDS = [None, 0.1, 0.3, 0.5, 0.7, 0.9]


@register_operator("SSDRandomCrop", "cpu")
class SSDRandomCrop(Operator):
    def run_batch(self, ctx, imgs: HostBatch, boxes: HostBatch, labels: HostBatch):
        rng = ctx.rng(self)
        attempts = max(self.spec.GetArgument("num_attempts"), 1)
        outs = [self._one(rng, attempts, imgs.samples[i],
                          boxes.samples[i].reshape(-1, 4).astype(np.float32),
                          labels.samples[i].reshape(-1)) for i in range(len(imgs))]
        return [HostBatch([o[0] for o in outs], layout=imgs.layout),
                HostBatch([o[1] for o in outs]), HostBatch([o[2] for o in outs])]

    @staticmethod
    def _one(rng, attempts, img, bxs, lbl):
        h, w = img.shape[:2]
        while True:
            thr = SSD_THRESHOLDS[int(rng.integers(0, len(SSD_THRESHOLDS)))]
            if thr is None:
                return img, bxs, lbl.astype(np.int32)
            for _ in range(attempts):
                cw = rng.uniform(0.3, 1.0)
                chh = rng.uniform(0.3, 1.0)
                if not (0.5 <= cw / chh <= 2.0):
                    continue
                x0 = rng.uniform(0, 1 - cw)
                y0 = rng.uniform(0, 1 - chh)
                win = np.array([x0, y0, x0 + cw, y0 + chh], np.float32)
                if bxs.shape[0]:
                    centers = (bxs[:, :2] + bxs[:, 2:]) / 2
                    inside = ((centers[:, 0] >= win[0]) & (centers[:, 0] <= win[2])
                              & (centers[:, 1] >= win[1]) & (centers[:, 1] <= win[3]))
                    if not inside.any() or (_iou(bxs, win)[inside] < thr).any():
                        continue
                    kept = bxs[inside].copy()
                    kept[:, [0, 2]] = (np.clip(kept[:, [0, 2]], win[0], win[2]) - win[0]) / cw
                    kept[:, [1, 3]] = (np.clip(kept[:, [1, 3]], win[1], win[3]) - win[1]) / chh
                    new_lbl = lbl[inside].astype(np.int32)
                else:
                    kept = bxs
                    new_lbl = lbl.astype(np.int32)
                ix0, iy0 = int(x0 * w), int(y0 * h)
                iw, ih = max(int(cw * w), 1), max(int(chh * h), 1)
                return np.ascontiguousarray(img[iy0:iy0 + ih, ix0:ix0 + iw]), kept, new_lbl


DALI_SCHEMA("Reinterpret").DocStr(
    "Reinterprets the underlying bytes with a new dtype and/or shape."
).NumInput(1, 2).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "dtype", ArgType.DATA_TYPE, "New dtype (bit reinterpret).", None
).AddOptionalArg(
    "shape", ArgType.FLOAT_VEC, "New shape (-1 infers).", None, tensor_ok=True
).AddOptionalArg(
    "rel_shape", ArgType.FLOAT_VEC, "Shape relative to input.", None
).AddOptionalArg("layout", ArgType.TENSOR_LAYOUT, "New layout.", None)


def _infer(shape, total):
    if -1 in shape:
        known = int(np.prod([v for v in shape if v != -1]))
        shape[shape.index(-1)] = total // max(known, 1)
    return shape


@register_operator("Reinterpret", "cpu")
class ReinterpretCPU(Operator):
    def run_sample(self, ctx, idx, x, *shape_in):
        dt = self.spec.GetArgument("dtype", None)
        out = x.view(to_numpy_type(dt)) if dt is not None else x
        if shape_in:
            shape = [int(v) for v in np.asarray(shape_in[0]).reshape(-1)]
        else:
            v = ctx.arg(self, "shape", idx, None)
            shape = None if v is None else [int(round(float(s)))
                                            for s in np.asarray(v).reshape(-1)]
        return out if shape is None else out.reshape(_infer(shape, out.size))

    def output_layout(self, j, inputs):
        return self.spec.GetArgument("layout", None) or ""


@register_operator("Reinterpret", "gpu")
class ReinterpretGPU(Operator):
    """A dtype reinterpret is a bitcast along the last canvas dim (a
    narrower dtype widens it by the itemsize ratio; a wider one needs it
    divisible, and a uniform batch); a constant ``shape`` reshapes a
    uniform batch. Per-sample shapes are cpu-only."""

    def host_output_layouts(self, in_layouts):
        return [self.spec.GetArgument("layout", None) or ""]

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        sh = input_shapes[0] if input_shapes else None
        if sh is None or len(input_shapes) > 1 or "shape" in self.spec.arg_inputs:
            return None
        out = np.asarray(sh).astype(np.int64).copy()
        dt = self.spec.GetArgument("dtype", None)
        if dt is not None and out.shape[1]:
            # the host knows the input dtype only of a batch that crossed
            # from it; elsewhere the batch's device shapes serve
            b = input_batches[0] if input_batches else None
            if b is None:
                return None
            out[:, -1] = out[:, -1] * b.dtype.itemsize // np.dtype(to_numpy_type(dt)).itemsize
        req = self.spec.GetArgument("shape", None)
        if req is not None:
            out = np.asarray([_infer([int(round(v)) for v in req], int(np.prod(row)))
                              for row in out], np.int64)
        return [out]

    def lower(self, dctx, inp: DeviceBatch, *shape_in):
        if shape_in or dctx.has_tensor_arg(self, "shape"):
            raise ValueError("Reinterpret(gpu): per-sample shapes are cpu-only (fn.reshape "
                             "supports per-sample tensor shapes on gpu)")
        data, shapes = inp.data, inp.shapes
        dt = self.spec.GetArgument("dtype", None)
        if dt is not None:
            new = to_torch_type(dt)
            old_sz, new_sz = data.element_size(), torch.empty(0, dtype=new).element_size()
            if new_sz > old_sz:
                r = new_sz // old_sz
                if shapes is not None:
                    raise ValueError("Reinterpret(gpu): widening dtype reinterpret of a ragged "
                                     "batch is cpu-only (per-sample extents must divide by the "
                                     "itemsize ratio)")
                if data.shape[-1] % r:
                    raise ValueError("Reinterpret(gpu): last extent not divisible by the "
                                     "itemsize ratio")
            data = data.contiguous().view(new)
            if new_sz < old_sz and shapes is not None:  # ragged extents scale exactly
                r = old_sz // new_sz
                shapes = torch.cat([shapes[:, :-1], shapes[:, -1:] * r], dim=1)
        req = self.spec.GetArgument("shape", None)
        if req is not None:
            if shapes is not None:
                raise ValueError("Reinterpret(gpu): static `shape` on a ragged batch is cpu-only "
                                 "(the padded canvas cannot reshape per sample)")
            shape = _infer([int(round(v)) for v in req], int(np.prod(data.shape[1:])))
            data = data.reshape(data.shape[0], *shape)
        return [DeviceBatch(data, shapes, self.spec.GetArgument("layout", None) or "")]
