"""noise.SaltAndPepper (cpu and gpu), noise.Shot on the host, SSDRandomCrop on
the host and Reinterpret (counterpart of those operators of
``dali_tpu/backend/tail.py``; the reference's other operators of that file
are not ported yet). The host noise draws one Philox stream per (op,
iteration, sample), as the reference does; the device noise draws from
``DeviceCtx.generator``."""

from __future__ import annotations

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch, HostBatch
from ..types import to_numpy_type, to_torch_type
from .base import Operator
from .bbox import _iou
from .random import per_sample

DALI_SCHEMA("noise.SaltAndPepper").DocStr(
    "Salt-and-pepper noise: a pixel is corrupted with probability `prob`, to salt with "
    "probability `salt_vs_pepper` and to pepper otherwise."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddRandomSeedArg().AddOptionalArg(
    "prob", ArgType.FLOAT, "Probability a pixel is corrupted.", 0.05, tensor_ok=True,
    per_sample=True
).AddOptionalArg(
    "salt_vs_pepper", ArgType.FLOAT, "Fraction of corrupted pixels that are salt.", 0.5,
    tensor_ok=True, per_sample=True
).AddOptionalArg(
    "salt_val", ArgType.FLOAT, "Salt value (default dtype max).", None
).AddOptionalArg(
    "pepper_val", ArgType.FLOAT, "Pepper value (default dtype min).", None
).AddOptionalArg("per_channel", ArgType.BOOL, "Corrupt channels independently.", False)


def _sp_vals(spec, dtype):
    salt = spec.GetArgument("salt_val", None)
    pepper = spec.GetArgument("pepper_val", None)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return (info.max if salt is None else salt), (info.min if pepper is None else pepper)
    return (1.0 if salt is None else salt), (0.0 if pepper is None else pepper)


@register_operator("noise.SaltAndPepper", "cpu")
class SaltAndPepperCPU(Operator):
    def run_sample(self, ctx, idx, x):
        rng = ctx.rng(self, idx)
        prob = float(np.asarray(ctx.arg(self, "prob", idx, 0.05)))
        svp = float(np.asarray(ctx.arg(self, "salt_vs_pepper", idx, 0.5)))
        salt, pepper = _sp_vals(self.spec, x.dtype)
        shape = x.shape if self.spec.GetArgument("per_channel", False) else x.shape[:-1] + (1,)
        u = rng.random(shape)
        out = np.where(np.broadcast_to(u < prob * svp, x.shape), np.asarray(salt, x.dtype), x)
        return np.where(np.broadcast_to((u >= prob * svp) & (u < prob), x.shape),
                        np.asarray(pepper, x.dtype), out)


@register_operator("noise.SaltAndPepper", "gpu")
class SaltAndPepperGPU(Operator):
    def lower(self, dctx, inp: DeviceBatch):
        x = inp.data
        np_dt = torch.empty(0, dtype=x.dtype).numpy().dtype
        # the values as numpy casts them to the input's dtype
        salt, pepper = (torch.from_numpy(np.asarray(v, np_dt).reshape(1)).to(x.device)
                        for v in _sp_vals(self.spec, np_dt))
        shape = x.shape if self.spec.GetArgument("per_channel", False) else x.shape[:-1] + (1,)
        prob = per_sample(dctx, self, "prob", 0.05, x.shape[0], x.dim(), x.device)
        svp = per_sample(dctx, self, "salt_vs_pepper", 0.5, x.shape[0], x.dim(), x.device)
        u = torch.rand(shape, generator=dctx.generator(self), dtype=torch.float32,
                       device=x.device)
        out = torch.where(u < prob * svp, salt, x)
        return [inp.with_data(torch.where((u >= prob * svp) & (u < prob), pepper, out))]


DALI_SCHEMA("noise.Shot").DocStr(
    "Shot (Poisson) noise: out ~ Poisson(x / factor) * factor; a factor <= 0 passes the input."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddRandomSeedArg().AddOptionalArg(
    "factor", ArgType.FLOAT, "Noise factor.", 20.0, tensor_ok=True, per_sample=True)


@register_operator("noise.Shot", "cpu")
class ShotNoiseCPU(Operator):
    def run_sample(self, ctx, idx, x):
        rng = ctx.rng(self, idx)
        factor = float(np.asarray(ctx.arg(self, "factor", idx, 20.0)))
        if factor <= 0:
            return x.copy()
        out = rng.poisson(x.astype(np.float64) / factor).astype(np.float64) * factor
        if np.issubdtype(x.dtype, np.integer):
            info = np.iinfo(x.dtype)
            out = np.clip(out, info.min, info.max)
        return out.astype(x.dtype)

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
