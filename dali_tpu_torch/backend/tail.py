"""noise.SaltAndPepper (cpu and gpu), noise.Shot on the host, SSDRandomCrop on
the host, Reinterpret, ResizeCropMirror and FastResizeCropMirror (cpu and
gpu), and experimental.Filter on the device (counterpart of those operators
of ``dali_tpu/backend/tail.py``; the reference's readers.NemoAsr is in
``readers3.py``, and the cpu Filter is in ``convolution.py``, as in the
reference). The host noise draws one Philox stream per (op, iteration,
sample), as the reference does; the device noise draws from
``DeviceCtx.generator``. The host resize-crop-mirror is one resample of each
sample over the crop window mapped back through its resize scale
(``kernels/host_resample.py``), then the mirror."""

from __future__ import annotations

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch, HostBatch
from ..kernels import resample as resample_kernel
from ..kernels.host_resample import host_resample
from ..types import DALIInterpType, to_numpy_type, to_torch_type
from .base import Operator, SamplePool, raise_unserved
from .bbox import _iou
from .generic2 import _crop_round
from .image import _pick_filter, compute_resize_size
from .random import per_sample, saturate

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


# ====================================== ResizeCropMirror ==============================================


def _resize_crop_mirror_schema(name):
    return DALI_SCHEMA(name).DocStr(
        "Fused resize + crop + mirror: one resample of the crop window mapped back through "
        "the resize scale."
    ).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
        "resize_x", ArgType.FLOAT, "Output width.", 0.0, tensor_ok=True, per_sample=True
    ).AddOptionalArg(
        "resize_y", ArgType.FLOAT, "Output height.", 0.0, tensor_ok=True, per_sample=True
    ).AddOptionalArg(
        "resize_shorter", ArgType.FLOAT, "Resize shorter edge.", 0.0, tensor_ok=True,
        per_sample=True
    ).AddOptionalArg("crop", ArgType.FLOAT_VEC, "Crop size (H, W).", None).AddOptionalArg(
        "crop_pos_x", ArgType.FLOAT, "Crop x position.", 0.5, tensor_ok=True, per_sample=True
    ).AddOptionalArg(
        "crop_pos_y", ArgType.FLOAT, "Crop y position.", 0.5, tensor_ok=True, per_sample=True
    ).AddOptionalArg(
        "mirror", ArgType.INT, "Horizontal mirror flag.", 0, tensor_ok=True, per_sample=True
    ).AddOptionalArg(
        "interp_type", ArgType.INTERP_TYPE, "Interpolation.", DALIInterpType.INTERP_LINEAR
    ).AddOptionalArg("antialias", ArgType.BOOL, "Antialiasing for downscaling.", True).AddOptionalArg(
        "mag_filter", ArgType.INTERP_TYPE, "Filter for upscaling.", None
    ).AddOptionalArg("min_filter", ArgType.INTERP_TYPE, "Filter for downscaling.", None).AddOptionalArg(
        "resize_longer", ArgType.FLOAT, "Resize longer edge.", 0.0, tensor_ok=True, per_sample=True
    ).AddOptionalArg(
        "size", ArgType.FLOAT_VEC, "Output size (H, W).", None, tensor_ok=True, per_sample=True
    ).AddOptionalArg(
        "mode", ArgType.STRING, '"default", "stretch", "not_larger", "not_smaller".', "default"
    ).AddOptionalArg(
        "roi_start", ArgType.FLOAT_VEC, "Input ROI origin.", None, tensor_ok=True, per_sample=True
    ).AddOptionalArg(
        "roi_end", ArgType.FLOAT_VEC, "Input ROI end.", None, tensor_ok=True, per_sample=True
    ).AddOptionalArg(
        "roi_relative", ArgType.BOOL, "ROI given in relative [0,1] coords.", False
    ).AddOptionalArg(
        "subpixel_scale", ArgType.BOOL, "Adjust scale for fractional sizes.", True
    ).AddOptionalArg(
        "crop_w", ArgType.FLOAT, "Crop width.", 0.0, tensor_ok=True, per_sample=True
    ).AddOptionalArg(
        "crop_h", ArgType.FLOAT, "Crop height.", 0.0, tensor_ok=True, per_sample=True
    ).AddOptionalArg("dtype", ArgType.DATA_TYPE, "Output dtype.", None).AddOptionalArg(
        "crop_d", ArgType.FLOAT, "Volumetric crop depth (unsupported here).", 0.0
    ).AddOptionalArg("crop_pos_z", ArgType.FLOAT, "Volumetric z pos.", 0.5).AddOptionalArg(
        "resize_z", ArgType.FLOAT, "Volumetric resize depth (unsupported here).", 0.0
    ).AddOptionalArg(
        "rounding", ArgType.STRING, 'Crop-start integer conversion: "round" or "truncate".',
        "round"
    ).AddOptionalArg(
        "minibatch_size", ArgType.INT, "Batching hint; accepted for compatibility.", 32
    ).AddOptionalArg(
        "temp_buffer_hint", ArgType.INT, "Scratch-size hint; accepted for compatibility.", 0)


_resize_crop_mirror_schema("ResizeCropMirror")
_resize_crop_mirror_schema("FastResizeCropMirror")


class _RCMCPU(SamplePool, Operator):
    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        # the reference's cpu op never reads them
        raise_unserved(spec, ("crop_d", "crop_pos_z", "resize_z", "subpixel_scale"))

    def run_sample(self, ctx, idx, img):
        spec = self.spec
        h, w = img.shape[:2]
        iy0 = ix0 = 0.0
        rs, re_ = ctx.arg(self, "roi_start", idx, None), ctx.arg(self, "roi_end", idx, None)
        if rs is not None or re_ is not None:
            rel = spec.GetArgument("roi_relative")
            s0 = np.asarray(rs if rs is not None else ([0.0, 0.0] if rel else [0, 0]), np.float64)
            e0 = np.asarray(re_ if re_ is not None else ([1.0, 1.0] if rel else [h, w]),
                            np.float64)
            if rel:
                s0, e0 = s0 * [h, w], e0 * [h, w]
            iy0, ix0 = float(s0[0]), float(s0[1])
            h = max(int(round(e0[0])) - int(round(s0[0])), 1)
            w = max(int(round(e0[1])) - int(round(s0[1])), 1)
        out_h, out_w = compute_resize_size(h, w, spec, lambda n, d=None: ctx.arg(self, n, idx, d))
        crop = spec.GetArgument("crop", None)
        if not crop:
            ch_ = int(np.asarray(ctx.arg(self, "crop_h", idx, 0.0)) or 0)
            cw_ = int(np.asarray(ctx.arg(self, "crop_w", idx, 0.0)) or 0)
            if ch_ and cw_:
                crop = [ch_, cw_]
        if crop:
            ch, cw = int(crop[0]), int(crop[1])
            py = float(np.asarray(ctx.arg(self, "crop_pos_y", idx, 0.5)))
            px = float(np.asarray(ctx.arg(self, "crop_pos_x", idx, 0.5)))
            rnd = spec.GetArgument("rounding")
            y = max(_crop_round(py * (out_h - ch), rnd), 0)
            x = max(_crop_round(px * (out_w - cw), rnd), 0)
            sy, sx = h / out_h, w / out_w
            roi_start, roi_size = (iy0 + y * sy, ix0 + x * sx), (ch * sy, cw * sx)
            to_h, to_w = ch, cw
        else:
            roi_start, roi_size = (iy0, ix0), (float(h), float(w))
            to_h, to_w = out_h, out_w
        dt = spec.GetArgument("dtype", None)
        out = host_resample(img, to_h, to_w, _pick_filter(spec, out_h < h or out_w < w),
                            spec.GetArgument("antialias"), roi_start, roi_size,
                            out_dtype=to_numpy_type(dt) if dt is not None else None)
        if out.ndim == 2:
            out = out[:, :, None]
        if int(np.asarray(ctx.arg(self, "mirror", idx, 0))):
            out = out[:, ::-1]
        return np.ascontiguousarray(out)

    def output_layout(self, j, inputs):
        return "HWC"


register_operator("ResizeCropMirror", "cpu")(type("ResizeCropMirrorCPU", (_RCMCPU,), {}))
register_operator("FastResizeCropMirror", "cpu")(
    type("FastResizeCropMirrorCPU", (_RCMCPU,), {}))


class _RCMGPU(Operator):
    """Resize, crop and mirror as one resample with a per-sample input ROI:
    the crop window maps back through each sample's resize scale (host
    parameters), then ``resample_batch`` reads only that window. The crop
    extent fixes the output canvas, so it must be a constant; without a crop
    the batch's output size must be uniform. A mirror flips the columns of
    the result (a tensor argument per sample, or a constant)."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        raise_unserved(spec, ("crop_d", "resize_z"))
        self._filter = None  # the filter override, latched on the first batch
        self._nocrop_ohw = None

    def _crop_size(self):
        crop = self.spec.GetArgument("crop", None)
        if crop:
            return int(crop[0]), int(crop[1])
        for nm in ("crop_h", "crop_w"):
            if nm in self.spec.arg_inputs:
                raise ValueError(
                    f"{self.spec.schema_name}(gpu): per-sample tensor {nm} is cpu-only (the "
                    "crop extent fixes the device output shape)")
        ch = int(self.spec.GetArgument("crop_h") or 0)
        cw = int(self.spec.GetArgument("crop_w") or 0)
        if ch and cw:
            return ch, cw
        return None  # no crop: a pure resize

    def host_params(self, ctx, input_shapes):
        shapes = input_shapes[0]
        if shapes is None:
            raise RuntimeError(f"{self.spec.schema_name}(gpu) requires its input's shapes to be "
                               "known on the host")
        cs = self._crop_size()
        n = shapes.shape[0]
        roi = np.zeros((n, 4), np.float32)  # y0, x0, h, w in input pixels
        out_sizes = np.zeros((n, 2), np.int32)
        rnd = self.spec.GetArgument("rounding")
        rel = self.spec.GetArgument("roi_relative")
        for i in range(n):
            h, w = int(shapes[i][0]), int(shapes[i][1])
            iy0, ix0 = 0.0, 0.0
            rs = ctx.arg(self, "roi_start", i, None)
            re_ = ctx.arg(self, "roi_end", i, None)
            if rs is not None or re_ is not None:
                s0 = np.asarray(rs if rs is not None else ([0.0, 0.0] if rel else [0, 0]),
                                np.float64)
                e0 = np.asarray(re_ if re_ is not None else ([1.0, 1.0] if rel else [h, w]),
                                np.float64)
                if rel:
                    s0, e0 = s0 * [h, w], e0 * [h, w]
                iy0, ix0 = float(s0[0]), float(s0[1])
                h = max(int(round(e0[0])) - int(round(s0[0])), 1)
                w = max(int(round(e0[1])) - int(round(s0[1])), 1)
            oh, ow = compute_resize_size(h, w, self.spec,
                                         lambda nm, d=None: ctx.arg(self, nm, i, d))
            out_sizes[i] = (oh, ow)
            if cs is None:
                roi[i] = (iy0, ix0, h, w)
                continue
            ch, cw = cs
            py = float(np.asarray(ctx.arg(self, "crop_pos_y", i, 0.5)))
            px = float(np.asarray(ctx.arg(self, "crop_pos_x", i, 0.5)))
            y = max(_crop_round(py * (oh - ch), rnd), 0)
            x = max(_crop_round(px * (ow - cw), rnd), 0)
            sy, sx = h / oh, w / ow
            roi[i] = (iy0 + y * sy, ix0 + x * sx, ch * sy, cw * sx)
        if cs is None:
            ohw = {(int(r[0]), int(r[1])) for r in out_sizes}
            if len(ohw) > 1:
                raise ValueError(f"{self.spec.schema_name}(gpu) without `crop` needs a "
                                 "batch-uniform output size; use fn.resize for per-sample sizes")
            self._nocrop_ohw = next(iter(ohw))
        if self._filter is None and (self.spec.GetArgument("mag_filter") is not None
                                     or self.spec.GetArgument("min_filter") is not None):
            ohw = (np.tile(np.array([cs], np.float32), (n, 1)) if cs
                   else out_sizes.astype(np.float32))
            down = int((roi[:, 2] > ohw[:, 0]).sum() + (roi[:, 3] > ohw[:, 1]).sum())
            up = int((roi[:, 2] < ohw[:, 0]).sum() + (roi[:, 3] < ohw[:, 1]).sum())
            self._filter = int(_pick_filter(self.spec, down >= up))
        return {"rcm_roi": roi}

    def device_statics(self, ctx, input_shapes, input_batches):
        cs = self._crop_size()
        return (*(cs if cs is not None else self._nocrop_ohw), self._filter)

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        sh = input_shapes[0] if input_shapes else None
        if sh is None or np.asarray(sh).shape[1] != 3:
            return None
        sh = np.asarray(sh).astype(np.int64)
        hw = self._crop_size() or self._nocrop_ohw
        return [np.concatenate([np.tile(np.array([hw], np.int64), (sh.shape[0], 1)), sh[:, 2:]],
                               1)]

    def host_output_layouts(self, in_layouts):
        return [(in_layouts[0] if in_layouts else "") or "HWC"]

    def lower(self, dctx, inp: DeviceBatch):
        out_h, out_w, filt = dctx.static(self)
        spec = self.spec
        interp = DALIInterpType(filt if filt is not None else spec.GetArgument("interp_type"))
        dt = spec.GetArgument("dtype", None)
        roi = dctx.param(self, "rcm_roi")
        data = resample_kernel.resample_batch(
            inp.data, inp.shapes, roi[:, 0:2], roi[:, 2:4], out_h, out_w, interp,
            bool(spec.GetArgument("antialias")),
            to_torch_type(dt) if dt is not None else inp.data.dtype)
        mirror = dctx.arg(self, "mirror", 0)
        if dctx.has_tensor_arg(self, "mirror"):
            m = mirror.to(data.device).reshape(-1).to(torch.bool)
            data = torch.where(m[:, None, None, None], data.flip(2), data)
        elif int(np.asarray(mirror)):
            data = data.flip(2)
        return [DeviceBatch(data, None, inp.layout or "HWC")]


register_operator("ResizeCropMirror", "gpu")(type("ResizeCropMirrorGPU", (_RCMGPU,), {}))
register_operator("FastResizeCropMirror", "gpu")(type("FastResizeCropMirrorGPU", (_RCMGPU,), {}))


# ====================================== Filter (gpu) ==================================================


def _reflect101(idx: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
    """Indices reflected into [0, ext) without repeating the edge
    (``reflect_101``); idx [N, L] int64, ext [N, 1]."""
    period = torch.clamp(2 * ext - 2, min=1)
    r = torch.remainder(idx, period)
    return torch.where(r >= ext, period - r, r).clamp(max=ext - 1).clamp(min=0)


@register_operator("experimental.Filter", "gpu")
class FilterGPU(Operator):
    """2-D correlation of each sample with its own kernel [kh, kw] (the
    second input), anchored at the kernel's centre, with a ``reflect_101``
    border within each sample's valid extent: one gather and one float32
    multiply-add per tap, in ascending (row, column) order, so no
    convolution library (and no TF32) touches the values. The reference's
    lowering serves neither ``anchor``, ``border``, ``mode``, ``fill_value``,
    ``dtype`` nor the fill input, and reflects at the canvas edge of a
    ragged batch (ROADMAP.md Queue 3); here the first raise."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        raise_unserved(spec, ("anchor", "border", "mode", "fill_value", "dtype"))

    def host_params(self, ctx, input_shapes):
        if len(input_shapes) > 2:
            raise NotImplementedError("experimental.Filter(gpu): the fill input is not served on "
                                      "the device; see ROADMAP.md (Queue 3)")
        ks = input_shapes[1]
        if ks is not None and len({tuple(r[:2]) for r in np.asarray(ks).tolist()}) > 1:
            raise NotImplementedError("experimental.Filter(gpu): kernels of different sizes in "
                                      "one batch; see ROADMAP.md (Queue 3)")
        return {}

    def lower(self, dctx, img_b: DeviceBatch, kern_b: DeviceBatch, *fill):
        x = img_b.data
        squeeze = x.dim() == 3
        if squeeze:
            x = x[..., None]
        n, H, W = x.shape[:3]
        dev = x.device
        k = kern_b.data.to(torch.float32)
        kh, kw = int(k.shape[1]), int(k.shape[2])
        ph, pw = kh // 2, kw // 2
        eh = img_b.extent(0).to(torch.int64)[:, None]
        ew = img_b.extent(1).to(torch.int64)[:, None]
        rows = torch.arange(H, device=dev)[None]
        cols = torch.arange(W, device=dev)[None]
        nidx = torch.arange(n, device=dev)[:, None, None]
        acc = None
        for i in range(kh):
            iy = _reflect101(rows + (i - ph), eh)[:, :, None]
            for j in range(kw):
                ix = _reflect101(cols + (j - pw), ew)[:, None, :]
                term = x[nidx, iy, ix].to(torch.float32) * k[:, i, j].reshape(n, 1, 1, 1)
                acc = term if acc is None else acc + term
        out = saturate(acc, x.dtype)
        return [img_b.with_data(out[..., 0] if squeeze else out)]
