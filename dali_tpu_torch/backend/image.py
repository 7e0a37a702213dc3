"""Resize, RandomResizedCrop, CropMirrorNormalize and Flip on the device
and on the host (counterpart of ``dali_tpu/backend/image.py``).

The device ops run the torch resampler (``kernels/resample.py``) and the
CMN kernel (``kernels/cmn.py``); the host ops run numpy, in the reference's
order of operations (``kernels/host_resample.py`` for the resamples). What
the port does not run (Resize ROI, tensor crop sizes of CMN) raises
``NotImplementedError`` pointing to ROADMAP.md.
"""

from __future__ import annotations

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch, HostBatch
from ..kernels import cmn as cmn_kernel
from ..kernels import resample as resample_kernel
from ..kernels.host_resample import host_resample, host_resample_volume
from ..types import DALIDataType, DALIImageType, DALIInterpType, to_numpy_type, to_torch_type
from .base import Operator, SamplePool, raise_unserved
from .decoders import sample_rrc_window
from .generic2 import _crop_round, _crop_round_torch


def _not_ported(what: str, item: str = "Queue 1"):
    return NotImplementedError(f"{what} is not ported to dali_tpu_torch yet; see ROADMAP.md ({item})")


# what dali_tpu runs only on the cpu, as the port's Resize(cpu) does
_CPU_ONLY = "Queue 1, item 5h.7; dali_tpu runs this on the cpu only"


def _fold_frames(inp: DeviceBatch):
    """Fold the frame dim of an FHWC batch into the batch dim, so 2-D image
    code applies per frame (reference ``_fold_frames``). Ragged batches fold
    their per-sample (H, W, C) extents per frame. Returns (folded batch,
    unfold), where unfold(db) restores [N, F, ...]; unfold is None when the
    layout has no leading F."""
    if not (inp.layout or "").startswith("F"):
        return inp, None
    n, f = inp.data.shape[0], inp.data.shape[1]
    fsh = None if inp.shapes is None else torch.repeat_interleave(inp.shapes[:, 1:], f, dim=0)
    folded = DeviceBatch(inp.data.reshape(n * f, *inp.data.shape[2:]), fsh, inp.layout[1:])

    def unfold(db: DeviceBatch) -> DeviceBatch:
        sh = None
        if db.shapes is not None:
            per = db.shapes[::f]
            fcol = (inp.shapes[:, :1] if inp.shapes is not None
                    else torch.full((n, 1), f, dtype=torch.int32, device=per.device))
            sh = torch.cat([fcol.to(per.dtype), per], 1)
        elif inp.shapes is not None:
            hw = torch.tensor([list(db.data.shape[1:])], dtype=torch.int32,
                              device=inp.shapes.device).expand(n, -1)
            sh = torch.cat([inp.shapes[:, :1].to(torch.int32), hw], 1)
        layout = db.layout or inp.layout[1:] or "HWC"
        return DeviceBatch(db.data.reshape(n, f, *db.data.shape[1:]), sh,
                           layout if layout.startswith("F") else "F" + layout)

    return folded, unfold


# =================================== Resize =====================================================

_resize = DALI_SCHEMA("Resize").DocStr(
    """Resizes images, sequences (FHWC, per frame) and volumes (DHWC) with
    static or per-sample sizes (reference image/resize/resize.cc,
    resize_attr.cc). The device path is the separable resampler of
    kernels/resample.py."""
).NumInput(1).OutputFn(lambda spec: 1 + int(bool(spec.GetArgument("save_attrs", False)))
                       ).Devices("cpu", "gpu")
for _args in (
    ("resize_x", ArgType.FLOAT, "Output width (0 = keep aspect).", 0.0, True),
    ("resize_y", ArgType.FLOAT, "Output height (0 = keep aspect).", 0.0, True),
    ("resize_z", ArgType.FLOAT, "Output depth (volumes).", 0.0, True),
    ("resize_shorter", ArgType.FLOAT, "Resize shorter edge, keep aspect.", 0.0, True),
    ("resize_longer", ArgType.FLOAT, "Resize longer edge, keep aspect.", 0.0, True),
    ("size", ArgType.FLOAT_VEC, "Output size (H, W), or (D, H, W) for volumes.", None, True),
    ("mode", ArgType.STRING, '"default", "stretch", "not_larger", "not_smaller".', "default", False),
    ("interp_type", ArgType.INTERP_TYPE, "Interpolation filter.", DALIInterpType.INTERP_LINEAR, False),
    ("mag_filter", ArgType.INTERP_TYPE, "Filter for upscaling.", None, False),
    ("min_filter", ArgType.INTERP_TYPE, "Filter for downscaling.", None, False),
    ("antialias", ArgType.BOOL, "Antialiasing for downscaling.", True, False),
    ("dtype", ArgType.DATA_TYPE, "Output dtype (default: input dtype).", None, False),
    ("max_size", ArgType.FLOAT_VEC, "Upper bound on output size.", None, False),
    ("roi_start", ArgType.FLOAT_VEC, "Input ROI origin.", None, True),
    ("roi_end", ArgType.FLOAT_VEC, "Input ROI end.", None, True),
    ("roi_relative", ArgType.BOOL, "ROI in relative coordinates.", False, False),
    ("save_attrs", ArgType.BOOL, "Second output with each sample's input shape (int32).", False,
     False),
    ("minibatch_size", ArgType.INT, "Compatibility hint.", 32, False),
    ("temp_buffer_hint", ArgType.INT, "Compatibility hint.", 0, False),
    ("subpixel_scale", ArgType.BOOL, "Compatibility flag.", True, False),
):
    _resize.AddOptionalArg(*_args[:4], tensor_ok=_args[4], per_sample=_args[4])


def _apply_max_size(spec, oh, ow):
    """Cap keep-aspect outputs at ``max_size`` (a scalar or (H, W) bound;
    scales down keeping the aspect)."""
    ms = spec.GetArgument("max_size", None)
    if not ms:
        return oh, ow
    ms = np.asarray(ms, np.float64).reshape(-1)
    mh, mw = (float(ms[0]), float(ms[-1])) if ms.size > 1 else (float(ms[0]),) * 2
    r = min((mh / oh) if mh > 0 else 1.0, (mw / ow) if mw > 0 else 1.0, 1.0)
    if r < 1.0:
        return max(1, round(oh * r)), max(1, round(ow * r))
    return oh, ow


def compute_volumetric_sizes(spec, sample_arg, d, h, w):
    """(out_d, out_h, out_w) of a DHWC input: a 3-element ``size`` (D, H,
    W), or resize_x / resize_y / resize_z; the keep-aspect 2-D modes are
    rejected."""
    size = sample_arg("size", None)
    if size is not None:
        sz = np.asarray(size, np.float64).reshape(-1)
        if sz.size != 3:
            raise ValueError("Resize: volumetric (DHWC) inputs need a 3-element `size` (D, H, W)")
        return (max(1, round(float(sz[0]))), max(1, round(float(sz[1]))),
                max(1, round(float(sz[2]))))
    if float(sample_arg("resize_shorter", 0.0) or 0.0) or \
            float(sample_arg("resize_longer", 0.0) or 0.0):
        raise NotImplementedError(
            "Resize: resize_shorter/resize_longer are 2-D modes; volumetric inputs need `size` "
            "(D, H, W) or resize_x/resize_y/resize_z")
    oh, ow = compute_resize_size(h, w, spec, sample_arg)
    rz = float(sample_arg("resize_z", 0.0) or 0.0)
    od = max(1, round(rz)) if rz > 0 else d
    return od, oh, ow


def compute_resize_size(in_h, in_w, spec, sample_arg, mode=None):
    """Output (h, w) from the Resize arguments (the reference's ResizeAttr
    logic, resize_attr.cc), ``max_size`` capping the keep-aspect modes."""
    rx = float(sample_arg("resize_x", 0.0) or 0.0)
    ry = float(sample_arg("resize_y", 0.0) or 0.0)
    rs = float(sample_arg("resize_shorter", 0.0) or 0.0)
    rl = float(sample_arg("resize_longer", 0.0) or 0.0)
    size = sample_arg("size", None)
    mode = mode or spec.GetArgument("mode", "default")
    if size is not None:
        sz = np.asarray(size, dtype=np.float64).reshape(-1)
        if sz.size == 1:
            ry = rx = float(sz[0])
        else:
            ry, rx = float(sz[0]), float(sz[1])
    if rs > 0:
        scale = rs / min(in_h, in_w)
        return _apply_max_size(spec, max(1, round(in_h * scale)), max(1, round(in_w * scale)))
    if rl > 0:
        scale = rl / max(in_h, in_w)
        return _apply_max_size(spec, max(1, round(in_h * scale)), max(1, round(in_w * scale)))
    if rx > 0 and ry > 0:
        if mode == "not_larger":
            scale = min(rx / in_w, ry / in_h)
            return _apply_max_size(spec, max(1, round(in_h * scale)), max(1, round(in_w * scale)))
        if mode == "not_smaller":
            scale = max(rx / in_w, ry / in_h)
            return _apply_max_size(spec, max(1, round(in_h * scale)), max(1, round(in_w * scale)))
        return max(1, round(ry)), max(1, round(rx))
    if rx > 0:
        scale = rx / in_w
        return _apply_max_size(spec, max(1, round(in_h * scale)), max(1, round(rx)))
    if ry > 0:
        scale = ry / in_h
        return _apply_max_size(spec, max(1, round(ry)), max(1, round(in_w * scale)))
    raise ValueError("Resize requires one of: size, resize_x/y, resize_shorter/longer")


def _pick_filter(spec, scale_down):
    """min_filter for a downscale, mag_filter for an upscale, else
    interp_type (reference ResamplingFilterAttr)."""
    f = spec.GetArgument("min_filter" if scale_down else "mag_filter", None)
    if f is None:
        f = spec.GetArgument("interp_type", DALIInterpType.INTERP_LINEAR)
    return f


def _out_dtype(spec, inp: DeviceBatch):
    dt = spec.GetArgument("dtype", None)
    return to_torch_type(dt) if dt is not None else inp.data.dtype


@register_operator("Resize", "gpu")
class ResizeGPU(Operator):
    """Device resize.

    * Static sizes (resize_x and resize_y, or ``size``, as constants): one
      output size, no host work; sequences resize per frame.
    * Per-sample sizes (resize_shorter / resize_longer, a one-sided size, the
      keep-aspect modes, tensor size arguments): sizes computed on the host
      each iteration and copied as the ``out_sizes`` parameter; each output
      sits in the front of a grow-only canvas (aligned to 32).
    * DHWC volumes: one batch-uniform size, three separable products.
    """

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        if spec.HasArgument("roi_start") or spec.HasArgument("roi_end") or \
                spec.GetArgument("roi_relative"):
            raise _not_ported(
                "Resize(gpu) roi_start/roi_end/roi_relative (dali_tpu's ResizeGPU declares them "
                "but never reads them)", "Queue 3, found in the reference")
        self._grow_canvas = [0, 0]
        self._taps_latch = [0, 0]
        self._filter = None  # the filter override, latched on the first batch
        self._last_out_sizes = None

    def _static_size(self):
        """(h, w) when the output size is a batch-invariant constant, else None."""
        spec = self.spec
        if any(nm in spec.arg_inputs for nm in
               ("resize_x", "resize_y", "resize_shorter", "resize_longer", "size")):
            return None
        if spec.GetArgument("resize_shorter") or spec.GetArgument("resize_longer"):
            return None
        if spec.GetArgument("mode") in ("not_larger", "not_smaller"):
            return None
        rx = float(spec.GetArgument("resize_x") or 0.0)
        ry = float(spec.GetArgument("resize_y") or 0.0)
        size = spec.GetArgument("size", None)
        if size is not None:
            sz = np.asarray(size, np.float64).reshape(-1)
            ry, rx = (float(sz[0]), float(sz[-1])) if sz.size > 1 else (float(sz[0]),) * 2
        if rx > 0 and ry > 0:
            return int(round(ry)), int(round(rx))
        return None

    def _has_filter_override(self):
        return (self.spec.GetArgument("mag_filter", None) is not None
                or self.spec.GetArgument("min_filter", None) is not None)

    def _choose_filter(self, in_hw, out_hw):
        """Latch the filter override for the whole batch from the majority
        scaling direction of the first batch (the reference's choice: a
        per-batch flip would recompile its device program)."""
        if self._filter is None and self._has_filter_override():
            down = int((out_hw[:, 0] < in_hw[:, 0]).sum() + (out_hw[:, 1] < in_hw[:, 1]).sum())
            up = int((out_hw[:, 0] > in_hw[:, 0]).sum() + (out_hw[:, 1] > in_hw[:, 1]).sum())
            self._filter = int(_pick_filter(self.spec, down >= up))

    def _volumetric_out(self, shapes):
        """(out_d, out_h, out_w, filter) of a DHWC batch: batch-uniform only."""
        spec = self.spec
        if any(nm in spec.arg_inputs for nm in
               ("resize_x", "resize_y", "resize_z", "resize_shorter", "resize_longer", "size")):
            raise _not_ported("Resize(gpu) per-sample sizes on volumetric (DHWC) inputs", _CPU_ONLY)
        outs = {compute_volumetric_sizes(spec, lambda nm, dv=None: spec.GetArgument(nm, dv),
                                         max(int(r[0]), 1), max(int(r[1]), 1), max(int(r[2]), 1))
                for r in np.asarray(shapes)}
        if len(outs) != 1:
            raise _not_ported("Resize(gpu) with per-sample output sizes on volumes", _CPU_ONLY)
        od, oh, ow = next(iter(outs))
        filt = None
        if self._has_filter_override():
            sh = np.asarray(shapes).astype(np.float64)
            filt = int(_pick_filter(spec, od * oh * ow < float(np.median(sh[:, 0] * sh[:, 1] *
                                                                         sh[:, 2]))))
        return od, oh, ow, filt

    # -- host side ------------------------------------------------------------------------
    def host_params(self, ctx, input_shapes):
        shapes = input_shapes[0]
        if shapes is not None and np.asarray(shapes).shape[1] >= 4:
            return {}  # a DHWC volume or an FHWC sequence: statics resolve it
        if self.spec.GetArgument("resize_z") or "resize_z" in self.spec.arg_inputs:
            raise NotImplementedError("Resize(gpu): resize_z applies to volumetric (DHWC) inputs")
        static = self._static_size()
        if static is not None:
            if shapes is not None:
                self._choose_filter(np.asarray(shapes)[:, :2],
                                    np.tile(np.array([static]), (len(shapes), 1)))
            return {}
        if shapes is None:
            raise RuntimeError("Resize(gpu) with per-sample sizes requires its input's shapes to "
                               "be known on the host")
        n = shapes.shape[0]
        out = np.zeros((n, 2), dtype=np.int32)
        for i in range(n):
            out[i] = compute_resize_size(int(shapes[i][0]), int(shapes[i][1]), self.spec,
                                         lambda nm, d=None: ctx.arg(self, nm, i, d))
        self._last_out_sizes = out
        in_hw = np.asarray(shapes)[:, :2]
        self._choose_filter(in_hw, out)
        for k in (0, 1):
            self._grow_canvas[k] = max(self._grow_canvas[k], int(-(-out[:, k].max() // 32) * 32))
        # the tap bound covers the true per-sample scale in/out (each output
        # is packed into a larger canvas, whose ratio under-counts the taps of
        # a heavy downscale); it only grows, like the canvas
        interp = (DALIInterpType(self._filter) if self._filter is not None
                  else self.spec.GetArgument("interp_type"))
        aa = bool(self.spec.GetArgument("antialias"))
        for k in (0, 1):
            scale = float((in_hw[:, k].astype(np.float64) / np.maximum(out[:, k], 1)).max())
            self._taps_latch[k] = max(self._taps_latch[k],
                                      resample_kernel.max_taps(interp, scale, aa))
        return {"out_sizes": out}

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        sh = input_shapes[0] if input_shapes else None
        if sh is None:
            return None
        sh = np.asarray(sh).astype(np.int64)
        n = sh.shape[0]
        static = self._static_size()
        if sh.shape[1] == 4 and (ctx.in_layouts(self) or [""])[0].startswith("F"):
            if static is None:
                return None
            hw = np.tile(np.array([static], np.int64), (n, 1))
            return [np.concatenate([sh[:, :1], hw, sh[:, 3:4]], 1)]
        if sh.shape[1] != 3:
            return None  # volumes: a uniform output, resolved in the statics
        if static is not None:
            hw = np.tile(np.array([static], np.int64), (n, 1))
        elif self._last_out_sizes is not None:
            hw = self._last_out_sizes.astype(np.int64)
        else:
            return None
        out = [np.concatenate([hw, sh[:, 2:3]], 1)]
        if self.spec.GetArgument("save_attrs"):
            out.append(np.full((n, 1), 2, np.int64))
        return out

    def device_statics(self, ctx, input_shapes, input_batches):
        shapes = input_shapes[0]
        if shapes is not None and np.asarray(shapes).shape[1] >= 4:
            if (ctx.in_layouts(self) or [""])[0].startswith("D"):
                return ("vol",) + self._volumetric_out(shapes)
            if self._static_size() is None:
                raise _not_ported("Resize(gpu) per-sample sizes on sequences", _CPU_ONLY)
            return None if self._filter is None else ("filt", self._filter)
        if self._static_size() is not None:
            return None if self._filter is None else ("filt", self._filter)
        return (self._grow_canvas[0], self._grow_canvas[1], self._filter) + tuple(
            self._taps_latch)

    # -- device side ----------------------------------------------------------------------
    def _attrs(self, inp: DeviceBatch, k: int) -> DeviceBatch:
        if inp.shapes is not None:
            a = inp.shapes[:, :k].to(torch.int32)
        else:
            a = torch.tensor([list(inp.data.shape[1:1 + k])], dtype=torch.int32,
                             device=inp.data.device).expand(inp.data.shape[0], k).contiguous()
        return DeviceBatch(a, None, "")

    def lower(self, dctx, inp: DeviceBatch):
        spec = self.spec
        save_attrs = bool(spec.GetArgument("save_attrs"))
        antialias = bool(spec.GetArgument("antialias"))
        out_dtype = _out_dtype(spec, inp)
        st = dctx.static(self)
        if inp.data.dim() == 5 and (inp.layout or "").startswith("D"):
            if not (isinstance(st, tuple) and st and st[0] == "vol"):
                raise RuntimeError("Resize(gpu): volumetric inputs need host-known shapes")
            _, od, oh, ow, filt = st
            interp = DALIInterpType(filt if filt is not None else spec.GetArgument("interp_type"))
            data = resample_kernel.resample_volume_batch(
                inp.data, None if inp.shapes is None else inp.shapes[:, :3], od, oh, ow, interp,
                antialias, out_dtype)
            outs = [DeviceBatch(data, None, inp.layout or "DHWC")]
            return outs + [self._attrs(inp, 3)] if save_attrs else outs

        folded, unfold = _fold_frames(inp)
        if unfold is not None:
            outs = self.lower(dctx, folded)
            ret = [unfold(outs[0])]
            if len(outs) > 1:  # save_attrs: one row per sequence, not per frame
                n, f = inp.data.shape[:2]
                ret.append(DeviceBatch(outs[1].data.reshape(n, f, -1)[:, 0, :], None, ""))
            return ret
        if inp.data.dim() != 4:
            raise _not_ported(f"Resize(gpu) on {inp.data.dim() - 1}-D samples")

        interp = DALIInterpType(spec.GetArgument("interp_type"))
        static = self._static_size()
        if static is not None:
            if isinstance(st, tuple) and st[0] == "filt":
                interp = DALIInterpType(st[1])
            data = resample_kernel.resample_batch(inp.data, inp.shapes, None, None, *static,
                                                  interp, antialias, out_dtype)
            outs = [DeviceBatch(data, None, inp.layout or "HWC")]
            return outs + [self._attrs(inp, 2)] if save_attrs else outs
        # per-sample sizes: sample k's output fills the front (h_k, w_k) of
        # the canvas, so its ROI stretches by canvas/out_k
        max_h, max_w, filt, taps_y, taps_x = st
        if filt is not None:
            interp = DALIInterpType(filt)
        sizes = dctx.param(self, "out_sizes")
        ext = torch.stack([inp.extent(0), inp.extent(1)], 1)
        roi_size = ext.to(torch.float32) * torch.stack(
            [max_h / sizes[:, 0].to(torch.float32), max_w / sizes[:, 1].to(torch.float32)], 1)
        data = resample_kernel.resample_batch(inp.data, ext, None, roi_size, max_h, max_w, interp,
                                              antialias, out_dtype, taps_y=taps_y or None,
                                              taps_x=taps_x or None)
        out_shapes = torch.cat([sizes.to(torch.int32),
                                torch.full_like(sizes[:, :1], inp.data.shape[3], dtype=torch.int32)],
                               1)
        outs = [DeviceBatch(data, out_shapes, inp.layout or "HWC")]
        return outs + [self._attrs(inp, 2)] if save_attrs else outs


# ============================== RandomResizedCrop ===============================================

DALI_SCHEMA("RandomResizedCrop").DocStr(
    """Random area/aspect crop + resize to a fixed size (reference
    image/resize/random_resized_crop.cc). The windows are drawn on the host
    (Philox, checkpointable); the crop and the resize are one device
    resample with a per-sample ROI."""
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddRandomSeedArg().AddArg(
    "size", ArgType.INT_VEC, "Output size (H, W)."
).AddOptionalArg(
    "random_area", ArgType.FLOAT_VEC, "Crop area range (fraction of input).", [0.08, 1.0]
).AddOptionalArg(
    "random_aspect_ratio", ArgType.FLOAT_VEC, "Aspect ratio range.", [3 / 4, 4 / 3]
).AddOptionalArg(
    "num_attempts", ArgType.INT, "Sampling attempts.", 10
).AddOptionalArg(
    "interp_type", ArgType.INTERP_TYPE, "Interpolation filter.", DALIInterpType.INTERP_LINEAR
).AddOptionalArg(
    "antialias", ArgType.BOOL, "Antialiasing when downscaling.", True
).AddOptionalArg(
    "dtype", ArgType.DATA_TYPE, "Output dtype.", None
).AddOptionalArg(
    "mag_filter", ArgType.INTERP_TYPE, "Filter for upscaling.", None
).AddOptionalArg(
    "min_filter", ArgType.INTERP_TYPE, "Filter for downscaling.", None
).AddOptionalArg(
    "minibatch_size", ArgType.INT, "Compatibility hint.", 32
).AddOptionalArg(
    "temp_buffer_hint", ArgType.INT, "Compatibility hint.", 0
)


@register_operator("RandomResizedCrop", "gpu")
class RandomResizedCropGPU(Operator):
    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._filter = None
        size = spec.GetArgument("size")
        self.out_hw = (int(size[0]), int(size[-1]))

    def host_params(self, ctx, input_shapes):
        shapes = input_shapes[0]
        if shapes is None:
            raise RuntimeError("RandomResizedCrop(gpu) requires its input's shapes to be known "
                               "on the host")
        spec = self.spec
        rng = ctx.rng(self)
        wins = np.zeros((len(shapes), 4), dtype=np.float32)  # y, x, h, w
        for i, row in enumerate(shapes):
            wins[i] = sample_rrc_window(rng, int(row[0]), int(row[1]),
                                        spec.GetArgument("random_area"),
                                        spec.GetArgument("random_aspect_ratio"),
                                        spec.GetArgument("num_attempts"))
        if spec.GetArgument("mag_filter", None) is not None or \
                spec.GetArgument("min_filter", None) is not None:
            # latched on the first batch, as Resize's
            if self._filter is None:
                oh, ow = self.out_hw
                down = int((wins[:, 2] > oh).sum() + (wins[:, 3] > ow).sum())
                up = int((wins[:, 2] < oh).sum() + (wins[:, 3] < ow).sum())
                self._filter = int(_pick_filter(spec, down >= up))
        return {"windows": wins}

    def device_statics(self, ctx, input_shapes, input_batches):
        return self._filter

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        sh = input_shapes[0] if input_shapes else None
        if sh is None or np.asarray(sh).shape[1] != 3:
            return None
        sh = np.asarray(sh).astype(np.int64)
        hw = np.tile(np.array([self.out_hw], np.int64), (sh.shape[0], 1))
        return [np.concatenate([hw, sh[:, 2:3]], 1)]

    def lower(self, dctx, inp: DeviceBatch):
        spec = self.spec
        filt = dctx.static(self)
        interp = DALIInterpType(filt if filt is not None else spec.GetArgument("interp_type"))
        wins = dctx.param(self, "windows")
        data = resample_kernel.resample_batch(
            inp.data, inp.shapes, wins[:, 0:2], wins[:, 2:4], *self.out_hw, interp,
            bool(spec.GetArgument("antialias")), _out_dtype(spec, inp))
        return [DeviceBatch(data, None, inp.layout or "HWC")]


@register_operator("Resize", "cpu")
class ResizeCPU(SamplePool, Operator):
    """Per sample on the host resampler (``kernels/host_resample.py``), on
    the pipeline's threads: HW(C) images, and DHWC volumes (4-D samples)
    with per-sample sizes, each slice resampled in float32, then the depth
    pass and one quantization. The filter override is picked per sample."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        # dali_tpu's ResizeCPU never reads these (ROADMAP.md Queue 3)
        raise_unserved(spec, ("dtype", "roi_start", "roi_end", "roi_relative"))

    def run_sample(self, ctx, idx, img):
        spec = self.spec
        antialias = bool(spec.GetArgument("antialias"))

        def sample_arg(nm, dv=None):
            return ctx.arg(self, nm, idx, dv)

        if img.ndim == 4:
            d, h, w = img.shape[:3]
            out_d, out_h, out_w = compute_volumetric_sizes(spec, sample_arg, d, h, w)
            interp = _pick_filter(spec, out_d * out_h * out_w < d * h * w)
            out = host_resample_volume(img, out_d, out_h, out_w, interp, antialias)
        else:
            h, w = img.shape[:2]
            out_h, out_w = compute_resize_size(h, w, spec, sample_arg)
            interp = _pick_filter(spec, out_h < h or out_w < w)
            out = host_resample(img, out_h, out_w, interp, antialias)
            if out.ndim == 2:
                out = out[:, :, None]
        out = np.ascontiguousarray(out)
        if spec.GetArgument("save_attrs"):
            return out, np.array([d, h, w] if img.ndim == 4 else [h, w], np.int32)
        return out

    def output_layout(self, output_idx, inputs):
        return "" if output_idx else (inputs[0].layout if inputs else "")


@register_operator("RandomResizedCrop", "cpu")
class RandomResizedCropCPU(SamplePool, Operator):
    """The gpu op's windows (one Philox stream per batch), each cropped and
    resampled on the host, on the pipeline's threads; the filter override is
    picked per sample."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        raise_unserved(spec, ("dtype",))  # dali_tpu's RandomResizedCropCPU never reads it
        size = spec.GetArgument("size")
        self.out_hw = (int(size[0]), int(size[-1]))

    def run_batch(self, ctx, inp: HostBatch):
        spec = self.spec
        rng = ctx.rng(self)
        wins = [sample_rrc_window(rng, int(r[0]), int(r[1]), spec.GetArgument("random_area"),
                                  spec.GetArgument("random_aspect_ratio"),
                                  spec.GetArgument("num_attempts"))
                for r in inp.shapes()]
        out_h, out_w = self.out_hw
        antialias = bool(spec.GetArgument("antialias"))

        def one(i):
            y, x, h, w = (int(v) for v in wins[i])
            interp = _pick_filter(spec, out_h < h or out_w < w)
            out = host_resample(inp.samples[i][y:y + h, x:x + w], out_h, out_w, interp, antialias)
            return out[:, :, None] if out.ndim == 2 else out

        return [HostBatch(self.map_samples(one, len(inp)), layout=inp.layout or "HWC")]


_cmn = DALI_SCHEMA("CropMirrorNormalize").DocStr(
    """Fused crop + horizontal mirror + normalize + cast + layout transform:
    out = scale * (in - mean) / std + shift. On the device the uint8 -> CHW
    case runs the hand-written CUDA kernel (kernels/cmn.py)."""
).NumInput(1).NumOutput(1).Devices("cpu", "gpu")
for _args in (
    ("crop", ArgType.FLOAT_VEC, "Crop size (H, W).", None, False),
    ("crop_h", ArgType.FLOAT, "Crop height.", 0.0, True),
    ("crop_w", ArgType.FLOAT, "Crop width.", 0.0, True),
    ("crop_d", ArgType.FLOAT, "Volumetric crop depth.", 0.0, True),
    ("crop_pos_x", ArgType.FLOAT, "Window x position in [0, 1].", 0.5, True),
    ("crop_pos_y", ArgType.FLOAT, "Window y position in [0, 1].", 0.5, True),
    ("crop_pos_z", ArgType.FLOAT, "Volumetric window z in [0, 1].", 0.5, True),
    ("mirror", ArgType.INT, "Horizontal flip flag.", 0, True),
    ("mean", ArgType.FLOAT_VEC, "Per-channel mean.", [0.0], False),
    ("std", ArgType.FLOAT_VEC, "Per-channel std.", [1.0], False),
    ("scale", ArgType.FLOAT, "Output scaling factor.", 1.0, False),
    ("shift", ArgType.FLOAT, "Output shift.", 0.0, False),
    ("dtype", ArgType.DATA_TYPE, "Output dtype.", DALIDataType.FLOAT, False),
    ("output_layout", ArgType.TENSOR_LAYOUT, "Output layout (CHW/HWC).", "CHW", False),
    ("pad_output", ArgType.BOOL, "Pad channels to 4.", False, False),
    ("out_of_bounds_policy", ArgType.STRING, '"error", "pad" or "trim_to_shape".', "error", False),
    ("fill_values", ArgType.FLOAT_VEC, "Out-of-bounds output values (pad policy).", [0.0], False),
    ("image_type", ArgType.IMAGE_TYPE, "Compatibility argument (ignored).", DALIImageType.RGB, False),
    ("rounding", ArgType.STRING, 'Window start rounding: "round" or "truncate".', "round", False),
):
    _cmn.AddOptionalArg(*_args[:4], tensor_ok=_args[4])
del _args


class _CMNCommon(Operator):
    # dali_tpu reads these with GetArgument, so a DataNode is ignored and the
    # whole image (depth) comes out (ROADMAP.md Queue 3); its cpu op reads a
    # tensor crop_d per sample
    unread_tensor_args = ("crop_h", "crop_w", "crop_d")

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        for nm in self.unread_tensor_args:
            if nm in spec.arg_inputs:
                raise _not_ported(
                    f"CropMirrorNormalize tensor argument '{nm}' (dali_tpu ignores it and does "
                    "not crop)", "Queue 3, found in the reference")
        self.policy = spec.GetArgument("out_of_bounds_policy")

    def _crop_size(self):
        crop = self.spec.GetArgument("crop", None)
        ch, cw = self.spec.GetArgument("crop_h"), self.spec.GetArgument("crop_w")
        if crop:
            return int(crop[0]), int(crop[1])
        if ch and cw:
            return int(ch), int(cw)
        return None


@register_operator("CropMirrorNormalize", "gpu")
class CropMirrorNormalizeGPU(_CMNCommon):
    """uint8/float16/float32 HWC -> float32/float16/uint8/int8/int16/int32
    CHW or HWC, through one launch of the CMN kernel (``kernels/cmn.py``).
    DHWC volumes (layout "D...") take their ``crop_d`` window at
    ``crop_pos_z`` and FHWC sequences ("F...") go whole: depth or frames
    fold into the batch, each per-sample argument repeats over them, and the
    output unfolds to [N, D or F, ...] with the layout's leading letter."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)

        def floats(name):
            return tuple(np.asarray(spec.GetArgument(name), np.float32).reshape(-1).tolist())

        # tuples: the kernel wrapper folds them once for the operator's life
        self.mean, self.std = floats("mean"), floats("std")
        self.fill = floats("fill_values") if self.policy == "pad" else None

    def host_output_layouts(self, in_layouts):
        base = self.spec.GetArgument("output_layout")
        lead = (in_layouts[0] if in_layouts else "")[:1]
        if lead == "D":
            return ["D" + base.lstrip("FD")]
        if lead == "F":
            return [base if base.startswith("F") else "F" + base]
        return [base]

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        shapes = input_shapes[0] if input_shapes else None
        if shapes is None:
            return None
        sh = np.asarray(shapes).astype(np.int64)
        lead = (ctx.in_layouts(self) or [""])[0][:1]
        if sh.shape[1] == 4 and lead in ("D", "F"):
            lead_ext = sh[:, 0].copy()
            if lead == "D" and int(self.spec.GetArgument("crop_d") or 0):
                lead_ext[:] = int(self.spec.GetArgument("crop_d"))
            sh = sh[:, 1:]
        elif sh.shape[1] != 3:
            return None
        h, w, c = sh[:, 0], sh[:, 1], sh[:, 2]
        cs = self._crop_size()
        if cs is None:
            oh, ow = h, w
        elif self.policy == "trim_to_shape":
            oh, ow = np.minimum(h, cs[0]), np.minimum(w, cs[1])
        else:
            bad = (h < cs[0]) | (w < cs[1])
            if self.policy == "error" and bad.any():
                i = int(np.argmax(bad))
                raise ValueError(
                    f"CropMirrorNormalize: crop window {cs[0]}x{cs[1]} out of bounds for "
                    f"sample {i} of extent {int(h[i])}x{int(w[i])} "
                    "(out_of_bounds_policy='error'; use 'pad' or 'trim_to_shape')")
            oh, ow = np.full_like(h, cs[0]), np.full_like(w, cs[1])
        oc = np.full_like(c, 4) if self.spec.GetArgument("pad_output") else c
        layout = self.spec.GetArgument("output_layout").lstrip("FD")
        cols = {"CHW": [oc, oh, ow], "HWC": [oh, ow, oc]}.get(layout)
        if cols is None:
            return None
        if sh.shape[1] != input_shapes[0].shape[1]:
            cols = [lead_ext] + cols
        return [np.stack(cols, axis=1)]

    def lower(self, dctx, inp: DeviceBatch):
        data = inp.data
        if data.dim() == 5 and inp.layout[:1] in ("D", "F"):
            n, depth = data.shape[:2]
            src = None
            if inp.layout[0] == "D":
                src, depth = self._depth_window(dctx, inp)
            sh = (None if inp.shapes is None
                  else torch.repeat_interleave(inp.shapes[:, 1:4], data.shape[1], dim=0))
            slices = DeviceBatch(data.reshape(n * data.shape[1], *data.shape[2:]), sh,
                                 inp.layout[1:])
            out = self._lower_2d(dctx, slices, depth, src)
            layout = inp.layout[0] + out.layout
            return [DeviceBatch(out.data.reshape(n, depth, *out.data.shape[1:]), None, layout)]
        if data.dim() != 4:
            raise _not_ported(f"CropMirrorNormalize(gpu) on {data.dim() - 1}-D samples")
        return [self._lower_2d(dctx, inp, 1)]

    def _depth_window(self, dctx, inp: DeviceBatch):
        """(the [N * crop_d] slices of the depth windows at crop_pos_z, as
        indices into the [N * D] slices; crop_d): rounded, clamped into
        the volume as a dynamic slice. None for the whole depth."""
        n, D = inp.data.shape[:2]
        cd = int(self.spec.GetArgument("crop_d") or 0) or D
        if cd == D:
            return None, D
        pos = dctx.arg(self, "crop_pos_z", 0.5)
        pos = pos.reshape(-1).to(torch.float32) if torch.is_tensor(pos) else float(pos)
        z = _crop_round_torch(pos * (inp.extent(0) - cd).to(torch.float32),
                              self.spec.GetArgument("rounding"))
        z = torch.clamp(z.to(torch.int64), 0, D - cd)
        first = torch.arange(n, device=z.device) * D + z.reshape(-1)
        return (first[:, None] + torch.arange(cd, device=z.device)).reshape(-1), cd

    def _lower_2d(self, dctx, inp: DeviceBatch, repeat: int, src=None) -> DeviceBatch:
        """One kernel launch over [N, H, W, C] (with ``src``, over those of
        its samples); per-sample arguments repeat ``repeat`` times (the
        folded depth or frames)."""
        spec = self.spec
        n = inp.data.shape[0] if src is None else src.shape[0]
        H, W, C = inp.data.shape[1:]
        crop_h, crop_w = self._crop_size() or (H, W)
        ext_h, ext_w = inp.extent(0), inp.extent(1)
        if src is not None:
            ext_h, ext_w = ext_h[src], ext_w[src]
        rnd = spec.GetArgument("rounding")

        def per_sample(name, default):
            v = dctx.arg(self, name, default)
            if torch.is_tensor(v) and repeat > 1:
                v = torch.repeat_interleave(v.reshape(-1), repeat)
            return v

        def origin(name, ext, size):
            pos = per_sample(name, 0.5)
            pos = pos.reshape(-1).to(torch.float32) if torch.is_tensor(pos) else float(pos)
            v = _crop_round_torch(pos * (ext - size).to(torch.float32), rnd).to(torch.int32)
            # error / trim_to_shape: the window starts inside the image
            return v if self.policy == "pad" else torch.clamp(v, min=0)

        crop_y = origin("crop_pos_y", ext_h, crop_h)
        crop_x = origin("crop_pos_x", ext_w, crop_w)
        mirror = per_sample("mirror", 0)
        if dctx.has_tensor_arg(self, "mirror"):
            mirror = mirror.reshape(-1)
        elif mirror:
            mirror = torch.full((n,), int(mirror), dtype=torch.int32, device=inp.data.device)
        else:
            mirror = None
        # a leading F or D of the requested layout belongs to the fold
        layout = spec.GetArgument("output_layout").lstrip("FD")
        out = cmn_kernel.crop_mirror_normalize(
            inp.data, crop_y, crop_x, mirror, crop_h, crop_w, self.mean, self.std,
            float(spec.GetArgument("scale")), float(spec.GetArgument("shift")), layout,
            to_torch_type(spec.GetArgument("dtype")), bool(spec.GetArgument("pad_output")),
            ext_h=ext_h, ext_w=ext_w, fill=self.fill, src_index=src)
        shapes = None
        if self.policy == "trim_to_shape" and inp.shapes is not None:
            oh = torch.clamp(ext_h, max=crop_h)
            ow = torch.clamp(ext_w, max=crop_w)
            oc = torch.full_like(oh, out.shape[1] if layout == "CHW" else out.shape[-1])
            shapes = torch.stack([oc, oh, ow] if layout == "CHW" else [oh, ow, oc], 1)
        return DeviceBatch(out, shapes, layout)


@register_operator("CropMirrorNormalize", "cpu")
class CropMirrorNormalizeCPU(_CMNCommon):
    """Per sample in numpy, in the reference's order of operations
    (``dali_tpu/backend/image.py`` ``CropMirrorNormalizeCPU``): HWC images
    and DHWC volumes (``crop_d``, ``crop_pos_z``); every
    ``out_of_bounds_policy``; ``fill_values`` as output values; the cast is
    numpy's ``astype``."""

    unread_tensor_args = ("crop_h", "crop_w")

    def run_sample(self, ctx, idx, img):
        spec = self.spec
        vol = img.ndim == 4
        if vol:
            d, h, w, c = img.shape
        else:
            h, w, c = img.shape
        crop_h, crop_w = self._crop_size() or (h, w)
        fill = np.asarray(spec.GetArgument("fill_values"), np.float32)
        rnd = spec.GetArgument("rounding")
        y = _crop_round(float(ctx.arg(self, "crop_pos_y", idx, 0.5)) * (h - crop_h), rnd)
        x = _crop_round(float(ctx.arg(self, "crop_pos_x", idx, 0.5)) * (w - crop_w), rnd)
        if vol:
            crop_d = int(ctx.arg(self, "crop_d", idx, 0.0) or 0) or d
            z = _crop_round(float(ctx.arg(self, "crop_pos_z", idx, 0.5)) * (d - crop_d), rnd)
        oob = y < 0 or x < 0 or y + crop_h > h or x + crop_w > w or (
            vol and (z < 0 or z + crop_d > d))
        if oob and self.policy == "error":
            raise ValueError(
                f"CropMirrorNormalize: crop window {crop_h}x{crop_w} out of "
                f"bounds for {h}x{w} (out_of_bounds_policy='error')")
        if self.policy == "trim_to_shape":
            y, x = max(y, 0), max(x, 0)
            crop_h, crop_w = min(crop_h, h - y), min(crop_w, w - x)
            if vol:
                z = max(z, 0)
                crop_d = min(crop_d, d - z)
        sl = (slice(max(z, 0), z + crop_d),) if vol else ()
        win = img[sl + (slice(max(y, 0), y + crop_h),
                        slice(max(x, 0), x + crop_w))].astype(np.float32)
        oob_mask = None
        if oob and self.policy == "pad":
            # pad to the requested window; the mask remembers what was padded
            pads = [(max(-z, 0), crop_d - win.shape[0] - max(-z, 0))] if vol else []
            pads += [(max(-y, 0), crop_h - win.shape[-3] - max(-y, 0)),
                     (max(-x, 0), crop_w - win.shape[-2] - max(-x, 0)), (0, 0)]
            oob_mask = np.pad(np.zeros(win.shape[:-1], bool), pads[:-1], constant_values=True)
            win = np.pad(win, pads)
        if int(np.asarray(ctx.arg(self, "mirror", idx, 0))) != 0:
            win = win[..., :, ::-1, :]
            if oob_mask is not None:
                oob_mask = oob_mask[..., :, ::-1]
        mean = np.asarray(spec.GetArgument("mean"), np.float32)
        std = np.asarray(spec.GetArgument("std"), np.float32)
        scale, shift = float(spec.GetArgument("scale")), float(spec.GetArgument("shift"))
        out = scale * (win - mean) / std + shift
        if oob_mask is not None:
            out[oob_mask] = fill if fill.size == c else fill.reshape(-1)[0]
        if spec.GetArgument("pad_output") and c < 4:
            out = np.pad(out, [(0, 0)] * (out.ndim - 1) + [(0, 4 - c)])
        if spec.GetArgument("output_layout") in ("CHW", "FCHW", "DCHW"):
            out = np.transpose(out, (0, 3, 1, 2) if out.ndim == 4 else (2, 0, 1))
        return np.ascontiguousarray(out.astype(to_numpy_type(spec.GetArgument("dtype"))))

    def output_layout(self, output_idx, inputs):
        return self.spec.GetArgument("output_layout")


DALI_SCHEMA("Flip").DocStr(
    "Flips images horizontally, vertically or (volumes) depthwise."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "horizontal", ArgType.INT, "Flip horizontally.", 1, tensor_ok=True
).AddOptionalArg(
    "vertical", ArgType.INT, "Flip vertically.", 0, tensor_ok=True
).AddOptionalArg(
    "depthwise", ArgType.INT, "Flip the depth axis of DHWC volumes.", 0, tensor_ok=True
)


def _reversed_index(flag: torch.Tensor, size: int, ext: torch.Tensor) -> torch.Tensor:
    """[N, size] source index of each position: reversed inside each
    sample's extent where its flag is set, the identity elsewhere."""
    pos = torch.arange(size, device=ext.device)[None, :]
    ext = ext.to(torch.int64)[:, None]
    return torch.where((flag[:, None] != 0) & (pos < ext), ext - 1 - pos, pos)


@register_operator("Flip", "gpu")
class FlipGPU(Operator):
    """Per-sample flags; a ragged sample flips within its valid extent.
    [N, H, W, C] images, [N, F, H, W, C] sequences (H and W of each frame)
    and [N, D, H, W, C] volumes (layout starting with "D")."""

    def lower(self, dctx, inp: DeviceBatch):
        data = inp.data
        n, dev = data.shape[0], data.device
        if data.dim() not in (4, 5):
            raise _not_ported(f"Flip(gpu) on {data.dim() - 1}-D samples")

        def flag(name, default):
            v = dctx.arg(self, name, default)
            f = (v.reshape(-1).to(dev) if torch.is_tensor(v)
                 else torch.tensor([int(v)], device=dev))
            return f.expand(n) if f.numel() == 1 else f

        h, v = flag("horizontal", 1), flag("vertical", 0)
        vol = data.dim() == 5 and inp.layout.startswith("D")
        if vol:
            d = flag("depthwise", 0)
        if inp.shapes is None:
            # axes counted from the end: W = -2, H = -3 (HWC, FHWC, DHWC alike)
            bshape = (n,) + (1,) * (data.dim() - 1)
            ax_h = data.dim() - 3
            out = torch.where(h.reshape(bshape) != 0, data.flip(ax_h + 1), data)
            out = torch.where(v.reshape(bshape) != 0, out.flip(ax_h), out)
            if vol:
                out = torch.where(d.reshape(bshape) != 0, out.flip(1), out)
            return [inp.with_data(out)]
        b = torch.arange(n, device=dev)
        if data.dim() == 4:
            H, W = data.shape[1:3]
            rows = _reversed_index(v, H, inp.extent(0))
            cols = _reversed_index(h, W, inp.extent(1))
            out = data[b[:, None, None], rows[:, :, None], cols[:, None, :]]
        else:
            A, H, W = data.shape[1:4]
            if vol:
                first = _reversed_index(d, A, inp.extent(0))
            else:  # a sequence: frames stay in order
                first = torch.arange(A, device=dev)[None, :].expand(n, A)
            rows = _reversed_index(v, H, inp.extent(1))
            cols = _reversed_index(h, W, inp.extent(2))
            out = data[b[:, None, None, None], first[:, :, None, None], rows[:, None, :, None],
                       cols[:, None, None, :]]
        return [inp.with_data(out)]
