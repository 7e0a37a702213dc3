"""Resize, CropMirrorNormalize and Flip on the device (counterpart of
``dali_tpu/backend/image.py`` ``ResizeGPU`` static-size path,
``CropMirrorNormalizeGPU`` 2-D path and ``FlipGPU``).

Paths not ported yet (per-sample resize sizes, ROI, filter overrides,
sequences/volumes, tensor crop sizes, integer CMN outputs, cpu placements)
raise ``NotImplementedError`` pointing to ROADMAP.md.
"""

from __future__ import annotations

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch
from ..kernels import cmn as cmn_kernel
from ..kernels import resample as resample_kernel
from ..types import DALIDataType, DALIImageType, DALIInterpType, to_torch_type
from .base import Operator


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to dali_tpu_torch yet; see ROADMAP.md (Queue 1)")


_resize = DALI_SCHEMA("Resize").DocStr(
    "Resizes images (reference image/resize/resize.cc). Ported: a static "
    "output size (resize_x and resize_y, or size) on the device."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu")
for _args in (
    ("resize_x", ArgType.FLOAT, "Output width (0 = keep aspect).", 0.0, True),
    ("resize_y", ArgType.FLOAT, "Output height (0 = keep aspect).", 0.0, True),
    ("resize_z", ArgType.FLOAT, "Output depth (volumes).", 0.0, True),
    ("resize_shorter", ArgType.FLOAT, "Resize shorter edge, keep aspect.", 0.0, True),
    ("resize_longer", ArgType.FLOAT, "Resize longer edge, keep aspect.", 0.0, True),
    ("size", ArgType.FLOAT_VEC, "Output size (H, W).", None, True),
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
    ("save_attrs", ArgType.BOOL, "Second output with the input shapes.", False, False),
    ("minibatch_size", ArgType.INT, "Compatibility hint.", 32, False),
    ("temp_buffer_hint", ArgType.INT, "Compatibility hint.", 0, False),
    ("subpixel_scale", ArgType.BOOL, "Compatibility flag.", True, False),
):
    _resize.AddOptionalArg(*_args[:4], tensor_ok=_args[4])


@register_operator("Resize", "gpu")
class ResizeGPU(Operator):
    """Static output size: every sample's valid extent resampled to (h, w)."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        for nm in ("resize_z", "resize_shorter", "resize_longer", "max_size", "roi_start",
                   "roi_end", "mag_filter", "min_filter"):
            if spec.HasArgument(nm):
                raise _not_ported(f"Resize(gpu) argument '{nm}'")
        if spec.GetArgument("save_attrs") or spec.GetArgument("mode") not in ("default", "stretch"):
            raise _not_ported("Resize(gpu) save_attrs / keep-aspect modes")
        if spec.arg_inputs:
            raise _not_ported("Resize(gpu) per-sample (tensor) size arguments")
        rx = float(spec.GetArgument("resize_x") or 0.0)
        ry = float(spec.GetArgument("resize_y") or 0.0)
        size = spec.GetArgument("size", None)
        if size is not None:
            sz = np.asarray(size, np.float64).reshape(-1)
            ry, rx = (float(sz[0]), float(sz[-1]))
        if not (rx > 0 and ry > 0):
            raise _not_ported("Resize(gpu) with a one-sided (keep-aspect) size")
        self.out_hw = (int(round(ry)), int(round(rx)))

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        sh = input_shapes[0] if input_shapes else None
        if sh is None:
            return None
        sh = np.asarray(sh)
        if sh.shape[1] != 3:
            raise _not_ported("Resize(gpu) on sequences or volumes")
        hw = np.tile(np.array([self.out_hw], np.int64), (sh.shape[0], 1))
        return [np.concatenate([hw, sh[:, 2:3].astype(np.int64)], axis=1)]

    def lower(self, dctx, inp: DeviceBatch):
        if inp.data.dim() != 4:
            raise _not_ported("Resize(gpu) on sequences or volumes")
        dt = self.spec.GetArgument("dtype", None)
        out_dtype = to_torch_type(dt) if dt is not None else inp.data.dtype
        data = resample_kernel.resample_batch(
            inp.data, inp.shapes, *self.out_hw,
            DALIInterpType(self.spec.GetArgument("interp_type")),
            bool(self.spec.GetArgument("antialias")), out_dtype)
        return [DeviceBatch(data, None, inp.layout or "HWC")]


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


@register_operator("CropMirrorNormalize", "gpu")
class CropMirrorNormalizeGPU(Operator):
    """2-D input: uint8/float16/float32 HWC -> float32/float16 CHW or HWC,
    through one launch of the CMN kernel (``kernels/cmn.py``)."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        for nm in ("crop_h", "crop_w", "crop_d", "crop_pos_z"):
            if nm in spec.arg_inputs:
                raise _not_ported(f"CropMirrorNormalize(gpu) tensor argument '{nm}'")
        self.policy = spec.GetArgument("out_of_bounds_policy")

        def floats(name):
            return tuple(np.asarray(spec.GetArgument(name), np.float32).reshape(-1).tolist())

        # tuples: the kernel wrapper folds them once for the operator's life
        self.mean, self.std = floats("mean"), floats("std")
        self.fill = floats("fill_values") if self.policy == "pad" else None

    def _crop_size(self):
        crop = self.spec.GetArgument("crop", None)
        ch, cw = self.spec.GetArgument("crop_h"), self.spec.GetArgument("crop_w")
        if crop:
            return int(crop[0]), int(crop[1])
        if ch and cw:
            return int(ch), int(cw)
        return None

    def host_output_layouts(self, in_layouts):
        return [self.spec.GetArgument("output_layout")]

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        shapes = input_shapes[0] if input_shapes else None
        if shapes is None:
            return None
        sh = np.asarray(shapes).astype(np.int64)
        if sh.shape[1] != 3:
            raise _not_ported("CropMirrorNormalize(gpu) on sequences or volumes")
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
        layout = self.spec.GetArgument("output_layout")
        cols = {"CHW": [oc, oh, ow], "HWC": [oh, ow, oc]}.get(layout)
        return None if cols is None else [np.stack(cols, axis=1)]

    def lower(self, dctx, inp: DeviceBatch):
        if inp.data.dim() != 4:
            raise _not_ported("CropMirrorNormalize(gpu) on sequences or volumes")
        spec = self.spec
        n, H, W, C = inp.data.shape
        crop_h, crop_w = self._crop_size() or (H, W)
        ext_h, ext_w = inp.extent(0), inp.extent(1)
        truncate = spec.GetArgument("rounding") == "truncate"

        def origin(name, ext, size):
            pos = dctx.arg(self, name, 0.5)
            pos = pos.reshape(-1).to(torch.float32) if torch.is_tensor(pos) else float(pos)
            v = pos * (ext - size).to(torch.float32)
            if truncate:
                v = torch.trunc(v)
            else:  # std::round: half away from zero
                v = torch.trunc(v + torch.copysign(torch.full_like(v, 0.5), v))
            v = v.to(torch.int32)
            # error / trim_to_shape: the window starts inside the image
            return v if self.policy == "pad" else torch.clamp(v, min=0)

        crop_y = origin("crop_pos_y", ext_h, crop_h)
        crop_x = origin("crop_pos_x", ext_w, crop_w)
        mirror = dctx.arg(self, "mirror", 0)
        if dctx.has_tensor_arg(self, "mirror"):
            mirror = mirror.reshape(-1)
        elif mirror:
            mirror = torch.full((n,), int(mirror), dtype=torch.int32, device=inp.data.device)
        else:
            mirror = None
        layout = spec.GetArgument("output_layout")
        out = cmn_kernel.crop_mirror_normalize(
            inp.data, crop_y, crop_x, mirror, crop_h, crop_w, self.mean, self.std,
            float(spec.GetArgument("scale")), float(spec.GetArgument("shift")), layout,
            to_torch_type(spec.GetArgument("dtype")), bool(spec.GetArgument("pad_output")),
            ext_h=ext_h, ext_w=ext_w, fill=self.fill)
        shapes = None
        if self.policy == "trim_to_shape" and inp.shapes is not None:
            oh = torch.clamp(ext_h, max=crop_h)
            ow = torch.clamp(ext_w, max=crop_w)
            oc = torch.full_like(oh, out.shape[1] if layout == "CHW" else out.shape[-1])
            shapes = torch.stack([oc, oh, ow] if layout == "CHW" else [oh, ow, oc], 1)
        return [DeviceBatch(out, shapes, layout)]


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
