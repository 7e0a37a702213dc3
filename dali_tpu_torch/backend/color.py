"""Colour operators on the device (counterpart of the gpu ops of
``dali_tpu/backend/color.py``): BrightnessContrast, Brightness, Contrast,
Hsv, Hue, Saturation and ColorSpaceConversion, over the formulas of
``kernels/pointwise.py``. Per-sample arguments arrive stacked [N] from the
host, or from the device env when they are GPU edges (``contrast_center``
from a device reduction)."""

from __future__ import annotations

import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch
from ..kernels import pointwise as pw
from ..types import DALIImageType, to_torch_type
from .base import Operator


def _batchwise(dctx, op, name, default, n, device):
    """A float argument as [N] float32: stacked per-sample, or a constant."""
    v = dctx.arg(op, name, default)
    if dctx.has_tensor_arg(op, name):
        return v.to(device=device, dtype=torch.float32).reshape(-1)
    return torch.full((n,), float(v), dtype=torch.float32, device=device)


def _out_dtype(spec, in_dtype):
    dt = spec.GetArgument("dtype", None)
    return in_dtype if dt is None else to_torch_type(dt)


for _name in ("BrightnessContrast", "Brightness", "Contrast"):
    DALI_SCHEMA(_name).DocStr(
        f"{_name}: out = brightness_shift*range + brightness*(center + "
        "contrast*(in - center))."
    ).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
        "brightness", ArgType.FLOAT, "Multiplicative brightness.", 1.0, tensor_ok=True
    ).AddOptionalArg(
        "brightness_shift", ArgType.FLOAT, "Additive brightness (fraction of range).", 0.0,
        tensor_ok=True
    ).AddOptionalArg(
        "contrast", ArgType.FLOAT, "Contrast factor.", 1.0, tensor_ok=True
    ).AddOptionalArg(
        "contrast_center", ArgType.FLOAT, "Contrast pivot (default: half range).", None,
        tensor_ok=True
    ).AddOptionalArg("dtype", ArgType.DATA_TYPE, "Output dtype.", None)


class BrightnessContrastGPU(Operator):
    def lower(self, dctx, inp: DeviceBatch):
        x, n = inp.data, inp.data.shape[0]
        b, bs, c = (_batchwise(dctx, self, nm, d, n, x.device)
                    for nm, d in (("brightness", 1.0), ("brightness_shift", 0.0),
                                  ("contrast", 1.0)))
        if dctx.has_tensor_arg(self, "contrast_center"):
            cc = dctx.arg(self, "contrast_center").to(device=x.device,
                                                      dtype=torch.float32).reshape(-1)
        else:
            v = self.spec.GetArgument("contrast_center", None)
            cc = torch.full((n,), 0.5 * pw.dtype_range(x.dtype) if v is None else float(v),
                            dtype=torch.float32, device=x.device)
        extra = (1,) * (x.dim() - 1)
        b, bs, c, cc = (v.reshape(n, *extra) for v in (b, bs, c, cc))
        out = pw.brightness_contrast(x, b, bs, c, cc, _out_dtype(self.spec, x.dtype))
        return [inp.with_data(out)]


for _name in ("BrightnessContrast", "Brightness", "Contrast"):
    register_operator(_name, "gpu")(type(_name + "GPU", (BrightnessContrastGPU,), {}))


DALI_SCHEMA("Hsv").DocStr(
    "Hue/saturation/value adjustment through linear YIQ matrices."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "hue", ArgType.FLOAT, "Hue rotation in degrees.", 0.0, tensor_ok=True
).AddOptionalArg(
    "saturation", ArgType.FLOAT, "Saturation multiplier.", 1.0, tensor_ok=True
).AddOptionalArg(
    "value", ArgType.FLOAT, "Value multiplier.", 1.0, tensor_ok=True
).AddOptionalArg("dtype", ArgType.DATA_TYPE, "Output dtype.", None)

DALI_SCHEMA("Hue").DocStr("Hue rotation.").NumInput(1).NumOutput(1).Devices(
    "cpu", "gpu").AddOptionalArg(
    "hue", ArgType.FLOAT, "Hue rotation in degrees.", 0.0, tensor_ok=True
).AddOptionalArg("dtype", ArgType.DATA_TYPE, "Output dtype.", None).AddOptionalArg(
    "image_type", ArgType.IMAGE_TYPE, "Colour space (RGB assumed).", DALIImageType.RGB)

DALI_SCHEMA("Saturation").DocStr("Saturation scaling.").NumInput(1).NumOutput(1).Devices(
    "cpu", "gpu").AddOptionalArg(
    "saturation", ArgType.FLOAT, "Saturation multiplier.", 1.0, tensor_ok=True
).AddOptionalArg("dtype", ArgType.DATA_TYPE, "Output dtype.", None).AddOptionalArg(
    "image_type", ArgType.IMAGE_TYPE, "Colour space (RGB assumed).", DALIImageType.RGB)


class HsvGPU(Operator):
    def lower(self, dctx, inp: DeviceBatch):
        x, n = inp.data, inp.data.shape[0]
        args = self.spec.schema.args
        h, s, v = (_batchwise(dctx, self, nm, d, n, x.device) if nm in args
                   else torch.full((n,), d, dtype=torch.float32, device=x.device)
                   for nm, d in (("hue", 0.0), ("saturation", 1.0), ("value", 1.0)))
        out = pw.apply_color_matrices(x.to(torch.float32), pw.color_twist_matrices(h, s, v))
        return [inp.with_data(pw.saturate_cast(out, _out_dtype(self.spec, x.dtype)))]


for _name in ("Hsv", "Hue", "Saturation"):
    register_operator(_name, "gpu")(type(_name + "GPU", (HsvGPU,), {}))


_CS_NAMES = {int(DALIImageType.RGB): "RGB", int(DALIImageType.BGR): "BGR",
             int(DALIImageType.GRAY): "GRAY", int(DALIImageType.YCbCr): "YCbCr"}

DALI_SCHEMA("ColorSpaceConversion").DocStr(
    "Converts between RGB, BGR, YCbCr (BT.601) and GRAY."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddArg(
    "image_type", ArgType.IMAGE_TYPE, "Input colour space."
).AddArg("output_type", ArgType.IMAGE_TYPE, "Output colour space.")


@register_operator("ColorSpaceConversion", "gpu")
class ColorSpaceConversionGPU(Operator):
    def host_output_shapes(self, ctx, input_shapes, input_batches):
        sh = input_shapes[0] if input_shapes else None
        if sh is None:
            return None
        out = sh.copy()
        dst = _CS_NAMES[int(self.spec.GetArgument("output_type"))]
        src = _CS_NAMES[int(self.spec.GetArgument("image_type"))]
        if dst == "GRAY":
            out[:, -1] = 1
        elif src == "GRAY":
            out[:, -1] = 3
        return [out]

    def lower(self, dctx, inp: DeviceBatch):
        src = _CS_NAMES[int(self.spec.GetArgument("image_type"))]
        dst = _CS_NAMES[int(self.spec.GetArgument("output_type"))]
        out = pw.convert_color_space(inp.data, src, dst, inp.data.dtype)
        shapes = inp.shapes
        if shapes is not None and out.shape[-1] != inp.data.shape[-1]:
            shapes = shapes.clone()
            shapes[:, -1] = out.shape[-1]
        return [DeviceBatch(out, shapes, inp.layout)]


DALI_SCHEMA("ColorTwist").DocStr(
    "Hue, saturation, brightness and contrast in one pass: the YIQ hue/saturation matrix, "
    "then out = brightness * (center + contrast * (x - center)) about half the range."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "hue", ArgType.FLOAT, "Hue rotation (degrees).", 0.0, tensor_ok=True, per_sample=True
).AddOptionalArg(
    "saturation", ArgType.FLOAT, "Saturation multiplier.", 1.0, tensor_ok=True, per_sample=True
).AddOptionalArg(
    "brightness", ArgType.FLOAT, "Brightness multiplier.", 1.0, tensor_ok=True, per_sample=True
).AddOptionalArg(
    "contrast", ArgType.FLOAT, "Contrast factor.", 1.0, tensor_ok=True, per_sample=True
).AddOptionalArg("dtype", ArgType.DATA_TYPE, "Output dtype.", None).AddOptionalArg(
    "image_type", ArgType.IMAGE_TYPE, "Colour space (RGB assumed).", DALIImageType.RGB)


@register_operator("ColorTwist", "gpu")
class ColorTwistGPU(Operator):
    def lower(self, dctx, inp: DeviceBatch):
        x, n = inp.data, inp.data.shape[0]
        h, s, b, c = (_batchwise(dctx, self, nm, d, n, x.device)
                      for nm, d in (("hue", 0.0), ("saturation", 1.0), ("brightness", 1.0),
                                    ("contrast", 1.0)))
        mats = pw.color_twist_matrices(h, s, torch.ones((n,), dtype=torch.float32,
                                                          device=x.device))
        out = pw.apply_color_matrices(x.to(torch.float32), mats)
        center = 0.5 * pw.dtype_range(x.dtype)
        extra = (1,) * (x.dim() - 1)
        out = b.reshape(n, *extra) * (center + c.reshape(n, *extra) * (out - center))
        return [inp.with_data(pw.saturate_cast(out, _out_dtype(self.spec, x.dtype)))]
