"""Water, Sphere, Jitter and GridMask on the device (counterpart of the gpu
ops of ``dali_tpu/backend/distortion.py``; their cpu placements are ROADMAP.md
Queue 1 item 5h), and the schemas of JpegCompressionDistortion, MedianBlur,
Dilate and Erode, whose gpu placements are in ``straggler_gpu.py`` as in the
reference.

The displacement ops gather each output pixel from source coordinates on the
padded canvas [N, H, W, C], nearest (the reference's default) or bilinear;
taps past a sample's valid extent take ``fill_value``. Jitter's
displacements draw from ``DeviceCtx.generator``. A per-sample ``mask`` of 0
passes the sample through.
"""

from __future__ import annotations

import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch
from ..types import DALIInterpType
from .base import Operator
from .random import per_sample, saturate


def bilinear_gather(img, sx, sy, fill, eh, ew):
    """Samples ``img`` [N, H, W, C] at float coordinates ``sx``, ``sy``
    ([N, h, w], or [1, h, w] for every sample) into float32 [N, h, w, C];
    taps outside a sample's valid extent (``eh``, ``ew`` [N]) take ``fill``."""
    n, H, W, _ = img.shape
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
    ix0, iy0 = x0.to(torch.int64), y0.to(torch.int64)
    nidx = torch.arange(n, device=img.device).view(n, 1, 1)
    vh, vw = eh.view(n, 1, 1), ew.view(n, 1, 1)

    def tap(iy, ix):
        valid = (ix >= 0) & (ix < vw) & (iy >= 0) & (iy < vh)
        v = img[nidx, iy.clamp(0, H - 1), ix.clamp(0, W - 1)].to(torch.float32)
        return torch.where(valid[..., None], v, fill)

    return ((tap(iy0, ix0) * (1 - wx) + tap(iy0, ix0 + 1) * wx) * (1 - wy)
            + (tap(iy0 + 1, ix0) * (1 - wx) + tap(iy0 + 1, ix0 + 1) * wx) * wy)


def _maybe_nn(xs, ys, spec):
    """Nearest interpolation gathers at the rounded source coordinates."""
    if spec.GetArgument("interp_type", DALIInterpType.INTERP_NN) == DALIInterpType.INTERP_NN:
        return torch.round(xs), torch.round(ys)
    return xs, ys


def _grid(H, W, device):
    """The canvas's row and column coordinates, float32 [1, H, W] each."""
    ys = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=device)[None, :].expand(H, W)
    return ys[None], xs[None]


class _DisplacementGPU(Operator):
    def _coords(self, dctx, inp):
        """Source coordinates (sx, sy), [N or 1, H, W] each."""
        raise NotImplementedError

    def lower(self, dctx, inp: DeviceBatch):
        x = inp.data
        sx, sy = _maybe_nn(*self._coords(dctx, inp), self.spec)
        out = bilinear_gather(x, sx, sy, float(self.spec.GetArgument("fill_value", 0.0)),
                              inp.extent(0), inp.extent(1))
        if dctx.has_tensor_arg(self, "mask") or int(self.spec.GetArgument("mask", 1)) != 1:
            m = per_sample(dctx, self, "mask", 1, x.shape[0], x.dim(), x.device)
            out = torch.where(m != 0, out, x.to(torch.float32))
        return [inp.with_data(saturate(out, x.dtype))]


def _displacement_schema(name, doc):
    return DALI_SCHEMA(name).DocStr(doc).NumInput(1).NumOutput(1).Devices("cpu", "gpu")


def _interp_and_mask(schema):
    return schema.AddOptionalArg(
        "interp_type", ArgType.INTERP_TYPE, "Interpolation (default: nearest).",
        DALIInterpType.INTERP_NN
    ).AddOptionalArg(
        "mask", ArgType.INT, "Per-sample apply flag: 0 passes the input through unchanged.", 1,
        tensor_ok=True, per_sample=True)


_interp_and_mask(_displacement_schema(
    "Water", "Sinusoidal water distortion: src_x = x + ampl_x*sin(freq_x*y + phase_x), "
    "src_y = y + ampl_y*cos(freq_y*x + phase_y).").AddOptionalArg(
    "ampl_x", ArgType.FLOAT, "X amplitude.", 10.0).AddOptionalArg(
    "ampl_y", ArgType.FLOAT, "Y amplitude.", 10.0).AddOptionalArg(
    "freq_x", ArgType.FLOAT, "X frequency.", 0.049087).AddOptionalArg(
    "freq_y", ArgType.FLOAT, "Y frequency.", 0.049087).AddOptionalArg(
    "phase_x", ArgType.FLOAT, "X phase.", 0.0).AddOptionalArg(
    "phase_y", ArgType.FLOAT, "Y phase.", 0.0).AddOptionalArg(
    "fill_value", ArgType.FLOAT, "Border fill.", 0.0))


@register_operator("Water", "gpu")
class WaterGPU(_DisplacementGPU):
    def _coords(self, dctx, inp):
        g = self.spec.GetArgument
        ys, xs = _grid(inp.data.shape[1], inp.data.shape[2], inp.data.device)
        return (xs + g("ampl_x") * torch.sin(g("freq_x") * ys + g("phase_x")),
                ys + g("ampl_y") * torch.cos(g("freq_y") * xs + g("phase_y")))


_interp_and_mask(_displacement_schema("Sphere", "Spherical lens distortion.").AddOptionalArg(
    "fill_value", ArgType.FLOAT, "Border fill.", 0.0))


@register_operator("Sphere", "gpu")
class SphereGPU(_DisplacementGPU):
    def _coords(self, dctx, inp):
        n = inp.data.shape[0]
        ys, xs = _grid(inp.data.shape[1], inp.data.shape[2], inp.data.device)
        # the center and the normalisation of each sample's valid extent
        cy = ((inp.extent(0) - 1) * 0.5).view(n, 1, 1)
        cx = ((inp.extent(1) - 1) * 0.5).view(n, 1, 1)
        nx, ny = (xs - cx) / cx, (ys - cy) / cy
        r = torch.sqrt(nx * nx + ny * ny)
        factor = torch.where(r < 1.0, r, 1.0)
        return cx + nx * factor * cx, cy + ny * factor * cy


_interp_and_mask(_displacement_schema(
    "Jitter", "Random per-pixel displacement within +-nDegree/2.").AddRandomSeedArg()
    .AddOptionalArg("nDegree", ArgType.INT, "Jitter extent.", 2).AddOptionalArg(
    "fill_value", ArgType.FLOAT, "Border fill.", 0.0))


@register_operator("Jitter", "gpu")
class JitterGPU(_DisplacementGPU):
    def _coords(self, dctx, inp):
        n, H, W = inp.data.shape[:3]
        half = self.spec.GetArgument("nDegree", 2) / 2.0
        disp = torch.rand((n, H, W, 2), generator=dctx.generator(self), dtype=torch.float32,
                          device=inp.data.device) * (2 * half) - half
        ys, xs = _grid(H, W, inp.data.device)
        return xs + disp[..., 0], ys + disp[..., 1]


DALI_SCHEMA("GridMask").DocStr(
    "GridMask erasure: zeroes a rotated grid of squares."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "tile", ArgType.INT, "Grid period (pixels).", 100, tensor_ok=True, per_sample=True
).AddOptionalArg(
    "ratio", ArgType.FLOAT, "Black square size / tile.", 0.5, tensor_ok=True, per_sample=True
).AddOptionalArg(
    "angle", ArgType.FLOAT, "Grid rotation (radians).", 0.0, tensor_ok=True, per_sample=True
).AddOptionalArg(
    "shift_x", ArgType.FLOAT, "Grid x shift.", 0.0, tensor_ok=True, per_sample=True
).AddOptionalArg("shift_y", ArgType.FLOAT, "Grid y shift.", 0.0, tensor_ok=True, per_sample=True)


@register_operator("GridMask", "gpu")
class GridMaskGPU(Operator):
    def lower(self, dctx, inp: DeviceBatch):
        x = inp.data
        tile, ratio, angle, sx, sy = (
            per_sample(dctx, self, name, default, x.shape[0], 3, x.device)
            for name, default in (("tile", 100), ("ratio", 0.5), ("angle", 0.0),
                                  ("shift_x", 0.0), ("shift_y", 0.0)))
        ys, xs = _grid(x.shape[1], x.shape[2], x.device)
        ca, sa = torch.cos(angle), torch.sin(angle)
        rx = (xs - sx) * ca + (ys - sy) * sa
        ry = -(xs - sx) * sa + (ys - sy) * ca
        keep = ((torch.remainder(rx, tile) / tile >= ratio)
                | (torch.remainder(ry, tile) / tile >= ratio))
        return [inp.with_data(x * keep[..., None].to(x.dtype))]


# ============================= JpegCompressionDistortion, MedianBlur, morphology =====================

DALI_SCHEMA("JpegCompressionDistortion").DocStr(
    "Simulates JPEG compression artifacts: encode at `quality`, decode back."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "quality", ArgType.FLOAT, "JPEG quality (1..100).", 50.0, tensor_ok=True, per_sample=True)

DALI_SCHEMA("experimental.MedianBlur").DocStr("Median filter.").NumInput(1).NumOutput(1).Devices(
    "cpu", "gpu").AddOptionalArg("window_size", ArgType.INT_VEC, "Kernel size (odd).", [3])

for _nm, _doc in (("experimental.Dilate", "Dilation"), ("experimental.Erode", "Erosion")):
    DALI_SCHEMA(_nm).DocStr(f"{_doc} with a rectangular structuring element.").NumInput(
        1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
        "mask_size", ArgType.INT_VEC, "Structuring element size.", [3, 3]
    ).AddOptionalArg("anchor", ArgType.INT_VEC, "Anchor (-1 = center).", [-1, -1]).AddOptionalArg(
        "iterations", ArgType.INT, "Number of times the operation is applied.", 1
    ).AddOptionalArg(
        "border_mode", ArgType.STRING,
        '"constant" (outside pixels take the reduction identity) or "replicate".', "constant")
