"""Water, Sphere, Jitter and GridMask on the device and the host, and
JpegCompressionDistortion, MedianBlur, Dilate and Erode on the host
(counterpart of ``dali_tpu/backend/distortion.py``; the gpu placements of
the last four are in ``straggler_gpu.py`` as in the reference).

The displacement ops gather each output pixel from source coordinates,
nearest (the reference's default) or bilinear; taps past a sample's valid
extent take ``fill_value``. On the device they gather over the padded canvas
[N, H, W, C] and Jitter's displacements draw from ``DeviceCtx.generator``; on
the host they run per sample in numpy, in the reference's operations, and
Jitter draws from the host stream ``HostCtx.rng`` before it reads ``mask``.
A per-sample ``mask`` of 0 passes the sample through.

The host JpegCompressionDistortion, MedianBlur and morphology stand where the
reference calls cv2: the JPEG round trip is the port's encoder front half and
decoder (``native.jpeg_roundtrip``, equal to ``cv2.imencode``/``imdecode``);
uint8 median and morphology run the port's copy of the reference's C++, other
types a numpy selection with cv2's borders (a median replicates the edge; a
min or max with the constant border ignores what lies outside, the
reduction's identity, which for a window that holds its own pixel is also
what replicate gives).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch
from ..kernels.host_resample import saturate as saturate_np
from ..types import DALIInterpType
from .base import BF16_ROUND, Operator, SamplePool
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


def bilinear_gather_np(img, sx, sy, fill):
    """Samples ``img`` [H, W, C] at float32 coordinates ``sx``, ``sy`` [h, w]
    into float32 [h, w, C]; taps outside the image take ``fill``."""
    H, W = img.shape[:2]
    x0, y0 = np.floor(sx), np.floor(sy)
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
    ix0, iy0 = x0.astype(np.int32), y0.astype(np.int32)

    def tap(iy, ix):
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        v = img[np.clip(iy, 0, H - 1), np.clip(ix, 0, W - 1)].astype(np.float32)
        return np.where(valid[..., None], v, fill)

    return ((tap(iy0, ix0) * (1 - wx) + tap(iy0, ix0 + 1) * wx) * (1 - wy)
            + (tap(iy0 + 1, ix0) * (1 - wx) + tap(iy0 + 1, ix0 + 1) * wx) * wy)


def _grid_np(H, W):
    """Row and column coordinates, float32 [H, W] each."""
    ys = np.arange(H, dtype=np.float32)[:, None] * np.ones((1, W), np.float32)
    xs = np.arange(W, dtype=np.float32)[None, :] * np.ones((H, 1), np.float32)
    return ys, xs


def _maybe_nn(xs, ys, spec):
    """Nearest interpolation gathers at the rounded source coordinates."""
    if spec.GetArgument("interp_type", DALIInterpType.INTERP_NN) == DALIInterpType.INTERP_NN:
        rnd = torch.round if torch.is_tensor(xs) else np.round
        return rnd(xs), rnd(ys)
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


class _DisplacementCPU(SamplePool, Operator):
    reads_bfloat16 = BF16_ROUND

    def _coords(self, ctx, idx, img):
        """Source coordinates (sx, sy), float32 [H, W] each."""
        raise NotImplementedError

    def run_sample(self, ctx, idx, img):
        coords = self._coords(ctx, idx, img)
        if not int(np.asarray(ctx.arg(self, "mask", idx, 1))):
            return img
        sx, sy = _maybe_nn(*coords, self.spec)
        out = bilinear_gather_np(img, sx, sy, self.spec.GetArgument("fill_value"))
        return saturate_np(out, img.dtype)


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


@register_operator("Water", "cpu")
class WaterCPU(_DisplacementCPU):
    def _coords(self, ctx, idx, img):
        g = self.spec.GetArgument
        ys, xs = _grid_np(*img.shape[:2])
        return (xs + g("ampl_x") * np.sin(g("freq_x") * ys + g("phase_x")),
                ys + g("ampl_y") * np.cos(g("freq_y") * xs + g("phase_y")))


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


@register_operator("Sphere", "cpu")
class SphereCPU(_DisplacementCPU):
    def _coords(self, ctx, idx, img):
        H, W = img.shape[:2]
        cy, cx = (H - 1) * 0.5, (W - 1) * 0.5
        ys, xs = _grid_np(H, W)
        nx, ny = (xs - cx) / cx, (ys - cy) / cy
        r = np.sqrt(nx * nx + ny * ny)
        factor = np.where(r < 1.0, r, 1.0)
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


@register_operator("Jitter", "cpu")
class JitterCPU(_DisplacementCPU):
    def _coords(self, ctx, idx, img):
        rng = ctx.rng(self, idx)
        H, W = img.shape[:2]
        half = self.spec.GetArgument("nDegree") / 2.0
        dx = rng.uniform(-half, half, (H, W)).astype(np.float32)
        dy = rng.uniform(-half, half, (H, W)).astype(np.float32)
        return (np.arange(W, dtype=np.float32)[None, :] + dx,
                np.arange(H, dtype=np.float32)[:, None] + dy)


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


@register_operator("GridMask", "cpu")
class GridMaskCPU(SamplePool, Operator):
    """In float32 throughout, as the gpu op: a python float would promote the
    boundary compare to float64 and flip pixels on the tile edges."""
    reads_bfloat16 = BF16_ROUND

    def run_sample(self, ctx, idx, img):
        tile, ratio, angle, sx, sy = (
            np.float32(np.asarray(ctx.arg(self, name, idx, default)))
            for name, default in (("tile", 100), ("ratio", 0.5), ("angle", 0.0),
                                  ("shift_x", 0.0), ("shift_y", 0.0)))
        ys, xs = _grid_np(*img.shape[:2])
        ca, sa = np.cos(angle), np.sin(angle)
        rx = (xs - sx) * ca + (ys - sy) * sa
        ry = -(xs - sx) * sa + (ys - sy) * ca
        keep = (np.mod(rx, tile) / tile >= ratio) | (np.mod(ry, tile) / tile >= ratio)
        return img * keep[..., None].astype(img.dtype)


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


@register_operator("JpegCompressionDistortion", "cpu")
class JpegDistortionCPU(SamplePool, Operator):
    """A baseline 4:2:0 JPEG round trip at ``quality`` (truncated to an
    integer): RGB uint8 out. As ``cv2.imencode``, another input type
    saturates to uint8 first, one channel encodes grey (decoded to three
    equal channels) and of four channels the encoder keeps what cv2 keeps of
    the reversed (BGR-ordered) image."""

    def run_sample(self, ctx, idx, img):
        q = int(np.asarray(ctx.arg(self, "quality", idx, 50.0)))
        if img.dtype != np.uint8:
            img = saturate_np(img, np.uint8)
        if img.ndim == 3 and img.shape[2] == 4:
            img = img[:, :, 1:]
        return native.jpeg_roundtrip(img, q)


def _window_view(x, axis, lo, hi, pad_mode, pad_value=None):
    """The window [i - lo, i + hi] of every position along ``axis``, as a
    trailing axis, over ``x`` padded with ``pad_mode``."""
    pads = [(lo, hi) if a == axis else (0, 0) for a in range(x.ndim)]
    kw = {"constant_values": pad_value} if pad_mode == "constant" else {}
    xp = np.pad(x, pads, mode=pad_mode, **kw)
    return np.lib.stride_tricks.sliding_window_view(xp, lo + hi + 1, axis=axis)


# the types cv2.medianBlur (windows 3 and 5) and cv2.erode/dilate take
_MEDIAN_TYPES = (np.uint16, np.int16, np.float32)
_MORPH_TYPES = (np.uint16, np.int16, np.float32, np.float64)


def median_np(img, k):
    """``cv2.medianBlur`` of a non-uint8 image: the median of the k x k
    window (k 3 or 5), the edge replicated."""
    if img.dtype not in _MEDIAN_TYPES or k not in (3, 5):
        raise ValueError(f"experimental.MedianBlur: window {k} on {img.dtype} is not supported "
                         "(as in cv2.medianBlur: uint8 any odd window; uint16, int16 and "
                         "float32 windows 3 and 5)")
    r = k // 2
    x = img if img.ndim == 3 else img[:, :, None]
    rows = _window_view(x, 0, r, r, "edge")  # [H, W, C, k]
    win = _window_view(rows, 1, r, r, "edge")  # [H, W, C, k, k]
    win = win.reshape(win.shape[:3] + (k * k,))
    out = np.partition(win, k * k // 2, axis=-1)[..., k * k // 2]
    return out.reshape(img.shape)


def morph_np(img, mh, mw, iterations, dilate):
    """``cv2.dilate``/``cv2.erode`` of a non-uint8 image with a full-ones
    mh x mw element at its default anchor, ``iterations`` times (one window
    (m - 1) * iterations + 1 wide, as cv2 merges them)."""
    if img.dtype not in _MORPH_TYPES:
        raise ValueError(f"experimental.{'Dilate' if dilate else 'Erode'}: {img.dtype} is not "
                         "supported (as in cv2: uint8, uint16, int16, float32, float64)")
    red = np.max if dilate else np.min
    ident = (np.finfo(img.dtype).min if dilate else np.finfo(img.dtype).max) \
        if np.issubdtype(img.dtype, np.floating) else \
        (np.iinfo(img.dtype).min if dilate else np.iinfo(img.dtype).max)
    out = img
    for axis, m in ((1, mw), (0, mh)):
        size = (m - 1) * iterations + 1
        lo = (m // 2) * iterations
        out = red(_window_view(out, axis, lo, size - 1 - lo, "constant", ident), axis=-1)
    return out


@register_operator("experimental.MedianBlur", "cpu")
class MedianBlurCPU(SamplePool, Operator):
    def run_sample(self, ctx, idx, img):
        k = int(self.spec.GetArgument("window_size")[0])
        if img.dtype == np.uint8:
            return native.median_blur_u8(img, k)
        return median_np(img, k)


class _MorphCPU(SamplePool, Operator):
    dilate = True

    def run_sample(self, ctx, idx, img):
        ms = self.spec.GetArgument("mask_size")
        iters = int(self.spec.GetArgument("iterations"))
        if img.dtype == np.uint8:
            anchor = self.spec.GetArgument("anchor")
            return native.morph_u8(img, int(ms[0]), int(ms[-1]), int(anchor[0]), int(anchor[-1]),
                                   iters, self.dilate,
                                   self.spec.GetArgument("border_mode") == "replicate")
        return morph_np(img, int(ms[0]), int(ms[-1]), iters, self.dilate)


@register_operator("experimental.Dilate", "cpu")
class DilateCPU(_MorphCPU):
    dilate = True


@register_operator("experimental.Erode", "cpu")
class ErodeCPU(_MorphCPU):
    dilate = False
