"""GaussianBlur, Laplacian and experimental.Filter (counterpart of
``dali_tpu/backend/convolution.py``): the gpu GaussianBlur (2-D HWC) and
Laplacian, and the cpu placements of all three.

On the device, as in the reference, the per-sample separable kernels are
built on the host (``host_params``; sigma and window size may be per-sample
arguments), padded to a common length that only grows, and applied along H
then W with a reflect-101 border bounded by each sample's valid extent, so
canvas padding never blurs into an image. Sequences and volumes raise there.

On the host, 2-D samples (HWC, and FHWC sequences frame by frame) run the
port's C++ (``native.sep_conv_f32`` and ``filter2d_f32``, copies of the
reference's own kernels); DHWC volumes correlate along D, H and W in numpy
with a reflect-101 border, as the reference's volumetric route does.
Integer outputs round half to even and saturate."""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch
from ..kernels.host_resample import saturate
from ..kernels.pointwise import saturate_cast
from ..types import to_numpy_type, to_torch_type
from .base import BF16_ROUND, BF16_WIDEN, Operator, SamplePool


def gaussian_window(size: int, sigma: float):
    """OpenCV-compatible Gaussian window: (weights, size, sigma)."""
    if size <= 0:
        size = max(3, int(2 * np.ceil(3 * sigma) + 1))
    if sigma <= 0:
        sigma = 0.3 * ((size - 1) * 0.5 - 1) + 0.8
    x = np.arange(size, dtype=np.float64) - (size - 1) * 0.5
    w = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (w / w.sum()).astype(np.float32), size, sigma


DALI_SCHEMA("GaussianBlur").DocStr("Separable Gaussian blur.").NumInput(1).NumOutput(1).Devices(
    "cpu", "gpu").AddOptionalArg(
    "sigma", ArgType.FLOAT_VEC, "Gaussian sigma per axis.", None, tensor_ok=True
).AddOptionalArg(
    "window_size", ArgType.INT_VEC, "Window size per axis.", None, tensor_ok=True
).AddOptionalArg("dtype", ArgType.DATA_TYPE, "Output dtype.", None)


def _blur_params(ctx, op, idx, naxes=1):
    """Per-axis (sigma, window) pairs of sample ``idx``; scalars broadcast
    over the axes, and a zero/absent pair means window 3."""
    sigma = ctx.arg(op, "sigma", idx, None)
    win = ctx.arg(op, "window_size", idx, None)
    sv = np.asarray(sigma, np.float64).reshape(-1) if sigma is not None else np.zeros(1)
    wv = np.asarray(win, np.int64).reshape(-1) if win is not None else np.zeros(1, np.int64)
    out = []
    for a in range(naxes):
        s, w = float(sv[a % len(sv)]), int(wv[a % len(wv)])
        out.append((s, 3 if s <= 0 and w <= 0 else w))
    return out


def conv1d_reflect_np(x: np.ndarray, k: np.ndarray, axis: int) -> np.ndarray:
    """1-D correlation along ``axis`` with a reflect-101 border, float32."""
    r = len(k) // 2
    pads = [(r, r) if a == axis else (0, 0) for a in range(x.ndim)]
    xp = np.pad(x.astype(np.float32), pads, mode="reflect")
    out = np.zeros(x.shape, np.float32)
    sl = [slice(None)] * x.ndim
    for t, kv in enumerate(np.asarray(k, np.float32)):
        sl[axis] = slice(t, t + x.shape[axis])
        out += kv * xp[tuple(sl)]
    return out


def _to_dtype(spec, out: np.ndarray, default) -> np.ndarray:
    """``out`` in the ``dtype`` argument (else ``default``): integers round
    half to even and saturate."""
    dt_arg = spec.GetArgument("dtype", None)
    return saturate(out, to_numpy_type(dt_arg) if dt_arg is not None else np.dtype(default))


class _HostConv(SamplePool, Operator):
    """FHWC sequences run frame by frame; other 4-D samples are DHWC volumes."""

    def run_batch(self, ctx, *inputs):
        self._in_layout = inputs[0].layout if inputs else ""
        return super().run_batch(ctx, *inputs)

    def run_sample(self, ctx, idx, img):
        if img.ndim == 4 and self._in_layout.startswith("F"):
            return np.stack([self.run_2d(ctx, idx, fr) for fr in img])
        return self.run_volume(ctx, idx, img) if img.ndim == 4 else self.run_2d(ctx, idx, img)


def blur_axis(img: torch.Tensor, w: torch.Tensor, ext: torch.Tensor, axis: int) -> torch.Tensor:
    """1-D correlation of a batch [N, ...] along sample ``axis`` (>= 1) with
    per-sample center-aligned kernels ``w`` [N, K] and a reflect-101 border at
    each sample's extent ``ext`` [N]."""
    n, K = w.shape
    c = (K - 1) // 2
    L = img.shape[axis]
    h = torch.arange(L, dtype=torch.int32, device=img.device)[None, :]
    m = torch.clamp(ext.to(torch.int32) - 1, min=0)[:, None]
    bshape = [n] + [1] * (img.dim() - 1)
    out = None
    for t in range(K):
        p = h + (t - c)
        p = torch.where(p < 0, -p, p)  # reflect-101 at 0
        p = torch.where(p > m, 2 * m - p, p)  # reflect-101 at ext-1
        p = torch.minimum(torch.clamp(p, min=0), m).to(torch.int64)  # multi-bounce clamp
        idx_shape = [n] + [1] * (img.dim() - 1)
        idx_shape[axis] = L
        idx = p.reshape(idx_shape).expand(*img.shape[:axis], L, *img.shape[axis + 1:])
        term = w[:, t].reshape(bshape) * torch.gather(img, axis, idx)
        out = term if out is None else out + term
    return out


@register_operator("GaussianBlur", "gpu")
class GaussianBlurGPU(Operator):
    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._k_latch = 0

    def host_params(self, ctx, input_shapes):
        # a window per axis of a DHWC volume, one for the two axes otherwise
        naxes = 3 if (ctx.in_layouts(self) or [""])[0].startswith("D") else 1
        batches = ctx._arg_batches.get(self.op_id, {})
        n = 1
        for nm in ("sigma", "window_size"):
            if nm in batches:
                n = len(batches[nm].samples)
                break
        rows = [[gaussian_window(w, s)[0] for s, w in _blur_params(ctx, self, i, naxes)]
                for i in range(n)]
        K = max(3, max(len(k) for row in rows for k in row))
        if K % 2 == 0:
            K += 1
        self._k_latch = max(self._k_latch, K)
        K = self._k_latch
        wmat = np.zeros((n, naxes, K), np.float32)
        C = (K - 1) // 2
        for i, row in enumerate(rows):
            for a, k in enumerate(row):
                c = (len(k) - 1) // 2
                wmat[i, a, C - c:C - c + len(k)] = k
        return {"gb_w": wmat}

    def lower(self, dctx, inp: DeviceBatch):
        x = inp.data
        n = x.shape[0]
        w = dctx.param(self, "gb_w")  # [n | 1, naxes, K], naxes 3 on a DHWC volume
        if w.shape[0] == 1 and n != 1:
            w = w.expand(n, -1, -1)
        if w.shape[1] == 3:
            axes = ((1, 0, w[:, 0]), (2, 1, w[:, 1]), (3, 2, w[:, 2]))
        elif x.dim() == 5:  # a sequence: a 2-D blur of each frame
            axes = ((2, 1, w[:, 0]), (3, 2, w[:, 0]))
        else:
            axes = ((1, 0, w[:, 0]), (2, 1, w[:, 0]))
        out = x.to(torch.float32)
        for axis, col, wa in axes:
            out = blur_axis(out, wa, inp.extent(col), axis)
        dt = self.spec.GetArgument("dtype", None)
        return [inp.with_data(saturate_cast(out, x.dtype if dt is None else to_torch_type(dt)))]


@register_operator("GaussianBlur", "cpu")
class GaussianBlurCPU(_HostConv):
    reads_bfloat16 = BF16_ROUND

    def run_volume(self, ctx, idx, img):
        out = img
        for axis, (s, w) in enumerate(_blur_params(ctx, self, idx, 3)):
            out = conv1d_reflect_np(out, gaussian_window(w, s)[0], axis)
        return _to_dtype(self.spec, out, img.dtype)

    def run_2d(self, ctx, idx, img):
        (s, w), = _blur_params(ctx, self, idx)
        kernel = gaussian_window(w, s)[0]
        return _to_dtype(self.spec, native.sep_conv_f32(img, kernel, kernel), img.dtype)


DALI_SCHEMA("Laplacian").DocStr(
    "Laplacian filter: the sum of second derivatives, each a separable "
    "derivative window along its axis and smoothing windows along the others."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "window_size", ArgType.INT_VEC, "Derivative window size.", [3]
).AddOptionalArg(
    "scale", ArgType.FLOAT_VEC, "Output scale.", [1.0]
).AddOptionalArg(
    "normalized_kernel", ArgType.BOOL, "Normalize the windows to unit gain.", False
).AddOptionalArg("dtype", ArgType.DATA_TYPE, "Output dtype (default float32).", None)


def laplacian_windows(size: int):
    """(derivative, smoothing) windows of an odd ``size``: [1, -2, 1]
    convolved with a binomial of ``size - 3``, and a binomial of ``size - 1``
    (OpenCV's Sobel windows)."""
    deriv = np.array([1.0, -2.0, 1.0], np.float32)
    for _ in range((size - 3) // 2):
        deriv = np.convolve(deriv, [1.0, 2.0, 1.0]).astype(np.float32)
    smooth = np.array([1.0], np.float32)
    for _ in range((size - 1) // 2):
        smooth = np.convolve(smooth, [1.0, 2.0, 1.0]).astype(np.float32)
    return deriv, smooth


def _laplacian_scale(spec, size, naxes):
    """``scale``, or 2^(naxes + 2 - size * naxes) with ``normalized_kernel``."""
    if spec.GetArgument("normalized_kernel"):
        return 2.0 ** (-(size * naxes) + naxes + 2)
    return float(spec.GetArgument("scale")[0])


@register_operator("Laplacian", "gpu")
class LaplacianGPU(Operator):
    """[N, H, W, C] images, [N, F, H, W, C] sequences (per frame) and
    [N, D, H, W, C] volumes (layout starting with "D"); reflect-101 borders
    at each sample's extent."""

    def lower(self, dctx, inp: DeviceBatch):
        x = inp.data
        if x.dim() not in (4, 5):
            raise ValueError(f"Laplacian(gpu) takes HWC images, FHWC sequences and DHWC "
                             f"volumes, not {x.dim() - 1}-D samples")
        size = int(self.spec.GetArgument("window_size")[0])
        n = x.shape[0]
        deriv, smooth = (torch.from_numpy(w).to(x.device)[None].expand(n, -1)
                         for w in laplacian_windows(size))
        # the spatial axes of the batch tensor, and the shape columns of each
        if x.dim() == 4:
            axes, cols = (1, 2), (0, 1)
        elif inp.layout.startswith("D"):
            axes, cols = (1, 2, 3), (0, 1, 2)
        else:  # a sequence: a 2-D Laplacian per frame
            axes, cols = (2, 3), (1, 2)
        scale = _laplacian_scale(self.spec, size, len(axes))
        img = x.to(torch.float32)
        out = None
        for d_axis in axes:  # the derivative axis; smoothing along the others
            part = img
            for axis, col in zip(axes, cols):
                part = blur_axis(part, deriv if axis == d_axis else smooth, inp.extent(col), axis)
            out = part if out is None else out + part
        dt = self.spec.GetArgument("dtype", None)
        return [inp.with_data(saturate_cast(out * scale,
                                            torch.float32 if dt is None else to_torch_type(dt)))]


@register_operator("Laplacian", "cpu")
class LaplacianCPU(_HostConv):
    """The sum over the axes of the second derivative along it, smoothed
    along the others, times the scale; float32 unless ``dtype``."""
    reads_bfloat16 = BF16_WIDEN

    def run_volume(self, ctx, idx, img):
        size = int(self.spec.GetArgument("window_size")[0])
        deriv, smooth = laplacian_windows(size)
        out = np.zeros(img.shape, np.float32)
        for d_axis in range(3):
            part = img.astype(np.float32)
            for axis in range(3):
                part = conv1d_reflect_np(part, deriv if axis == d_axis else smooth, axis)
            out += part
        out *= _laplacian_scale(self.spec, size, 3)
        return _to_dtype(self.spec, out, np.float32)

    def run_2d(self, ctx, idx, img):
        size = int(self.spec.GetArgument("window_size")[0])
        deriv, smooth = laplacian_windows(size)
        out = (native.sep_conv_f32(img, deriv, smooth) + native.sep_conv_f32(img, smooth, deriv))
        return _to_dtype(self.spec, out * _laplacian_scale(self.spec, size, 2), np.float32)


# ======================================== Filter ====================================================

# the gpu placement is in tail.py, as in the reference
DALI_SCHEMA("experimental.Filter").DocStr(
    "General 2D correlation with a per-sample kernel."
).NumInput(2, 3).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "anchor", ArgType.INT_VEC, "Kernel anchor (default center).", None
).AddOptionalArg(
    "border", ArgType.STRING, '"reflect_101", "constant", ...', "reflect_101"
).AddOptionalArg(
    "mode", ArgType.STRING, '"same" or "valid".', "same"
).AddOptionalArg("fill_value", ArgType.FLOAT, "Constant-border fill.", 0.0).AddOptionalArg(
    "dtype", ArgType.DATA_TYPE, "Output dtype.", None)


@register_operator("experimental.Filter", "cpu")
class FilterCPU(SamplePool, Operator):
    """2-D correlation of each HW(C) sample with its kernel (``cv2.filter2D``'s
    convention), with the ``border`` (reflect_101, reflect, replicate, wrap or
    constant with ``fill_value``, or the third input's per-sample value) and
    the ``anchor``; ``mode="valid"`` keeps the windows wholly inside."""

    def run_sample(self, ctx, idx, img, kernel, *fill):
        border = self.spec.GetArgument("border")
        fill_v = (float(np.asarray(fill[0]).reshape(-1)[0]) if fill
                  else float(self.spec.GetArgument("fill_value")))
        kernel = np.asarray(kernel, np.float32)
        anchor = self.spec.GetArgument("anchor", None)
        ay = ax = -1
        if anchor is not None:
            av = np.asarray(anchor, np.int64).reshape(-1)
            ay, ax = int(av[0]), int(av[-1])
        if self.spec.GetArgument("mode") == "valid":
            oh, ow = img.shape[0] - kernel.shape[0] + 1, img.shape[1] - kernel.shape[1] + 1
            if oh <= 0 or ow <= 0:
                raise ValueError(f"filter mode='valid': kernel {tuple(kernel.shape)} does not "
                                 f"fit inside the input {img.shape[:2]}: no valid window exists")
            out = native.filter2d_f32(img, kernel, border, fill_v, 0, 0)[:oh, :ow]
        else:
            out = native.filter2d_f32(img, kernel, border, fill_v, ay, ax)
        return _to_dtype(self.spec, out, img.dtype)
