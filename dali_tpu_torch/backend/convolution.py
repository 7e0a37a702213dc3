"""GaussianBlur (2-D HWC) and Laplacian on the device (counterpart of the gpu
ops of ``dali_tpu/backend/convolution.py``).

As in the reference, the per-sample separable kernels are built on the host
(``host_params``; sigma and window size may be per-sample arguments), padded
to a common length that only grows, and applied along H then W with a
reflect-101 border bounded by each sample's valid extent, so canvas padding
never blurs into an image. Sequences and volumes raise."""

from __future__ import annotations

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch
from ..kernels.pointwise import saturate_cast
from ..types import to_torch_type
from .base import Operator


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


def _blur_params(ctx, op, idx):
    """(sigma, window) of sample ``idx``; a zero/absent pair means window 3."""
    sigma = ctx.arg(op, "sigma", idx, None)
    win = ctx.arg(op, "window_size", idx, None)
    s = float(np.asarray(sigma, np.float64).reshape(-1)[0]) if sigma is not None else 0.0
    w = int(np.asarray(win, np.int64).reshape(-1)[0]) if win is not None else 0
    return (s, 3 if s <= 0 and w <= 0 else w)


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
        batches = ctx._arg_batches.get(self.op_id, {})
        n = 1
        for nm in ("sigma", "window_size"):
            if nm in batches:
                n = len(batches[nm].samples)
                break
        rows = [gaussian_window(w, s)[0] for s, w in (_blur_params(ctx, self, i)
                                                     for i in range(n))]
        K = max(3, max(len(k) for k in rows))
        if K % 2 == 0:
            K += 1
        self._k_latch = max(self._k_latch, K)
        K = self._k_latch
        wmat = np.zeros((n, K), np.float32)
        C = (K - 1) // 2
        for i, k in enumerate(rows):
            c = (len(k) - 1) // 2
            wmat[i, C - c:C - c + len(k)] = k
        return {"gb_w": wmat}

    def lower(self, dctx, inp: DeviceBatch):
        if inp.data.dim() != 4:
            raise NotImplementedError("GaussianBlur(gpu) on sequences or volumes is not ported "
                                      "to dali_tpu_torch yet; see ROADMAP.md (Queue 1)")
        x = inp.data
        n = x.shape[0]
        w = dctx.param(self, "gb_w")
        if w.shape[0] == 1 and n != 1:
            w = w.expand(n, -1)
        out = x.to(torch.float32)
        out = blur_axis(out, w, inp.extent(0), 1)
        out = blur_axis(out, w, inp.extent(1), 2)
        dt = self.spec.GetArgument("dtype", None)
        return [inp.with_data(saturate_cast(out, x.dtype if dt is None else to_torch_type(dt)))]


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


@register_operator("Laplacian", "gpu")
class LaplacianGPU(Operator):
    """[N, H, W, C] images, [N, F, H, W, C] sequences (per frame) and
    [N, D, H, W, C] volumes (layout starting with "D"); reflect-101 borders
    at each sample's extent."""

    def lower(self, dctx, inp: DeviceBatch):
        x = inp.data
        if x.dim() not in (4, 5):
            raise NotImplementedError(f"Laplacian(gpu) on {x.dim() - 1}-D samples is not ported "
                                      "to dali_tpu_torch yet; see ROADMAP.md (Queue 1)")
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
        if self.spec.GetArgument("normalized_kernel"):
            scale = 2.0 ** (-(size * len(axes)) + len(axes) + 2)
        else:
            scale = float(self.spec.GetArgument("scale")[0])
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
