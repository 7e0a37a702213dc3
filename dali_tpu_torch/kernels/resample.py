"""Separable resize of padded batches (plain PyTorch).

Counterpart of ``dali_tpu/kernels/resample.py`` ``resample_batch`` (2-D
path): per-sample dense interpolation matrices ``A_y [out_h, H]`` and
``A_x [out_w, W]`` built by direct window evaluation, then two batched
matrix products ``A_y @ img @ A_x^T`` in float32 with TF32 off (the
reference runs them at ``Precision.HIGHEST``). Integer outputs are rounded
half to even and clipped. No Pallas kernel exists for this stage; the
tap-gather hand kernel is queued in ROADMAP.md (B3).
"""

from __future__ import annotations

import contextlib
import math

import torch

from ..types import DALIInterpType

_BASE_RADIUS = {
    DALIInterpType.INTERP_NN: 0.5,
    DALIInterpType.INTERP_LINEAR: 1.0,
    DALIInterpType.INTERP_TRIANGULAR: 1.0,
    DALIInterpType.INTERP_CUBIC: 2.0,
    DALIInterpType.INTERP_GAUSSIAN: 2.0,
    DALIInterpType.INTERP_LANCZOS3: 3.0,
}


def _window(interp: DALIInterpType, t: torch.Tensor) -> torch.Tensor:
    """Filter window at normalized distance t (reference resampling_windows.h)."""
    a = torch.abs(t)
    if interp in (DALIInterpType.INTERP_LINEAR, DALIInterpType.INTERP_TRIANGULAR):
        return torch.clamp(1.0 - a, min=0.0)
    if interp == DALIInterpType.INTERP_NN:
        return torch.where(a <= 0.5, 1.0, 0.0)
    if interp == DALIInterpType.INTERP_CUBIC:
        x = a * 2.0
        A = -0.5
        w1 = ((A + 2) * x - (A + 3)) * x * x + 1
        w2 = ((A * x - 5 * A) * x + 8 * A) * x - 4 * A
        return torch.where(x < 1.0, w1, torch.where(x < 2.0, w2, 0.0))
    if interp == DALIInterpType.INTERP_GAUSSIAN:
        x = a * 2.0
        return torch.exp(-(x * x))
    if interp == DALIInterpType.INTERP_LANCZOS3:
        x = a * 3.0

        def sinc(v):
            v = torch.where(torch.abs(v) < 1e-8, 1e-8, v)
            return torch.sin(math.pi * v) / (math.pi * v)

        return torch.where(x < 3.0, sinc(x) * sinc(x / 3.0), 0.0)
    raise ValueError(f"Unsupported interp {interp}")


def max_taps(interp: DALIInterpType, max_scale: float, antialias: bool) -> int:
    if interp == DALIInterpType.INTERP_NN:
        return 1
    radius = _BASE_RADIUS[interp] * (max(max_scale, 1.0) if antialias else 1.0)
    return int(math.ceil(2.0 * radius)) + 1


def _radius(interp, scale, antialias):
    base = _BASE_RADIUS[interp]
    if antialias and interp != DALIInterpType.INTERP_NN:
        return base * torch.clamp(scale, min=1.0)
    return torch.full_like(scale, base)


def interp_matrix(out_size: int, roi_start, roi_size, extent, interp, taps: int,
                  antialias: bool, extent_static: int) -> torch.Tensor:
    """[N, out_size, extent_static] per-sample interpolation matrices.

    roi_start / roi_size / extent: [N] per-sample values along this axis.
    Edge-clamped taps keep their raw-position weights and land on the edge
    rows, as in the reference's gather tap plan."""
    dev = roi_size.device
    scale = roi_size / out_size                                           # [N]
    x = (torch.arange(out_size, dtype=torch.float32, device=dev)[None, :] + 0.5) \
        * scale[:, None] + roi_start[:, None]                             # [N, out]
    ext = extent.to(torch.int32)[:, None, None]
    h = torch.arange(extent_static, dtype=torch.int32, device=dev)        # [H]
    if interp == DALIInterpType.INTERP_NN:
        idx = torch.floor(x).to(torch.int32)
        idx = torch.minimum(torch.clamp(idx, min=0), ext[:, :, 0] - 1)
        return (idx[:, :, None] == h[None, None, :]).to(torch.float32)
    center = x - 0.5
    radius = _radius(interp, scale, antialias)                            # [N]
    first = torch.ceil(center - radius[:, None]).to(torch.int32)          # [N, out]
    tgrid = (h[None, None, :].to(torch.float32) - center[:, :, None]) / radius[:, None, None]
    w_dense = _window(interp, tgrid)                                      # [N, out, H]
    offs = torch.arange(taps, dtype=torch.int32, device=dev)[None, :, None]
    raw = first[:, None, :] + offs                                        # [N, taps, out]
    w_taps = _window(interp, (raw.to(torch.float32) - center[:, None, :]) / radius[:, None, None])
    norm = torch.sum(w_taps, dim=1)                                       # [N, out]
    norm = torch.where(norm == 0, 1.0, norm)
    hh = h[None, None, :]
    in_taps = (hh >= first[:, :, None]) & (hh < first[:, :, None] + taps)
    valid = in_taps & (hh <= ext - 1)
    A = torch.where(valid, w_dense, 0.0) / norm[:, :, None]
    below = torch.sum(torch.where(raw < 0, w_taps, 0.0), dim=1) / norm
    above = torch.sum(torch.where(raw > ext - 1, w_taps, 0.0), dim=1) / norm
    return A + below[:, :, None] * (hh == 0) + above[:, :, None] * (hh == ext - 1)


@contextlib.contextmanager
def _full_fp32_matmul():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def resample_batch(data: torch.Tensor, extents, out_h: int, out_w: int,
                   interp: DALIInterpType = DALIInterpType.INTERP_LINEAR,
                   antialias: bool = True, out_dtype=None) -> torch.Tensor:
    """Resize padded [N, H, W, C] (valid extents [N, 2] or None) to
    [N, out_h, out_w, C]; the ROI is each sample's whole valid extent."""
    n, H, W, C = data.shape
    dev = data.device
    if extents is None:
        extents = torch.tensor([[H, W]], dtype=torch.int32, device=dev).expand(n, 2)
    ext_f = extents[:, :2].to(torch.float32)
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    Ay = interp_matrix(out_h, zero, ext_f[:, 0], extents[:, 0], interp,
                       max_taps(interp, H / out_h, antialias), antialias, H)
    Ax = interp_matrix(out_w, zero, ext_f[:, 1], extents[:, 1], interp,
                       max_taps(interp, W / out_w, antialias), antialias, W)
    img = data.to(torch.float32)
    with _full_fp32_matmul():
        tmp = torch.bmm(Ay, img.reshape(n, H, W * C)).reshape(n, out_h, W, C)
        tmp = tmp.permute(0, 2, 1, 3).reshape(n, W, out_h * C)
        out = torch.bmm(Ax, tmp).reshape(n, out_w, out_h, C).permute(0, 2, 1, 3)
    if out_dtype is not None and out_dtype != torch.float32:
        if not out_dtype.is_floating_point:
            info = torch.iinfo(out_dtype)
            out = torch.clamp(torch.round(out), info.min, info.max)
        out = out.to(out_dtype)
    return out.contiguous()
