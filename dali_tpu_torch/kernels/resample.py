"""Separable resize of padded batches (plain PyTorch).

Counterpart of ``dali_tpu/kernels/resample.py`` ``resample_batch`` and
``resample_volume_batch``: per-sample dense interpolation matrices
``A_y [out_h, H]`` and ``A_x [out_w, W]`` (and ``A_z [out_d, D]`` for
volumes) built by direct window evaluation over a per-sample ROI, then
batched matrix products ``A_y @ img @ A_x^T`` in float32 with TF32 off (the
reference runs them at ``Precision.HIGHEST``). Integer outputs are rounded
half to even and clipped. No Pallas kernel exists for this stage; the
tap-gather hand kernel is queued in ROADMAP.md (B3).

Divisions by a constant divide by a tensor (``_div``): on CUDA, PyTorch
computes ``tensor / python_number`` as a product with the float32
reciprocal, one ulp away from the quotient for many values, which moved
the card's interpolation positions off the CPU's (and the reference's).
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


def _div(t: torch.Tensor, d: float) -> torch.Tensor:
    """``t / d`` as a correctly rounded quotient on every device."""
    return t / torch.full((), d, dtype=t.dtype, device=t.device)


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

        return torch.where(x < 3.0, sinc(x) * sinc(_div(x, 3.0)), 0.0)
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
    scale = _div(roi_size, out_size)                                      # [N]
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


def _cast_out(out: torch.Tensor, out_dtype) -> torch.Tensor:
    if out_dtype is not None and out_dtype != torch.float32:
        if not out_dtype.is_floating_point:
            info = torch.iinfo(out_dtype)
            out = torch.clamp(torch.round(out), info.min, info.max)
        out = out.to(out_dtype)
    return out.contiguous()


def _full_extents(n: int, canvas, extents, dev) -> torch.Tensor:
    if extents is None:
        return torch.tensor([list(canvas)], dtype=torch.int32, device=dev).expand(n, len(canvas))
    return extents[:, :len(canvas)]


def resample_batch(data: torch.Tensor, extents, roi_start, roi_size, out_h: int, out_w: int,
                   interp: DALIInterpType = DALIInterpType.INTERP_LINEAR,
                   antialias: bool = True, out_dtype=None, taps_y: int = None,
                   taps_x: int = None) -> torch.Tensor:
    """Resize padded [N, H, W, C] to [N, out_h, out_w, C].

    ``extents`` [N, >=2] valid (H, W) or None (the whole canvas);
    ``roi_start`` / ``roi_size`` [N, 2] float (y, x) / (h, w), by default
    the origin and each sample's valid extent. ``taps_y`` / ``taps_x``
    override the canvas-ratio tap bound: a caller whose per-sample ROI
    stretch exceeds the canvas ratio (Resize packing each output into the
    front of a larger canvas) passes a bound from the true per-sample scale,
    or heavy downscales get too few antialias taps."""
    n, H, W, C = data.shape
    dev = data.device
    extents = _full_extents(n, (H, W), extents, dev)
    if roi_start is None:
        roi_start = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    if roi_size is None:
        roi_size = extents.to(torch.float32)
    roi_start, roi_size = roi_start.to(torch.float32), roi_size.to(torch.float32)
    if taps_y is None:
        taps_y = max_taps(interp, H / out_h, antialias)
    if taps_x is None:
        taps_x = max_taps(interp, W / out_w, antialias)
    Ay = interp_matrix(out_h, roi_start[:, 0], roi_size[:, 0], extents[:, 0], interp, taps_y,
                       antialias, H)
    Ax = interp_matrix(out_w, roi_start[:, 1], roi_size[:, 1], extents[:, 1], interp, taps_x,
                       antialias, W)
    img = data.to(torch.float32)
    with _full_fp32_matmul():
        tmp = torch.bmm(Ay, img.reshape(n, H, W * C)).reshape(n, out_h, W, C)
        tmp = tmp.permute(0, 2, 1, 3).reshape(n, W, out_h * C)
        out = torch.bmm(Ax, tmp).reshape(n, out_w, out_h, C).permute(0, 2, 1, 3)
    return _cast_out(out, out_dtype)


def resample_volume_batch(data: torch.Tensor, extents, out_d: int, out_h: int, out_w: int,
                          interp: DALIInterpType = DALIInterpType.INTERP_LINEAR,
                          antialias: bool = True, out_dtype=None) -> torch.Tensor:
    """Resize padded [N, D, H, W, C] volumes (valid extents [N, >=3] or
    None) to [N, out_d, out_h, out_w, C]: three separable products (depth,
    then rows, then columns), each over the sample's whole valid extent."""
    n, D, H, W, C = data.shape
    dev = data.device
    extents = _full_extents(n, (D, H, W), extents, dev)
    ext_f = extents.to(torch.float32)
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)

    def axis(k, out_size, canvas):
        return interp_matrix(out_size, zero, ext_f[:, k], extents[:, k], interp,
                             max_taps(interp, canvas / out_size, antialias), antialias, canvas)

    Az, Ay, Ax = axis(0, out_d, D), axis(1, out_h, H), axis(2, out_w, W)
    img = data.to(torch.float32)
    with _full_fp32_matmul():
        t = torch.bmm(Az, img.reshape(n, D, H * W * C))                     # [n, q, H*W*C]
        t = t.reshape(n, out_d, H, W * C).permute(0, 2, 1, 3).reshape(n, H, out_d * W * C)
        t = torch.bmm(Ay, t)                                                 # [n, o, q*W*C]
        t = t.reshape(n, out_h, out_d, W, C).permute(0, 3, 2, 1, 4).reshape(
            n, W, out_d * out_h * C)
        t = torch.bmm(Ax, t)                                                 # [n, p, q*o*C]
        out = t.reshape(n, out_w, out_d, out_h, C).permute(0, 2, 3, 1, 4)
    return _cast_out(out, out_dtype)
