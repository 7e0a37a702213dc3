"""Affine warps of padded batches on torch tensors (counterpart of
``dali_tpu/kernels/warp.py``, 2-D HWC).

Each output pixel (x, y) samples the input at M @ (x, y, 1) with NN or
bilinear taps; taps outside the sample's valid extent read ``fill_value``.
Two routes, as in the reference: the gather route for any affine, and the
separable route for axis-aligned matrices (m01 == m10 == 0), which warps
with two per-sample interpolation-matrix products. The host-side matrix and
canvas helpers are the reference's numpy code.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.pointwise import saturate_cast
from ..types import DALIInterpType


def _extents(data, extents):
    n, H, W = data.shape[:3]
    if extents is None:
        return torch.tensor([[H, W]], dtype=torch.int32, device=data.device).expand(n, 2)
    return extents[:, :2].to(torch.int32)


def warp_affine_batch(data, matrices, out_h: int, out_w: int, extents=None,
                      interp=DALIInterpType.INTERP_LINEAR, fill_value: float = 0.0,
                      out_dtype=None):
    """Gather route: data [N, H, W, C], matrices [N, 2, 3] destination ->
    source, extents [N, >=2] valid (h, w) -> [N, out_h, out_w, C]."""
    n, H, W, C = data.shape
    dev = data.device
    ext = _extents(data, extents)
    m = matrices.to(torch.float32)
    gy, gx = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=dev),
                            torch.arange(out_w, dtype=torch.float32, device=dev), indexing="ij")
    gx, gy = gx[None], gy[None]

    def coef(i, j):
        return m[:, i, j].reshape(n, 1, 1)

    sx = coef(0, 0) * gx + coef(0, 1) * gy + coef(0, 2)
    sy = coef(1, 0) * gx + coef(1, 1) * gy + coef(1, 2)
    eh, ew = ext[:, 0].reshape(n, 1, 1), ext[:, 1].reshape(n, 1, 1)
    flat = data.to(torch.float32).reshape(n, H * W, C)

    def tap(iy, ix):
        valid = (ix >= 0) & (ix < ew) & (iy >= 0) & (iy < eh)
        lin = (torch.clamp(iy, 0, H - 1) * W + torch.clamp(ix, 0, W - 1)).to(torch.int64)
        v = torch.gather(flat, 1, lin.reshape(n, -1, 1).expand(n, out_h * out_w, C))
        v = v.reshape(n, out_h, out_w, C)
        return torch.where(valid[..., None], v, torch.full_like(v, fill_value))

    if interp == DALIInterpType.INTERP_NN:
        out = tap(torch.round(sy).to(torch.int32), torch.round(sx).to(torch.int32))
    else:
        x0, y0 = torch.floor(sx), torch.floor(sy)
        wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
        ix0, iy0 = x0.to(torch.int32), y0.to(torch.int32)
        out = ((tap(iy0, ix0) * (1 - wx) + tap(iy0, ix0 + 1) * wx) * (1 - wy)
               + (tap(iy0 + 1, ix0) * (1 - wx) + tap(iy0 + 1, ix0 + 1) * wx) * wy)
    return saturate_cast(out, out_dtype if out_dtype is not None else data.dtype)


def warp_affine_separable_batch(data, matrices, out_h: int, out_w: int, extents=None,
                                interp=DALIInterpType.INTERP_LINEAR, fill_value: float = 0.0,
                                out_dtype=None):
    """Separable route for axis-aligned matrices: sx = a*x + c and
    sy = e*y + f decouple, so the warp is A_y @ img @ A_x^T per sample, with
    out-of-extent taps at weight 0 and the lost weight restored as
    (1 - sum(A_y) * sum(A_x)) * fill."""
    n, H, W, C = data.shape
    dev = data.device
    ext = _extents(data, extents)
    m = matrices.to(torch.float32)

    def axis_matrix(scale, off, out_n, in_n, e):
        s = scale[:, None] * torch.arange(out_n, dtype=torch.float32, device=dev)[None] \
            + off[:, None]  # [N, out_n]
        i = torch.arange(in_n, dtype=torch.float32, device=dev)[None, None, :]
        extf = e.to(torch.float32)[:, None, None]
        if interp == DALIInterpType.INTERP_NN:
            t = torch.round(s)[..., None]
            return ((i == t) & (t >= 0) & (t < extf)).to(torch.float32)
        t0 = torch.floor(s)[..., None]
        w1 = s[..., None] - t0
        a0 = torch.where((i == t0) & (t0 >= 0) & (t0 < extf), 1.0 - w1, torch.zeros_like(w1))
        a1 = torch.where((i == t0 + 1) & (t0 + 1 >= 0) & (t0 + 1 < extf), w1,
                         torch.zeros_like(w1))
        return a0 + a1  # [N, out_n, in_n]

    a_y = axis_matrix(m[:, 1, 1], m[:, 1, 2], out_h, H, ext[:, 0])
    a_x = axis_matrix(m[:, 0, 0], m[:, 0, 2], out_w, W, ext[:, 1])
    img = data.to(torch.float32)
    tmp = torch.einsum("noh,nhwc->nowc", a_y, img)
    core = torch.einsum("npw,nowc->nopc", a_x, tmp)
    lost = 1.0 - a_y.sum(dim=2)[:, :, None] * a_x.sum(dim=2)[:, None, :]
    out = core + lost[..., None] * fill_value
    return saturate_cast(out, out_dtype if out_dtype is not None else data.dtype).contiguous()


def rotation_matrix(angle_deg, center_xy, out_center_xy):
    """Destination -> source rotation about a center, (x, y) order
    (positive angle = counter-clockwise in y-down image coordinates)."""
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    m = np.array([[c, -s], [s, c]], np.float32)
    t = np.asarray(center_xy, np.float32) - m @ np.asarray(out_center_xy, np.float32)
    return np.concatenate([m, t[:, None]], axis=1).astype(np.float32)


def rotated_canvas_size(h, w, angle_deg):
    a = np.deg2rad(angle_deg)
    c, s = abs(np.cos(a)), abs(np.sin(a))
    return int(np.ceil(h * c + w * s - 0.5)), int(np.ceil(w * c + h * s - 0.5))
