"""Affine and perspective warps of padded batches on torch tensors
(counterpart of ``dali_tpu/kernels/warp.py``, 2-D HWC).

Each output pixel (x, y) samples the input at M @ (x, y, 1) with NN or
bilinear taps; taps outside the sample's valid extent read ``fill_value``.
Two routes, as in the reference: the gather route for any affine, and the
separable route for axis-aligned matrices (m01 == m10 == 0), which warps
with two per-sample interpolation-matrix products. The host-side matrix and
canvas helpers, and the host warp of one DHWC volume
(``warp_affine_volumetric_np``), are the reference's numpy code.
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


def rotation_matrix_3d(angle_deg, axis, center_xyz, out_center_xyz):
    """Destination -> source rotation of a volume about ``axis`` through a
    center, [3, 4] in (x, y, z) order (Rodrigues' form, used directly as the
    destination -> source map: about +z it is ``rotation_matrix``)."""
    a = np.deg2rad(angle_deg)
    u = np.asarray(axis, np.float64)
    nrm = np.linalg.norm(u)
    u = u / (nrm if nrm > 0 else 1.0)
    c, s = np.cos(a), np.sin(a)
    ux, uy, uz = u
    k = np.array([[0, -uz, uy], [uz, 0, -ux], [-uy, ux, 0]])
    m = np.eye(3) + s * k + (1 - c) * (k @ k)
    t = np.asarray(center_xyz, np.float64) - m @ np.asarray(out_center_xyz, np.float64)
    return np.concatenate([m, t[:, None]], axis=1).astype(np.float32)


def warp_affine_volumetric_np(img, m, out_d: int, out_h: int, out_w: int, interp, fill):
    """One DHWC volume through the [3, 4] destination -> source map ``m`` on
    the host, in numpy float32: the nearest voxel (rounded half to even) or
    trilinear taps, ``fill`` outside the volume. Returns float32."""
    D, H, W, _ = img.shape
    gz, gy, gx = np.meshgrid(np.arange(out_d, dtype=np.float32),
                             np.arange(out_h, dtype=np.float32),
                             np.arange(out_w, dtype=np.float32), indexing="ij")
    sx = m[0, 0] * gx + m[0, 1] * gy + m[0, 2] * gz + m[0, 3]
    sy = m[1, 0] * gx + m[1, 1] * gy + m[1, 2] * gz + m[1, 3]
    sz = m[2, 0] * gx + m[2, 1] * gy + m[2, 2] * gz + m[2, 3]
    imgf = img.astype(np.float32)

    def tap(iz, iy, ix):
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H) & (iz >= 0) & (iz < D)
        v = imgf[np.clip(iz, 0, D - 1), np.clip(iy, 0, H - 1), np.clip(ix, 0, W - 1)]
        return np.where(valid[..., None], v, np.float32(fill))

    if interp == DALIInterpType.INTERP_NN:
        return tap(np.round(sz).astype(np.int32), np.round(sy).astype(np.int32),
                   np.round(sx).astype(np.int32))
    z0, y0, x0 = np.floor(sz), np.floor(sy), np.floor(sx)
    wz, wy, wx = (sz - z0)[..., None], (sy - y0)[..., None], (sx - x0)[..., None]
    iz0, iy0, ix0 = z0.astype(np.int32), y0.astype(np.int32), x0.astype(np.int32)

    def bilin(iz):
        v00, v01 = tap(iz, iy0, ix0), tap(iz, iy0, ix0 + 1)
        v10, v11 = tap(iz, iy0 + 1, ix0), tap(iz, iy0 + 1, ix0 + 1)
        return (v00 * (1 - wx) + v01 * wx) * (1 - wy) + (v10 * (1 - wx) + v11 * wx) * wy

    return bilin(iz0) * (1 - wz) + bilin(iz0 + 1) * wz


def warp_perspective_batch(data, matrices, out_h: int, out_w: int, extents=None,
                           interp=DALIInterpType.INTERP_LINEAR, fill_value: float = 0.0,
                           out_dtype=None, replicate: bool = False):
    """Perspective warp: data [N, H, W, C], matrices [N, 3, 3] destination ->
    source homographies -> [N, out_h, out_w, C]. Each output pixel divides
    by its homogeneous coordinate (kept away from 0 by 1e-9), then takes NN
    or bilinear taps clamped to the sample's valid extent; outside it a tap
    reads ``fill_value``, or the clamped edge with ``replicate``."""
    n, H, W, C = data.shape
    dev = data.device
    ext = _extents(data, extents)
    m = matrices.to(torch.float32)
    gy, gx = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=dev),
                            torch.arange(out_w, dtype=torch.float32, device=dev), indexing="ij")
    gx, gy = gx[None], gy[None]

    def coef(i, j):
        return m[:, i, j].reshape(n, 1, 1)

    wdiv = coef(2, 0) * gx + coef(2, 1) * gy + coef(2, 2)
    wdiv = torch.where(torch.abs(wdiv) < 1e-9, 1e-9, wdiv)
    sx = (coef(0, 0) * gx + coef(0, 1) * gy + coef(0, 2)) / wdiv
    sy = (coef(1, 0) * gx + coef(1, 1) * gy + coef(1, 2)) / wdiv
    eh, ew = ext[:, 0].reshape(n, 1, 1), ext[:, 1].reshape(n, 1, 1)
    flat = data.to(torch.float32).reshape(n, H * W, C)

    def tap(iy, ix):
        iyc = torch.minimum(iy.clamp(min=0), (eh - 1).clamp(min=0)).clamp(max=H - 1)
        ixc = torch.minimum(ix.clamp(min=0), (ew - 1).clamp(min=0)).clamp(max=W - 1)
        lin = (iyc * W + ixc).to(torch.int64)
        v = torch.gather(flat, 1, lin.reshape(n, -1, 1).expand(n, out_h * out_w, C))
        v = v.reshape(n, out_h, out_w, C)
        if replicate:
            return v
        valid = (ix >= 0) & (ix < ew) & (iy >= 0) & (iy < eh)
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
