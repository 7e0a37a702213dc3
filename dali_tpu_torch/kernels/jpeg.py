"""JPEG device tail (plain PyTorch): dequantise + scaled IDCT + fancy chroma
upsample + YCbCr->RGB, batched over N.

Counterpart of ``dali_tpu/kernels/jpeg.py`` (``jpeg_device_tail`` under
``jax.vmap``). The IDCT keeps the reference's order-fixed multiply-add chain
(``_mm_rows_fixed``/``_mm_cols_fixed``), and ``torch.round`` rounds half to
even like ``jnp.round``, so the uint8 output matches the JAX package up to
rounding ties that the two backends' float evaluation may split differently.
No Pallas kernel exists for this stage; its hand kernel is queued in
ROADMAP.md (B2).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def idct_matrix(k: int) -> np.ndarray:
    """[k, k] T with pixels_k = T @ coeffs_k along one dimension: the 8-point
    IDCT box-downsampled to k outputs (same derivation as the reference)."""
    i = np.arange(8)[:, None]
    m = np.arange(8)[None, :]
    B = 0.5 * np.cos((2 * i + 1) * m * np.pi / 16)
    B[:, 0] *= 1 / np.sqrt(2)
    step = 8 // k
    P = np.zeros((k, 8))
    for r in range(k):
        P[r, r * step:(r + 1) * step] = 1.0 / step
    return (P @ B)[:, :k].astype(np.float32)


def _mm_rows_fixed(T, c):
    """out[..., i, l] = sum_k T[i, k] c[..., k, l], ascending k, no dot."""
    acc = T[:, 0][:, None] * c[..., 0, None, :]
    for kk in range(1, T.shape[1]):
        acc = acc + T[:, kk][:, None] * c[..., kk, None, :]
    return acc


def _mm_cols_fixed(c, T):
    """out[..., i, j] = sum_l c[..., i, l] T[j, l], ascending l, no dot."""
    acc = c[..., :, 0, None] * T[:, 0]
    for ll in range(1, T.shape[1]):
        acc = acc + c[..., :, ll, None] * T[:, ll]
    return acc


def decode_blocks(coeffs: torch.Tensor, qtab: torch.Tensor, k: int) -> torch.Tensor:
    """coeffs [..., Hb, Wb, k*k] int, qtab broadcastable to it -> pixels
    [..., Hb*k, Wb*k] float32 (dequantise, 2-D scaled IDCT, +128)."""
    T = torch.from_numpy(idct_matrix(k)).to(coeffs.device)
    c = coeffs.to(torch.float32) * qtab.to(torch.float32)
    *lead, Hb, Wb, _ = c.shape
    c = c.reshape(*lead, Hb, Wb, k, k)
    px = _mm_cols_fixed(_mm_rows_fixed(T, c), T) + 128.0
    px = px.movedim(-2, -3)
    return px.reshape(*lead, Hb * k, Wb * k)


def _up1d(v: torch.Tensor, axis: int) -> torch.Tensor:
    """libjpeg's triangular (3/4, 1/4) 2x upsample along one axis."""
    a = v.movedim(axis, -1)
    left = torch.cat([a[..., :1], a[..., :-1]], dim=-1)
    right = torch.cat([a[..., 1:], a[..., -1:]], dim=-1)
    lo = 0.75 * a + 0.25 * left
    hi = 0.75 * a + 0.25 * right
    out = torch.stack([lo, hi], dim=-1).reshape(*a.shape[:-1], a.shape[-1] * 2)
    return out.movedim(-1, axis)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    return _up1d(_up1d(x, -1), -2)


def upsample2x_h(x: torch.Tensor) -> torch.Tensor:
    return _up1d(x, -1)


def ycbcr_to_rgb(y, cb, cr) -> torch.Tensor:
    """BT.601 full range, rounded half to even and clipped to uint8."""
    r = y + 1.402 * (cr - 128.0)
    g = y - 0.344136 * (cb - 128.0) - 0.714136 * (cr - 128.0)
    b = y + 1.772 * (cb - 128.0)
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)


def chroma_k(ky: int, mode_420: bool, chroma_full: bool = False) -> int:
    if chroma_full and mode_420:
        return min(2 * ky, 8)
    return ky


def jpeg_device_tail(y_coef, c_coef, qtabs, ky: int, mode: int = 0,
                     chroma_full: bool = False) -> torch.Tensor:
    """Batched device tail.

    y_coef [N, Yh, Yw, ky*ky] int; c_coef [N, 2, Ch, Cw, kc*kc] int;
    qtabs [N, ky*ky + kc*kc] (luma then chroma corner); mode 0 = 4:2:0,
    1 = 4:4:4, 2 = 4:2:2. Returns RGB uint8 [N, Yh*ky, Yw*ky, 3].
    """
    kc = chroma_k(ky, mode == 0, chroma_full)
    qy = qtabs[:, :ky * ky][:, None, None, :]
    qc = qtabs[:, ky * ky:ky * ky + kc * kc][:, None, None, :]
    y = decode_blocks(y_coef, qy, ky)
    cb = decode_blocks(c_coef[:, 0], qc, kc)
    cr = decode_blocks(c_coef[:, 1], qc, kc)
    if mode == 0 and kc < 2 * ky:
        cb, cr = upsample2x(cb), upsample2x(cr)
    elif mode == 2:
        cb, cr = upsample2x_h(cb), upsample2x_h(cr)
    H, W = y.shape[-2], y.shape[-1]

    def fit(c):
        # chroma canvas may be larger (crop) or smaller (zero-pad) than luma
        c = c[..., :H, :W]
        return torch.nn.functional.pad(c, (0, W - c.shape[-1], 0, H - c.shape[-2]))

    return ycbcr_to_rgb(y, fit(cb), fit(cr))


def shift_window(rgb: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """out[n, i, j] = rgb[n, clip(i + dy[n]), clip(j + dx[n])] — the RRC
    residual shift of ``_JpegIdctSplitRRC.lower`` (clamped gathers)."""
    n, Hc, Wc = rgb.shape[:3]
    dev = rgb.device
    rows = (torch.arange(Hc, device=dev)[None, :] + dy.to(torch.int64)[:, None]).clamp(0, Hc - 1)
    cols = (torch.arange(Wc, device=dev)[None, :] + dx.to(torch.int64)[:, None]).clamp(0, Wc - 1)
    nidx = torch.arange(n, device=dev)[:, None, None]
    return rgb[nidx, rows[:, :, None], cols[:, None, :]]
