"""Pointwise colour and intensity math on torch tensors (counterpart of
``dali_tpu/kernels/pointwise.py``): the formulas and constants of the
reference's device lowering, in the same order of operations.

* brightness/contrast: out = brightness_shift*R + brightness*(contrast_center
  + contrast*(in - contrast_center)), R the output dtype's range;
* hue rotates and saturation scales chroma in linear YIQ space;
* gray uses ITU-R BT.601 weights; YCbCr is BT.601 studio swing.
"""

from __future__ import annotations

import numpy as np
import torch

_Y_WEIGHTS = np.array([0.299, 0.587, 0.114], np.float32)


def dtype_range(dtype: torch.dtype) -> float:
    return 1.0 if dtype.is_floating_point or dtype == torch.bool else float(torch.iinfo(dtype).max)


def saturate_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round half to even and clamp to the integer range; floats pass."""
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        x = torch.clamp(torch.round(x), info.min, info.max)
    return x.to(dtype)


def _rgb_to_yiq() -> np.ndarray:
    return np.array([[0.299, 0.587, 0.114],
                     [0.595716, -0.274453, -0.321263],
                     [0.211456, -0.522591, 0.311135]], np.float32)


def color_twist_matrices(hue_deg, saturation, value) -> torch.Tensor:
    """Per-sample [N, 3, 3] hue/saturation/value matrices from [N] vectors."""
    hue_deg, saturation, value = (v.to(torch.float32).reshape(-1)
                                  for v in (hue_deg, saturation, value))
    h = hue_deg * (np.pi / 180.0)
    c, s = torch.cos(h), torch.sin(h)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    hue_mat = torch.stack([torch.stack([ones, zeros, zeros], -1),
                           torch.stack([zeros, c, -s], -1),
                           torch.stack([zeros, s, c], -1)], -2)
    sv = value[:, None] * torch.stack([torch.ones_like(saturation), saturation, saturation], -1)
    sat_mat = sv[:, :, None] * torch.eye(3, dtype=torch.float32, device=sv.device)
    to_yiq = torch.from_numpy(_rgb_to_yiq()).to(sv.device)
    from_yiq = torch.from_numpy(np.linalg.inv(_rgb_to_yiq()).astype(np.float32)).to(sv.device)
    return from_yiq @ (sat_mat @ (hue_mat @ to_yiq))


def apply_color_matrices(img: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """img [N, ..., 3] x per-sample mats [N, 3, 3]."""
    return torch.einsum("n...c,ndc->n...d", img, mats)


def brightness_contrast(img, brightness, brightness_shift, contrast, contrast_center,
                        out_dtype: torch.dtype) -> torch.Tensor:
    x = img.to(torch.float32)
    out = (brightness_shift * dtype_range(out_dtype)
           + brightness * (contrast_center + contrast * (x - contrast_center)))
    return saturate_cast(out, out_dtype)


def _apply_color_matrix(img, mat: np.ndarray, offset=None):
    out = torch.matmul(img, torch.from_numpy(np.ascontiguousarray(mat.T)).to(img))
    if offset is not None:
        out = out + torch.from_numpy(offset).to(img)
    return out


_CSC = {}


def color_space_matrix(src: str, dst: str):
    """(mat, offset) of an RGB/BGR/YCbCr conversion (BT.601 studio swing)."""
    key = (src, dst)
    if key in _CSC:
        return _CSC[key]
    ident = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    rgb2ycbcr = (np.array([[0.25678823529, 0.50412941176, 0.09790588235],
                           [-0.14822289945, -0.29099278682, 0.43921568627],
                           [0.43921568627, -0.36778831435, -0.07142737192]], np.float32),
                 np.array([16, 128, 128], np.float32))
    y = 255.0 / 219
    ycbcr2rgb = (np.array([[y, 0, 1.5960267848], [y, -0.39176228842, -0.81296764538],
                           [y, 2.0172321417, 0]], np.float32),
                 np.array([-16 * y - 1.5960267848 * 128,
                           -16 * y + (0.39176228842 + 0.81296764538) * 128,
                           -16 * y - 2.0172321417 * 128], np.float32))
    swap = (np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]], np.float32), np.zeros(3, np.float32))
    table = {("RGB", "RGB"): ident, ("BGR", "BGR"): ident, ("RGB", "YCbCr"): rgb2ycbcr,
             ("YCbCr", "RGB"): ycbcr2rgb, ("RGB", "BGR"): swap, ("BGR", "RGB"): swap}
    if key in table:
        _CSC[key] = table[key]
    else:  # compose through RGB
        m1, o1 = color_space_matrix(src, "RGB")
        m2, o2 = color_space_matrix("RGB", dst)
        _CSC[key] = ((m2 @ m1).astype(np.float32), (m2 @ o1 + o2).astype(np.float32))
    return _CSC[key]


def convert_color_space(img: torch.Tensor, src: str, dst: str, out_dtype) -> torch.Tensor:
    if dst == "GRAY":
        if src == "BGR":
            img = img.flip(-1)
        elif src == "YCbCr":  # studio-swing Y -> full-range gray
            return saturate_cast((img[..., 0:1].to(torch.float32) - 16.0) * (255.0 / 219.0),
                                 out_dtype)
        w = torch.from_numpy(_Y_WEIGHTS).to(img.device)
        return saturate_cast(torch.sum(img.to(torch.float32) * w, dim=-1, keepdim=True),
                             out_dtype)
    if src == "GRAY":
        rep = torch.cat([img.to(torch.float32)] * 3, dim=-1)
        if dst == "YCbCr":
            return saturate_cast(_apply_color_matrix(rep, *color_space_matrix("RGB", "YCbCr")),
                                 out_dtype)
        return saturate_cast(rep, out_dtype)
    mat, off = color_space_matrix(src, dst)
    return saturate_cast(_apply_color_matrix(img.to(torch.float32), mat, off), out_dtype)
