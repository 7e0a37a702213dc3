"""Pointwise colour and intensity math on torch tensors (counterpart of
``dali_tpu/kernels/pointwise.py``): the formulas and constants of the
reference's device lowering, in the same order of operations.

* brightness/contrast: out = brightness_shift*R + brightness*(contrast_center
  + contrast*(in - contrast_center)), R the output dtype's range;
* hue rotates and saturation scales chroma in linear YIQ space;
* gray uses ITU-R BT.601 weights; YCbCr is BT.601 studio swing.
"""

from __future__ import annotations

import ctypes
import functools

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


def _fma_sum(pairs) -> torch.Tensor:
    """float32 sum of the products a * b of float32 pairs, in the order of
    XLA's CPU dot: the first product rounded, then a chain of fused
    multiply-adds (one rounding per term), so that a value next to a rounding
    tie lands on the reference's side. On the CPU each fused multiply-add is
    emulated in float64; on the card ``torch.addcmul`` is one (its CUDA
    kernel contracts to an FMA: ``tools/bench_color_twist.py`` holds it
    equal to the emulation)."""
    acc = None
    for a, b in pairs:
        if acc is None:
            acc = a * b
        elif acc.is_cuda:
            acc = torch.addcmul(acc, a, b)
        else:
            acc = (acc.to(torch.float64) + a.to(torch.float64) * b.to(torch.float64)).to(
                torch.float32)
    return acc


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., 3, 3] @ b [..., 3, 3], each entry summed as ``_fma_sum``."""
    return _fma_sum((a[..., :, k, None], b[..., None, k, :]) for k in range(3))


def _unfused_rows(m: int) -> int:
    """How many leading rows of XLA's CPU dot [m, 3] x [3, 3] sum their first
    two columns unfused: whole tiles of 8 rows, or none below 16 rows and
    from 20 to 23 and 28 to 31 (fitted against jax.numpy for m up to 3,300)."""
    return 0 if m < 16 or (m < 32 and m % 8 >= 4) else 8 * (m // 8)


def _xla_dot(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [..., 3] @ b [3, 3] as XLA's CPU dot of x's rows, flattened to [M, 3],
    sums it: in the first ``_unfused_rows(M)`` rows the first two columns are
    summed unfused (each product rounded, added left to right); every other
    entry takes the chain of ``_fma_sum``."""
    fused = _fma_sum((x[..., k, None], b[k]) for k in range(3))
    rows = x[..., 0].numel()
    u = _unfused_rows(rows)
    if u == 0:
        return fused
    unfused = (x[..., 0, None] * b[0] + x[..., 1, None] * b[1]) + x[..., 2, None] * b[2]
    tiled = (torch.arange(rows, device=x.device) < u).reshape(*x.shape[:-1], 1)
    return torch.where(tiled & torch.tensor([True, True, False], device=x.device), unfused, fused)


@functools.lru_cache(maxsize=None)
def _libm():
    lib = ctypes.CDLL("libm.so.6")
    for name in ("cosf", "sinf"):
        getattr(lib, name).restype = ctypes.c_float
        getattr(lib, name).argtypes = [ctypes.c_float]
    return lib


def _cos_sin(h: torch.Tensor):
    """cos and sin of float32 radians; on the CPU through the C library's
    cosf and sinf, which XLA's CPU backend calls (torch's vectorised ones
    differ from them by an ulp on about 5% of inputs)."""
    if h.device.type != "cpu":
        return torch.cos(h), torch.sin(h)
    vals = h.tolist()
    return tuple(torch.tensor([f(v) for v in vals], dtype=torch.float32)
                 for f in (_libm().cosf, _libm().sinf))


def color_twist_matrices(hue_deg, saturation, value) -> torch.Tensor:
    """Per-sample [N, 3, 3] hue/saturation/value matrices from [N] vectors,
    each product summed in XLA-CPU's order (``_xla_dot``, ``_matmul3``)."""
    hue_deg, saturation, value = (v.to(torch.float32).reshape(-1)
                                  for v in (hue_deg, saturation, value))
    h = hue_deg * (np.pi / 180.0)
    c, s = _cos_sin(h)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    hue_mat = torch.stack([torch.stack([ones, zeros, zeros], -1),
                           torch.stack([zeros, c, -s], -1),
                           torch.stack([zeros, s, c], -1)], -2)
    sv = value[:, None] * torch.stack([torch.ones_like(saturation), saturation, saturation], -1)
    sat_mat = sv[:, :, None] * torch.eye(3, dtype=torch.float32, device=sv.device)
    to_yiq = torch.from_numpy(_rgb_to_yiq()).to(sv.device)
    from_yiq = torch.from_numpy(np.linalg.inv(_rgb_to_yiq()).astype(np.float32)).to(sv.device)
    return _matmul3(from_yiq, _matmul3(sat_mat, _xla_dot(hue_mat, to_yiq)))


def apply_color_matrices(img: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """img [N, ..., C] x per-sample mats [N, 3, 3] -> [N, ..., 3], summed as
    ``_fma_sum`` (a batch of one image as the plain dot ``_xla_dot``, as XLA
    folds it); a 1-channel image broadcasts: x * (m[d, 0] + m[d, 1] + m[d, 2])."""
    m = mats.reshape(mats.shape[0], *(1,) * (img.dim() - 2), 3, 3)
    if img.shape[-1] == 1:
        return img * ((m[..., 0] + m[..., 1]) + m[..., 2])
    if img.shape[0] == 1 and img.dim() > 3:
        return _xla_dot(img[0], mats[0].T)[None]
    return _fma_sum((img[..., c, None], m[..., c]) for c in range(3))


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
