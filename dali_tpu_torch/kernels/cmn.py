"""Fused crop + mirror + normalize + HWC->CHW + cast.

Counterpart of ``dali_tpu/kernels/cmn.py`` ``crop_mirror_normalize`` and of
the Pallas kernel ``dali_tpu/kernels/cmn_pallas.py`` ``cmn_pallas``. On a CUDA
tensor ``crop_mirror_normalize`` launches the hand-written Hopper kernel
``csrc/cmn.cu`` (uint8 in, CHW float32/float16 out) and raises on anything
that kernel does not take; on a CPU tensor it runs
``crop_mirror_normalize_plain``, the plain PyTorch version of the same
function.

Window semantics follow the reference: origins are clamped so the window
fits the canvas (``lax.dynamic_slice``), and a mirrored sample reverses only
its VALID width ``vw = clip(ext_w - crop_x, 0, crop_w)`` and realigns it to
column 0 (``cmn.py:56-68``).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch


class LaunchCounter:
    """Plain count of kernel launches, read by the chip smoke test to show
    that the main path went through the kernel."""

    def __init__(self):
        self.launches = 0


COUNTER = LaunchCounter()

_LIB = None
_LIB_LOCK = threading.Lock()


def _kernel_lib():
    global _LIB
    from ..native import build

    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build.kernel_library())
            fn = lib.dali_tpu_torch_cmn_u8_chw
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                           + [ctypes.c_float] * 8 + [ctypes.c_int, ctypes.c_void_p])
            _LIB = lib
    return _LIB


def fold_constants(mean, std, scale: float, shift: float, C: int):
    """out = scale * (x - mean) / std + shift = x * a + b, folded in float32
    in the reference's order (a = scale/std, b = shift - mean*scale/std)."""
    mean = np.asarray(mean, np.float32).reshape(-1)
    std = np.asarray(std, np.float32).reshape(-1)
    mean = np.broadcast_to(mean, (C,)) if mean.shape[0] == 1 else mean
    std = np.broadcast_to(std, (C,)) if std.shape[0] == 1 else std
    a = np.float32(scale) / std
    b = np.float32(shift) - mean * np.float32(scale) / std
    return a.astype(np.float32), b.astype(np.float32)


def _window(data, crop_y, crop_x, crop_h, crop_w, ext_w):
    """Clamped int32 origins and per-sample valid width, on data's device."""
    n, H, W, _ = data.shape
    if crop_h > H or crop_w > W:
        raise ValueError(f"crop window {crop_h}x{crop_w} exceeds the canvas {H}x{W}")
    dev = data.device
    crop_y = torch.as_tensor(crop_y, device=dev).to(torch.int32).reshape(n)
    crop_x = torch.as_tensor(crop_x, device=dev).to(torch.int32).reshape(n)
    ext_w = (torch.full((n,), W, dtype=torch.int32, device=dev) if ext_w is None
             else torch.as_tensor(ext_w, device=dev).to(torch.int32).reshape(n))
    vw = torch.clamp(ext_w - crop_x, 0, crop_w)
    cy = torch.clamp(crop_y, 0, H - crop_h)
    cx = torch.clamp(crop_x, 0, W - crop_w)
    return cy.contiguous(), cx.contiguous(), vw.contiguous()


def crop_mirror_normalize_plain(data, crop_y, crop_x, mirror, crop_h: int, crop_w: int,
                                mean, std, scale: float = 1.0, shift: float = 0.0,
                                output_layout: str = "CHW", out_dtype=torch.float32,
                                ext_w=None) -> torch.Tensor:
    """Plain PyTorch version: gather the window, ``x * a + b``, transpose, cast."""
    n, H, W, C = data.shape
    dev = data.device
    cy, cx, vw = _window(data, crop_y, crop_x, crop_h, crop_w, ext_w)
    a, b = (torch.from_numpy(v).to(dev) for v in fold_constants(mean, std, scale, shift, C))
    j = torch.arange(crop_w, dtype=torch.int32, device=dev)[None, :]
    col = j.expand(n, crop_w)
    if mirror is not None:
        m = torch.as_tensor(mirror, device=dev).reshape(n, 1) != 0
        vwc = vw[:, None]
        col = torch.where(m, torch.where(j < vwc, vwc - 1 - j, crop_w - 1 + vwc - j), col)
    rows = cy[:, None] + torch.arange(crop_h, dtype=torch.int32, device=dev)[None, :]
    cols = cx[:, None] + col
    nidx = torch.arange(n, device=dev)[:, None, None]
    win = data[nidx, rows[:, :, None].long(), cols[:, None, :].long()].to(torch.float32)
    out = win * a + b
    if output_layout == "CHW":
        out = out.permute(0, 3, 1, 2)
    elif output_layout != "HWC":
        raise ValueError(f"Unsupported output_layout {output_layout!r}")
    return out.to(out_dtype).contiguous()


def crop_mirror_normalize(data, crop_y, crop_x, mirror, crop_h: int, crop_w: int,
                          mean, std, scale: float = 1.0, shift: float = 0.0,
                          output_layout: str = "CHW", out_dtype=torch.float32,
                          ext_w=None) -> torch.Tensor:
    """data [N, H, W, C] uint8 -> [N, C, crop_h, crop_w] (CHW) ``out_dtype``.

    crop_y / crop_x [N] window origins; mirror [N] flags or None; ext_w [N]
    valid widths (None = the canvas width)."""
    if not data.is_cuda:
        return crop_mirror_normalize_plain(data, crop_y, crop_x, mirror, crop_h, crop_w, mean,
                                           std, scale, shift, output_layout, out_dtype, ext_w)
    n, H, W, C = data.shape
    if data.dtype != torch.uint8:
        raise NotImplementedError(f"CMN kernel takes uint8 input, got {data.dtype}")
    if output_layout != "CHW":
        raise NotImplementedError(f"CMN kernel writes CHW only, got {output_layout!r}")
    if out_dtype not in (torch.float32, torch.float16):
        raise NotImplementedError(f"CMN kernel writes float32/float16, got {out_dtype}")
    if C not in (1, 3, 4) or not data.is_contiguous() or n > 65535:
        raise NotImplementedError(
            f"CMN kernel takes a contiguous [N<=65535, H, W, C in (1, 3, 4)] batch, "
            f"got {tuple(data.shape)} contiguous={data.is_contiguous()}")
    cy, cx, vw = _window(data, crop_y, crop_x, crop_h, crop_w, ext_w)
    a, b = fold_constants(mean, std, scale, shift, C)
    a4 = [float(v) for v in a] + [0.0] * (4 - C)
    b4 = [float(v) for v in b] + [0.0] * (4 - C)
    m = None
    if mirror is not None:
        m = torch.as_tensor(mirror, device=data.device).to(torch.int32).reshape(n).contiguous()
    out = torch.empty((n, C, crop_h, crop_w), dtype=out_dtype, device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    err = _kernel_lib().dali_tpu_torch_cmn_u8_chw(
        data.data_ptr(), out.data_ptr(), cy.data_ptr(), cx.data_ptr(),
        m.data_ptr() if m is not None else None, vw.data_ptr() if m is not None else None,
        n, H, W, C, crop_h, crop_w, *a4, *b4, 1 if out_dtype == torch.float16 else 0, stream)
    if err != 0:
        raise RuntimeError(f"CMN kernel launch failed: cudaError {err}")
    COUNTER.launches += 1
    return out
