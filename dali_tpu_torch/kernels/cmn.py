"""Fused crop + mirror + normalize + layout + cast.

Counterpart of ``dali_tpu/kernels/cmn.py`` ``crop_mirror_normalize`` and of
the Pallas kernel ``dali_tpu/kernels/cmn_pallas.py`` ``cmn_pallas``. On a CUDA
tensor ``crop_mirror_normalize`` launches the hand-written Hopper kernel
``csrc/cmn.cu`` and raises on anything that kernel does not take; on a CPU
tensor it runs ``crop_mirror_normalize_plain``, the plain PyTorch version of
the same function. Both take uint8, float16 or float32 input with 1-4
channels and write float32, float16, uint8, int8, int16 or int32, CHW or HWC
(``""`` is HWC), with ``pad_output`` appending zero channels up to 4 after
normalisation. ``x * a + b`` is a product and a sum, each rounded, as the
reference computes it; an integer output converts as the reference's XLA
convert does: toward zero, saturated to the type's range, NaN to 0
(``saturating_cast``). Volumes and sequences reach it with their depth or
frames folded into the batch (``backend/image.py``).

The reference has two window semantics (``cmn.py:51-84``), kept exactly:

* without ``fill``, origins are clamped so the window fits the canvas
  (``lax.dynamic_slice``; the operator passes non-negative origins, and a
  negative one clamps to 0 here where ``dynamic_slice`` would first wrap it),
  and a mirrored sample reverses only its VALID width
  ``vw = clip(ext_w - crop_x, 0, crop_w)`` (from the unclamped origin) and
  realigns it to column 0;
* with ``fill`` (the pad policy), origins may be negative or run past the
  extent; a pixel outside ``[0, ext_h) x [0, ext_w)`` takes ``fill`` (an
  output value, not normalised, broadcast from length 1), and the mirror
  reverses the whole window, fill included.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch


class LaunchCounter:
    """Plain count of kernel launches, read by the chip smoke test to show
    that the main path went through the kernel."""

    def __init__(self):
        self.launches = 0


COUNTER = LaunchCounter()

# input and output dtypes the kernel takes, by the codes of its entry point
_IN_CODES = {torch.uint8: 0, torch.float16: 1, torch.float32: 2}
_OUT_CODES = {torch.float32: 0, torch.float16: 1, torch.uint8: 2, torch.int8: 3, torch.int16: 4,
              torch.int32: 5}

_LIB = None
_LIB_LOCK = threading.Lock()


def _kernel_lib():
    global _LIB
    from ..native import build

    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build.kernel_library())
            fn = lib.dali_tpu_torch_cmn
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                           + [ctypes.c_void_p, ctypes.c_void_p])
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


def _as_key(v):
    if v is None or isinstance(v, tuple):
        return v
    return tuple(np.asarray(v, np.float32).reshape(-1).tolist())


@functools.lru_cache(maxsize=64)
def _folded(mean, std, scale, shift, fill, C):
    a, b = fold_constants(mean, std, scale, shift, C)
    f = np.array(np.broadcast_to(np.asarray(0.0 if fill is None else fill, np.float32)
                                 .reshape(-1), (C,)))
    packed = np.zeros(12, np.float32)
    packed[:C], packed[4:4 + C], packed[8:8 + C] = a, b, f
    for v in (a, b, f, packed):
        v.flags.writeable = False
    return a, b, f, packed


def constants(mean, std, scale, shift, fill, C):
    """(a [C], b [C], fill [C], the 12 floats a|b|fill padded to 4 that the
    kernel takes), float32. Cached by value: an operator, which passes the
    same tuples on every call, folds its constants once."""
    return _folded(_as_key(mean), _as_key(std), float(scale), float(shift), _as_key(fill), C)


def saturating_cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """float32 -> ``dtype`` as XLA's convert: floats round to nearest; an
    integer type takes the value truncated toward zero, saturated to its
    range, NaN as 0."""
    if dtype.is_floating_point:
        return x.to(dtype)
    info = torch.iinfo(dtype)
    t = torch.nan_to_num(torch.trunc(x), nan=0.0, posinf=float(info.max), neginf=float(info.min))
    if dtype == torch.int32:  # 2**31 - 1 is no float32: clamp below it, then saturate
        out = t.clamp(float(info.min), 2147483520.0).to(dtype)
        return torch.where(t >= 2.0 ** 31, torch.full_like(out, info.max), out)
    return t.clamp(info.min, info.max).to(dtype)


def _check_form(output_layout: str, out_dtype) -> bool:
    """True for CHW output; raises on what neither version writes."""
    if out_dtype not in _OUT_CODES:
        raise NotImplementedError(
            "CropMirrorNormalize writes float32, float16 and the integer outputs uint8, int8, "
            f"int16 and int32 in dali_tpu_torch, got {out_dtype}")
    if output_layout not in ("CHW", "HWC", ""):
        raise ValueError(f"Unsupported output_layout {output_layout!r}")
    return output_layout == "CHW"


def _check_window(H, W, crop_h, crop_w):
    if crop_h > H or crop_w > W:
        raise ValueError(f"crop window {crop_h}x{crop_w} exceeds the canvas {H}x{W} "
                         "(only the pad policy takes a larger window)")


def _int32(v, n, device):
    """Per-sample int32 [n] on ``device`` (no copy when it already is)."""
    if v is None:
        return None
    if (torch.is_tensor(v) and v.dtype == torch.int32 and v.device == device
            and v.is_contiguous()):
        return v.reshape(n)
    return torch.as_tensor(v, device=device).to(torch.int32).reshape(n).contiguous()


def crop_mirror_normalize_plain(data, crop_y, crop_x, mirror, crop_h: int, crop_w: int,
                                mean, std, scale: float = 1.0, shift: float = 0.0,
                                output_layout: str = "CHW", out_dtype=torch.float32,
                                pad_output: bool = False, ext_h=None, ext_w=None,
                                fill=None, src_index=None) -> torch.Tensor:
    """Plain PyTorch version: gather the window, ``x * a + b``, fill, pad
    channels, transpose, cast."""
    chw = _check_form(output_layout, out_dtype)
    if src_index is not None:
        data = data[torch.as_tensor(src_index, device=data.device).long().reshape(-1)]
    n, H, W, C = data.shape
    dev = data.device
    a, b, f, _ = constants(mean, std, scale, shift, fill, C)
    a, b = torch.tensor(a, device=dev), torch.tensor(b, device=dev)
    cy, cx = _int32(crop_y, n, dev), _int32(crop_x, n, dev)
    ew = _int32(ext_w, n, dev) if ext_w is not None else torch.full((n,), W, device=dev)
    i = torch.arange(crop_h, dtype=torch.int32, device=dev)[None, :]
    j = torch.arange(crop_w, dtype=torch.int32, device=dev)[None, :]
    m = None if mirror is None else torch.as_tensor(mirror, device=dev).reshape(n, 1) != 0
    nidx = torch.arange(n, device=dev)[:, None, None]
    if fill is None:
        _check_window(H, W, crop_h, crop_w)
        col = j.expand(n, crop_w)
        if m is not None:
            vw = torch.clamp(ew - cx, 0, crop_w)[:, None]
            col = torch.where(m, torch.where(j < vw, vw - 1 - j, crop_w - 1 + vw - j), col)
        rows = torch.clamp(cy, 0, H - crop_h)[:, None] + i
        cols = torch.clamp(cx, 0, W - crop_w)[:, None] + col
        win = data[nidx, rows[:, :, None].long(), cols[:, None, :].long()].to(torch.float32)
        out = win * a + b
    else:
        eh = _int32(ext_h, n, dev) if ext_h is not None else torch.full((n,), H, device=dev)
        rows, cols = cy[:, None] + i, cx[:, None] + j
        win = data[nidx, rows.clamp(0, H - 1)[:, :, None].long(),
                   cols.clamp(0, W - 1)[:, None, :].long()].to(torch.float32)
        valid = (((rows >= 0) & (rows < eh[:, None]))[:, :, None]
                 & ((cols >= 0) & (cols < ew[:, None]))[:, None, :])
        out = torch.where(valid[..., None], win * a + b, torch.tensor(f, device=dev))
        if m is not None:
            out = torch.where(m[:, :, None, None], out.flip(2), out)
    if pad_output and C < 4:
        out = torch.nn.functional.pad(out, (0, 4 - C))
    if chw:
        out = out.permute(0, 3, 1, 2)
    return saturating_cast(out, out_dtype).contiguous()


def launch_args(data, crop_y, crop_x, mirror, crop_h: int, crop_w: int, mean, std,
                scale: float = 1.0, shift: float = 0.0, output_layout: str = "CHW",
                out_dtype=torch.float32, pad_output: bool = False, ext_h=None, ext_w=None,
                fill=None, src_index=None):
    """Checks a CUDA batch against what the kernel takes and allocates the
    output. Returns (output, the arguments of the C entry point
    ``dali_tpu_torch_cmn``, the tensors and buffers they point into)."""
    chw = _check_form(output_layout, out_dtype)
    n_in, H, W, C = data.shape
    n = n_in if src_index is None else int(torch.as_tensor(src_index).numel())
    if data.dtype not in _IN_CODES:
        raise NotImplementedError(f"CMN kernel reads uint8/float16/float32, got {data.dtype}")
    if not data.is_contiguous() or not 1 <= C <= 4:
        raise NotImplementedError(
            f"CMN kernel takes a contiguous [N, H, W, C <= 4] batch, got {tuple(data.shape)} "
            f"contiguous={data.is_contiguous()}")
    if fill is None:
        _check_window(H, W, crop_h, crop_w)
    dev = data.device
    packed = constants(mean, std, scale, shift, fill, C)[3]
    src = _int32(src_index, n, dev)  # each in [0, n_in): not checked, that would sync
    per_sample = [_int32(v, n, dev) for v in (crop_y, crop_x, mirror, ext_h, ext_w)]
    c_out = 4 if pad_output and C < 4 else C
    shape = (n, c_out, crop_h, crop_w) if chw else (n, crop_h, crop_w, c_out)
    out = torch.empty(shape, dtype=out_dtype, device=dev)
    args = (data.data_ptr(), src.data_ptr() if src is not None else None, out.data_ptr(),
            *(t.data_ptr() if t is not None else None for t in per_sample),
            n, H, W, C, crop_h, crop_w, c_out, _IN_CODES[data.dtype],
            _OUT_CODES[out_dtype], int(not chw), int(fill is not None),
            packed.ctypes.data, torch.cuda.current_stream(dev).cuda_stream)
    return out, args, (per_sample, src, packed)


def crop_mirror_normalize(data, crop_y, crop_x, mirror, crop_h: int, crop_w: int,
                          mean, std, scale: float = 1.0, shift: float = 0.0,
                          output_layout: str = "CHW", out_dtype=torch.float32,
                          pad_output: bool = False, ext_h=None, ext_w=None,
                          fill=None, src_index=None) -> torch.Tensor:
    """data [N, H, W, C] -> [N, C', crop_h, crop_w] (CHW) or [N, crop_h,
    crop_w, C'] (HWC) ``out_dtype``, C' = 4 with ``pad_output``, else C.

    crop_y / crop_x [N] window origins; mirror [N] flags or None; ext_h /
    ext_w [N] valid extents (None = the canvas); fill: output values of
    out-of-bounds pixels, which selects the pad policy (None = clamp).
    ``src_index`` [M] (None = each sample once): output sample i reads
    input sample src_index[i], and N above is M (a volume's depth window
    folded into the batch reads its slices in place)."""
    if not data.is_cuda:
        return crop_mirror_normalize_plain(data, crop_y, crop_x, mirror, crop_h, crop_w, mean,
                                           std, scale, shift, output_layout, out_dtype,
                                           pad_output, ext_h, ext_w, fill, src_index)
    out, args, _ = launch_args(data, crop_y, crop_x, mirror, crop_h, crop_w, mean, std, scale,
                               shift, output_layout, out_dtype, pad_output, ext_h, ext_w, fill,
                               src_index)
    if out.numel() == 0:
        return out
    err = _kernel_lib().dali_tpu_torch_cmn(*args)
    if err != 0:
        raise RuntimeError(f"CMN kernel launch failed: cudaError {err}")
    COUNTER.launches += 1
    return out
