"""Separable resampling of one sample on the host, in numpy (counterpart of
the host path of ``dali_tpu/kernels/resample.py``: ``_window`` with numpy,
``_host_tap_plan`` and ``host_resample``).

The same filter windows as the device resampler (``kernels/resample.py``),
but as the reference computes them on the host: per axis a tap plan of
gather indices and float32 weights, then one ``np.einsum`` per axis. The
einsum is kept, not replaced by the torch resampler, because its summation
order is what makes ``Resize`` and ``RandomResizedCrop`` on the cpu
bit-equal to the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import DALIInterpType, to_bfloat16, to_numpy_type
from .resample import _BASE_RADIUS, max_taps


def _window(interp: DALIInterpType, t: np.ndarray) -> np.ndarray:
    """Filter window at normalized distance t (|t| <= 1 is the support)."""
    a = np.abs(t)
    if interp in (DALIInterpType.INTERP_LINEAR, DALIInterpType.INTERP_TRIANGULAR):
        return np.maximum(0.0, 1.0 - a)
    if interp == DALIInterpType.INTERP_NN:
        return np.where(a <= 0.5, 1.0, 0.0)
    if interp == DALIInterpType.INTERP_CUBIC:
        x = a * 2.0
        A = -0.5
        w1 = ((A + 2) * x - (A + 3)) * x * x + 1
        w2 = ((A * x - 5 * A) * x + 8 * A) * x - 4 * A
        return np.where(x < 1.0, w1, np.where(x < 2.0, w2, 0.0))
    if interp == DALIInterpType.INTERP_GAUSSIAN:
        x = a * 2.0
        return np.exp(-(x * x))
    if interp == DALIInterpType.INTERP_LANCZOS3:
        x = a * 3.0

        def sinc(v):
            v = np.where(np.abs(v) < 1e-8, 1e-8, v)
            return np.sin(np.pi * v) / (np.pi * v)

        return np.where(x < 3.0, sinc(x) * sinc(x / 3.0), 0.0)
    raise ValueError(f"Unsupported interp {interp}")


def tap_plan(out_size: int, roi_start, roi_size, extent: int, interp, antialias: bool):
    """(idx [taps, out], w [taps, out] float32) of one axis: output pixel
    center x + 0.5 maps to roi_start + (x + 0.5) * roi_size / out_size;
    weights normalized to sum 1, indices clamped into the extent."""
    scale = roi_size / out_size
    x = (np.arange(out_size, dtype=np.float32) + 0.5) * np.float32(scale) + np.float32(roi_start)
    center = x - 0.5
    if interp == DALIInterpType.INTERP_NN:
        idx = np.clip(np.floor(x).astype(np.int32), 0, extent - 1)
        return idx[None, :], np.ones((1, out_size), np.float32)
    base = _BASE_RADIUS[interp]
    radius = base * max(scale, 1.0) if antialias else base
    taps = max_taps(interp, scale if antialias else 1.0, antialias)
    first = np.ceil(center - radius).astype(np.int32)
    idx = first[None, :] + np.arange(taps, dtype=np.int32)[:, None]
    t = (idx.astype(np.float32) - center[None, :]) / np.float32(radius)
    w = np.asarray(_window(interp, t), np.float32)
    norm = w.sum(axis=0, keepdims=True)
    w = w / np.where(norm == 0, 1.0, norm)
    return np.clip(idx, 0, extent - 1), w


def saturate(out: np.ndarray, dt):
    """Round half to even and clip to an integer type's range; floats pass
    (``torch.bfloat16``, the port's host bfloat16, through ``to_bfloat16``)."""
    if dt is torch.bfloat16:
        return to_bfloat16(out.astype(np.float32))
    if np.issubdtype(dt, np.integer):
        info = np.iinfo(dt)
        out = np.clip(np.round(out), info.min, info.max)
    return out.astype(dt)


def host_resample(img: np.ndarray, out_h: int, out_w: int,
                  interp=DALIInterpType.INTERP_LINEAR, antialias: bool = True,
                  roi_start=(0.0, 0.0), roi_size=None, out_dtype=None) -> np.ndarray:
    """Separable resample of one HW(C) sample: rows, then columns, each an
    einsum over the taps in float32; ``out_dtype`` (default the input's),
    integers rounded half to even and clipped."""
    h, w = img.shape[:2]
    if roi_size is None:
        roi_size = (float(h), float(w))
    f = img.astype(np.float32)
    idx_y, w_y = tap_plan(out_h, roi_start[0], roi_size[0], h, interp, antialias)
    tmp = np.einsum("to,towc->owc", w_y, f[idx_y])
    idx_x, w_x = tap_plan(out_w, roi_start[1], roi_size[1], w, interp, antialias)
    out = np.einsum("to,htoc->hoc", w_x, tmp[:, idx_x])
    return saturate(out, img.dtype if out_dtype is None else to_numpy_type(out_dtype))


def host_resample_volume(img: np.ndarray, out_d: int, out_h: int, out_w: int, interp,
                         antialias: bool = True) -> np.ndarray:
    """A DHWC volume: each depth slice resampled in float32, then the depth
    pass with the same tap plan, one final quantization."""
    d = img.shape[0]
    planes = np.stack([host_resample(img[k].astype(np.float32), out_h, out_w, interp, antialias)
                       for k in range(d)])
    if planes.ndim == 3:
        planes = planes[..., None]
    if out_d != d:
        idx_z, w_z = tap_plan(out_d, 0.0, float(d), d, interp, antialias)
        planes = np.einsum("tq,tqhwc->qhwc", w_z, planes[idx_z])
    return saturate(planes, img.dtype)
