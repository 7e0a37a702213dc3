"""Batch containers (counterpart of ``dali_tpu/batch.py``).

* ``HostBatch`` — ragged numpy samples; readers, decoders and cpu ops.
* ``DeviceBatch`` — one padded ``torch.Tensor`` [N, *canvas] on the pipeline's
  device, plus per-sample valid extents ``shapes`` (an int32 tensor on the
  same device, or ``None`` when every sample fills the canvas).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch


class HostBatch:
    __slots__ = ("samples", "layout", "source_info")

    def __init__(self, samples: Sequence[np.ndarray], layout: str = "", source_info=None):
        self.samples = list(samples)
        self.layout = layout or ""
        self.source_info = source_info

    def __len__(self):
        return len(self.samples)

    @property
    def dtype(self):
        return self.samples[0].dtype if self.samples else np.dtype(np.uint8)

    @property
    def ndim(self):
        return self.samples[0].ndim if self.samples else 0

    def shapes(self) -> np.ndarray:
        return np.array([s.shape for s in self.samples], dtype=np.int32)

    def is_uniform(self) -> bool:
        s0 = self.samples[0].shape if self.samples else None
        return all(s.shape == s0 for s in self.samples)

    def __repr__(self):
        return f"HostBatch(n={len(self.samples)}, layout={self.layout!r})"


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_and_stack(batch: HostBatch, canvas: Optional[Sequence[int]] = None,
                  align: Union[Sequence[int], int] = 1, fill=0):
    """Pad ragged samples onto a common canvas and stack -> (array [N, ...],
    shapes [N, ndim]). The canvas is the per-dim max rounded up to ``align``,
    and never smaller than ``canvas`` (the grow-only policy of the boundary)."""
    n = len(batch.samples)
    if n == 0:
        raise ValueError("Cannot pad empty batch")
    ndim = batch.ndim
    shapes = batch.shapes()
    if isinstance(align, int):
        align = [align] * ndim
    out_canvas = [round_up(int(shapes[:, d].max()), align[d]) for d in range(ndim)]
    if canvas is not None:
        out_canvas = [max(c, int(p)) for c, p in zip(out_canvas, canvas)]
    # zeros() gets calloc's lazily zeroed pages; np.full writes the canvas once more
    if isinstance(fill, (int, float)) and fill == 0:
        out = np.zeros((n, *out_canvas), dtype=batch.dtype)
    else:
        out = np.full((n, *out_canvas), fill, dtype=batch.dtype)
    for i, s in enumerate(batch.samples):
        out[(i, *(slice(0, e) for e in s.shape))] = s
    return out, shapes


class Staged:
    """A host->device boundary buffer already in its final dense layout:
    ``array`` [N, ...] plus per-sample logical ``shapes`` [N, ndim]."""

    __slots__ = ("array", "shapes", "layout")

    def __init__(self, array: np.ndarray, shapes: np.ndarray, layout: str = ""):
        self.array = array
        self.shapes = shapes
        self.layout = layout


class FlatStaged:
    """A boundary batch staged flat: each sample's payload dense at
    ``offsets`` of the 1-D ``flat`` buffer, with no padding; the device
    scatters it onto the padded per-sample ``canvas`` (counterpart of
    ``dali_tpu.executor._FlatStaged``; the hybrid-JPEG planes whose
    coefficient selection does not fit the 16-bit sparse bitmaps)."""

    __slots__ = ("flat", "offsets", "shapes", "canvas", "layout")

    def __init__(self, flat, offsets, shapes, canvas, layout=""):
        self.flat = flat
        self.offsets = np.asarray(offsets, np.int32)
        self.shapes = shapes
        self.canvas = tuple(int(c) for c in canvas)
        self.layout = layout


class Esc16Staged:
    """An int16 plane escape-packed to int8 (hybrid-JPEG DC): ``dc8`` holds
    values in [-127, 127], the marker -128 points at the next int16 of
    ``esc``. Samples sit flat at ``offsets``; ``canvas`` is the padded
    per-sample canvas (counterpart of ``dali_tpu.executor._Esc16Staged``)."""

    __slots__ = ("dc8", "esc", "offsets", "shapes", "canvas", "layout")

    def __init__(self, dc8, esc, offsets, shapes, canvas, layout=""):
        self.dc8 = dc8
        self.esc = esc
        self.offsets = np.asarray(offsets, np.int32)
        self.shapes = shapes
        self.canvas = tuple(int(c) for c in canvas)
        self.layout = layout


class SparseStaged:
    """The sparse AC wire (hybrid-JPEG): per-block uint16 nonzero bitmaps
    ``mask`` (in the DC plane's block order, at the same ``offsets``) and the
    nonzero int8 values, nibble-packed into ``nibs`` with escapes in ``esc``
    (counterpart of ``dali_tpu.executor._SparseStaged``). ``canvas`` and
    ``shapes`` include the trailing coefficient dimension."""

    __slots__ = ("mask", "nibs", "esc", "offsets", "shapes", "canvas", "layout")

    def __init__(self, mask, nibs, esc, offsets, shapes, canvas, layout=""):
        self.mask = mask
        self.nibs = nibs
        self.esc = esc
        self.offsets = np.asarray(offsets, np.int32)
        self.shapes = shapes
        self.canvas = tuple(int(c) for c in canvas)
        self.layout = layout


class DeviceBatch:
    __slots__ = ("data", "shapes", "layout")

    def __init__(self, data: torch.Tensor, shapes: Optional[torch.Tensor] = None, layout: str = ""):
        self.data = data
        self.shapes = shapes
        self.layout = layout or ""

    def with_data(self, data: torch.Tensor) -> "DeviceBatch":
        """Same shapes and layout, new values (a value-only op's output)."""
        return DeviceBatch(data, self.shapes, self.layout)

    def extent(self, dim: int) -> torch.Tensor:
        """Per-sample valid extent of sample dimension ``dim`` as int32 [N]."""
        if self.shapes is None:
            n = self.data.shape[0]
            return torch.full((n,), self.data.shape[1 + dim], dtype=torch.int32,
                              device=self.data.device)
        return self.shapes[:, dim]

    def valid_mask(self) -> Optional[torch.Tensor]:
        """Boolean [N, *canvas] mask of each sample's valid region, or None
        when every sample fills the canvas."""
        if self.shapes is None:
            return None
        nd = self.data.dim()
        mask = None
        for d in range(nd - 1):
            idx = torch.arange(self.data.shape[d + 1], device=self.data.device)
            m = (idx.reshape(*([1] * (d + 1)), -1, *([1] * (nd - d - 2)))
                 < self.shapes[:, d].reshape(-1, *([1] * (nd - 1))))
            mask = m if mask is None else mask & m
        return mask

    def __repr__(self):
        return (f"DeviceBatch(shape={tuple(self.data.shape)}, layout={self.layout!r},"
                f" uniform={self.shapes is None})")
