"""Batches returned by ``Pipeline.run()`` (counterpart of ``dali_tpu/tensors.py``).

``TensorListGPU.as_tensor()`` hands out the padded device tensor itself: no
copy and no DLPack hop. Per-sample shapes are the host-propagated numpy array,
so nothing is read back from the device to answer ``shape()``; ``at(i)`` and
``as_cpu()`` copy to the host and crop each sample to its valid extent.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


class TensorListCPU:
    def __init__(self, samples: List[np.ndarray], layout: str = ""):
        self._samples = list(samples)
        self._layout = layout or ""

    def __len__(self):
        return len(self._samples)

    def at(self, i) -> np.ndarray:
        return self._samples[i]

    def layout(self) -> str:
        return self._layout

    def shape(self):
        return [tuple(s.shape) for s in self._samples]

    def as_array(self) -> np.ndarray:
        return np.stack(self._samples, 0)

    def as_tensor(self) -> torch.Tensor:
        return torch.from_numpy(self.as_array())

    def __repr__(self):
        return f"TensorListCPU(n={len(self)}, layout={self._layout!r})"


class TensorListGPU:
    """Device batch: padded tensor [N, *canvas] + host-known per-sample shapes
    (numpy [N, ndim], or ``None`` when every sample fills the canvas)."""

    def __init__(self, data: torch.Tensor, shapes: Optional[np.ndarray] = None, layout: str = ""):
        self._data = data
        self._shapes = shapes
        self._layout = layout or ""

    def __len__(self):
        return int(self._data.shape[0])

    def layout(self) -> str:
        return self._layout

    @property
    def dtype(self):
        return self._data.dtype

    def is_dense_tensor(self) -> bool:
        """True iff every sample fills the padded canvas exactly."""
        if self._shapes is None:
            return True
        sh = self._shapes
        return sh.shape[1] == self._data.dim() - 1 and bool(
            (sh == np.asarray(self._data.shape[1:])).all())

    def shape(self):
        if self._shapes is None:
            return [tuple(self._data.shape[1:])] * len(self)
        return [tuple(int(x) for x in row) for row in self._shapes]

    def as_tensor(self) -> torch.Tensor:
        """The padded device tensor itself (no copy)."""
        return self._data

    def _crop(self, host: torch.Tensor, i: int) -> np.ndarray:
        arr = host.numpy()
        if self._shapes is None:
            return arr
        return arr[tuple(slice(0, int(e)) for e in self._shapes[i])]

    def at(self, i) -> np.ndarray:
        """Sample ``i`` on the host, cropped to its valid extent."""
        return self._crop(self._data[i].cpu(), i)

    def as_cpu(self) -> TensorListCPU:
        host = self._data.cpu()
        return TensorListCPU([self._crop(host[i], i) for i in range(len(self))], self._layout)

    def __repr__(self):
        return f"TensorListGPU(shape={tuple(self._data.shape)}, layout={self._layout!r})"
