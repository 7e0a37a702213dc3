"""Batches returned by ``Pipeline.run()`` (counterpart of ``dali_tpu/tensors.py``).

``TensorListGPU.as_tensor()`` hands out the padded device tensor itself: no
copy and no DLPack hop. Per-sample shapes are the host-propagated numpy array,
so nothing is read back from the device to answer ``shape()``; ``at(i)`` and
``as_cpu()`` copy to the host and crop each sample to its valid extent.
A bfloat16 sample on the host is a ``torch.bfloat16`` tensor (numpy has no
bfloat16; ``types.py``): ``as_tensor()`` stacks it, ``as_array()`` raises.
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

    @property
    def dtype(self) -> np.dtype:
        return self._samples[0].dtype if self._samples else np.dtype(np.uint8)

    def shape(self):
        return [tuple(s.shape) for s in self._samples]

    def as_array(self) -> np.ndarray:
        if self._samples and torch.is_tensor(self._samples[0]):
            raise TypeError(f"numpy has no {self.dtype}: take this batch with as_tensor()")
        return np.stack(self._samples, 0)

    def as_tensor(self) -> torch.Tensor:
        if self._samples and torch.is_tensor(self._samples[0]):
            return torch.stack(self._samples, 0)
        return torch.from_numpy(self.as_array())

    def __repr__(self):
        return f"TensorListCPU(n={len(self)}, layout={self._layout!r})"


class TensorListGPU:
    """Device batch: padded tensor [N, *canvas] + host-known per-sample shapes
    (numpy [N, ndim], or ``None`` when every sample fills the canvas). An
    operator that propagates no host shapes leaves its batch's device
    extents (``device_shapes``), read back only when asked for."""

    def __init__(self, data: torch.Tensor, shapes: Optional[np.ndarray] = None, layout: str = "",
                 device_shapes: Optional[torch.Tensor] = None):
        self._data = data
        self._shapes = shapes
        self._layout = layout or ""
        if shapes is None and device_shapes is not None:
            self._device_shapes = device_shapes
        else:
            self._device_shapes = None

    def _host_shapes(self) -> Optional[np.ndarray]:
        if self._shapes is None and self._device_shapes is not None:
            self._shapes = self._device_shapes.cpu().numpy()
            self._device_shapes = None
        return self._shapes

    def __len__(self):
        return int(self._data.shape[0])

    def layout(self) -> str:
        return self._layout

    @property
    def dtype(self):
        return self._data.dtype

    def is_dense_tensor(self) -> bool:
        """True iff every sample fills the padded canvas exactly."""
        sh = self._host_shapes()
        if sh is None:
            return True
        return sh.shape[1] == self._data.dim() - 1 and bool(
            (sh == np.asarray(self._data.shape[1:])).all())

    def shape(self):
        sh = self._host_shapes()
        if sh is None:
            return [tuple(self._data.shape[1:])] * len(self)
        return [tuple(int(x) for x in row) for row in sh]

    def as_tensor(self) -> torch.Tensor:
        """The padded device tensor itself (no copy)."""
        return self._data

    def _crop(self, host: torch.Tensor, i: int):
        arr = host if host.dtype == torch.bfloat16 else host.numpy()
        sh = self._host_shapes()
        if sh is None:
            return arr
        return arr[tuple(slice(0, int(e)) for e in sh[i])]

    def at(self, i) -> np.ndarray:
        """Sample ``i`` on the host, cropped to its valid extent."""
        return self._crop(self._data[i].cpu(), i)

    def as_cpu(self) -> TensorListCPU:
        host = self._data.cpu()
        return TensorListCPU([self._crop(host[i], i) for i in range(len(self))], self._layout)

    def __repr__(self):
        return f"TensorListGPU(shape={tuple(self._data.shape)}, layout={self._layout!r})"
