"""PyTorch iterators (counterpart of ``dali_tpu/plugin/pytorch.py``).

Device outputs are already ``torch.Tensor``s on the pipeline's device and are
yielded as they are; the reference's DLPack / numpy hop is gone. CPU outputs
(labels) become CPU tensors. Each step yields a list with one dict per
pipeline, like the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tensors import TensorListCPU
from .base_iterator import DALIGenericIterator as _Base
from .base_iterator import LastBatchPolicy  # noqa: F401


def to_torch_type(np_dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, dtype=np_dtype)).dtype


def feed_ndarray(tensor_list, arr: torch.Tensor, cuda_stream=None) -> torch.Tensor:
    """Copy a whole batch into the preallocated ``arr``: a ``TensorListGPU``
    device to device (no host hop; on ``cuda_stream`` when given), a
    ``TensorListCPU`` from its stacked samples."""
    if isinstance(tensor_list, TensorListCPU):
        src = torch.from_numpy(np.ascontiguousarray(tensor_list.as_array()))
    else:
        src = tensor_list.as_tensor()
    if cuda_stream is not None:
        with torch.cuda.stream(cuda_stream):
            arr.copy_(src, non_blocking=True)
    else:
        arr.copy_(src)
    return arr


class DALIGenericIterator(_Base):
    def _to_framework(self, batches):
        return [{k: v.as_tensor() for k, v in b.items()} for b in batches]


class DALIClassificationIterator(DALIGenericIterator):
    """(data, label) convenience iterator."""

    def __init__(self, pipelines, **kwargs):
        super().__init__(pipelines, ["data", "label"], **kwargs)
