"""PyTorch iterators (counterpart of ``dali_tpu/plugin/pytorch.py``).

Device outputs are already ``torch.Tensor``s on the pipeline's device and are
yielded as they are; the reference's DLPack / numpy hop is gone. CPU outputs
(labels) become CPU tensors. Each step yields a list with one dict per
pipeline, like the reference.
"""

from __future__ import annotations

from .base_iterator import DALIGenericIterator as _Base
from .base_iterator import LastBatchPolicy  # noqa: F401


class DALIGenericIterator(_Base):
    def _to_framework(self, batches):
        return [{k: v.as_tensor() for k, v in b.items()} for b in batches]


class DALIClassificationIterator(DALIGenericIterator):
    """(data, label) convenience iterator."""

    def __init__(self, pipelines, **kwargs):
        super().__init__(pipelines, ["data", "label"], **kwargs)
