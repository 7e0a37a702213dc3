"""PaddlePaddle iterators (counterpart of ``dali_tpu/plugin/paddle.py``).

The PyTorch iterators' surface, yielding ``paddle.Tensor``s built from host
copies of the outputs (device outputs are copied to the host once per
batch). Paddle is imported when an iterator is made: without it that
raises ``ImportError``, as the reference does."""

from __future__ import annotations

from .base_iterator import DALIGenericIterator as _Base
from .base_iterator import LastBatchPolicy  # noqa: F401 (re-export)
from .base_iterator import to_numpy


class DALIGenericIterator(_Base):
    """Yields dicts of ``paddle.Tensor``."""

    def __init__(self, *args, **kwargs):
        try:
            import paddle  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "dali_tpu_torch.plugin.paddle requires PaddlePaddle (pip install paddlepaddle)"
            ) from e
        super().__init__(*args, **kwargs)

    def _to_framework(self, batches):
        import paddle

        dicts = [{k: paddle.to_tensor(to_numpy(v)) for k, v in b.items()} for b in batches]
        return dicts[0] if len(dicts) == 1 else dicts


class DALIClassificationIterator(DALIGenericIterator):
    """(data, label) convenience iterator."""

    def __init__(self, pipelines, **kwargs):
        super().__init__(pipelines, ["data", "label"], **kwargs)
