"""TensorFlow integration (counterpart of ``dali_tpu/plugin/tf.py``; DALI's
``plugin/tf.py``).

``DALIDataset`` is a ``tf.data.Dataset`` over the pipeline's outputs, built
with ``tf.data.Dataset.from_generator``: DALI's custom TF op is not ported.
Each batch is handed to TensorFlow as host numpy arrays, so device outputs
are copied to the host once per batch. TensorFlow is imported when a
dataset or checkpoint object is made."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .base_iterator import LastBatchPolicy  # noqa: F401 (re-export)
from .base_iterator import to_numpy


def DALIDataset(
    pipeline=None,
    *,
    output_dtypes=None,
    output_shapes=None,
    batch_size: int = -1,
    num_threads: int = -1,
    device_id: int = 0,
    exec_separated: bool = False,
    prefetch_queue_depth: int = 2,
    fail_on_device_mismatch: bool = True,
):
    """A ``tf.data.Dataset`` yielding the pipeline's outputs as a tuple of
    tensors. ``output_dtypes`` is required (a ``tf.DType`` or a tuple of
    them); ``output_shapes`` is optional. ``batch_size``, ``num_threads``,
    ``device_id``, ``exec_separated`` and ``fail_on_device_mismatch`` are
    DALI's and are ignored: the pipeline keeps its own."""
    import tensorflow as tf

    if pipeline is None:
        raise ValueError("DALIDataset requires a pipeline")
    if output_dtypes is None:
        raise ValueError("output_dtypes is required (tuple of tf.DType)")
    if not isinstance(output_dtypes, (tuple, list)):
        output_dtypes = (output_dtypes,)
    output_dtypes = tuple(output_dtypes)
    if output_shapes is None:
        output_shapes = tuple(tf.TensorShape(None) for _ in output_dtypes)
    elif not isinstance(output_shapes, (tuple, list)):
        output_shapes = (output_shapes,)
    output_shapes = tuple(tf.TensorShape(s) for s in output_shapes)
    pipeline._require_built()

    def generator():
        pipeline.reset()
        while True:
            outs = pipeline.run()
            yield tuple(np.ascontiguousarray(to_numpy(o)).astype(dt.as_numpy_dtype, copy=False)
                        for o, dt in zip(outs, output_dtypes))

    spec = tuple(tf.TensorSpec(shape=s, dtype=d) for s, d in zip(output_shapes, output_dtypes))
    ds = tf.data.Dataset.from_generator(generator, output_signature=spec)
    if prefetch_queue_depth:
        ds = ds.prefetch(prefetch_queue_depth)
    return ds


def checkpointable(pipeline):
    """A ``tf.train.Checkpoint``-trackable object holding the pipeline's
    state: ``tf.train.Checkpoint(dali=checkpointable(pipe)).save(path)``
    stores ``pipe.checkpoint()``; restoring resets the pipeline and restores
    it. No batch the training loop consumed is repeated on resume; batches
    ``tf.data`` pulled ahead from the generator but the loop never consumed
    are skipped (``from_generator`` datasets cannot save their buffers)."""
    import tensorflow as tf

    class _DALIPythonState(tf.train.experimental.PythonState):
        def __init__(self, pipe):
            self._pipe = pipe

        def serialize(self):
            return self._pipe.checkpoint()

        def deserialize(self, string_value):
            if isinstance(string_value, bytes):
                string_value = string_value.decode("utf-8")
            # a restart mid-iteration must not leave stale in-flight batches
            self._pipe.reset()
            self._pipe.restore_checkpoint(string_value)

    return _DALIPythonState(pipeline)


def DALIIterator():
    """The legacy iterator factory: a callable with DALI's
    ``DALIIterator()(pipeline, output_dtypes, output_shapes, ...)`` signature
    returning a one-shot iterator over a ``DALIDataset``."""

    def dali_iterator(pipeline, output_dtypes, output_shapes=None, **kwargs):
        return iter(DALIDataset(pipeline, output_dtypes=output_dtypes,
                                output_shapes=output_shapes, **kwargs))

    return dali_iterator


class DALIGenericIterator:
    """Dict-style iterator over one ``DALIDataset`` per pipeline, for users
    who do not want ``tf.data``."""

    def __init__(self, pipelines, output_map: Sequence[str], output_dtypes,
                 size: int = -1, auto_reset: bool = False, **kwargs):
        if not isinstance(pipelines, (list, tuple)):
            pipelines = [pipelines]
        self._pipes = pipelines
        self.output_map = list(output_map)
        self._ds_iters = [iter(DALIDataset(p, output_dtypes=output_dtypes, **kwargs))
                          for p in pipelines]
        self._size = size
        self._counter = 0
        self._auto_reset = auto_reset
        self.batch_size = pipelines[0].max_batch_size

    def __iter__(self):
        return self

    def reset(self):
        """Start a new epoch: only the counter restarts; the pipelines go on
        streaming through their datasets (new datasets would race the old
        ones' prefetch on the same pipelines)."""
        self._counter = 0

    def __next__(self):
        if self._size > 0 and self._counter >= self._size:
            if self._auto_reset:
                self.reset()
            raise StopIteration
        outs = [next(it) for it in self._ds_iters]
        self._counter += self.batch_size * len(self._pipes)
        dicts = [dict(zip(self.output_map, o)) for o in outs]
        return dicts[0] if len(dicts) == 1 else dicts
