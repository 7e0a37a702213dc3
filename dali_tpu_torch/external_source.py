"""``fn.external_source``, user data injection (counterpart of
``dali_tpu/external_source.py``), with the reference's full signature.

A callable ``source`` produces samples unless ``batch=True`` is passed; an
iterable or generator function produces batches. ``device="gpu"`` is a cpu
injection followed by ``.gpu()``. ``cuda_stream``, ``use_copy_kernel``,
``batch_info`` and ``blocking`` are accepted for compatibility; other keyword
arguments are checked against the operator's schema.
"""

from __future__ import annotations


def external_source(
    source=None,
    num_outputs=None,
    *,
    cycle=None,
    name=None,
    device="cpu",
    layout="",
    dtype=None,
    ndim=None,
    cuda_stream=None,
    use_copy_kernel=None,
    batch=None,
    repeat_last=False,
    batch_info=False,
    parallel=False,
    no_copy=False,
    prefetch_queue_depth=1,
    blocking=None,
    **kwargs,
):
    from . import _op_call

    if device not in ("cpu", "gpu"):
        raise ValueError(f"external_source device must be 'cpu' or 'gpu', got {device!r}")
    if device == "gpu":
        node = external_source(source=source, num_outputs=num_outputs, cycle=cycle, name=name,
                               layout=layout, dtype=dtype, ndim=ndim, batch=batch,
                               repeat_last=repeat_last, parallel=parallel, no_copy=no_copy,
                               prefetch_queue_depth=prefetch_queue_depth, **kwargs)
        if num_outputs is not None and num_outputs > 1:
            return tuple(n.gpu() for n in node)
        return node.gpu()
    if isinstance(cycle, bool):
        cycle = "quiet" if cycle else "no"
    if batch is None:
        # callables produce samples, iterables produce batches
        batch = not callable(source) if source is not None else True
    return _op_call("ExternalSource", device="cpu", inputs=(), name=name,
                    num_outputs=num_outputs, batch=batch, cycle=cycle, layout=layout,
                    dtype=dtype, ndim=ndim, repeat_last=repeat_last, parallel=parallel,
                    no_copy=no_copy, prefetch_queue_depth=prefetch_queue_depth, _source=source,
                    **kwargs)


class ExternalSource:
    """The object form (``ops.ExternalSource``): arguments bound at
    construction, merged with those of each call."""

    def __init__(self, source=None, num_outputs=None, **kwargs):
        self._source = source
        self._num_outputs = num_outputs
        self._kwargs = kwargs

    def __call__(self, *, source=None, **kwargs):
        merged = dict(self._kwargs)
        merged.update(kwargs)
        return external_source(source=source if source is not None else self._source,
                               num_outputs=self._num_outputs, **merged)
