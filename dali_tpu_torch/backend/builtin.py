"""Built-in structural operators (counterpart of ``dali_tpu/backend/builtin.py``):
``_CopyToDevice`` (``DataNode.gpu()``), ``Copy``, ``Constant`` and
``ExternalSource``.

``ExternalSource`` takes its data from ``Pipeline.feed_input`` (a queue, with
``repeat_last``) or from ``source``: a callable, an iterable or a generator
function, producing batches or (``batch=False``) samples, with ``cycle``,
``num_outputs``, ``dtype``/``ndim`` checks and, with ``parallel=True``, worker
processes (``_multiproc.py``) for a per-sample callable.
"""

from __future__ import annotations

import collections
import inspect

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch, HostBatch
from ..types import BatchInfo, DALIDataType, SampleInfo, cast_host, to_numpy_type
from .base import BF16_BITS, Operator

DALI_SCHEMA("_CopyToDevice").DocStr(
    "Host->device copy inserted by DataNode.gpu(): the executor stages its "
    "output across the boundary."
).NumInput(1).NumOutput(1).Devices("mixed").MakeInternal()


@register_operator("_CopyToDevice", "mixed")
class CopyToDevice(Operator):
    reads_bfloat16 = True  # staged as int16 bits (batch.pad_and_stack)

    def run_batch(self, ctx, inp: HostBatch):
        return [inp]


DALI_SCHEMA("Copy").DocStr("Copies the input.").NumInput(1).NumOutput(1).Devices("cpu", "gpu")


@register_operator("Copy", "cpu")
class CopyCPU(Operator):
    reads_bfloat16 = BF16_BITS

    def run_sample(self, ctx, idx, x):
        return np.copy(x)


@register_operator("Copy", "gpu")
class CopyGPU(Operator):
    def lower(self, dctx, x):
        return [x]


DALI_SCHEMA("Constant").DocStr(
    "A constant batch (created by types.Constant)."
).NumInput(0).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "fdata", ArgType.FLOAT_VEC, "Float payload.", None
).AddOptionalArg(
    "idata", ArgType.INT_VEC, "Int payload.", None
).AddOptionalArg(
    "shape", ArgType.INT_VEC, "Output sample shape.", None
).AddOptionalArg(
    "dtype", ArgType.DATA_TYPE, "Output dtype.", None
).AddOptionalArg(
    "layout", ArgType.TENSOR_LAYOUT, "Output layout.", ""
)


class _ConstantBase(Operator):
    def _value(self) -> np.ndarray:
        fdata = self.spec.GetArgument("fdata", None)
        idata = self.spec.GetArgument("idata", None)
        payload = fdata if fdata is not None else (idata if idata is not None else [0])
        arr = np.asarray(payload, dtype=np.float32 if fdata is not None else np.int32)
        shape = self.spec.GetArgument("shape", None)
        if shape is not None:
            shape = list(shape)
            if arr.size == int(np.prod(shape)) if shape else arr.size == 1:
                arr = arr.reshape(shape)
            else:
                arr = np.full(shape, arr.reshape(-1)[0], arr.dtype)
        dtype = self.spec.GetArgument("dtype", None)
        if dtype is not None:
            arr = cast_host(arr, dtype)
        return arr


@register_operator("Constant", "cpu")
class ConstantCPU(_ConstantBase):
    def run_batch(self, ctx, *unused):
        v = self._value()
        return [HostBatch([v] * ctx.batch_size, layout=self.spec.GetArgument("layout", ""))]


@register_operator("Constant", "gpu")
class ConstantGPU(_ConstantBase):
    def lower(self, dctx, *unused):
        # the pipeline's max batch size, as the reference's device program
        v = self._value()
        v = (v if torch.is_tensor(v) else torch.from_numpy(v)).to(self.pipeline.device)
        data = v[None].expand(self.pipeline.max_batch_size, *v.shape)
        return [DeviceBatch(data, None, self.spec.GetArgument("layout", ""))]


DALI_SCHEMA("ExternalSource").DocStr(
    """User data injection: from ``source`` (a callable, iterable or generator
    function producing batches or samples) or from ``Pipeline.feed_input``."""
).NumInput(0).OutputFn(lambda spec: spec.GetArgument("num_outputs", 1) or 1).Devices(
    "cpu"
).MakeStateful().AddOptionalArg(
    "num_outputs", ArgType.INT, "Number of outputs (the source returns a tuple per call).", None
).AddOptionalArg(
    "source", ArgType.PYTHON_OBJECT, "Callable, iterable or generator function.", None
).AddOptionalArg(
    "batch", ArgType.BOOL, "`source` produces whole batches (True) or samples (False).", True
).AddOptionalArg(
    "cycle", ArgType.STRING, "'no', 'quiet' or 'raise': what an exhausted iterable does.", None
).AddOptionalArg(
    "layout", ArgType.TENSOR_LAYOUT, "Layout of the produced data.", ""
).AddOptionalArg(
    "repeat_last", ArgType.BOOL, "Serve the last fed batch again when the queue is empty.", False
).AddOptionalArg(
    "blocking", ArgType.BOOL, "Compatibility argument (feeds never block).", True
).AddOptionalArg(
    "no_copy", ArgType.BOOL, "Compatibility hint (host batches are always borrowed).", False
).AddOptionalArg(
    "parallel", ArgType.BOOL, "Run a per-sample callable `source` in worker processes.", False
).AddOptionalArg(
    "prefetch_queue_depth", ArgType.INT,
    "Compatibility argument (parallel workers compute each batch when asked).", 1
).AddOptionalArg(
    "dtype", ArgType.DATA_TYPE, "Expected dtype; other data raises.", None
).AddOptionalArg(
    "ndim", ArgType.INT, "Expected sample rank; inferred from `layout` when set.", None
)


@register_operator("ExternalSource", "cpu")
class ExternalSource(Operator):
    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._queue = collections.deque()
        self._last = None
        self._iter = None
        self._pool = None
        self._iteration = 0
        self._epoch = 0
        src = spec._extra.get("_source", spec.GetArgument("source", None))
        self._source = src
        self._batch_mode = bool(spec.GetArgument("batch", True))
        self._cycle = spec.GetArgument("cycle", None)
        self._layout = spec.GetArgument("layout", "") or ""
        self._num_outputs = spec.GetArgument("num_outputs", None)
        if src is None:
            self._source_kind = "fed"
        elif inspect.isgeneratorfunction(src):
            # called for a fresh iterator at the start and at each cycle
            self._source_kind = "gen_func"
        elif callable(src):
            self._source_kind = "callable"
        else:
            self._source_kind = "iterable"
        self._accepts_arg = False
        if self._source_kind == "callable":
            try:
                # a required positional parameter takes the SampleInfo/BatchInfo
                # (defaulted closure parameters such as `lambda v=v:` do not)
                self._accepts_arg = any(
                    p.default is inspect.Parameter.empty
                    and p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                                   inspect.Parameter.POSITIONAL_OR_KEYWORD)
                    for p in inspect.signature(src).parameters.values())
            except (TypeError, ValueError):
                self._accepts_arg = False

    @property
    def parallel(self) -> bool:
        return bool(self.spec.GetArgument("parallel", False)) and self._source_kind == "callable"

    def start_pool(self, pipeline):
        """Start the worker processes of a ``parallel=True`` source. The
        executor calls this when the pipeline is built, before its stage
        threads exist, so ``fork`` copies a process with no executor thread."""
        if self._batch_mode:
            raise ValueError("parallel=True requires a per-sample (batch=False) callable source")
        if not self._accepts_arg:
            raise ValueError("parallel=True requires a callable that takes a SampleInfo "
                             "(a stateless, indexed source)")
        from .._multiproc import WorkerPool

        self._pool = WorkerPool(self._source, num_workers=pipeline.py_num_workers,
                                batch_size=pipeline.max_batch_size,
                                queue_depth=pipeline.prefetch_queue_depth,
                                start_method=pipeline.py_start_method,
                                pickler=pipeline.py_callback_pickler)

    def feed(self, data, layout=None):
        """Queue one batch (``Pipeline.feed_input``)."""
        self._queue.append((data, layout or self._layout))

    def run_batch(self, ctx, *unused):
        n_out = self._num_outputs or 1
        if self.parallel:
            if self._pool is None:
                self.start_pool(ctx.pipeline)
            per_sample = self._pool.run_batch(self._iteration, self._epoch)
            outs = [HostBatch([s[j] for s in per_sample], layout=self._layout)
                    for j in range(n_out)]
        else:
            data, layout = self._next_data(ctx)
            outs = [HostBatch(self._to_samples(g, ctx.batch_size), layout=layout)
                    for g in self._split_outputs(data, n_out)]
        self._iteration += 1
        self._validate_outs(outs)
        return outs

    def _validate_outs(self, outs):
        """The declared dtype and ndim: a mismatch raises."""
        want_dt = self.spec.GetArgument("dtype", None)
        want_nd = self.spec.GetArgument("ndim", None)
        if want_nd is None and self._layout:
            want_nd = len(self._layout)
        if want_dt is None and want_nd is None:
            return
        for hb in outs:
            if not hb.samples:
                continue
            s = np.asarray(hb.samples[0])
            if want_dt is not None:
                want = np.dtype(to_numpy_type(DALIDataType(int(want_dt))))
                if s.dtype != want:
                    raise TypeError(f"ExternalSource '{self.spec.name}': declared dtype {want} "
                                    f"but source produced {s.dtype}")
            if want_nd is not None and s.ndim != int(want_nd):
                raise ValueError(f"ExternalSource '{self.spec.name}': declared ndim "
                                 f"{int(want_nd)} but source produced {s.ndim}-D samples")

    def _next_data(self, ctx):
        if self._source_kind == "fed":
            if not self._queue:
                if self.spec.GetArgument("repeat_last", False) and self._last is not None:
                    return self._last
                raise RuntimeError(f"ExternalSource '{self.spec.name}' has no data; call "
                                   "Pipeline.feed_input first")
            self._last = self._queue.popleft()
            return self._last
        if self._source_kind == "callable":
            if self._batch_mode:
                data = (self._source(BatchInfo(self._iteration, self._epoch)) if self._accepts_arg
                        else self._source())
            else:
                bs = ctx.batch_size
                samples = [self._source(SampleInfo(self._iteration * bs + i, i, self._iteration,
                                                   self._epoch))
                           if self._accepts_arg else self._source() for i in range(bs)]
                if samples and isinstance(samples[0], tuple):
                    samples = tuple(list(x) for x in zip(*samples))
                data = samples
            return data, self._layout

        def fresh_iter():
            return self._source() if self._source_kind == "gen_func" else iter(self._source)

        if self._iter is None:
            self._iter = fresh_iter()
        try:
            data = next(self._iter)
        except StopIteration:
            if self._cycle in ("quiet", "raise") or self._cycle is True:
                self._iter = fresh_iter()
                self._epoch += 1
                if self._cycle == "raise":
                    raise
                data = next(self._iter)
            else:
                raise
        return data, self._layout

    def _split_outputs(self, data, n_out):
        if n_out == 1:
            if isinstance(data, tuple) and self._num_outputs is None:
                data = data[0] if len(data) == 1 else data
            return [data]
        if not isinstance(data, (tuple, list)) or len(data) != n_out:
            raise ValueError(f"ExternalSource '{self.spec.name}' expected {n_out} outputs, got "
                             f"{type(data)}")
        return list(data)

    @staticmethod
    def _to_samples(data, batch_size):
        if isinstance(data, np.ndarray):
            samples = [np.asarray(data[i]) for i in range(data.shape[0])]
        elif isinstance(data, (list, tuple)):
            samples = [np.asarray(s) for s in data]
        elif hasattr(data, "__array__"):
            arr = np.asarray(data)
            samples = [arr[i] for i in range(arr.shape[0])]
        else:
            raise TypeError(f"Unsupported external source data type {type(data)}")
        if len(samples) > batch_size:
            raise ValueError(f"external_source produced {len(samples)} samples, more than the "
                             f"pipeline's max_batch_size={batch_size}")
        return samples

    def reset_epoch(self):
        """Restart an exhausted source: iterables iterate again; callables
        restart their iteration count at 0 with the next epoch index."""
        if self._source_kind in ("iterable", "gen_func"):
            self._iter = None
            self._epoch += 1
        elif self._source_kind == "callable":
            self._iteration = 0
            self._epoch += 1

    def close(self):
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def save_state(self):
        st = {"iteration": self._iteration, "epoch": self._epoch}
        if self._source_kind in ("iterable", "gen_func") and (self._iteration or self._epoch):
            # an iterator cannot be rewound: restoring the counters would
            # replay a different stream, so Pipeline.checkpoint() refuses it
            st["unresumable_source"] = (
                "external_source with an iterator/generator source cannot be "
                "checkpointed mid-stream; use an indexed callable "
                "(source=lambda sample_info: ...) for resumable pipelines")
        return st

    def restore_state(self, state):
        self._iteration = int(state["iteration"])
        self._epoch = int(state.get("epoch", 0))
