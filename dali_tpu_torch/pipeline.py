"""Pipeline: graph building + lifecycle (counterpart of ``dali_tpu/pipeline.py``).

``device`` names the ``torch.device`` every device-side output lives on
(default ``"cuda:0"``); asking for CUDA where none exists raises. Operator
ids and auto-generated instance names follow the reference, so a
``dali_tpu`` checkpoint restores here (``checkpoint=`` or
``restore_checkpoint``).
"""

from __future__ import annotations

import functools
import inspect
import json
import threading
from typing import List, Optional

import torch

from ._schema import OpSpec
from .data_node import DataNode
from .graph import Graph, OpNode

_pipeline_tls = threading.local()


class Pipeline:
    """Data pipeline: define, build, run. The parameters are the reference's,
    in its order; those that concern its executor or a CUDA stream
    (``exec_pipelined``, ``exec_async``, ``bytes_per_sample``,
    ``set_affinity``, ``max_streams``, ``default_cuda_stream_priority``,
    ``exec_dynamic``) are accepted and ignored, as there. ``debug`` is
    accepted: the port always runs its device ops eagerly. ``pad_align``
    rounds the spatial dims of a ragged batch's canvas; ``output_dtype`` and
    ``output_ndim`` are checked on every ``outputs()``. ``device`` is the
    port's own: the ``torch.device`` of the device-side outputs."""

    def __init__(
        self,
        batch_size: int = -1,
        num_threads: int = -1,
        device_id: Optional[int] = None,
        seed: int = -1,
        exec_pipelined: bool = True,
        prefetch_queue_depth=2,
        exec_async: bool = True,
        bytes_per_sample: int = 0,
        set_affinity: bool = False,
        max_streams: int = -1,
        default_cuda_stream_priority: int = 0,
        *,
        enable_conditionals: bool = False,
        enable_checkpointing: bool = False,
        checkpoint: Optional[str] = None,
        py_num_workers: int = 1,
        py_start_method: str = "fork",
        py_callback_pickler=None,
        output_dtype=None,
        output_ndim=None,
        pad_align: int = 64,
        max_batch_size: Optional[int] = None,
        exec_dynamic: bool = False,
        debug: bool = False,
        device=None,
    ):
        self.max_batch_size = max_batch_size if max_batch_size is not None else batch_size
        if self.max_batch_size is None or self.max_batch_size < 1:
            raise ValueError("batch_size must be a positive integer")
        self.num_threads = num_threads if num_threads and num_threads > 0 else 4
        self.seed = seed if seed is not None and seed >= 0 else 12345
        if device is None:
            device = f"cuda:{device_id}" if device_id is not None else "cuda:0"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Pipeline device {self.device} requested but CUDA is not "
                               "available; pass device='cpu' to run the plain versions")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported pipeline device {self.device}")
        self.device_id = device_id
        if isinstance(prefetch_queue_depth, dict):
            cpu_d = int(prefetch_queue_depth.get("cpu_size", 2))
            gpu_d = int(prefetch_queue_depth.get("gpu_size", 2))
        else:
            cpu_d = gpu_d = int(prefetch_queue_depth)
        self.cpu_queue_depth = max(1, cpu_d)
        self.gpu_queue_depth = max(1, gpu_d)
        self.prefetch_queue_depth = max(self.cpu_queue_depth, self.gpu_queue_depth)
        self.enable_conditionals = enable_conditionals
        self.enable_checkpointing = enable_checkpointing
        # worker processes of parallel external sources: how many, how
        # started ("fork" or "spawn") and the module that pickles the source
        self.py_num_workers = py_num_workers
        self.py_start_method = py_start_method
        self.py_callback_pickler = py_callback_pickler
        self.pad_align = int(pad_align)
        self.output_dtype = output_dtype
        self.output_ndim = output_ndim
        self.debug = bool(debug)
        self._restore_checkpoint = checkpoint
        self._graph_fn = None
        self._graph: Optional[Graph] = None
        self._executor = None
        self._built = False
        self._traced_ops: List[OpNode] = []
        self._next_op_id = 0
        self._op_name_counts = {}
        self._outputs_raw = None
        self._batches_scheduled = 0
        self._batches_consumed = 0

    def __enter__(self):
        stack = getattr(_pipeline_tls, "stack", None)
        if stack is None:
            stack = _pipeline_tls.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _pipeline_tls.stack.pop()
        return False

    @staticmethod
    def current() -> Optional["Pipeline"]:
        stack = getattr(_pipeline_tls, "stack", None)
        return stack[-1] if stack else None

    def add_op(self, spec: OpSpec) -> OpNode:
        if spec.name is None:
            base = spec.schema_name.replace(".", "__")
            taken = {op.instance_name for op in self._traced_ops}
            n = self._op_name_counts.get(base, 0)
            while f"__{base}_{n}" in taken:
                n += 1
            self._op_name_counts[base] = n + 1
            spec.name = f"__{base}_{n}"
        elif any(op.instance_name == spec.name for op in self._traced_ops):
            raise ValueError(f"Duplicate operator instance name '{spec.name}'")
        node = OpNode(self._next_op_id, spec)
        self._next_op_id += 1
        out_device = "gpu" if spec.device in ("gpu", "mixed") else "cpu"
        node.outputs = [DataNode(f"{spec.name}[{j}]", out_device, node, j)
                        for j in range(spec.num_outputs())]
        self._traced_ops.append(node)
        return node

    def set_outputs(self, *outputs):
        self._outputs_raw = outputs

    def build(self):
        if self._built:
            return self
        if self._outputs_raw is None and self._graph_fn is not None:
            with self:
                outputs = self._graph_fn()
            self._outputs_raw = outputs if isinstance(outputs, tuple) else (outputs,)
        if self._outputs_raw is None:
            raise RuntimeError("Pipeline has no outputs; define via pipeline_def or set_outputs()")
        self._graph = Graph.build(list(self._outputs_raw), self._traced_ops).deduplicate()
        from .executor import Executor

        self._executor = Executor(self, self._graph)
        if self._restore_checkpoint is not None:
            self.restore_checkpoint(self._restore_checkpoint, _built=True)
        self._built = True
        return self

    def _require_built(self):
        if not self._built:
            self.build()

    def schedule_run(self):
        self._require_built()
        self._executor.schedule_run()
        self._batches_scheduled += 1

    def run(self):
        self.schedule_run()
        return self.outputs()

    def outputs(self):
        self._require_built()
        if self._batches_consumed >= self._batches_scheduled:
            raise RuntimeError("outputs() called with no scheduled run; call schedule_run() first")
        self._batches_consumed += 1
        return self._executor.outputs()

    def share_outputs(self):
        return self.outputs()

    def reset(self):
        """Start the next epoch after a source raised ``StopIteration``."""
        if self._executor is not None:
            self._executor.reset()
        self._batches_scheduled = 0
        self._batches_consumed = 0

    def release_outputs(self):
        """Nothing to recycle: outputs are tensors the caller owns."""

    def feed_input(self, data_node, data, layout=None):
        """Queue one batch for the ``external_source`` named ``data_node``
        (a name or the node itself)."""
        self._require_built()
        name = data_node if isinstance(data_node, str) else data_node.source.instance_name
        for node in self._graph.ops:
            if node.instance_name == name:
                impl = self._executor.impls[node.id]
                if not hasattr(impl, "feed"):
                    raise TypeError(f"Operator '{name}' is not an input operator")
                impl.feed(data, layout=layout)
                return
        raise KeyError(f"No operator named '{name}' in the pipeline")

    def _prefetch(self):
        for _ in range(self.prefetch_queue_depth):
            self.schedule_run()

    def epoch_size(self, name: Optional[str] = None):
        """The padded epoch size of the reader ``name``, or of every reader
        by name."""
        meta = self.reader_meta()
        if name is not None:
            return meta[name]["epoch_size_padded"]
        return {k: v["epoch_size_padded"] for k, v in meta.items()}

    def reader_meta(self, name: Optional[str] = None):
        self._require_built()
        meta = self._executor.reader_meta()
        return meta[name] if name is not None else meta

    def executor_statistics(self):
        self._require_built()
        return self._executor.statistics()

    def serialize(self, filename: Optional[str] = None, include_callables: bool = False) -> str:
        """The built graph and the pipeline's parameters as the reference's
        JSON document (``Pipeline.deserialize`` of either package reads it).
        ``include_callables`` embeds by-value pickles of sources and
        callables, so the payload then contains code."""
        self._require_built()
        params = {
            "batch_size": self.max_batch_size,
            "num_threads": self.num_threads,
            "device_id": self.device_id,
            "seed": self.seed,
            "prefetch_queue_depth": {"cpu_size": self.cpu_queue_depth,
                                     "gpu_size": self.gpu_queue_depth},
            "pad_align": self.pad_align,
            "enable_checkpointing": self.enable_checkpointing,
            "enable_conditionals": self.enable_conditionals,
            "output_dtype": ([int(d) for d in self.output_dtype]
                             if isinstance(self.output_dtype, (list, tuple))
                             else None if self.output_dtype is None else int(self.output_dtype)),
            "output_ndim": self.output_ndim,
        }
        payload = self._graph.serialize(params, include_callables=include_callables)
        if filename:
            with open(filename, "w") as f:
                f.write(payload)
        return payload

    @classmethod
    def deserialize(cls, serialized_pipeline: Optional[str] = None,
                    filename: Optional[str] = None, **kwargs):
        """A pipeline from :meth:`serialize`'s payload (of either package)
        with no Python definition; ``kwargs`` override its parameters, and
        ``device=`` places it. An unknown parameter raises ``TypeError``,
        but for the reference's ``transfer_chunk_bytes`` (a TPU transfer
        setting, dropped)."""
        if serialized_pipeline is None:
            with open(filename) as f:
                serialized_pipeline = f.read()
        params = json.loads(serialized_pipeline).get("params", {})
        params.update(kwargs)
        params.pop("transfer_chunk_bytes", None)
        unknown = set(params) - set(inspect.signature(cls.__init__).parameters)
        if unknown:
            raise TypeError(f"Pipeline.deserialize got unknown parameter(s) {sorted(unknown)}")
        params.setdefault("batch_size", 1)
        params.setdefault("num_threads", 4)
        pipe = cls(**params)
        graph = Graph.deserialize(serialized_pipeline)
        pipe._traced_ops = list(graph.ops)
        pipe._next_op_id = len(graph.ops)
        pipe._outputs_raw = tuple(graph.outputs)
        return pipe

    def save_graph_to_dot_file(self, filename: str, **kwargs):
        """Write the built graph in Graphviz's dot language."""
        self._require_built()
        with open(filename, "w") as f:
            f.write(self._graph.to_dot())

    @property
    def batch_size(self):
        return self.max_batch_size

    @property
    def executor(self):
        self._require_built()
        return self._executor

    def checkpoint(self, filename: Optional[str] = None) -> str:
        """JSON checkpoint aligned with the last consumed batch (same format as
        ``dali_tpu``)."""
        self._require_built()
        state = self._executor.consumed_checkpoint_state()
        for name, st in state.get("ops", {}).items():
            if isinstance(st, dict) and st.get("unresumable_source"):
                raise ValueError(f"{name}: {st['unresumable_source']}")
        payload = json.dumps({"format": "dali_tpu.checkpoint.v1", "executor": state})
        if filename:
            with open(filename, "w") as f:
                f.write(payload)
        return payload

    def restore_checkpoint(self, payload: str, _built: bool = False):
        if not _built:
            self._require_built()
        state = json.loads(payload)
        self._executor.restore_checkpoint(state.get("executor", state))

    def shutdown(self):
        """Stop the stage threads and release native resources."""
        if self._executor is not None:
            self._executor.shutdown()
            self._executor = None
            self._built = False

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass


# the decorator's own keyword sets enable_conditionals
_CTOR_NAMES = frozenset(inspect.signature(Pipeline.__init__).parameters) - {
    "self", "enable_conditionals"}


def pipeline_def(fn=None, *, enable_conditionals=False, **pipeline_kwargs):
    """Decorator turning a graph function into a Pipeline factory;
    ``enable_conditionals=True`` rewrites its ``if``/``not``/``and``/``or``
    over DataNodes into per-sample conditionals."""

    def actual_decorator(func):
        graph_func = func
        if enable_conditionals:
            from ._conditionals import autograph_convert

            graph_func = autograph_convert(func)

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            ctor_kwargs = dict(pipeline_kwargs)
            fn_kwargs = {}
            for k, v in kwargs.items():
                (ctor_kwargs if k in _CTOR_NAMES else fn_kwargs)[k] = v
            pipe = Pipeline(enable_conditionals=enable_conditionals, **ctor_kwargs)
            pipe._graph_fn = lambda: graph_func(*args, **fn_kwargs)
            return pipe

        wrapper.is_pipeline_def = True
        return wrapper

    return actual_decorator(fn) if fn is not None else actual_decorator


def do_not_convert(fn):
    """Exempt ``fn`` from the conditional rewrite of
    ``enable_conditionals=True``."""
    fn._dali_do_not_convert = True
    return fn
