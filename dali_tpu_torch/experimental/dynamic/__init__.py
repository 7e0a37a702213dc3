"""Eager mode, ``ndd`` (counterpart of ``dali_tpu/experimental/dynamic``).

Every registered operator is also a function that runs at once on
:class:`Batch` objects: host operators run their numpy ``run_batch``, device
operators run their host setup pass and ``lower`` on the context's
``torch.device`` through the executor's own helper
(``executor.run_device_op``). ``capture`` compiles a function of Batches into
a pipeline once per batch size and replays it.

    import dali_tpu_torch.experimental.dynamic as ndd
    with ndd.EvalContext(seed=1):                 # device defaults to cuda:0
        batch = ndd.as_batch([img1, img2], layout="HWC")
        out = ndd.resize(batch.gpu(), resize_x=224, resize_y=224)
        out = ndd.crop_mirror_normalize(out, mean=[...], std=[...])

Operator ids and reader cache keys follow ``dali_tpu``'s ndd, so random ops
and readers draw the same streams, and an ``ndd.Checkpoint`` serialized by
``dali_tpu`` applies here. The port draws no randomness on the device: an
eager gpu random operator raises ``NotImplementedError``, as in a pipeline.
"""

from __future__ import annotations

import builtins
import functools
import hashlib
import sys
import types as _pytypes
from typing import Optional

import numpy as np
import torch

from ..._schema import GetSchema, OpSpec, RegisteredSchemas, get_operator_impl
from ...backend.base import HostCtx
from ...batch import DeviceBatch, HostBatch, pad_and_stack
from ...executor import pad_align_for, run_device_op
from ...fn import _camel_to_snake


def _not_ported(path: str, where: str = "Queue 1"):
    return NotImplementedError(
        f"ndd.{path} is not ported to dali_tpu_torch yet; see ROADMAP.md ({where})")


class EvalContext:
    """Seed, call counter, device and the persistent stateful operators
    (readers) of eager calls. ``device`` defaults to ``cuda:0`` and raises
    without CUDA, as ``Pipeline`` does; pass ``device="cpu"`` to run the
    plain PyTorch versions."""

    _current: Optional["EvalContext"] = None

    def __init__(self, seed: int = 12345, num_threads: int = 4, device=None):
        self.seed = seed
        self.num_threads = num_threads
        self.device = torch.device("cuda:0" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"EvalContext device {self.device} requested but CUDA is not "
                               "available; pass device='cpu' to run the plain versions")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported eager device {self.device}")
        self.counter = 0
        # one persistent instance per reader call site: it advances across
        # calls, and its state is what a Checkpoint holds
        self._op_cache = {}
        self._pending_states = {}  # repr(cache key) -> state to apply on creation

    def __enter__(self):
        self._prev = EvalContext._current
        EvalContext._current = self
        return self

    def __exit__(self, *exc):
        EvalContext._current = self._prev
        return False

    @classmethod
    def current(cls) -> "EvalContext":
        if cls._current is None:
            cls._current = EvalContext()
        return cls._current


class Checkpoint:
    """The eval context's seed and call counter (eager random ops key their
    streams on them) and every cached reader's state. ``apply`` restores
    them; the state of a reader not created yet applies at its first call.
    The format is ``dali_tpu``'s."""

    FORMAT_VERSION = 1

    def __init__(self, state=None):
        self.state = state or {}

    @classmethod
    def collect(cls, ectx: Optional[EvalContext] = None) -> "Checkpoint":
        ectx = ectx or EvalContext.current()
        ops = {}
        for key, impl in ectx._op_cache.items():
            st = impl.save_state()
            if st is not None:
                ops[repr(key)] = {"type": type(impl).__name__, "state": st}
        return cls({"version": cls.FORMAT_VERSION, "seed": ectx.seed, "counter": ectx.counter,
                    "ops": ops})

    def apply(self, ectx: Optional[EvalContext] = None) -> None:
        ectx = ectx or EvalContext.current()
        if self.state.get("version") != self.FORMAT_VERSION:
            raise ValueError(f"ndd checkpoint version {self.state.get('version')} != "
                             f"{self.FORMAT_VERSION}")
        ectx.seed = self.state["seed"]
        ectx.counter = self.state["counter"]
        for key_r, entry in self.state.get("ops", {}).items():
            impl = next((im for k, im in ectx._op_cache.items() if repr(k) == key_r), None)
            if impl is None:
                ectx._pending_states[key_r] = entry
            else:
                _restore(impl, entry)

    def serialize(self) -> str:
        import base64
        import json

        from ... import pickling

        def enc(o):
            if isinstance(o, (np.integer, np.floating)):
                return o.item()
            return {"__pkl__": base64.b64encode(pickling.dumps(o)).decode()}

        return json.dumps(self.state, default=enc)

    @classmethod
    def deserialize(cls, payload: str) -> "Checkpoint":
        import base64
        import json

        from ... import pickling

        def dec(d):
            return pickling.loads(base64.b64decode(d["__pkl__"])) if "__pkl__" in d else d

        return cls(json.loads(payload, object_hook=dec))


def _restore(impl, entry):
    if type(impl).__name__ != entry["type"]:
        raise TypeError(f"checkpoint state for {entry['type']} cannot apply to "
                        f"{type(impl).__name__}")
    impl.restore_state(entry["state"])


def current_checkpoint() -> Checkpoint:
    """A checkpoint of the current eval context."""
    return Checkpoint.collect(EvalContext.current())


_GIVEN_BY_SHAPES = object()  # device shapes derived from the host shapes on demand


class Batch:
    """An eager batch: host samples (ragged numpy), or a ``torch.Tensor``
    [N, *canvas] on the context's device with per-sample extents ``shapes``
    (numpy [N, ndim], or None when every sample fills the canvas)."""

    def __init__(self, samples=None, device_data=None, shapes=None, layout="",
                 device_shapes=_GIVEN_BY_SHAPES):
        self._samples = None if samples is None else [np.asarray(s) for s in samples]
        self._device_data = device_data
        if torch.is_tensor(shapes):
            device_shapes, shapes = shapes, shapes.cpu().numpy()
        self._shapes = None if shapes is None else np.asarray(shapes)
        # the DeviceBatch.shapes the next device op sees: a device tensor, or
        # None for a dense batch, as the executor leaves it
        self._device_shapes = device_shapes
        self.layout = layout or ""

    @staticmethod
    def from_samples(samples, layout=""):
        return Batch(samples=samples, layout=layout)

    @property
    def is_gpu(self) -> bool:
        return self._device_data is not None

    def __len__(self):
        if self._samples is not None:
            return len(self._samples)
        return int(self._device_data.shape[0])

    def _host_shapes(self) -> np.ndarray:
        if self._shapes is not None:
            return self._shapes
        return np.tile(np.asarray(self._device_data.shape[1:], np.int64)[None], (len(self), 1))

    def _device_batch(self) -> DeviceBatch:
        sh = self._device_shapes
        if sh is _GIVEN_BY_SHAPES:
            sh = None
            host = self._shapes
            if host is not None and not (host == np.asarray(
                    self._device_data.shape[1:1 + host.shape[1]])).all():
                sh = torch.from_numpy(host.astype(np.int32)).to(self._device_data.device)
            self._device_shapes = sh
        return DeviceBatch(self._device_data, sh, self.layout)

    # -- movement ---------------------------------------------------------------------
    def gpu(self) -> "Batch":
        """The batch on the context's device: a uniform batch exactly, a
        ragged one on a canvas aligned as the executor aligns its boundary."""
        if self.is_gpu:
            return self
        device = EvalContext.current().device
        hb = HostBatch(self._samples, self.layout)
        if hb.is_uniform():
            arr, _ = pad_and_stack(hb, align=1)
            return Batch(device_data=torch.from_numpy(arr).to(device), layout=self.layout,
                         device_shapes=None)
        arr, shapes = pad_and_stack(hb, align=pad_align_for(hb))
        return Batch(device_data=torch.from_numpy(arr).to(device), shapes=shapes,
                     layout=self.layout, device_shapes=torch.from_numpy(shapes).to(device))

    def cpu(self) -> "Batch":
        """The batch on the host: one device-to-host copy, then each sample
        cropped to its extent."""
        if not self.is_gpu:
            return self
        host = self._device_data.cpu().numpy()
        if self._shapes is None:
            samples = [host[i] for i in range(host.shape[0])]
        else:
            # builtins.slice: this module exposes an operator named `slice`
            samples = [host[(i, *(builtins.slice(0, int(e)) for e in self._shapes[i]))]
                       for i in range(host.shape[0])]
        return Batch(samples=samples, layout=self.layout)

    # -- access -----------------------------------------------------------------------
    def at(self, i):
        if self.is_gpu:
            return self.cpu().at(i)
        return self._samples[i]

    def as_array(self):
        """The device tensor itself, or the host samples stacked."""
        if self.is_gpu:
            return self._device_data
        return np.stack(self._samples, 0)

    def __repr__(self):
        return f"Batch({'gpu' if self.is_gpu else 'cpu'}, n={len(self)}, layout={self.layout!r})"


def _batch_arithm(op, *operands, reverse=False):
    """Eager arithmetic over Batches: the DataNode expression language."""
    from ...data_node import _scalar_desc

    inputs, descs = [], []
    for o in (operands[::-1] if reverse else operands):
        if isinstance(o, Batch):
            descs.append(f"&{len(inputs)}")
            inputs.append(o)
        elif isinstance(o, (bool, int, float)):
            descs.append(_scalar_desc(o, None))
        elif isinstance(o, np.generic):
            descs.append(_scalar_desc(o.item(), None))
        else:
            return NotImplemented
    return _eager_call("_ArithmeticGenericOp", *inputs,
                       expression_desc=f"{op}({' '.join(descs)})")


def _add_batch_operators():
    binops = {"__add__": "add", "__sub__": "sub", "__mul__": "mul", "__truediv__": "fdiv",
              "__floordiv__": "div", "__mod__": "mod", "__pow__": "pow", "__eq__": "eq",
              "__ne__": "neq", "__lt__": "lt", "__le__": "leq", "__gt__": "gt", "__ge__": "geq",
              "__and__": "bitand", "__or__": "bitor", "__xor__": "bitxor"}
    for dunder, op in binops.items():
        setattr(Batch, dunder, lambda self, other, _op=op: _batch_arithm(_op, self, other))
    for dunder, op in (("__radd__", "add"), ("__rsub__", "sub"), ("__rmul__", "mul"),
                       ("__rtruediv__", "fdiv"), ("__rfloordiv__", "div"), ("__rmod__", "mod"),
                       ("__rpow__", "pow"), ("__rand__", "bitand"), ("__ror__", "bitor"),
                       ("__rxor__", "bitxor")):
        setattr(Batch, dunder, lambda self, other, _op=op: _batch_arithm(_op, other, self))

    def no_bool(self):
        raise TypeError("A dynamic Batch cannot be used in a plain Python `if` or `bool()`: "
                        "comparisons are elementwise (as for DataNode). Reduce explicitly, "
                        "e.g. bool(np.all(...)).")

    Batch.__bool__ = no_bool
    Batch.__hash__ = object.__hash__
    Batch.__neg__ = lambda self: _batch_arithm("minus", self)
    Batch.__pos__ = lambda self: _batch_arithm("plus", self)
    Batch.__abs__ = lambda self: _batch_arithm("abs", self)


_add_batch_operators()


def as_batch(data, layout="") -> Batch:
    """A Batch from a Batch, a list of samples, a numpy array (its first
    dim is the batch) or a ``torch.Tensor`` (a device batch on the
    context's device)."""
    if isinstance(data, Batch):
        return data
    if torch.is_tensor(data):
        return Batch(device_data=data.to(EvalContext.current().device), layout=layout)
    if isinstance(data, np.ndarray):
        return Batch.from_samples(list(data), layout)
    if isinstance(data, (list, tuple)):
        return Batch.from_samples(data, layout)
    raise TypeError(f"Cannot make a Batch from {type(data)}")


class _EagerPipelineShim:
    """The Pipeline attributes that operators read."""

    def __init__(self, ectx: EvalContext, batch_size: int):
        self.seed = ectx.seed
        self.max_batch_size = batch_size
        self.num_threads = ectx.num_threads
        self.device = ectx.device
        self.prefetch_queue_depth = 1
        self.py_num_workers = 1
        self.py_start_method = "fork"
        self.py_callback_pickler = None


def _fn_for_schema(schema_name: str):
    """The fn.* function of a schema (the same naming)."""
    from ... import fn as fn_root

    mod = fn_root
    *parts, last = schema_name.split(".")
    for p in parts:
        mod = getattr(mod, p)
    return getattr(mod, _camel_to_snake(last))


def _freeze_arg(v) -> str:
    """A reader-cache identity of one argument: repr(), with numpy arrays
    hashed by content (repr truncates large arrays)."""
    if isinstance(v, np.ndarray):
        h = hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest()[:16]
        return f"ndarray({v.dtype},{v.shape},{h})"
    if isinstance(v, (list, tuple)):
        return f"{type(v).__name__}[" + ",".join(_freeze_arg(x) for x in v) + "]"
    return repr(v)


def _in_capture(inputs) -> bool:
    from ...data_node import DataNode
    from ...pipeline import Pipeline

    return Pipeline.current() is not None and (
        not inputs or any(isinstance(i, DataNode) for i in inputs))


def _eager_call(schema_name: str, *inputs, device=None, batch_size=None, **kwargs):
    # inside a pipeline trace (ndd.capture) ndd functions are the fn API, so
    # one function body works in both modes
    if _in_capture(inputs):
        if device is not None:
            kwargs["device"] = device
        return _fn_for_schema(schema_name)(*inputs, **kwargs)

    schema = GetSchema(schema_name)
    batches = [i if isinstance(i, Batch) else as_batch(i) for i in inputs]
    if device is None:
        device = "gpu" if any(b.is_gpu for b in batches) else "cpu"
        if device not in schema.devices:
            device = schema.devices[0]
    n = len(batches[0]) if batches else (batch_size or 1)
    ectx = EvalContext.current()
    ectx.counter += 1

    # Batch-valued keyword arguments are per-sample argument inputs
    arg_batches, plain_kwargs = {}, {}
    for k, v in kwargs.items():
        if isinstance(v, Batch):
            arg_batches[k] = HostBatch(v.cpu()._samples)
        else:
            plain_kwargs[k] = v
    spec = OpSpec(schema_name, device=device, **plain_kwargs)
    impl_cls = get_operator_impl(schema_name, device)
    if schema.is_reader:
        # one persistent instance per (op, device, arguments): the reader
        # advances across calls instead of restarting
        key = (schema_name, device,
               tuple(sorted((k, _freeze_arg(v)) for k, v in plain_kwargs.items())))
        impl = ectx._op_cache.get(key)
        if impl is None:
            impl = ectx._op_cache[key] = impl_cls(spec, op_id=1_000_000 + len(ectx._op_cache))
            pending = ectx._pending_states.pop(repr(key), None)
            if pending is not None:
                _restore(impl, pending)
    else:
        impl = impl_cls(spec, op_id=ectx.counter)
    shim = _EagerPipelineShim(ectx, n)
    impl.pipeline = shim
    ctx = HostCtx(shim, ectx.counter, 0)

    if device in ("cpu", "mixed"):
        ctx.set_arg_batches(impl.op_id, arg_batches)
        outs = impl.run_batch(ctx, *(HostBatch(b.cpu()._samples, b.layout) for b in batches))
        result = [Batch(samples=o.samples, layout=o.layout) for o in outs]
        if device == "mixed":
            result = [r.gpu() for r in result]
    else:
        dev_inputs, in_shapes, in_batches = [], [], []
        for b in batches:
            # a batch that crosses from the host here shows its samples to
            # the setup pass, as a boundary edge of the executor does
            in_batches.append(None if b.is_gpu else HostBatch(b._samples, b.layout))
            g = b.gpu()
            dev_inputs.append(g._device_batch())
            in_shapes.append(g._host_shapes())
        outs, host_shapes = run_device_op(impl, ctx, dev_inputs, in_shapes, in_batches,
                                          arg_batches, ectx.device)
        result = []
        for o, sh in zip(outs, host_shapes):
            if sh is None and o.shapes is not None:
                sh = o.shapes.cpu().numpy()
            result.append(Batch(device_data=o.data, shapes=sh, layout=o.layout,
                                device_shapes=o.shapes))
    return result[0] if len(result) == 1 else tuple(result)


def _make_eager_fn(schema_name):
    def eager_fn(*inputs, **kwargs):
        return _eager_call(schema_name, *inputs, **kwargs)

    eager_fn.__name__ = eager_fn.__qualname__ = _camel_to_snake(schema_name.rsplit(".", 1)[-1])
    eager_fn.__doc__ = f"Eager {schema_name} (see fn.{eager_fn.__name__})."
    return eager_fn


def _make_image_decoder(name):
    """``ndd.decoders.<name>``: inside a capture, the port's fn wrapper (the
    hybrid decode included); eagerly, what ``dali_tpu`` does: the host
    decodes (``hybrid_device_decode`` is not an argument of the eager
    decoder)."""
    schema = "decoders." + "".join(w.capitalize() for w in name.split("_"))

    def decoder(*inputs, **kwargs):
        if _in_capture(inputs):
            from ... import fn as fn_root

            return getattr(fn_root.decoders, name)(*inputs, **kwargs)
        if "hybrid_device_decode" in kwargs:
            raise TypeError(f"Operator '{schema}' got unexpected argument 'hybrid_device_decode'")
        return _eager_call(schema, *inputs, **kwargs)

    decoder.__name__ = decoder.__qualname__ = name
    return decoder


class _Namespace(_pytypes.ModuleType):
    """A nested ndd module whose missing names are operators not ported yet."""

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        raise _not_ported(f"{self.__name__.split('.dynamic.', 1)[1]}.{name}")


def __getattr__(name):
    if name.startswith("_"):
        raise AttributeError(name)
    raise _not_ported(name)


def _submodule(parent, name):
    full = parent.__name__ + "." + name
    mod = sys.modules.get(full)
    if mod is None:
        mod = sys.modules[full] = _Namespace(full)
    parent.__dict__.setdefault(name, mod)
    return mod


def _populate():
    this = sys.modules[__name__]
    for schema_name in RegisteredSchemas():
        if GetSchema(schema_name).is_internal:
            continue
        *parts, last = schema_name.split(".")
        mod = this
        for p in parts:
            mod = _submodule(mod, p)
        mod.__dict__.setdefault(_camel_to_snake(last), _make_eager_fn(schema_name))
    decoders = _submodule(this, "decoders")
    for name in ("image", "image_random_crop"):
        decoders.__dict__[name] = _make_image_decoder(name)


_populate()


# ---------------------------------- capture -----------------------------------


def capture(fn=None, *, num_threads: int = 1):
    """Compile a function of Batches into a pipeline, once per batch size,
    and replay it. The first call traces the function with an
    ``external_source`` per argument (ndd functions dispatch to fn there);
    every call feeds its arguments through ``Pipeline.feed_input`` and runs
    the pipeline on the context's device. Device outputs come back as device
    Batches with their host-known shapes.

        @ndd.capture
        def frontend(jpegs):
            images = ndd.decoders.image_random_crop(
                jpegs, device="mixed", hybrid_device_decode=True)
            return ndd.resize(images, resize_x=224, resize_y=224)
    """

    def deco(user_fn):
        state = {}

        @functools.wraps(user_fn)
        def wrapper(*input_batches):
            from ... import fn as fn_root
            from ...pipeline import pipeline_def
            from ...tensors import TensorListGPU

            batches = [b if isinstance(b, Batch) else as_batch(b) for b in input_batches]
            bs = len(batches[0])
            pipe = state.get(bs)
            if pipe is None:
                ectx = EvalContext.current()

                @pipeline_def(batch_size=bs, num_threads=num_threads, seed=ectx.seed,
                              device=ectx.device)
                def _captured():
                    ins = [fn_root.external_source(name=f"__capture_in_{i}")
                           for i in range(len(batches))]
                    return user_fn(*ins)

                pipe = state[bs] = _captured()
                pipe.build()
            for i, b in enumerate(batches):
                host = b.cpu()
                pipe.feed_input(f"__capture_in_{i}", list(host._samples),
                                layout=host.layout or None)
            result = []
            for tl in pipe.run():
                if isinstance(tl, TensorListGPU):
                    result.append(Batch(device_data=tl.as_tensor(), shapes=tl._shapes,
                                        layout=tl.layout()))
                else:
                    result.append(Batch(samples=[tl.at(i) for i in range(len(tl))],
                                        layout=tl.layout()))
            return result[0] if len(result) == 1 else tuple(result)

        wrapper._captured_pipelines = state
        return wrapper

    return deco(fn) if fn is not None else deco
