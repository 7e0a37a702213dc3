"""Python function operators (counterpart of ``dali_tpu/backend/interop.py``).

PythonFunction, DLTensorPythonFunction, TorchPythonFunction and NumbaFunction
run a user callable on the host, per sample on the operator's thread pool or
on whole batches (``batch_processing``); an exception raised there surfaces
at the next ``outputs()``. The callable rides ``OpSpec._extra`` and is not
serialized, as in the reference. The reference's gpu ``_JaxFunction``
(a JAX function traced into its device program) becomes ``_TorchFunction``,
reached as ``fn.torch_function``: a torch function of the batched device
canvases [N, ...], run in graph order on the device thread.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch, HostBatch
from ..types import DALIDataType, from_numpy_type, to_numpy_type
from .base import Operator


def _function_schema(name, doc, batch_default, devices=("cpu",)):
    return (DALI_SCHEMA(name).DocStr(doc).NumInput(0, 8)
            .OutputFn(lambda spec: spec.GetArgument("num_outputs", 1) or 1)
            .Devices(*devices).MakeStateful()
            .AddOptionalArg("function", ArgType.PYTHON_OBJECT, "The callable.", None)
            .AddOptionalArg("num_outputs", ArgType.INT, "Number of outputs.", 1)
            .AddOptionalArg("batch_processing", ArgType.BOOL,
                            "Pass whole batches (lists of samples) instead of samples.",
                            batch_default)
            .AddOptionalArg("output_layouts", ArgType.STRING_VEC, "Layouts of the outputs.", None))


_function_schema("PythonFunction", "Runs a Python function on host samples (per sample by "
                 "default; batch_processing=True passes lists of samples).", False)
_function_schema("DLTensorPythonFunction", "PythonFunction whose arguments expose "
                 "__dlpack__ (numpy arrays on the host).", True).AddOptionalArg(
    "synchronize_stream", ArgType.BOOL, "Compatibility no-op.", True)
_function_schema("TorchPythonFunction", "PythonFunction receiving and returning torch "
                 "tensors.", False)


class _SamplePool:
    """Per-sample calls of a user callable on a thread pool of the
    pipeline's ``num_threads``, created at first use."""

    _pool = None

    def map_samples(self, fn, n):
        threads = getattr(self.pipeline, "num_threads", 1) or 1
        if threads <= 1 or n <= 1:
            return [fn(i) for i in range(n)]
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=threads,
                                            thread_name_prefix="dali-torch-python-function")
        return list(self._pool.map(fn, range(n)))

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None


class _HostFunction(_SamplePool, Operator):
    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._fn = spec._extra.get("_function", spec.GetArgument("function", None))
        if self._fn is None:
            raise ValueError("python_function requires `function`")


@register_operator("PythonFunction", "cpu")
class PythonFunction(_HostFunction):
    def _layout(self, j):
        layouts = self.spec.GetArgument("output_layouts", None) or []
        return layouts[j] if j < len(layouts) else ""

    def run_batch(self, ctx, *inputs: HostBatch):
        if self.spec.GetArgument("batch_processing", False):
            res = self._fn(*[list(b.samples) for b in inputs])
            if not isinstance(res, tuple):
                res = (res,)
            return [HostBatch([np.asarray(s) for s in r], layout=self._layout(j))
                    for j, r in enumerate(res)]
        n = len(inputs[0]) if inputs else ctx.batch_size
        results = self.map_samples(lambda i: self._fn(*(b.samples[i] for b in inputs)), n)
        return [HostBatch([np.asarray(r[j] if isinstance(r, tuple) else r) for r in results],
                          layout=self._layout(j))
                for j in range(self.spec.GetArgument("num_outputs", 1) or 1)]


@register_operator("DLTensorPythonFunction", "cpu")
class DLTensorPythonFunction(PythonFunction):
    pass


@register_operator("TorchPythonFunction", "cpu")
class TorchPythonFunction(_HostFunction):
    def run_batch(self, ctx, *inputs: HostBatch):
        n = len(inputs[0]) if inputs else ctx.batch_size

        def one(i):
            r = self._fn(*(torch.from_numpy(np.ascontiguousarray(b.samples[i])) for b in inputs))
            return tuple(np.asarray(t.numpy() if hasattr(t, "numpy") else t)
                         for t in (r if isinstance(r, tuple) else (r,)))

        results = self.map_samples(one, n)
        return [HostBatch([r[j] for r in results])
                for j in range(self.spec.GetArgument("num_outputs", 1) or 1)]


DALI_SCHEMA("_TorchFunction").DocStr(
    """Runs a torch function of the device batches [N, ...] in the device
    program (the port's counterpart of the reference's ``_JaxFunction``)."""
).NumInput(0, 8).OutputFn(lambda spec: spec.GetArgument("num_outputs", 1) or 1).Devices(
    "gpu").MakeInternal().AddOptionalArg(
    "function", ArgType.PYTHON_OBJECT, "A callable of torch tensors.", None).AddOptionalArg(
    "num_outputs", ArgType.INT, "Number of outputs.", 1).AddOptionalArg(
    "output_layouts", ArgType.STRING_VEC, "Output layouts.", None)


@register_operator("_TorchFunction", "gpu")
class TorchFunction(Operator):
    """An output keeps the first input's per-sample shapes only where its
    shape equals that input's canvas; otherwise every sample fills it."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._fn = spec._extra.get("_function", spec.GetArgument("function", None))
        if self._fn is None:
            raise ValueError("torch_function requires `function`")

    def lower(self, dctx, *inputs: DeviceBatch):
        layouts = self.spec.GetArgument("output_layouts", None) or []
        res = self._fn(*(b.data for b in inputs))
        outs = []
        for j, r in enumerate(res if isinstance(res, tuple) else (res,)):
            sh = (inputs[0].shapes if inputs and tuple(r.shape) == tuple(inputs[0].data.shape)
                  else None)
            layout = layouts[j] if j < len(layouts) else (inputs[0].layout if inputs else "")
            outs.append(DeviceBatch(r, sh, layout))
        return outs


DALI_SCHEMA("NumbaFunction").DocStr(
    """Runs a kernel writing into preallocated outputs: ``run_fn(out0, ..,
    in0, ..)``; ``setup_fn(out_shapes, in_shapes)`` computes the output
    shapes (by default the first input's). Where numba imports and
    ``run_fn`` is a plain function it is njit-compiled at first use;
    otherwise the callable runs as plain Python."""
).NumInput(1, 6).OutputFn(lambda spec: len(spec.GetArgument("out_types", [0]) or [0])).Devices(
    "cpu").MakeStateful().AddOptionalArg(
    "run_fn", ArgType.PYTHON_OBJECT, "The kernel.", None).AddOptionalArg(
    "setup_fn", ArgType.PYTHON_OBJECT, "Output-shape function.", None).AddOptionalArg(
    "out_types", ArgType.INT_VEC, "DALIDataType per output.", None).AddOptionalArg(
    "in_types", ArgType.INT_VEC, "DALIDataType per input (validated).", None).AddOptionalArg(
    "outs_ndim", ArgType.INT_VEC, "ndim per output.", None).AddOptionalArg(
    "ins_ndim", ArgType.INT_VEC, "ndim per input (validated).", None).AddOptionalArg(
    "batch_processing", ArgType.BOOL, "Process whole batches.", False).AddOptionalArg(
    "blocks", ArgType.INT_VEC, "CUDA grid compat (ignored).", None).AddOptionalArg(
    "threads_per_block", ArgType.INT_VEC, "CUDA compat (ignored).", None)


@register_operator("NumbaFunction", "cpu")
class NumbaFunction(_SamplePool, Operator):
    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._run_fn = spec._extra.get("_run_fn", spec.GetArgument("run_fn", None))
        self._setup_fn = spec._extra.get("_setup_fn", spec.GetArgument("setup_fn", None))
        if self._run_fn is None:
            raise ValueError("numba_function requires `run_fn`")
        self._compiled = None

    def _kernel(self):
        if self._compiled is None:
            fn = self._run_fn
            try:
                import numba

                if not hasattr(fn, "py_func"):  # not a numba dispatcher yet
                    fn = numba.njit(fn)
            except ImportError:
                pass
            self._compiled = fn
        return self._compiled

    def _validate(self, arrays):
        in_types = self.spec.GetArgument("in_types", None)
        ins_ndim = self.spec.GetArgument("ins_ndim", None)
        for k, a in enumerate(arrays):
            if in_types is not None and k < len(in_types):
                want, got = DALIDataType(int(in_types[k])), from_numpy_type(a.dtype)
                if got != want:
                    raise TypeError(f"numba_function input {k}: expected {want}, got {got}")
            if ins_ndim is not None and k < len(ins_ndim) and a.ndim != int(ins_ndim[k]):
                raise TypeError(
                    f"numba_function input {k}: expected ndim {ins_ndim[k]}, got {a.ndim}")

    def _outputs(self, out_shapes):
        return [np.zeros(shape, to_numpy_type(DALIDataType(int(dt))))
                for shape, dt in zip(out_shapes, self.spec.GetArgument("out_types", None) or [])]

    def _apply(self, *arrays):
        self._validate(arrays)
        n_out = len(self.spec.GetArgument("out_types", None) or [])
        outs_ndim = self.spec.GetArgument("outs_ndim", None)
        in_shapes = [list(a.shape) for a in arrays]
        if self._setup_fn is not None:
            out_shapes = [[0] * (int(outs_ndim[i]) if outs_ndim else arrays[0].ndim)
                          for i in range(n_out)]
            self._setup_fn(out_shapes, in_shapes)
        else:
            out_shapes = [in_shapes[0]] * n_out
        outs = self._outputs(out_shapes)
        self._kernel()(*outs, *arrays)
        return tuple(outs)

    def _apply_batch(self, batches):
        """``run_fn`` receives lists of samples; ``setup_fn`` sees
        [output][sample][dim]."""
        n = len(batches[0])
        for arrays in zip(*batches):
            self._validate(arrays)
        out_types = self.spec.GetArgument("out_types", None) or []
        outs_ndim = self.spec.GetArgument("outs_ndim", None)
        in_shapes = [[list(a.shape) for a in b] for b in batches]
        if self._setup_fn is not None:
            out_shapes = [[[0] * (int(outs_ndim[j]) if outs_ndim else batches[0][i].ndim)
                           for i in range(n)] for j in range(len(out_types))]
            self._setup_fn(out_shapes, in_shapes)
        else:
            out_shapes = [in_shapes[0]] * len(out_types)
        outs = [[np.zeros(shape, to_numpy_type(DALIDataType(int(dt)))) for shape in shapes]
                for shapes, dt in zip(out_shapes, out_types)]
        self._kernel()(*outs, *[list(b) for b in batches])
        return outs

    def run_batch(self, ctx, *inputs: HostBatch):
        if self.spec.GetArgument("batch_processing", False):
            return [HostBatch(o) for o in self._apply_batch([list(b.samples) for b in inputs])]
        n_out = len(self.spec.GetArgument("out_types", [0]) or [0])
        results = self.map_samples(lambda i: self._apply(*(b.samples[i] for b in inputs)),
                                   len(inputs[0]))
        return [HostBatch([r[j] for r in results]) for j in range(n_out)]
