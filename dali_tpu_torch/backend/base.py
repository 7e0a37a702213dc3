"""Operator base classes and execution contexts (counterpart of
``dali_tpu/backend/base.py``).

Host ops (``cpu``/``mixed``) run ``run_batch`` or ``stage_batch_multi`` over
numpy batches (the default ``run_batch`` calls ``run_sample`` per sample);
device ops (``gpu``) run ``lower`` on torch tensors on the pipeline's device,
eagerly and in graph order. ``host_params``, ``device_statics``,
``host_output_shapes`` and ``host_output_layouts`` keep the reference's
host-side setup pass: per-iteration numpy parameters (copied to the device
with the batch), and per-sample shapes and layouts that never need a device
readback.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .._schema import OpSpec
from ..batch import DeviceBatch, HostBatch


class HostCtx:
    """Per-iteration host context."""

    def __init__(self, pipeline, iteration: int, epoch: int):
        self.pipeline = pipeline
        self.batch_size = pipeline.max_batch_size
        self.iteration = iteration
        self.epoch = epoch
        self._arg_batches: Dict[int, Dict[str, HostBatch]] = {}
        # input layouts of each device op, from the executor's layout pass
        self.op_in_layouts: Dict[int, List[str]] = {}

    def in_layouts(self, op: "Operator") -> List[str]:
        return self.op_in_layouts.get(op.op_id, [])

    def rng(self, op: "Operator", sample_idx: Optional[int] = None) -> np.random.Generator:
        """Philox stream keyed by (seed [xor op_id << 32], iteration[, sample]).

        Same keying as the reference (``dali_tpu/backend/base.py`` HostCtx.rng),
        so both packages draw identical shuffles, crop windows and coin flips."""
        k0, k1 = philox_key(op, self.pipeline.seed, self.iteration)
        if sample_idx is not None:
            k1 = k1 | (np.uint64(sample_idx) << np.uint64(40))
        return np.random.Generator(np.random.Philox(key=np.array([k0, k1], dtype=np.uint64)))

    def set_arg_batches(self, op_id: int, batches: Dict[str, HostBatch]):
        self._arg_batches[op_id] = batches

    def arg(self, op: "Operator", name: str, sample_idx: Optional[int] = None, default=None):
        batches = self._arg_batches.get(op.op_id, {})
        if name in batches:
            b = batches[name]
            if sample_idx is None:
                return b
            v = b.samples[sample_idx]
            return v[()] if v.ndim == 0 else v
        if op.spec.HasArgument(name):
            return op.spec.GetArgument(name)
        v = op.spec.GetArgument(name, default)
        return default if v is None else v


def philox_key(op: "Operator", pipeline_seed: int, iteration: int):
    """The (k0, k1) key of an op's stream in one iteration: an explicit
    ``seed`` gives (seed, iteration), otherwise (pipeline seed xor op_id <<
    32, iteration), as the reference keys its host streams."""
    seed = op.spec.GetArgument("seed", -1) if op.spec.schema.has_random_seed else -1
    explicit = seed is not None and seed >= 0
    k0 = np.uint64(seed if explicit else pipeline_seed)
    if not explicit:
        k0 = k0 ^ (np.uint64(op.op_id) << np.uint64(32))
    return k0, np.uint64(iteration)


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit words that spreads every
    input bit over the whole output (the CPU generator reads the low 32)."""
    m = (1 << 64) - 1
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & m
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & m
    return x ^ (x >> 31)


class DeviceCtx:
    """Context of one device-phase run, keyed by op id: statics, host
    parameters and argument inputs. An argument input on a CPU edge arrives
    stacked [N, ...]; one on a GPU edge resolves from the device env
    (``dev_arg_edges`` maps (op id, name) to its env key).

    Device draws come from :meth:`generator`: a ``torch.Generator`` on the
    batch's device, seeded from the key of the host streams and the batch's
    own iteration (not the executor's counter, which runs ahead by the
    prefetch depth). The same seed and iteration give the same draws; torch's
    generators cannot reproduce the reference's threefry, so device draws
    match the reference in distribution only (ROADMAP.md Queue 3)."""

    def __init__(self, arg_arrays, statics, params=None, dev_arg_edges=None, env=None,
                 batch_size=None, seed=None, iteration=None, device=None):
        # the iteration's batch size, for device ops with no input
        self.batch_size = batch_size
        self._arg_arrays = arg_arrays
        self._statics = statics
        self._params = params or {}
        self._dev_arg_edges = dev_arg_edges or {}
        self._env = env
        self.seed = seed
        self.iteration = iteration
        self.device = device

    def generator(self, op: "Operator") -> torch.Generator:
        """A fresh generator on the batch's device for ``op``'s draws in this
        iteration; pass it as ``generator=`` to every draw, so the process's
        global generators (the trainer's) are never touched."""
        if self.seed is None or self.iteration is None or self.device is None:
            raise RuntimeError(f"{op.spec.schema_name}: this device context has no random key")
        k0, k1 = philox_key(op, self.seed, self.iteration)
        g = torch.Generator(device=self.device)
        g.manual_seed(_mix64(int(k0) ^ _mix64(int(k1) + 0x9E3779B97F4A7C15 & (1 << 64) - 1)))
        return g

    def static(self, op: "Operator"):
        return self._statics.get(op.op_id)

    def param(self, op: "Operator", name: str):
        return self._params[op.op_id][name]

    def has_param(self, op: "Operator", name: str) -> bool:
        return name in self._params.get(op.op_id, {})

    def has_tensor_arg(self, op: "Operator", name: str) -> bool:
        return (name in self._arg_arrays.get(op.op_id, {})
                or (op.op_id, name) in self._dev_arg_edges)

    def arg(self, op: "Operator", name: str, default=None):
        arrs = self._arg_arrays.get(op.op_id, {})
        if name in arrs:
            return arrs[name]
        key = self._dev_arg_edges.get((op.op_id, name))
        if key is not None:
            return self._env[key].data
        if op.spec.HasArgument(name):
            return op.spec.GetArgument(name)
        v = op.spec.GetArgument(name, default)
        return default if v is None else v


def raise_unserved(spec: OpSpec, names):
    """Raise for an argument among ``names`` that ``spec`` sets to other than
    its default, or feeds as a tensor: one that this placement cannot serve
    (and the reference's placement ignores; ROADMAP.md Queue 3)."""
    for name in names:
        default = spec.schema.args[name].default
        if name in spec.arg_inputs or (name in spec.args and spec.args[name] != default):
            raise NotImplementedError(
                f"{spec.schema_name}({spec.device}): argument '{name}' is not served on this "
                "device by dali_tpu_torch; see ROADMAP.md (Queue 3)")


class Operator:
    schema_name: str = None
    device: str = None
    # run_sample is an element-wise numpy function of its inputs: a batch
    # whose inputs all share one sample shape runs as one stacked call
    elementwise = False
    # argument inputs a device op reads only in its host-side setup pass: a
    # host edge of one is not stacked and copied to the device, so its
    # samples may differ in shape
    host_args: tuple = ()

    def __init__(self, spec: OpSpec, op_id: int):
        self.spec = spec
        self.op_id = op_id
        self.pipeline = None

    def run_batch(self, ctx: HostCtx, *inputs: HostBatch) -> Sequence[HostBatch]:
        """Default: ``run_sample`` per sample; a tuple result gives one
        output batch per element."""
        n = len(inputs[0]) if inputs else ctx.batch_size
        if self.elementwise and n and inputs:
            shape = inputs[0].samples[0].shape
            if all(s.shape == shape for b in inputs for s in b.samples):
                out = self.run_sample(ctx, None, *(np.stack(b.samples) for b in inputs))
                return [HostBatch([out[i, ...] for i in range(n)],
                                  layout=self.output_layout(0, inputs))]
        results = self.map_samples(
            lambda i: self.run_sample(ctx, i, *(b.samples[i] for b in inputs)), n)
        n_out = len(results[0]) if isinstance(results[0], tuple) else 1
        return [HostBatch([r[j] if isinstance(r, tuple) else r for r in results],
                          layout=self.output_layout(j, inputs)) for j in range(n_out)]

    def run_sample(self, ctx: HostCtx, idx: int, *inputs: np.ndarray):
        raise NotImplementedError(f"{type(self).__name__} has no host implementation")

    def map_samples(self, fn, n: int) -> list:
        """``[fn(i) for i in range(n)]``: inline here, on a thread pool in a
        ``SamplePool`` operator."""
        return [fn(i) for i in range(n)]

    def output_layout(self, output_idx: int, inputs) -> str:
        return inputs[0].layout if inputs else ""

    def lower(self, dctx: DeviceCtx, *inputs: DeviceBatch) -> Sequence[DeviceBatch]:
        raise NotImplementedError(f"{type(self).__name__} has no device implementation")

    def host_params(self, ctx: HostCtx, input_shapes) -> Dict[str, np.ndarray]:
        """Per-iteration numpy parameters of a device op, built on the host
        and copied with the batch (``DeviceCtx.param``). Runs before
        ``device_statics`` and ``host_output_shapes``."""
        return {}

    def device_statics(self, ctx: HostCtx, input_shapes, input_batches):
        return None

    def host_output_shapes(self, ctx: HostCtx, input_shapes, input_batches):
        return None

    def host_output_layouts(self, in_layouts: List[str]) -> List[str]:
        """Static layouts of a device op's outputs (default: its first
        input's)."""
        return [in_layouts[0] if in_layouts else ""]

    def save_state(self) -> Optional[dict]:
        return None

    def restore_state(self, state: dict):
        pass

    def reset_epoch(self):
        """Start the next epoch after ``Pipeline.reset()``."""

    def close(self):
        pass

    def __repr__(self):
        return f"<{type(self).__name__} op_id={self.op_id} name={self.spec.name!r}>"


# Device ops whose per-sample extents equal their first input's (value-only
# transforms): the host-side setup pass carries shapes through them, as the
# reference does (``dali_tpu/backend/base.py`` SHAPE_PRESERVING_SCHEMAS).
# Only the ported names are listed.
SHAPE_PRESERVING_SCHEMAS = frozenset({
    "Brightness", "BrightnessContrast", "Contrast", "Hsv", "Hue", "Saturation", "ColorTwist",
    "Equalize", "experimental.Equalize", "Cast", "CastLike", "Copy", "Flip", "GridMask",
    "Jitter", "Sphere", "Water", "LookupTable", "GaussianBlur", "Laplacian", "Normalize",
    "noise.Gaussian", "noise.SaltAndPepper", "noise.Shot", "PreemphasisFilter", "ToDecibels",
    "_conditional.LogicalNot", "JpegCompressionDistortion", "experimental.Clahe",
    "experimental.MedianBlur", "experimental.Erode", "experimental.Dilate", "PerFrame",
})


class SamplePool:
    """Mixed in before ``Operator``: per-sample calls (``run_batch``'s
    ``run_sample`` among them) on a thread pool of the pipeline's
    ``num_threads``, created at first use. For host work that releases the
    GIL: numpy's einsum and gathers, the host C++."""

    _pool = None
    thread_name_prefix = "dali-torch-samples"

    def map_samples(self, fn, n):
        threads = getattr(self.pipeline, "num_threads", 1) or 1
        if threads <= 1 or n <= 1:
            return [fn(i) for i in range(n)]
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=threads,
                                            thread_name_prefix=self.thread_name_prefix)
        return list(self._pool.map(fn, range(n)))

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None


class ReaderOperator(Operator):
    def reader_meta(self) -> dict:
        raise NotImplementedError
