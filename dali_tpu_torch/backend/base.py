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

from typing import Dict, List, Optional, Sequence

import numpy as np

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
        seed = op.spec.GetArgument("seed", -1) if op.spec.schema.has_random_seed else -1
        explicit = seed is not None and seed >= 0
        if not explicit:
            seed = self.pipeline.seed
        k0 = np.uint64(seed)
        if not explicit:
            k0 = k0 ^ (np.uint64(op.op_id) << np.uint64(32))
        k1 = np.uint64(self.iteration)
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


class DeviceCtx:
    """Context of one device-phase run, keyed by op id: statics, host
    parameters and argument inputs. An argument input on a CPU edge arrives
    stacked [N, ...]; one on a GPU edge resolves from the device env
    (``dev_arg_edges`` maps (op id, name) to its env key). Device-side
    randomness is not ported: every ported random op draws on the host, so
    unlike the reference there is no device key."""

    def __init__(self, arg_arrays, statics, params=None, dev_arg_edges=None, env=None):
        self._arg_arrays = arg_arrays
        self._statics = statics
        self._params = params or {}
        self._dev_arg_edges = dev_arg_edges or {}
        self._env = env

    def static(self, op: "Operator"):
        return self._statics.get(op.op_id)

    def param(self, op: "Operator", name: str):
        return self._params[op.op_id][name]

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


class Operator:
    schema_name: str = None
    device: str = None
    # run_sample is an element-wise numpy function of its inputs: a batch
    # whose inputs all share one sample shape runs as one stacked call
    elementwise = False

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
        results = [self.run_sample(ctx, i, *(b.samples[i] for b in inputs)) for i in range(n)]
        n_out = len(results[0]) if isinstance(results[0], tuple) else 1
        return [HostBatch([r[j] if isinstance(r, tuple) else r for r in results],
                          layout=self.output_layout(j, inputs)) for j in range(n_out)]

    def run_sample(self, ctx: HostCtx, idx: int, *inputs: np.ndarray):
        raise NotImplementedError(f"{type(self).__name__} has no host implementation")

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
    "Brightness", "BrightnessContrast", "Contrast", "Hsv", "Hue", "Saturation",
    "experimental.Equalize", "Cast", "Copy", "Flip", "LookupTable", "GaussianBlur",
    "Laplacian", "Normalize", "PreemphasisFilter", "ToDecibels", "_conditional.LogicalNot",
})


class ReaderOperator(Operator):
    def reader_meta(self) -> dict:
        raise NotImplementedError
