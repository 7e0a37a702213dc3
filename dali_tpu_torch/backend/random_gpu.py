"""random.Uniform, Normal, CoinFlip and Beta on the device (counterpart of
``dali_tpu/backend/random_gpu.py``).

Every draw passes ``DeviceCtx.generator(op)``: a generator on the batch's
device keyed by (seed, the batch's iteration), so the same seed and iteration
give bit-identical output, another iteration another stream, and a restored
checkpoint the same batches. torch's Philox cannot reproduce the reference's
threefry: the draws match the reference in distribution, not value
(ROADMAP.md Queue 3). A per-sample ``shape`` (a cpu tensor argument) draws
onto a grow-only canvas whose logical extents are the host output shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from .._schema import register_operator
from ..batch import DeviceBatch
from ..types import DALIDataType, to_torch_type
from .base import Operator
from .random import per_sample


class _RngShapeMixin:
    """Per-sample tensor ``shape`` arguments: the extents are host data, so
    the host sizes a grow-only canvas, and the logical extents ride the host
    output shapes and the batch's device shapes."""

    default_dtype = DALIDataType.FLOAT

    def host_params(self, ctx, input_shapes):
        b = ctx._arg_batches.get(self.op_id, {}).get("shape")
        if b is None:
            if "shape" in self.spec.arg_inputs:
                # a device-resident shape cannot size the output canvas
                raise ValueError(f"{self.spec.schema.name}: a tensor `shape` argument must be a "
                                 "cpu tensor (device-resident shapes cannot size the output "
                                 "canvas)")
            self._ps_shape = None
            return {}
        ps = np.asarray([np.asarray(s).reshape(-1) for s in b.samples], np.int64)
        mx = ps.max(axis=0)
        latch = getattr(self, "_canvas_latch", None)
        self._canvas_latch = mx if latch is None else np.maximum(latch, mx)
        self._ps_shape = ps
        return {"rng_shapes": ps.astype(np.int32)}

    def device_statics(self, ctx, input_shapes, input_batches=None):
        if getattr(self, "_ps_shape", None) is None:
            return None
        return ("rngps",) + tuple(int(v) for v in self._canvas_latch)

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        ps = getattr(self, "_ps_shape", None)
        return None if ps is None else [ps]

    def _setup(self, dctx, inputs):
        """(n, the batched draw shape, the logical per-sample shapes or None,
        the output dtype, the device)."""
        n = inputs[0].data.shape[0] if inputs else dctx.batch_size
        st = dctx.static(self)
        if isinstance(st, tuple) and st and st[0] == "rngps":
            shape, ps = (n, *st[1:]), dctx.param(self, "rng_shapes")
        else:
            const = self.spec.GetArgument("shape", None)
            shape, ps = (n, *[int(v) for v in const or ()]), None
        dt = to_torch_type(self.spec.GetArgument("dtype", None) or self.default_dtype)
        return n, shape, ps, dt, dctx.device


@register_operator("random.Uniform", "gpu")
class UniformGPU(_RngShapeMixin, Operator):
    def lower(self, dctx, *inputs):
        n, shape, ps, dt, dev = self._setup(dctx, inputs)
        g = dctx.generator(self)
        values = self.spec.GetArgument("values", None)
        if values:
            idx = torch.randint(0, len(values), shape, generator=g, device=dev)
            out = torch.tensor(values, dtype=torch.float32, device=dev)[idx]
        else:
            lo, hi = self.spec.GetArgument("range", [-1.0, 1.0])
            u = torch.rand(shape, generator=g, dtype=torch.float32, device=dev)
            out = u * (float(hi) - float(lo)) + float(lo)
        return [DeviceBatch(out.to(dt), ps, "")]


@register_operator("random.Normal", "gpu")
class NormalGPU(_RngShapeMixin, Operator):
    def lower(self, dctx, *inputs):
        n, shape, ps, dt, dev = self._setup(dctx, inputs)
        mean = per_sample(dctx, self, "mean", 0.0, n, len(shape), dev)
        std = per_sample(dctx, self, "stddev", 1.0, n, len(shape), dev)
        out = torch.randn(shape, generator=dctx.generator(self), dtype=torch.float32, device=dev)
        return [DeviceBatch((out * std + mean).to(dt), ps, "")]


@register_operator("random.CoinFlip", "gpu")
class CoinFlipGPU(_RngShapeMixin, Operator):
    default_dtype = DALIDataType.INT32

    def lower(self, dctx, *inputs):
        n, shape, ps, dt, dev = self._setup(dctx, inputs)
        p = per_sample(dctx, self, "probability", 0.5, n, len(shape), dev)
        u = torch.rand(shape, generator=dctx.generator(self), dtype=torch.float32, device=dev)
        return [DeviceBatch((u < p).to(dt), ps, "")]


def log_gamma(alpha: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """log X for X ~ Gamma(alpha), elementwise: Gamma(a) = Gamma(a + 1) *
    U^(1/a), taken in logs, so a small ``alpha`` (mixup's 0.2) never
    underflows float32 to log 0."""
    u = 1.0 - torch.rand(alpha.shape, generator=g, dtype=torch.float32, device=alpha.device)
    return torch.log(torch._standard_gamma(alpha + 1.0, generator=g)) + torch.log(u) / alpha


@register_operator("random.Beta", "gpu")
class BetaGPU(_RngShapeMixin, Operator):
    def lower(self, dctx, *inputs):
        n, shape, ps, dt, dev = self._setup(dctx, inputs)
        a, b = (per_sample(dctx, self, name, 1.0, n, len(shape), dev).expand(shape).contiguous()
                for name in ("alpha", "beta"))
        g = dctx.generator(self)
        # X / (X + Y) for X ~ Gamma(a), Y ~ Gamma(b), from their logs
        out = torch.sigmoid(log_gamma(a, g) - log_gamma(b, g))
        return [DeviceBatch(out.to(dt), ps, "")]
