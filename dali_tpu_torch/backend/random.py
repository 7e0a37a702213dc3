"""random.Uniform and random.CoinFlip on the host (counterpart of
``dali_tpu/backend/random.py``): one Philox stream per (op, iteration),
drawn sample by sample, so the draws equal the reference's. Per-sample
outputs reach device ops as argument inputs or through ``.gpu()``."""

from __future__ import annotations

import numpy as np

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import HostBatch
from ..types import DALIDataType, to_numpy_type
from .base import Operator


def _random_schema(name, doc):
    return (DALI_SCHEMA(name).DocStr(doc).NumInput(0, 1).NumOutput(1).Devices("cpu", "gpu")
            .AddRandomSeedArg()
            .AddOptionalArg("shape", ArgType.INT_VEC, "Output sample shape.", None, tensor_ok=True)
            .AddOptionalArg("dtype", ArgType.DATA_TYPE, "Output dtype.", None))


class _RandomBase(Operator):
    default_dtype = DALIDataType.FLOAT

    def run_batch(self, ctx, *inputs):
        n = len(inputs[0]) if inputs else ctx.batch_size
        rng = ctx.rng(self)
        dt = to_numpy_type(self.spec.GetArgument("dtype", None) or self.default_dtype)
        if not inputs and not self.spec.arg_inputs and self.spec.GetArgument("shape", None) is None:
            # one scalar per sample: one call draws the same stream as n calls
            out = self._draw(ctx, rng, None, (n,)).astype(dt)
            return [HostBatch([out[i, ...] for i in range(n)])]
        samples = []
        for i in range(n):
            if inputs:
                shape = inputs[0].samples[i].shape
            else:
                s = ctx.arg(self, "shape", i, None)
                shape = () if s is None else tuple(int(v) for v in np.asarray(s).reshape(-1))
            samples.append(self._draw(ctx, rng, i, shape).astype(dt))
        return [HostBatch(samples)]

    def _draw(self, ctx, rng, idx, shape):
        raise NotImplementedError


_random_schema("random.Uniform", "Uniform random numbers in `range`, or drawn from "
               "the discrete `values`.").AddOptionalArg(
    "range", ArgType.FLOAT_VEC, "Half-open range [lo, hi).", [-1.0, 1.0]).AddOptionalArg(
    "values", ArgType.FLOAT_VEC, "Discrete value set.", None)


@register_operator("random.Uniform", "cpu")
class UniformCPU(_RandomBase):
    def _draw(self, ctx, rng, idx, shape):
        values = self.spec.GetArgument("values", None)
        if values:
            return np.asarray(rng.choice(np.asarray(values), size=shape or None))
        lo, hi = self.spec.GetArgument("range", [-1.0, 1.0])
        return np.asarray(rng.uniform(lo, hi, size=shape or None))


_random_schema("random.CoinFlip", "Bernoulli 0/1 samples.").AddOptionalArg(
    "probability", ArgType.FLOAT, "P(1).", 0.5, tensor_ok=True)


@register_operator("random.CoinFlip", "cpu")
class CoinFlipCPU(_RandomBase):
    default_dtype = DALIDataType.INT32

    def _draw(self, ctx, rng, idx, shape):
        p = float(np.asarray(ctx.arg(self, "probability", idx, 0.5)))
        return np.asarray(rng.random(size=shape or None) < p).astype(np.int32)
