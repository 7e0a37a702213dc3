"""random.CoinFlip on the host (counterpart of ``dali_tpu/backend/random.py``
``_RandomBase`` / ``CoinFlipCPU``): one Philox stream per (op, iteration),
drawn sample by sample, so the flips equal the reference's."""

from __future__ import annotations

import numpy as np

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import HostBatch
from ..types import DALIDataType, to_numpy_type
from .base import Operator

DALI_SCHEMA("random.CoinFlip").DocStr(
    "Bernoulli 0/1 samples."
).NumInput(0, 1).NumOutput(1).Devices("cpu", "gpu").AddRandomSeedArg().AddOptionalArg(
    "shape", ArgType.INT_VEC, "Output sample shape.", None, tensor_ok=True
).AddOptionalArg(
    "dtype", ArgType.DATA_TYPE, "Output dtype.", None
).AddOptionalArg(
    "probability", ArgType.FLOAT, "P(1).", 0.5, tensor_ok=True
)


@register_operator("random.CoinFlip", "cpu")
class CoinFlipCPU(Operator):
    def run_batch(self, ctx, *inputs):
        n = len(inputs[0]) if inputs else ctx.batch_size
        rng = ctx.rng(self)
        dt = to_numpy_type(self.spec.GetArgument("dtype", None) or DALIDataType.INT32)
        samples = []
        for i in range(n):
            if inputs:
                shape = inputs[0].samples[i].shape
            else:
                s = ctx.arg(self, "shape", i, None)
                shape = () if s is None else tuple(int(v) for v in np.asarray(s).reshape(-1))
            p = float(np.asarray(ctx.arg(self, "probability", i, 0.5)))
            samples.append(np.asarray(rng.random(size=shape or None) < p).astype(np.int32).astype(dt))
        return [HostBatch(samples)]
