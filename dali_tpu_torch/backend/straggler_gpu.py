"""noise.Shot on the device (counterpart of that operator of
``dali_tpu/backend/straggler_gpu.py``; the reference's other operators of that
file are not ported yet): Poisson draws from ``DeviceCtx.generator``."""

from __future__ import annotations

import torch

from .._schema import register_operator
from ..batch import DeviceBatch
from .base import Operator
from .random import per_sample


@register_operator("noise.Shot", "gpu")
class ShotNoiseGPU(Operator):
    def lower(self, dctx, inp: DeviceBatch):
        x = inp.data
        f = per_sample(dctx, self, "factor", 20.0, x.shape[0], x.dim(), x.device)
        safe_f = torch.where(f <= 0, 1.0, f)
        # a negative value has no Poisson rate: it draws 0, as a rate of 0 does
        lam = (x.to(torch.float32) / safe_f).clamp_(min=0)
        noisy = torch.poisson(lam, generator=dctx.generator(self)) * safe_f
        out = torch.where(f <= 0, x.to(torch.float32), noisy)
        if not x.dtype.is_floating_point:
            info = torch.iinfo(x.dtype)
            out = out.clamp(info.min, info.max)
        return [inp.with_data(out.to(x.dtype))]
