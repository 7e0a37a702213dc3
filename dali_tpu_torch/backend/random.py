"""Random-number and Gaussian-noise operators on the host, and
``noise.Gaussian`` on the device (counterpart of
``dali_tpu/backend/random.py``).

Host draws come from one Philox stream per (op, iteration), sample by sample,
or one per (op, iteration, sample) for the noise, keyed as the reference keys
them, so every host draw equals the reference's. Per-sample outputs reach
device ops as argument inputs or through ``.gpu()``. The device noise draws
from ``DeviceCtx.generator``: the same seed and iteration give the same
noise, and its distribution is the reference's (ROADMAP.md Queue 3)."""

from __future__ import annotations

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch, HostBatch
from ..types import DALIDataType, cast_host
from .base import BF16_ROUND, BF16_WIDEN, Operator


def _random_schema(name, doc):
    return (DALI_SCHEMA(name).DocStr(doc).NumInput(0, 1).NumOutput(1).Devices("cpu", "gpu")
            .AddRandomSeedArg()
            .AddOptionalArg("shape", ArgType.INT_VEC, "Output sample shape.", None, tensor_ok=True,
                            per_sample=True)
            .AddOptionalArg("dtype", ArgType.DATA_TYPE, "Output dtype.", None))


class _RandomBase(Operator):
    reads_bfloat16 = BF16_WIDEN

    default_dtype = DALIDataType.FLOAT

    def run_batch(self, ctx, *inputs):
        n = len(inputs[0]) if inputs else ctx.batch_size
        rng = ctx.rng(self)
        # `dtype or default`, as the reference reads it: UINT8 (0) gives the default
        dt = self.spec.GetArgument("dtype", None) or self.default_dtype
        if not inputs and not self.spec.arg_inputs and self.spec.GetArgument("shape", None) is None:
            # one scalar per sample: one call draws the same stream as n calls
            out = cast_host(self._draw(ctx, rng, None, (n,)), dt)
            return [HostBatch([out[i, ...] for i in range(n)])]
        samples = []
        for i in range(n):
            if inputs:
                shape = inputs[0].samples[i].shape
            else:
                s = ctx.arg(self, "shape", i, None)
                shape = () if s is None else tuple(int(v) for v in np.asarray(s).reshape(-1))
            samples.append(cast_host(self._draw(ctx, rng, i, shape), dt))
        return [HostBatch(samples)]

    def _draw(self, ctx, rng, idx, shape):
        raise NotImplementedError


def _scalar(ctx, op, name, idx, default):
    return float(np.asarray(ctx.arg(op, name, idx, default)))


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


_random_schema("random.Normal", "Normally distributed random numbers.").AddOptionalArg(
    "mean", ArgType.FLOAT, "Mean.", 0.0, tensor_ok=True, per_sample=True).AddOptionalArg(
    "stddev", ArgType.FLOAT, "Standard deviation.", 1.0, tensor_ok=True, per_sample=True)


@register_operator("random.Normal", "cpu")
class NormalCPU(_RandomBase):
    def _draw(self, ctx, rng, idx, shape):
        return np.asarray(rng.normal(_scalar(ctx, self, "mean", idx, 0.0),
                                     _scalar(ctx, self, "stddev", idx, 1.0), size=shape or None))


_random_schema("random.CoinFlip", "Bernoulli 0/1 samples.").AddOptionalArg(
    "probability", ArgType.FLOAT, "P(1).", 0.5, tensor_ok=True, per_sample=True)


@register_operator("random.CoinFlip", "cpu")
class CoinFlipCPU(_RandomBase):
    default_dtype = DALIDataType.INT32

    def _draw(self, ctx, rng, idx, shape):
        p = _scalar(ctx, self, "probability", idx, 0.5)
        return np.asarray(rng.random(size=shape or None) < p).astype(np.int32)


_random_schema("random.Beta", "Beta-distributed samples.").AddOptionalArg(
    "alpha", ArgType.FLOAT, "Alpha.", 1.0, tensor_ok=True, per_sample=True).AddOptionalArg(
    "beta", ArgType.FLOAT, "Beta.", 1.0, tensor_ok=True, per_sample=True)


@register_operator("random.Beta", "cpu")
class BetaCPU(_RandomBase):
    def _draw(self, ctx, rng, idx, shape):
        return np.asarray(rng.beta(_scalar(ctx, self, "alpha", idx, 1.0),
                                   _scalar(ctx, self, "beta", idx, 1.0), size=shape or None))


_random_schema(
    "random.Choice", "Samples from the input's values, or from range(n) for a scalar input n, "
    "with optional weights `p`."
).AddOptionalArg("p", ArgType.FLOAT_VEC, "Probabilities.", None, tensor_ok=True,
                 per_sample=True).Devices("cpu")


@register_operator("random.Choice", "cpu")
class ChoiceCPU(Operator):
    reads_bfloat16 = BF16_ROUND

    def run_batch(self, ctx, *inputs):
        n = len(inputs[0]) if inputs else ctx.batch_size
        rng = ctx.rng(self)
        samples = []
        for i in range(n):
            shape = ctx.arg(self, "shape", i, None)
            if shape is not None:
                shape = tuple(int(v) for v in np.asarray(shape).reshape(-1))
            p = ctx.arg(self, "p", i, None)
            if p is not None:
                p = np.asarray(p, np.float64)
                p = p / p.sum()
            src = inputs[0].samples[i]
            if src.ndim == 0 or src.size == 1:
                # range mode: the output keeps the scalar input's dtype
                v = np.asarray(rng.choice(int(np.asarray(src).reshape(-1)[0]), size=shape,
                                          p=p)).astype(src.dtype)
            else:
                v = rng.choice(src, size=shape, p=p)
            samples.append(np.asarray(v))
        return [HostBatch(samples)]


DALI_SCHEMA("BatchPermutation").DocStr(
    "A random permutation of the batch's indices, one int32 scalar per sample."
).NumInput(0).NumOutput(1).Devices("cpu").AddRandomSeedArg().AddOptionalArg(
    "no_fixed_points", ArgType.BOOL, "Ensure perm[i] != i.", False).AddOptionalArg(
    "allow_repetitions", ArgType.BOOL,
    "Sample indices with replacement instead of a permutation.", False)


@register_operator("BatchPermutation", "cpu")
class BatchPermutation(Operator):
    def run_batch(self, ctx, *unused):
        rng = ctx.rng(self)
        n = ctx.batch_size
        draw = ((lambda: rng.integers(0, n, size=n))
                if self.spec.GetArgument("allow_repetitions", False)
                else (lambda: rng.permutation(n)))
        perm = draw()
        if self.spec.GetArgument("no_fixed_points", False) and n > 1:
            while np.any(perm == np.arange(n)):
                perm = draw()
        return [HostBatch([np.int32(perm[i]) for i in range(n)])]


DALI_SCHEMA("noise.Gaussian").DocStr(
    "Additive Gaussian noise; integer outputs round half to even and saturate."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddRandomSeedArg().AddOptionalArg(
    "mean", ArgType.FLOAT, "Noise mean.", 0.0, tensor_ok=True, per_sample=True).AddOptionalArg(
    "stddev", ArgType.FLOAT, "Noise std.", 1.0, tensor_ok=True, per_sample=True)


@register_operator("noise.Gaussian", "cpu")
class GaussianNoiseCPU(Operator):
    reads_bfloat16 = BF16_ROUND

    def run_sample(self, ctx, idx, x):
        rng = ctx.rng(self, idx)
        noise = rng.normal(_scalar(ctx, self, "mean", idx, 0.0),
                           _scalar(ctx, self, "stddev", idx, 1.0), size=x.shape)
        noisy = x.astype(np.float32) + noise.astype(np.float32)
        if np.issubdtype(x.dtype, np.integer):
            info = np.iinfo(x.dtype)
            noisy = np.clip(np.round(noisy), info.min, info.max)
        return noisy.astype(x.dtype)


def per_sample(dctx, op, name, default, n, ndim, device):
    """A float argument as a float32 tensor broadcastable over [n, ...] of
    ``ndim`` dims: stacked per sample ([n, 1, ...]) from a cpu or a gpu
    edge, or a 0-d constant."""
    v = dctx.arg(op, name, default)
    if dctx.has_tensor_arg(op, name):
        return v.to(device=device, dtype=torch.float32).reshape(n, *([1] * (ndim - 1)))
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def saturate(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Float values to ``dtype``: integers round half to even (as
    ``jnp.round``) and clip to the dtype's range."""
    if dtype.is_floating_point:
        return x.to(dtype)
    info = torch.iinfo(dtype)
    return torch.round(x).clamp_(info.min, info.max).to(dtype)


@register_operator("noise.Gaussian", "gpu")
class GaussianNoiseGPU(Operator):
    def lower(self, dctx, inp: DeviceBatch):
        x = inp.data
        n, nd = x.shape[0], x.dim()
        mean = per_sample(dctx, self, "mean", 0.0, n, nd, x.device)
        std = per_sample(dctx, self, "stddev", 1.0, n, nd, x.device)
        noise = torch.randn(x.shape, generator=dctx.generator(self), dtype=torch.float32,
                            device=x.device)
        return [inp.with_data(saturate(x.to(torch.float32) + noise * std + mean, x.dtype))]
