"""Separable resize: dali_tpu_torch.kernels.resample against
dali_tpu.kernels.resample.resample_batch on ragged canvases.

float32 output: atol 1e-4 (the two sides sum the matrix products in different
orders). uint8 output: round half to even of those float results, so a value
that lands within float error of .5 may round the other way; the difference
is at most one step on a bounded fraction of pixels (measured in PERF.md)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dali_tpu.kernels import resample as ref
from dali_tpu.types import DALIInterpType as RefInterp
from dali_tpu_torch.kernels import resample as port
from dali_tpu_torch.types import DALIInterpType

MAX_U8_FLIP_FRACTION = 2e-3


def _batch(seed, n=4, H=40, W=56, C=3):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (n, H, W, C), dtype=np.uint8)
    ext = np.stack([rng.integers(H // 3, H + 1, n), rng.integers(W // 3, W + 1, n)], 1)
    ext[0] = (H, W)
    return data, ext.astype(np.int32)


@pytest.mark.parametrize("interp,out_hw", [
    ("INTERP_LINEAR", (24, 20)), ("INTERP_LINEAR", (64, 72)), ("INTERP_TRIANGULAR", (24, 20)),
    ("INTERP_CUBIC", (24, 20)), ("INTERP_NN", (64, 72)), ("INTERP_LANCZOS3", (24, 20)),
    ("INTERP_GAUSSIAN", (24, 20))])
def test_resample_float_matches_jax(interp, out_hw):
    data, ext = _batch(len(interp) + out_hw[0])
    want = np.asarray(ref.resample_batch(jnp.asarray(data), jnp.asarray(ext), None, None,
                                         *out_hw, RefInterp[interp], True, None))
    got = port.resample_batch(torch.from_numpy(data), torch.from_numpy(ext), *out_hw,
                              DALIInterpType[interp], True, None).numpy()
    assert got.shape == want.shape == (4,) + out_hw + (3,)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("antialias", [True, False])
def test_resample_uint8_matches_jax(antialias):
    data, ext = _batch(11, n=6, H=64, W=80)
    want = np.asarray(ref.resample_batch(jnp.asarray(data), jnp.asarray(ext), None, None, 32, 32,
                                         RefInterp.INTERP_LINEAR, antialias, jnp.uint8))
    got = port.resample_batch(torch.from_numpy(data), torch.from_numpy(ext), 32, 32,
                              DALIInterpType.INTERP_LINEAR, antialias, torch.uint8).numpy()
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= MAX_U8_FLIP_FRACTION


def test_resample_uniform_batch_without_extents():
    data, _ = _batch(3)
    want = np.asarray(ref.resample_batch(jnp.asarray(data), None, None, None, 16, 16))
    got = port.resample_batch(torch.from_numpy(data), None, 16, 16).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("scale", [0.5, 1.0, 3.7])
def test_max_taps(scale):
    for interp in DALIInterpType:
        for aa in (True, False):
            assert port.max_taps(interp, scale, aa) == ref.max_taps(RefInterp(int(interp)), scale, aa)
