"""Crop-mirror-normalize: the plain PyTorch version of dali_tpu_torch's CMN
kernel against dali_tpu.kernels.cmn.crop_mirror_normalize and against the
Pallas kernel cmn_pallas in interpret mode (atol 1e-5: one fused multiply-add
versus a multiply then an add). The CUDA kernel itself is compared with the
plain version by tests/test_torch_cuda.py, which skips without a card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dali_tpu.kernels import cmn as ref
from dali_tpu.kernels.cmn_pallas import cmn_pallas
from dali_tpu_torch.kernels import cmn as port

MEAN = [123.675, 116.28, 103.53]
STD = [58.395, 57.12, 57.375]


def _case(seed, n=5, H=40, W=64, crop=(24, 33)):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)
    cy = rng.integers(0, H - crop[0] + 1, n).astype(np.int32)
    cx = rng.integers(0, W - crop[1] + 1, n).astype(np.int32)
    cx[0] = 13  # not a multiple of 8
    mirror = (np.arange(n) % 2).astype(np.int32)
    ext_w = np.full(n, W, np.int32)
    ext_w[1] = cx[1] + crop[1] - 7  # trimmed valid width on a mirrored sample
    return data, cy, cx, mirror, ext_w


@pytest.mark.parametrize("layout", ["CHW", "HWC"])
@pytest.mark.parametrize("with_mirror", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jax_cmn(layout, with_mirror, seed):
    data, cy, cx, mirror, ext_w = _case(seed)
    m = mirror if with_mirror else None
    want = np.asarray(ref.crop_mirror_normalize(
        jnp.asarray(data), jnp.asarray(cy), jnp.asarray(cx),
        None if m is None else jnp.asarray(m), 24, 33, np.float32(MEAN), np.float32(STD),
        1.0, 0.0, layout, jnp.float32, ext_w=jnp.asarray(ext_w)))
    got = port.crop_mirror_normalize_plain(
        torch.from_numpy(data), torch.from_numpy(cy), torch.from_numpy(cx),
        None if m is None else torch.from_numpy(m), 24, 33, MEAN, STD, 1.0, 0.0, layout,
        torch.float32, ext_w=torch.from_numpy(ext_w)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_plain_scale_shift_fp16():
    data, cy, cx, mirror, ext_w = _case(4)
    args = dict(scale=2.0, shift=0.5)
    want = np.asarray(ref.crop_mirror_normalize(
        jnp.asarray(data), jnp.asarray(cy), jnp.asarray(cx), jnp.asarray(mirror), 24, 33,
        np.float32(MEAN), np.float32(STD), output_layout="CHW", out_dtype=jnp.float16, **args))
    got = port.crop_mirror_normalize_plain(
        torch.from_numpy(data), torch.from_numpy(cy), torch.from_numpy(cx),
        torch.from_numpy(mirror), 24, 33, MEAN, STD, output_layout="CHW",
        out_dtype=torch.float16, **args).numpy()
    assert got.dtype == np.float16
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), atol=4e-3, rtol=0)


@pytest.mark.parametrize("seed", [0, 3])
def test_plain_matches_pallas_interpret(seed):
    """cmn_pallas mirrors the whole window, so compare on fully valid windows."""
    rng = np.random.default_rng(seed)
    N, H, W = 4, 48, 96
    data = rng.integers(0, 256, (N, H, W, 3), np.uint8)
    cy = rng.integers(0, H - 32, N).astype(np.int32)
    cx = rng.integers(0, W - 48 - 8, N).astype(np.int32)
    cx[1] = 5  # unaligned x offset
    m = (np.arange(N) % 2).astype(np.int32)
    a, b = port.fold_constants(MEAN, STD, 1.0, 0.0, 3)
    want = np.asarray(cmn_pallas(jnp.asarray(data), jnp.asarray(cy), jnp.asarray(cx),
                                 jnp.asarray(m), jnp.asarray(a), jnp.asarray(b), crop_h=32,
                                 crop_w=48, interpret=True))
    got = port.crop_mirror_normalize_plain(
        torch.from_numpy(data), torch.from_numpy(cy), torch.from_numpy(cx), torch.from_numpy(m),
        32, 48, MEAN, STD).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_wrapper_uses_plain_version_on_cpu():
    data, cy, cx, mirror, ext_w = _case(2)
    before = port.COUNTER.launches
    args = (torch.from_numpy(data), torch.from_numpy(cy), torch.from_numpy(cx),
            torch.from_numpy(mirror), 24, 33, MEAN, STD)
    torch.testing.assert_close(port.crop_mirror_normalize(*args),
                               port.crop_mirror_normalize_plain(*args), rtol=0, atol=0)
    assert port.COUNTER.launches == before  # no kernel launch for a CPU tensor


def test_fold_constants_match_reference_order():
    a, b = port.fold_constants(MEAN, STD, 1.5, 0.25, 3)
    mean, std = jnp.asarray(MEAN, jnp.float32), jnp.asarray(STD, jnp.float32)
    np.testing.assert_array_equal(a, np.asarray(1.5 / std))
    np.testing.assert_array_equal(b, np.asarray(0.25 - mean * 1.5 / std))

