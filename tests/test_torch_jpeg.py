"""JPEG device tail: dali_tpu_torch.kernels.jpeg against jax.vmap of
dali_tpu.kernels.jpeg.jpeg_device_tail, for every sampling mode and IDCT
size k.

Contract: uint8 output bit-equal. Both sides evaluate the same fixed-order
float32 multiply-add chain and round half to even; if the two backends ever
split a rounding tie differently, the difference is one step on a bounded
fraction of pixels (measured: 0, PERF.md), never more."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dali_tpu.kernels import jpeg as ref
from dali_tpu_torch.kernels import jpeg as port

MAX_TIE_FRACTION = 1e-4


def _coeffs(rng, shape, k):
    c = np.round(rng.laplace(0, 3.0, shape + (k * k,))).astype(np.int16)
    c[..., 0] = rng.integers(-60, 60, shape)
    return c


def _qtab(rng, k):
    return rng.integers(1, 40, k * k).astype(np.int32)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("ky", [2, 4, 8])
def test_device_tail_matches_jax(mode, ky):
    rng = np.random.default_rng(100 * mode + ky)
    n, yh, yw = 3, 6, 8
    kc = ky
    ch = yh // 2 if mode == 0 else yh
    cw = yw if mode == 1 else yw // 2
    y = _coeffs(rng, (n, yh, yw), ky)
    c = _coeffs(rng, (n, 2, ch, cw), kc)
    q = np.stack([np.concatenate([_qtab(rng, ky), _qtab(rng, kc)]) for _ in range(n)])
    want = np.asarray(jax.vmap(lambda a, b, qq: ref.jpeg_device_tail(jnp, a, b, qq, ky, mode))(
        jnp.asarray(y), jnp.asarray(c), jnp.asarray(q)))
    got = port.jpeg_device_tail(torch.from_numpy(y), torch.from_numpy(c), torch.from_numpy(q),
                                ky, mode).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (n, yh * ky, yw * ky, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= MAX_TIE_FRACTION


def test_device_tail_chroma_full_and_canvas_fit():
    """chroma_full (kc = 2*ky) and a chroma canvas larger than the luma one."""
    rng = np.random.default_rng(5)
    ky, kc = 2, 4
    y = _coeffs(rng, (2, 4, 4), ky)
    c = _coeffs(rng, (2, 2, 3, 3), kc)  # 12x12 chroma px vs 8x8 luma px: cropped
    q = np.stack([np.concatenate([_qtab(rng, ky), _qtab(rng, kc)]) for _ in range(2)])
    want = np.asarray(jax.vmap(lambda a, b, qq: ref.jpeg_device_tail(jnp, a, b, qq, ky, 0, True))(
        jnp.asarray(y), jnp.asarray(c), jnp.asarray(q)))
    got = port.jpeg_device_tail(torch.from_numpy(y), torch.from_numpy(c), torch.from_numpy(q),
                                ky, 0, True).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_idct_matrix(k):
    np.testing.assert_array_equal(port.idct_matrix(k), ref.idct_matrix(k))


def test_shift_window_matches_rrc_lower():
    """The residual RRC shift (clamped gathers, decoders.py:1668-1672)."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (4, 10, 12, 3), dtype=np.uint8)
    dy = np.array([0, 3, 9, 12], np.int32)
    dx = np.array([11, 0, 5, 20], np.int32)

    def shift(im, oy, ox):
        im = jnp.take(im, jnp.clip(jnp.arange(10) + oy, 0, 9), axis=0)
        return jnp.take(im, jnp.clip(jnp.arange(12) + ox, 0, 11), axis=1)

    want = np.asarray(jax.vmap(shift)(jnp.asarray(img), jnp.asarray(dy), jnp.asarray(dx)))
    got = port.shift_window(torch.from_numpy(img), torch.from_numpy(dy), torch.from_numpy(dx))
    np.testing.assert_array_equal(got.numpy(), want)
