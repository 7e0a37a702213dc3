"""Coefficient-wire decode: dali_tpu_torch.kernels.wire against the JAX
reference functions of dali_tpu.executor. Integer code on both sides, so the
outputs must be equal element for element."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dali_tpu import executor as ref
from dali_tpu_torch.kernels import wire


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_nib_stream(seed):
    rng = np.random.default_rng(seed)
    nibs = rng.integers(0, 256, 4000, dtype=np.uint8)
    esc = rng.integers(-128, 128, 700, dtype=np.int8)
    want = np.asarray(ref._decode_nib_stream(jnp, jnp.asarray(nibs), jnp.asarray(esc)))
    got = wire.decode_nib_stream(_t(nibs), _t(esc)).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_esc16_stream(seed):
    rng = np.random.default_rng(seed)
    dc8 = rng.integers(-128, 128, 3000, dtype=np.int8)
    esc = rng.integers(-2048, 2048, 200, dtype=np.int16)
    want = np.asarray(ref._decode_esc16_stream(jnp, jnp.asarray(dc8), jnp.asarray(esc)))
    got = wire.decode_esc16_stream(_t(dc8), _t(esc)).numpy()
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)


def _ragged(rng, n, lead, canvas_hw):
    """Per-sample block dims inside the canvas and dense flat offsets."""
    hw = np.stack([rng.integers(1, canvas_hw[0] + 1, n), rng.integers(1, canvas_hw[1] + 1, n)], 1)
    shapes = np.concatenate([np.full((n, len(lead)), lead, np.int64), hw], 1).astype(np.int32)
    sizes = shapes.prod(1)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    return shapes, offsets, int(sizes.sum())


@pytest.mark.parametrize("lead", [(), (2,)])
def test_unflatten_boundary(lead):
    rng = np.random.default_rng(7)
    canvas = tuple(lead) + (6, 9)
    shapes, offsets, total = _ragged(rng, 5, lead, (6, 9))
    flat = rng.integers(-500, 500, total + 11, dtype=np.int16)
    want = np.asarray(ref._unflatten_boundary(jnp, jnp.asarray(flat), jnp.asarray(offsets),
                                              jnp.asarray(shapes), canvas))
    got = wire.unflatten_boundary(_t(flat), _t(offsets), _t(shapes), canvas).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nac", [3, 8, 15])
def test_zz_sel_perm(nac):
    assert wire.zz_sel_perm(nac) == ref._zz_sel_perm(nac)


@pytest.mark.parametrize("nac,lead", [(15, ()), (3, ()), (15, (2,)), (8, (2,))])
def test_unsparse_boundary(nac, lead):
    """Random bitmaps (with garbage past the last block, as the ratcheted wire
    ships it) and their packed values rebuild the same dense AC canvas."""
    rng = np.random.default_rng(nac * 10 + len(lead))
    shapes_b, offsets, n_blocks = _ragged(rng, 6, lead, (7, 5))
    shapes = np.concatenate([shapes_b, np.full((6, 1), nac, np.int32)], 1)
    canvas = tuple(lead) + (7, 5, nac)
    mask = (rng.integers(0, 1 << 16, n_blocks + 40) & ((1 << nac) - 1)).astype(np.uint16)
    mask[::3] = 0
    nnz = int(sum(bin(int(m)).count("1") for m in mask))
    vals = rng.integers(-128, 128, nnz + 16, dtype=np.int8)
    want = np.asarray(ref._unsparse_boundary(jnp, jnp.asarray(mask), jnp.asarray(vals),
                                             jnp.asarray(offsets), jnp.asarray(shapes), canvas))
    got = wire.unsparse_boundary(_t(mask.view(np.int16)), _t(vals), _t(offsets), _t(shapes),
                                 canvas).numpy()
    assert got.shape == (6,) + canvas
    np.testing.assert_array_equal(got, want)


def test_popcount16():
    x = np.arange(0, 1 << 16, 97, dtype=np.int32)
    want = np.array([bin(int(v)).count("1") for v in x])
    np.testing.assert_array_equal(wire.popcount16(_t(x)).numpy(), want)
