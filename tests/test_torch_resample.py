"""Separable resize: dali_tpu_torch.kernels.resample against
dali_tpu.kernels.resample.resample_batch (per-sample ROI, tap bounds) and
resample_volume_batch on ragged canvases.

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
    got = port.resample_batch(torch.from_numpy(data), torch.from_numpy(ext), None, None, *out_hw,
                              DALIInterpType[interp], True, None).numpy()
    assert got.shape == want.shape == (4,) + out_hw + (3,)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("antialias", [True, False])
def test_resample_uint8_matches_jax(antialias):
    data, ext = _batch(11, n=6, H=64, W=80)
    want = np.asarray(ref.resample_batch(jnp.asarray(data), jnp.asarray(ext), None, None, 32, 32,
                                         RefInterp.INTERP_LINEAR, antialias, jnp.uint8))
    got = port.resample_batch(torch.from_numpy(data), torch.from_numpy(ext), None, None, 32, 32,
                              DALIInterpType.INTERP_LINEAR, antialias, torch.uint8).numpy()
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= MAX_U8_FLIP_FRACTION


def test_resample_uniform_batch_without_extents():
    data, _ = _batch(3)
    want = np.asarray(ref.resample_batch(jnp.asarray(data), None, None, None, 16, 16))
    got = port.resample_batch(torch.from_numpy(data), None, None, None, 16, 16).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("scale", [0.5, 1.0, 3.7])
def test_max_taps(scale):
    for interp in DALIInterpType:
        for aa in (True, False):
            assert port.max_taps(interp, scale, aa) == ref.max_taps(RefInterp(int(interp)), scale, aa)


def _windows(seed, ext):
    """Per-sample ROI windows inside each valid extent: [n, 2] starts and
    sizes, float32, with fractional origins."""
    rng = np.random.default_rng(seed)
    size = np.stack([rng.uniform(0.2, 1.0, len(ext)) * ext[:, 0],
                     rng.uniform(0.2, 1.0, len(ext)) * ext[:, 1]], 1)
    start = rng.uniform(0.0, 1.0, size.shape) * (ext - size)
    return start.astype(np.float32), size.astype(np.float32)


@pytest.mark.parametrize("interp,out_hw", [
    ("INTERP_LINEAR", (64, 72)), ("INTERP_TRIANGULAR", (12, 10)), ("INTERP_CUBIC", (24, 20)),
    ("INTERP_NN", (30, 30))])
def test_resample_roi_matches_jax(interp, out_hw):
    """RandomResizedCrop's form: one resample over per-sample windows."""
    data, ext = _batch(40 + out_hw[0], n=5)
    start, size = _windows(out_hw[1], ext)
    want = np.asarray(ref.resample_batch(jnp.asarray(data), jnp.asarray(ext), jnp.asarray(start),
                                         jnp.asarray(size), *out_hw, RefInterp[interp]))
    got = port.resample_batch(torch.from_numpy(data), torch.from_numpy(ext),
                              torch.from_numpy(start), torch.from_numpy(size), *out_hw,
                              DALIInterpType[interp], True, None).numpy()
    assert got.shape == want.shape == (5,) + out_hw + (3,)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("interp", ["INTERP_LINEAR", "INTERP_CUBIC"])
def test_resample_tap_bound_override(interp):
    """Resize's per-sample canvas: each output fills the front (h_k, w_k) of
    a (32, 40) canvas, its ROI stretched by canvas/out; the tap bound comes
    from the true per-sample scale, which exceeds the canvas ratio. With the
    canvas-ratio bound the heavy downscales lose antialias taps."""
    data, ext = _batch(51, n=4, H=96, W=120)
    out = np.array([[32, 40], [6, 8], [12, 5], [20, 33]], np.int32)
    roi = (ext * (np.array([32, 40]) / out)).astype(np.float32)
    taps = [port.max_taps(DALIInterpType[interp], float((ext[:, k] / out[:, k]).max()), True)
            for k in (0, 1)]
    assert taps[0] > port.max_taps(DALIInterpType[interp], 96 / 32, True)
    want = np.asarray(ref.resample_batch(jnp.asarray(data), jnp.asarray(ext), None,
                                         jnp.asarray(roi), 32, 40, RefInterp[interp],
                                         taps_y=taps[0], taps_x=taps[1]))
    got = port.resample_batch(torch.from_numpy(data), torch.from_numpy(ext), None,
                              torch.from_numpy(roi), 32, 40, DALIInterpType[interp], True, None,
                              taps_y=taps[0], taps_x=taps[1]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    short = port.resample_batch(torch.from_numpy(data), torch.from_numpy(ext), None,
                                torch.from_numpy(roi), 32, 40, DALIInterpType[interp], True,
                                None).numpy()
    assert np.abs(short - want).max() > 1e-2  # too few taps change the result


@pytest.mark.parametrize("interp,out_dhw", [
    ("INTERP_LINEAR", (5, 12, 20)), ("INTERP_NN", (7, 9, 11)), ("INTERP_CUBIC", (14, 40, 50))])
def test_resample_volume_matches_jax(interp, out_dhw):
    rng = np.random.default_rng(sum(out_dhw))
    n, D, H, W, C = 3, 10, 24, 28, 2
    data = rng.integers(0, 256, (n, D, H, W, C), dtype=np.uint8)
    ext = np.stack([rng.integers(4, D + 1, n), rng.integers(8, H + 1, n),
                    rng.integers(8, W + 1, n)], 1).astype(np.int32)
    ext[0] = (D, H, W)
    want = np.asarray(ref.resample_volume_batch(jnp.asarray(data), jnp.asarray(ext), *out_dhw,
                                                RefInterp[interp]))
    got = port.resample_volume_batch(torch.from_numpy(data), torch.from_numpy(ext), *out_dhw,
                                     DALIInterpType[interp], True, None).numpy()
    assert got.shape == want.shape == (n,) + out_dhw + (C,)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_resample_volume_uint8_without_extents():
    data = np.random.default_rng(8).integers(0, 256, (2, 6, 16, 20, 1), dtype=np.uint8)
    want = np.asarray(ref.resample_volume_batch(jnp.asarray(data), None, 4, 10, 12,
                                                out_dtype=jnp.uint8))
    got = port.resample_volume_batch(torch.from_numpy(data), None, 4, 10, 12,
                                     DALIInterpType.INTERP_LINEAR, True, torch.uint8).numpy()
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= MAX_U8_FLIP_FRACTION
