"""Crop-mirror-normalize: the plain PyTorch version of dali_tpu_torch's CMN
kernel against dali_tpu.kernels.cmn.crop_mirror_normalize and against the
Pallas kernel cmn_pallas in interpret mode (atol 1e-5 for float32: one fused
multiply-add versus a multiply then an add; one half-precision step at the
value's magnitude for float16, where the two float32 results may round to
neighbouring halves). The CUDA kernel itself is compared with the plain
version by tests/test_torch_cuda.py, which skips without a card."""

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


def _f16_within_one_step(got, want):
    """|got - want| at most one float16 step at the larger magnitude."""
    g, w = got.astype(np.float32), want.astype(np.float32)
    step = np.spacing(np.maximum(np.abs(g), np.abs(w)).astype(np.float16)).astype(np.float32)
    assert np.all(np.abs(g - w) <= step), float(np.abs(g - w).max())


# window cases: (crop_h, crop_w, fill, origins, valid extents) on a 5 x 20 x 24 canvas
WINDOWS = {
    # clamped origins (two past the canvas), trimmed valid widths under the mirror
    "clamp": (16, 13, None, ([3, 0, 5, 12, 30], [4, 2, 10, 20, 50]),
              ([20, 15, 18, 20, 10], [24, 20, 11, 24, 5])),
    # the pad policy: negative origins, windows past ext_h / ext_w, fill length 1
    "pad_fill1": (12, 15, [7.5], ([-3, 10, 6, -20, 15], [-4, 12, 0, 30, -16]),
                  ([20, 15, 9, 20, 17], [24, 20, 11, 24, 5])),
    # the pad policy: a window larger than the canvas, fill length C
    "pad_fill_c": (26, 33, [1.0, -2.0, 3.5], ([-3, 0, -6, -1, 2], [-4, -9, 0, -5, 3]),
                   ([20, 15, 18, 20, 10], [24, 20, 11, 24, 5])),
}


@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("in_dtype", ["uint8", "float16", "float32"])
@pytest.mark.parametrize("with_mirror", [True, False])
@pytest.mark.parametrize("pad_output", [False, True])
@pytest.mark.parametrize("layout", ["CHW", "HWC"])
def test_plain_matches_jax_cmn_every_form(layout, pad_output, with_mirror, in_dtype, window):
    """Every 2-D form of the reference: both layouts, pad_output, three
    input dtypes, both window semantics (clamped with the valid-width
    mirror; the pad policy with fill and the whole-window mirror), mirror
    on and off, float32 and float16 output."""
    crop_h, crop_w, fill, (cy, cx), (eh, ew) = WINDOWS[window]
    rng = np.random.default_rng(len(window) + 7 * pad_output)
    data = rng.integers(0, 256, (5, 20, 24, 3)).astype(in_dtype)
    if in_dtype != "uint8":
        data = (data + rng.random(data.shape)).astype(in_dtype)
    cy, cx, eh, ew = (np.asarray(v, np.int32) for v in (cy, cx, eh, ew))
    m = np.array([1, 0, 1, 1, 0], np.int32) if with_mirror else None
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.float16, torch.float16)):
        want = np.asarray(ref.crop_mirror_normalize(
            jnp.asarray(data), jnp.asarray(cy), jnp.asarray(cx),
            None if m is None else jnp.asarray(m), crop_h, crop_w, np.float32(MEAN),
            np.float32(STD), 1.5, 0.25, layout, jdt, pad_output, ext_h=jnp.asarray(eh),
            ext_w=jnp.asarray(ew), fill=None if fill is None else np.float32(fill)))
        got = port.crop_mirror_normalize_plain(
            torch.from_numpy(data), torch.from_numpy(cy), torch.from_numpy(cx),
            None if m is None else torch.from_numpy(m), crop_h, crop_w, MEAN, STD, 1.5, 0.25,
            layout, tdt, pad_output, ext_h=torch.from_numpy(eh), ext_w=torch.from_numpy(ew),
            fill=fill).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        if tdt == torch.float32:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        else:
            _f16_within_one_step(got, want)
    if fill is not None:  # the case does reach the fill
        ch0 = got[:, 0] if layout == "CHW" else got[..., 0]
        assert (ch0 == np.float16(fill[0])).any()


def test_plain_raises_on_integer_output_and_oversized_window():
    data, cy, cx, mirror, ext_w = _case(1)
    args = [torch.from_numpy(x) for x in (data, cy, cx, mirror)]
    with pytest.raises(NotImplementedError, match="integer output"):
        port.crop_mirror_normalize(*args, 24, 33, MEAN, STD, out_dtype=torch.uint8)
    with pytest.raises(ValueError, match="exceeds the canvas"):
        port.crop_mirror_normalize(*args, 24, 65, MEAN, STD)
    with pytest.raises(ValueError, match="output_layout"):
        port.crop_mirror_normalize(*args, 24, 33, MEAN, STD, output_layout="CWH")


def test_constants_fold_once_per_value():
    """An operator passes the same tuples on every call: the folded
    constants are the same arrays, read-only, and match fold_constants."""
    first = port.constants(tuple(MEAN), tuple(STD), 1.0, 0.0, (5.0,), 3)
    assert port.constants(tuple(MEAN), tuple(STD), 1.0, 0.0, (5.0,), 3) is first
    a, b, fill, packed = first
    want_a, want_b = port.fold_constants(MEAN, STD, 1.0, 0.0, 3)
    np.testing.assert_array_equal(a, want_a)
    np.testing.assert_array_equal(packed, np.float32([*want_a, 0, *want_b, 0, 5, 5, 5, 0]))
    assert not packed.flags.writeable and not fill.flags.writeable


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

