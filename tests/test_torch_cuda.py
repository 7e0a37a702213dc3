"""Tests of dali_tpu_torch that need an NVIDIA CUDA card; each skips without
one. This file imports neither jax nor dali_tpu, so it runs on a machine that
has only PyTorch with CUDA:

    python -m pytest -m cuda tests/test_torch_cuda.py

The CMN kernel (csrc/cmn.cu) is held against its plain PyTorch version on the
card: float32 within 1e-5 (one fused multiply-add versus a multiply then an
add), float16 within one half-precision step at the outputs' magnitude
(2**-8 for |x| < 8; these outputs stay within (-3, 4.3)), since the two
float32 values may round to neighbouring halves. The RN50 path on the card
is held against the same pipeline on the CPU: labels equal, images within one
uint8 step divided by the smallest std, on a bounded fraction of values (the
resize's uint8 rounding may split a tie differently). The ASR mel front end
on the card is held against the same pipeline on the CPU: equal canvases and
per-sample shapes, dB within 1e-3 dB and normalized values within 1e-3 on
each sample's valid region (cuFFT and the card's matmul against the CPU's).
Automatic augmentation and DataNode arithmetic on the card are held against
the same graphs on the CPU (the stated limits are in each test)."""

import os

import numpy as np
import pytest
import torch

from dali_tpu_torch import fn, pipeline_def, types
from dali_tpu_torch.kernels import cmn

pytestmark = pytest.mark.cuda

CORPUS = os.path.join(os.path.dirname(__file__), "..", "dali_tpu_torch", "testdata", "rn50")
MEAN = [123.675, 116.28, 103.53]
STD = [58.395, 57.12, 57.375]
LSB = 1.0 / min(STD) + 1e-4
MAX_FLIP_FRACTION = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel and the device path run only there")
    return torch.device("cuda:0")


def _case(seed, n=16, H=96, W=128, C=3, crop=(64, 80)):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (n, H, W, C), dtype=np.uint8)
    cy = rng.integers(0, H - crop[0] + 1, n).astype(np.int32)
    cx = rng.integers(0, W - crop[1] + 1, n).astype(np.int32)
    cx[0] = 13  # not a multiple of 8
    mirror = (np.arange(n) % 2).astype(np.int32)
    ext_w = np.full(n, W, np.int32)
    ext_w[1] = cx[1] + crop[1] - 7  # trimmed valid width on a mirrored sample
    return data, cy, cx, mirror, ext_w


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("with_mirror", [True, False])
@pytest.mark.parametrize("out_dtype,atol", [(torch.float32, 1e-5), (torch.float16, 2.0 ** -8)])
def test_cuda_kernel_matches_plain(card, channels, with_mirror, out_dtype, atol):
    data, cy, cx, mirror, ext_w = _case(7, C=channels)
    mean, std = MEAN[:channels], STD[:channels]
    args = [torch.from_numpy(x).to(card) for x in (data, cy, cx)]
    args += [torch.from_numpy(mirror).to(card) if with_mirror else None, 64, 80, mean, std]
    kw = dict(scale=1.5, shift=0.25, out_dtype=out_dtype, ext_w=torch.from_numpy(ext_w).to(card))
    before = cmn.COUNTER.launches
    got = cmn.crop_mirror_normalize(*args, **kw)
    want = cmn.crop_mirror_normalize_plain(*args, **kw)
    assert cmn.COUNTER.launches == before + 1
    assert got.is_cuda and got.dtype == out_dtype and tuple(got.shape) == (16, channels, 64, 80)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


def test_cuda_kernel_raises_instead_of_falling_back(card):
    data, cy, cx, mirror, ext_w = _case(3)
    args = [torch.from_numpy(x).to(card) for x in (data, cy, cx, mirror)] + [64, 80, MEAN, STD]
    before = cmn.COUNTER.launches
    with pytest.raises(NotImplementedError, match="CHW"):
        cmn.crop_mirror_normalize(*args, output_layout="HWC")
    with pytest.raises(NotImplementedError, match="uint8"):
        cmn.crop_mirror_normalize(args[0].float(), *args[1:])
    with pytest.raises(NotImplementedError, match="contiguous"):
        cmn.crop_mirror_normalize(args[0].transpose(1, 2), *args[1:])
    assert cmn.COUNTER.launches == before


def _rn50(device):
    @pipeline_def(batch_size=8, num_threads=2, seed=42, device=device)
    def rn50_train():
        jpegs, labels = fn.readers.file(file_root=CORPUS, random_shuffle=True, name="Reader",
                                        seed=1234)
        images = fn.decoders.image_random_crop(jpegs, device="mixed", hybrid_device_decode=True,
                                               hybrid_scale=2, seed=77)
        images = fn.resize(images, resize_x=64, resize_y=64)
        mirror = fn.random.coin_flip(probability=0.5, seed=5)
        images = fn.crop_mirror_normalize(images, mirror=mirror, dtype=types.FLOAT,
                                          output_layout="CHW", mean=MEAN, std=STD)
        return images, labels

    pipe = rn50_train()
    pipe.build()
    return pipe


def _two_batches(device):
    pipe = _rn50(device)
    try:
        return [(imgs.as_tensor(), labels.as_array()) for imgs, labels in
                (pipe.run() for _ in range(2))]
    finally:
        pipe.shutdown()


def test_rn50_on_card_matches_cpu(card):
    before = cmn.COUNTER.launches
    on_card = _two_batches(card)
    assert cmn.COUNTER.launches == before + 2
    on_cpu = _two_batches("cpu")
    assert cmn.COUNTER.launches == before + 2  # the CPU pipeline runs the plain version
    for (g_img, g_lab), (c_img, c_lab) in zip(on_card, on_cpu):
        assert g_img.is_cuda and g_img.dtype == torch.float32
        assert tuple(g_img.shape) == (8, 3, 64, 64)
        np.testing.assert_array_equal(g_lab, c_lab)
        diff = (g_img.cpu() - c_img).abs()
        assert float(diff.max()) <= LSB
        assert float((diff > 1e-4).float().mean()) <= MAX_FLIP_FRACTION


def _asr(device, root):
    @pipeline_def(batch_size=8, num_threads=2, seed=7, device=device)
    def asr_frontend():
        enc, _ = fn.readers.file(file_root=root, file_filters=["*.wav"], random_shuffle=True,
                                 name="R", seed=3)
        audio, _rate = fn.decoders.audio(enc, dtype=types.FLOAT, downmix=True, device="mixed")
        audio = fn.preemphasis_filter(audio, preemph_coeff=0.97)
        spec = fn.spectrogram(audio, nfft=512, window_length=320, window_step=160)
        mel = fn.mel_filter_bank(spec, sample_rate=16000.0, nfilter=80)
        db = fn.to_decibels(mel, multiplier=10.0, cutoff_db=-80.0)
        return db, fn.normalize(db, axes=[1])

    pipe = asr_frontend()
    pipe.build()
    try:
        return [pipe.run() for _ in range(2)]
    finally:
        pipe.shutdown()


def test_asr_frontend_on_card_matches_cpu(card, tmp_path):
    from dali_tpu_torch.testdata.make_audio_corpus import write_corpus

    root = write_corpus(str(tmp_path), 16, 5, (1.0, 3.0))
    for got, want in zip(_asr(card, root), _asr("cpu", root)):
        for g, w in zip(got, want):
            assert g.as_tensor().is_cuda and g.dtype == torch.float32
            assert tuple(g.as_tensor().shape) == tuple(w.as_tensor().shape)
            assert g.shape() == w.shape()
            gs, ws = g.as_cpu(), w.as_cpu()
            for i in range(len(gs)):
                np.testing.assert_allclose(gs.at(i), ws.at(i), rtol=0, atol=1e-3)


def _aug_only(device, policy, data):
    from dali_tpu_torch import auto_aug

    aug = getattr(auto_aug, policy)

    @pipeline_def(batch_size=len(data), num_threads=1, seed=42, device=device,
                  enable_conditionals=True)
    def p():
        return aug(fn.external_source(source=lambda: data, batch=True, layout="HWC").gpu())

    pipe = p()
    try:
        return [pipe.run()[0].as_tensor() for _ in range(2)]
    finally:
        pipe.shutdown()


@pytest.mark.parametrize("policy", ["trivial_augment_wide", "auto_augment_image_net"])
def test_auto_augment_on_card_matches_cpu(card, policy):
    """The policy on the same uint8 batch on the card and on the CPU:
    TrivialAugment within one step on at most 1e-3 of values (float
    rounding of the warps and colour matrices), AutoAugment at least 99.9%
    of values bit-equal (a tie flip can move a later posterize by more)."""
    data = np.random.default_rng(5).integers(0, 256, (8, 96, 80, 3)).astype(np.uint8)
    for got, want in zip(_aug_only(card, policy, data), _aug_only("cpu", policy, data)):
        assert got.is_cuda and got.dtype == torch.uint8 and got.is_contiguous()
        d = (got.cpu().to(torch.int32) - want.to(torch.int32)).abs()
        if policy == "trivial_augment_wide":
            assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
        else:
            assert float((d > 0).float().mean()) <= 1e-3


def test_arithmetic_dtypes_on_card_match_cpu(card):
    """The reference's promotion holds on the card: uint8 & int32 literal is
    int32, uint8 * float32 scalar is float32, comparisons are bool."""
    data = np.random.default_rng(1).integers(1, 256, (4, 5, 3)).astype(np.uint8)
    scale = np.float32([0.5, 1.5, 2.0, 3.0])
    outs = []
    for device in (card, "cpu"):
        @pipeline_def(batch_size=4, num_threads=1, seed=1, device=device)
        def p():
            x = fn.external_source(source=lambda: data, batch=True).gpu()
            s = fn.external_source(source=lambda: scale, batch=True)
            return x & 0xF0, x * s, (x > 100) | (s > 1.0), x // 7 - 3 % x
        pipe = p()
        try:
            outs.append([o.as_tensor() for o in pipe.run()])
        finally:
            pipe.shutdown()
    for g, w in zip(*outs):
        assert g.is_cuda and g.dtype == w.dtype
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    assert [o.dtype for o in outs[1]] == [torch.int32, torch.float32, torch.bool, torch.int32]
