"""Tests of dali_tpu_torch that need an NVIDIA CUDA card; each skips without
one. This file imports neither jax nor dali_tpu, so it runs on a machine that
has only PyTorch with CUDA:

    python -m pytest -m cuda tests/test_torch_cuda.py

The CMN kernel (csrc/cmn.cu) is held against its plain PyTorch version on the
card in every form it computes (uint8/float16/float32 input, CHW/HWC,
pad_output, the clamped window and the pad policy, mirror on and off, batches
of 1 and of more than 65535 samples): float32 within 1e-5 (one fused
multiply-add versus a multiply then an add), float16 within one
half-precision step at the value's magnitude, since the two float32 values
may round to neighbouring halves. The RN50 path on the card, in its FLOAT CHW
form and its channels-last mixed-precision form (FLOAT16 HWC, pad_output), is
held against the same pipeline on the CPU: labels equal, images within one
uint8 step divided by the smallest std (plus one float16 step in the fp16
form), on a bounded fraction of values (the resize's uint8 rounding may split
a tie differently). The ASR mel front end
on the card is held against the same pipeline on the CPU: equal canvases and
per-sample shapes, dB within 1e-3 dB and normalized values within 1e-3 on
each sample's valid region (cuFFT and the card's matmul against the CPU's).
Automatic augmentation and DataNode arithmetic on the card are held against
the same graphs on the CPU (the stated limits are in each test), and so are
eager mode (ndd: eager resize + CMN, a captured frontend) and a parallel
external source feeding the RN50 device path, within one uint8 step / std,
and so are the ImageNet training recipe (whole-image hybrid decode,
RandomResizedCrop) and the RN50 validation recipe (decode at scale 1,
resize_shorter onto a per-sample canvas, CMN crop), and the host-decode
recipes (ImageRandomCrop on the host, and the int16 hybrid wire), and the
reader-fed recipes (WebDataset shards into the whole-image hybrid decode,
TFRecords into the host decode with CMN to HWC). The mixed host decoders'
device outputs, the mixed Numpy reader's (device="gpu") and decoders.numpy's
equal the CPU run's bit for bit. The device random and noise operators are
held by their distributions (a card's generator does not reproduce a CPU
generator's stream) and leave the global generators untouched; the
rn50_affine_mixup path's host draws and warped images match the CPU run.
The gpu ops on FHWC sequences and DHWC volumes, the colour-twist rounding
ties, the sequence_augment and volume_augment graphs and the GIF fixtures
through the mixed decoders equal the CPU run; the ASR front end on FLAC
equals it on WAV of the same PCM, bit for bit. The DataLoader proxy's
batches and the C API's served outputs on the card match the CPU run's
within one uint8 step / std."""

import os

import numpy as np
import pytest
import torch

import dali_tpu_torch
from dali_tpu_torch import fn, pipeline_def, types
from dali_tpu_torch.kernels import cmn
from dali_tpu_torch.tools import bench_dali_cpu
from dali_tpu_torch.tools.bench_cmn import within_f16_step

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


MEAN4, STD4 = MEAN + [100.0], STD + [50.0]
# (crop_h, crop_w, pad policy fill) on a 40 x 48 canvas; crop_w 33 leaves
# every plane row off the 16-byte grid
KERNEL_WINDOWS = {"clamp": (24, 33, None), "pad": (30, 53, [0.5, -1.0, 2.0, 4.0])}


@pytest.mark.parametrize("window", sorted(KERNEL_WINDOWS))
@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.float16, torch.float32])
@pytest.mark.parametrize("channels,pad_output", [(3, False), (3, True), (1, True), (4, False)])
@pytest.mark.parametrize("layout", ["CHW", "HWC"])
@pytest.mark.parametrize("with_mirror", [True, False])
def test_cuda_kernel_matches_plain_every_form(card, window, in_dtype, channels, pad_output,
                                              layout, with_mirror):
    crop_h, crop_w, fill = KERNEL_WINDOWS[window]
    rng = np.random.default_rng(11)
    n, H, W = 9, 40, 48
    data = torch.from_numpy(rng.random((n, H, W, channels)) * 255).to(in_dtype)
    if fill is None:
        cy = rng.integers(0, H - crop_h + 1, n)
        cx = rng.integers(0, W - crop_w + 1, n)
        cx[-1] = 60  # past the canvas: clamped
    else:
        cy = rng.integers(-12, H - 8, n)
        cx = rng.integers(-30, W - 5, n)
    ext_h = rng.integers(H // 2, H + 1, n)
    ext_w = rng.integers(W // 2, W + 1, n)
    mirror = (np.arange(n) % 3 != 1).astype(np.int32) if with_mirror else None
    dev = [torch.from_numpy(np.asarray(v, np.int32)).to(card) if v is not None else None
           for v in (cy, cx, mirror, ext_h, ext_w)]
    for out_dtype in (torch.float32, torch.float16):
        args = (data.to(card), dev[0], dev[1], dev[2], crop_h, crop_w, MEAN4[:channels],
                STD4[:channels], 1.5, 0.25, layout, out_dtype, pad_output)
        kw = dict(ext_h=dev[3], ext_w=dev[4], fill=None if fill is None else fill[:channels])
        before = cmn.COUNTER.launches
        got = cmn.crop_mirror_normalize(*args, **kw)
        torch.cuda.synchronize()
        assert cmn.COUNTER.launches == before + 1
        want = cmn.crop_mirror_normalize_plain(*args, **kw)
        assert got.is_cuda and got.dtype == out_dtype and got.shape == want.shape
        if out_dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        else:
            assert within_f16_step(got, want), float((got.float() - want.float()).abs().max())


@pytest.mark.parametrize("n,H,W,crop", [(1, 224, 224, (224, 224)), (70000, 6, 7, (4, 5))])
def test_cuda_kernel_batch_edges(card, n, H, W, crop):
    """One sample, and more samples than a grid's y or z dimension holds."""
    g = torch.Generator(device=card).manual_seed(3)
    data = torch.randint(0, 256, (n, H, W, 3), dtype=torch.uint8, device=card, generator=g)
    cy = torch.randint(0, H - crop[0] + 1, (n,), dtype=torch.int32, device=card, generator=g)
    cx = torch.randint(0, W - crop[1] + 1, (n,), dtype=torch.int32, device=card, generator=g)
    mirror = torch.randint(0, 2, (n,), dtype=torch.int32, device=card, generator=g)
    args = (data, cy, cx, mirror, *crop, MEAN, STD)
    got = cmn.crop_mirror_normalize(*args)
    torch.testing.assert_close(got, cmn.crop_mirror_normalize_plain(*args), rtol=0, atol=1e-5)


def test_cuda_kernel_raises_instead_of_falling_back(card):
    data, cy, cx, mirror, ext_w = _case(3)
    args = [torch.from_numpy(x).to(card) for x in (data, cy, cx, mirror)] + [64, 80, MEAN, STD]
    before = cmn.COUNTER.launches
    with pytest.raises(NotImplementedError, match="integer output"):
        cmn.crop_mirror_normalize(*args, out_dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="contiguous"):
        cmn.crop_mirror_normalize(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(NotImplementedError, match="uint8/float16/float32"):
        cmn.crop_mirror_normalize(args[0].to(torch.int16), *args[1:])
    with pytest.raises(NotImplementedError, match="C <= 4"):
        cmn.crop_mirror_normalize(args[0].repeat(1, 1, 1, 2), *args[1:])
    assert cmn.COUNTER.launches == before


def _rn50(device, amp=False):
    @pipeline_def(batch_size=8, num_threads=2, seed=42, device=device)
    def rn50_train():
        jpegs, labels = fn.readers.file(file_root=CORPUS, random_shuffle=True, name="Reader",
                                        seed=1234)
        images = fn.decoders.image_random_crop(jpegs, device="mixed", hybrid_device_decode=True,
                                               hybrid_scale=2, seed=77)
        images = fn.resize(images, resize_x=64, resize_y=64)
        mirror = fn.random.coin_flip(probability=0.5, seed=5)
        form = (dict(dtype=types.FLOAT16, output_layout="HWC", pad_output=True) if amp
                else dict(dtype=types.FLOAT, output_layout="CHW"))
        images = fn.crop_mirror_normalize(images, mirror=mirror, mean=MEAN, std=STD, **form)
        return images, labels

    pipe = rn50_train()
    pipe.build()
    return pipe


def _two_batches(device, amp=False):
    pipe = _rn50(device, amp)
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


def test_rn50_channels_last_amp_on_card_matches_cpu(card):
    """The form channels-last mixed-precision trainers ask for: FLOAT16 HWC
    with the channels padded to 4; one CMN launch per batch."""
    before = cmn.COUNTER.launches
    on_card = _two_batches(card, amp=True)
    assert cmn.COUNTER.launches == before + 2
    on_cpu = _two_batches("cpu", amp=True)
    step = 2.0 ** -9  # one float16 step for 2 <= |x| < 4; these outputs stay within (-3, 3)
    for (g_img, g_lab), (c_img, c_lab) in zip(on_card, on_cpu):
        assert g_img.is_cuda and g_img.dtype == torch.float16
        assert tuple(g_img.shape) == (8, 64, 64, 4) and g_img.is_contiguous()
        np.testing.assert_array_equal(g_lab, c_lab)
        assert not bool(g_img[..., 3].any())  # the padded channel is zero
        diff = (g_img.cpu().float() - c_img.float()).abs()
        assert float(diff.max()) <= LSB + step
        assert float((diff > step).float().mean()) <= MAX_FLIP_FRACTION


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


# -- eager mode (ndd) and the parallel external source ---------------------------------------


def _eager_resize_cmn(device, imgs, flags):
    import dali_tpu_torch.experimental.dynamic as ndd

    with ndd.EvalContext(seed=9, device=device):
        b = ndd.resize(ndd.as_batch(imgs, layout="HWC").gpu(), resize_x=64, resize_y=64)
        mirror = ndd.as_batch(flags)
        return ndd.crop_mirror_normalize(b, mirror=mirror, mean=MEAN, std=STD,
                                         dtype=types.FLOAT, output_layout="CHW").as_array()


def test_eager_resize_cmn_on_card_matches_cpu(card):
    rng = np.random.default_rng(12)
    imgs = [rng.integers(0, 256, (70 + 9 * i, 90 - 7 * i, 3)).astype(np.uint8) for i in range(6)]
    flags = [np.int32([i % 2]) for i in range(6)]
    before = cmn.COUNTER.launches
    got = _eager_resize_cmn(card, imgs, flags)
    assert cmn.COUNTER.launches == before + 1
    want = _eager_resize_cmn("cpu", imgs, flags)
    assert got.is_cuda and got.dtype == torch.float32 and tuple(got.shape) == (6, 3, 64, 64)
    diff = (got.cpu() - want).abs()
    assert float(diff.max()) <= LSB
    assert float((diff > 1e-4).float().mean()) <= MAX_FLIP_FRACTION


def _captured_frontend(device, steps=2):
    import dali_tpu_torch.experimental.dynamic as ndd

    @ndd.capture
    def frontend(jpegs):
        images = ndd.decoders.image_random_crop(jpegs, device="mixed",
                                                hybrid_device_decode=True, hybrid_scale=2)
        images = ndd.resize(images, resize_x=64, resize_y=64)
        mirror = ndd.random.coin_flip(probability=0.5)
        return ndd.crop_mirror_normalize(images, mirror=mirror, dtype=types.FLOAT,
                                         output_layout="CHW", mean=MEAN, std=STD)

    out = []
    with ndd.EvalContext(seed=4, device=device):
        for _ in range(steps):
            jpegs, labels = ndd.readers.file(file_root=CORPUS, random_shuffle=True,
                                             batch_size=8, name="R")
            out.append((frontend(jpegs).as_array(), labels.as_array()))
    for p in frontend._captured_pipelines.values():
        p.shutdown()
    return out


def test_captured_frontend_on_card_matches_cpu(card):
    before = cmn.COUNTER.launches
    on_card = _captured_frontend(card)
    assert cmn.COUNTER.launches == before + 2
    for (g_img, g_lab), (c_img, c_lab) in zip(on_card, _captured_frontend("cpu")):
        assert g_img.is_cuda and tuple(g_img.shape) == (8, 3, 64, 64)
        np.testing.assert_array_equal(g_lab, c_lab)
        diff = (g_img.cpu() - c_img).abs()
        assert float(diff.max()) <= LSB
        assert float((diff > 1e-4).float().mean()) <= MAX_FLIP_FRACTION


class _JpegFiles:
    """A per-sample source over the committed corpus: (JPEG bytes, label)."""

    def __init__(self):
        self.files = sorted(os.path.join(CORPUS, c, f) for c in sorted(os.listdir(CORPUS))
                            for f in sorted(os.listdir(os.path.join(CORPUS, c))))

    def __call__(self, info):
        path = self.files[info.idx_in_epoch % len(self.files)]
        with open(path, "rb") as f:
            data = np.frombuffer(f.read(), np.uint8)
        return data, np.int32([int(os.path.basename(os.path.dirname(path))[len("class"):])])


def _parallel_rn50(device):
    @pipeline_def(batch_size=8, num_threads=2, seed=42, device=device, py_num_workers=2,
                  py_start_method="fork")
    def p():
        jpegs, labels = fn.external_source(source=_JpegFiles(), num_outputs=2, batch=False,
                                           parallel=True)
        images = fn.decoders.image_random_crop(jpegs, device="mixed", hybrid_device_decode=True,
                                               hybrid_scale=2, seed=77)
        images = fn.resize(images, resize_x=64, resize_y=64)
        return fn.crop_mirror_normalize(images, mean=MEAN, std=STD, dtype=types.FLOAT,
                                        output_layout="CHW"), labels

    pipe = p()
    pipe.build()
    try:
        return [(i.as_tensor(), lab.as_array()) for i, lab in (pipe.run() for _ in range(2))]
    finally:
        pipe.shutdown()


def test_parallel_external_source_feeds_card_pipeline(card):
    before = cmn.COUNTER.launches
    on_card = _parallel_rn50(card)
    assert cmn.COUNTER.launches == before + 2
    for (g_img, g_lab), (c_img, c_lab) in zip(on_card, _parallel_rn50("cpu")):
        assert g_img.is_cuda and tuple(g_img.shape) == (8, 3, 64, 64)
        np.testing.assert_array_equal(g_lab, c_lab)
        diff = (g_img.cpu() - c_img).abs()
        assert float(diff.max()) <= LSB
        assert float((diff > 1e-4).float().mean()) <= MAX_FLIP_FRACTION


def test_eager_on_card_raises_without_kernel_library(card, monkeypatch):
    import dali_tpu_torch.experimental.dynamic as ndd
    from dali_tpu_torch.native import build

    def missing():
        raise RuntimeError("kernel library missing")

    monkeypatch.setattr(cmn, "_LIB", None)
    monkeypatch.setattr(build, "kernel_library", missing)
    before = cmn.COUNTER.launches
    with ndd.EvalContext(device=card):
        b = ndd.as_batch(np.zeros((2, 8, 8, 3), np.uint8), layout="HWC").gpu()
        with pytest.raises(RuntimeError, match="kernel library missing"):
            ndd.crop_mirror_normalize(b, mean=MEAN, std=STD)
    assert cmn.COUNTER.launches == before


# -- the ImageNet recipes: whole-image decode, RandomResizedCrop, per-sample Resize -------------


def _imagenet(device, recipe):
    train = recipe == "imagenet_train"

    @pipeline_def(batch_size=8, num_threads=2, seed=42, device=device)
    def p():
        jpegs, labels = fn.readers.file(file_root=CORPUS, random_shuffle=True, name="Reader",
                                        seed=1234)
        images = fn.decoders.image(jpegs, device="mixed", hybrid_device_decode=True,
                                   hybrid_scale=2 if train else 1, hybrid_wire="int8")
        if train:
            resized = fn.random_resized_crop(images, size=[224, 224])
            out = fn.crop_mirror_normalize(resized, mirror=fn.random.coin_flip(probability=0.5),
                                           dtype=types.FLOAT, output_layout="CHW", mean=MEAN,
                                           std=STD)
        else:
            resized = fn.resize(images, resize_shorter=256, interp_type=types.INTERP_TRIANGULAR)
            out = fn.crop_mirror_normalize(resized, crop=(224, 224), dtype=types.FLOAT,
                                           output_layout="CHW", mean=MEAN, std=STD)
        return out, labels, images, resized

    pipe = p()
    pipe.build()
    try:
        return [[o.as_tensor() if i != 1 else o.as_array() for i, o in enumerate(r)] + [
            r[2].shape(), r[3].shape()] for r in (pipe.run() for _ in range(2))]
    finally:
        pipe.shutdown()


@pytest.mark.parametrize("recipe", ["imagenet_train", "rn50_val"])
def test_imagenet_recipes_on_card_match_cpu(card, recipe):
    """One CMN launch per batch; labels and host-known shapes equal; the
    decoded and resized uint8 images within one step on at most 1e-3 of
    values (float evaluation on two devices may split a rounding tie); CMN
    output within one uint8 step / std."""
    before = cmn.COUNTER.launches
    on_card = _imagenet(card, recipe)
    assert cmn.COUNTER.launches == before + 2
    on_cpu = _imagenet("cpu", recipe)
    for (g_img, g_lab, g_dec, g_res, g_dsh, g_rsh), (c_img, c_lab, c_dec, c_res, c_dsh, c_rsh) in zip(
            on_card, on_cpu):
        assert g_img.is_cuda and g_img.dtype == torch.float32
        assert tuple(g_img.shape) == (8, 3, 224, 224)
        np.testing.assert_array_equal(g_lab, c_lab)
        assert g_dsh == c_dsh and g_rsh == c_rsh
        for g, c in ((g_dec, c_dec), (g_res, c_res)):
            assert g.is_cuda and g.dtype == torch.uint8 and g.shape == c.shape
            d = (g.cpu().to(torch.int16) - c.to(torch.int16)).abs()
            assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= MAX_FLIP_FRACTION
        diff = (g_img.cpu() - c_img).abs()
        assert float(diff.max()) <= LSB
        assert float((diff > 1e-4).float().mean()) <= MAX_FLIP_FRACTION


def test_unported_image_paths_raise_on_card(card):
    """What is not ported raises, with the ROADMAP item, rather than falling
    back to another path."""
    def build(make):
        @pipeline_def(batch_size=2, num_threads=1, device=card)
        def p():
            jpegs, _ = fn.readers.file(file_root=CORPUS)
            return make(jpegs)

        p().build()

    def run(data, **kw):
        arr = np.frombuffer(data, np.uint8)

        @pipeline_def(batch_size=2, num_threads=1, device=card)
        def p():
            return fn.decoders.image(fn.external_source(source=lambda: [arr, arr], batch=True), **kw)

        pipe = p()
        pipe.build()
        try:
            pipe.run()
        finally:
            pipe.shutdown()

    # a Radiance HDR header: a format not ported (TIFF, WebP and PNM decode
    # since items 1d-1f); a JPEG whose frame is 12-bit
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 1g"):
        run(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 2 +X 2\n" + bytes(16),
            device="mixed")
    first = open(sorted(os.path.join(r, f) for r, _, fs in os.walk(CORPUS) for f in fs)[0],
                 "rb").read()
    sof = first.index(b"\xff\xc0")
    twelve_bit = first[:sof + 4] + b"\x0c" + first[sof + 5:]
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 1a\), or 12-bit"):
        run(twelve_bit, device="mixed")
    # volumes blur on the card since item 5h.7, as on the CPU
    vols = [np.random.default_rng(2).integers(0, 256, (3, 6, 8, 1), np.uint8)] * 2
    blurred = []
    for device in (card, "cpu"):
        @pipeline_def(batch_size=2, num_threads=1, device=device)
        def blur_volumes():
            return fn.gaussian_blur(fn.external_source(source=lambda: vols, batch=True,
                                                       layout="DHWC").gpu(), window_size=3)

        pipe = blur_volumes()
        pipe.build()
        try:
            blurred.append(pipe.run()[0].as_tensor().cpu())
        finally:
            pipe.shutdown()
    assert torch.equal(*blurred)
    with pytest.raises(NotImplementedError, match="never reads"):
        build(lambda j: fn.resize(fn.decoders.image(j, device="mixed", hybrid_device_decode=True,
                                                    hybrid_wire="int8"),
                                  resize_shorter=8, roi_start=[0.0, 0.0]))


# -- host decode and the int16 wire ------------------------------------------------------------


def _host_decoders(device):
    @pipeline_def(batch_size=8, num_threads=2, seed=42, device=device)
    def p():
        jpegs, labels = fn.readers.file(file_root=CORPUS, random_shuffle=True, name="Reader",
                                        seed=1234)
        return (fn.decoders.image(jpegs, device="mixed"),
                fn.decoders.image_random_crop(jpegs, device="mixed", seed=3,
                                              downscale_shorter_hint=100),
                fn.decoders.image_crop(jpegs, device="mixed", crop=(100, 120)),
                fn.decoders.image_slice(jpegs, device="mixed"),
                fn.decoders.image(jpegs, device="mixed", hybrid_device_decode=True),
                labels)

    pipe = p()
    pipe.build()
    try:
        return [[(o.as_tensor(), o.shape()) for o in r[:5]] for r in (pipe.run() for _ in range(2))]
    finally:
        pipe.shutdown()


def test_host_decoders_and_int16_wire_on_card_match_cpu(card):
    """The mixed host decoders' device outputs are the CPU run's, bit for bit
    (the decode is the same host code; the card only receives it); the int16
    wire, whose IDCT runs on the card, within one uint8 step on at most 1e-3
    of values."""
    for g_run, c_run in zip(_host_decoders(card), _host_decoders("cpu")):
        for k, ((g, g_sh), (c, c_sh)) in enumerate(zip(g_run, c_run)):
            assert g.is_cuda and g.dtype == torch.uint8 and g.shape == c.shape
            assert g_sh == c_sh
            # each sample's valid region (the host decode leaves canvas padding unset)
            g = torch.cat([g[i, :h, :w].reshape(-1).cpu() for i, (h, w, _) in enumerate(g_sh)])
            c = torch.cat([c[i, :h, :w].reshape(-1) for i, (h, w, _) in enumerate(c_sh)])
            if k < 4:
                assert torch.equal(g, c)
            else:
                d = (g.to(torch.int16) - c.to(torch.int16)).abs()
                assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= MAX_FLIP_FRACTION


def _host_recipe(device, recipe, root=CORPUS):
    @pipeline_def(batch_size=16, num_threads=2, seed=42, device=device)
    def p():
        jpegs, labels = fn.readers.file(file_root=root, random_shuffle=True, name="Reader",
                                        seed=1234)
        if recipe == "rn50_host_decode":
            images = fn.decoders.image_random_crop(
                jpegs, device="mixed", output_type=types.RGB, random_area=[0.1, 1.0],
                random_aspect_ratio=[0.8, 1.25], num_attempts=100)
            images = fn.resize(images, resize_x=224, resize_y=224,
                               interp_type=types.INTERP_TRIANGULAR)
        else:
            images = fn.decoders.image(jpegs, device="mixed", hybrid_device_decode=True)
            images = fn.random_resized_crop(images, size=[224, 224])
        out = fn.crop_mirror_normalize(images, mirror=fn.random.coin_flip(probability=0.5),
                                       dtype=types.FLOAT, output_layout="CHW", mean=MEAN, std=STD)
        return out, labels

    pipe = p()
    pipe.build()
    try:
        return [(r[0].as_tensor(), r[1].as_array()) for r in (pipe.run() for _ in range(2))]
    finally:
        pipe.shutdown()


@pytest.mark.parametrize("recipe", ["rn50_host_decode", "proxy_int16_wire"])
def test_host_decode_recipes_on_card_match_cpu(card, recipe):
    """One CMN launch per batch; labels equal; images within one uint8 step /
    std on at most 1e-3 of values."""
    before = cmn.COUNTER.launches
    on_card = _host_recipe(card, recipe)
    assert cmn.COUNTER.launches == before + 2
    for (g_img, g_lab), (c_img, c_lab) in zip(on_card, _host_recipe("cpu", recipe)):
        assert g_img.is_cuda and g_img.dtype == torch.float32
        assert tuple(g_img.shape) == (16, 3, 224, 224)
        np.testing.assert_array_equal(g_lab, c_lab)
        diff = (g_img.cpu() - c_img).abs()
        assert float(diff.max()) <= LSB
        assert float((diff > 1e-4).float().mean()) <= MAX_FLIP_FRACTION


# -- every image form an ImageNet-like corpus holds, decoded on the host ------------------------
CODECS = os.path.join(os.path.dirname(__file__), "..", "dali_tpu_torch", "testdata", "codecs")


def _mixed_root(tmp_path):
    """Five corpus JPEGs and every committed image-form fixture (CMYK, YCCK,
    RGB-colour, 4:1:1 and h=4 JPEGs, partly interleaved scans, a cut
    progressive JPEG, PNGs, BMPs) in one class folder."""
    d = tmp_path / "c"
    d.mkdir()
    files = sorted(os.path.join(CORPUS, c, f) for c in sorted(os.listdir(CORPUS))
                   for f in sorted(os.listdir(os.path.join(CORPUS, c))))[:5]
    for path in files + [os.path.join(CODECS, f) for f in sorted(os.listdir(CODECS))]:
        with open(path, "rb") as src:
            (d / os.path.basename(path)).write_bytes(src.read())
    return str(tmp_path)


def _mixed_decoders(device, root, op):
    @pipeline_def(batch_size=9, num_threads=2, seed=42, device=device)
    def p():
        jpegs, labels = fn.readers.file(file_root=root, random_shuffle=True, name="Reader",
                                        seed=1234)
        if op == "image":
            return fn.decoders.image(jpegs, device="mixed"), labels
        return fn.decoders.image_random_crop(jpegs, device="mixed", seed=3), labels

    pipe = p()
    pipe.build()
    try:
        return [(r[0].as_tensor(), r[0].shape()) for r in (pipe.run() for _ in range(2))]
    finally:
        pipe.shutdown()


@pytest.mark.parametrize("op", ["image", "image_random_crop"])
def test_mixed_forms_host_decode_on_card_matches_cpu(card, tmp_path, op):
    """Batches that mix every form: the mixed decoders' device outputs are the
    CPU run's, bit for bit, in each sample's valid region."""
    root = _mixed_root(tmp_path)
    for (g, g_sh), (c, c_sh) in zip(_mixed_decoders(card, root, op),
                                    _mixed_decoders("cpu", root, op)):
        assert g.is_cuda and g.dtype == torch.uint8 and g_sh == c_sh
        g = torch.cat([g[i, :h, :w].reshape(-1).cpu() for i, (h, w, _) in enumerate(g_sh)])
        c = torch.cat([c[i, :h, :w].reshape(-1) for i, (h, w, _) in enumerate(c_sh)])
        assert torch.equal(g, c)


def test_mixed_forms_rn50_host_decode_on_card_matches_cpu(card, tmp_path):
    """rn50_host_decode over every form: one CMN launch per batch; labels
    equal; images within one uint8 step / std on at most 1e-3 of values."""
    root = _mixed_root(tmp_path)
    before = cmn.COUNTER.launches
    on_card = _host_recipe(card, "rn50_host_decode", root)
    assert cmn.COUNTER.launches == before + 2
    for (g_img, g_lab), (c_img, c_lab) in zip(on_card, _host_recipe("cpu", "rn50_host_decode",
                                                                    root)):
        assert g_img.is_cuda and tuple(g_img.shape) == (16, 3, 224, 224)
        np.testing.assert_array_equal(g_lab, c_lab)
        diff = (g_img.cpu() - c_img).abs()
        assert float(diff.max()) <= LSB
        assert float((diff > 1e-4).float().mean()) <= MAX_FLIP_FRACTION


# ---------------------------------------------------------------- the detection lane

SSD_BATCH = 64


def _ssd_boxes(seed, n=SSD_BATCH):
    """Ragged ltrb boxes in [0, 1] with COCO's count shape (geometric, mean
    ~7.3, at most 50; sample 5 empty) and int32 labels."""
    rng = np.random.default_rng(seed)
    boxes, labels = [], []
    for i in range(n):
        k = 0 if i == 5 else min(50, int(rng.geometric(1 / 7.3)))
        wh = np.exp(rng.uniform(np.log(0.02), np.log(0.9), (k, 2)))
        lt = rng.uniform(0, 1, (k, 2)) * (1 - wh)
        boxes.append(np.concatenate([lt, lt + wh], 1).astype(np.float32))
        labels.append(rng.integers(1, 81, k).astype(np.int32))
    return boxes, labels


def _card_and_host(card, graph):
    """One batch of ``graph`` on the card (host ops run on the host)."""
    @pipeline_def(batch_size=SSD_BATCH, num_threads=2, seed=21, device=card)
    def p():
        return graph()

    pipe = p()
    pipe.build()
    try:
        return pipe.run()
    finally:
        pipe.shutdown()


def test_bb_flip_gpu_matches_cpu(card):
    boxes, _ = _ssd_boxes(1)
    for ltrb in (True, False):
        def graph():
            b = fn.external_source(source=lambda: boxes, batch=True)
            h = fn.random.coin_flip(probability=0.5)
            v = fn.random.coin_flip(probability=0.5)
            return (fn.bb_flip(b.gpu(), ltrb=ltrb, horizontal=h, vertical=v),
                    fn.bb_flip(b, ltrb=ltrb, horizontal=h, vertical=v))

        gpu, cpu = _card_and_host(card, graph)
        assert gpu.as_tensor().is_cuda and gpu.shape() == cpu.shape()
        for i in range(SSD_BATCH):
            np.testing.assert_allclose(gpu.at(i), cpu.at(i), rtol=0, atol=1e-6)


def test_coord_flip_gpu_matches_cpu(card):
    rng = np.random.default_rng(2)
    pts = [rng.uniform(0, 1, (int(rng.integers(0, 40)), 3)).astype(np.float32)
           for _ in range(SSD_BATCH)]

    def graph():
        p = fn.external_source(source=lambda: pts, batch=True)
        fx = fn.random.coin_flip(probability=0.5)
        fz = fn.random.coin_flip(probability=0.5)
        kw = dict(layout="xyz", flip_x=fx, flip_y=1, flip_z=fz, center_x=0.3, center_z=0.7)
        return fn.coord_flip(p.gpu(), **kw), fn.coord_flip(p, **kw)

    gpu, cpu = _card_and_host(card, graph)
    assert gpu.as_tensor().is_cuda
    for i in range(SSD_BATCH):
        np.testing.assert_allclose(gpu.at(i), cpu.at(i), rtol=0, atol=1e-6)


@pytest.mark.parametrize("offset", [False, True])
def test_box_encoder_gpu_matches_cpu(card, offset):
    """SSD300's 8,732 anchors at batch 64: dense [64, 8732, 4] float32 and
    [64, 8732] int32 on the card; labels equal to the host encoder's (or a
    printed tie), boxes within 1e-6 (offset form: 1e-5)."""
    from dali_tpu_torch.tools import bench_ssd

    anchors = bench_ssd.dboxes300_coco()
    boxes, labels = _ssd_boxes(3)
    kw = dict(anchors=anchors.reshape(-1), criteria=0.5)
    if offset:
        kw.update(offset=True, stds=[0.1, 0.1, 0.2, 0.2], scale=1.0)

    def graph():
        b = fn.external_source(source=lambda: boxes, batch=True)
        lab = fn.external_source(source=lambda: labels, batch=True)
        return fn.box_encoder(b.gpu(), lab.gpu(), **kw) + fn.box_encoder(b, lab, **kw)

    gb, gl, cb, cl = _card_and_host(card, graph)
    assert gb.as_tensor().is_cuda and tuple(gb.as_tensor().shape) == (SSD_BATCH, 8732, 4)
    assert gl.as_tensor().dtype == torch.int32 and tuple(gl.as_tensor().shape) == (SSD_BATCH, 8732)
    matched = 0
    for i in range(SSD_BATCH):
        if offset:
            np.testing.assert_array_equal(gl.at(i), cl.at(i))
            np.testing.assert_allclose(gb.at(i), cb.at(i), rtol=0, atol=1e-5)
        else:
            ties = bench_ssd.check_against_cpu_encoder(boxes[i], labels[i], gb.at(i), gl.at(i),
                                                       anchors)
            if ties:
                print(f"sample {i}: ties {ties}")
        matched += int((gl.at(i) > 0).sum())
    assert matched > SSD_BATCH * 5


def test_ssd_recipe_on_card_matches_cpu(card, tmp_path):
    """ssd_train at batch 8 (host encoder): one CMN launch per batch; labels
    and encoded labels equal; images within one uint8 step / std on at most
    1e-3 of values. ssd_device_encode: its device encoder against the host
    encoder on the boxes it received."""
    from dali_tpu_torch.testdata.make_coco_annotations import write_annotations
    from dali_tpu_torch.tools import bench_ssd

    ann = write_annotations(str(tmp_path / "coco.json"), 0)
    anchors = bench_ssd.dboxes300_coco()
    runs = {}
    for device in (card, "cpu"):
        pipe = bench_ssd.make_pipe(ann, 8, device, "ssd_train", with_boxes=True, num_threads=2)
        pipe.build()
        before = cmn.COUNTER.launches
        try:
            runs[str(device)] = [pipe.run() for _ in range(2)]
        finally:
            pipe.shutdown()
        if device == card:
            assert cmn.COUNTER.launches == before + 2
    for got, want in zip(runs[str(card)], runs["cpu"]):
        diff = (got[0].as_tensor().cpu() - want[0].as_tensor()).abs()
        assert float(diff.max()) <= LSB
        assert float((diff > 1e-4).float().mean()) <= MAX_FLIP_FRACTION
        for k in (1, 2, 3, 4):
            for i in range(8):
                np.testing.assert_array_equal(got[k].at(i), want[k].at(i))
    pipe = bench_ssd.make_pipe(ann, 8, card, "ssd_device_encode", with_boxes=True,
                               num_threads=2)
    pipe.build()
    try:
        for _ in range(2):
            images, eb, el, boxes, labels = pipe.run()
            assert eb.as_tensor().is_cuda and bool(torch.isfinite(images.as_tensor()).all())
            for i in range(8):
                bench_ssd.check_against_cpu_encoder(boxes.at(i), labels.at(i), eb.at(i),
                                                    el.at(i), anchors)
    finally:
        pipe.shutdown()


@pytest.mark.parametrize("form", ["ssd_train", "ssd_device_encode"])
def test_ssd_cmn_on_card_matches_plain(card, tmp_path, form):
    """The CMN kernel's output on the batch each SSD form gives it (uint8
    in ssd_train, float32 from brightness_contrast in ssd_device_encode)
    equals the plain version on the same arguments within 1e-5."""
    from dali_tpu_torch.testdata.make_coco_annotations import write_annotations
    from dali_tpu_torch.tools import bench_ssd

    ann = write_annotations(str(tmp_path / "coco.json"), 0)
    pipe = bench_ssd.make_pipe(ann, 8, card, form, num_threads=2)
    pipe.build()
    try:
        with bench_ssd.recording_cmn([]) as calls:
            pipe.run()
    finally:
        pipe.shutdown()
    args = calls[0][0]
    assert args[0].is_cuda and args[0].dtype == (torch.uint8 if form == "ssd_train"
                                                 else torch.float32)
    assert bench_ssd.hold_cmn(calls[0]) <= bench_ssd.CMN_ATOL


def test_resample_matrices_on_card_equal_cpu(card):
    """The interpolation matrices of the resize, built on the card, agree
    with the CPU's: the scale is a correctly rounded quotient on both
    devices, not a product with a reciprocal (which moved the card's
    positions by up to ~2e-5 at the far end of a 300-wide output). Linear
    upscales (two taps) are equal bit for bit; the antialiased downscales
    sum more taps into their norm, in the device's order, so they agree
    within 1e-6."""
    from dali_tpu_torch.kernels import resample
    from dali_tpu_torch.types import DALIInterpType

    roi = torch.tensor([213.0, 150.0, 377.0, 640.0, 97.0, 300.0])
    ext = roi.to(torch.int32)
    for interp in (DALIInterpType.INTERP_LINEAR, DALIInterpType.INTERP_TRIANGULAR):
        for out in (224, 300):
            taps = resample.max_taps(interp, 640 / out, True)
            args = (torch.zeros(6), roi, ext, interp, taps, True, 640)
            want = resample.interp_matrix(out, *args)
            got = resample.interp_matrix(out, *(a.to(card) if torch.is_tensor(a) else a
                                                 for a in args)).cpu()
            assert float((got - want).abs().max()) <= 1e-6, (interp, out)
            up = roi < out
            if interp == DALIInterpType.INTERP_LINEAR:
                assert torch.equal(got[up], want[up]), out


@pytest.mark.parametrize("roi", [False, True], ids=["whole", "roi"])
def test_numpy_reader_on_card_equals_cpu_reader(card, tmp_path, roi):
    """readers.numpy(device="gpu") returns the batch on cuda:0, bit-equal
    to the cpu reader's on the same files and seed (small volumes)."""
    from dali_tpu_torch.testdata.make_reader_datasets import write_npy_volumes

    files = write_npy_volumes(str(tmp_path), 3, (2, 9, 20, 16), seed=1)
    kw = dict(roi_start=[1, 2, 3], roi_shape=[5, 8, 8], roi_axes=[1, 2, 3]) if roi else {}
    outs = {}
    for reader_device in ("gpu", "cpu"):
        @pipeline_def(batch_size=2, num_threads=1, seed=5, device=card)
        def volumes():
            return fn.readers.numpy(files=files, device=reader_device, random_shuffle=True, **kw)

        pipe = volumes()
        pipe.build()
        try:
            outs[reader_device] = [pipe.run()[0] for _ in range(3)]
        finally:
            pipe.shutdown()
    for got, want in zip(outs["gpu"], outs["cpu"]):
        t = got.as_tensor()
        assert t.is_cuda and t.device == torch.device("cuda:0") and t.dtype == torch.float32
        assert torch.equal(t.cpu(), torch.from_numpy(np.stack([want.at(i) for i in range(2)])))


def test_numpy_decoder_mixed_on_card_equals_cpu(card):
    """decoders.numpy(device="mixed") on the card equals the cpu decoder."""
    import io

    rng = np.random.default_rng(2)
    blobs = []
    for a in (rng.standard_normal((3, 5)).astype(np.float32),
              np.asfortranarray(rng.standard_normal((3, 5)).astype(np.float32)),
              rng.standard_normal((3, 5)).astype(">f4")):
        buf = io.BytesIO()
        np.save(buf, a)
        blobs.append(np.frombuffer(buf.getvalue(), np.uint8))

    @pipeline_def(batch_size=3, num_threads=1, seed=5, device=card)
    def decode():
        enc = fn.external_source(source=lambda: blobs, batch=True)
        return fn.decoders.numpy(enc, device="mixed"), fn.decoders.numpy(enc, device="cpu")

    pipe = decode()
    pipe.build()
    try:
        got, want = pipe.run()
    finally:
        pipe.shutdown()
    assert got.as_tensor().is_cuda
    for i in range(3):
        np.testing.assert_array_equal(got.as_cpu().at(i), want.at(i))


@pytest.mark.parametrize("form", ["wds_train", "tfrecord_train"])
def test_reader_recipes_on_card_match_cpu(card, tmp_path, form):
    """wds_train and tfrecord_train (tools/bench_readers.py) at batch 16 on
    the card against the CPU: one CMN launch per batch, labels equal,
    images within one uint8 step / std on at most 1e-3 of values; the CMN
    kernel's output on the path's own batch equals the plain version within
    1e-5."""
    from dali_tpu_torch.tools import bench_readers, bench_ssd

    data = bench_readers.write_datasets(str(tmp_path), samples=64)[form]
    runs = {}
    for device in (card, "cpu"):
        pipe = bench_readers.make_pipe(form, data, 16, device, num_threads=2)
        pipe.build()
        before = cmn.COUNTER.launches
        try:
            runs[str(device)] = [pipe.run() for _ in range(2)]
            if device == card:
                assert cmn.COUNTER.launches == before + 2
                with bench_ssd.recording_cmn([]) as calls:
                    pipe.run()
        finally:
            pipe.shutdown()
    for got, want in zip(runs[str(card)], runs["cpu"]):
        np.testing.assert_array_equal(got[1].as_array(), want[1].as_array())
        diff = (got[0].as_tensor().cpu() - want[0].as_tensor()).abs()
        assert float(diff.max()) <= LSB
        assert float((diff > 1e-4).float().mean()) <= MAX_FLIP_FRACTION
    assert bench_ssd.hold_cmn(calls[0]) <= bench_ssd.CMN_ATOL


def _file_list(tmp_path, n):
    files = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(CORPUS) for f in fs)
    path = tmp_path / "files.txt"
    path.write_text("".join(f"{f} {i % 2}\n" for i, f in enumerate((files * 4)[:n])))
    return str(path)


def test_serialized_rn50_on_card_matches_cpu(card, tmp_path):
    """serialized_rn50 (tools/bench_frontend.py) at batch 16: on the card
    each deserialized batch equals the ops-built source's and the resume
    from the iterator's checkpoints equals the uninterrupted run (one CMN
    launch per batch); then the payload rebuilt on the card and on the CPU:
    labels equal, images within one uint8 step / std on at most 1e-3 of
    values."""
    from dali_tpu_torch import Pipeline
    from dali_tpu_torch.tools import bench_frontend

    files = _file_list(tmp_path, n=128)
    r, launches, pipe = bench_frontend.serialized_rn50(files, 16, 64, card, warmup=1, timed=7)
    payload = pipe.serialize()
    pipe.shutdown()
    assert launches == 8 + pipe.prefetch_queue_depth and r["resumed_equal"] == 3
    runs = []
    for device in (card, "cpu"):
        again = Pipeline.deserialize(payload, device=device)
        again.build()
        try:
            runs.append([(o[0].as_tensor().cpu(), o[1].as_array())
                         for o in (again.run() for _ in range(2))])
        finally:
            again.shutdown()
    for (g_img, g_lab), (c_img, c_lab) in zip(*runs):
        np.testing.assert_array_equal(g_lab, c_lab)
        diff = (g_img - c_img).abs()
        assert float(diff.max()) <= LSB
        assert float((diff > 1e-4).float().mean()) <= MAX_FLIP_FRACTION


def test_shape_relative_trivial_augment_on_card_matches_cpu(card):
    """TrivialAugment Wide with ``shape=`` (effnet_shape_translate's policy):
    its translates read each image's shape on the card; within one step on
    at most 1e-3 of values of the CPU run."""
    from dali_tpu_torch import auto_aug

    data = np.random.default_rng(8).integers(0, 256, (16, 96, 80, 3)).astype(np.uint8)
    outs = []
    for device in (card, "cpu"):
        @pipeline_def(batch_size=16, num_threads=1, seed=42, device=device,
                      enable_conditionals=True)
        def p():
            x = fn.external_source(source=lambda: data, batch=True, layout="HWC").gpu()
            return auto_aug.trivial_augment_wide(x, shape=[96, 80])

        pipe = p()
        pipe.build()
        try:
            assert {"Shapes", "_TensorSubscript"} <= {n.spec.schema_name
                                                     for n in pipe.executor.device_ops}
            outs.append([pipe.run()[0].as_tensor() for _ in range(2)])
        finally:
            pipe.shutdown()
    for got, want in zip(*outs):
        assert got.is_cuda and got.dtype == torch.uint8
        d = (got.cpu().to(torch.int32) - want.to(torch.int32)).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3


def test_volumes_zscore_on_card_matches_cpu(card, tmp_path):
    """volumes_zscore's graph on smaller volumes: windows bit-equal card vs
    CPU, the normalised output within 1e-5 relative."""
    from dali_tpu_torch.testdata.make_reader_datasets import write_npy_volumes
    from dali_tpu_torch.tools import bench_frontend

    files = write_npy_volumes(str(tmp_path), 3, (4, 40, 48, 48), 0)
    assert bench_frontend.check_volumes_against_cpu(files, 2, 2, window=32,
                                                    devices=(card, "cpu")) <= 1e-5


def test_feed_ndarray_into_cuda_tensor(card):
    """A device batch copies into a preallocated CUDA tensor on the card,
    also on a given stream; a host batch copies in from the host."""
    from dali_tpu_torch.plugin.pytorch import feed_ndarray

    data = np.random.default_rng(3).integers(0, 256, (4, 6, 5, 3)).astype(np.uint8)

    @pipeline_def(batch_size=4, num_threads=1, device=card)
    def p():
        x = fn.external_source(source=lambda: data, batch=True, layout="HWC")
        return x, x.gpu()

    pipe = p()
    pipe.build()
    try:
        host, dev = pipe.run()
    finally:
        pipe.shutdown()
    stream = torch.cuda.Stream()
    for tl, s in ((dev, None), (dev, stream), (host, None)):
        arr = torch.empty((4, 6, 5, 3), dtype=torch.uint8, device=card)
        assert feed_ndarray(tl, arr, cuda_stream=s) is arr
        torch.cuda.synchronize()
        np.testing.assert_array_equal(arr.cpu().numpy(), data)


def test_shapes_on_card_read_nothing_back(card, monkeypatch):
    """``Shapes`` and a subscript of it on the card use the shapes the host
    propagated: no device tensor is read back while the pipeline runs."""
    ragged = [np.zeros((10 + 3 * i, 20 - 2 * i, 3), np.uint8) for i in range(4)]
    reads = []
    for name in ("cpu", "numpy", "item", "tolist", "__bool__", "__int__", "__float__",
                 "__index__", "to"):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, _name=name, **k):
            if self.is_cuda and (_name != "to" or any(
                    str(v).startswith("cpu") for v in list(a) + list(k.values()))):
                reads.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, wrapped)

    @pipeline_def(batch_size=4, num_threads=1, device=card)
    def p():
        shape = fn.shapes(fn.external_source(source=lambda: ragged, batch=True,
                                             layout="HWC").gpu())
        return shape, fn.cast(shape, dtype=types.FLOAT)[1]

    pipe = p()
    pipe.build()
    try:
        shape, width = pipe.run()
        assert not reads, reads
    finally:
        pipe.shutdown()
    monkeypatch.undo()
    assert shape.as_tensor().is_cuda and shape.as_tensor().dtype == torch.int64
    np.testing.assert_array_equal(shape.as_tensor().cpu().numpy(), [s.shape for s in ragged])
    np.testing.assert_array_equal(width.as_tensor().cpu().numpy(),
                                  [float(s.shape[1]) for s in ragged])


def _affine_file_list(tmp_path, n=32):
    files = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(CORPUS) for f in fs)
    path = tmp_path / "list.txt"
    path.write_text("".join(f"{f} {i % 2}\n" for i, f in enumerate((files * 2)[:n])))
    return str(path)


def test_affine_mixup_on_card_matches_cpu(card, tmp_path):
    """rn50_affine_mixup at batch 8, 96 px: host draws equal card vs CPU,
    warped images within one step, the device noise by its distribution,
    mixup by its formula, the same seed twice bit-identical on the card."""
    from dali_tpu_torch.tools import bench_affine_mixup

    r = bench_affine_mixup.check_against_cpu(_affine_file_list(tmp_path), batch=8, out=96)
    assert r["warped_max_diff"] <= 1 and r["warped_frac_differing"] <= MAX_FLIP_FRACTION
    assert all(abs(z) <= 3.0 for zs in r["noise_z"] for z in zs)


def test_device_random_draws_keep_the_global_cuda_generator(card):
    torch.cuda.manual_seed(5)
    before = torch.cuda.get_rng_state()
    host_before = torch.random.get_rng_state()

    @pipeline_def(batch_size=4, num_threads=1, seed=3, device="cuda:0")
    def p():
        x = fn.external_source(source=lambda: [np.zeros((8, 8, 3), np.uint8)] * 4,
                               batch=True, layout="HWC").gpu()
        return (fn.random.normal(shape=[16], device="gpu"), fn.noise.gaussian(x, stddev=3.0),
                fn.noise.shot(x, factor=2.0), fn.random.beta(alpha=0.2, beta=0.2, device="gpu"),
                fn.jitter(x))

    pipe = p()
    pipe.build()
    outs = [[o.as_tensor().clone() for o in pipe.run()] for _ in range(2)]
    pipe.shutdown()
    assert all(o.is_cuda for o in outs[0])
    assert torch.equal(torch.cuda.get_rng_state(), before)
    assert torch.equal(torch.random.get_rng_state(), host_before)
    assert not torch.equal(outs[0][0], outs[1][0])


def test_device_random_ops_on_card_by_distribution(card):
    from dali_tpu_torch.tools import bench_affine_mixup

    r = bench_affine_mixup.random_ops(batch=16, shape=(64, 64, 3))
    assert all(v > bench_affine_mixup.KS_P_MIN for k, v in r.items() if k.endswith("_p"))
    assert all(abs(v) <= 3.0 for k, v in r.items() if k.endswith("_z"))


def test_distortion_ops_on_card_match_cpu(card):
    from dali_tpu_torch.tools import bench_affine_mixup

    r = bench_affine_mixup.distortion_ops(batch=6, size=(48, 64))
    assert all(v["max_diff"] <= 1 for v in r.values() if isinstance(v, dict))


def test_custom_operators_with_torch_function_on_card(card):
    from dali_tpu_torch.tools import bench_affine_mixup

    assert bench_affine_mixup.custom_operators()["outputs_checked"] == 4


def test_coord_transform_gpu_on_card_matches_cpu(card):
    rng = np.random.default_rng(4)
    pts = [rng.uniform(-5, 60, (7 - i, 2)).astype(np.float32) for i in range(4)]

    def run(device):
        @pipeline_def(batch_size=4, num_threads=1, seed=3, device=device)
        def p():
            x = fn.external_source(source=lambda: pts, batch=True).gpu()
            return fn.coord_transform(x, M=fn.random.uniform(range=[-1.0, 1.0], shape=[4]),
                                      T=[1.0, -2.0], device="gpu")

        pipe = p()
        pipe.build()
        (out,) = pipe.run()
        pipe.shutdown()
        return [out.at(i) for i in range(4)]

    for g, c in zip(run("cuda:0"), run("cpu")):
        assert g.shape == c.shape
        np.testing.assert_allclose(g, c, rtol=1e-6, atol=1e-5)


def test_device_random_checkpoint_resumes_on_card(card):
    """A checkpoint taken after batch 1 and restored gives the same device
    draws for batches 2 and 3, on the card."""
    def build(**kw):
        @pipeline_def(batch_size=4, num_threads=1, seed=11, device="cuda:0", **kw)
        def p():
            x = fn.external_source(source=lambda: [np.full((8, 8, 3), 100, np.uint8)] * 4,
                                   batch=True, layout="HWC").gpu()
            return (fn.random.uniform(shape=[32], device="gpu"),
                    fn.noise.gaussian(x, stddev=fn.random.uniform(range=[1.0, 4.0],
                                                                  device="gpu")),
                    fn.jitter(x), fn.random.beta(alpha=0.5, beta=0.5, device="gpu"))

        pipe = p()
        pipe.build()
        return pipe

    pipe = build(enable_checkpointing=True)
    pipe.run()
    ckpt = pipe.checkpoint()
    want = [[o.as_tensor().clone() for o in pipe.run()] for _ in range(2)]
    pipe.shutdown()
    again = build(checkpoint=ckpt)
    got = [[o.as_tensor().clone() for o in again.run()] for _ in range(2)]
    again.shutdown()
    for g_it, w_it in zip(got, want):
        assert all(torch.equal(g, w) for g, w in zip(g_it, w_it))
    assert not torch.equal(want[0][0], want[1][0])


# -- the gpu operators of item 5g and the rn50_rcm_jpeg path ---------------------------------

GPU_OP_NAMES = ["experimental.dilate", "experimental.erode", "experimental.median_blur_3",
                "experimental.median_blur_5", "experimental.clahe", "experimental.debayer",
                "experimental.filter_5x5", "experimental.remap",
                "experimental.warp_perspective_nn", "experimental.warp_perspective_linear",
                "multi_paste_2x2", "element_extract", "sequence_rearrange", "per_frame"]


@pytest.mark.parametrize("name", GPU_OP_NAMES)
def test_gpu_op_on_card_matches_cpu(card, name):
    """Each image and sequence operator of item 5g at batch 8 (ragged images,
    4 sequences) on the card against the CPU: bit-equal, or within one step
    on at most 1e-3 of values (Clahe's scan, Filter, the linear warps)."""
    from dali_tpu_torch.tools import bench_rcm_jpeg as b

    graph, inputs, tol = b.image_op_cases(np.random.default_rng(4), 8, (64, 80), True)[name]
    if name in ("element_extract", "sequence_rearrange", "per_frame"):
        inputs = [(a[:4], lay) for a, lay in inputs]
    r = b._compare(b._run_op(graph, inputs, "cuda:0"), b._run_op(graph, inputs, "cpu"), tol,
                   name)
    assert r["max_diff"] <= (0 if tol == "equal" else 1)


def test_gpu_op_outputs_stay_on_card(card):
    @pipeline_def(batch_size=2, num_threads=1, seed=3, device="cuda:0")
    def p():
        x = fn.external_source(source=lambda: [np.zeros((16, 16, 3), np.uint8)] * 2,
                               batch=True, layout="HWC").gpu()
        return (fn.experimental.median_blur(x), fn.jpeg_compression_distortion(x, quality=40),
                fn.fast_resize_crop_mirror(x, resize_x=20, resize_y=20, crop=(8, 8)),
                fn.experimental.clahe(x), fn.tensor_resize(x, scales=[0.5, 0.5], axes=[0, 1]))

    pipe = p()
    pipe.build()
    outs = [o.as_tensor() for o in pipe.run()]
    pipe.shutdown()
    assert all(o.is_cuda for o in outs)


def test_filter_unserved_argument_raises_on_card(card):
    @pipeline_def(batch_size=2, num_threads=1, seed=3, device="cuda:0")
    def p():
        x = fn.external_source(source=lambda: [np.zeros((16, 16, 3), np.uint8)] * 2,
                               batch=True, layout="HWC").gpu()
        k = fn.external_source(source=lambda: [np.ones((3, 3), np.float32)] * 2, batch=True)
        return fn.experimental.filter(x, k.gpu(), border="constant")

    with pytest.raises(NotImplementedError, match="Queue 3"):
        p().build()


def test_jpeg_compression_distortion_on_card_matches_cpu(card):
    """At a quality per sample on ragged images: at most 1e-3 of the 8x8
    blocks differ card vs CPU."""
    from dali_tpu_torch.tools import bench_rcm_jpeg as b

    rng = np.random.default_rng(6)
    imgs = [rng.integers(0, 256, (96 - 8 * i, 112 - 16 * i, 3), np.uint8) for i in range(4)]
    q = rng.uniform(20, 95, (4,)).astype(np.float32)
    graph = lambda fn, t, x, qq: fn.jpeg_compression_distortion(x, quality=qq)  # noqa: E731
    inputs = [(imgs, "HWC"), (q, "")]
    card_out = b._run_op(graph, inputs, "cuda:0")
    cpu_out = b._run_op(graph, inputs, "cpu")
    share, _ = b.block_diff((g.numpy(), c.numpy()) for g, c in zip(card_out[0], cpu_out[0]))
    assert share <= b.BLOCK_SHARE_MAX


def test_rn50_rcm_jpeg_on_card_matches_cpu(card, tmp_path):
    """The path at batch 16 on the card against the CPU: labels and host
    draws equal, resized images within one step, the JPEG block bound, the
    normalised images within one step / std where the distorted ones agree."""
    from dali_tpu_torch.tools import bench_rcm_jpeg

    r = bench_rcm_jpeg.check_against_cpu(_affine_file_list(tmp_path, 32), batch=16)
    assert r["resized_max_diff"] <= 1 and r["jpeg_block_share"] <= 1e-3


# ------------------------------------------------------------------ CMN's forms of item 4

INT_OUTPUTS = [torch.uint8, torch.int8, torch.int16, torch.int32]


@pytest.mark.parametrize("window", sorted(KERNEL_WINDOWS))
@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.float16, torch.float32])
@pytest.mark.parametrize("out_dtype", INT_OUTPUTS)
@pytest.mark.parametrize("layout,channels,pad_output", [("CHW", 3, False), ("HWC", 4, False),
                                                        ("HWC", 3, True), ("CHW", 1, True)])
def test_cuda_kernel_integer_outputs_equal_plain(card, window, in_dtype, out_dtype, layout,
                                                 channels, pad_output):
    """The saturating integer stores: x * a + b spans past every type's range
    (float input adds infinities, NaN and +-3e9); the kernel equals its plain
    version exactly."""
    crop_h, crop_w, fill = KERNEL_WINDOWS[window]
    rng = np.random.default_rng(5)
    n, H, W = 9, 40, 48
    vals = rng.random((n, H, W, channels)) * 255
    if in_dtype != torch.uint8:
        vals[0, :2] = rng.uniform(-3e4, 3e4, (2, W, channels))
        vals[1, 0, :4, 0] = [np.nan, np.inf, -np.inf, 60000.0]
    data = torch.from_numpy(vals).to(in_dtype).to(card)
    if fill is None:
        cy, cx = rng.integers(0, H - crop_h + 1, n), rng.integers(0, W - crop_w + 1, n)
    else:
        cy, cx = rng.integers(-12, H - 8, n), rng.integers(-30, W - 5, n)
    dev = [torch.from_numpy(np.asarray(v, np.int32)).to(card)
           for v in (cy, cx, np.arange(n) % 2, rng.integers(H // 2, H + 1, n),
                     rng.integers(W // 2, W + 1, n))]
    for scale in (1.0, 3e5):  # 3e5 sends uint8 input past int32 too
        args = (data, dev[0], dev[1], dev[2], crop_h, crop_w, [64.0] * channels,
                [0.01] * channels, scale, 0.5, layout, out_dtype, pad_output)
        kw = dict(ext_h=dev[3], ext_w=dev[4],
                  fill=None if fill is None else [300.7, -1.5, 2.0, -40000.0][:channels])
        before = cmn.COUNTER.launches
        got = cmn.crop_mirror_normalize(*args, **kw)
        torch.cuda.synchronize()
        assert cmn.COUNTER.launches == before + 1
        want = cmn.crop_mirror_normalize_plain(*args, **kw)
        assert got.dtype == out_dtype and got.shape == want.shape
        assert torch.equal(got, want), int((got.long() - want.long()).abs().max())


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float16, torch.int16])
def test_cuda_kernel_src_index_reads_in_place(card, out_dtype):
    """Output sample i reads input sample src_index[i]: a depth window
    folded into the batch, held against the plain version."""
    g = torch.Generator(device=card).manual_seed(3)
    vols = torch.rand((3 * 10, 20, 24, 2), device=card, generator=g) * 200
    src = (torch.tensor([0, 14, 22], device=card)[:, None]
           + torch.arange(6, device=card)).reshape(-1).to(torch.int32)
    n = src.numel()
    cy = torch.full((n,), 2, dtype=torch.int32, device=card)
    mirror = (torch.arange(n, device=card) % 2).to(torch.int32)
    args = (vols, cy, cy * 3, mirror, 16, 16, [50.0, 60.0], [30.0, 20.0], 1.0, 0.0, "CHW",
            out_dtype)
    got = cmn.crop_mirror_normalize(*args, src_index=src)
    want = cmn.crop_mirror_normalize_plain(*args, src_index=src)
    assert tuple(got.shape) == (n, 2, 16, 16)
    if out_dtype == torch.float16:
        assert within_f16_step(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 if out_dtype.is_floating_point
                                   else 0)


def _cmn_fold_pipe(device, data, layout, **kw):
    @pipeline_def(batch_size=len(data), num_threads=1, seed=4, device=device)
    def p():
        x = fn.external_source(source=lambda: data, batch=True, layout=layout).gpu()
        m = fn.random.coin_flip(probability=0.5, seed=9)
        return fn.crop_mirror_normalize(x, mirror=m, mean=[60.0], std=[30.0], **kw)

    pipe = p()
    pipe.build()
    try:
        out = pipe.run()[0]
        return out.as_tensor().cpu(), out.layout()
    finally:
        pipe.shutdown()


@pytest.mark.parametrize("layout,kw", [
    ("DHWC", dict(crop=(16, 20), crop_d=5, crop_pos_z=0.7, output_layout="CHW")),
    ("DHWC", dict(crop=(12, 12), crop_d=3, dtype=types.UINT8, output_layout="HWC")),
    ("FHWC", dict(crop=(18, 22), output_layout="FCHW", dtype=types.FLOAT16)),
], ids=["dchw", "dhwc_uint8", "fchw_float16"])
def test_cmn_volume_and_sequence_folds_on_card_match_cpu(card, layout, kw):
    rng = np.random.default_rng(8)
    lead = 9 if layout == "DHWC" else 4
    data = [rng.integers(0, 256, (lead, 24, 28, 3)).astype(np.uint8) for _ in range(5)]
    got, g_lay = _cmn_fold_pipe("cuda:0", data, layout, **kw)
    want, w_lay = _cmn_fold_pipe("cpu", data, layout, **kw)
    assert g_lay == w_lay and got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.float16:
        assert within_f16_step(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 if got.is_floating_point()
                                   else 0)


def test_audio_resample_on_card_matches_cpu(card):
    """The device sinc resample, per-sample rates, mono and stereo: card vs
    CPU within 1e-5 of each clip's peak."""
    rng = np.random.default_rng(6)
    clips = [rng.uniform(-0.9, 0.9, (n,) + ch).astype(np.float32)
             for n, ch in ((48000, ()), (30001, ()), (22050, ()), (9000, ()))]
    rates = [np.float32(r) for r in (48000, 44100, 22050, 16000)]
    outs = {}
    for device in ("cuda:0", "cpu"):
        @pipeline_def(batch_size=4, num_threads=1, seed=2, device=device)
        def p():
            x = fn.external_source(source=lambda: clips, batch=True).gpu()
            r = fn.external_source(source=lambda: rates, batch=True)
            return fn.experimental.audio_resample(x, in_rate=r, out_rate=16000.0, quality=90.0)

        pipe = p()
        pipe.build()
        try:
            out = pipe.run()[0]
            outs[device] = [np.asarray(out.as_cpu().at(i)) for i in range(4)]
        finally:
            pipe.shutdown()
    for g, c in zip(outs["cuda:0"], outs["cpu"]):
        assert g.shape == c.shape
        assert float(np.abs(g - c).max()) <= 1e-5 * float(np.abs(c).max())


def test_rn50_dali_cpu_on_card_cmn_placements_agree(card, tmp_path):
    """The --dali-cpu recipe at batch 16: CMN on the card against CMN on the
    host before .gpu(), labels equal, images within 1e-5."""
    from dali_tpu_torch.tools import bench_dali_cpu

    r = bench_dali_cpu.check_rn50_dali_cpu(_affine_file_list(tmp_path, 32), batch=16)
    assert r["max_abs_diff"] <= bench_dali_cpu.CMN_ATOL


def test_asr_resample_on_card_matches_cpu(card, tmp_path):
    from dali_tpu_torch.testdata.make_audio_corpus import write_corpus
    from dali_tpu_torch.tools import bench_dali_cpu

    root = write_corpus(str(tmp_path), 8, 5, (1.0, 2.5), rate=48000)
    r = bench_dali_cpu.check_asr_resample(root, batch=4)
    assert r["resampled_rel_to_peak"] <= bench_dali_cpu.RESAMPLE_RTOL


@pytest.mark.parametrize("name", sorted(bench_dali_cpu.PLACEMENT_BOUNDS))
def test_host_filter_placements_agree_on_card(card, name):
    """Each op with a host and a gpu placement on one ragged batch: the host
    output against the card's, within the bound the CPU tests hold both
    packages' placements to (``bench_dali_cpu.PLACEMENT_BOUNDS``)."""
    from dali_tpu_torch.tools import bench_dali_cpu

    pairs = bench_dali_cpu.placement_pairs(dali_tpu_torch, card, batch=8, hw=(96, 120),
                                           names=[name])
    bench_dali_cpu.check_placements(pairs)


def test_rn50_host_augment_on_card_cmn_placements_agree(card, tmp_path):
    """The --dali-cpu recipe with the host JPEG, blur and equalize at batch
    16: CMN on the card against CMN on the host, labels equal, images within
    1e-5."""
    from dali_tpu_torch.tools import bench_dali_cpu

    r = bench_dali_cpu.check_rn50_dali_cpu(_affine_file_list(tmp_path, 32), batch=16,
                                           augment=True)
    assert r["max_abs_diff"] <= bench_dali_cpu.CMN_ATOL


# -- item 5h.7, F2, FLAC and GIF on the card -------------------------------------------------------

SEQ_VOLUME_OPS = {
    "warp_affine": lambda x, lay: fn.warp_affine(
        x, matrix=[0.9, 0.2, 1.0, -0.1, 1.1, 0.5] if lay == "FHWC"
        else [0.9, 0.1, 0.05, 0.5, -0.1, 1.05, 0.1, 0.2, 0.05, -0.1, 0.95, 0.3]),
    "rotate": lambda x, lay: fn.rotate(x, angle=15.0, axis=[0.3, 0.5, 1.0]),
    "gaussian_blur": lambda x, lay: fn.gaussian_blur(
        x, sigma=[0.8, 1.2, 1.6] if lay == "DHWC" else 1.1),
    "equalize": lambda x, lay: fn.experimental.equalize(x),
}


def _seq_volume_run(device, name, layout, data):
    @pipeline_def(batch_size=len(data), num_threads=1, seed=3, device=device)
    def p():
        x = fn.external_source(source=lambda: data, batch=True, layout=layout).gpu()
        return SEQ_VOLUME_OPS[name](x, layout)

    pipe = p()
    pipe.build()
    try:
        out = pipe.run()[0]
        return [torch.as_tensor(np.asarray(out.as_cpu().at(i))) for i in range(len(data))]
    finally:
        pipe.shutdown()


# Equalize(gpu) takes uniform sequences and volumes only, as dali_tpu's does
SEQ_VOLUME_CASES = [(name, layout, ragged) for name in sorted(SEQ_VOLUME_OPS)
                    for layout in ("FHWC", "DHWC") for ragged in (False, True)
                    if not (name == "equalize" and ragged)]


@pytest.mark.parametrize("name,layout,ragged", SEQ_VOLUME_CASES,
                         ids=[f"{n}-{lay}-{'ragged' if r else 'uniform'}"
                              for n, lay, r in SEQ_VOLUME_CASES])
def test_sequence_and_volume_ops_on_card_match_cpu(card, name, layout, ragged):
    """Item 5h.7's gpu ops on sequences and volumes, uint8, batch 3: the card
    equal to the CPU."""
    rng = np.random.default_rng(9)
    data = [rng.integers(0, 256, (4 + (i if ragged else 0), 40 + (3 * i if ragged else 0),
                                  48, 3), np.uint8) for i in range(3)]
    got, want = (_seq_volume_run(d, name, layout, data) for d in (card, "cpu"))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.uint8
        assert torch.equal(g, w), name


def test_color_twist_ties_on_card_equal_cpu(card):
    """ColorTwist at brightness 0.9 and Hsv at value 0.9 (rounding ties summed
    in XLA-CPU's order: fused multiply-adds, ``torch.addcmul`` on the card and
    emulated in float64 on the CPU): the card equal to the CPU."""
    from dali_tpu_torch.tools import bench_rcm_jpeg as b

    for name in ("color_twist_brightness_0.9", "hsv_value_0.9"):
        graph, inputs, tol = b.image_op_cases(np.random.default_rng(4), 8, (64, 80), True)[name]
        r = b._compare(b._run_op(graph, inputs, "cuda:0"), b._run_op(graph, inputs, "cpu"), tol,
                       name)
        assert tol == "equal" and r["max_diff"] == 0


def test_colour_products_on_card_equal_cpu(card):
    """``kernels/pointwise.py``'s sums of products round once per term on
    both devices (``torch.addcmul`` on the card, a float64 emulation on the
    CPU): the per-pixel product of a batch of 16 and of one image, and the
    hue product at 64 and 256 matrices (whole tiles of 8 rows summed
    unfused), bit-equal."""
    from dali_tpu_torch.kernels import pointwise as pw

    g = torch.Generator().manual_seed(3)
    for n in (16, 1):
        x = torch.randint(0, 256, (n, 60, 250, 3), generator=g).to(torch.float32)
        m = torch.randn((n, 3, 3), generator=g)
        want = pw.apply_color_matrices(x, m)
        assert torch.equal(pw.apply_color_matrices(x.to(card), m.to(card)).cpu(), want)
    b = torch.randn((3, 3), generator=g)
    for n in (64, 256):
        a = torch.randn((n, 3, 3), generator=g)
        assert torch.equal(pw._xla_dot(a.to(card), b.to(card)).cpu(), pw._xla_dot(a, b))
        assert torch.equal(pw._matmul3(b.to(card), a.to(card)).cpu(), pw._matmul3(b, a))


def test_sequence_augment_on_card_matches_cpu(card, tmp_path):
    """chip_smoke.py's sequence_augment graph at batch 2 on 4 frames of 64x64:
    each uint8 stage within one step on at most 1e-3 of values, the FCHW
    output within one uint8 step / std (tools/bench_seq_volumes.py)."""
    from dali_tpu_torch.tools import bench_seq_volumes as bsv

    root = bsv.ensure_sequence_corpus(str(tmp_path / "seqs"), frames=4, size=64)
    r = bsv.check_sequences(root, frames=4, size=64)
    assert r["equalize"]["max_diff"] <= 1


def test_volume_augment_on_card_matches_cpu(card, tmp_path):
    """chip_smoke.py's volume_augment graph (numpy reader on the card,
    transpose, blur, rotation about a random axis) on 24^3 windows of three
    [4, 30, 40, 36] float32 volumes: card vs CPU within 1e-5."""
    from dali_tpu_torch.testdata.make_reader_datasets import write_npy_volumes
    from dali_tpu_torch.tools import bench_seq_volumes as bsv

    files = write_npy_volumes(str(tmp_path / "vols"), 3, (4, 30, 40, 36), 1)
    r = bsv.check_volumes(files, roi_shape=[24, 24, 24], volume=(4, 30, 40, 36))
    assert r["max_abs_diff"] <= bsv.VOLUME_ATOL


def test_asr_frontend_on_flac_equals_wav_on_card(card, tmp_path):
    """asr_frontend at batch 4 on the card: a FLAC corpus gives the dB mel of
    the WAV corpus of the same PCM, bit for bit."""
    from dali_tpu_torch.testdata.make_audio_corpus import write_corpus

    roots = {ext: write_corpus(str(tmp_path / ext), 8, 5, (0.5, 1.25), fmt=ext)
             for ext in ("wav", "flac")}
    outs = {}
    for ext, root in roots.items():
        @pipeline_def(batch_size=4, num_threads=2, seed=7, device=card)
        def asr():
            enc, _ = fn.readers.file(file_root=root, file_filters=[f"*.{ext}"], name="R")
            audio, _ = fn.decoders.audio(enc, dtype=types.FLOAT, downmix=True, device="mixed")
            spec = fn.spectrogram(fn.preemphasis_filter(audio), nfft=512, window_length=320,
                                  window_step=160)
            return fn.to_decibels(fn.mel_filter_bank(spec, sample_rate=16000.0, nfilter=80))

        pipe = asr()
        pipe.build()
        try:
            outs[ext] = [pipe.run()[0].as_tensor().cpu() for _ in range(2)]
        finally:
            pipe.shutdown()
    for g, w in zip(outs["flac"], outs["wav"]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("decoder", ["image", "image_random_crop"])
def test_gif_fixtures_mixed_decode_on_card_match_cpu(card, tmp_path, decoder):
    """The GIF fixtures through the mixed decoders on the card, equal to the
    same pipeline on the CPU."""
    import shutil

    codecs = os.path.join(os.path.dirname(CORPUS), "codecs")
    os.makedirs(tmp_path / "c")
    for name in sorted(os.listdir(codecs)):
        if name.endswith(".gif"):
            shutil.copy(os.path.join(codecs, name), tmp_path / "c" / name)
    outs = []
    for device in (card, "cpu"):
        @pipeline_def(batch_size=5, num_threads=2, seed=5, device=device)
        def p():
            gifs, _ = fn.readers.file(file_root=str(tmp_path), file_filters=["*.gif"], name="R")
            return getattr(fn.decoders, decoder)(gifs, device="mixed")

        pipe = p()
        pipe.build()
        try:
            out = pipe.run()[0]
            outs.append([torch.as_tensor(np.asarray(out.as_cpu().at(i))) for i in range(5)])
        finally:
            pipe.shutdown()
    for g, w in zip(*outs):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("decoder", ["image", "image_random_crop"])
def test_webp_tiff_pnm_fixtures_mixed_decode_on_card_match_cpu(card, tmp_path, decoder):
    """The WebP, TIFF and PNM fixtures through the mixed decoders on the
    card (one native batch call on the task pool), equal to the same
    pipeline on the CPU."""
    import shutil

    codecs = os.path.join(os.path.dirname(CORPUS), "codecs")
    os.makedirs(tmp_path / "c")
    names = [n for n in sorted(os.listdir(codecs)) if n.endswith((".webp", ".tif", ".ppm"))]
    for name in names:
        shutil.copy(os.path.join(codecs, name), tmp_path / "c" / name)
    outs = []
    for device in (card, "cpu"):
        @pipeline_def(batch_size=len(names), num_threads=2, seed=5, device=device)
        def p():
            data, _ = fn.readers.file(file_root=str(tmp_path), name="R")
            return getattr(fn.decoders, decoder)(data, device="mixed")

        pipe = p()
        pipe.build()
        try:
            out = pipe.run()[0]
            outs.append([torch.as_tensor(np.asarray(out.as_cpu().at(i)))
                         for i in range(len(names))])
        finally:
            pipe.shutdown()
    for g, w in zip(*outs):
        assert g.shape == w.shape and torch.equal(g, w)


def test_dataloader_proxy_on_card_matches_cpu(card):
    """rn50_dataloader_proxy at batch 8, two batches from forked workers:
    device tensors on the card, labels equal to the CPU run's, images within
    one uint8 step / std on a bounded fraction of values."""
    from dali_tpu_torch.tools import bench_plugins

    got = bench_plugins.proxy_batches(8, card, 2, workers=2)
    want = bench_plugins.proxy_batches(8, torch.device("cpu"), 2, workers=2)
    for (gi, gl), (ci, cl) in zip(got, want):
        assert gi.is_cuda and torch.equal(gl, cl)
        d = (gi.cpu() - ci).abs()
        assert float(d.max()) <= LSB and float((d > 1e-4).float().mean()) <= MAX_FLIP_FRACTION


def test_capi_serve_on_card_matches_cpu(card, tmp_path):
    """The serving document through the C API (ctypes, in this process) on
    the card, as written, and on the CPU (``"device": "cpu"`` in its
    params): the same output shapes, values within one uint8 step / std on
    a bounded fraction of values."""
    import json

    from dali_tpu_torch.capi import build as capi_build
    from dali_tpu_torch.tools import bench_plugins

    model = bench_plugins.write_model(8, repo=str(tmp_path / "repo"))
    doc = json.load(open(model))
    doc["params"]["device"] = "cpu"
    cpu_model = str(tmp_path / "cpu.dali")
    json.dump(doc, open(cpu_model, "w"))
    lib = capi_build.build(str(tmp_path / "lib"))
    outs = []
    for m in (model, cpu_model):
        server = bench_plugins.CapiServer(lib, m)
        bufs = server.serve(bench_plugins.serve_inputs(8, 0))
        outs.append([b.copy().view(np.float32) for b in bufs])
        server.close()
    (g,), (c,) = outs
    assert g.shape == c.shape == (8, 3 * 224 * 224)
    d = np.abs(g - c)
    assert d.max() <= LSB and (d > 1e-4).mean() <= MAX_FLIP_FRACTION


def test_audio_codec_fixtures_on_the_card_machine(card):
    """Every committed MP3 and Vorbis fixture decoded by this machine's build
    of the host library, against reference.npz (dali_tpu's FFmpeg decode,
    written on a machine that has FFmpeg): the same lengths, channels and
    rates, within the full-accuracy bounds of ISO/IEC 11172-4."""
    from dali_tpu_torch.tools import bench_audio_codecs

    r = bench_audio_codecs.check_fixtures()
    assert r["fixtures"]["mp3"] >= 20 and r["fixtures"]["vorbis"] >= 7
    assert r["worst"]["max_abs"] <= bench_audio_codecs.MAX_BOUND


@pytest.mark.parametrize("corpus,ext", [("mp3", "mp3"), ("vorbis", "ogg")])
def test_asr_resample_on_mp3_and_vorbis_matches_cpu(card, corpus, ext):
    """asr_resample's graph over the committed MP3 and Vorbis clips (the
    host decode, the card's resample and mel) against the CPU port, within
    asr_resample's card-vs-CPU contract."""
    from dali_tpu_torch.tools import bench_audio_codecs

    root = {"mp3": bench_audio_codecs.MP3_CORPUS, "vorbis": bench_audio_codecs.VORBIS_CORPUS}
    r = bench_dali_cpu.check_asr_resample(root[corpus], batch=4, ext=ext)
    assert r["resampled_rel_to_peak"] <= bench_dali_cpu.RESAMPLE_RTOL
    assert r["db_max_diff"] <= bench_dali_cpu.DB_ATOL
