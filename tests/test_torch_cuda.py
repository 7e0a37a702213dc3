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
recipes (ImageRandomCrop on the host, and the int16 hybrid wire). The mixed
host decoders' device outputs equal the CPU run's bit for bit."""

import os

import numpy as np
import pytest
import torch

from dali_tpu_torch import fn, pipeline_def, types
from dali_tpu_torch.kernels import cmn
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
        cmn.crop_mirror_normalize(*args, out_dtype=torch.int16)
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

    # a GIF signature: a format not ported; a JPEG whose frame is 12-bit
    with pytest.raises(NotImplementedError, match=r"Queue 1 items 1c-1e"):
        run(b"GIF89a" + bytes(26), device="mixed")
    first = open(sorted(os.path.join(r, f) for r, _, fs in os.walk(CORPUS) for f in fs)[0],
                 "rb").read()
    sof = first.index(b"\xff\xc0")
    twelve_bit = first[:sof + 4] + b"\x0c" + first[sof + 5:]
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 1a\), or 12-bit"):
        run(twelve_bit, device="mixed")
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 5h"):
        build(lambda j: fn.random_resized_crop(j, size=[8, 8]))
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
