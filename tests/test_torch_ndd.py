"""Eager mode (``ndd``) of dali_tpu_torch against dali_tpu's ndd, on the CPU
(``EvalContext(device="cpu")``; dali_tpu's eager device ops run op by op).

Inputs are seeded numpy batches and the committed 32-file JPEG corpus.
Tolerances: uint8 outputs and host ops bit-equal; float outputs within atol
1e-4; outputs behind a uint8 resize within one uint8 step / std with at most
1e-3 of values apart (the resize's rounding ties, as in
``tests/test_torch_pipeline.py``), plus one float16 step in float16 forms.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import dali_tpu
import dali_tpu.experimental.dynamic as ref_ndd
import dali_tpu_torch
import dali_tpu_torch.experimental.dynamic as ndd
from dali_tpu_torch import math as port_math
from dali_tpu import math as ref_math

CORPUS = os.path.join(os.path.dirname(__file__), "..", "dali_tpu_torch", "testdata", "rn50")
MEAN = [0.485 * 255, 0.456 * 255, 0.406 * 255]
STD = [0.229 * 255, 0.224 * 255, 0.225 * 255]
LSB = 1.0 / min(STD) + 1e-4
F16_STEP = 2.0 ** -9
RNG = np.random.default_rng(2024)
IMGS = [RNG.integers(0, 256, (40 + 8 * i, 60 - 5 * i, 3)).astype(np.uint8) for i in range(4)]


def _port_ctx(seed=12345):
    return ndd.EvalContext(seed=seed, device="cpu")


def _np(b):
    """A Batch of either package as a list of host samples."""
    host = b.cpu()
    return [np.asarray(host.at(i)) for i in range(len(host))]


def _exact(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _close(got, want, atol=1e-4):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), atol=atol, rtol=0)


def _behind_resize(got, want, extra=0.0):
    apart = total = 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        d = np.abs(g.astype(np.float64) - w.astype(np.float64))
        assert d.max() <= LSB + extra
        apart, total = apart + int((d > 1e-4 + extra).sum()), total + d.size
    assert apart <= 1e-3 * total


def _resize_ties(got, want):
    """uint8 resize output: one step apart on at most 1e-3 of values."""
    assert len(got) == len(want)
    d = []
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape
        d.append(np.abs(g.astype(int) - w.astype(int)))
    assert max(x.max() for x in d) <= 1
    assert sum(int((x > 0).sum()) for x in d) <= 1e-3 * sum(x.size for x in d)


# -- eager device ops -------------------------------------------------------------------------


def _resize_cmn(m, fp16):
    b = m.as_batch(IMGS, layout="HWC").gpu()
    r = m.resize(b, resize_x=48, resize_y=40)
    form = (dict(dtype=dali_tpu_torch.types.FLOAT16 if m is ndd else dali_tpu.types.FLOAT16,
                 output_layout="HWC", pad_output=True) if fp16 else dict(output_layout="CHW"))
    return r, m.crop_mirror_normalize(r, mean=MEAN, std=STD, crop=(32, 40), **form)


@pytest.mark.parametrize("fp16", [False, True])
def test_eager_resize_cmn_matches_dali_tpu(fp16):
    with _port_ctx():
        r_p, got = _resize_cmn(ndd, fp16)
    with ref_ndd.EvalContext():
        r_w, want = _resize_cmn(ref_ndd, fp16)
    assert got.is_gpu and got.layout == want.layout
    assert got.as_array().device.type == "cpu"
    uint8_r = _np(r_p)
    assert all(s.shape == (40, 48, 3) for s in uint8_r)
    _resize_ties(uint8_r, _np(r_w))
    g, w = _np(got), _np(want)
    assert g[0].shape == ((32, 40, 4) if fp16 else (3, 32, 40))
    _behind_resize(g, w, F16_STEP if fp16 else 0.0)


def test_eager_ops_keep_ragged_extents_and_layouts():
    with _port_ctx():
        b = ndd.as_batch(IMGS, layout="HWC").gpu()
        assert b.as_array().shape == (4, 64, 64, 3)  # the executor's 64 alignment
        t = ndd.transpose(b, perm=[2, 0, 1])
        f = ndd.flip(b, horizontal=1, vertical=1)
        back = b.cpu()
    assert t.layout == "CHW" and [s.shape for s in _np(t)] == [x.transpose(2, 0, 1).shape
                                                                for x in IMGS]
    _exact(_np(f), [x[::-1, ::-1] for x in IMGS])
    _exact(_np(back), IMGS)


def test_eager_mirror_argument_batch_and_gpu_random_raise():
    with _port_ctx(seed=3):
        b = ndd.as_batch(IMGS, layout="HWC").gpu()
        mirror = ndd.random.coin_flip(probability=0.5, batch_size=4)
        got = ndd.crop_mirror_normalize(b, crop=(30, 30), mirror=mirror, mean=MEAN, std=STD)
        # a device random op draws on the device: one value per sample
        u = ndd.random.uniform(b, range=[0.0, 1.0])
        assert u.is_gpu and len(u) == 4
    with ref_ndd.EvalContext(seed=3):
        b = ref_ndd.as_batch(IMGS, layout="HWC").gpu()
        m = ref_ndd.random.coin_flip(probability=0.5, batch_size=4)
        want = ref_ndd.crop_mirror_normalize(b, crop=(30, 30), mirror=m, mean=MEAN, std=STD)
    _exact(_np(mirror), _np(m))
    _close(_np(got), _np(want))


def test_as_batch_of_tensor_and_arrays():
    with _port_ctx():
        t = ndd.as_batch(torch.arange(24, dtype=torch.float32).reshape(2, 3, 4))
        a = ndd.as_batch(np.arange(6).reshape(2, 3))
    assert t.is_gpu and len(t) == 2 and t.at(1).shape == (3, 4)
    assert not a.is_gpu and a.at(1).tolist() == [3, 4, 5]
    with pytest.raises(TypeError):
        ndd.as_batch(3)


# -- arithmetic and math ---------------------------------------------------------------------


def _arith(m, mm, on_gpu):
    x = m.as_batch([np.float32([[1.5, -2.0], [3.0, 0.25]]), np.float32([[4.0, 9.0], [0.5, 2.0]])])
    y = m.as_batch([np.int32([[2, 3], [4, 5]]), np.int32([[1, 0], [7, 2]])])
    if on_gpu:
        x, y = x.gpu(), y
    return [x + y, x * 2 - 1, 3 / x, -x, abs(x), x ** 2, y // 2, y % 3, x < y, x >= 1.5,
            (y & 6) | 1, mm.sqrt(abs(x)), mm.clamp(x, 0.0, 2.5), mm.max(x, y), mm.atan2(x, 2.0),
            np.float32(2.0) * x]


@pytest.mark.parametrize("on_gpu", [False, True])
def test_batch_arithmetic_and_math(on_gpu):
    with _port_ctx():
        got = [_np(b) for b in _arith(ndd, port_math, on_gpu)]
    with ref_ndd.EvalContext():
        want = [_np(b) for b in _arith(ref_ndd, ref_math, on_gpu)]
    for g, w in zip(got, want):
        _close(g, w, atol=1e-6)
    with _port_ctx(), pytest.raises(TypeError, match="Batch"):
        bool(ndd.as_batch([np.float32(1.0)]) > 0)


# -- random ops and readers ---------------------------------------------------------------------


def test_random_uniform_bit_equal_under_eval_context():
    def draws(m, ctx):
        with ctx:
            return [_np(m.random.uniform(batch_size=4, range=[-1.0, 2.0], shape=[3])),
                    _np(m.random.uniform(batch_size=2, range=[0.0, 1.0])),
                    _np(m.random.coin_flip(batch_size=5, probability=0.3))]

    got = draws(ndd, _port_ctx(seed=7))
    for g, w in zip(got, draws(ref_ndd, ref_ndd.EvalContext(seed=7))):
        _exact(g, w)
    for g, w in zip(got, draws(ndd, _port_ctx(seed=7))):
        _exact(g, w)
    assert not np.array_equal(got[0][0], draws(ndd, _port_ctx(seed=8))[0][0])


def _read(m, n=4):
    return m.readers.file(file_root=CORPUS, random_shuffle=True, batch_size=n, name="R", seed=9)


def test_reader_advances_across_calls():
    got, want = [], []
    with _port_ctx(seed=1):
        for _ in range(10):
            got.append([_np(b) for b in _read(ndd)])
    with ref_ndd.EvalContext(seed=1):
        for _ in range(10):
            want.append([_np(b) for b in _read(ref_ndd)])
    for g, w in zip(got, want):
        _exact(g[0], w[0])
        _exact(g[1], w[1])
    labels = [int(s[0]) for batch in got[:8] for s in batch[1]]
    assert sorted(labels) == [0] * 16 + [1] * 16  # 32 files, one epoch in 8 calls
    assert got[0][0][0].tobytes() != got[1][0][0].tobytes()


def test_checkpoint_from_dali_tpu_applies_in_port():
    with ref_ndd.EvalContext(seed=21) as ectx:
        _read(ref_ndd)
        ref_ndd.random.uniform(batch_size=3, range=[0.0, 1.0])
        _read(ref_ndd)
        payload = ref_ndd.Checkpoint.collect(ectx).serialize()
        want_batch = [_np(b) for b in _read(ref_ndd)]
        want_draw = _np(ref_ndd.random.uniform(batch_size=3, range=[0.0, 1.0]))
    with _port_ctx(seed=0) as ectx:
        ndd.Checkpoint.deserialize(payload).apply(ectx)
        assert ectx.seed == 21 and repr(next(iter(ectx._pending_states))).count("readers.File")
        got_batch = [_np(b) for b in _read(ndd)]
        got_draw = _np(ndd.random.uniform(batch_size=3, range=[0.0, 1.0]))
        again = ndd.current_checkpoint()
    for g, w in zip(got_batch, want_batch):
        _exact(g, w)
    _exact(got_draw, want_draw)
    # and the port's own checkpoint restores in dali_tpu
    with ref_ndd.EvalContext(seed=0) as ectx:
        ref_ndd.Checkpoint.deserialize(again.serialize()).apply(ectx)
        nxt = [_np(b) for b in _read(ref_ndd)]
    with _port_ctx(seed=0) as ectx:
        ndd.Checkpoint.deserialize(again.serialize()).apply(ectx)
        _read(ndd)  # the cached reader is created, then the state applies on it
        ndd.Checkpoint.deserialize(again.serialize()).apply(ectx)
        mine = [_np(b) for b in _read(ndd)]
    for g, w in zip(mine, nxt):
        _exact(g, w)


def test_checkpoint_rejects_wrong_version_and_type():
    with _port_ctx():
        with pytest.raises(ValueError, match="version"):
            ndd.Checkpoint({"version": 99}).apply()
        _read(ndd)
        ck = ndd.current_checkpoint()
        key = next(iter(ck.state["ops"]))
        ck.state["ops"][key]["type"] = "OtherReader"
        with pytest.raises(TypeError, match="cannot apply"):
            ck.apply()


# -- capture ------------------------------------------------------------------------------------


def _bench_ndd_frontend(m, types):
    @m.capture
    def frontend(jpegs):
        images = m.decoders.image_random_crop(jpegs, device="mixed", hybrid_device_decode=True,
                                              hybrid_scale=2)
        images = m.resize(images, resize_x=64, resize_y=64)
        mirror = m.random.coin_flip(probability=0.5)
        return m.crop_mirror_normalize(images, mirror=mirror, dtype=types.FLOAT,
                                       output_layout="CHW", mean=MEAN, std=STD)

    return frontend


def _bench_ndd_steps(m, types, ctx, steps=3, batch=8):
    frontend = _bench_ndd_frontend(m, types)
    out = []
    with ctx:
        for _ in range(steps):
            jpegs, labels = m.readers.file(file_root=CORPUS, random_shuffle=True,
                                           batch_size=batch, name="R")
            out.append((_np(frontend(jpegs)), _np(labels)))
    return out, frontend


def test_bench_ndd_captured_frontend_matches_dali_tpu():
    got, frontend = _bench_ndd_steps(ndd, dali_tpu_torch.types, _port_ctx(seed=4))
    want, _ = _bench_ndd_steps(ref_ndd, dali_tpu.types, ref_ndd.EvalContext(seed=4))
    assert list(frontend._captured_pipelines) == [8]
    for (g_img, g_lab), (w_img, w_lab) in zip(got, want):
        _exact(g_lab, w_lab)
        assert g_img[0].shape == (3, 64, 64)
        _behind_resize(g_img, w_img)


def test_capture_one_pipeline_per_batch_size_and_matches_eager():
    @ndd.capture
    def front(x):
        x = ndd.resize(x.gpu(), resize_x=16, resize_y=16)
        return ndd.crop_mirror_normalize(x, mean=[0.0] * 3, std=[1.0] * 3,
                                         dtype=dali_tpu_torch.types.FLOAT, output_layout="CHW")

    with _port_ctx():
        a = front(ndd.as_batch(IMGS, layout="HWC"))
        b = front(ndd.as_batch(IMGS, layout="HWC"))
        c = front(ndd.as_batch(IMGS[:2], layout="HWC"))
        eager = ndd.crop_mirror_normalize(
            ndd.resize(ndd.as_batch(IMGS, layout="HWC").gpu(), resize_x=16, resize_y=16),
            mean=[0.0] * 3, std=[1.0] * 3, dtype=dali_tpu_torch.types.FLOAT,
            output_layout="CHW")
    assert sorted(front._captured_pipelines) == [2, 4]
    assert a.is_gpu and a.layout == "CHW" and len(c) == 2
    _close(_np(a), _np(eager))
    _close(_np(b), _np(eager))
    _close(_np(c), _np(eager)[:2])
    for p in front._captured_pipelines.values():
        p.shutdown()


def test_capture_with_argument_batch_and_host_output():
    @ndd.capture
    def f(x, m):
        y = ndd.crop_mirror_normalize(x.gpu(), mirror=m, mean=MEAN, std=STD, crop=(30, 30))
        return y, ndd.cast(m, dtype=dali_tpu_torch.types.FLOAT)

    with _port_ctx(seed=6):
        m = ndd.random.coin_flip(batch_size=4, probability=0.5)
        x = ndd.as_batch(IMGS, layout="HWC")
        y, mf = f(x, m)
        eager = ndd.crop_mirror_normalize(x.gpu(), mirror=m, mean=MEAN, std=STD, crop=(30, 30))
    assert y.is_gpu and not mf.is_gpu
    _exact(_np(mf), [s.astype(np.float32) for s in _np(m)])
    _close(_np(y), _np(eager))


def test_eager_decoders_do_what_dali_tpu_does():
    with _port_ctx():
        jpegs, _ = _read(ndd)
        with pytest.raises(TypeError, match="hybrid_device_decode"):
            ndd.decoders.image_random_crop(jpegs, device="mixed", hybrid_device_decode=True)
        gif = np.frombuffer(b"GIF89a" + bytes(26), np.uint8)
        for dec in (ndd.decoders.image_random_crop, ndd.decoders.image):
            with pytest.raises(NotImplementedError, match="Queue 1 items 1c-1e"):
                dec(ndd.as_batch([gif, gif]), device="mixed")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ndd.optical_flow
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ndd.readers.video
    with ref_ndd.EvalContext():
        jpegs, _ = _read(ref_ndd)
        with pytest.raises(TypeError, match="hybrid_device_decode"):
            ref_ndd.decoders.image_random_crop(jpegs, device="mixed", hybrid_device_decode=True)


# -- the pad regression and the ndd_vs_fn cases ------------------------------------------------


def test_ndd_pad_gpu_axis_names():
    """Eager Pad resolves its axis_names against the input layout in its
    setup pass (dali_tpu's tests/test_dynamic.py regression)."""
    outs = []
    for m, ctx in ((ndd, _port_ctx()), (ref_ndd, ref_ndd.EvalContext())):
        with ctx:
            a = m.Batch([np.zeros((3, 5), np.float32), np.zeros((4, 2), np.float32)], layout="HW")
            outs.append(_np(m.pad(a.gpu(), axis_names="W", fill_value=7.0)))
    _exact(*outs)
    assert outs[0][0].shape == (3, 5) and outs[0][1].shape == (4, 5)
    assert (outs[0][1][:, 2:] == 7.0).all()


def _cases(types):
    return {
        "flip": lambda m, x: m.flip(x, horizontal=1, vertical=1),
        "resize": lambda m, x: m.resize(x, resize_x=24, resize_y=24,
                                        interp_type=types.INTERP_LINEAR),
        "crop_mirror_normalize": lambda m, x: m.crop_mirror_normalize(
            x, crop=(16, 16), mean=[10.0] * 3, std=[9.0] * 3, dtype=types.FLOAT,
            output_layout="CHW"),
        "gaussian_blur": lambda m, x: m.gaussian_blur(x, sigma=1.1),
        "brightness_contrast": lambda m, x: m.brightness_contrast(x, brightness=1.1,
                                                                  contrast=0.9),
        "color_space_conversion": lambda m, x: m.color_space_conversion(
            x, image_type=types.RGB, output_type=types.GRAY),
        "warp_affine": lambda m, x: m.warp_affine(x, matrix=[1.0, 0.1, 0.0, 0.0, 1.0, 2.0]),
        "rotate": lambda m, x: m.rotate(x, angle=90.0, interp_type=types.INTERP_NN),
        "transpose": lambda m, x: m.transpose(x, perm=[2, 0, 1]),
        "erase": lambda m, x: m.erase(x, anchor=[2.0, 2.0], shape=[5.0, 5.0], axis_names="HW"),
        "cast": lambda m, x: m.cast(x, dtype=types.FLOAT),
        "laplacian": lambda m, x: m.laplacian(x, window_size=3, dtype=types.FLOAT),
    }


def _case_imgs(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (int(rng.integers(20, 40)), int(rng.integers(20, 40)), 3),
                         np.uint8) for _ in range(3)]


@pytest.mark.parametrize("name", sorted(_cases(dali_tpu_torch.types)))
def test_ndd_matches_fn_gpu(name):
    """dali_tpu's ndd_vs_fn cases on the device: the port's ndd against the
    port's fn (same canvas: bit-equal, or 1e-4 for float) and against
    dali_tpu's ndd (uint8 bit-equal but for the resize's one-step ties on at
    most 1e-3 of values, float within 1e-4)."""
    samples = _case_imgs(sum(map(ord, name)))
    port_body = _cases(dali_tpu_torch.types)[name]

    @dali_tpu_torch.pipeline_def(batch_size=3, num_threads=1, seed=7, device="cpu")
    def p():
        x = dali_tpu_torch.fn.external_source(source=lambda: samples, batch=True, cycle=True,
                                              layout="HWC")
        return port_body(dali_tpu_torch.fn, x.gpu())

    pipe = p()
    try:
        via_fn = [np.asarray(s) for s in pipe.run()[0].as_cpu()._samples]
    finally:
        pipe.shutdown()
    with _port_ctx():
        eager = _np(port_body(ndd, ndd.as_batch(samples, layout="HWC").gpu()))
    with ref_ndd.EvalContext():
        ref = _np(_cases(dali_tpu.types)[name](ref_ndd,
                                               ref_ndd.as_batch(samples, layout="HWC").gpu()))
    _close(eager, via_fn, atol=0.0 if eager[0].dtype == np.uint8 else 1e-4)
    if name == "resize":
        _resize_ties(eager, ref)
    else:
        _close(eager, ref, atol=0.0 if eager[0].dtype == np.uint8 else 1e-4)


def test_eval_context_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ndd.EvalContext()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ndd.EvalContext(device="cuda:0")
    with pytest.raises(ValueError, match="unsupported"):
        ndd.EvalContext(device="meta")


def test_ndd_runs_bench_recipe_without_jax():
    """bench.py's bench_ndd recipe through dali_tpu_torch's ndd, changed only
    in its import, in a process that must not import jax or dali_tpu."""
    code = (
        "import sys\n"
        "import dali_tpu_torch.experimental.dynamic as ndd\n"
        "from dali_tpu_torch import types\n"
        f"CORPUS = {CORPUS!r}\n"
        "with ndd.EvalContext(seed=3, device='cpu'):\n"
        "    @ndd.capture\n"
        "    def frontend(jpegs):\n"
        "        images = ndd.decoders.image_random_crop(\n"
        "            jpegs, device='mixed', hybrid_device_decode=True, hybrid_scale=2)\n"
        "        images = ndd.resize(images, resize_x=32, resize_y=32)\n"
        "        mirror = ndd.random.coin_flip(probability=0.5)\n"
        "        return ndd.crop_mirror_normalize(\n"
        "            images, mirror=mirror, dtype=types.FLOAT, output_layout='CHW',\n"
        "            mean=[0.485 * 255, 0.456 * 255, 0.406 * 255],\n"
        "            std=[0.229 * 255, 0.224 * 255, 0.225 * 255])\n"
        "    for _ in range(2):\n"
        "        jpegs, _labels = ndd.readers.file(file_root=CORPUS, random_shuffle=True,\n"
        "                                          batch_size=4, name='R')\n"
        "        out = frontend(jpegs)\n"
        "        assert tuple(out.as_array().shape) == (4, 3, 32, 32)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dali_tpu')]\n"
        "assert not bad, bad\n"
    )
    root = os.path.join(os.path.dirname(__file__), "..")
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=300)
