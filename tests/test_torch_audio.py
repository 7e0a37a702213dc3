"""The ASR mel front end in both packages on the CPU: each ported module of
the audio path against its ``dali_tpu`` counterpart, then bench.py's
``asr_frontend`` end to end on ragged clips at the bench's widths.

Inputs come from ``np.random.default_rng``; the reference runs on JAX-CPU,
the port on torch-CPU. Tolerances, per case:

* WAV decode, the mixed decode split, ``pad_and_stack`` and the boundary
  canvas, framing, the mel and DCT matrices: bit-equal (the same numpy code,
  or pure gathers);
* preemphasis: 1e-6 (one multiply and one subtract in float32);
* spectrogram: 1e-5 of each sample's max (two float32 FFT implementations);
* Normalize on the device: 1e-4 (float32 moments summed in another order);
* the whole front end: dB within 1e-3 dB and normalized values within 1e-3
  on each sample's valid region (the maxima measured are in PERF.md).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dali_tpu
import dali_tpu_torch
from dali_tpu import batch as ref_batch
from dali_tpu import tensors as ref_tensors
from dali_tpu.backend import audio as ref_audio
from dali_tpu.backend import base as ref_base
from dali_tpu.kernels import signal as ref_sig
from dali_tpu_torch import batch as port_batch
from dali_tpu_torch import tensors as port_tensors
from dali_tpu_torch.backend import audio as port_audio
from dali_tpu_torch.backend import base as port_base
from dali_tpu_torch.kernels import signal as port_sig
from dali_tpu_torch.testdata.make_audio_corpus import speech_clip, to_int16, wav_bytes, write_corpus

RATE = 16000


# ------------------------------------------------------------------ WAV decode

def _wav_case(kind, rng, n=1000):
    x = rng.uniform(-1, 1, (n, 2) if kind == "stereo16" else n).astype(np.float32)
    if kind in ("pcm16", "stereo16"):
        return wav_bytes(to_int16(x).tobytes(), channels=x.ndim, bits=16)
    if kind == "pcm8":
        return wav_bytes(rng.integers(0, 256, n, dtype=np.uint8).tobytes(), bits=8)
    if kind == "pcm24":
        v = rng.integers(-(1 << 23), 1 << 23, n).astype(np.int32)
        b = np.stack([v & 255, (v >> 8) & 255, (v >> 16) & 255], 1).astype(np.uint8)
        return wav_bytes(b.tobytes(), bits=24)
    if kind == "pcm32":
        return wav_bytes(rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32)
                         .tobytes(), bits=32)
    return wav_bytes(x.tobytes(), bits=32, fmt_tag=3)


@pytest.mark.parametrize("kind", ["pcm8", "pcm16", "pcm24", "pcm32", "float32", "stereo16"])
def test_decode_wav_bit_equal(kind):
    data = _wav_case(kind, np.random.default_rng(11))
    got, rate = port_audio.decode_wav(data)
    want, want_rate = ref_audio.decode_wav(data)
    assert rate == want_rate == RATE and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_compressed_audio_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_audio.decode_audio(b"fLaC\x00\x00\x00\x22" + bytes(64))


@pytest.fixture(scope="module")
def formats_dir(tmp_path_factory):
    """One file per WAV flavour, stereo ones included (class folder 'a')."""
    root = tmp_path_factory.mktemp("wav_formats")
    os.makedirs(root / "a")
    rng = np.random.default_rng(12)
    for i, kind in enumerate(["pcm8", "pcm16", "pcm24", "pcm32", "float32", "stereo16"]):
        (root / "a" / f"{i}_{kind}.wav").write_bytes(_wav_case(kind, rng, n=700 + 50 * i))
    return str(root)


def _decode_pipe(pkg, root, batch, device, n_out=2, **dec_kw):
    fn = pkg.fn

    @pkg.pipeline_def(batch_size=batch, num_threads=2, seed=7,
                      **({"device": "cpu"} if pkg is dali_tpu_torch else {}))
    def p():
        enc, _ = fn.readers.file(file_root=root, file_filters=["*.wav"], name="R")
        audio, rate = fn.decoders.audio(enc, device=device, **dec_kw)
        return (audio, rate)[:n_out]

    pipe = p()
    pipe.build()
    return pipe


def _shutdown(pipe):
    if isinstance(pipe, dali_tpu_torch.Pipeline):
        pipe.shutdown()
    else:
        pipe._executor.shutdown()


def _samples(tl):
    """Per-sample numpy arrays of an output of either package, cropped to
    each sample's valid extent."""
    if hasattr(tl, "as_cpu"):
        tl = tl.as_cpu()
    return [np.asarray(tl.at(i)) for i in range(len(tl))]


@pytest.mark.parametrize("downmix,dtype,rate", [(True, "FLOAT", 0.0), (False, "FLOAT", 0.0),
                                               (True, "INT16", 0.0), (True, "FLOAT", 8000.0),
                                               (False, "FLOAT", 22050.0)])
def test_cpu_decoder_bit_equal(formats_dir, downmix, dtype, rate):
    """decoders.audio on the cpu: every WAV flavour, downmixed or not, as
    float or int16, and resampled (scipy's polyphase filter in both)."""
    outs = []
    for pkg in (dali_tpu_torch, dali_tpu):
        pipe = _decode_pipe(pkg, formats_dir, 6, "cpu", downmix=downmix,
                            dtype=getattr(pkg.types, dtype), sample_rate=rate)
        try:
            audio, rates = pipe.run()
            outs.append((_samples(audio), _samples(rates)))
        finally:
            _shutdown(pipe)
    (ga, gr), (wa, wr) = outs
    for g, w in zip(ga + gr, wa + wr):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def mixed_dirs(tmp_path_factory):
    """'pcm16': 16-bit clips of ragged lengths; 'with_float': the same plus a
    float32 file, which forces a float32 wire for its batch."""
    rng = np.random.default_rng(21)
    dirs = {}
    for name in ("pcm16", "with_float"):
        root = tmp_path_factory.mktemp(name)
        os.makedirs(root / "a")
        for i in range(4):
            x = speech_clip(rng, float(rng.uniform(0.05, 0.2)))
            (root / "a" / f"{i}.wav").write_bytes(wav_bytes(to_int16(x).tobytes()))
        if name == "with_float":
            x = speech_clip(rng, 0.1) * np.float32(0.5) + np.float32(1e-6)
            (root / "a" / "4.wav").write_bytes(wav_bytes(x.tobytes(), bits=32, fmt_tag=3))
        dirs[name] = str(root)
    return dirs


@pytest.mark.parametrize("case,wire", [("pcm16", np.int16), ("with_float", np.float32)])
def test_mixed_decode_split_bit_equal(mixed_dirs, case, wire):
    """_AudioStage + _AudioToOutput: the wire dtype, and float32 output equal
    to the port's cpu decoder and to dali_tpu's mixed decode."""
    root = mixed_dirs[case]
    batch = 5 if case == "with_float" else 4
    staged = _decode_pipe(dali_tpu_torch, root, batch, "mixed", n_out=1, downmix=True)
    try:
        boundary = staged.executor._host_phase(0)["boundary"]
        assert len(boundary) == 1 and boundary[0].array.dtype == wire
    finally:
        staged.shutdown()
    got = {}
    for label, pkg, device in (("mixed", dali_tpu_torch, "mixed"), ("cpu", dali_tpu_torch, "cpu"),
                               ("ref", dali_tpu, "mixed")):
        pipe = _decode_pipe(pkg, root, batch, device, n_out=1, downmix=True)
        try:
            got[label] = _samples(pipe.run()[0])
        finally:
            _shutdown(pipe)
    for m, c, r in zip(got["mixed"], got["cpu"], got["ref"]):
        assert m.dtype == np.float32
        np.testing.assert_array_equal(m, c)
        np.testing.assert_array_equal(m, r)


# ------------------------------------------------- the ragged boundary canvas

@pytest.mark.parametrize("shapes,align,canvas,fill", [
    ([(5,), (17,), (3,)], 64, None, 0),
    ([(5, 2), (17, 2), (9, 2)], [64, 1], [128, 2], 0),
    ([(4, 6, 3), (7, 2, 3)], [8, 8, 1], None, 7),
    ([(10,), (10,)], 1, [32], 0),
])
def test_pad_and_stack_bit_equal(shapes, align, canvas, fill):
    rng = np.random.default_rng(31)
    samples = [rng.integers(-1000, 1000, s).astype(np.int16) for s in shapes]
    got = port_batch.pad_and_stack(port_batch.HostBatch(samples), canvas=canvas, align=align,
                                   fill=fill)
    want = ref_batch.pad_and_stack(ref_batch.HostBatch(samples), canvas=canvas, align=align,
                                   fill=fill)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def shrinking_dir(tmp_path_factory):
    """Six 16-bit clips whose lengths fall, read in order: the second batch
    of two is shorter than the first."""
    root = tmp_path_factory.mktemp("shrinking")
    os.makedirs(root / "a")
    rng = np.random.default_rng(41)
    for i, n in enumerate([3000, 2100, 1500, 1200, 700, 90]):
        x = rng.uniform(-0.5, 0.5, n).astype(np.float32)
        (root / "a" / f"{i}.wav").write_bytes(wav_bytes(to_int16(x).tobytes()))
    return str(root)


def test_boundary_canvas_grows_only(shrinking_dir):
    """The executor's grow-only canvas: later, shorter batches keep the
    first batch's canvas in both packages, with equal per-sample shapes and
    values."""
    runs = []
    for pkg in (dali_tpu_torch, dali_tpu):
        pipe = _decode_pipe(pkg, shrinking_dir, 2, "mixed", n_out=1)
        try:
            runs.append([pipe.run()[0] for _ in range(3)])
        finally:
            _shutdown(pipe)
    canvases = []
    for g, w in zip(*runs):
        canvases.append(tuple(g.as_tensor().shape))
        assert canvases[-1] == tuple(np.asarray(w.as_tensor()).shape)
        assert g.shape() == w.shape()
        for a, b in zip(_samples(g), _samples(w)):
            np.testing.assert_array_equal(a, b)
    assert canvases == [(2, 3008)] * 3


@pytest.mark.parametrize("shapes", [None, [[6, 3], [6, 3]], [[4, 3], [4, 3]], [[6, 3], [2, 3]],
                                    [[6], [6]]])
def test_is_dense_tensor_matches(shapes):
    """Dense iff every sample fills the canvas: uniform shapes over a padded
    canvas are still ragged, as in dali_tpu."""
    data = np.arange(36, dtype=np.float32).reshape(2, 6, 3)
    sh = None if shapes is None else np.array(shapes, np.int32)
    got = port_tensors.TensorListGPU(torch.from_numpy(data), sh)
    want = ref_tensors.TensorListGPU(jnp.asarray(data), sh)
    assert got.is_dense_tensor() == want.is_dense_tensor()


# ------------------------------------------------------------ signal kernels

def _ragged_signals(seed, n=4, canvas=1600):
    rng = np.random.default_rng(seed)
    lens = np.array([canvas, 1211, 640, 333][:n])
    x = np.zeros((n, canvas), np.float32)
    for i, ln in enumerate(lens):
        x[i, :ln] = rng.standard_normal(ln).astype(np.float32)
    return x, lens


@pytest.mark.parametrize("center,reflect", [(True, True), (True, False), (False, True)])
def test_frame_signal_bit_equal(center, reflect):
    x, lens = _ragged_signals(51)
    got = port_sig.frame_signal(torch.from_numpy(x), 320, 160, center, reflect,
                                valid_len=torch.from_numpy(lens)).numpy()
    for i, ln in enumerate(lens):
        want = np.asarray(ref_sig.frame_signal(jnp, jnp.asarray(x[i]), 320, 160, center, reflect,
                                               valid_len=int(ln)))
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("power,nfft,layout,center,reflect", [
    (2, 512, "ft", True, True), (1, 512, "ft", True, True), (2, 320, "tf", True, False),
    (2, 400, "ft", False, True), (1, 320, "tf", True, True)])
def test_spectrogram_matches(power, nfft, layout, center, reflect):
    x, lens = _ragged_signals(52)
    window = port_sig.hann_window(320)
    got = port_sig.spectrogram(torch.from_numpy(x), nfft, 320, 160, window, power, center,
                               reflect, layout, valid_len=torch.from_numpy(lens)).numpy()
    for i, ln in enumerate(lens):
        want = np.asarray(ref_sig.spectrogram(jnp, jnp.asarray(x[i]), nfft, 320, 160, window,
                                              power, center, reflect, layout, valid_len=int(ln)))
        assert got[i].shape == want.shape
        frames = ln // 160 + 1 if center else (ln - 320) // 160 + 1
        valid = (slice(None), slice(0, frames)) if layout == "ft" else (slice(0, frames),)
        err = np.abs(got[i][valid] - want[valid]).max() / want[valid].max()
        assert err <= 1e-5, err


@pytest.mark.parametrize("border", ["clamp", "zero", "reflect"])
def test_preemphasis_matches(border):
    x, lens = _ragged_signals(53)
    coeff = torch.tensor([0.97, 0.5, 0.0, 0.9])
    got = port_sig.preemphasis(torch.from_numpy(x), coeff, border).numpy()
    for i, ln in enumerate(lens):
        want = np.asarray(ref_sig.preemphasis(jnp, jnp.asarray(x[i, :ln]), float(coeff[i]), border))
        np.testing.assert_allclose(got[i, :ln], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("args", [(80, 512, 16000.0), (40, 400, 8000.0, 20.0, 3000.0, "htk", False),
                                  (128, 1024, 44100.0, 0.0, None, "slaney", True)])
def test_mel_filter_bank_matrix_bit_equal(args):
    np.testing.assert_array_equal(port_sig.mel_filter_bank_matrix(*args),
                                  ref_sig.mel_filter_bank_matrix(*args))


@pytest.mark.parametrize("args", [(20, 80, 2, False), (13, 40, 2, True), (8, 16, 1, False),
                                  (8, 16, 3, False)])
def test_dct_matrix_bit_equal(args):
    np.testing.assert_array_equal(port_sig.dct_matrix(*args), ref_sig.dct_matrix(*args))


# ------------------------------------------------------------------- operators

def _both_ops(schema, device, **kw):
    from dali_tpu._schema import OpSpec as RefSpec
    from dali_tpu_torch._schema import OpSpec as PortSpec, get_operator_impl
    from dali_tpu._schema import get_operator_impl as ref_impl

    port = get_operator_impl(schema, device)(PortSpec(schema, device=device, **kw), 0)
    ref = ref_impl(schema, device)(RefSpec(schema, device=device, **kw), 0)
    return port, ref


def _ragged_mel(seed, n=3, canvas=(80, 40)):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-80, 0, (n, *canvas)).astype(np.float32)
    shapes = np.array([canvas, (80, 23), (80, 7)][:n], np.int32)
    return x, shapes


@pytest.mark.parametrize("kw,ragged", [
    ({"axes": [1]}, True), ({"axes": [1]}, False), ({}, True), ({"batch": True}, True),
    ({"axes": [1], "mean": -40.0, "stddev": 12.5}, True), ({"axis_names": "t"}, True),
    ({"axes": [0], "scale": 2.0, "shift": 1.0, "epsilon": 0.5}, True)])
def test_normalize_gpu_matches(kw, ragged):
    x, shapes = _ragged_mel(61)
    port, ref = _both_ops("Normalize", "gpu", **kw)
    layout = "ft"
    got = port.lower(port_base.DeviceCtx({}, {}), port_batch.DeviceBatch(
        torch.from_numpy(x), torch.from_numpy(shapes) if ragged else None, layout))[0]
    import jax

    want = ref.lower(ref_base.DeviceCtx(3, jax.random.PRNGKey(0), {}, {}), ref_batch.DeviceBatch(
        jnp.asarray(x), jnp.asarray(shapes) if ragged else None, layout))[0]
    want = np.asarray(want.data)
    for i, (f, t) in enumerate(shapes if ragged else [x.shape[1:]] * 3):
        np.testing.assert_allclose(got.data.numpy()[i, :f, :t], want[i, :f, :t], rtol=0, atol=1e-4)


class _Pipe:
    max_batch_size, seed = 3, 1


def test_normalize_cpu_honours_ddof_like_dali_tpu():
    x, shapes = _ragged_mel(62)
    samples = [x[i, :f, :t] for i, (f, t) in enumerate(shapes)]
    port, ref = _both_ops("Normalize", "cpu", axes=[1], ddof=1)
    got = port.run_batch(port_base.HostCtx(_Pipe(), 0, 0),
                         port_batch.HostBatch(samples, layout="ft"))[0].samples
    want = ref.run_batch(ref_base.HostCtx(_Pipe(), 0, 0),
                         ref_batch.HostBatch(samples, layout="ft"))[0].samples
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kw", [{}, {"n_mfcc": 13, "normalize": True, "lifter": 22.0},
                                {"axis": 1, "n_mfcc": 5, "dct_type": 3}])
def test_mfcc_gpu_matches(kw):
    x, shapes = _ragged_mel(63)
    port, ref = _both_ops("MFCC", "gpu", **kw)
    got = port.lower(port_base.DeviceCtx({}, {}), port_batch.DeviceBatch(
        torch.from_numpy(x), torch.from_numpy(shapes), "ft"))[0]
    want = ref.lower(None, ref_batch.DeviceBatch(jnp.asarray(x), jnp.asarray(shapes), "ft"))[0]
    np.testing.assert_array_equal(got.shapes.numpy(), np.asarray(want.shapes))
    np.testing.assert_array_equal(port.host_output_shapes(None, [shapes], [None])[0],
                                  np.asarray(want.shapes))
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=1e-5, atol=1e-3)


def test_nonsilent_region_matches():
    rng = np.random.default_rng(71)
    x = np.zeros(20000, np.float32)
    x[5000:13000] = rng.uniform(-0.5, 0.5, 8000).astype(np.float32)
    port, ref = _both_ops("NonsilentRegion", "cpu", window_length=512, cutoff_db=-40.0)
    got = port.run_sample(None, 0, x)
    want = ref.run_sample(None, 0, x)
    assert [int(v) for v in got] == [int(v) for v in want]


# -------------------------------------------------------- the whole front end

@pytest.fixture(scope="module")
def asr_corpus(tmp_path_factory):
    """Twelve ragged 16-bit clips of 0.5-1.25 s (the bench's signal)."""
    return write_corpus(str(tmp_path_factory.mktemp("asr")), 12, 5, (0.5, 1.25))


def _asr_pipe(pkg, root, ops_device=None, **kw):
    fn, types = pkg.fn, pkg.types
    dev = {} if ops_device is None else {"device": ops_device}

    @pkg.pipeline_def(batch_size=4, num_threads=2, seed=7, **kw)
    def asr_frontend():
        enc, _ = fn.readers.file(file_root=root, file_filters=["*.wav"], random_shuffle=True,
                                 name="R", seed=3)
        audio, _rate = fn.decoders.audio(enc, dtype=types.FLOAT, downmix=True,
                                         device="cpu" if ops_device == "cpu" else "mixed")
        audio = fn.preemphasis_filter(audio, preemph_coeff=0.97, **dev)
        spec = fn.spectrogram(audio, nfft=512, window_length=320, window_step=160, **dev)
        mel = fn.mel_filter_bank(spec, sample_rate=float(RATE), nfilter=80, **dev)
        db = fn.to_decibels(mel, multiplier=10.0, cutoff_db=-80.0, **dev)
        return db, fn.normalize(db, axes=[1], **dev)

    pipe = asr_frontend()
    pipe.build()
    return pipe


def _run_both(port, ref, iterations):
    worst = [0.0, 0.0]
    try:
        for _ in range(iterations):
            got, want = port.run(), ref.run()
            for k in range(2):
                if hasattr(got[k], "as_tensor") and hasattr(want[k], "jax_array"):
                    assert tuple(got[k].as_tensor().shape) == tuple(want[k].jax_array.shape)
                    assert got[k].as_tensor().dtype == torch.float32
                assert got[k].shape() == want[k].shape()
                for g, w in zip(_samples(got[k]), _samples(want[k])):
                    worst[k] = max(worst[k], float(np.abs(g - w).max()))
    finally:
        _shutdown(port)
        _shutdown(ref)
    return worst


def test_asr_frontend_matches_dali_tpu(asr_corpus):
    """bench.py's asr_frontend at batch 4 on ragged clips, three iterations
    (the canvas grows, then holds): equal canvases and per-sample shapes; dB
    within 1e-3 dB and normalized values within 1e-3 on the valid region."""
    worst_db, worst_norm = _run_both(_asr_pipe(dali_tpu_torch, asr_corpus, device="cpu"),
                                     _asr_pipe(dali_tpu, asr_corpus), 3)
    print(f"asr_frontend max abs diff: dB {worst_db:.3e}, normalized {worst_norm:.3e}")
    assert worst_db <= 1e-3 and worst_norm <= 1e-3


def test_asr_frontend_cpu_operators_match_dali_tpu(asr_corpus):
    """The same chain with every operator on device='cpu' in both packages."""
    worst_db, worst_norm = _run_both(
        _asr_pipe(dali_tpu_torch, asr_corpus, ops_device="cpu", device="cpu"),
        _asr_pipe(dali_tpu, asr_corpus, ops_device="cpu"), 2)
    print(f"asr_frontend cpu operators max abs diff: dB {worst_db:.3e}, "
          f"normalized {worst_norm:.3e}")
    assert worst_db <= 1e-3 and worst_norm <= 1e-3


def test_asr_output_shapes_are_host_known(asr_corpus):
    """The device output's per-sample shapes come from the host-side shape
    pass (a numpy array, no readback): [80, len // 160 + 1] per clip."""
    fn, types = dali_tpu_torch.fn, dali_tpu_torch.types

    @dali_tpu_torch.pipeline_def(batch_size=4, num_threads=2, seed=7, device="cpu")
    def p():
        enc, _ = fn.readers.file(file_root=asr_corpus, file_filters=["*.wav"], name="R")
        audio, _rate = fn.decoders.audio(enc, dtype=types.FLOAT, device="mixed")
        spec = fn.spectrogram(audio, nfft=512, window_length=320, window_step=160)
        mel = fn.mel_filter_bank(spec, sample_rate=float(RATE), nfilter=80)
        return audio, fn.normalize(fn.to_decibels(mel, cutoff_db=-80.0), axes=[1])

    pipe = p()
    try:
        for _ in range(2):
            audio, out = pipe.run()
            assert isinstance(out._shapes, np.ndarray)
            assert out.shape() == [(80, s[0] // 160 + 1) for s in audio.shape()]
            assert tuple(out.as_tensor().shape) == (4, 80, audio.as_tensor().shape[1] // 160 + 1)
            assert all(np.isfinite(a).all() for a in _samples(out))
    finally:
        pipe.shutdown()
