"""experimental.AudioResample in dali_tpu_torch against dali_tpu, on the CPU,
and the asr_resample path (asr_frontend's graph on 48 kHz clips, resampled
to 16 kHz on the device) whole.

The two placements compute different functions in the reference, and each
is held against its own: the cpu op is scipy's polyphase filter there and
here, bit-equal; the gpu op is a Kaiser-windowed sinc
(``kernels/signal.py`` ``sinc_resample``), held against the reference's
lowering with ``debug=True`` within 1e-5 of each clip's peak (float32 sums
over 16-64 taps in another order, and torch's sin and exp against XLA's).
The whole path: the resampled signal within 1e-5 of each clip's peak, the
dB mel within 1e-3 dB on each clip's frames (the ASR tests' bound).
"""

import numpy as np
import pytest
import torch

import dali_tpu
import dali_tpu_torch
from dali_tpu_torch.kernels import signal as port_sig
from dali_tpu_torch.testdata.make_audio_corpus import write_corpus
from dali_tpu_torch.tools import bench_dali_cpu

N = 4
RNG = np.random.default_rng(19)
MONO = [(np.sin(np.arange(n) * 0.05 * (i + 1)) * 0.5
         + RNG.standard_normal(n) * 0.05).astype(np.float32)
        for i, n in enumerate((4800, 3001, 7000, 960))]
STEREO = [RNG.uniform(-0.8, 0.8, (n, 2)).astype(np.float32) for n in (2000, 3500, 1200, 4410)]
IN_RATES = [np.float32(r) for r in (48000, 44100, 22050, 16000)]
OUT_RATES = [np.float32(r) for r in (16000, 16000, 24000, 8000)]
SCALES = [np.float32(s) for s in (0.5, 1.5, 0.25, 1.0)]
LENGTHS = [np.int32(n) for n in (1000, 2500, 640, 333)]


def _run(pkg, device, data, build, args=()):
    kw = {"device": "cpu"} if pkg is dali_tpu_torch else {"debug": True}

    @pkg.pipeline_def(batch_size=len(data), num_threads=1, seed=3, **kw)
    def p():
        x = pkg.fn.external_source(source=lambda: data, batch=True)
        x = x.gpu() if device == "gpu" else x
        a = [pkg.fn.external_source(source=lambda v=v: v, batch=True) for v in args]
        return build(pkg.fn, pkg.types, x, *a)

    pipe = p()
    pipe.build()
    try:
        (out,) = pipe.run()
        return [np.asarray(out.as_cpu().at(i) if hasattr(out, "as_cpu") else out.at(i))
                for i in range(len(data))]
    finally:
        (pipe.shutdown if pkg is dali_tpu_torch else pipe._executor.shutdown)()


def _both(device, data, build, args=()):
    return (_run(dali_tpu_torch, device, data, build, args),
            _run(dali_tpu, device, data, build, args))


CASES = {
    "rates": (lambda fn, t, x: fn.experimental.audio_resample(x, in_rate=48000.0,
                                                              out_rate=16000.0), ()),
    "per_sample_rates": (lambda fn, t, x, i, o: fn.experimental.audio_resample(
        x, in_rate=i, out_rate=o), (IN_RATES, OUT_RATES)),
    "scale": (lambda fn, t, x, s: fn.audio_resample(x, scale=s), (SCALES,)),
    "up_float64": (lambda fn, t, x: fn.experimental.audio_resample(
        x, in_rate=16000.0, out_rate=22050.0, dtype=t.FLOAT64), ()),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("data", ["mono", "stereo"])
def test_cpu_bit_equal(case, data):
    build, args = CASES[case]
    got, want = _both("cpu", MONO if data == "mono" else STEREO, build, args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _close_to_peak(got, want, rtol=1e-5):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        peak = float(np.abs(w).max())
        assert float(np.abs(g.astype(np.float64) - w).max()) <= rtol * peak


@pytest.mark.parametrize("quality", [10.0, 50.0, 95.0], ids=["16_taps", "32_taps", "64_taps"])
@pytest.mark.parametrize("data", ["mono", "stereo"])
def test_gpu_against_the_reference_lowering(quality, data):
    build = lambda fn, t, x, i, o: fn.experimental.audio_resample(  # noqa: E731
        x, in_rate=i, out_rate=o, quality=quality)
    _close_to_peak(*_both("gpu", MONO if data == "mono" else STEREO, build,
                          (IN_RATES, OUT_RATES)))


@pytest.mark.parametrize("case", ["scale", "out_length", "equal_rates"])
def test_gpu_scale_out_length_and_equal_rates(case):
    build = {
        "scale": (lambda fn, t, x, s: fn.audio_resample(x, scale=s), (SCALES,)),
        "out_length": (lambda fn, t, x, n: fn.experimental.audio_resample(
            x, in_rate=48000.0, out_rate=16000.0, out_length=n), (LENGTHS,)),
        "equal_rates": (lambda fn, t, x: fn.experimental.audio_resample(
            x, in_rate=16000.0, out_rate=16000.0), ()),
    }[case]
    got, want = _both("gpu", MONO, *build)
    _close_to_peak(got, want)
    if case == "out_length":
        assert [g.shape[0] for g in got] == [int(n) for n in LENGTHS]


def test_sinc_resample_chunks_equal_one_pass(monkeypatch):
    """Output positions go in chunks that bound the [N, positions, taps]
    intermediates: the chunked result equals one pass."""
    x = torch.from_numpy(np.stack([np.resize(m, 4000) for m in MONO]))
    rates = torch.tensor([48000.0, 44100.0, 32000.0, 16000.0]), torch.tensor([16000.0] * 4)
    whole = port_sig.sinc_resample(x, *rates, 1408, 32)
    monkeypatch.setattr(port_sig, "SINC_CHUNK_BYTES", 4 * 4 * 32 * 100)
    torch.testing.assert_close(port_sig.sinc_resample(x, *rates, 1408, 32), whole, rtol=0,
                               atol=0)


@pytest.fixture(scope="module")
def corpus_48k(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("asr48k")), 6, 21, (0.5, 1.2), rate=48000)


def test_asr_resample_path_matches_dali_tpu(corpus_48k):
    """The asr_resample graph (``tools/bench_dali_cpu.py``) at batch 4, two
    iterations, both packages: resampled clips within 1e-5 of their peak,
    dB within 1e-3 dB on each clip's frames, the same per-sample shapes.
    dali_tpu decodes on the host and copies (the same values): its mixed
    decode gives AudioResample(gpu) no host shapes, and it raises
    (``test_reference_mixed_decode_gives_the_resample_no_shapes``)."""
    res = []
    for pkg, kw in ((dali_tpu_torch, {"device": "cpu"}), (dali_tpu, {"debug": True})):
        @pkg.pipeline_def(batch_size=4, seed=7, num_threads=1, **kw)
        def p():
            return bench_dali_cpu.asr_resample_graph(pkg.fn, pkg.types, corpus_48k,
                                                     mixed=pkg is dali_tpu_torch)[:2]

        pipe = p()
        pipe.build()
        try:
            res.append([[[np.asarray(o.as_cpu().at(i)) for i in range(4)] for o in pipe.run()]
                        for _ in range(2)])
        finally:
            (pipe.shutdown if pkg is dali_tpu_torch else pipe._executor.shutdown)()
    for (g_res, g_db), (w_res, w_db) in zip(*res):
        _close_to_peak(g_res, w_res)
        for g, w in zip(g_db, w_db):
            assert g.shape == w.shape == (bench_dali_cpu.NMEL, w.shape[1])
            np.testing.assert_allclose(g, w, atol=1e-3, rtol=0)


def test_reference_mixed_decode_gives_the_resample_no_shapes(corpus_48k):
    """Found in the reference (ROADMAP.md Queue 3): dali_tpu's mixed audio
    decode leaves AudioResample(gpu) without host shapes, so asr_resample's
    graph raises there; the port's mixed decode carries them."""
    @dali_tpu.pipeline_def(batch_size=4, seed=7, num_threads=1, debug=True)
    def p():
        return bench_dali_cpu.asr_resample_graph(dali_tpu.fn, dali_tpu.types, corpus_48k)[0]

    pipe = p()
    try:
        with pytest.raises(RuntimeError, match="host-known input shapes"):
            pipe.build()
            pipe.run()
    finally:
        pipe._executor.shutdown()
