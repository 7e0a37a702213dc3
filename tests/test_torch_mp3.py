"""MP3 in dali_tpu_torch (ROADMAP.md Queue 1 item 4b): the native decoder
(``csrc/host/mp3_decode.cc``) against dali_tpu's FFmpeg route
(``dali_tpu.native.audio_decode``: FFmpeg 5.1's mp3 demuxer and mp3float
decoder) on the CPU.

The fixtures are committed (``dali_tpu_torch/testdata/audio_codecs``,
written by ``testdata/make_audio_codecs.py`` through FFmpeg's encoders):
MPEG-1, MPEG-2 and MPEG-2.5 at every rate, CBR and VBR, mono, stereo and
joint stereo; streams without a LAME frame and with ID3v1 and APEv2
trailers; damaged streams (a frame cut short, a frame's main data
overwritten, a stream cut where a frame reaches into a reservoir that is
gone); and the forms LAME never writes, made by editing LAME's frames
(intensity stereo in MPEG-1 and MPEG-2, mixed blocks, CRC-protected frames).

Tolerance: the sample count, channel count and rate are equal; the float32
PCM meets the "full accuracy" bounds of ISO/IEC 11172-4 against the
reference's: RMS difference <= 2^-15 / sqrt(12) (8.8e-6) and largest
difference <= 2^-14 (6.1e-5) of full scale. The worst seen is ~1.8e-6 and
~2.1e-7 (the two decoders' float32 synthesis sums in other orders). INT16
outputs are within one step. The ASR mel graph fed the same PCM meets the
ASR contract of PERF.md section 2, 1e-3 dB (worst seen ~6.4e-4 dB on these
louder, burstier clips; the 7e-5 dB ROADMAP.md quotes is the WAV corpus's
measure); with the two decodes inside it, 5e-3 dB (worst seen ~3.5e-3 dB:
the decodes' 1e-6 differences seen through the log of the quietest bins).
Streams the reference fails on raise ValueError here.
"""

import json
import os
import shutil

import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch
from dali_tpu import native as ref_native
from dali_tpu_torch import native as port_native
from dali_tpu_torch.backend import audio as port_audio
from dali_tpu_torch.testdata.make_audio_codecs import Mp3Frames, apev2_tag, id3v1_tag
from dali_tpu_torch.tools.bench_audio_codecs import CODECS, MAX_BOUND, RMS_BOUND

pytestmark = pytest.mark.skipif(not ref_native.has_audio(),
                                reason="dali_tpu's native library was built without FFmpeg")

FIXTURES = sorted(f for f in os.listdir(CODECS) if f.startswith("mp3_") and f.endswith(".mp3"))
REF = np.load(os.path.join(CODECS, "reference.npz"))


def _read(name):
    with open(os.path.join(CODECS, name), "rb") as f:
        return f.read()


def _port(data):
    """The port's decode, or the exception type it raises."""
    try:
        return port_audio.decode_audio(data)
    except (ValueError, NotImplementedError) as e:
        return type(e)


def _assert_within(got, want, what):
    """Equal shape and rate, ISO/IEC 11172-4 full accuracy; returns (max, rms)."""
    (x, rate), (w, wrate) = got, want
    assert x.dtype == np.float32 and x.shape == w.shape and rate == wrate, (what, x.shape, w.shape)
    d = x.astype(np.float64) - w
    mx, rms = float(np.abs(d).max()), float(np.sqrt(np.mean(d * d)))
    assert mx <= MAX_BOUND and rms <= RMS_BOUND, f"{what}: max {mx:.3e}, rms {rms:.3e}"
    return mx, rms


def _same_outcome(data, what):
    """The port decodes what the reference decodes, within the bounds, and
    raises ValueError where the reference fails."""
    want = ref_native.audio_decode(data)
    got = _port(data)
    if want is None:
        assert got is ValueError, f"{what}: the reference fails, the port gives {got}"
        return None
    assert not isinstance(got, type), f"{what}: the port raises {got.__name__}"
    return _assert_within(got, want, what)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_matches_dali_tpu(name):
    """Every form: the reference's sample count, channels and rate, within
    the full-accuracy bounds; the committed reference.npz is the live
    reference's output (what the card holds the port against)."""
    data = _read(name)
    want = ref_native.audio_decode(data)
    key = name[:-4]
    np.testing.assert_array_equal(REF[key], want[0])
    assert float(REF[key + ":rate"]) == want[1]
    mx, rms = _assert_within(port_audio.decode_audio(data), want, name)
    print(f"{name}: {want[0].shape} at {want[1]:.0f} Hz, max {mx:.2e}, rms {rms:.2e}")


LONG = os.path.join("corpus_mp3", "clips", "c0000.mp3")  # 48 kHz mono, 64 kbit/s, 8.5 s


def _frames(name=LONG):
    m = Mp3Frames(_read(name))
    return m, m.audio_frames()


def _side_end(f):
    return f["offset"] + f["fields"][(None, None, "end")][0] // 8


@pytest.mark.parametrize("frame", [-1, -2, -3, 100])
@pytest.mark.parametrize("into", [2, "side+20", "side+60", "side+120"])
def test_cut_inside_a_frame(frame, into):
    """A stream cut inside a frame: cut in the header the reference fails;
    cut in the main data it decodes the partial frame from the bytes there
    are (the rest reads as zeros, its position stalls 8 bits past them, its
    Huffman reads stop at their end), as the port does."""
    m, audio = _frames()
    f = audio[frame]
    at = f["offset"] + into if isinstance(into, int) else _side_end(f) + int(into[5:])
    _same_outcome(bytes(m.data[:at]), f"cut {into} into frame {frame}")


def test_cut_before_the_scale_factors_end_departs():
    """Pinned departure (ROADMAP.md Queue 3): a frame cut a byte or two
    after its side info, where a granule's scale factors reach past the
    cut. FFmpeg reads them from its reservoir buffer past the bytes it
    copied there (stale bytes of earlier frames); the port reads zeros. The
    lengths agree, and every sample before the cut frame's."""
    m, audio = Mp3Frames(_read("mp3_mpeg1_48k_mono_cbr64.mp3")), None
    audio = m.audio_frames()
    data = bytes(m.data[:_side_end(audio[-2]) + 2])
    (w, wr), (g, gr) = ref_native.audio_decode(data), port_audio.decode_audio(data)
    assert g.shape == w.shape and gr == wr
    last = len(w) - 1152 + 529  # the cut frame's samples, after the end trim
    _assert_within((g[:last - 1152], 0), (w[:last - 1152], 0), "before the cut frame")
    assert np.abs(g - w).max() > MAX_BOUND


@pytest.mark.parametrize("start", [1, 2, 3, 4])
def test_cut_mid_reservoir(start):
    """The stream started at a later frame (ID3 and Info frames gone): the
    granules whose main data lay in frames that are gone decode as silence,
    as FFmpeg conceals them."""
    m, audio = _frames()
    _same_outcome(bytes(m.data[audio[start]["offset"]:]), f"from frame {start}")


def _damaged(case):
    m, audio = _frames()
    data = bytes(m.data)
    mid = audio[len(audio) // 2]["offset"]
    if case == "junk_between_frames":
        return data[:mid] + bytes(range(1, 11)) + data[mid:]
    if case == "id3v1_between_frames":  # swallows the frame after it
        return data[:mid] + id3v1_tag() + data[mid:]
    if case == "trailing_junk":
        return data + b"\x01" * 10
    if case == "trailing_apev2_without_header":
        return data + apev2_tag()[32:]
    if case == "trailing_apev2_then_id3v1":
        return data + apev2_tag() + id3v1_tag()
    if case == "trailing_id3v1":
        return data + id3v1_tag()
    if case == "big_values_over_288":
        f = audio[3]
        m.put(f, (0, 0, "big_values"), 300)
        return bytes(m.data)
    if case == "block_type_0_with_window_switching":
        f = next(g for g in audio if (0, 0, "block_type") in g["fields"])
        m.put(f, (0, 0, "block_type"), 0)
        return bytes(m.data)
    if case == "one_frame":
        return data[audio[2]["offset"]:audio[3]["offset"]]
    if case == "two_frames":
        return data[audio[2]["offset"]:audio[4]["offset"]]
    if case == "main_data_noise":
        b = bytearray(data)
        rng = np.random.default_rng(5)
        for f in audio[2::3]:
            s = _side_end(f)
            b[s:s + 24] = rng.integers(0, 256, 24, dtype=np.uint8).tobytes()
        return bytes(b)
    raise KeyError(case)


DAMAGED = ["junk_between_frames", "id3v1_between_frames", "trailing_junk",
           "trailing_apev2_without_header", "trailing_apev2_then_id3v1", "trailing_id3v1",
           "big_values_over_288", "block_type_0_with_window_switching", "one_frame",
           "two_frames", "main_data_noise"]


@pytest.mark.parametrize("case", DAMAGED)
def test_damaged_stream_follows_the_reference(case):
    """Each damage gives the reference's output, or ValueError where the
    reference fails: a packet not starting with a header fails the stream
    unless it starts with "TAG" (swallowed with the frame after it); bytes
    left after the last frame are dropped only as an ID3v1 or APEv2 tag
    with its header; a frame whose side info FFmpeg rejects fails the
    stream; the first frame needs a successor of the same form, so one
    frame alone fails."""
    _same_outcome(_damaged(case), case)


def test_committed_damaged_fixtures_are_damaged():
    """The committed damaged streams differ from clean decodes of the same
    frames: the truncated one ends inside its last frame, the corrupt one
    decodes differently from its clean frames, the reservoir cut starts
    after its first frames."""
    m, audio = Mp3Frames(_read("mp3_truncated.mp3")), None
    last = m.frames[-1]
    assert last["offset"] + last["size"] > len(m.data)
    trunc = _read("mp3_truncated.mp3")
    clean = trunc[:last["offset"]]
    assert ref_native.audio_decode(clean)[0].shape != ref_native.audio_decode(trunc)[0].shape \
        or not np.array_equal(ref_native.audio_decode(clean)[0], ref_native.audio_decode(trunc)[0])
    cut = Mp3Frames(_read("mp3_cut_mid_reservoir.mp3"))
    assert cut.start == 0 and cut.field(cut.frames[0], (None, None, "main_data_begin")) > 0


def test_layer_2_and_item_4c_raise():
    """MPEG-1 Layer II, which the reference decodes, raises
    NotImplementedError naming item 4c; free format too."""
    data = _read("fail_layer2.mp3")
    assert ref_native.audio_decode(data) is not None
    with pytest.raises(NotImplementedError, match=r"item 4c"):
        port_audio.decode_audio(data)
    with pytest.raises(ValueError, match="malformed MP3"):
        port_audio.decode_audio(_read("fail_bad_side_info.mp3"))
    assert ref_native.audio_decode(_read("fail_bad_side_info.mp3")) is None


def test_huffman_tables_are_complete_prefix_codes():
    """audio_tables.h: each Huffman table a complete prefix code of its
    size, the synthesis window ending at 75038 / 2^16."""
    path = os.path.join(os.path.dirname(CODECS), "..", "csrc", "host", "audio_tables.h")
    text = open(path).read()
    sizes = {1: 4, 2: 9, 3: 9, 5: 16, 6: 16, 7: 36, 8: 36, 9: 36, 10: 64, 11: 64, 12: 64,
             13: 256, 15: 256, 16: 256, 24: 256, 32: 16, 33: 16}

    def array(name):
        body = text.split(name + "[")[1].split("{", 1)[1].split("}", 1)[0]
        return [int(v) for v in body.split(",")]
    for t, n in sizes.items():
        codes, lens = array(f"kHuffCodes{t}"), array(f"kHuffLens{t}")
        assert len(codes) == len(lens) == n
        assert sum(2.0 ** -ln for ln in lens) == 1.0
        words = sorted(format(c, f"0{ln}b") for c, ln in zip(codes, lens))
        assert all(c < 1 << ln for c, ln in zip(codes, lens))
        assert not any(b.startswith(a) for a, b in zip(words, words[1:]))
    assert array("kSynthWindow")[-1] == 75038


def test_pool_and_inline_decodes_are_equal():
    datas = [_read(n) for n in FIXTURES]
    inline = port_native.decode_audio_codec_batch(None, datas, ["mp3"] * len(datas))
    pooled = port_native.decode_audio_codec_batch(port_native.shared_pool(4), datas,
                                                  ["mp3"] * len(datas))
    for a, b in zip(inline, pooled):
        np.testing.assert_array_equal(a[0], b[0])



def test_every_codec_in_one_batch_call():
    """A batch mixing MP3, Ogg Vorbis, FLAC and WAV decodes in one native
    call on the pool, each stream equal to its own decode, in the batch's
    order; a malformed stream names its sample and its codec."""
    from dali_tpu_torch.testdata import flac_writer
    from dali_tpu_torch.testdata.make_audio_corpus import wav_bytes

    pcm = np.random.default_rng(5).integers(-20000, 20000, 4000).astype(np.int16)
    datas = [_read(FIXTURES[0]), _read("vorbis_mono_16k.ogg"), flac_writer.encode(pcm),
             wav_bytes(pcm.tobytes()), _read(FIXTURES[-1])]
    got = port_audio.decode_audio_batch(port_native.shared_pool(4), datas)
    for d, (x, rate) in zip(datas, got):
        want, want_rate = port_audio.decode_audio(d)
        assert rate == want_rate
        np.testing.assert_array_equal(x, want)
    np.testing.assert_array_equal(got[2][0], got[3][0])
    with pytest.raises(ValueError, match=r"sample 2\): malformed FLAC"):
        port_audio.decode_audio_batch(None, datas[:2] + [datas[2][:-5]] + datas[3:])


# ------------------------------------------------------------------ through the pipelines

PIPE_FILES = ["mp3_mpeg1_48k_mono_cbr64.mp3", "mp3_mpeg1_44k_joint_cbr128.mp3",
              "mp3_mpeg2_16k_mono.mp3", "mp3_mpeg25_11k_joint.mp3", "mp3_mpeg2_22k_joint.mp3",
              "mp3_mpeg1_44k_stereo_vbr.mp3"]


@pytest.fixture(scope="module")
def mp3_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp3_files")
    os.makedirs(root / "a")
    for name in PIPE_FILES:
        shutil.copy(os.path.join(CODECS, name), root / "a" / name)
    return str(root)


def _shutdown(pipe):
    (pipe.shutdown if isinstance(pipe, dali_tpu_torch.Pipeline) else pipe._executor.shutdown)()


def _samples(tl):
    tl = tl.as_cpu() if hasattr(tl, "as_cpu") else tl
    return [np.asarray(tl.at(i)) for i in range(len(tl))]


def _run(pkg, graph, batch, iters=1):
    kw = {"device": "cpu"} if pkg is dali_tpu_torch else {"debug": True}

    @pkg.pipeline_def(batch_size=batch, num_threads=2, seed=7, **kw)
    def p():
        return graph(pkg)

    pipe = p()
    pipe.build()
    try:
        return [[_samples(o) for o in pipe.run()] for _ in range(iters)]
    finally:
        _shutdown(pipe)


@pytest.mark.parametrize("downmix,dtype,rate", [(False, "FLOAT", 0.0), (True, "FLOAT", 0.0),
                                               (True, "INT16", 0.0), (False, "INT16", 0.0),
                                               (True, "FLOAT", 16000.0)])
def test_decoders_audio_matches_dali_tpu(mp3_dir, downmix, dtype, rate):
    """decoders.audio over a ragged batch of MP3 forms in both packages:
    float within the full-accuracy bounds (after scipy's resample too);
    INT16 within one step, the fraction of samples that differ printed."""
    def graph(pkg):
        enc, _ = pkg.fn.readers.file(file_root=mp3_dir, file_filters=["*.mp3"], name="R")
        return pkg.fn.decoders.audio(enc, downmix=downmix, dtype=getattr(pkg.types, dtype),
                                     sample_rate=rate)

    (port_audio_, port_rates), = _run(dali_tpu_torch, graph, len(PIPE_FILES))
    (ref_audio_, ref_rates), = _run(dali_tpu, graph, len(PIPE_FILES))
    differ = total = 0
    for g, w, gr, wr in zip(port_audio_, ref_audio_, port_rates, ref_rates):
        assert g.dtype == w.dtype and g.shape == w.shape and gr == wr
        if dtype == "INT16":
            d = np.abs(g.astype(np.int32) - w)
            assert d.max() <= 1
            differ += int(np.count_nonzero(d))
            total += d.size
        else:
            _assert_within((g, 0), (w, 0), "decoders.audio")
    if dtype == "INT16":
        print(f"INT16: {differ} of {total} samples ({differ / total:.2e}) one step apart")


def _mel(pkg, audio):
    fn = pkg.fn
    audio = fn.preemphasis_filter(audio, preemph_coeff=0.97)
    spec = fn.spectrogram(audio, nfft=512, window_length=320, window_step=160)
    mel = fn.mel_filter_bank(spec, sample_rate=16000.0, nfilter=80)
    return fn.to_decibels(mel, multiplier=10.0, cutoff_db=-80.0)


def test_mel_graph_on_the_reference_pcm():
    """The ASR mel graph fed the reference's decoded PCM (downmixed) through
    external_source: dB within 1e-3 dB of dali_tpu's, the ASR contract."""
    pcm = [ref_native.audio_decode(_read(n))[0] for n in PIPE_FILES]
    pcm = [x.mean(axis=1).astype(np.float32) if x.ndim == 2 else x for x in pcm]

    def graph(pkg):
        return _mel(pkg, pkg.fn.external_source(source=lambda: pcm, batch=True)),

    (g,), = _run(dali_tpu_torch, graph, len(pcm))
    (w,), = _run(dali_tpu, graph, len(pcm))
    worst = max(float(np.abs(a - b).max()) for a, b in zip(g, w))
    print(f"mel graph on the reference PCM: dB max diff {worst:.2e}")
    assert worst <= 1e-3


def test_asr_mel_graph_with_the_decode(mp3_dir):
    """readers.file -> decoders.audio (downmix) -> the ASR mel graph, a
    ragged batch of MP3 forms in both packages: the same shapes, dB within
    5e-3 dB (the decodes' 1e-6 differences seen through the log of the
    quietest bins)."""
    def graph(pkg):
        enc, _ = pkg.fn.readers.file(file_root=mp3_dir, file_filters=["*.mp3"], name="R",
                                     random_shuffle=True, seed=3)
        audio, _ = pkg.fn.decoders.audio(enc, downmix=True, dtype=pkg.types.FLOAT)
        return _mel(pkg, audio),

    got = _run(dali_tpu_torch, graph, 4, iters=2)
    want = _run(dali_tpu, graph, 4, iters=2)
    worst = 0.0
    for (g,), (w,) in zip(got, want):
        for a, b in zip(g, w):
            assert a.shape == b.shape
            worst = max(worst, float(np.abs(a - b).max()))
    print(f"asr mel graph with the MP3 decode: dB max diff {worst:.2e}")
    assert worst <= 5e-3


def test_nemo_asr_reads_mp3(tmp_path):
    """readers.nemo_asr over a manifest of MP3 clips, as decoders.audio:
    audio within the bounds, rates and text equal."""
    os.makedirs(tmp_path / "clips")
    with open(tmp_path / "manifest.json", "w") as f:
        for i, name in enumerate(PIPE_FILES[:4]):
            shutil.copy(os.path.join(CODECS, name), tmp_path / "clips" / name)
            x, rate = ref_native.audio_decode(_read(name))
            f.write(json.dumps({"audio_filepath": f"clips/{name}", "text": f"clip {i}",
                                "duration": len(x) / rate}) + "\n")

    def graph(pkg):
        return pkg.fn.readers.nemo_asr(manifest_filepaths=[str(tmp_path / "manifest.json")],
                                       read_sample_rate=True, read_text=True, downmix=False,
                                       name="Reader")

    got = _run(dali_tpu_torch, graph, 2, iters=2)
    want = _run(dali_tpu, graph, 2, iters=2)
    for (ga, gr, gt), (wa, wr, wt) in zip(got, want):
        for a, b, r1, r2, t1, t2 in zip(ga, wa, gr, wr, gt, wt):
            _assert_within((a, float(r1)), (b, float(r2)), "nemo_asr")
            np.testing.assert_array_equal(t1, t2)


@pytest.mark.parametrize("tag", ["vbri", "vbri_without_counts", "xing_without_counts"])
def test_vbri_and_empty_xing_frames(tag):
    """A first frame holding a Fraunhofer VBRI tag yields no audio and no
    trimming; a VBRI or Xing tag giving neither a frame count nor a stream
    size leaves its frame to be decoded as audio, as FFmpeg's demuxer
    does."""
    data = _read("mp3_no_lame_frame.mp3")
    m = Mp3Frames(data)
    first = m.frames[0]
    frame = bytearray(data[first["offset"]:first["offset"] + first["size"]])
    frame[4:] = bytes(len(frame) - 4)
    if tag.startswith("vbri"):
        counts = (0, 0) if tag == "vbri_without_counts" else (len(data), len(m.frames))
        frame[36:54] = (b"VBRI" + (1).to_bytes(2, "big") + bytes(4)
                        + counts[0].to_bytes(4, "big") + counts[1].to_bytes(4, "big"))
    else:
        frame[4 + 17:4 + 17 + 8] = b"Xing" + bytes(4)
    _same_outcome(data[:first["offset"]] + bytes(frame) + data[first["offset"]:], tag)


@pytest.mark.parametrize("seed", range(4))
def test_mutated_streams_raise_only_value_errors(seed):
    """Bytes of the fixtures flipped, overwritten or cut: the decoder
    returns finite float32 or raises ValueError (NotImplementedError where
    a first header turns into another layer), never anything else."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        data = bytearray(_read(FIXTURES[rng.integers(len(FIXTURES))]))
        for _ in range(rng.integers(1, 6)):
            data[rng.integers(len(data))] ^= 1 << int(rng.integers(8))
        if rng.integers(3) == 0:
            data = data[:rng.integers(len(data))]
        try:
            x, _ = port_audio.decode_audio(bytes(data))
        except (ValueError, NotImplementedError):
            continue
        assert x.dtype == np.float32 and x.size > 0
