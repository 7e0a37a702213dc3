"""FLAC in dali_tpu_torch (ROADMAP.md Queue 1 item 4): the native decoder
(``csrc/host/flac_decode.cc``) against the port's WAV parser on the same
PCM, over every form the decoder covers, written by the numpy encoder
``testdata/flac_writer.py``.

FLAC is lossless, so the tolerance is bit-equality: each stream decodes to
exactly the float32 that the WAV of the same integer PCM decodes to
(sample / 2^(bits - 1), as the reference's FFmpeg path gives it). The
reference's FFmpeg path is not built on this machine, so the ASR front end
on FLAC is held against the same front end on WAV, bit-equal, and the WAV
front end against dali_tpu in ``test_torch_audio.py``. So that the writer
and the decoder cannot share a misreading of RFC 9639, FFmpeg 5's own FLAC
decoder (``libavcodec.so.59`` through ctypes, its CRC checks on) decodes
every form the writer emits, but the ID3 prefix, which FFmpeg's demuxer
and not its decoder skips, to the same PCM; those tests skip where that
library is missing. Mutated streams raise only ValueError, as
``tests/test_fuzz_parsers.py`` asks of the reference's decoder.
"""

import ctypes
import os
import struct

import numpy as np
import pytest

import dali_tpu_torch
from dali_tpu_torch.backend import audio as port_audio
from dali_tpu_torch.testdata import flac_writer
from dali_tpu_torch.testdata.make_audio_corpus import (speech_clip, to_int16, wav_bytes,
                                                       write_corpus)

RNG = np.random.default_rng(41)


def _pcm(n, channels=1, bits=16, seed=0):
    """Speech-like integer PCM at ``bits``, channels differing."""
    rng = np.random.default_rng(seed)
    scale = float(1 << (bits - 1)) * 0.6
    cols = [np.clip(np.round(speech_clip(rng, n / 16000.0)[:n] * 2.5 * scale
                             * (1.0 - 0.1 * c)), -scale, scale) for c in range(channels)]
    x = np.stack(cols, 1).astype(np.int64)
    return x[:, 0] if channels == 1 else x


def _wav_of(pcm, bits, rate=16000):
    """A WAV holding the same samples: 8-bit unsigned, 16-bit, and 20- or
    24-bit in a 24-bit container (20-bit samples shifted up by 4)."""
    x = np.asarray(pcm, np.int64)
    ch = 1 if x.ndim == 1 else x.shape[1]
    if bits == 8:
        raw = (x + 128).astype(np.uint8).tobytes()
    elif bits == 16:
        raw = x.astype("<i2").tobytes()
    else:
        v = (x << (24 - bits)).astype("<i4").reshape(-1)
        raw = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], 1).astype(np.uint8).tobytes()
    return wav_bytes(raw, rate, ch, 8 if bits == 8 else 16 if bits == 16 else 24)


def _round_trip(pcm, bits=16, rate=16000, **kw):
    data = flac_writer.encode(pcm, rate, bits, **kw)
    got, got_rate = port_audio.decode_audio(data)
    want, want_rate = port_audio.decode_wav(_wav_of(pcm, bits, rate))
    assert got_rate == want_rate == rate
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return data


@pytest.mark.parametrize("bits", [8, 16, 20, 24])
def test_bit_depths(bits):
    _round_trip(_pcm(6000, bits=bits, seed=bits), bits)


@pytest.mark.parametrize("bits", [8, 16, 24])
def test_bits_from_streaminfo(bits):
    _round_trip(_pcm(3000, bits=bits, seed=3), bits, bits_from_streaminfo=True)


@pytest.mark.parametrize("channels", range(1, 9))
def test_independent_channels(channels):
    data = _round_trip(_pcm(2500, channels, seed=channels), channels="independent")
    assert (data[data.index(b"fLaC") + 42 + 3] >> 4) == channels - 1  # first frame's code


@pytest.mark.parametrize("mode", ["independent", "left_side", "right_side", "mid_side"])
@pytest.mark.parametrize("bits", [16, 24])
def test_stereo_decorrelation(mode, bits):
    _round_trip(_pcm(9000, 2, bits=bits, seed=7), bits, channels=mode)


SUBFRAMES = ([("constant", None), ("verbatim", None)]
             + [("fixed", k) for k in range(5)]
             + [("lpc", k) for k in (1, 2, 3, 5, 8, 12, 16, 24, 32)])


@pytest.mark.parametrize("kind,order", SUBFRAMES, ids=[f"{k}{'' if o is None else o}"
                                                       for k, o in SUBFRAMES])
def test_subframe_types(kind, order):
    pcm = np.full(4096, -1234, np.int64) if kind == "constant" else _pcm(8192, seed=11)
    _round_trip(pcm, subframe=kind, order=order)


@pytest.mark.parametrize("precision", [2, 7, 12, 15])
def test_lpc_precisions(precision):
    _round_trip(_pcm(8192, seed=13), subframe="lpc", order=8, precision=precision)


@pytest.mark.parametrize("kind", ["verbatim", "fixed", "lpc", "constant"])
def test_wasted_bits(kind):
    pcm = (np.full(4096, 37, np.int64) if kind == "constant" else _pcm(8192, seed=5) >> 3) << 3
    _round_trip(pcm, subframe=kind, order=2 if kind != "constant" else None)
    stereo = np.stack([pcm, (pcm * 3) // 4 & ~np.int64(3)], 1)  # different wasted bits per channel
    _round_trip(stereo, channels="left_side")


@pytest.mark.parametrize("rice2", [False, True])
@pytest.mark.parametrize("escape", [False, True])
@pytest.mark.parametrize("max_partition_order", [0, 3, 8])
def test_residual_codings(rice2, escape, max_partition_order):
    _round_trip(_pcm(8192, seed=17), subframe="lpc", order=6, rice2=rice2, escape=escape,
                max_partition_order=max_partition_order)


def test_rice2_large_parameters():
    """Residuals of 2^20: Rice parameters above 14 need Rice2."""
    rng = np.random.default_rng(3)
    pcm = rng.integers(-(1 << 22), 1 << 22, 4096)
    _round_trip(pcm, 24, subframe="fixed", order=0, rice2=True)


BLOCKS = ([192, 576, 1152, 2304, 4608] + [256 << k for k in range(8)])


@pytest.mark.parametrize("size", BLOCKS)
def test_block_size_codes(size):
    _round_trip(_pcm(max(2 * size + 100, 3000), seed=19), block_size=size)


@pytest.mark.parametrize("code,size", [(6, 1), (6, 100), (6, 256), (7, 257), (7, 1000),
                                       (7, 65535)])
def test_explicit_block_sizes(code, size):
    _round_trip(_pcm(size + 50, seed=23), block_size=size, block_code=code)


def test_variable_block_sizes():
    """Blocking strategy 1 (sample numbers in the headers), sizes cycling."""
    _round_trip(_pcm(20000, 2, seed=29), block_size=[1000, 4096, 17, 2304, 333])


RATES = [(88200, None), (176400, None), (192000, None), (8000, None), (16000, None),
         (22050, None), (24000, None), (32000, None), (44100, None), (48000, None),
         (96000, None), (11000, 12), (11025, 13), (37800, 14), (12345, 0)]


@pytest.mark.parametrize("rate,code", RATES, ids=[f"{r}-{c}" for r, c in RATES])
def test_sample_rate_codes(rate, code):
    _round_trip(_pcm(2000, seed=31), rate=rate, rate_code=code)


@pytest.mark.parametrize("blocks", [("padding",), ("seektable", "vorbis_comment"),
                                    ("application", "picture", "padding")])
@pytest.mark.parametrize("id3", [False, True])
def test_metadata_blocks_and_id3(blocks, id3):
    _round_trip(_pcm(5000, 2, seed=37), metadata=blocks, id3=id3)


def test_frame_numbers_past_one_byte():
    """Fixed block size: frame numbers from 128 on take two coded bytes."""
    _round_trip(_pcm(192 * 300, seed=43), block_size=192)


def test_default_encoding_is_the_ffmpeg_form():
    """The default stream: 4096-sample blocks, LPC subframes (type 0b1xxxxx)
    of order at most 8, mid/side or another decorrelation for stereo."""
    pcm = _pcm(40000, 2, seed=47)
    data = _round_trip(pcm)
    first = data.index(b"fLaC") + 4 + 4 + 34
    assert data[first:first + 2] == b"\xff\xf8" and data[first + 2] >> 4 == 12  # 4096
    assert data[first + 3] >> 4 in (1, 8, 9, 10)


# ------------------------------------------------------------------ errors


def test_crc_failures_raise_value_error():
    data = bytearray(flac_writer.encode(_pcm(5000, seed=53), 16000, 16))
    first = data.index(b"fLaC") + 4 + 4 + 34
    for pos in (first + 3, len(data) - 1, len(data) // 2):
        bad = bytearray(data)
        bad[pos] ^= 0x10
        with pytest.raises(ValueError):
            port_audio.decode_audio(bytes(bad))


def _mutations(data: bytes, rng, n: int):
    """Truncations, byte flips, a corrupted dword, a duplicated slice, and a
    junk prefix or suffix (the kinds of ``tests/test_fuzz_parsers.py``)."""
    ln = len(data)
    for i in range(n):
        kind = i % 5
        b = bytearray(data)
        if kind == 0:
            yield bytes(b[:int(rng.integers(0, ln + 1))])
        elif kind == 1:
            for _ in range(int(rng.integers(1, 8))):
                b[int(rng.integers(0, ln))] ^= int(rng.integers(1, 256))
            yield bytes(b)
        elif kind == 2:
            pos = int(rng.integers(0, max(ln - 4, 1)))
            b[pos:pos + 4] = struct.pack("<I", int(rng.integers(0, 1 << 32)))
            yield bytes(b)
        elif kind == 3:
            lo = int(rng.integers(0, ln))
            hi = int(rng.integers(lo, min(lo + 64, ln)))
            yield bytes(b[:hi] + b[lo:hi] + b[hi:])
        else:
            junk = rng.integers(0, 256, int(rng.integers(1, 32)), np.uint8).tobytes()
            yield junk + bytes(b) if i % 2 else bytes(b) + junk


@pytest.mark.parametrize("form", ["default", "stereo_escape_rice2", "fixed_variable"])
def test_fuzz_mutated_streams_raise_only_value_error(form):
    kw = {"default": {},
          "stereo_escape_rice2": {"channels": "mid_side", "escape": True, "rice2": True},
          "fixed_variable": {"subframe": "fixed", "block_size": [300, 700]}}[form]
    pcm = _pcm(3000, 2 if form == "stereo_escape_rice2" else 1, seed=59)
    data = flac_writer.encode(pcm, 16000, 16, metadata=("padding",), **kw)
    rng = np.random.default_rng(61)
    for blob in _mutations(data, rng, 400):
        try:
            x, _ = port_audio.decode_audio(blob)
            assert x.dtype == np.float32
        except ValueError:
            pass


def test_batch_decode_on_the_task_pool():
    """A batch of FLAC streams decodes in one native call on a worker pool,
    each equal to its one-stream decode; a bad stream names its sample."""
    from dali_tpu_torch import native

    datas = [flac_writer.encode(_pcm(3000 + 500 * i, 1 + i % 2, seed=i), 16000, 16)
             for i in range(6)]
    pool = native.TaskPool(3)
    try:
        got = port_audio.decode_audio_batch(pool, datas)
        for d, (x, rate) in zip(datas, got):
            want, want_rate = port_audio.decode_audio(d)
            assert rate == want_rate
            np.testing.assert_array_equal(x, want)
        with pytest.raises(ValueError, match="sample 2"):
            port_audio.decode_audio_batch(pool, datas[:2] + [datas[2][:-5]])
    finally:
        pool.close()


# ------------------------------------------------------------------ FFmpeg's decoder


def _ffmpeg():
    """FFmpeg 5's libavcodec and libavutil through ctypes (the layouts read
    below are FFmpeg 5's: AVCodec.id, AVPacket.data, AVFrame.nb_samples and
    format), or None where they are not installed."""
    try:
        avc, avu = ctypes.CDLL("libavcodec.so.59"), ctypes.CDLL("libavutil.so.57")
    except OSError:
        return None
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for lib, name, res, args in [
            (avc, "avcodec_find_decoder_by_name", vp, [ctypes.c_char_p]),
            (avc, "avcodec_alloc_context3", vp, [vp]), (avc, "avcodec_open2", i32, [vp, vp, vp]),
            (avc, "av_parser_init", vp, [i32]),
            (avc, "av_parser_parse2", i32, [vp, vp, ctypes.POINTER(vp), ctypes.POINTER(i32), vp,
                                            i32, i64, i64, i64]),
            (avc, "av_packet_alloc", vp, []), (avc, "av_new_packet", i32, [vp, i32]),
            (avc, "avcodec_send_packet", i32, [vp, vp]),
            (avc, "avcodec_receive_frame", i32, [vp, vp]), (avc, "av_packet_unref", None, [vp]),
            (avc, "av_parser_close", None, [vp]),
            (avc, "avcodec_free_context", None, [ctypes.POINTER(vp)]),
            (avc, "av_packet_free", None, [ctypes.POINTER(vp)]),
            (avu, "av_frame_alloc", vp, []), (avu, "av_frame_unref", None, [vp]),
            (avu, "av_frame_free", None, [ctypes.POINTER(vp)]),
            (avu, "av_opt_set", i32, [vp, ctypes.c_char_p, ctypes.c_char_p, i32])]:
        getattr(lib, name).restype, getattr(lib, name).argtypes = res, args
    return avc, avu


FFMPEG = _ffmpeg()
needs_ffmpeg = pytest.mark.skipif(FFMPEG is None, reason="needs FFmpeg 5's libavcodec.so.59")


def _ffmpeg_decode(data: bytes, channels: int) -> np.ndarray:
    """``data`` through FFmpeg's FLAC parser and decoder with its CRC checks
    on (``err_detect=crccheck+explode``), as float32 [n, channels]: each
    sample over 2^15 or 2^31, the top of FFmpeg's s16/s32 outputs, which is
    what swresample's FLT gives the reference. Raises ValueError where
    FFmpeg reports an error."""
    avc, avu = FFMPEG
    vp = ctypes.c_void_p
    codec = avc.avcodec_find_decoder_by_name(b"flac")
    ctx = vp(avc.avcodec_alloc_context3(codec))
    assert avu.av_opt_set(ctx, b"err_detect", b"crccheck+explode", 0) == 0
    assert avc.avcodec_open2(ctx, codec, None) == 0
    parser = avc.av_parser_init(ctypes.cast(codec, ctypes.POINTER(ctypes.c_int))[5])
    pkt, frame = vp(avc.av_packet_alloc()), vp(avu.av_frame_alloc())
    buf = ctypes.create_string_buffer(data + bytes(64), len(data) + 64)  # the input padding
    out, pos = [], 0

    def check(ret):
        if ret < 0:
            raise ValueError(f"FFmpeg error {ret}")

    def drain():
        while avc.avcodec_receive_frame(ctx, frame) == 0:
            n, fmt = ctypes.cast(frame, ctypes.POINTER(ctypes.c_int))[28:30]
            planes = ctypes.cast(frame, ctypes.POINTER(vp))
            wide = fmt in (2, 7)  # s32, s32p; else s16, s16p
            ct = ctypes.c_int32 if wide else ctypes.c_int16
            if fmt in (6, 7):
                x = np.stack([np.ctypeslib.as_array(ctypes.cast(planes[c], ctypes.POINTER(ct)),
                                                    (n,)) for c in range(channels)], 1)
            else:
                x = np.ctypeslib.as_array(ctypes.cast(planes[0], ctypes.POINTER(ct)),
                                          (n * channels,)).reshape(n, channels)
            out.append((x / (2.0 ** 31 if wide else 2.0 ** 15)).astype(np.float32))
            avu.av_frame_unref(frame)

    try:
        while True:
            got, size = vp(), ctypes.c_int()
            used = avc.av_parser_parse2(parser, ctx, ctypes.byref(got), ctypes.byref(size),
                                        ctypes.addressof(buf) + pos, len(data) - pos,
                                        -1 << 63, -1 << 63, 0)
            at_end = pos == len(data)
            pos += used
            if size.value > 0:
                check(avc.av_new_packet(pkt, size.value))
                ctypes.memmove(ctypes.cast(pkt, ctypes.POINTER(vp))[3], got, size.value)
                ret = avc.avcodec_send_packet(ctx, pkt)
                avc.av_packet_unref(pkt)
                check(ret)
                drain()
            elif at_end:
                break
        check(avc.avcodec_send_packet(ctx, None))
        drain()
    finally:
        avc.av_parser_close(parser)
        avc.avcodec_free_context(ctypes.byref(ctx))
        avc.av_packet_free(ctypes.byref(pkt))
        avu.av_frame_free(ctypes.byref(frame))
    return np.concatenate(out) if out else np.zeros((0, channels), np.float32)


FFMPEG_FORMS = dict(
    [(f"bits{b}", (lambda b=b: _pcm(6000, bits=b, seed=b), b, {})) for b in (8, 16, 20, 24)]
    + [(f"streaminfo_bits{b}", (lambda b=b: _pcm(3000, bits=b, seed=3), b,
                                {"bits_from_streaminfo": True})) for b in (8, 16, 24)]
    + [(f"channels{c}", (lambda c=c: _pcm(2500, c, seed=c), 16, {"channels": "independent"}))
       for c in range(1, 9)]
    + [(f"{m}{b}", (lambda b=b: _pcm(9000, 2, bits=b, seed=7), b, {"channels": m}))
       for m in ("left_side", "right_side", "mid_side") for b in (16, 24)]
    + [(f"{k}{'' if o is None else o}", (
        (lambda: np.full(4096, -1234, np.int64)) if k == "constant" else
        (lambda: _pcm(8192, seed=11)), 16, {"subframe": k, "order": o})) for k, o in SUBFRAMES]
    + [(f"lpc_precision{p}", (lambda: _pcm(8192, seed=13), 16,
                              {"subframe": "lpc", "order": 8, "precision": p}))
       for p in (2, 7, 12, 15)]
    + [(f"wasted_{k}", (lambda: (_pcm(8192, seed=5) >> 3) << 3, 16,
                        {"subframe": k, "order": 2 if k != "verbatim" else None}))
       for k in ("verbatim", "fixed", "lpc")]
    + [("wasted_stereo", (lambda: np.stack([(_pcm(8192, seed=5) >> 3) << 3,
                                            (((_pcm(8192, seed=5) >> 3) << 3) * 3) // 4
                                            & ~np.int64(3)], 1), 16,
                          {"channels": "left_side"}))]
    + [(f"residual_rice{2 if r2 else 1}{'_escape' if esc else ''}_order{o}", (
        lambda: _pcm(8192, seed=17), 16, {"subframe": "lpc", "order": 6, "rice2": r2,
                                          "escape": esc, "max_partition_order": o}))
       for r2 in (False, True) for esc in (False, True) for o in (0, 3, 8)]
    + [("rice2_large", (lambda: np.random.default_rng(3).integers(-(1 << 22), 1 << 22, 4096),
                        24, {"subframe": "fixed", "order": 0, "rice2": True}))]
    + [(f"block{b}", (lambda b=b: _pcm(max(2 * b + 100, 3000), seed=19), 16, {"block_size": b}))
       for b in BLOCKS]
    + [(f"block_code{c}_{b}", (lambda b=b: _pcm(b + 50, seed=23), 16,
                                {"block_size": b, "block_code": c}))
       for c, b in ((6, 100), (6, 256), (7, 257), (7, 1000), (7, 65535))]
    + [("variable_blocks", (lambda: _pcm(20000, 2, seed=29), 16,
                            {"block_size": [1000, 4096, 17, 2304, 333]}))]
    + [(f"rate{r}_{c}", (lambda: _pcm(2000, seed=31), 16, {"rate": r, "rate_code": c}))
       for r, c in RATES]
    + [("metadata", (lambda: _pcm(5000, 2, seed=37), 16,
                     {"metadata": ("application", "picture", "seektable", "vorbis_comment",
                                   "padding")}))]
    + [("frame_numbers", (lambda: _pcm(192 * 300, seed=43), 16, {"block_size": 192}))]
    + [("default_stereo", (lambda: _pcm(40000, 2, seed=47), 16, {}))])


@needs_ffmpeg
@pytest.mark.parametrize("form", sorted(FFMPEG_FORMS))
def test_ffmpeg_decodes_the_writers_streams_alike(form):
    """An independent reading of RFC 9639: FFmpeg's FLAC decoder, its CRC
    checks on, decodes each form the writer emits to exactly the PCM given
    and to what the port's decoder returns. Bit-equal."""
    make, bits, kw = FFMPEG_FORMS[form]
    pcm = make()
    kw = dict(kw)
    rate = kw.pop("rate", 16000)
    data = flac_writer.encode(pcm, rate, bits, **kw)
    x = np.asarray(pcm, np.int64).reshape(len(pcm), -1)
    got = _ffmpeg_decode(data, x.shape[1])
    np.testing.assert_array_equal(got, (x / 2.0 ** (bits - 1)).astype(np.float32))
    mine, mine_rate = port_audio.decode_audio(data)
    assert mine_rate == rate
    np.testing.assert_array_equal(mine.reshape(got.shape), got)


@needs_ffmpeg
def test_ffmpeg_checks_the_writers_crcs():
    """The CRC-16 of a frame and the CRC-8 of its header are FFmpeg's: a
    flipped bit in a frame's last byte (the CRC-16) or in a header byte
    fails there, as in the port."""
    data = flac_writer.encode(_pcm(5000, seed=53), 16000, 16)
    first = data.index(b"fLaC") + 4 + 4 + 34
    assert _ffmpeg_decode(data, 1).shape == (5000, 1)
    for pos in (len(data) - 1, first + 4):
        bad = bytearray(data)
        bad[pos] ^= 0x10
        with pytest.raises(ValueError):
            _ffmpeg_decode(bytes(bad), 1)
        with pytest.raises(ValueError):
            port_audio.decode_audio(bytes(bad))


# ------------------------------------------------------------------ the ASR front end


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Twelve ragged clips of 0.5-1.25 s, as WAV and as FLAC of the same PCM."""
    root = tmp_path_factory.mktemp("flac_asr")
    return (write_corpus(str(root / "wav"), 12, 5, (0.5, 1.25)),
            write_corpus(str(root / "flac"), 12, 5, (0.5, 1.25), fmt="flac"))


def _asr(root, ext, device, decode_device):
    fn, types = dali_tpu_torch.fn, dali_tpu_torch.types

    @dali_tpu_torch.pipeline_def(batch_size=4, num_threads=2, seed=7, device=device)
    def asr_frontend():
        enc, _ = fn.readers.file(file_root=root, file_filters=[f"*.{ext}"], random_shuffle=True,
                                 name="R", seed=3)
        audio, rate = fn.decoders.audio(enc, dtype=types.FLOAT, downmix=True,
                                        device=decode_device)
        audio = fn.preemphasis_filter(audio, preemph_coeff=0.97)
        spec = fn.spectrogram(audio, nfft=512, window_length=320, window_step=160)
        mel = fn.mel_filter_bank(spec, sample_rate=16000.0, nfilter=80)
        db = fn.to_decibels(mel, multiplier=10.0, cutoff_db=-80.0)
        return db, fn.normalize(db, axes=[1]), rate

    pipe = asr_frontend()
    pipe.build()
    outs = []
    try:
        for _ in range(3):
            res = pipe.run()
            outs.append([[np.asarray(t.at(i)) for i in range(len(t))]
                         for t in (o.as_cpu() if hasattr(o, "as_cpu") else o for o in res)])
    finally:
        pipe.shutdown()
    return outs


@pytest.mark.parametrize("decode_device", ["cpu", "mixed"])
def test_asr_frontend_on_flac_equals_wav(corpora, decode_device):
    """bench.py's asr_frontend at batch 4, three iterations: the FLAC corpus
    gives the WAV corpus's dB mel and normalized features, bit-equal."""
    wav, flac = corpora
    got = _asr(flac, "flac", "cpu", decode_device)
    want = _asr(wav, "wav", "cpu", decode_device)
    for g_it, w_it in zip(got, want):
        for g_out, w_out in zip(g_it, w_it):
            for g, w in zip(g_out, w_out):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)


def test_flac_corpus_holds_the_wav_corpus_pcm(corpora):
    wav, flac = corpora
    names = sorted(os.listdir(os.path.join(wav, "clips")))
    assert len(names) == 12
    for name in names:
        with open(os.path.join(wav, "clips", name), "rb") as f:
            w, _ = port_audio.decode_audio(f.read())
        with open(os.path.join(flac, "clips", name[:-3] + "flac"), "rb") as f:
            g, _ = port_audio.decode_audio(f.read())
        np.testing.assert_array_equal(g, w)
        assert np.array_equal(to_int16(w), np.round(w * 32768).astype(np.int16))
