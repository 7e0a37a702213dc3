"""Audio operators (counterpart of ``dali_tpu/backend/audio.py``): WAV decode,
the mixed decode split (host decode + device dtype conversion), preemphasis,
spectrogram, mel filter bank, MFCC, decibels and the nonsilent region.

The device ops run on the padded canvas of a ragged batch and take every
border and every reduction against each sample's valid extent, so a padded
sample gives the values its unpadded self gives. ``Spectrogram``,
``MelFilterBank`` and ``MFCC`` on the device also infer their output shapes
on the host, so nothing is read back per batch. Compressed containers
(FLAC/OGG/MP3) and ``experimental.AudioResample`` are not ported.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch, HostBatch
from ..kernels import signal as sig
from ..types import DALIDataType, to_numpy_type
from .base import Operator

# ====================================== decoders.Audio ============================================


def decode_wav(data: bytes):
    """Minimal RIFF/WAVE decoder: PCM 8/16/24/32-bit and IEEE float, to
    float32 in [-1, 1) ([n] or [n, channels]) and the sample rate."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("Not a WAV file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError("Malformed WAV: missing fmt/data chunk")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE, read as PCM (as the reference does)
        audio_format = 1
    if audio_format == 1:
        if bits == 8:
            x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            v = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int32) << 16))
            v = np.where(v >= 1 << 23, v - (1 << 24), v)
            x = v.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(raw, np.int32).astype(np.float32) / float(1 << 31)
        else:
            raise ValueError(f"Unsupported PCM bit depth {bits}")
    elif audio_format == 3:
        x = np.frombuffer(raw, np.float32 if bits == 32 else np.float64).astype(np.float32)
    else:
        raise ValueError(f"Unsupported WAV format {audio_format}")
    if channels > 1:
        x = x.reshape(-1, channels)
    return x, float(sample_rate)


def decode_audio(data: bytes):
    """WAV through the built-in parser. Any other container raises: the
    reference decodes FLAC/OGG/MP3 with a native FFmpeg decoder that the port
    does not build."""
    if data[:4] == b"RIFF":
        return decode_wav(data)
    raise NotImplementedError(
        "only WAV audio is ported to dali_tpu_torch; compressed containers (FLAC/OGG/MP3) "
        "are not yet, see ROADMAP.md (Queue 1)")


DALI_SCHEMA("decoders.Audio").DocStr(
    """Decodes audio (WAV). Outputs (audio, sample_rate)."""
).NumInput(1).NumOutput(2).Devices("cpu").AddOptionalArg(
    "sample_rate", ArgType.FLOAT, "Resample to this rate (0 = keep).", 0.0, tensor_ok=True
).AddOptionalArg(
    "downmix", ArgType.BOOL, "Downmix to mono.", False
).AddOptionalArg(
    "dtype", ArgType.DATA_TYPE, "Output dtype (FLOAT: [-1,1]; INT16: raw).", DALIDataType.FLOAT
).AddOptionalArg("quality", ArgType.FLOAT, "Resampling quality (0..100).", 50.0)


def _resample_audio(x: np.ndarray, in_rate: float, out_rate: float) -> np.ndarray:
    """Polyphase windowed-sinc resampling (scipy), as the reference."""
    if abs(in_rate - out_rate) < 1e-9:
        return x
    from fractions import Fraction

    import scipy.signal

    frac = Fraction(out_rate / in_rate).limit_denominator(10000)
    return scipy.signal.resample_poly(x, frac.numerator, frac.denominator, axis=0).astype(np.float32)


@register_operator("decoders.Audio", "cpu")
class AudioDecoderCPU(Operator):
    def _decode(self, ctx, idx, encoded):
        """float32 PCM after downmix and resampling, and its rate."""
        x, rate = decode_audio(np.ascontiguousarray(encoded).tobytes())
        if self.spec.GetArgument("downmix") and x.ndim == 2:
            x = x.mean(axis=1)
        target = float(np.asarray(ctx.arg(self, "sample_rate", idx, 0.0)))
        if target > 0:
            x = _resample_audio(x, rate, target)
            rate = target
        return x, np.float32(rate)

    def run_sample(self, ctx, idx, encoded):
        x, rate = self._decode(ctx, idx, encoded)
        dt = self.spec.GetArgument("dtype")
        if dt == DALIDataType.INT16:
            return np.clip(np.round(x * 32767.0), -32768, 32767).astype(np.int16), rate
        return x.astype(to_numpy_type(dt)), rate

    def output_layout(self, output_idx, inputs):
        return "" if output_idx else "t"


# Mixed decode: the host decodes, the device holds the output. With dtype
# FLOAT and PCM that is exactly int16/32768 in EVERY sample of the batch (a
# 16-bit source), the samples cross as int16 and the device divides: half the
# bytes of the host->device copy.

DALI_SCHEMA("_AudioStage").DocStr(
    "Host half of the mixed audio decode: decoded PCM staged at wire "
    "precision (int16 when exact) + per-sample rate."
).NumInput(1).NumOutput(2).Devices("mixed").MakeInternal().AddOptionalArg(
    "sample_rate", ArgType.FLOAT, "Resample to this rate (0 = keep).", 0.0, tensor_ok=True
).AddOptionalArg(
    "downmix", ArgType.BOOL, "Downmix to mono.", False
).AddOptionalArg(
    "dtype", ArgType.DATA_TYPE, "Requested output dtype.", DALIDataType.FLOAT
).AddOptionalArg("quality", ArgType.FLOAT, "Resampling quality (0..100).", 50.0)


@register_operator("_AudioStage", "mixed")
class AudioStageMixed(AudioDecoderCPU):
    def run_batch(self, ctx, inp):
        as_float = self.spec.GetArgument("dtype") == DALIDataType.FLOAT
        outs = [self._stage_one(ctx, i, s, as_float) for i, s in enumerate(inp.samples)]
        wire16 = as_float and all(o[2] is not None for o in outs)
        pcm = [o[2] if wire16 else o[0] for o in outs]
        return [HostBatch(pcm, layout=self.output_layout(0, None)),
                HostBatch([o[1] for o in outs], layout="")]

    def _stage_one(self, ctx, idx, encoded, as_float):
        """(PCM at the requested precision, rate, its int16 form or None).
        The exactness test runs here, per sample."""
        x, rate = self._decode(ctx, idx, encoded)
        dt = self.spec.GetArgument("dtype")
        if dt == DALIDataType.INT16:
            x = np.clip(np.round(x * 32767.0), -32768, 32767).astype(np.int16)
        elif not as_float:
            x = x.astype(to_numpy_type(dt))
        as16 = None
        if as_float:
            s = x * np.float32(32768.0)
            if np.array_equal(np.clip(np.rint(s), -32768, 32767), s):
                as16 = s.astype(np.int16)
        return np.ascontiguousarray(x), rate, as16


DALI_SCHEMA("_AudioToOutput").DocStr(
    "Device half of the mixed audio decode: converts wire-precision PCM to "
    "the requested dtype (int16 wire -> float/32768 on device)."
).NumInput(1).NumOutput(1).Devices("gpu").MakeInternal().AddOptionalArg(
    "dtype", ArgType.DATA_TYPE, "Requested output dtype.", DALIDataType.FLOAT
)


@register_operator("_AudioToOutput", "gpu")
class AudioToOutput(Operator):
    def host_output_shapes(self, ctx, input_shapes, input_batches):
        return [input_shapes[0]]

    def lower(self, dctx, pcm: DeviceBatch):
        data = pcm.data
        if self.spec.GetArgument("dtype") == DALIDataType.FLOAT:
            data = data.to(torch.float32)
            if pcm.data.dtype == torch.int16:
                data = data * (1.0 / 32768.0)
        return [pcm.with_data(data)]


def _as_batch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))[None]


# ====================================== PreemphasisFilter ==========================================

DALI_SCHEMA("PreemphasisFilter").DocStr(
    "y[t] = x[t] - coeff * x[t-1]."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "preemph_coeff", ArgType.FLOAT, "Preemphasis coefficient.", 0.97, tensor_ok=True
).AddOptionalArg(
    "border", ArgType.STRING, "'clamp', 'zero' or 'reflect' first-sample handling.", "clamp"
).AddOptionalArg("dtype", ArgType.DATA_TYPE, "Output dtype.", DALIDataType.FLOAT)


@register_operator("PreemphasisFilter", "cpu")
class PreemphasisCPU(Operator):
    def run_sample(self, ctx, idx, x):
        coeff = float(np.asarray(ctx.arg(self, "preemph_coeff", idx, 0.97)))
        return sig.preemphasis(_as_batch(x), coeff, self.spec.GetArgument("border"))[0].numpy()


@register_operator("PreemphasisFilter", "gpu")
class PreemphasisGPU(Operator):
    def lower(self, dctx, inp: DeviceBatch):
        out = sig.preemphasis(inp.data, dctx.arg(self, "preemph_coeff", 0.97),
                              self.spec.GetArgument("border"))
        return [inp.with_data(out)]


# ====================================== Spectrogram ================================================

DALI_SCHEMA("Spectrogram").DocStr(
    "Power spectrogram, layout 'ft' (frequency bins x frames) or 'tf'."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "nfft", ArgType.INT, "FFT size (default window_length).", None
).AddOptionalArg(
    "window_length", ArgType.INT, "Window size in samples.", 512
).AddOptionalArg(
    "window_step", ArgType.INT, "Hop size in samples.", 256
).AddOptionalArg(
    "window_fn", ArgType.FLOAT_VEC, "Window coefficients (default Hann).", None
).AddOptionalArg(
    "power", ArgType.INT, "1 = magnitude, 2 = power.", 2
).AddOptionalArg(
    "center_windows", ArgType.BOOL, "Center windows on signal samples.", True
).AddOptionalArg(
    "reflect_padding", ArgType.BOOL, "Reflect-pad at boundaries.", True
).AddOptionalArg("layout", ArgType.TENSOR_LAYOUT, "'ft' or 'tf'.", "ft")


class _SpecCommon(Operator):
    def _params(self):
        wl = self.spec.GetArgument("window_length")
        wf = self.spec.GetArgument("window_fn", None)
        return dict(nfft=self.spec.GetArgument("nfft", None) or wl, window_length=wl,
                    window_step=self.spec.GetArgument("window_step"),
                    window=np.asarray(wf, np.float32) if wf else sig.hann_window(wl),
                    power=self.spec.GetArgument("power"),
                    center=self.spec.GetArgument("center_windows"),
                    reflect_pad=self.spec.GetArgument("reflect_padding"),
                    layout=self.spec.GetArgument("layout"))

    def output_layout(self, output_idx, inputs):
        return self.spec.GetArgument("layout")


@register_operator("Spectrogram", "cpu")
class SpectrogramCPU(_SpecCommon):
    def run_sample(self, ctx, idx, x):
        return sig.spectrogram(_as_batch(x.reshape(-1)), **self._params())[0].numpy()


@register_operator("Spectrogram", "gpu")
class SpectrogramGPU(_SpecCommon):
    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._window = {}  # device -> window tensor, built once

    def _frames(self, lens):
        p = self._params()
        if p["center"]:
            return lens // p["window_step"] + 1
        return (lens - p["window_length"]) // p["window_step"] + 1

    def _shapes(self, frames, stack, full_like):
        n_bins = self._params()["nfft"] // 2 + 1
        cols = [full_like(frames, n_bins), frames]
        return stack(cols if self.spec.GetArgument("layout") == "ft" else cols[::-1], 1)

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        if input_shapes[0] is None:
            return None
        frames = self._frames(np.asarray(input_shapes[0])[:, 0].astype(np.int64))
        return [self._shapes(frames, np.stack, np.full_like).astype(np.int32)]

    def lower(self, dctx, inp: DeviceBatch):
        lens = None if inp.shapes is None else inp.shapes[:, 0]
        params = self._params()
        dev = inp.data.device
        if dev not in self._window:
            self._window[dev] = torch.from_numpy(params["window"]).to(dev)
        params["window"] = self._window[dev]
        out = sig.spectrogram(inp.data.reshape(inp.data.shape[0], -1), valid_len=lens, **params)
        shapes = None
        if lens is not None:
            shapes = self._shapes(self._frames(lens), torch.stack, torch.full_like)
        return [DeviceBatch(out, shapes, self.spec.GetArgument("layout"))]


# ====================================== MelFilterBank ==============================================

DALI_SCHEMA("MelFilterBank").DocStr(
    "Projects a spectrogram ('ft') onto triangular mel filters (Slaney "
    "formula + normalization by default)."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "nfilter", ArgType.INT, "Number of mel bins.", 128
).AddOptionalArg(
    "sample_rate", ArgType.FLOAT, "Input audio sample rate.", 44100.0
).AddOptionalArg(
    "freq_low", ArgType.FLOAT, "Lowest frequency.", 0.0
).AddOptionalArg(
    "freq_high", ArgType.FLOAT, "Highest frequency (0 = Nyquist).", 0.0
).AddOptionalArg(
    "normalize", ArgType.BOOL, "Slaney area normalization.", True
).AddOptionalArg("mel_formula", ArgType.STRING, "'slaney' or 'htk'.", "slaney")


class _MelCommon(Operator):
    def _weights(self, n_bins):
        return sig.mel_filter_bank_matrix(
            self.spec.GetArgument("nfilter"), (n_bins - 1) * 2,
            self.spec.GetArgument("sample_rate"), self.spec.GetArgument("freq_low"),
            self.spec.GetArgument("freq_high") or None, self.spec.GetArgument("mel_formula"),
            self.spec.GetArgument("normalize"))


@register_operator("MelFilterBank", "cpu")
class MelFilterBankCPU(_MelCommon):
    def run_sample(self, ctx, idx, spec):
        return (self._weights(spec.shape[0]) @ spec.astype(np.float32)).astype(np.float32)


@register_operator("MelFilterBank", "gpu")
class MelFilterBankGPU(_MelCommon):
    """A float32 matmul of the [nfilter, bins] bank with every sample's
    [bins, frames] spectrogram; the bank is built once per bin count and
    device. Full float32 unless the caller turned on TF32 for matmuls
    (``torch.backends.cuda.matmul.allow_tf32``)."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._bank = {}

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        if input_shapes[0] is None:
            return None
        sh = np.asarray(input_shapes[0])
        return [np.stack([np.full_like(sh[:, 1], self.spec.GetArgument("nfilter")), sh[:, 1]],
                         1).astype(np.int32)]

    def lower(self, dctx, inp: DeviceBatch):
        x = inp.data.to(torch.float32)
        key = (x.shape[1], x.device)
        if key not in self._bank:
            self._bank[key] = torch.from_numpy(self._weights(x.shape[1])).to(x.device)
        out = torch.matmul(self._bank[key], x)
        shapes = None
        if inp.shapes is not None:
            shapes = torch.stack([torch.full_like(inp.shapes[:, 1], out.shape[1]),
                                  inp.shapes[:, 1]], 1)
        return [DeviceBatch(out, shapes, inp.layout)]


# ====================================== MFCC ========================================================

DALI_SCHEMA("MFCC").DocStr(
    "Mel-frequency cepstral coefficients: DCT over the mel axis with optional liftering."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "n_mfcc", ArgType.INT, "Number of coefficients.", 20
).AddOptionalArg(
    "dct_type", ArgType.INT, "DCT type (1, 2, or 3).", 2
).AddOptionalArg(
    "normalize", ArgType.BOOL, "Ortho-normalize the DCT.", False
).AddOptionalArg(
    "lifter", ArgType.FLOAT, "Cepstral liftering coefficient.", 0.0
).AddOptionalArg("axis", ArgType.INT, "Axis to transform.", 0)


class _MFCCCommon(Operator):
    def _matrix(self, n_in):
        return sig.dct_matrix(self.spec.GetArgument("n_mfcc"), n_in,
                              self.spec.GetArgument("dct_type"), self.spec.GetArgument("normalize"))

    def _lifter_vec(self):
        lifter = self.spec.GetArgument("lifter")
        if not lifter:
            return None
        n = self.spec.GetArgument("n_mfcc")
        return (1.0 + lifter / 2.0 * np.sin(np.pi * np.arange(n) / lifter)).astype(np.float32)


@register_operator("MFCC", "cpu")
class MFCCCPU(_MFCCCommon):
    def run_sample(self, ctx, idx, mel):
        axis = self.spec.GetArgument("axis")
        x = np.moveaxis(mel.astype(np.float32), axis, 0)
        out = np.tensordot(self._matrix(mel.shape[axis]), x, axes=(1, 0))
        lift = self._lifter_vec()
        if lift is not None:
            out = out * lift.reshape(-1, *([1] * (out.ndim - 1)))
        return np.moveaxis(out, 0, axis).astype(np.float32)


@register_operator("MFCC", "gpu")
class MFCCGPU(_MFCCCommon):
    def host_output_shapes(self, ctx, input_shapes, input_batches):
        if input_shapes[0] is None:
            return None
        sh = np.array(input_shapes[0], np.int32)
        sh[:, self.spec.GetArgument("axis")] = self.spec.GetArgument("n_mfcc")
        return [sh]

    def lower(self, dctx, inp: DeviceBatch):
        axis = self.spec.GetArgument("axis") + 1
        x = torch.movedim(inp.data.to(torch.float32), axis, 1)
        m = torch.from_numpy(self._matrix(x.shape[1])).to(x.device)
        out = torch.matmul(m, x.reshape(x.shape[0], x.shape[1], -1))
        out = out.reshape(x.shape[0], m.shape[0], *x.shape[2:])
        lift = self._lifter_vec()
        if lift is not None:
            out = out * torch.from_numpy(lift).to(x.device).reshape(1, -1, *([1] * (out.dim() - 2)))
        shapes = inp.shapes
        if shapes is not None:
            shapes = shapes.clone()
            shapes[:, axis - 1] = m.shape[0]
        return [DeviceBatch(torch.movedim(out, 1, axis), shapes, inp.layout)]


# ====================================== ToDecibels ==================================================

DALI_SCHEMA("ToDecibels").DocStr(
    "out = multiplier * log10(x / reference), clipped at cutoff_db."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "multiplier", ArgType.FLOAT, "Usually 10 (power) or 20 (magnitude).", 10.0
).AddOptionalArg(
    "reference", ArgType.FLOAT, "Reference value (0 = per-sample max).", 0.0
).AddOptionalArg("cutoff_db", ArgType.FLOAT, "Minimum output value.", -200.0)


@register_operator("ToDecibels", "cpu")
class ToDecibelsCPU(Operator):
    def run_sample(self, ctx, idx, x):
        ref = self.spec.GetArgument("reference")
        return sig.to_decibels(torch.from_numpy(x.astype(np.float32)),
                               self.spec.GetArgument("multiplier"), None if ref == 0.0 else ref,
                               self.spec.GetArgument("cutoff_db")).numpy()


@register_operator("ToDecibels", "gpu")
class ToDecibelsGPU(Operator):
    def lower(self, dctx, inp: DeviceBatch):
        x = inp.data.to(torch.float32)
        ref = self.spec.GetArgument("reference")
        if ref == 0.0:  # per-sample max over the valid region only
            mask = inp.valid_mask()
            masked = x if mask is None else x.masked_fill(~mask, float("-inf"))
            ref = masked.amax(dim=tuple(range(1, x.dim())), keepdim=True)
        out = sig.to_decibels(x, self.spec.GetArgument("multiplier"), ref,
                              self.spec.GetArgument("cutoff_db"))
        return [inp.with_data(out)]


# ====================================== NonsilentRegion =============================================

DALI_SCHEMA("NonsilentRegion").DocStr(
    "Finds the leading/trailing non-silence: outputs (begin, length) of the "
    "region above cutoff_db."
).NumInput(1).NumOutput(2).Devices("cpu").AddOptionalArg(
    "cutoff_db", ArgType.FLOAT, "Silence threshold relative to reference.", -60.0
).AddOptionalArg(
    "window_length", ArgType.INT, "Moving-mean-square window.", 2048
).AddOptionalArg(
    "reference_power", ArgType.FLOAT, "Reference power (0 = per-sample max).", 0.0
).AddOptionalArg("reset_interval", ArgType.INT, "Compatibility no-op.", 8192)


@register_operator("NonsilentRegion", "cpu")
class NonsilentRegionCPU(Operator):
    def run_sample(self, ctx, idx, x):
        x = x.reshape(-1).astype(np.float32)
        win = min(self.spec.GetArgument("window_length"), max(len(x), 1))
        mms = sig.moving_mean_square(torch.from_numpy(x), win).numpy()
        ref = self.spec.GetArgument("reference_power")
        ref = mms.max() if ref == 0.0 else ref
        thresh = ref * (10.0 ** (self.spec.GetArgument("cutoff_db") / 10.0))
        above = mms >= max(thresh, 1e-20)
        if not above.any():
            return np.int32(0), np.int32(0)
        begin = int(np.argmax(above))  # first window above the threshold
        end = min(len(above) - 1 - int(np.argmax(above[::-1])) + win, len(x))
        return np.int32(begin), np.int32(end - begin)

    def output_layout(self, output_idx, inputs):
        return ""
