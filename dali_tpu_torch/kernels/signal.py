"""Signal processing of the audio operators (counterpart of
``dali_tpu/kernels/signal.py``).

The window, mel and DCT matrices are numpy, copied from the reference so both
packages build the same float32 constants. The tensor pieces are PyTorch and
batched: a signal batch is ``[N, L]`` (a padded canvas) with an optional
per-sample ``valid_len`` ``[N]``, where the reference vmaps a 1-D function.
On a CUDA tensor the FFT is cuFFT (``torch.fft.rfft``) and the filter bank a
float32 matmul, as the reference leaves both to XLA: no Pallas kernel is on
this path. ``sinc_resample`` (AudioResample on the device) is plain torch
too: the reference computes it in XLA.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window (DALI's default)."""
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(np.float32)


def _valid_len(x: torch.Tensor, valid_len) -> torch.Tensor:
    n, n_buf = x.shape
    if valid_len is None:
        return torch.full((n,), n_buf, dtype=torch.int64, device=x.device)
    return torch.as_tensor(valid_len, device=x.device).to(torch.int64).reshape(n)


def frame_signal(x: torch.Tensor, window_length: int, window_step: int, center: bool,
                 reflect_pad: bool, valid_len=None) -> torch.Tensor:
    """Frames of a signal batch ``x`` [N, L] -> [N, n_frames, window_length].

    center=True: frame i is centred at i*step and the frame count comes from
    the padded length L (``L // step + 1``); the borders (reflect-101, or
    zeros) are taken against each sample's ``valid_len``, so a padded sample
    frames exactly as its unpadded self does. Instead of gathering every
    frame's window, one gather builds the bordered signal of length
    ``(n_frames - 1) * step + window_length`` and ``unfold`` frames it."""
    n, n_buf = x.shape
    if not center:
        n_frames = max((n_buf - window_length) // window_step + 1, 0)
        if n_frames == 0:
            return x.new_zeros((n, 0, window_length))
        return x[:, :(n_frames - 1) * window_step + window_length].unfold(
            -1, window_length, window_step)
    n_frames = n_buf // window_step + 1
    pos = (torch.arange((n_frames - 1) * window_step + window_length, device=x.device)
           - window_length // 2)[None, :]
    lens = _valid_len(x, valid_len)[:, None]
    if reflect_pad:
        r = torch.clamp(lens - 1, min=1)
        idx = r - torch.abs(r - torch.abs(pos) % (2 * r))
        ext = torch.gather(x, 1, torch.clamp(idx, 0, n_buf - 1))
    else:
        valid = (pos >= 0) & (pos < lens)
        ext = torch.where(valid, torch.gather(x, 1, torch.clamp(pos, 0, n_buf - 1).expand(n, -1)),
                          x.new_zeros(()))
    return ext.unfold(-1, window_length, window_step)


def spectrogram(x: torch.Tensor, nfft: int, window_length: int, window_step: int,
                window, power: int = 2, center: bool = True,
                reflect_pad: bool = True, layout: str = "ft", valid_len=None) -> torch.Tensor:
    """Magnitude (power 1) or power (power 2) spectrogram of ``x`` [N, L]:
    [N, nfft//2+1, frames] for layout 'ft', [N, frames, nfft//2+1] for 'tf'.
    A window (numpy or a tensor) shorter than nfft sits centred in the FFT
    frame."""
    frames = frame_signal(x.to(torch.float32), window_length, window_step, center,
                          reflect_pad, valid_len)
    frames = frames * torch.as_tensor(window, dtype=torch.float32, device=x.device)
    if window_length < nfft:
        lpad = (nfft - window_length) // 2
        frames = torch.nn.functional.pad(frames, (lpad, nfft - window_length - lpad))
    mag = torch.fft.rfft(frames, n=nfft, dim=-1).abs()
    if power == 2:
        mag = mag * mag
    return mag.transpose(1, 2).contiguous() if layout == "ft" else mag


def mel_hz_to_mel(f, formula: str):
    f = np.asarray(f, np.float64)
    if formula == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # slaney: linear below 1 kHz, logarithmic above
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    above = f >= min_log_hz
    return np.where(above, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)


def mel_mel_to_hz(m, formula: str):
    m = np.asarray(m, np.float64)
    if formula == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    hz = m * f_sp
    above = m >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), hz)


def mel_filter_bank_matrix(nfilter: int, nfft: int, sample_rate: float, freq_low: float = 0.0,
                           freq_high: Optional[float] = None, formula: str = "slaney",
                           normalize: bool = True) -> np.ndarray:
    """[nfilter, nfft//2+1] triangular filter bank (Slaney area normalization
    when normalize=True)."""
    if freq_high is None or freq_high <= 0:
        freq_high = sample_rate / 2
    n_bins = nfft // 2 + 1
    fft_freqs = np.linspace(0, sample_rate / 2, n_bins)
    mel_pts = np.linspace(mel_hz_to_mel(freq_low, formula), mel_hz_to_mel(freq_high, formula),
                          nfilter + 2)
    hz_pts = mel_mel_to_hz(mel_pts, formula)
    weights = np.zeros((nfilter, n_bins), np.float64)
    for i in range(nfilter):
        lo, cen, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (fft_freqs - lo) / max(cen - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - cen, 1e-10)
        weights[i] = np.maximum(0.0, np.minimum(up, down))
        if normalize:
            weights[i] *= 2.0 / (hi - lo)
    return weights.astype(np.float32)


def dct_matrix(n_out: int, n_in: int, dct_type: int = 2, normalize: bool = False) -> np.ndarray:
    """DCT matrix [n_out, n_in]: type 2 (optionally ortho-normalized), 1 or 3."""
    k = np.arange(n_out)[:, None]
    i = np.arange(n_in)[None, :]
    if dct_type == 2:
        m = np.cos(np.pi * k * (2 * i + 1) / (2 * n_in))
        if normalize:
            m *= np.sqrt(2.0 / n_in)
            m[0] *= 1.0 / np.sqrt(2.0)
        else:
            m *= 2.0
    elif dct_type == 1:
        m = np.cos(np.pi * k * i / max(n_in - 1, 1))
    elif dct_type == 3:
        m = np.cos(np.pi * (2 * k + 1) * i / (2 * n_in))
        m[:, 0] *= 0.5
        m *= 2.0
    else:
        raise ValueError(f"Unsupported dct_type {dct_type}")
    return m.astype(np.float32)


def to_decibels(x: torch.Tensor, multiplier: float = 10.0, s_ref=None,
                cutoff_db: float = -80.0) -> torch.Tensor:
    """multiplier * log10(max(x / ref, 10**(cutoff_db/multiplier))); ``s_ref``
    None -> the max of all of ``x`` (one sample), else a scalar or a tensor
    that broadcasts against ``x``."""
    if s_ref is None:
        s_ref = x.max()
    ref = torch.clamp(s_ref, min=1e-20) if isinstance(s_ref, torch.Tensor) else max(s_ref, 1e-20)
    min_ratio = 10.0 ** (cutoff_db / multiplier)
    return (multiplier * torch.log10(torch.clamp(x / ref, min=min_ratio))).to(torch.float32)


def preemphasis(x: torch.Tensor, coeff, border: str = "clamp") -> torch.Tensor:
    """y[:, t] = x[:, t] - coeff * x[:, t-1] over a batch [N, L, ...]; the value
    before t = 0 is 0 ('zero'), x[:, 0] ('clamp') or x[:, 1] ('reflect').
    ``coeff`` is a scalar or a per-sample [N] tensor."""
    x = x.to(torch.float32)
    if border == "zero":
        first = torch.zeros_like(x[:, :1])
    elif border == "reflect" and x.shape[1] > 1:
        first = x[:, 1:2]
    else:
        first = x[:, :1]
    prev = torch.cat([first, x[:, :-1]], dim=1)
    if isinstance(coeff, torch.Tensor):
        coeff = coeff.to(torch.float32).reshape(-1, *([1] * (x.dim() - 1)))
    return x - coeff * prev


def moving_mean_square(x: torch.Tensor, window: int) -> torch.Tensor:
    """Mean of squares over the windows starting at each index of a 1-D
    signal; output length ``len(x) - window + 1`` (at least 1)."""
    xx = x.to(torch.float32) ** 2
    cs = torch.cumsum(torch.cat([xx.new_zeros(1), xx]), 0)
    n = xx.shape[0]
    lo = torch.arange(max(n - window + 1, 1), device=x.device)
    return (cs[lo + min(window, n)] - cs[lo]) / window


def _i0(x: torch.Tensor) -> torch.Tensor:
    """Modified Bessel I0 (Abramowitz & Stegun 9.8.1/9.8.2 polynomial fit),
    the reference's ``_i0``."""
    ax = x.abs()
    t = ax / 3.75
    small = 1.0 + 3.5156229 * t**2 + 3.0899424 * t**4 + 1.2067492 * t**6 + \
        0.2659732 * t**8 + 0.0360768 * t**10 + 0.0045813 * t**12
    ti = 3.75 / torch.clamp(ax, min=1e-9)
    big = (torch.exp(ax) / torch.sqrt(torch.clamp(ax, min=1e-9))) * (
        0.39894228 + 0.01328592 * ti + 0.00225319 * ti**2 - 0.00157565 * ti**3
        + 0.00916281 * ti**4 - 0.02057706 * ti**5 + 0.02635537 * ti**6
        - 0.01647633 * ti**7 + 0.00392377 * ti**8)
    return torch.where(ax < 3.75, small, big)


SINC_CHUNK_BYTES = 32 << 20  # one [N, positions, taps] float32 intermediate


def sinc_resample(x: torch.Tensor, in_rate: torch.Tensor, out_rate: torch.Tensor,
                  out_len: int, taps: int = 32) -> torch.Tensor:
    """Kaiser-windowed sinc resampling of a batch (the reference's
    ``sinc_resample``, vmapped): ``x`` [N, L] or [N, L, C] float32 on a
    canvas of L, per-sample rates [N] float32 -> [N, out_len(, C)].

    Output j of sample i reads the ``taps`` canvas samples around
    ``j * in_rate / out_rate`` (indices clamped into the canvas, as the
    reference's are), weighted by a Kaiser (beta 16) window times a sinc
    whose cutoff scales down for downsampling. Positions stay float32 in the
    reference's order, so each lands on the same taps. The gather is
    [N, positions, taps]: positions go in chunks so that one intermediate
    stays under ``SINC_CHUNK_BYTES``."""
    n, L = x.shape[:2]
    dev = x.device
    in_rate = in_rate.to(device=dev, dtype=torch.float32).reshape(n, 1, 1)
    out_rate = out_rate.to(device=dev, dtype=torch.float32).reshape(n, 1, 1)
    step = in_rate / out_rate
    cutoff = torch.minimum(torch.ones_like(step), out_rate / in_rate)
    k = torch.arange(-(taps // 2) + 1, taps // 2 + 1, dtype=torch.float32, device=dev)
    k_int = k.to(torch.int64)
    i0_beta = _i0(torch.tensor(16.0, device=dev))
    half_width = taps / 2.0 * cutoff
    chans = x.shape[2] if x.dim() == 3 else 1
    out = x.new_empty((n, out_len) + tuple(x.shape[2:]))
    chunk = max(1, SINC_CHUNK_BYTES // (4 * n * taps * chans))
    rows = torch.arange(n, device=dev)[:, None, None]
    for o0 in range(0, out_len, chunk):
        pos = torch.arange(o0, min(o0 + chunk, out_len), dtype=torch.float32,
                           device=dev)[None, :, None] * step            # [N, P, 1]
        base = torch.floor(pos)
        frac = pos - base
        arg = (k - frac) * cutoff                                         # [N, P, T]
        t_norm = arg / half_width
        w_kaiser = _i0(16.0 * torch.sqrt(torch.clamp(1.0 - t_norm * t_norm, min=0.0))) / i0_beta
        w = torch.where(t_norm.abs() < 1.0, w_kaiser * torch.sinc(arg) * cutoff,
                        torch.zeros((), device=dev))
        idx = torch.clamp(base.to(torch.int64) + k_int, 0, L - 1)
        g = x[rows, idx]                                                  # [N, P, T(, C)]
        if g.dim() == 4:
            out[:, o0:o0 + pos.shape[1]] = torch.einsum("nptc,npt->npc", g, w)
        else:
            out[:, o0:o0 + pos.shape[1]] = (g * w).sum(-1)
    return out
