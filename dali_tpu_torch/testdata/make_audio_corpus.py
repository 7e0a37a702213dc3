"""The speech-like 16 kHz corpus of the ASR front end, as 16-bit mono WAV.

The signals are those of ``bench.py``'s audio lane (same formula, seed 99,
128 clips of 4-10 s): harmonics over a wandering f0 plus low white noise.
The bench writes them as 16-bit FLAC; here they are 16-bit WAV, which holds
the same int16 PCM (float -> int16 as FFmpeg's resampler converts:
``round(x * 32768)`` clipped), so the device sees the same data. The corpus
is written at first use under ``build/`` and never committed.

Usage: python dali_tpu_torch/testdata/make_audio_corpus.py [root]
"""

from __future__ import annotations

import os
import struct
import sys

import numpy as np

RATE = 16000
DEFAULT_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "audio_corpus")


def speech_clip(rng: np.random.Generator, seconds: float, rate: int = RATE) -> np.ndarray:
    """One float32 clip: four harmonics of an f0 wandering around 110 Hz,
    plus white noise at 0.01."""
    n = int(seconds * rate)
    t = np.arange(n, dtype=np.float32) / rate
    f0 = 110.0 + 40.0 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 6))
    phase = np.cumsum(2 * np.pi * f0 / rate)
    x = sum(np.sin(k * phase) / k for k in range(1, 5))
    x = x.astype(np.float32) * 0.2
    x += rng.standard_normal(n).astype(np.float32) * 0.01
    return x


def to_int16(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int16)


def wav_bytes(data: bytes, rate: int = RATE, channels: int = 1, bits: int = 16,
              fmt_tag: int = 1) -> bytes:
    """A RIFF/WAVE file around interleaved sample bytes (``fmt_tag`` 1 = PCM,
    3 = IEEE float)."""
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", fmt_tag, channels, rate, rate * block, block, bits)
    return (b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data)) + b"WAVE"
            + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(data)) + data)


def write_corpus(root: str, n_clips: int, seed: int, seconds=(4.0, 10.0)) -> str:
    """``n_clips`` clips of uniform(*seconds) s as ``root/clips/cNNNN.wav``
    (one class folder, the layout ``readers.file`` walks). Returns root."""
    marker = os.path.join(root, ".complete")
    if os.path.exists(marker):
        return root
    os.makedirs(os.path.join(root, "clips"), exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n_clips):
        x = speech_clip(rng, float(rng.uniform(*seconds)))
        with open(os.path.join(root, "clips", f"c{i:04d}.wav"), "wb") as f:
            f.write(wav_bytes(to_int16(x).tobytes()))
    with open(marker, "w") as f:
        f.write("ok")
    return root


def ensure_corpus(root: str = DEFAULT_ROOT) -> str:
    """The bench-sized corpus: 128 clips of 4-10 s, seed 99."""
    return write_corpus(root, 128, 99)


if __name__ == "__main__":
    print(ensure_corpus(*sys.argv[1:2]))
