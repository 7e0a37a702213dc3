"""asr_mp3 and the audio codecs: the MP3 and Ogg Vorbis host decode
(``csrc/host/mp3_decode.cc``, ``vorbis_decode.cc``) on the card's machine.

* asr_mp3: asr_resample's graph (``bench_dali_cpu.asr_resample_graph``:
  ``readers.file``, the mixed ``decoders.audio`` at the clip's own rate,
  ``experimental.audio_resample`` 48 kHz -> 16 kHz on the card,
  preemphasis, spectrogram, 80 mels, dB, normalize) over the 32 committed
  48 kHz mono MP3 clips of ``testdata/audio_codecs/corpus_mp3`` (Common
  Voice's form, 64 kbit/s CBR): clips/s, host ms per batch, the ms of one
  batch's MP3 decode on one thread and on the host's cores, and the card's
  dB mel against the CPU port's over one batch of all 32 clips.
* audio_codecs: every committed MP3 and Vorbis fixture decoded with this
  machine's build and held against ``reference.npz`` (dali_tpu's FFmpeg
  decode, written by ``tests/write_audio_codecs_reference.py``): the same length,
  channels and rate, and the "full accuracy" bounds of ISO/IEC 11172-4
  (RMS difference <= 2^-15 / sqrt(12), largest <= 2^-14 of full scale); the
  streams the reference rejects raise as they should; then one batch of the
  8 Vorbis clips of ``corpus_vorbis`` through the same graph, card against
  CPU.

``chip_smoke.py`` runs both (phases 36-37). Alone, on the card:
``python dali_tpu_torch/tools/bench_audio_codecs.py --form
asr_mp3|audio_codecs`` (one JSON line).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

if __name__ == "__main__":  # run as a script from the repository root
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))))

from dali_tpu_torch.tools import bench_dali_cpu  # noqa: E402
from dali_tpu_torch.tools.bench_seq_volumes import host_decode_ms  # noqa: E402

CODECS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "testdata",
                      "audio_codecs")
MP3_CORPUS = os.path.join(CODECS, "corpus_mp3")
VORBIS_CORPUS = os.path.join(CODECS, "corpus_vorbis")
RMS_BOUND = 2.0 ** -15 / np.sqrt(12.0)
MAX_BOUND = 2.0 ** -14
# the streams the port does not decode, and the error each raises: one the
# reference rejects too, and forms left to ROADMAP item 4c
FAILING = {"fail_bad_side_info.mp3": ValueError, "fail_layer2.mp3": NotImplementedError,
           "fail_ogg_opus.ogg": NotImplementedError, "fail_ogg_flac.ogg": NotImplementedError}


def run_asr_mp3(batch=32, warmup=3, timed=20):
    """asr_mp3 on the card: the path's rates, the decode's ms, the card's
    mel against the CPU's."""
    from dali_tpu_torch.backend.audio import decode_audio

    r = bench_dali_cpu.run_asr_resample(MP3_CORPUS, batch, warmup, timed, ext="mp3")
    clips = sorted(os.listdir(os.path.join(MP3_CORPUS, "clips")))[:batch]
    seconds = 0.0
    for name in clips:
        with open(os.path.join(MP3_CORPUS, "clips", name), "rb") as f:
            x, rate = decode_audio(f.read())
        seconds += len(x) / rate
    cores = os.cpu_count() or 1
    r.update({"decode_ms_one_thread": host_decode_ms(MP3_CORPUS, "mp3", batch, threads=1),
              "decode_ms_pool": host_decode_ms(MP3_CORPUS, "mp3", batch), "cores": cores,
              "audio_seconds_per_batch": seconds,
              "check": bench_dali_cpu.check_asr_resample(MP3_CORPUS, batch=batch, iterations=1,
                                                         ext="mp3")})
    return r


def check_fixtures():
    """Every fixture against reference.npz; returns the worst differences
    and the counts, or raises."""
    from dali_tpu_torch.backend.audio import decode_audio

    ref = np.load(os.path.join(CODECS, "reference.npz"))
    worst = {"max_abs": 0.0, "rms": 0.0}
    n = {"mp3": 0, "vorbis": 0}
    for name in sorted(os.listdir(CODECS)):
        if not name.endswith((".mp3", ".ogg")):
            continue
        with open(os.path.join(CODECS, name), "rb") as f:
            data = f.read()
        if name in FAILING:
            try:
                decode_audio(data)
            except FAILING[name]:
                continue
            raise AssertionError(f"{name}: decoded, where it should raise {FAILING[name]}")
        key = name.rsplit(".", 1)[0]
        x, rate = decode_audio(data)
        want = ref[key]
        if x.shape != want.shape or rate != float(ref[key + ":rate"]):
            raise AssertionError(f"{name}: {x.shape} at {rate} Hz, the reference "
                                 f"{want.shape} at {float(ref[key + ':rate'])} Hz")
        d = x.astype(np.float64) - want
        mx, rms = float(np.abs(d).max()), float(np.sqrt(np.mean(d * d)))
        if not (mx <= MAX_BOUND and rms <= RMS_BOUND):
            raise AssertionError(f"{name}: max {mx:.3e}, rms {rms:.3e} beyond the bounds")
        worst["max_abs"] = max(worst["max_abs"], mx)
        worst["rms"] = max(worst["rms"], rms)
        n["mp3" if name.endswith(".mp3") else "vorbis"] += 1
    return {"worst": worst, "fixtures": n, "failing": len(FAILING)}


def run_audio_codecs(vorbis_batch=8):
    return {"fixtures": check_fixtures(), "vorbis_batch": vorbis_batch,
            "vorbis_decode_ms_pool": host_decode_ms(VORBIS_CORPUS, "ogg", vorbis_batch),
            "vorbis_check": bench_dali_cpu.check_asr_resample(VORBIS_CORPUS, batch=vorbis_batch,
                                                              iterations=1, ext="ogg")}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--form", choices=["asr_mp3", "audio_codecs"], required=True)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_audio_codecs: no card", file=sys.stderr)
        return 2
    r = run_asr_mp3() if args.form == "asr_mp3" else run_audio_codecs()
    print(json.dumps({"form": args.form, **r}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
