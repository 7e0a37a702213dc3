"""Where the ASR mel front end spends its time on one CUDA card.

Run from the repository root: ``python -m dali_tpu_torch.tools.profile_asr``.

1. **Host phase.** bench.py's ``asr_frontend`` at batch 32 on the generated
   128-clip corpus, twice: 3 warm-up + 20 timed batches each, prefetching as
   an iterator does. Prints host-phase ms/batch (``Executor.stats``), the
   device stage's wait for staged input and clips/s of each run.
2. **Device busy share.** ``torch.profiler`` over 10 steady batches. Device
   busy time is the union of the card's kernel, memcpy and memset intervals
   inside the profiled window (overlaps count once); the window is a
   ``record_function`` range on the host clock of the trace, and idle share
   = 1 - busy / window.

Prints one JSON object of all readings as its last line and writes it to
``build/profile_asr.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time

import torch

from dali_tpu_torch import fn, pipeline_def, types
from dali_tpu_torch.testdata.make_audio_corpus import ensure_corpus

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BATCH, WARMUP, TIMED, PROFILED = 32, 3, 20, 10
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def make_pipe(root: str):
    @pipeline_def(batch_size=BATCH, seed=7, prefetch_queue_depth=2, device="cuda:0")
    def asr_frontend():
        enc, _ = fn.readers.file(file_root=root, file_filters=["*.wav"], random_shuffle=True,
                                 name="R")
        audio, _rate = fn.decoders.audio(enc, dtype=types.FLOAT, downmix=True, device="mixed")
        audio = fn.preemphasis_filter(audio, preemph_coeff=0.97)
        spec = fn.spectrogram(audio, nfft=512, window_length=320, window_step=160)
        mel = fn.mel_filter_bank(spec, sample_rate=16000.0, nfilter=80)
        db = fn.to_decibels(mel, multiplier=10.0, cutoff_db=-80.0)
        return fn.normalize(db, axes=[1])

    pipe = asr_frontend()
    pipe.build()
    return pipe


def steps(pipe, n: int):
    """Take ``n`` batches, scheduling one more after each (iterator order)."""
    for _ in range(n):
        pipe.outputs()
        pipe.schedule_run()


def host_phase_run(root: str) -> dict:
    pipe = make_pipe(root)
    ex = pipe.executor
    pipe._prefetch()
    steps(pipe, WARMUP)
    torch.cuda.synchronize()
    st0 = dict(ex.stats)
    t0 = time.perf_counter()
    steps(pipe, TIMED)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = {k: v - st0[k] for k, v in ex.stats.items()}
    for _ in range(pipe.prefetch_queue_depth):
        pipe.outputs()
    pipe.shutdown()
    return {"clips_per_s": TIMED * BATCH / dt,
            "host_phase_ms": 1e3 * st["host_phase_seconds"] / st["host_batches"],
            "device_wait_ms": 1e3 * st["device_wait_seconds"] / TIMED}


def union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def busy_share(root: str) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    pipe = make_pipe(root)
    pipe._prefetch()
    steps(pipe, WARMUP)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("asr_window"):
            steps(pipe, PROFILED)
            torch.cuda.synchronize()
    for _ in range(pipe.prefetch_queue_depth):
        pipe.outputs()
    pipe.shutdown()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    window = [e for e in events if e.get("name") == "asr_window"
              and e.get("cat") == "user_annotation"]
    if len(window) != 1:
        raise RuntimeError(f"expected one profiled window in the trace, found {len(window)}")
    w0, w1 = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
    dev = [(max(w0, e["ts"]), min(w1, e["ts"] + e["dur"])) for e in events
           if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    dev = [(a, b) for a, b in dev if b > a]
    if not dev:
        raise RuntimeError("the trace holds no device interval inside the window")
    kern = [(max(w0, e["ts"]), min(w1, e["ts"] + e["dur"])) for e in events
            if e.get("cat") == "kernel" and e.get("ph") == "X"]
    busy = union_us(dev)
    return {"batches": PROFILED, "window_ms": (w1 - w0) / 1e3,
            "device_busy_ms": busy / 1e3,
            "kernel_busy_ms": union_us([(a, b) for a, b in kern if b > a]) / 1e3,
            "device_intervals": len(dev), "idle_share": 1.0 - busy / (w1 - w0)}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_asr: torch.cuda.is_available() is False")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    root = ensure_corpus()
    runs = []
    for _ in range(2):
        runs.append(host_phase_run(root))
        print(f"host phase {runs[-1]['host_phase_ms']:.2f} ms/batch, "
              f"{runs[-1]['clips_per_s']:.1f} clips/s, device wait "
              f"{runs[-1]['device_wait_ms']:.2f} ms/batch ({card})", flush=True)
    prof = busy_share(root)
    print(f"profiled {PROFILED} batches: window {prof['window_ms']:.3f} ms, device busy "
          f"{prof['device_busy_ms']:.3f} ms (kernels {prof['kernel_busy_ms']:.3f} ms), idle "
          f"{100 * prof['idle_share']:.1f}% ({card})", flush=True)
    result = {"card": card, "host_cores": os.cpu_count(), "runs": runs, "profile": prof}
    out = os.path.join(HERE, "build")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "profile_asr.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
