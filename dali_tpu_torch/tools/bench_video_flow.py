"""The two-stream action-recognition input on the card: ``video_flow_train``.

C3D's input (Tran et al., 2015), with a motion stream beside it:
``readers.video_resize`` over the committed 320x240 corpus
(``testdata/video/corpus``: 4 classes of 8 MPEG-4 Part 2 clips at 25 fps),
``sequence_length=8, stride=2, random_shuffle=True``, every frame resized to
171x128 on the host; ``optical_flow(output_grid=4)`` on the host, the
Farneback flow of each consecutive pair (``[7, 32, 43, 2]`` float32 a
sequence), then ``.gpu()``; the frames ``.gpu()`` and
``crop_mirror_normalize`` to FLOAT FCHW, a random 112x112 crop with a
coin-flip mirror (the CMN kernel's FCHW fold on ``[32, 8, 128, 171, 3]``
uint8); batch 32, so 256 frames and 224 flow pairs a batch.

``run`` reports clips/s and frames/s, host ms a batch and by schema, the
device wait, device ms by stage of one batch alone, peak device memory, the
CMN launches of the run and the kernel held against its plain version on
the path's own batch and timed on it. ``host_costs`` splits the reader's
host time: the per-frame resample of one batch alone, and the flow of one
pair on one thread and of a batch's pairs on the pool. ``check_mixed_vs_cpu``
runs the reader ``device="mixed"`` against the cpu placement: the uint8
frames equal on the card.

    python dali_tpu_torch/tools/bench_video_flow.py [--timed 5]

runs all of it on the card and prints one JSON line; ``--device cpu
--batch 2 --timed 1`` runs the path on the CPU at a small size (no device
numbers).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CORPUS = os.path.join(REPO, "dali_tpu_torch", "testdata", "video", "corpus")
BATCH, FRAMES, STRIDE = 32, 8, 2
RESIZE_H, RESIZE_W, CROP, GRID = 128, 171, 112, 4
MEAN, STD = [0.45 * 255] * 3, [0.225 * 255] * 3
CLASSES = 4
FLOW_SHAPE = (FRAMES - 1, -(-RESIZE_H // GRID), -(-RESIZE_W // GRID), 2)


def reader(fn, root=CORPUS, device="cpu"):
    return fn.readers.video_resize(
        file_root=root, sequence_length=FRAMES, stride=STRIDE, random_shuffle=True,
        resize_x=RESIZE_W, resize_y=RESIZE_H, name="Reader", device=device)


def flow_graph(fn, types, root=CORPUS):
    frames, labels = reader(fn, root)
    flow = fn.optical_flow(frames, output_grid=GRID).gpu()
    out = fn.crop_mirror_normalize(
        frames.gpu(), crop=(CROP, CROP), crop_pos_x=fn.random.uniform(range=[0.0, 1.0]),
        crop_pos_y=fn.random.uniform(range=[0.0, 1.0]),
        mirror=fn.random.coin_flip(probability=0.5), dtype=types.FLOAT, output_layout="FCHW",
        mean=MEAN, std=STD)
    return out, labels, flow


def make_pipe(batch, device, root=CORPUS, seed=7, reader_device=None):
    """The path's pipeline; with ``reader_device`` only its reader on that
    placement, its frames on the card."""
    from dali_tpu_torch import fn, pipeline_def, types

    @pipeline_def(batch_size=batch, num_threads=os.cpu_count() or 1, seed=seed,
                  prefetch_queue_depth=2, device=device)
    def video_flow_train():
        if reader_device is None:
            return flow_graph(fn, types, root)
        frames, labels = reader(fn, root, reader_device)
        return (frames if reader_device == "mixed" else frames.gpu()), labels

    pipe = video_flow_train()
    pipe.build()
    return pipe


def check_batch(b, batch=BATCH, on_card=True):
    x, lab, fl = b[0]["frames"], b[0]["labels"], b[0]["flow"]
    shape = (batch, FRAMES, 3, CROP, CROP)
    if not (x.is_cuda == on_card and x.dtype == torch.float32 and tuple(x.shape) == shape):
        raise AssertionError(f"video_flow_train: frames {tuple(x.shape)} {x.dtype} on {x.device}")
    if not (fl.is_cuda == on_card and fl.dtype == torch.float32
            and tuple(fl.shape) == (batch,) + FLOW_SHAPE):
        raise AssertionError(f"video_flow_train: flow {tuple(fl.shape)} {fl.dtype} on "
                             f"{fl.device}")
    if not (bool(torch.isfinite(x).all()) and bool(torch.isfinite(fl).all())):
        raise AssertionError("video_flow_train: non-finite values in a batch")
    lab = lab.reshape(-1)
    if not (lab.numel() == batch and int(lab.min()) >= 0 and int(lab.max()) < CLASSES):
        raise AssertionError(f"video_flow_train: labels out of range: {lab.tolist()}")


def run(batch=BATCH, warmup=3, timed=5, device="cuda:0"):
    """video_flow_train (``bench_readers._drive``): rates, host ms by
    schema, the device wait and the CMN launches of the run (set to 0 just
    before it, one per batch); on the card also device ms by stage of one
    batch alone, peak memory, and the CMN kernel held against its plain
    version on one more batch of the path and timed on it."""
    from dali_tpu_torch.kernels import cmn
    from dali_tpu_torch.tools import bench_readers, bench_ssd

    on_card = device != "cpu"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    pipe = make_pipe(batch, device)
    cmn.COUNTER.launches = 0
    dt, st, by, ran = bench_readers._drive(pipe, ["frames", "labels", "flow"], warmup, timed,
                                           lambda b: check_batch(b, batch, on_card))
    launches = cmn.COUNTER.launches
    if on_card and launches != ran:
        raise AssertionError(f"video_flow_train: CMN launched {launches} times for {ran} batches")
    res = {"form": "video_flow_train", "batch": batch, "timed": timed, "device": device,
           "clips_per_s": timed * batch / dt, "frames_per_s": timed * batch * FRAMES / dt,
           "host_ms_per_batch": 1e3 * st["host_phase_seconds"] / max(st["host_batches"], 1),
           "device_wait_ms_per_batch": 1e3 * st["device_wait_seconds"] / timed,
           "host_ms_by_schema": dict(sorted(by.items(), key=lambda kv: -kv[1])),
           "cmn_launches": launches}
    if on_card:
        res["stage_ms"] = dict(sorted(bench_readers._stages_alone(pipe).items(),
                                      key=lambda kv: -kv[1]))
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        with bench_ssd.recording_cmn([]) as calls:
            pipe.run()
        res["cmn"] = dict(bench_ssd.time_cmn(calls[0]), max_abs_err=bench_ssd.hold_cmn(calls[0]))
    pipe.shutdown()
    return res


def _one_sequence(root=CORPUS):
    """The frames of one path sequence, decoded and resized, and the same
    frames at the corpus's 320x240 (uint8 [FRAMES, H, W, 3])."""
    from dali_tpu_torch import native
    from dali_tpu_torch.kernels.host_resample import host_resample

    path = os.path.join(root, sorted(os.listdir(root))[0])
    vf = native.VideoFile(os.path.join(path, sorted(os.listdir(path))[0]))
    full = vf.read(0, FRAMES, STRIDE, pad=False)
    vf.close()
    small = np.stack([host_resample(f, RESIZE_H, RESIZE_W) for f in full])
    return full, small


def host_costs(batch=BATCH, threads=None, reps=3):
    """The host work of one batch, split: the per-frame resample of a
    batch's frames (320x240 -> 171x128) on one thread, and the Farneback
    flow of one 171x128 pair on one thread and of a batch's pairs on a pool
    of ``threads`` workers (the operator's ``SamplePool``: one task a
    sequence). Medians of ``reps``."""
    from dali_tpu_torch import native
    from dali_tpu_torch.backend.enhance2 import _gray
    from dali_tpu_torch.kernels.host_resample import host_resample

    threads = threads or os.cpu_count() or 1
    full, small = _one_sequence()
    grey = [_gray(f) for f in small]

    def timed(fn):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    resample_s = timed(lambda: [host_resample(f, RESIZE_H, RESIZE_W) for f in full])
    pair_s = timed(lambda: native.farneback(grey[0], grey[1]))

    def seq_flow(_):
        return [native.farneback(a, b) for a, b in zip(grey[:-1], grey[1:])]

    with ThreadPoolExecutor(threads) as pool:
        pool_s = timed(lambda: list(pool.map(seq_flow, range(batch))))
    pairs = batch * (FRAMES - 1)
    return {"resample_ms_per_batch_one_thread": 1e3 * resample_s * batch,
            "flow_ms_per_pair_one_thread": 1e3 * pair_s,
            "flow_ms_per_batch_pool": 1e3 * pool_s,
            "flow_ms_per_pair_pool": 1e3 * pool_s / pairs, "pairs": pairs, "threads": threads}


def check_mixed_vs_cpu(batch=BATCH, batches=2, device="cuda:0"):
    """The reader on ``device="mixed"`` against the cpu placement then
    ``.gpu()``, on the card: the uint8 frames and labels equal, batch for
    batch."""
    runs = []
    for placement in ("cpu", "mixed"):
        pipe = make_pipe(batch, device, reader_device=placement)
        runs.append([[_tensor(o) for o in pipe.run()] for _ in range(batches)])
        pipe.shutdown()
    frames = 0
    for (raw_c, lab_c), (raw_m, lab_m) in zip(*runs):
        on_card = device == "cpu" or (raw_c.is_cuda and raw_m.is_cuda)
        if not (on_card and raw_c.dtype == torch.uint8 and torch.equal(raw_c, raw_m)
                and torch.equal(lab_c.cpu(), lab_m.cpu())):
            raise AssertionError("video_flow_train: the mixed reader's frames differ from the "
                                 "cpu reader's")
        frames += raw_m.shape[0] * raw_m.shape[1]
    return {"batches": batches, "frames": frames}


def _tensor(tl):
    x = tl.as_tensor() if hasattr(tl, "as_tensor") else tl.as_array()
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timed", type=int, default=5)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    if args.device == "cpu":
        r = {"run": run(args.batch, 1, args.timed, "cpu"),
             "mixed_vs_cpu": check_mixed_vs_cpu(args.batch, 1, "cpu")}
        print(json.dumps(r))
        return 0
    if not torch.cuda.is_available():
        print("bench_video_flow: needs a CUDA card", file=sys.stderr)
        return 2
    r = {"run": run(args.batch, timed=args.timed), "host": host_costs(args.batch),
         "mixed_vs_cpu": check_mixed_vs_cpu(args.batch), "card": card_line()}
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
