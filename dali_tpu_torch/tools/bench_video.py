"""The video-clip training path on the card, at full width: ``video_clip_train``.

``docs/examples/video_training.py``'s recipe as written: ``readers.video``
over the committed 320x240 corpus (``testdata/video/corpus``: 4 classes of
8 MPEG-4 Part 2 clips at 25 fps, UCF101's frame size and rate),
``sequence_length=8, stride=2, random_shuffle=True, pad_mode="edge"``;
``resize`` to 112x112; ``rotate`` by an angle in [-8, 8] degrees and
``gaussian_blur`` of sigma in [0.1, 1.1], both drawn once a sequence;
``crop_mirror_normalize`` to FLOAT FCHW with a coin-flip mirror (the CMN
kernel's FCHW fold on ``[32, 8, 112, 112, 3]`` uint8); batch 32, so 256
frames a batch.

The timed form runs the reader ``device="mixed"``: the host decodes a
batch's sequences at once on the task pool and the frames cross as the
planar YUV wire (1.5 bytes a pixel), turned into RGB on the card
(``kernels.wire.yuv420_boundary``). ``run`` reports clips/s and frames/s,
host ms a batch and by schema, the device wait, device ms by stage of one
batch alone (``wire`` is the YUV -> RGB stage), peak device memory, the CMN
launches of the run and the kernel on the path's own batch. ``yuv_stage``
times the YUV -> RGB stage alone on a batch of the path's size;
``decode_rate`` the host decode of the whole corpus on one thread and on the
pool; ``check_fixtures`` holds every committed fixture, decoded on this
machine, against ``testdata/video/reference.npz`` (dali_tpu's FFmpeg 5.1
decode) in RGB and YUV; ``check_mixed_vs_cpu`` runs the recipe with the
cpu reader then ``.gpu()`` against the mixed reader: the uint8 frames equal.

    python dali_tpu_torch/tools/bench_video.py [--timed 10]

runs all of it on the card and prints one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VIDEO = os.path.join(REPO, "dali_tpu_torch", "testdata", "video")
CORPUS = os.path.join(VIDEO, "corpus")
BATCH, FRAMES, STRIDE, SIZE = 32, 8, 2, 112
MEAN, STD = [0.45 * 255] * 3, [0.225 * 255] * 3
CLASSES = 4
# the fixtures stored whole in reference.npz
WHOLE = ("flat_48x32", "pan_64x48")


def video_graph(fn, types, root, reader_device, raw=False, stride=STRIDE):
    frames, labels = fn.readers.video(
        file_root=root, sequence_length=FRAMES, stride=stride, random_shuffle=True,
        pad_mode="edge", name="Reader", device=reader_device)
    frames = frames if reader_device == "mixed" else frames.gpu()
    out = fn.resize(frames, resize_x=SIZE, resize_y=SIZE)
    angle = fn.random.uniform(range=[-8.0, 8.0])
    out = fn.rotate(out, angle=angle, keep_size=True, fill_value=0.0)
    sigma = fn.random.uniform(range=[0.1, 1.1])
    out = fn.gaussian_blur(out, sigma=sigma)
    mirror = fn.random.coin_flip(probability=0.5)
    out = fn.crop_mirror_normalize(out, mirror=mirror, dtype=types.FLOAT, output_layout="FCHW",
                                   mean=MEAN, std=STD)
    return (out, labels, frames) if raw else (out, labels)


def make_pipe(batch, device, reader_device="mixed", root=CORPUS, raw=False, seed=7,
              stride=STRIDE):
    from dali_tpu_torch import fn, pipeline_def, types

    @pipeline_def(batch_size=batch, num_threads=os.cpu_count() or 1, seed=seed,
                  prefetch_queue_depth=2, device=device)
    def video_clip_train():
        return video_graph(fn, types, root, reader_device, raw, stride)

    pipe = video_clip_train()
    pipe.build()
    return pipe


def check_batch(b, batch=BATCH, form="video_clip_train"):
    x, lab = b[0]["frames"], b[0]["labels"]
    shape = (batch, FRAMES, 3, SIZE, SIZE)
    if not (x.is_cuda and x.dtype == torch.float32 and tuple(x.shape) == shape):
        raise AssertionError(f"{form}: {tuple(x.shape)} {x.dtype} on {x.device}")
    if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{form}: non-finite values in a batch")
    lab = lab.reshape(-1)
    if not (lab.numel() == batch and int(lab.min()) >= 0 and int(lab.max()) < CLASSES):
        raise AssertionError(f"{form}: labels out of range: {lab.tolist()}")


def run(batch=BATCH, warmup=3, timed=10, root=CORPUS, form="video_clip_train", stride=STRIDE):
    """The path over ``root`` on the card (``bench_readers._drive``): rates,
    host ms by schema, the CMN launches of the run (set to 0 just before it,
    one per batch), device ms by stage of one batch alone, peak memory, and
    the CMN kernel held against its plain version on one more batch of the
    path and timed on it (``bench_ssd.hold_cmn``, ``time_cmn``)."""
    from dali_tpu_torch.kernels import cmn
    from dali_tpu_torch.tools import bench_readers, bench_ssd

    torch.cuda.reset_peak_memory_stats()
    pipe = make_pipe(batch, "cuda:0", root=root, stride=stride)
    cmn.COUNTER.launches = 0
    dt, st, by, ran = bench_readers._drive(pipe, ["frames", "labels"], warmup, timed,
                                           lambda b: check_batch(b, batch, form))
    launches = cmn.COUNTER.launches
    if launches != ran:
        raise AssertionError(f"{form}: CMN launched {launches} times for {ran} batches")
    stages = bench_readers._stages_alone(pipe)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with bench_ssd.recording_cmn([]) as calls:
        pipe.run()
    pipe.shutdown()
    held = dict(bench_ssd.time_cmn(calls[0]), max_abs_err=bench_ssd.hold_cmn(calls[0]))
    return {"form": form, "batch": batch, "timed": timed,
            "clips_per_s": timed * batch / dt, "frames_per_s": timed * batch * FRAMES / dt,
            "host_ms_per_batch": 1e3 * st["host_phase_seconds"] / st["host_batches"],
            "device_wait_ms_per_batch": 1e3 * st["device_wait_seconds"] / timed,
            "host_ms_by_schema": dict(sorted(by.items(), key=lambda kv: -kv[1])),
            "stage_ms": dict(sorted(stages.items(), key=lambda kv: -kv[1])),
            "peak_gib": peak, "cmn_launches": launches, "cmn": held}


def yuv_stage(batch=BATCH, reps=20):
    """The YUV -> RGB stage alone on the card at the path's size (batch
    sequences of FRAMES 320x240 frames on the wire): median ms (CUDA events),
    equality with the same call on the CPU, and the bytes it must move (the
    planes read once, the RGB canvas written once)."""
    from dali_tpu_torch.kernels import wire

    h, w = 240, 320
    rng = np.random.default_rng(0)
    fy, fc = FRAMES * h * w, FRAMES * ((h + 1) // 2) * ((w + 1) // 2)
    y = rng.integers(0, 256, batch * fy, dtype=np.uint8)
    u = rng.integers(0, 256, batch * fc, dtype=np.uint8)
    v = rng.integers(0, 256, batch * fc, dtype=np.uint8)
    offs = np.stack([np.arange(batch) * fy, np.arange(batch) * fc]).astype(np.int32)
    shapes = np.tile(np.array([FRAMES, h, w, 3], np.int64), (batch, 1))
    canvas = (FRAMES, h, w, 3)
    args = [torch.from_numpy(a) for a in (y, u, v, offs, shapes)]
    want = wire.yuv420_boundary(*args, canvas, False)
    dev = [a.cuda() for a in args]
    got = wire.yuv420_boundary(*dev, canvas, False)
    if not torch.equal(got.cpu(), want):
        raise AssertionError("yuv420_boundary on the card differs from the CPU")
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        wire.yuv420_boundary(*dev, canvas, False)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    nbytes = int(y.nbytes + u.nbytes + v.nbytes + want.numel())
    return {"ms": float(np.median(times)), "bytes": nbytes, "equal_to_cpu": True,
            "shape_out": list(want.shape)}


def corpus_files(root=CORPUS):
    return [os.path.join(root, c, f) for c in sorted(os.listdir(root))
            for f in sorted(os.listdir(os.path.join(root, c)))]


def decode_rate(root=CORPUS, threads=None, files=None):
    """Frames/s of the host decode of every corpus clip (or of ``files``),
    whole, as planar YUV: on one thread, and on the task pool of
    ``threads`` workers (one task a clip, ``native.video_read_batch``)."""
    from dali_tpu_torch import native

    files = files or corpus_files(root)
    threads = threads or os.cpu_count() or 1
    vfs = [native.VideoFile(p) for p in files]
    counts = [vf.num_frames for vf in vfs]
    outs = [tuple(np.empty(n * s, np.uint8) for s in
                  (vf.width * vf.height, ((vf.width + 1) // 2) * ((vf.height + 1) // 2),
                   ((vf.width + 1) // 2) * ((vf.height + 1) // 2)))
            for vf, n in zip(vfs, counts)]
    t0 = time.perf_counter()
    for vf, n, o in zip(vfs, counts, outs):
        vf.read_yuv(0, n, 1, pad=False, out=o)
    one = time.perf_counter() - t0
    vfs = [native.VideoFile(p) for p in files]
    t0 = time.perf_counter()
    native.video_read_batch(native.shared_pool(threads), vfs, [0] * len(vfs), counts,
                            [1] * len(vfs), outs, yuv=True)
    pool = time.perf_counter() - t0
    total = sum(counts)
    return {"clips": len(files), "frames": total, "frames_per_s_one_thread": total / one,
            "frames_per_s_pool": total / pool, "threads": threads}


def check_fixtures(root=VIDEO):
    """Every committed fixture decoded here against reference.npz: the
    info, each frame's RGB and YUV hash, and the small clips' frames whole.
    Returns the clips and frames compared."""
    from dali_tpu_torch import native

    ref = np.load(os.path.join(root, "reference.npz"))
    names = sorted({k.split(":")[0] for k in ref.files})
    frames = 0
    for name in names:
        path = os.path.join(root, name + ".mp4")
        w, h, n, fps = ref[name + ":info"]
        vf = native.VideoFile(path)
        if (vf.width, vf.height, vf.num_frames, vf.fps) != (w, h, n, fps):
            raise AssertionError(f"{name}: info {(vf.width, vf.height, vf.num_frames, vf.fps)}, "
                                 f"reference {(w, h, n, fps)}")
        rgb = vf.read(0, int(n), pad=False)
        y, u, v, got = native.VideoFile(path).read_yuv(0, int(n), pad=False)
        shas = [hashlib.sha256(f.tobytes()).digest() for f in rgb]
        yshas = [hashlib.sha256(y[i].tobytes() + u[i].tobytes() + v[i].tobytes()).digest()
                 for i in range(got)]
        if shas != [bytes(r) for r in ref[name + ":rgb_sha"]]:
            raise AssertionError(f"{name}: RGB frames differ from reference.npz")
        if yshas != [bytes(r) for r in ref[name + ":yuv_sha"]]:
            raise AssertionError(f"{name}: YUV frames differ from reference.npz")
        if name in WHOLE and not (np.array_equal(rgb, ref[name + ":rgb"])
                                  and np.array_equal(y[:got], ref[name + ":y"])):
            raise AssertionError(f"{name}: frames differ from reference.npz")
        frames += len(rgb)
    return {"clips": len(names), "frames": frames}


def _tensor(x):
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def check_mixed_vs_cpu(batch=BATCH, batches=2, device="cuda:0", root=CORPUS,
                       form="video_clip_train", stride=STRIDE):
    """The recipe as written (cpu reader, then ``.gpu()``) against the timed
    form (mixed reader) on the card: the reader's uint8 frames and the
    labels equal, batch for batch."""
    runs = []
    for reader in ("cpu", "mixed"):
        pipe = make_pipe(batch, device, reader_device=reader, root=root, raw=True,
                         stride=stride)
        runs.append([[_tensor(o.as_tensor()) for o in pipe.run()[1:]] for _ in range(batches)])
        pipe.shutdown()
    frames = 0
    for (lab_c, raw_c), (lab_m, raw_m) in zip(*runs):
        on_card = device == "cpu" or (raw_c.is_cuda and raw_m.is_cuda)
        if not (on_card and raw_c.dtype == torch.uint8 and torch.equal(raw_c, raw_m)
                and torch.equal(lab_c.cpu(), lab_m.cpu())):
            raise AssertionError(f"{form}: the mixed reader's frames differ from the "
                                 "cpu reader's")
        frames += raw_m.shape[0] * raw_m.shape[1]
    return {"batches": batches, "frames": frames}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timed", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_video: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    r = {"fixtures": check_fixtures(), "run": run(timed=args.timed), "yuv_stage": yuv_stage(),
         "decode": decode_rate(), "mixed_vs_cpu": check_mixed_vs_cpu(), "card": card_line()}
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
