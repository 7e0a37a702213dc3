"""The lossless-capture training path on the card, at full width: ``capture_avi_train``.

Lab capture (behaviour and pose recordings) is stored lossless, as the FFV1
or HuffYUV AVIs that OpenCV's ``VideoWriter`` and FFmpeg write, and webcams
record Motion JPEG 4:2:2. None of these is 4:2:0: the reference converts
them to RGB through libswscale (pixel-format class 0), and so does the
port, through its rebuild (``csrc/host/sws_rgb.cc``). This is
``docs/examples/video_training.py``'s recipe, as ``bench_video.py``'s
``video_clip_train`` runs it, over ``testdata/video/capture_corpus``: 320x240
AVIs at 25 fps of ``make_video_corpus``'s moving scenes, one codec a class
folder: 4 HuffYUV 4:2:2 clips of 10 frames (FFmpeg's ``huffyuv``, median
predictor), 2 FFV1 clips of 16 (cv2's ``FFV1`` writer: RGB32, version 3,
slice CRCs, a GOP of 12, so a sequence may start 8 frames into a GOP) and
24 Motion JPEG 4:2:2 clips of 10 (FFmpeg's ``mjpeg``). ``readers.video(device="mixed",
file_root=..., sequence_length=8, stride=1, random_shuffle=True,
pad_mode="edge")``: the corpus is class 0, so the mixed reader takes the
dense RGB path (decoded and converted on the host, RGB24 across); then
``resize`` to 112x112, ``rotate`` and ``gaussian_blur`` drawn once a
sequence, ``crop_mirror_normalize`` to FLOAT FCHW with a coin-flip mirror
(the CMN kernel's FCHW fold on ``[32, 8, 112, 112, 3]`` uint8); batch 32.

``check_fixtures`` holds every committed file of ``testdata/video/capture``
and of the corpus, decoded on this machine by the port, against
``testdata/video/capture_reference.npz`` (dali_tpu's FFmpeg 5.1 and
libswscale 6.7 decode): info and each frame's RGB hash, the planes of the
4:2:0 ones, and the forms left to item 8b raising NotImplementedError.
``run`` is ``bench_video``'s over the corpus at stride 1, with the time the
reads spent in the swscale rebuild (``native.sws_clock``); ``decode_rate``
decodes the corpus whole to RGB on one thread and on the pool, with the
rebuild's share of the one-thread time; ``check_mixed_vs_cpu`` is
``bench_video``'s.

    python dali_tpu_torch/tools/bench_capture.py [--timed 10]

runs all of it on the card and prints one JSON line.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VIDEO = os.path.join(REPO, "dali_tpu_torch", "testdata", "video")
CAPTURE_CORPUS = os.path.join(VIDEO, "capture_corpus")
FORM = "capture_avi_train"
STRIDE = 1
# committed files of forms left to item 8b: they must raise, not decode
LEFT = ("capture/ffvh_422p10_64x48", "capture/ffv1_422p10_64x48",
        "capture/mjpeg_fields_64x48")


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).digest()


def check_fixtures(root=VIDEO):
    """Every file of capture_reference.npz decoded here: its info (width,
    height, frames, fps, pixel-format class), each frame's RGB hash and, for
    the 4:2:0 files, each frame's planes; the forms left to item 8b raise.
    Returns the files and frames compared."""
    from dali_tpu_torch import native

    ref = np.load(os.path.join(root, "capture_reference.npz"))
    names = sorted({k.split(":")[0] for k in ref.files})
    frames = 0
    for name in names:
        path = os.path.join(root, name + ".avi")
        if name in LEFT:
            try:
                native.VideoFile(path).read(0, 1)
            except NotImplementedError as e:
                if "item 8b" not in str(e):
                    raise
                continue
            raise AssertionError(f"{name}: a form left to item 8b decoded")
        vf = native.VideoFile(path)
        info = (vf.width, vf.height, vf.num_frames, vf.fps, vf.pixfmt_class)
        if info != tuple(ref[name + ":info"].tolist()):
            raise AssertionError(f"{name}: info {info}, reference {ref[name + ':info']}")
        rgb = vf.read(0, vf.num_frames, pad=False)
        if [_sha(f) for f in rgb] != [bytes(r) for r in ref[name + ":rgb_sha"]]:
            raise AssertionError(f"{name}: RGB frames differ from capture_reference.npz")
        if vf.pixfmt_class:
            y, u, v, got = native.VideoFile(path).read_yuv(0, vf.num_frames, pad=False)
            yshas = [hashlib.sha256(y[i].tobytes() + u[i].tobytes() + v[i].tobytes()).digest()
                     for i in range(got)]
            if yshas != [bytes(r) for r in ref[name + ":yuv_sha"]]:
                raise AssertionError(f"{name}: YUV frames differ from capture_reference.npz")
        frames += len(rgb)
    return {"files": len(names) - len(LEFT), "frames": frames, "left_raised": len(LEFT)}


def run(warmup=3, timed=10, batch=None):
    """``bench_video.run`` over the capture corpus at stride 1, and the
    swscale rebuild's time over the run: seconds summed over the threads
    that read, frames converted, ms a frame and a batch."""
    from dali_tpu_torch import native
    from dali_tpu_torch.tools import bench_video

    batch = batch or bench_video.BATCH
    native.sws_clock(reset=True)
    r = bench_video.run(batch=batch, warmup=warmup, timed=timed, root=CAPTURE_CORPUS, form=FORM,
                        stride=STRIDE)
    seconds, frames = native.sws_clock(reset=True)
    per_frame = 1e3 * seconds / max(frames, 1)
    r["sws"] = {"seconds": seconds, "frames": frames, "ms_per_frame": per_frame,
                "ms_per_batch_summed": per_frame * batch * bench_video.FRAMES}
    return r


def decode_rate(root=CAPTURE_CORPUS, threads=None):
    """Frames/s of the host decode of every corpus clip, whole, to RGB24:
    on one thread (with the swscale rebuild's share of that time and the
    ms a frame of each class folder's codec), and on the task pool of
    ``threads`` workers (one task a clip)."""
    from dali_tpu_torch import native
    from dali_tpu_torch.tools import bench_video

    files = bench_video.corpus_files(root)
    threads = threads or os.cpu_count() or 1
    vfs = [native.VideoFile(p) for p in files]
    counts = [vf.num_frames for vf in vfs]
    outs = [np.empty((n, vf.height, vf.width, 3), np.uint8) for vf, n in zip(vfs, counts)]
    classes = [os.path.basename(os.path.dirname(p)) for p in files]
    class_s = collections.Counter()
    native.sws_clock(reset=True)
    t0 = time.perf_counter()
    for vf, n, o, c in zip(vfs, counts, outs, classes):
        t1 = time.perf_counter()
        o[:] = vf.read(0, n, 1, pad=False)
        class_s[c] += time.perf_counter() - t1
    one = time.perf_counter() - t0
    sws_one, _ = native.sws_clock(reset=True)
    vfs = [native.VideoFile(p) for p in files]
    t0 = time.perf_counter()
    native.video_read_batch(native.shared_pool(threads), vfs, [0] * len(vfs), counts,
                            [1] * len(vfs), outs, yuv=False)
    pool = time.perf_counter() - t0
    total = sum(counts)
    by_class = collections.Counter()
    for c, n in zip(classes, counts):
        by_class[c] += n
    return {"clips": len(files), "frames": total, "frames_by_class": dict(by_class),
            "ms_per_frame_by_class": {c: 1e3 * class_s[c] / by_class[c] for c in by_class},
            "frames_per_s_one_thread": total / one, "frames_per_s_pool": total / pool,
            "threads": threads, "sws_share_one_thread": sws_one / one}


def check_mixed_vs_cpu(batches=2, device="cuda:0"):
    from dali_tpu_torch.tools import bench_video

    return bench_video.check_mixed_vs_cpu(batches=batches, device=device, root=CAPTURE_CORPUS,
                                          form=FORM, stride=STRIDE)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timed", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_capture: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from dali_tpu_torch.tools import bench_video

    r = {"fixtures": check_fixtures(), "run": run(timed=args.timed)}
    r.update(decode=decode_rate(threads=8), mixed_vs_cpu=check_mixed_vs_cpu(),
             card=bench_video.card_line())
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
