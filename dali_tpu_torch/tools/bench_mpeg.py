"""The MPEG-1/2 broadcast-and-archive training path on the card, at full width: ``mpeg_ts_train``.

Broadcast video comes as MPEG-2 in MPEG-TS (DVB, ATSC), DVDs and older
archives as MPEG-2 or MPEG-1 in MPEG-PS. This is
``docs/examples/video_training.py``'s recipe, as ``bench_video.py``'s
``video_clip_train`` runs it, over ``testdata/video/mpeg_corpus``: 16
MPEG-2 clips in TS (cv2's ``mpg2``: a GOP of 12, two B-pictures, open
GOPs) and 16 MPEG-1 clips in PS (cv2's ``mpg1``), 320x240 at 25 fps, in two
class folders, so both demuxers, the open-GOP seek and the handle cache's
forward decode and backward seek over real GOPs are on the path.
``readers.video(device="mixed", file_root=..., sequence_length=8,
stride=2, random_shuffle=True, pad_mode="edge")`` (class 1: the planar YUV
wire, RGB on the card), ``resize`` to 112x112, ``rotate`` and
``gaussian_blur`` drawn once a sequence, ``crop_mirror_normalize`` to FLOAT
FCHW with a coin-flip mirror (the CMN kernel's FCHW fold on
``[32, 8, 112, 112, 3]`` uint8); batch 32.

``check_fixtures`` holds every committed MPEG-1/2 file (the fixtures of
``testdata/video/mpeg`` and the corpus), decoded on this machine by the
port's host decoder, against ``testdata/video/mpeg_reference.npz``
(dali_tpu's FFmpeg 5.1 read and info, and FFmpeg's display-order decode,
which reads after seeks through one handle must give). ``check_spliced``
holds the two cv2 TS segments of different sizes spliced:
``VideoPixfmtChanged`` from the planar read, and the mixed decode equal to
the cpu one on the card. ``run``, ``decode_rate`` and
``check_mixed_vs_cpu`` are ``bench_video``'s over the MPEG corpus;
``run(max_open_files=8)`` runs the path with a handle cache smaller than
the corpus, so that reads reopen files, and ``open_cost`` times the open
against the file's length.

    python dali_tpu_torch/tools/bench_mpeg.py [--timed 10]

runs all of it on the card and prints one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VIDEO = os.path.join(REPO, "dali_tpu_torch", "testdata", "video")
MPEG_CORPUS = os.path.join(VIDEO, "mpeg_corpus")
SPLICED = os.path.join(VIDEO, "mpeg", "spliced_64x48_32x24.ts")
FORM = "mpeg_ts_train"


def _yuv_shas(vf, start, count, stride=1):
    y, u, v, got = vf.read_yuv(start, count, stride, pad=False)
    return [hashlib.sha256(y[i].tobytes() + u[i].tobytes() + v[i].tobytes()).digest()
            for i in range(got)]


def check_fixtures(root=VIDEO):
    """Every file of mpeg_reference.npz decoded here: its info (width,
    height, frames, fps, pixel-format class), each frame's RGB and YUV hash
    from frame 0, and, where the reference holds FFmpeg's display order,
    reads that seek back and forth through one handle. Returns the files,
    frames and seeks compared."""
    from dali_tpu_torch import native

    ref = np.load(os.path.join(root, "mpeg_reference.npz"))
    names = sorted({k.split(":")[0] for k in ref.files})
    frames = seeks = 0
    for name in names:
        path = os.path.join(root, name)
        vf = native.VideoFile(path)
        info = (vf.width, vf.height, vf.num_frames, vf.fps, vf.pixfmt_class)
        if info != tuple(ref[name + ":info"].tolist()):
            raise AssertionError(f"{name}: info {info}, reference {ref[name + ':info']}")
        n = len(ref[name + ":rgb_sha"])
        shas = [hashlib.sha256(f.tobytes()).digest() for f in vf.read(0, n, pad=False)]
        if shas != [bytes(r) for r in ref[name + ":rgb_sha"]]:
            raise AssertionError(f"{name}: RGB frames differ from mpeg_reference.npz")
        yuv = name + ":yuv_sha"
        if yuv in ref.files and _yuv_shas(native.VideoFile(path), 0, n) != [
                bytes(r) for r in ref[yuv]]:
            raise AssertionError(f"{name}: YUV frames differ from mpeg_reference.npz")
        disp = name + ":display_sha"
        if disp in ref.files and not name.endswith((".m1v", ".m2v")):
            want = [bytes(r) for r in ref[disp]]
            vf = native.VideoFile(path)
            for start in (len(want) - 3, 1, len(want) // 2, 0, 13 % len(want)):
                if _yuv_shas(vf, start, 3) != want[start: start + 3]:
                    raise AssertionError(f"{name}: the read from {start} after a seek differs "
                                         "from the display order")
                seeks += 1
        frames += len(shas)
    return {"files": len(names), "frames": frames, "seeks": seeks}


def check_spliced(device="cuda:0", path=SPLICED):
    """Two cv2 TS segments of different sizes byte-concatenated: the planar
    read raises VideoPixfmtChanged after the frames before the splice, and
    ``decoders.video`` over the file's bytes on ``device="mixed"`` (which
    falls back to the dense path) equals the cpu decoder's, on the card."""
    from dali_tpu_torch import fn, native, pipeline_def

    try:
        native.VideoFile(path).read_yuv(0, 20, 1, pad=True)
    except native.VideoPixfmtChanged as e:
        got = e.got
    else:
        raise AssertionError("spliced TS: the planar read did not raise VideoPixfmtChanged")
    blob = np.frombuffer(open(path, "rb").read(), np.uint8)
    outs = {}
    for reader in ("cpu", "mixed"):
        @pipeline_def(batch_size=1, num_threads=1, seed=5, device=device)
        def spliced():
            buf = fn.external_source(source=lambda: [blob], batch=True, cycle=True)
            return fn.decoders.video(buf, sequence_length=20, device=reader)

        pipe = spliced()
        pipe.build()
        out = pipe.run()[0].as_tensor()
        outs[reader] = (out if torch.is_tensor(out) else torch.from_numpy(np.asarray(out))).cpu()
        pipe.shutdown()
    if not torch.equal(outs["cpu"], outs["mixed"]):
        raise AssertionError("spliced TS: the mixed decode differs from the cpu one")
    return {"changed_after": got, "frames": int(outs["mixed"].shape[1])}


def run(warmup=3, timed=10, max_open_files=None):
    """``bench_video.run`` over the MPEG corpus. ``max_open_files`` below
    the corpus's 32 files makes the reader's handle cache drop and reopen
    files, as a dataset of more files than the cache does: each such read
    opens its file anew (the demuxer's pass and the header pass) and
    seeks."""
    from dali_tpu_torch.backend import video as video_backend
    from dali_tpu_torch.tools import bench_video

    keep = video_backend._MAX_OPEN_FILES
    if max_open_files is not None:
        video_backend._MAX_OPEN_FILES = max_open_files
    try:
        return bench_video.run(warmup=warmup, timed=timed, root=MPEG_CORPUS, form=FORM)
    finally:
        video_backend._MAX_OPEN_FILES = keep


def open_cost(lengths=(1, 16, 64), reps=5, work=None):
    """The open's cost against the file's length: for TS and PS, the first
    corpus clip and ``n`` clips byte-concatenated (both containers
    concatenate; the clips repeat past 16), written under ``work`` (a
    temporary directory by default). Each file is opened ``reps`` times
    from its path with the page cache warm; the least time is kept, with
    the handle's index bytes (``VideoFile.index_bytes``). Every clip holds
    the same pictures (a whole read of the first gives their number)."""
    import tempfile

    from dali_tpu_torch import native

    out = []
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        for kind, ext in (("ts", "ts"), ("ps", "mpg")):
            clips = sorted(os.listdir(os.path.join(MPEG_CORPUS, kind)))
            blobs = [open(os.path.join(MPEG_CORPUS, kind, c), "rb").read() for c in clips]
            first = native.VideoFile(os.path.join(MPEG_CORPUS, kind, clips[0]))
            per_clip = first.read_yuv(0, 4 * first.num_frames + 64, 1, pad=False)[3]
            for n in lengths:
                path = os.path.join(tmp, f"{kind}_{n}.{ext}")
                with open(path, "wb") as f:
                    for i in range(n):
                        f.write(blobs[i % len(blobs)])
                best = float("inf")
                for _ in range(reps):
                    t0 = time.perf_counter()
                    vf = native.VideoFile(path)
                    best = min(best, time.perf_counter() - t0)
                    index = vf.index_bytes()
                    vf.close()
                size = os.path.getsize(path)
                pictures = n * per_clip
                out.append({"container": kind, "clips": n, "bytes": size, "pictures": pictures,
                            "open_ms": 1e3 * best, "ms_per_mib": 1e3 * best / (size / 2 ** 20),
                            "index_bytes": index, "index_bytes_per_picture": index / pictures})
    return out


def decode_rate(threads=None):
    """Frames/s of the host decode of the whole corpus as planar YUV, on one
    thread and on ``threads`` (``bench_video.decode_rate``)."""
    from dali_tpu_torch.tools import bench_video

    return bench_video.decode_rate(MPEG_CORPUS, threads=threads)


def check_mixed_vs_cpu():
    from dali_tpu_torch.tools import bench_video

    return bench_video.check_mixed_vs_cpu(root=MPEG_CORPUS, form=FORM)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timed", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_mpeg: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from dali_tpu_torch.tools import bench_video

    r = {"fixtures": check_fixtures(), "spliced": check_spliced(), "run": run(timed=args.timed),
         "reopen": run(timed=args.timed, max_open_files=8), "open_cost": open_cost(),
         "decode": decode_rate(8), "mixed_vs_cpu": check_mixed_vs_cpu(),
         "card": bench_video.card_line()}
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
