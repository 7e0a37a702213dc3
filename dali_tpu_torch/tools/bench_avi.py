"""The UCF101-form AVI training path on the card, at full width: ``ucf_avi_train``.

UCF101 and HMDB51 ship as ``.avi`` files of XviD/DivX MPEG-4 Part 2. This
is ``docs/examples/video_training.py``'s recipe, as ``bench_video.py``'s
``video_clip_train`` runs it, over ``testdata/video/avi_corpus``: the 32
clips of the MP4 corpus (4 classes, 320x240 at 25 fps) re-encoded by
``libxvid`` with B-frames into AVI, so packed bitstreams with N-VOP
placeholders, Xvid's IDCT and display-order numbering are on the path.
``readers.video(device="mixed", file_root=..., sequence_length=8,
stride=2, random_shuffle=True, pad_mode="edge")`` (the planar YUV wire, RGB
on the card), ``resize`` to 112x112, ``rotate`` and ``gaussian_blur``
drawn once a sequence, ``crop_mirror_normalize`` to FLOAT FCHW with a
coin-flip mirror (the CMN kernel's FCHW fold on ``[32, 8, 112, 112, 3]``
uint8); batch 32.

``check_fixtures`` holds every committed AVI file (the fixtures of
``testdata/video/avi`` and the corpus), decoded on this machine by the
port's host decoder, against ``testdata/video/avi_reference.npz``
(FFmpeg 5.1's display-order decode and dali_tpu's info) in RGB and planar
YUV. ``run``, ``decode_rate`` and ``check_mixed_vs_cpu`` are
``bench_video``'s over the AVI corpus.

    python dali_tpu_torch/tools/bench_avi.py [--timed 10]

runs all of it on the card and prints one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VIDEO = os.path.join(REPO, "dali_tpu_torch", "testdata", "video")
AVI_CORPUS = os.path.join(VIDEO, "avi_corpus")
FORM = "ucf_avi_train"


def check_fixtures(root=VIDEO):
    """Every AVI file of avi_reference.npz decoded here: its info (width,
    height, frames, fps, pixel-format class) and each frame's RGB and YUV
    hash. Returns the files and frames compared."""
    from dali_tpu_torch import native

    ref = np.load(os.path.join(root, "avi_reference.npz"))
    names = sorted({k.split(":")[0] for k in ref.files})
    frames = 0
    for name in names:
        path = os.path.join(root, name + ".avi")
        vf = native.VideoFile(path)
        info = (vf.width, vf.height, vf.num_frames, vf.fps, vf.pixfmt_class)
        if info != tuple(ref[name + ":info"].tolist()):
            raise AssertionError(f"{name}: info {info}, reference {ref[name + ':info']}")
        rgb = vf.read(0, vf.num_frames, pad=False)
        y, u, v, got = native.VideoFile(path).read_yuv(0, vf.num_frames, pad=False)
        shas = [hashlib.sha256(f.tobytes()).digest() for f in rgb]
        yshas = [hashlib.sha256(y[i].tobytes() + u[i].tobytes() + v[i].tobytes()).digest()
                 for i in range(got)]
        if shas != [bytes(r) for r in ref[name + ":rgb_sha"]]:
            raise AssertionError(f"{name}: RGB frames differ from avi_reference.npz")
        if yshas != [bytes(r) for r in ref[name + ":yuv_sha"]]:
            raise AssertionError(f"{name}: YUV frames differ from avi_reference.npz")
        frames += len(rgb)
    return {"files": len(names), "frames": frames}


def run(warmup=3, timed=10):
    from dali_tpu_torch.tools import bench_video

    return bench_video.run(warmup=warmup, timed=timed, root=AVI_CORPUS, form=FORM)


def decode_rate():
    from dali_tpu_torch.tools import bench_video

    return bench_video.decode_rate(AVI_CORPUS)


def check_mixed_vs_cpu():
    from dali_tpu_torch.tools import bench_video

    return bench_video.check_mixed_vs_cpu(root=AVI_CORPUS, form=FORM)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timed", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_avi: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from dali_tpu_torch.tools import bench_video

    r = {"fixtures": check_fixtures(), "run": run(timed=args.timed), "decode": decode_rate(),
         "mixed_vs_cpu": check_mixed_vs_cpu(), "card": bench_video.card_line()}
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
