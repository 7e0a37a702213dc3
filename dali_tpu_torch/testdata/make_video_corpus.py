"""The MP4 / MPEG-4 Part 2 fixtures of dali_tpu_torch's video decode
(``testdata/video``) and the card's video corpus.

Every file is written by OpenCV's ``cv2.VideoWriter`` with the ``mp4v``
fourcc, the form the reference's tests and recipes write (FFmpeg's
``mpeg4`` encoder at its defaults: Simple Profile, I- and P-VOPs, a GOP of
12, ``mdat`` before ``moov``):

* ``flat_48x32.mp4`` — 24 flat frames of rising brightness, the clip of
  ``tests/test_video.py``;
* ``pan_64x48.mp4`` — 12 frames of a random texture panned a column a
  frame, the clip of ``tests/test_video_yuv_wire.py``;
* ``recipe_160x120.mp4`` — 40 frames at the size the video training recipe
  resizes from (120 rows: not a multiple of 16);
* ``odd_170x98.mp4`` — 30 frames at a size that is a multiple of neither 16
  nor 2, with sub-pixel motion and a scene cut;
* ``corpus/<class>/<clip>.mp4`` — 4 classes of 8 clips at 320x240 and
  25 fps (UCF101's frame size and rate), 48-96 frames each: sub-pixel pans,
  a zoom, noise and, in some clips, a scene cut, so that half-sample motion,
  both rounding modes, intra macroblocks in P-VOPs and AC prediction all
  occur. This is the corpus of the ``video_clip_train`` path on the card.

The reference decode of each fixture (``video/reference.npz``, what the
card's machine, which has no FFmpeg, holds the port against) is written
afterwards by ``tests/write_video_reference.py``, outside this package,
since it runs dali_tpu.

Run on a machine with OpenCV, from the repo root:

    python dali_tpu_torch/testdata/make_video_corpus.py [out_dir]
    python tests/write_video_reference.py [out_dir]
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "video")
CLASSES = ("pan", "drift", "zoom", "cut")
CLIPS_PER_CLASS = 8
CORPUS_SIZE = (320, 240)
FPS = 25


def _texture(rng, h, w):
    """A smooth random colour texture: blurred noise at two scales."""
    import cv2

    coarse = cv2.resize(rng.integers(0, 256, (h // 32 + 2, w // 32 + 2, 3), np.uint8), (w, h),
                        interpolation=cv2.INTER_CUBIC)
    fine = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8), (0, 0), 3.0)
    return cv2.addWeighted(coarse, 0.7, fine, 0.3, 0)


def write_clip(path, frames, fps=FPS):
    import cv2

    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not wr.isOpened():
        raise RuntimeError("cv2 cannot write mp4v")
    for f in frames:
        wr.write(np.ascontiguousarray(f))
    wr.release()


def moving_frames(rng, n, w, h, motion, noise=3.0, cut_at=None):
    """``n`` frames of a texture under ``motion`` ("pan", "drift" or
    "zoom"), with Gaussian noise and an optional scene cut."""
    import cv2

    scenes = [_texture(rng, h + 96, w + 160), _texture(rng, h + 96, w + 160)]
    out = []
    for i in range(n):
        src = scenes[1 if cut_at is not None and i >= cut_at else 0]
        if motion == "pan":
            m = np.float32([[1, 0, -(8 + 1.37 * i)], [0, 0, 0]])
            m[1] = [0, 1, -(16 + 0.31 * i)]
        elif motion == "drift":
            m = np.float32([[1, 0, -(60 + 23 * np.sin(i / 9.0))],
                            [0, 1, -(40 + 17 * np.cos(i / 7.0))]])
        else:
            s = 1.0 + 0.004 * i
            cx, cy = (w + 160) / 2, (h + 96) / 2
            m = np.float32([[s, 0, w / 2 - s * cx], [0, s, h / 2 - s * cy]])
        f = cv2.warpAffine(src, m, (w, h), flags=cv2.INTER_LINEAR,
                           borderMode=cv2.BORDER_REFLECT)
        f = np.clip(f + rng.normal(0, noise, f.shape), 0, 255).astype(np.uint8)
        out.append(f)
    return out


def write_fixtures(out_dir=OUT):
    os.makedirs(out_dir, exist_ok=True)
    # tests/test_video.py _write_video
    write_clip(os.path.join(out_dir, "flat_48x32.mp4"),
               [np.full((32, 48, 3), i * 8 % 256, np.uint8) for i in range(24)])
    # tests/test_video_yuv_wire.py _write_video
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (48, 64 * 3, 3), np.uint8)
    write_clip(os.path.join(out_dir, "pan_64x48.mp4"),
               [np.ascontiguousarray(base[:, i: i + 64]) for i in range(12)])
    rng = np.random.default_rng(160)
    write_clip(os.path.join(out_dir, "recipe_160x120.mp4"),
               moving_frames(rng, 40, 160, 120, "pan"))
    rng = np.random.default_rng(170)
    write_clip(os.path.join(out_dir, "odd_170x98.mp4"),
               moving_frames(rng, 30, 170, 98, "drift", cut_at=17))


def corpus_files(root):
    return [os.path.join(root, c, f"{c}_{k:02d}.mp4") for c in CLASSES
            for k in range(CLIPS_PER_CLASS)]


def write_corpus(root):
    w, h = CORPUS_SIZE
    for ci, cls in enumerate(CLASSES):
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        for k in range(CLIPS_PER_CLASS):
            rng = np.random.default_rng(1000 * ci + k)
            n = 48 + 6 * k  # 48-90 frames
            motion = cls if cls != "cut" else ("pan", "drift", "zoom")[k % 3]
            frames = moving_frames(rng, n, w, h, motion, noise=1.0,
                                   cut_at=n // 2 if cls == "cut" else None)
            write_clip(os.path.join(root, cls, f"{cls}_{k:02d}.mp4"), frames)


def main(argv):
    out_dir = argv[1] if len(argv) > 1 else OUT
    write_fixtures(out_dir)
    write_corpus(os.path.join(out_dir, "corpus"))
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(out_dir)
                for f in fs)
    print(f"{out_dir}: {total} bytes")


if __name__ == "__main__":
    main(sys.argv)
