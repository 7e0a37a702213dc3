"""Regenerate the committed RN50 fixture corpus (``testdata/rn50``).

32 baseline 4:2:0 JPEGs at quality 85, in two class folders, at the
ImageNet-like sizes of ``bench.py`` (333-640 px). Content is an 8x-upscaled
random image, as in ``tools/hybrid_fixture.py``, so the sparse coefficient
wire carries a realistic mask density. Needs OpenCV (cv2); reading the corpus
does not.

Usage: python dali_tpu_torch/testdata/make_corpus.py
"""

from __future__ import annotations

import os

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rn50")
SIZES = [(375, 500), (500, 375), (333, 500), (480, 640), (500, 500), (400, 600)]
N_FILES = 32
N_CLASSES = 2


def main():
    import cv2

    rng = np.random.default_rng(2024)
    for i in range(N_FILES):
        h, w = SIZES[i % len(SIZES)]
        d = os.path.join(OUT, f"class{i % N_CLASSES}")
        os.makedirs(d, exist_ok=True)
        small = rng.integers(0, 256, (h // 8, w // 8, 3), "uint8")
        cv2.imwrite(os.path.join(d, f"img_{i:02d}.jpg"), cv2.resize(small, (w, h)),
                    [cv2.IMWRITE_JPEG_QUALITY, 85])


if __name__ == "__main__":
    main()
