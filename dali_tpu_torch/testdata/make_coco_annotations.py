"""A COCO-format annotation file over the committed 32-file corpus
(``testdata/rn50``), made from a seed, for the detection recipes.

COCO is not in the repository; the file is written at run time (under
``build/`` or a test's temporary directory) and never committed. Its shape
follows COCO train2017 (860,001 instances over 118,287 images, about 7.3 per
image, with a long tail): ``n_images`` entries with distinct ids, each
pointing at one of the corpus files (repeated) and holding boxes of its own.

- box counts: geometric with mean ~7.3, capped at 50; ~2% of images empty;
- box sides log-uniform from 2% to 90% of the image side; ~1% of boxes are
  narrower than one pixel, so the reader's default ``size_threshold`` (0.1)
  drops some of them;
- ~1% of boxes ``iscrowd``; the 80 COCO category ids (1-90, with gaps), so
  the reader's class remapping has work to do;
- one polygon per box (an ellipse of 4-12 vertices inside it) as its
  ``segmentation``.

Usage: python dali_tpu_torch/testdata/make_coco_annotations.py [out.json] [--seed N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rn50")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "build", "coco_annotations.json")
COCO_CATEGORY_IDS = [c for c in range(1, 91)
                     if c not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)]
MEAN_BOXES, MAX_BOXES = 7.3, 50
EMPTY_SHARE, CROWD_SHARE, TINY_SHARE = 0.02, 0.01, 0.01


def corpus_files():
    """(relative path, width, height) of every corpus image, sorted."""
    from dali_tpu_torch.imgcodec import peek_shape

    out = []
    for cls in sorted(os.listdir(CORPUS)):
        for name in sorted(os.listdir(os.path.join(CORPUS, cls))):
            rel = f"{cls}/{name}"
            with open(os.path.join(CORPUS, rel), "rb") as f:
                h, w, _ = peek_shape(f.read())
            out.append((rel, int(w), int(h)))
    return out


def make_annotations(seed: int, n_images: int = 256) -> dict:
    rng = np.random.default_rng(seed)
    files = corpus_files()
    ids = np.sort(rng.choice(10 * n_images, n_images, replace=False)) + 1
    ids = rng.permutation(ids)  # entry order differs from id order
    images, annotations = [], []
    for i, img_id in enumerate(ids):
        rel, w, h = files[i % len(files)]
        images.append({"id": int(img_id), "file_name": rel, "width": w, "height": h})
        if rng.random() < EMPTY_SHARE:
            continue
        for _ in range(min(MAX_BOXES, int(rng.geometric(1.0 / MEAN_BOXES)))):
            bw, bh = np.exp(rng.uniform(np.log(0.02), np.log(0.9), 2)) * (w, h)
            if rng.random() < TINY_SHARE:
                bw = rng.uniform(0.01, 0.99)
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            k = int(rng.integers(4, 13))
            t = np.sort(rng.uniform(0, 2 * np.pi, k))
            poly = np.stack([x + bw / 2 * (1 + np.cos(t)), y + bh / 2 * (1 + np.sin(t))], 1)
            annotations.append({
                "id": len(annotations) + 1, "image_id": int(img_id),
                "category_id": int(rng.choice(COCO_CATEGORY_IDS)),
                "bbox": [round(float(v), 2) for v in (x, y, bw, bh)],
                "area": round(float(bw * bh), 2),
                "iscrowd": int(rng.random() < CROWD_SHARE),
                "segmentation": [[round(float(v), 2) for v in poly.reshape(-1)]]})
    return {"images": images, "annotations": annotations,
            "categories": [{"id": c, "name": f"category_{c}"} for c in COCO_CATEGORY_IDS]}


def write_annotations(path: str, seed: int, n_images: int = 256) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(make_annotations(seed, n_images), f)
    return path


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default=DEFAULT_OUT)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(write_annotations(args.out, args.seed))
