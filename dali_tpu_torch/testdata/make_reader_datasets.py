"""Datasets in the stored formats the readers take, written at run time from
the committed 32-file corpus (``testdata/rn50``) and from seeds; nothing is
committed or downloaded.

- ``write_wds_shards``: WebDataset POSIX-tar shards, one ``<key>.jpg`` (or,
  from the WebP corpus ``testdata/webp``, ``<key>.webp``) and one
  ``<key>.cls`` (the label as ASCII digits) member per sample, keys sorted,
  with ``wds2idx`` index files (``ext offset size basename`` lines) when
  asked;
- ``write_tfrecords``: TFRecord files of tf.Example records with
  ``image/encoded`` (the JPEG bytes) and ``image/class/label`` (int64 [1]),
  the features of DALI's TensorFlow ResNet-50 example, each with its
  ``tfrecord2idx`` index (``offset size`` lines);
- ``write_npy_volumes``: ``.npy`` float32 volumes from a seed, e.g. BraTS's
  four modalities at 240x240x155 (``[4, 155, 240, 240]``, 143 MB each).

The corpus repeats to the number of samples asked for; sample ``i`` is
corpus file ``i % 32`` with its class label.

Usage: python dali_tpu_torch/testdata/make_reader_datasets.py ROOT [--samples N]
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import tarfile

import numpy as np

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rn50")
WEBP_CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "webp")
FEATURES = ("image/encoded", "image/class/label")


def corpus_samples(n: int, corpus: str = CORPUS):
    """``n`` (encoded image bytes, label) pairs: the sorted corpus repeated."""
    files = sorted((c, f) for c in sorted(os.listdir(corpus))
                   for f in sorted(os.listdir(os.path.join(corpus, c))))
    data = []
    for c, f in files:
        with open(os.path.join(corpus, c, f), "rb") as fh:
            data.append((fh.read(), int(c[len("class"):])))
    return [data[i % len(data)] for i in range(n)]


def _split(n: int, parts: int):
    return [(k * n // parts, (k + 1) * n // parts) for k in range(parts)]


def write_wds_shards(root: str, n_samples: int, n_shards: int, index: bool = False,
                     ext: str = "jpg", corpus: str = CORPUS):
    """``n_shards`` tar shards of the first ``n_samples`` samples of
    ``corpus``, the image member named ``<key>.<ext>``; returns (shard
    paths, index paths or None)."""
    os.makedirs(root, exist_ok=True)
    samples = corpus_samples(n_samples, corpus)
    paths, index_paths = [], []
    for s, (lo, hi) in enumerate(_split(n_samples, n_shards)):
        path = os.path.join(root, f"shard-{s:05d}.tar")
        with tarfile.open(path, "w", format=tarfile.USTAR_FORMAT) as tar:
            for i in range(lo, hi):
                jpeg, label = samples[i]
                for member, payload in ((ext, jpeg), ("cls", str(label).encode())):
                    info = tarfile.TarInfo(f"{i:08d}.{member}")
                    info.size = len(payload)
                    tar.addfile(info, io.BytesIO(payload))
        paths.append(path)
        if index:
            index_paths.append(path[:-len(".tar")] + ".idx")
            with tarfile.open(path) as tar, open(index_paths[-1], "w") as out:
                for m in tar:
                    if m.isfile():
                        base, _, kind = m.name.partition(".")
                        out.write(f"{kind} {m.offset_data} {m.size} {base}\n")
    return paths, (index_paths if index else None)


def write_tfrecords(root: str, n_samples: int, n_files: int):
    """``n_files`` TFRecord files of the first ``n_samples`` corpus samples
    and their index files; returns (record paths, index paths)."""
    from dali_tpu_torch import tfrecord

    os.makedirs(root, exist_ok=True)
    samples = corpus_samples(n_samples)
    paths, index_paths = [], []
    for k, (lo, hi) in enumerate(_split(n_samples, n_files)):
        path = os.path.join(root, f"train-{k:05d}-of-{n_files:05d}")
        with open(path, "wb") as f:
            for jpeg, label in samples[lo:hi]:
                tfrecord.write_record(f, tfrecord.write_example(
                    {FEATURES[0]: jpeg, FEATURES[1]: np.array([label], np.int64)}))
        idx = path + ".idx"
        tfrecord.write_index(path, idx)
        paths.append(path)
        index_paths.append(idx)
    return paths, index_paths


def write_npy_volumes(root: str, n: int, shape, seed: int = 0):
    """``n`` float32 volumes of ``shape`` from ``seed``; returns their paths."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        path = os.path.join(root, f"volume_{i:03d}.npy")
        np.save(path, rng.standard_normal(shape, dtype=np.float32))
        paths.append(path)
    return paths


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--samples", type=int, default=1024)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))))
    shards, _ = write_wds_shards(os.path.join(args.root, "wds"), args.samples, 4, index=True)
    records, _ = write_tfrecords(os.path.join(args.root, "tfrecord"), args.samples, 4)
    print("\n".join(shards + records))


if __name__ == "__main__":
    main()
