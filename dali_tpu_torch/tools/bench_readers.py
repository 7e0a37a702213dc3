"""ImageNet training fed by stored-format readers, and 3-D volumes read to the
card, at full width:

- ``wds_train``: ``docs/examples/webdataset_ingest.py``'s recipe over
  WebDataset tar shards (``.jpg`` + ``.cls`` members, ``wds2idx`` index
  files): ``readers.webdataset(ext=["jpg", "cls"], random_shuffle=True)``,
  the whole-image hybrid decode as the ImageNet training recipe runs it
  (``hybrid_scale=2``, int8 wire), ``random_resized_crop(224)`` and CMN to
  FLOAT CHW with a coin-flip mirror;
- ``tfrecord_train``: the input of DALI's TensorFlow ResNet-50 example over
  TFRecord files (``image/encoded``, ``image/class/label`` int64 [1], default
  -1, ``tfrecord2idx`` index files): ``readers.tfrecord``, the host decode of
  ``decoders.image_random_crop(device="mixed")`` with its default window
  arguments, ``resize`` to 224x224 and CMN to FLOAT HWC (TensorFlow's
  layout) with a coin-flip mirror;
- ``wds_webp_train``: webdataset shards of WebP (``.webp`` + ``.cls``, as
  img2dataset writes them with ``--encode_format webp``), from the corpus
  stored as WebP at quality 85 (``testdata/webp``):
  ``readers.webdataset(ext=["webp", "cls"], random_shuffle=True)``, the host
  decode of ``decoders.image_random_crop(device="mixed")`` with its default
  window arguments (the WebP samples of a batch in one native call on the
  operator's task pool), ``resize`` to 224x224 and CMN to FLOAT CHW with a
  coin-flip mirror;
- ``numpy_volumes``: ``readers.numpy(device="gpu")`` over float32 volumes
  of BraTS's four modalities at 240x240x155 (``[4, 155, 240, 240]``, 143 MB
  a file), whole or as the ``[4, 128, 128, 128]`` centre ROI over axes
  1-3; batch 2.

The data is written at run time from the committed 32-file corpora and from
seed 0 (``testdata/make_reader_datasets.py``). ``chip_smoke.py`` runs
wds_train, tfrecord_train and numpy_volumes after its phase 14 and
wds_webp_train as its phase 33;

    python dali_tpu_torch/tools/bench_readers.py [--form wds_train] [--timed 10]

times one form on the card and prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

MEAN = [0.485 * 255, 0.456 * 255, 0.406 * 255]
STD = [0.229 * 255, 0.224 * 255, 0.225 * 255]
SIZE = 224
FORMS = ("wds_train", "tfrecord_train")
WEBP_FORM = "wds_webp_train"
ALL_FORMS = FORMS + (WEBP_FORM,)
SAMPLES, FILES = 1024, 4
VOLUME = (4, 155, 240, 240)
ROI_START, ROI_SHAPE = [13, 56, 56], [128, 128, 128]  # the centre 128^3 of 155x240x240


def write_datasets(root: str, samples: int = SAMPLES) -> dict:
    """The corpus repeated to ``samples`` as 4 WebDataset shards and 4
    TFRecord files, and its WebP form as 4 WebDataset shards (256 samples
    each by default), with their index files, under ``root``; (paths, index
    paths) by form."""
    from dali_tpu_torch.testdata.make_reader_datasets import (WEBP_CORPUS, write_tfrecords,
                                                              write_wds_shards)

    return {"wds_train": write_wds_shards(os.path.join(root, "wds"), samples, FILES, index=True),
            "tfrecord_train": write_tfrecords(os.path.join(root, "tfrecord"), samples, FILES),
            WEBP_FORM: write_wds_shards(os.path.join(root, "wds_webp"), samples, FILES,
                                        index=True, ext="webp", corpus=WEBP_CORPUS)}


def make_pipe(form, data, batch, device, num_threads=None, dont_use_mmap=False):
    """One recipe (see the module docstring) over ``data`` = (paths, index
    paths); outputs (images, labels). ``dont_use_mmap`` makes the reader
    ``pread`` each record instead of slicing its file's map."""
    from dali_tpu_torch import fn, pipeline_def, tfrecord, types

    if form not in ALL_FORMS:
        raise ValueError(f"form must be one of {ALL_FORMS}, got {form!r}")
    paths, index = data

    @pipeline_def(batch_size=batch, num_threads=num_threads or os.cpu_count() or 1, seed=42,
                  prefetch_queue_depth=2, device=device)
    def recipe():
        if form == "wds_train":
            jpegs, labels = fn.readers.webdataset(paths=paths, index_paths=index,
                                                  ext=["jpg", "cls"], random_shuffle=True,
                                                  dont_use_mmap=dont_use_mmap, name="Reader")
            images = fn.decoders.image(jpegs, device="mixed", hybrid_device_decode=True,
                                       hybrid_scale=2, hybrid_wire="int8")
            images = fn.random_resized_crop(images, size=[SIZE, SIZE])
            layout = "CHW"
        elif form == WEBP_FORM:
            webps, labels = fn.readers.webdataset(paths=paths, index_paths=index,
                                                  ext=["webp", "cls"], random_shuffle=True,
                                                  dont_use_mmap=dont_use_mmap, name="Reader")
            images = fn.decoders.image_random_crop(webps, device="mixed", output_type=types.RGB)
            images = fn.resize(images, resize_x=SIZE, resize_y=SIZE)
            layout = "CHW"
        else:
            feats = fn.readers.tfrecord(
                path=paths, index_path=index, random_shuffle=True, dont_use_mmap=dont_use_mmap,
                name="Reader", features={
                    "image/encoded": tfrecord.FixedLenFeature((), tfrecord.string, ""),
                    "image/class/label": tfrecord.FixedLenFeature([1], tfrecord.int64, -1)})
            jpegs, labels = feats["image/encoded"], feats["image/class/label"]
            images = fn.decoders.image_random_crop(jpegs, device="mixed", output_type=types.RGB)
            images = fn.resize(images, resize_x=SIZE, resize_y=SIZE)
            layout = "HWC"
        images = fn.crop_mirror_normalize(images, mirror=fn.random.coin_flip(probability=0.5),
                                          dtype=types.FLOAT, output_layout=layout, mean=MEAN,
                                          std=STD)
        return images, labels

    return recipe()


def check_batch(batch, n, form):
    """One iterator batch: images [n, 3, 224, 224] (the webdataset forms) or
    [n, 224, 224, 3] (tfrecord_train) float32 on the card and finite;
    labels [n, 1] on the host, uint8 ``.cls`` bytes or int64 class ids in
    {0, 1}."""
    img, labels = batch[0]["images"], batch[0]["labels"]
    wds = form != "tfrecord_train"
    shape = (n, 3, SIZE, SIZE) if wds else (n, SIZE, SIZE, 3)
    if not (img.is_cuda and img.dtype == torch.float32 and tuple(img.shape) == shape):
        raise AssertionError(f"{form}: images {tuple(img.shape)} {img.dtype} on {img.device}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{form}: non-finite image values")
    want = (torch.uint8, b"01") if wds else (torch.int64, (0, 1))
    if (tuple(labels.shape) != (n, 1) or labels.dtype != want[0] or labels.is_cuda
            or not set(labels.reshape(-1).tolist()) <= set(want[1])):
        raise AssertionError(f"{form}: labels {tuple(labels.shape)} {labels.dtype}")


def _drive(pipe, names, warmup, timed, check):
    """WARMUP + ``timed`` batches through ``DALIGenericIterator``, each
    checked, then the prefetched ones collected. Returns (seconds of the
    timed batches, executor stat deltas, host ms/batch by schema, batches
    run)."""
    from dali_tpu_torch.plugin.pytorch import DALIGenericIterator

    ex = pipe.executor
    # a pipeline on the CPU (a rehearsal at a small size) has no device to wait for
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    it = DALIGenericIterator(pipe, names)
    for _ in range(warmup):
        check(next(it))
    sync()
    st0, by0 = dict(ex.stats), dict(ex.host_seconds_by_schema)
    t0 = time.perf_counter()
    for _ in range(timed):
        check(next(it))
    sync()
    dt = time.perf_counter() - t0
    st = {k: v - st0[k] for k, v in ex.stats.items()}
    by = {k: 1e3 * (v - by0.get(k, 0.0)) / max(st["host_batches"], 1)
          for k, v in ex.host_seconds_by_schema.items()}
    for _ in range(pipe.prefetch_queue_depth):
        pipe.outputs()
    sync()
    return dt, st, by, warmup + timed + pipe.prefetch_queue_depth


def _stages_alone(pipe):
    """Device ms by stage (CUDA events) of one batch run alone."""
    ex = pipe.executor
    ex.record_stage_events = True
    pipe.run()
    torch.cuda.synchronize()
    if ex.record_stage_events or not ex.stage_events:
        raise AssertionError("the instrumented batch did not run")
    stages = {}
    for name, a, b in ex.stage_events:
        stages[name] = stages.get(name, 0.0) + a.elapsed_time(b)
    return stages


def measure(form, data, batch=256, warmup=3, timed=10, dont_use_mmap=False):
    """Build one recipe on the card and run it (``_drive``); the CMN launch
    count is set to 0 just before and must equal the batches run. Then one
    batch alone by stage, the peak device memory, and one more batch with
    its CMN call recorded: the kernel held against its plain version on
    that batch and timed on it (``bench_ssd.hold_cmn``, ``time_cmn``)."""
    from dali_tpu_torch.kernels import cmn
    from dali_tpu_torch.tools import bench_ssd

    torch.cuda.reset_peak_memory_stats()
    pipe = make_pipe(form, data, batch, "cuda:0", dont_use_mmap=dont_use_mmap)
    pipe.build()
    cmn.COUNTER.launches = 0
    dt, st, by, ran = _drive(pipe, ["images", "labels"], warmup, timed,
                             lambda b: check_batch(b, batch, form))
    launches = cmn.COUNTER.launches
    if launches != ran:
        raise AssertionError(f"{form}: CMN kernel launched {launches} times for {ran} batches")
    stages = _stages_alone(pipe)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with bench_ssd.recording_cmn([]) as calls:
        pipe.run()
    pipe.shutdown()
    held = dict(bench_ssd.time_cmn(calls[0]), max_abs_err=bench_ssd.hold_cmn(calls[0]))
    return {"form": form, "batch": batch, "timed": timed, "dont_use_mmap": dont_use_mmap,
            "images_per_s": timed * batch / dt,
            "host_ms_per_batch": 1e3 * st["host_phase_seconds"] / st["host_batches"],
            "device_wait_ms_per_batch": 1e3 * st["device_wait_seconds"] / timed,
            "host_ms_by_schema": dict(sorted(by.items(), key=lambda kv: -kv[1])),
            "stage_ms": stages, "peak_gib": peak, "cmn_launches": launches, "cmn": held}


def webp_decode_ms(data, batch=256, reps=3):
    """The WebP decode of one batch of the first ``batch`` samples of the
    shards: ms of one native call on one thread and on a pool of the host's
    cores, into the buffers the decoder would fill."""
    import tarfile

    from dali_tpu_torch import imgcodec, native

    datas = []
    for path in data[0]:
        with tarfile.open(path) as tar:
            datas += [tar.extractfile(m).read() for m in tar if m.name.endswith(".webp")]
    datas = datas[:batch]
    bufs = [imgcodec.prepare_native(d, native.KIND_WEBP, False)[0] for d in datas]
    kinds = [native.KIND_WEBP] * len(datas)
    threads = os.cpu_count() or 1
    out = {"batch": len(datas), "threads": threads}
    for name, pool in (("one_thread_ms", None), ("pool_ms", native.shared_pool(threads))):
        rcs = native.decode_images_batch(pool, datas, kinds, bufs)
        if rcs != [0] * len(datas):
            raise AssertionError(f"WebP batch decode failed: {rcs}")
        t0 = time.perf_counter()
        for _ in range(reps):
            native.decode_images_batch(pool, datas, kinds, bufs)
        out[name] = 1e3 * (time.perf_counter() - t0) / reps
    return out


def make_numpy_pipe(files, batch, roi, device, reader_device="gpu"):
    """``readers.numpy`` over ``files`` at ``batch``, the whole volume or its
    centre ROI, shuffled from seed 42."""
    from dali_tpu_torch import fn, pipeline_def

    kw = dict(roi_start=ROI_START, roi_shape=ROI_SHAPE, roi_axes=[1, 2, 3]) if roi else {}

    @pipeline_def(batch_size=batch, num_threads=1, seed=42, prefetch_queue_depth=2,
                  device=device)
    def volumes():
        return fn.readers.numpy(files=files, device=reader_device, random_shuffle=True,
                                name="Reader", **kw)

    pipe = volumes()
    pipe.build()
    return pipe


def measure_numpy(files, roi, batch=2, warmup=3, timed=10, check_batches=2):
    """The mixed reader (``device="gpu"``) on the card: ``warmup`` +
    ``timed`` batches through ``DALIGenericIterator``, each on ``cuda:0``
    with the expected shape and dtype; GB/s delivered to the card, host
    ms/batch, device wait, and the H2D ms of one batch alone. Then the
    first ``check_batches`` batches of a fresh pipeline, bit-equal to the
    cpu reader's on the same files and seed."""
    shape = (batch, VOLUME[0], *ROI_SHAPE) if roi else (batch, *VOLUME)
    nbytes = int(np.prod(shape)) * 4

    def check(b):
        t = b[0]["volumes"]
        if not (t.is_cuda and t.device == torch.device("cuda:0") and t.dtype == torch.float32
                and tuple(t.shape) == shape):
            raise AssertionError(f"numpy_volumes: {tuple(t.shape)} {t.dtype} on {t.device}")

    pipe = make_numpy_pipe(files, batch, roi, "cuda:0")
    dt, st, _, _ = _drive(pipe, ["volumes"], warmup, timed, check)
    stages = _stages_alone(pipe)
    pipe.shutdown()
    runs = []
    for reader_device in ("gpu", "cpu"):
        pipe = make_numpy_pipe(files, batch, roi, "cuda:0", reader_device)
        outs = [pipe.run()[0] for _ in range(check_batches)]
        runs.append([o.as_tensor().cpu() if reader_device == "gpu"
                     else torch.from_numpy(np.stack([o.at(i) for i in range(batch)]))
                     for o in outs])
        pipe.shutdown()
    for got, want in zip(*runs):
        if not torch.equal(got, want):
            raise AssertionError("numpy_volumes: the card's batch differs from the cpu reader's")
    return {"form": "roi" if roi else "whole", "batch": batch, "timed": timed,
            "bytes_per_batch": nbytes, "gb_per_s": timed * nbytes / dt / 1e9,
            "host_ms_per_batch": 1e3 * st["host_phase_seconds"] / st["host_batches"],
            "device_wait_ms_per_batch": 1e3 * st["device_wait_seconds"] / timed,
            "h2d_ms": stages.get("h2d", 0.0), "bit_equal_batches": check_batches}


def numpy_phase(root, n_files=4, seed=0, **kw):
    """Both volume forms over ``n_files`` volumes written under ``root`` from
    ``seed``; the files are deleted at the end, also on failure."""
    from dali_tpu_torch.testdata.make_reader_datasets import write_npy_volumes

    t0 = time.perf_counter()
    try:
        files = write_npy_volumes(root, n_files, VOLUME, seed)
        written = time.perf_counter() - t0
        return written, [measure_numpy(files, roi, **kw) for roi in (False, True)]
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--form", choices=ALL_FORMS + ("numpy_volumes",), default="wds_train")
    ap.add_argument("--timed", type=int, default=10)
    ap.add_argument("--dont-use-mmap", action="store_true",
                    help="the reader preads each record instead of slicing its file's map")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_readers: needs a CUDA card", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, repo)
    root = os.path.join(repo, "build", "reader_datasets")
    if args.form == "numpy_volumes":
        written, r = numpy_phase(os.path.join(root, "volumes"), timed=args.timed)
        r = {"form": args.form, "write_s": written, "forms": r}
    else:
        data = write_datasets(root)[args.form]
        r = measure(args.form, data, timed=args.timed, dont_use_mmap=args.dont_use_mmap)
        if args.form == WEBP_FORM:
            r["webp_decode"] = webp_decode_ms(data)
    r["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
