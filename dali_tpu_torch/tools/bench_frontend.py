"""The front end, the shape ops and the reductions on their paths:
serialized_rn50 and volumes_zscore.

* serialized_rn50: the RN50 training graph built through the ``ops`` class
  API (as DALI's legacy RN50 example builds it), serialized, and rebuilt by
  ``Pipeline.deserialize`` with no Python definition, driven through
  ``DALIClassificationIterator(reader_name=..., prepare_first_batch=False)``
  within one epoch of ``file_list``. Every batch must be bit-equal to the
  source pipeline's; after batch 5 the
  iterator's ``checkpoints()`` rebuild the pipeline (``checkpoint=``,
  ``restore_counter``), whose next batches must equal the uninterrupted
  run's.
* volumes_zscore: BraTS-sized ``[4, 155, 240, 240]`` float32 volumes read to
  the device (``readers.numpy(device="gpu")``), given the layout CDHW,
  a 128^3 window at random relative starts (``slice``), per-channel mean and
  standard deviation over DHW, ``(x - mean) / std``, and the normalised and
  raw windows stacked on a new leading axis.

``chip_smoke.py`` runs both on the card. Alone, on the card:
``python dali_tpu_torch/tools/bench_frontend.py --form serialized_rn50|volumes_zscore``
(one JSON line).
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
CHECKPOINT_AFTER, RESUMED = 5, 3
VOLUME = (4, 155, 240, 240)
WINDOW = 128
# relative starts in [0, 0.17): 0.17 * 155 + 128 stays inside the depth
MAX_REL_START = 0.17
FORMS = ("serialized_rn50", "volumes_zscore")


def make_rn50_ops(file_list, batch, out, device, num_threads=None, **kw):
    """rn50_train's graph through the ``ops`` class API, with checkpointing
    on: the same operators in the same order as ``fn``'s, so the same seed
    gives the same batches."""
    from dali_tpu_torch import Pipeline, ops, types

    pipe = Pipeline(batch_size=batch, num_threads=num_threads or os.cpu_count() or 1, seed=42,
                    prefetch_queue_depth=2, device=device, enable_checkpointing=True, **kw)
    reader = ops.readers.File(file_list=file_list, random_shuffle=True, name="Reader")
    decode = ops.decoders.ImageRandomCrop(device="mixed", hybrid_device_decode=True,
                                          hybrid_scale=2)
    resize = ops.Resize(resize_x=out, resize_y=out)
    coin = ops.random.CoinFlip(probability=0.5)
    cmn = ops.CropMirrorNormalize(dtype=types.FLOAT, output_layout="CHW", mean=MEAN, std=STD)
    with pipe:
        jpegs, labels = reader()
        images = cmn(resize(decode(jpegs)), mirror=coin())
        pipe.set_outputs(images, labels)
    return pipe


def _collect(it, n):
    """``n`` batches of a classification iterator, copied (data, label)."""
    out = []
    for _ in range(n):
        b = next(it)[0]
        out.append((b["data"].clone(), b["label"].clone()))
    return out


def _equal(got, want, what):
    for i, ((gd, gl), (wd, wl)) in enumerate(zip(got, want)):
        if not (torch.equal(gd, wd) and torch.equal(gl, wl)):
            raise AssertionError(f"{what}: batch {i} differs")


def serialized_rn50(file_list, batch, out, device, warmup=3, timed=10, dot_file=None):
    """The source pipeline's batches, then the deserialized pipeline's
    through the iterator (timed), held bit-equal; the resume from the
    iterator's checkpoints after batch ``CHECKPOINT_AFTER``; statistics and
    the dot file. Returns the readings, the deserialized pipeline's CMN
    launches over its ``warmup + timed`` batches (and the prefetched ones)
    and the pipeline itself, still built (shut it down after use)."""
    from dali_tpu_torch import Pipeline
    from dali_tpu_torch.kernels import cmn
    from dali_tpu_torch.plugin.pytorch import DALIClassificationIterator

    n = warmup + timed
    if n < CHECKPOINT_AFTER + RESUMED:
        raise ValueError(f"serialized_rn50 needs at least {CHECKPOINT_AFTER + RESUMED} batches")
    src = make_rn50_ops(file_list, batch, out, device)
    src.build()
    payload = src.serialize()
    want = _collect(DALIClassificationIterator(src, reader_name="Reader"), n)
    src.shutdown()

    pipe = Pipeline.deserialize(payload, device=device)
    pipe.build()
    ex = pipe.executor
    cmn.COUNTER.launches = 0
    it = DALIClassificationIterator(pipe, reader_name="Reader", prepare_first_batch=False)
    got = _collect(it, warmup)
    _sync(device)
    st0 = dict(ex.stats)
    t0 = time.perf_counter()
    for k in range(warmup, n):
        got += _collect(it, 1)
        if k + 1 == CHECKPOINT_AFTER:
            ckpt = it.checkpoints()
    _sync(device)
    dt = time.perf_counter() - t0
    st = {k: v - st0[k] for k, v in ex.stats.items()}
    for _ in range(pipe.prefetch_queue_depth):
        pipe.outputs()
    _sync(device)
    launches = cmn.COUNTER.launches
    ran = n + pipe.prefetch_queue_depth
    if torch.device(device).type == "cuda" and launches != ran:
        raise AssertionError(f"serialized_rn50: CMN kernel launched {launches} times for {ran} "
                             "batches")
    _equal(got, want, "serialized_rn50: the deserialized pipeline against the source")

    again = Pipeline.deserialize(payload, device=device, checkpoint=ckpt["pipelines"][0])
    it2 = DALIClassificationIterator(again, reader_name="Reader")
    it2.restore_counter(ckpt["counter"])
    resumed = _collect(it2, RESUMED)
    again.shutdown()
    _equal(resumed, got[CHECKPOINT_AFTER:CHECKPOINT_AFTER + RESUMED],
           "serialized_rn50: the resumed pipeline against the uninterrupted run")

    stats = pipe.executor_statistics()
    if dot_file:
        pipe.save_graph_to_dot_file(dot_file)
    return {"images_per_s": timed * batch / dt, "timed": timed, "batches_equal": n,
            "resumed_equal": RESUMED, "counter": ckpt["counter"],
            "host_ms_per_batch": 1e3 * st["host_phase_seconds"] / st["host_batches"],
            "device_wait_ms_per_batch": 1e3 * st["device_wait_seconds"] / timed,
            "payload_bytes": len(payload), "statistics_keys": sorted(stats),
            "canvases": stats["canvases"]}, launches, pipe


def make_volumes_pipe(files, batch, device, window=WINDOW):
    """volumes_zscore's graph; outputs (stacked, window)."""
    from dali_tpu_torch import fn, pipeline_def

    @pipeline_def(batch_size=batch, num_threads=1, seed=42, prefetch_queue_depth=2,
                  device=device)
    def volumes_zscore():
        v = fn.readers.numpy(files=files, device="gpu", random_shuffle=True, name="Reader")
        v = fn.reshape(v, layout="CDHW")
        start = fn.random.uniform(range=[0.0, MAX_REL_START], shape=[3])
        crop = fn.slice(v, rel_start=start, shape=[window] * 3, axis_names="DHW")
        mean = fn.reductions.mean(crop, axis_names="DHW", keep_dims=True)
        std = fn.reductions.std_dev(crop, mean, axis_names="DHW", keep_dims=True)
        return fn.stack((crop - mean) / std, crop, axis=0), crop

    pipe = volumes_zscore()
    pipe.build()
    return pipe


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def volumes_zscore(files, batch=2, warmup=3, timed=10, check_batches=2, window=WINDOW):
    """The path on the card: ``warmup`` + ``timed`` batches, each checked;
    GB/s of volumes read, host ms/batch, device wait and the device ms by
    stage of one batch alone. Then the first ``check_batches`` batches of
    fresh pipelines on the card and on the CPU: the windows bit-equal, the
    stacked output within 1e-5 relative."""
    from dali_tpu_torch.plugin.pytorch import DALIGenericIterator

    c = VOLUME[0]
    vol_bytes = int(np.prod(np.load(files[0], mmap_mode="r").shape)) * 4 * batch
    pipe = make_volumes_pipe(files, batch, "cuda:0", window)
    ex = pipe.executor
    it = DALIGenericIterator(pipe, ["z", "window"])

    def check(b):
        z, w = b[0]["z"], b[0]["window"]
        if not (z.is_cuda and z.dtype == torch.float32
                and tuple(z.shape) == (batch, 2, c, window, window, window)
                and tuple(w.shape) == (batch, c, window, window, window)):
            raise AssertionError(f"volumes_zscore: {tuple(z.shape)} {z.dtype} on {z.device}")
        if not bool(torch.isfinite(z).all()):
            raise AssertionError("volumes_zscore: non-finite values")

    for _ in range(warmup):
        check(next(it))
    torch.cuda.synchronize()
    st0 = dict(ex.stats)
    t0 = time.perf_counter()
    for _ in range(timed):
        check(next(it))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = {k: v - st0[k] for k, v in ex.stats.items()}
    for _ in range(pipe.prefetch_queue_depth):
        pipe.outputs()
    ex.record_stage_events = True
    pipe.run()
    torch.cuda.synchronize()
    if ex.record_stage_events or not ex.stage_events:
        raise AssertionError("the instrumented batch did not run")
    stages = {}
    for name, a, b in ex.stage_events:
        stages[name] = stages.get(name, 0.0) + a.elapsed_time(b)
    pipe.shutdown()
    worst = check_volumes_against_cpu(files, batch, check_batches, window)
    return {"batch": batch, "timed": timed, "bytes_per_batch": vol_bytes,
            "gb_per_s": timed * vol_bytes / dt / 1e9,
            "host_ms_per_batch": 1e3 * st["host_phase_seconds"] / st["host_batches"],
            "device_wait_ms_per_batch": 1e3 * st["device_wait_seconds"] / timed,
            "stage_ms": stages, "checked_batches": check_batches, "max_rel_err": worst}


def check_volumes_against_cpu(files, batch, n, window=WINDOW, devices=("cuda:0", "cpu")):
    """The first ``n`` batches of the path on two devices: windows
    bit-equal, the stacked output within 1e-5 relative (of the largest
    magnitude). Returns the worst relative difference."""
    runs = []
    for device in devices:
        pipe = make_volumes_pipe(files, batch, device, window)
        runs.append([tuple(o.as_tensor().cpu() for o in pipe.run()) for _ in range(n)])
        pipe.shutdown()
    worst = 0.0
    for (gz, gw), (cz, cw) in zip(*runs):
        if not torch.equal(gw, cw):
            raise AssertionError("volumes_zscore: the windows differ between devices")
        rel = float((gz - cz).abs().max() / cz.abs().max())
        worst = max(worst, rel)
        if not rel <= 1e-5:
            raise AssertionError(f"volumes_zscore: stacked output {rel:.3e} apart (limit 1e-5)")
    return worst


def volumes_phase(root, n_files=4, seed=0, **kw):
    """``volumes_zscore`` over ``n_files`` volumes written under ``root``
    from ``seed``; the files are deleted at the end, also on failure."""
    from dali_tpu_torch.testdata.make_reader_datasets import write_npy_volumes

    t0 = time.perf_counter()
    try:
        files = write_npy_volumes(root, n_files, VOLUME, seed)
        written = time.perf_counter() - t0
        return written, volumes_zscore(files, **kw)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--form", choices=FORMS, default="serialized_rn50")
    ap.add_argument("--timed", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_frontend: needs a CUDA card", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, repo)
    if args.form == "volumes_zscore":
        written, r = volumes_phase(os.path.join(repo, "build", "frontend_volumes"),
                                   timed=args.timed)
        r["write_s"] = written
    else:
        import chip_smoke

        r, launches, pipe = serialized_rn50(chip_smoke.write_file_list(repeat=16), 256, 224,
                                            "cuda:0", timed=args.timed)
        pipe.shutdown()
        r["cmn_launches"] = launches
    r["form"] = args.form
    r["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
