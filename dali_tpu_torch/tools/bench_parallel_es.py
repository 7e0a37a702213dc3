"""RN50 fed by a per-sample ``parallel=True`` external source, timed on the
card: the input DALI's PyTorch RN50 recipe feeds from user code
(``test_RN50_external_source_parallel_train_ddp.py`` in DALI).

The source reads JPEG bytes and labels from a DALI file list in host-cores - 1
worker processes (``fork``); hybrid decode at ``hybrid_scale=2``, resize 224,
coin-flip mirror and CMN FLOAT CHW follow, through
``DALIClassificationIterator``. ``chip_smoke.py`` runs it as its phase 8.

    python dali_tpu_torch/tools/bench_parallel_es.py FILE_LIST [--timed N]

times the pipeline once and prints one JSON line (images/s, host ms/batch,
the device thread's wait, the card's name and power limit).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

MEAN = [0.485 * 255, 0.456 * 255, 0.406 * 255]
STD = [0.229 * 255, 0.224 * 255, 0.225 * 255]


class FileListSource:
    """A per-sample source over a DALI file list: (JPEG bytes, [label])."""

    def __init__(self, file_list):
        with open(file_list) as f:
            self.entries = [(p, int(label)) for p, label in
                            (line.rsplit(" ", 1) for line in f.read().splitlines() if line)]

    def __call__(self, info):
        path, label = self.entries[info.idx_in_epoch % len(self.entries)]
        with open(path, "rb") as f:
            return np.frombuffer(f.read(), np.uint8), np.array([label], np.int32)


def make_pipe(file_list, batch, device, out=224):
    from dali_tpu_torch import fn, pipeline_def, types

    cores = os.cpu_count() or 1

    @pipeline_def(batch_size=batch, num_threads=cores, seed=42, prefetch_queue_depth=2,
                  device=device, py_num_workers=max(1, cores - 1))
    def rn50_parallel_es():
        jpegs, labels = fn.external_source(source=FileListSource(file_list), num_outputs=2,
                                           batch=False, parallel=True)
        images = fn.decoders.image_random_crop(jpegs, device="mixed", hybrid_device_decode=True,
                                               hybrid_scale=2)
        images = fn.resize(images, resize_x=out, resize_y=out)
        mirror = fn.random.coin_flip(probability=0.5)
        images = fn.crop_mirror_normalize(images, mirror=mirror, dtype=types.FLOAT,
                                          output_layout="CHW", mean=MEAN, std=STD)
        return images, labels

    return rn50_parallel_es()


def measure(file_list, batch=256, warmup=3, timed=10, check=None, device="cuda:0"):
    """Warm-up and timed batches through the iterator; returns the
    readings and the CMN launches of the run (the prefetched batches
    included)."""
    from dali_tpu_torch.kernels import cmn
    from dali_tpu_torch.plugin.pytorch import DALIClassificationIterator

    pipe = make_pipe(file_list, batch, device)
    sync = torch.cuda.synchronize if pipe.device.type == "cuda" else (lambda: None)
    pipe.build()
    cmn.COUNTER.launches = 0
    it = DALIClassificationIterator(pipe)
    for _ in range(warmup):
        b = next(it)
        if check:
            check(b)
    sync()
    st0 = dict(pipe.executor.stats)
    t0 = time.perf_counter()
    for _ in range(timed):
        b = next(it)
        if check:
            check(b)
    sync()
    dt = time.perf_counter() - t0
    st = {k: v - st0[k] for k, v in pipe.executor.stats.items()}
    for _ in range(pipe.prefetch_queue_depth):
        pipe.outputs()
    sync()
    launches = cmn.COUNTER.launches
    workers, ran = pipe.py_num_workers, warmup + timed + pipe.prefetch_queue_depth
    pipe.shutdown()
    return {"images_per_s": timed * batch / dt, "workers": workers,
            "host_ms_per_batch": 1e3 * st["host_phase_seconds"] / st["host_batches"],
            "device_wait_ms_per_batch": 1e3 * st["device_wait_seconds"] / timed,
            "batches": ran}, launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("file_list")
    ap.add_argument("--timed", type=int, default=10)
    args = ap.parse_args()
    # run as a script: the package is two levels up
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    r, _ = measure(args.file_list, timed=args.timed)
    r["card"] = card
    print(json.dumps(r))


if __name__ == "__main__":
    main()
