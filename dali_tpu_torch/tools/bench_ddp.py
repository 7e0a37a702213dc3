"""rn50_ddp_2rank: rn50_train's input pipeline as a two-rank DDP job runs it.

DALI's distributed training feeds each rank from its own pipeline over its
shard of the dataset (SURVEY §5.8). Here two ranks, spawned processes joined
in one gloo group through a ``file://`` store, each build rn50_train's
recipe (``bench.py:137-168``: hybrid decode at ``hybrid_scale=2``, resize to
224x224, coin-flip mirror, CMN to FLOAT CHW, batch 256) with
``shard_id=rank``, ``num_shards=2`` and half the host's cores as
``num_threads``, as on a 2-GPU node, and take their batches through
``plugin.distributed.DALIGenericIterator`` on a 1-D CUDA mesh (each batch a
``DTensor`` shard, assembled without communication). The reader shuffles
with ``shuffle_after_epoch=True`` (rn50_train's ``random_shuffle`` buffer
mixes epochs), so each epoch is a partition of the file list across the
ranks; the list's labels are the entry indices, so a rank's batch names its
samples. Each rank runs WARMUP + ``timed`` batches; its shard of the file
list (512 entries: the 32-file corpus 16 times) is one batch, so the
warm-up batches are whole epochs: their one-hot label counts, summed over
the mesh, must equal WARMUP for every entry. Each rank reports its
images/s over the timed batches (the ranks start them together at a
barrier), its host ms/batch, its CMN launches and a hash of its first
batch. The ranks' rate together is the images of all ranks over the span
from the barrier to the last rank's end (one host clock,
``time.monotonic``). ``shard_runs`` runs each shard's pipeline standalone
for the bit-equality check.

On a card: ``python dali_tpu_torch/tools/bench_ddp.py`` (both ranks on
``cuda:{r % cards}``); ``--device cpu --batch 8 --timed 2`` rehearses it on
the CPU. The last line is a JSON object.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CORPUS = os.path.join(ROOT, "dali_tpu_torch", "testdata", "rn50")
BATCH, OUT, WARMUP, TIMED, RANKS = 256, 224, 3, 20, 2
MEAN = [0.485 * 255, 0.456 * 255, 0.406 * 255]
STD = [0.229 * 255, 0.224 * 255, 0.225 * 255]


def write_file_list(path: str, entries: int) -> str:
    """``entries`` lines of the corpus repeated, ``path label`` with the
    entry's index as its label."""
    files = sorted(os.path.join(CORPUS, c, f) for c in sorted(os.listdir(CORPUS))
                   for f in sorted(os.listdir(os.path.join(CORPUS, c))))
    with open(path, "w") as f:
        f.write("".join(f"{files[i % len(files)]} {i}\n" for i in range(entries)))
    return path


def make_pipe(file_list, shard, shards, device, threads, batch=BATCH):
    from dali_tpu_torch import fn, pipeline_def, types

    @pipeline_def(batch_size=batch, num_threads=threads, seed=42, prefetch_queue_depth=2,
                  device=device)
    def rn50_ddp():
        jpegs, labels = fn.readers.file(file_list=file_list, shuffle_after_epoch=True,
                                        shard_id=shard, num_shards=shards, name="Reader")
        images = fn.decoders.image_random_crop(jpegs, device="mixed", hybrid_device_decode=True,
                                               hybrid_scale=2)
        images = fn.resize(images, resize_x=OUT, resize_y=OUT)
        mirror = fn.random.coin_flip(probability=0.5)
        images = fn.crop_mirror_normalize(images, mirror=mirror, mean=MEAN, std=STD,
                                          dtype=types.FLOAT, output_layout="CHW")
        return images, labels

    return rn50_ddp()


def batch_hash(images: torch.Tensor, labels: torch.Tensor) -> str:
    h = hashlib.sha256(images.contiguous().cpu().numpy().tobytes())
    h.update(labels.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def device_of(device: str, rank: int) -> str:
    return f"cuda:{rank % torch.cuda.device_count()}" if device == "cuda" else "cpu"


def rank_worker(rank, world, store, device, file_list, batch, warmup, timed, threads, results):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from dali_tpu_torch.kernels import cmn
    from dali_tpu_torch.plugin.distributed import DALIGenericIterator, global_batch

    dev = device_of(device, rank)
    if device == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        mesh = init_device_mesh(device, (world,), mesh_dim_names=("data",))
        with open(file_list) as f:
            entries = sum(1 for _ in f)
        pipe = make_pipe(file_list, rank, world, dev, threads, batch)
        pipe.build()
        ex = pipe.executor
        cmn.COUNTER.launches = 0
        it = DALIGenericIterator([pipe], ["data", "label"], device_mesh=mesh)
        counts = torch.zeros((1, entries), dtype=torch.int32)
        first = None
        for _ in range(warmup):
            b = next(it)
            images, labels = b["data"].to_local(), b["label"].to_local()
            first = first or batch_hash(images, labels)
            counts[0].index_add_(0, labels.reshape(-1).long().cpu(),
                                 torch.ones(labels.numel(), dtype=torch.int32))
        cover = global_batch(counts, mesh).sum(0).full_tensor().cpu()
        if device == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
        st0 = dict(ex.stats)
        t0 = time.monotonic()
        for _ in range(timed):
            b = next(it)
            images = b["data"].to_local()
            if tuple(images.shape) != (batch, 3, OUT, OUT) or images.dtype != torch.float32:
                raise AssertionError(f"rank {rank}: batch {tuple(images.shape)} {images.dtype}")
        if device == "cuda":
            torch.cuda.synchronize()
        t_end = time.monotonic()
        finite = bool(torch.isfinite(images).all())
        st = {k: v - st0[k] for k, v in ex.stats.items()}
        for _ in range(pipe.prefetch_queue_depth):
            pipe.outputs()
        if device == "cuda":
            torch.cuda.synchronize()
        results.put((rank, {
            "images_per_s": timed * batch / (t_end - t0), "t_start": t0, "t_end": t_end,
            "host_ms_per_batch": 1e3 * st["host_phase_seconds"] / max(st["host_batches"], 1),
            "cmn_launches": cmn.COUNTER.launches, "batches_run": warmup + timed + 2,
            "first_batch_sha256": first, "coverage_min": int(cover.min()),
            "coverage_max": int(cover.max()), "finite": finite}))
        pipe.shutdown()
    finally:
        dist.destroy_process_group()


def run(device="cuda", batch=BATCH, warmup=WARMUP, timed=TIMED, ranks=RANKS):
    """Spawns the ranks; returns each rank's readings, the ranks' rate
    together and the file list."""
    import torch.multiprocessing as mp

    threads = max(1, (os.cpu_count() or 1) // ranks)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    file_list = write_file_list(
        os.path.join(ROOT, "build", f"rn50_ddp_file_list_{batch * ranks}.txt"), batch * ranks)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        results = ctx.SimpleQueue()
        t0 = time.perf_counter()
        mp.start_processes(rank_worker, args=(ranks, os.path.join(tmp, "store"), device,
                                              file_list, batch, warmup, timed, threads, results),
                           nprocs=ranks, join=True, start_method="spawn")
        secs = time.perf_counter() - t0
        by_rank = [r for _, r in sorted(results.get() for _ in range(ranks))]
    span = max(r["t_end"] for r in by_rank) - min(r["t_start"] for r in by_rank)
    return {"ranks": ranks, "threads_per_rank": threads, "batch": batch, "warmup": warmup,
            "timed": timed, "file_list": file_list, "seconds": secs,
            "by_rank": by_rank, "span_seconds": span,
            "images_per_s": ranks * timed * batch / span}


def shard_runs(r: dict, device="cuda"):
    """Each shard's pipeline run standalone in this process: the hash of its
    first batch, as the ranks hashed theirs."""
    hashes = []
    for rank in range(r["ranks"]):
        pipe = make_pipe(r["file_list"], rank, r["ranks"], device_of(device, rank),
                         r["threads_per_rank"], r["batch"])
        pipe.build()
        images, labels = pipe.run()
        hashes.append(batch_hash(images.as_tensor(), labels.as_tensor()))
        pipe.shutdown()
    return hashes


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--timed", type=int, default=TIMED)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    r = run(args.device, args.batch, timed=args.timed)
    r["standalone_equal"] = shard_runs(r, args.device) == [b["first_batch_sha256"]
                                                          for b in r["by_rank"]]
    print(json.dumps(r))
    return 0 if r["standalone_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
