"""Ranks sharing one dataset: counterpart of ``tools/multiprocess_test.py``.

The reference's check (after DALI's ``qa/TL3_JAX_multiprocess``) runs two
JAX processes of four devices each. Here each rank is one process with one
device, as a PyTorch DDP job runs, and the ranks join one
``torch.distributed`` group over gloo through a ``file://`` store in a
temporary directory (no TCP port to collide). Each rank drives one sharded
pipeline into ``plugin.distributed.DALIGenericIterator`` with a 1-D
``DeviceMesh`` and checks three phases:

(a) an external source whose shard ``r`` yields ``[[r] * 3] * 2``: the
    global ``DTensor`` batch is [2 * ranks, 3], and its sum over the mesh
    equals sum(r * 6);
(b) ``readers.file`` over 64 files whose first byte is the sample id, with
    ``shuffle_after_epoch=True``: one epoch covers every sample exactly once
    across the ranks (one-hot counts summed over the mesh), and a
    mid-epoch ``checkpoints()`` replays bit-identically in fresh pipelines;
(c) the hybrid-decode tail of ``tools/hybrid_fixture.py`` (the port's own
    copy, ``hybrid_tail`` below) over the committed 32-image corpus (or
    ``--jpeg-root``, a tree of JPEGs in class folders): each
    rank's local shard equals a standalone run of the same shard pipeline
    bit for bit, and the global mean over the mesh is finite.

Run from the repository root:

    python -m dali_tpu_torch.tools.multiprocess_test --device cpu [--out DIR]
    python -m dali_tpu_torch.tools.multiprocess_test --device cuda

``--device cuda`` puts rank r's pipeline on ``cuda:{r % cards}`` (two ranks
share a machine's one card) and its shards in a CUDA mesh, still over gloo:
NCCL refuses two ranks on one device. ``--out`` makes each rank write
``rank{r}.npz`` (its local shards and sample ids). The last line is a JSON
object with each rank's results.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
JPEG_ROOT = os.path.join(ROOT, "dali_tpu_torch", "testdata", "rn50")
N_FILES, BATCH, RANKS = 64, 2, 2
# the hybrid pipeline's shape, as tools/hybrid_fixture.py pins it for the
# reference's two multi-device checks
HYBRID_SCALE = 2
OUT_SIZE = 64
CMN_MEAN = [123.675, 116.28, 103.53]
CMN_STD = [58.395, 57.12, 57.375]


def hybrid_tail(fn, types, enc, with_decoded=False):
    """The production device tail from encoded JPEGs: hybrid ROI decode
    (sparse DCT wire, device IDCT), resample to OUT_SIZE, CMN to FLOAT CHW;
    with ``with_decoded``, also a 32x32 crop of the decoded uint8 image."""
    img = fn.decoders.image_random_crop(enc, device="mixed", hybrid_device_decode=True,
                                        hybrid_scale=HYBRID_SCALE)
    out = fn.resize(img, resize_x=OUT_SIZE, resize_y=OUT_SIZE)
    out = fn.crop_mirror_normalize(out, dtype=types.FLOAT, output_layout="CHW", mean=CMN_MEAN,
                                   std=CMN_STD)
    if with_decoded:
        return out, fn.crop(img, crop=(32, 32))
    return out


def make_dataset(root: str) -> str:
    """64 eight-byte files under ``root/cls`` whose first byte is the sample id."""
    d = os.path.join(root, "cls")
    os.makedirs(d, exist_ok=True)
    for i in range(N_FILES):
        with open(os.path.join(d, f"f_{i:03d}.bin"), "wb") as f:
            f.write(bytes([i, 255 - i, 0, 0, 0, 0, 0, 0]))
    return root


def rank_device(device: str, rank: int) -> str:
    return f"cuda:{rank % torch.cuda.device_count()}" if device == "cuda" else "cpu"


def init_group(rank: int, world: int, store: str, device: str):
    """The default gloo group through a file store; on CUDA, this rank's card
    made current. Returns the 1-D DeviceMesh over all ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if device == "cuda":
        torch.cuda.set_device(rank_device(device, rank))
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    return init_device_mesh(device, (world,), mesh_dim_names=("data",))


def external_source_phase(rank, mesh, device):
    from .. import fn, pipeline_def
    from ..plugin.distributed import DALIGenericIterator

    world = mesh.size()

    @pipeline_def(batch_size=BATCH, num_threads=1, seed=1, device=rank_device(device, rank))
    def pipe():
        return fn.external_source(source=lambda: np.full((BATCH, 3), rank, np.int32), batch=True)

    it = DALIGenericIterator([pipe()], ["data"], size=64, device_mesh=mesh)
    g = next(it)["data"]
    if tuple(g.shape) != (BATCH * world, 3):
        raise AssertionError(f"global batch {tuple(g.shape)}")
    local = g.to_local()
    if not bool((local == rank).all()):
        raise AssertionError(f"rank {rank}: local shard {local.tolist()}")
    total = int(g.sum().full_tensor())
    want = sum(r * BATCH * 3 for r in range(world))
    if total != want:
        raise AssertionError(f"global sum {total}, expected {want}")
    return {"a_local": local.cpu().numpy(), "a_sum": total}


def reader_phase(rank, mesh, device, root):
    from .. import fn, pipeline_def
    from ..plugin.distributed import DALIGenericIterator, global_batch

    world = mesh.size()

    def make_pipe(checkpoint=None):
        @pipeline_def(batch_size=BATCH, num_threads=1, seed=123, enable_checkpointing=True,
                      checkpoint=checkpoint, device=rank_device(device, rank))
        def rp():
            # shuffle_after_epoch: a global permutation each epoch keeps the
            # shards a partition, so the epoch covers each sample once
            data, label = fn.readers.file(file_root=root, file_filters=["*.bin"],
                                          shuffle_after_epoch=True, seed=5, shard_id=rank,
                                          num_shards=world, name="R")
            return data, label

        return rp()

    def ids(batch):
        return batch["data"].to_local()[:, 0].tolist()

    it = DALIGenericIterator([make_pipe()], ["data", "label"], reader_name="R", device_mesh=mesh)
    if len(it) != N_FILES // world // BATCH:
        raise AssertionError(f"{len(it)} iterations an epoch")
    counts = torch.zeros((1, N_FILES), dtype=torch.int32)
    epoch = []
    for batch in it:
        epoch += ids(batch)
        for v in ids(batch):
            counts[0, v] += 1
    total = global_batch(counts, mesh).sum(0).full_tensor().cpu()
    if not bool((total == 1).all()):
        raise AssertionError(f"epoch coverage broken: {total.tolist()}")
    it.reset()
    for _ in range(2):
        next(it)
    ck = it.checkpoints()
    expect = [ids(next(it)) for _ in range(2)]
    it2 = DALIGenericIterator([make_pipe(ck["pipelines"][0])], ["data", "label"], reader_name="R",
                              device_mesh=mesh)
    it2.restore_counter(ck["counter"])
    got = [ids(next(it2)) for _ in range(2)]
    if got != expect:
        raise AssertionError(f"resume {got} != {expect}")
    return {"b_epoch_ids": np.array(epoch, np.int32), "b_resumed_ids": np.array(got, np.int32)}


def hybrid_phase(rank, mesh, device, jpeg_root=JPEG_ROOT):
    from .. import fn, pipeline_def, types
    from ..plugin.distributed import DALIGenericIterator

    world = mesh.size()

    def make_pipe():
        @pipeline_def(batch_size=BATCH, num_threads=1, seed=77, device=rank_device(device, rank))
        def hp():
            enc, lab = fn.readers.file(file_root=jpeg_root, shard_id=rank, num_shards=world,
                                       name="R")
            images, decoded = hybrid_tail(fn, types, enc, with_decoded=True)
            return images, decoded, lab

        return hp()

    pipe = make_pipe()
    it = DALIGenericIterator([pipe], ["images", "decoded", "labels"], reader_name="R",
                             device_mesh=mesh)
    batch = next(it)
    g = batch["images"]
    if tuple(g.shape) != (BATCH * world, 3, OUT_SIZE, OUT_SIZE):
        raise AssertionError(f"global images {tuple(g.shape)}")
    solo = make_pipe()
    solo.build()
    want = solo.run()
    for k, out in zip(("images", "decoded"), want):
        if not torch.equal(batch[k].to_local(), out.as_tensor().to(batch[k].to_local().device)):
            raise AssertionError(f"rank {rank}: local {k} shard != a standalone run")
    for p in (pipe, solo):
        p.shutdown()
    mean = float(g.sum().full_tensor()) / g.numel()
    if not np.isfinite(mean):
        raise AssertionError(f"global mean {mean}")
    return {"c_images": batch["images"].to_local().cpu().numpy(),
            "c_decoded": batch["decoded"].to_local().cpu().numpy(),
            "c_labels": batch["labels"].to_local().cpu().numpy(), "c_mean": mean}


def worker(rank, world, store, device, data_root, jpeg_root, out_dir, results):
    import torch.distributed as dist

    mesh = init_group(rank, world, store, device)
    try:
        t0 = time.perf_counter()
        res = external_source_phase(rank, mesh, device)
        res.update(reader_phase(rank, mesh, device, data_root))
        res.update(hybrid_phase(rank, mesh, device, jpeg_root))
        res["seconds"] = time.perf_counter() - t0
        if out_dir:
            np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                     **{k: v for k, v in res.items() if isinstance(v, np.ndarray)})
        results.put((rank, {"global_sum": res["a_sum"], "global_mean": res["c_mean"],
                            "epoch_ids": len(res["b_epoch_ids"]),
                            "seconds": round(res["seconds"], 3)}))
    finally:
        dist.destroy_process_group()


def run(device: str = "cpu", out_dir: str = None, jpeg_root: str = JPEG_ROOT) -> dict:
    """Spawns RANKS ranks; raises if any phase failed on any rank."""
    import torch.multiprocessing as mp

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        results = ctx.SimpleQueue()
        mp.start_processes(worker, args=(RANKS, os.path.join(tmp, "store"), device,
                                         make_dataset(os.path.join(tmp, "data")), jpeg_root,
                                         out_dir, results),
                           nprocs=RANKS, join=True, start_method="spawn")
        out = dict(results.get() for _ in range(RANKS))
    return {"device": device, "ranks": RANKS, "by_rank": out}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--out", default=None, help="directory for each rank's rank{r}.npz")
    ap.add_argument("--jpeg-root", default=JPEG_ROOT, help="phase (c)'s JPEGs")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    print(json.dumps(run(args.device, args.out, args.jpeg_root)))


if __name__ == "__main__":
    main()
