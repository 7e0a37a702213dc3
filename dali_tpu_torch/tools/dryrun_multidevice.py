"""One sharded train step fed by the port: counterpart of
``__graft_entry__.dryrun_multichip`` (``__graft_entry__.py:196-317``).

Each rank is one process with one device. The ranks form a 2-D
``DeviceMesh`` (``data``, ``model``) with the reference's arithmetic:
``model`` = 2 when the rank count is even, ``data`` = ranks / model. Each
rank takes its data row's shard of a seeded global batch ([4 * data, 64, 64,
3] uint8, as ``:281-290`` assembles it from per-host shards), preprocesses it
on its device with the port's ``resample_batch`` (to 32x32) and CMN to
bfloat16 HWC (on a card, the CMN kernel's bfloat16 store), and the 2-layer
MLP consumes the global batch as ``DTensor``s: the features ``Shard(0)`` on
``data``, ``w1`` ``Shard(1)`` and ``w2`` ``Shard(0)`` on ``model``. The loss,
its gradients (DTensor autograd) and one SGD step (lr 0.1) follow. Then the
hybrid-decode program (``multiprocess_test.hybrid_tail``) runs as one
pipeline per data shard, and each rank's shard of its global batch equals,
bit for bit, that shard's pipeline run alone (the reference's
``check_real_program_sharded``, ``:67``).

The step needs only all_reduce (the loss and the gradients' partial sums);
the collectives it issues are counted (``CommDebugMode``) and printed. On a
card, the step's own CMN call (its float32 input, the resampled batch) is
recorded and held against ``crop_mirror_normalize_plain`` on the same
arguments, bfloat16 bits equal, then timed on them (``hold_cmn``).
Nothing here gathers a sharded tensor whole: DTensor's Shard -> Replicate
all_gather over gloo segfaults on CUDA tensors (torch 2.11, CUDA 12.8, an
H100), so each rank writes its own shards of the updated weights and
``gather_weights`` assembles them from the files. ``--device cuda`` runs the
ranks on ``cuda:{r % cards}`` over gloo, since NCCL refuses two ranks on
one card.

    python -m dali_tpu_torch.tools.dryrun_multidevice --device cpu --ranks 4 [--out DIR]
    python -m dali_tpu_torch.tools.dryrun_multidevice --device cuda --ranks 2

``--out`` makes each rank write ``dryrun_rank{r}.npz`` (the loss, its shards
of the updated ``w1`` and ``w2``, its model coordinate). The last line is a
JSON object.
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

from . import multiprocess_test as mpt

H = W = 64
OUT, NCLS, DMODEL = 32, 16, 64
LR = 0.1
HYBRID_BATCH = 2


def mesh_shape(ranks: int):
    """(data, model), as ``dryrun_multichip`` splits its devices."""
    model = 2 if ranks % 2 == 0 and ranks >= 2 else 1
    return ranks // model, model


def step_inputs(data: int):
    """The seed-0 inputs of the step, as ``dryrun_multichip`` makes them."""
    n = 4 * data
    rng = np.random.default_rng(0)
    padded = rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)
    shapes = np.tile(np.array([[H, W]], np.int32), (n, 1))
    roi_start = np.zeros((n, 2), np.float32)
    roi_size = np.tile(np.array([[float(H), float(W)]], np.float32), (n, 1))
    mirror = (np.arange(n) % 2).astype(np.int32)
    labels = rng.integers(0, NCLS, (n,), dtype=np.int32)
    w1 = rng.normal(0, 0.02, (OUT * OUT * 3, DMODEL)).astype(np.float32)
    w2 = rng.normal(0, 0.02, (DMODEL, NCLS)).astype(np.float32)
    return dict(padded=padded, shapes=shapes, roi_start=roi_start, roi_size=roi_size,
                mirror=mirror, labels=labels, w1=w1, w2=w2)


def preprocess(padded, shapes, roi_start, roi_size, mirror):
    """The device stage on the local shard: resample to OUTxOUT float32, then
    CMN to bfloat16 HWC (ImageNet mean and std)."""
    from ..kernels.cmn import crop_mirror_normalize
    from ..kernels.resample import resample_batch
    from ..types import DALIInterpType

    imgs = resample_batch(padded, shapes, roi_start, roi_size, OUT, OUT,
                          DALIInterpType.INTERP_LINEAR, True, torch.float32)
    zeros = torch.zeros((padded.shape[0],), dtype=torch.int32, device=padded.device)
    return crop_mirror_normalize(imgs, zeros, zeros, mirror, OUT, OUT, mean=mpt.CMN_MEAN,
                                 std=mpt.CMN_STD, output_layout="HWC", out_dtype=torch.bfloat16)


def mlp_loss(feats, w1, w2, onehot, n: int):
    """The reference's loss: mean cross-entropy of relu(feats @ w1) @ w2
    (the sum over the batch divided by ``n``: a mean over a sharded batch
    would need an averaging collective, which gloo does not have)."""
    h = torch.relu(feats @ w1)
    logp = torch.log_softmax(h @ w2, dim=1)
    return -(logp * onehot).sum() / n


def reference_step(inputs, device="cpu"):
    """The same step on one device without DTensors: (loss, w1, w2) as
    numpy, the held-against values of a sharded run."""
    t = {k: torch.from_numpy(v).to(device) for k, v in inputs.items()}
    n = t["padded"].shape[0]
    x = preprocess(t["padded"], t["shapes"], t["roi_start"], t["roi_size"], t["mirror"])
    feats = x.reshape(n, -1).to(torch.float32)
    onehot = torch.nn.functional.one_hot(t["labels"].long(), NCLS).float()
    w1, w2 = t["w1"].clone().requires_grad_(), t["w2"].clone().requires_grad_()
    loss = mlp_loss(feats, w1, w2, onehot, n)
    loss.backward()
    with torch.no_grad():
        new = [(w - LR * w.grad).cpu().numpy() for w in (w1, w2)]
    return float(loss.detach()), new[0], new[1]


def train_step(mesh, inputs, dev):
    """Loss, this rank's shards of the updated w1 and w2, and the
    collectives the step issued, by name."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode

    from ..plugin.distributed import from_shard

    data, model = mesh.shape
    di, mi = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    n = inputs["padded"].shape[0]
    per = n // data
    rows = slice(di * per, (di + 1) * per)

    def local(name):
        return torch.from_numpy(inputs[name][rows]).to(dev)

    x = preprocess(local("padded"), local("shapes"), local("roi_start"), local("roi_size"),
                   local("mirror"))
    feats = from_shard(x.reshape(per, -1).to(torch.float32), mesh, [Shard(0), Replicate()],
                     (n, OUT * OUT * 3))
    onehot = from_shard(torch.nn.functional.one_hot(local("labels").long(), NCLS).float(), mesh,
                      [Shard(0), Replicate()], (n, NCLS))
    k1, k2 = DMODEL // model, DMODEL // model
    w1 = from_shard(torch.from_numpy(inputs["w1"][:, mi * k1:(mi + 1) * k1]).to(dev), mesh,
                  [Replicate(), Shard(1)], inputs["w1"].shape).requires_grad_()
    w2 = from_shard(torch.from_numpy(inputs["w2"][mi * k2:(mi + 1) * k2]).to(dev), mesh,
                  [Replicate(), Shard(0)], inputs["w2"].shape).requires_grad_()
    comm = CommDebugMode()
    with comm:
        loss = mlp_loss(feats, w1, w2, onehot, n)
        loss.backward()
        with torch.no_grad():
            new = [(w - LR * w.grad.redistribute(mesh, w.placements)).to_local()
                   for w in (w1, w2)]
        loss_value = loss.detach().full_tensor()
    counts = {str(k).split(".")[-1]: v for k, v in comm.get_comm_counts().items()}
    return loss_value, new, counts


def hold_cmn(call) -> dict:
    """A recorded CMN call (``bench_ssd.recording_cmn``) against its plain
    version on the same arguments, raising unless the bfloat16 bits are
    equal; then its readings (``bench_ssd.time_cmn``) with ``max_abs_err``."""
    import inspect

    from ..kernels.cmn import crop_mirror_normalize, crop_mirror_normalize_plain
    from .bench_ssd import time_cmn

    # time_cmn reads the arguments by position, as the operator passes them
    bound = inspect.signature(crop_mirror_normalize).bind(*call[0], **call[1])
    bound.apply_defaults()
    args, got = list(bound.args), call[2]
    want = crop_mirror_normalize_plain(*args)
    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(
            got.view(torch.int16), want.view(torch.int16)):
        raise AssertionError(f"the step's CMN kernel {tuple(got.shape)} {got.dtype} is not "
                             f"bit-equal to its plain version {tuple(want.shape)} {want.dtype}")
    return dict(time_cmn((args, {}, got)), max_abs_err=float((got.float() - want.float()).abs().max()))


def hybrid_check(mesh, device, rank):
    """The hybrid program as one pipeline per data shard: this rank's shard
    of the global batch against its shard pipeline run alone. Returns the
    global batch's shape."""
    from .. import fn, pipeline_def, types
    from ..plugin.distributed import DALIGenericIterator

    sub = mesh["data"]
    shards = sub.size()

    def make_pipe(shard):
        @pipeline_def(batch_size=HYBRID_BATCH, num_threads=1, seed=11,
                      device=mpt.rank_device(device, rank))
        def hp():
            enc, lab = fn.readers.file(file_root=mpt.JPEG_ROOT, shard_id=shard,
                                       num_shards=shards, name="R")
            images, decoded = mpt.hybrid_tail(fn, types, enc, with_decoded=True)
            return images, decoded

        return hp()

    pipe = make_pipe(sub.get_local_rank())
    it = DALIGenericIterator([pipe], ["images", "decoded"], device_mesh=sub)
    got = next(it)
    solo = make_pipe(sub.get_local_rank())
    solo.build()
    for k, want in zip(("images", "decoded"), solo.run()):
        local = got[k].to_local()
        if not torch.equal(local, want.as_tensor().to(local.device)):
            raise AssertionError(f"rank {rank}: the sharded hybrid {k} != its shard run alone")
    for p in (pipe, solo):
        p.shutdown()
    return list(got["images"].shape)


def worker(rank, world, store, device, out_dir, results):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..kernels import cmn
    from .bench_ssd import recording_cmn

    if device == "cuda":
        torch.cuda.set_device(mpt.rank_device(device, rank))
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        mesh = init_device_mesh(device, mesh_shape(world), mesh_dim_names=("data", "model"))
        dev = torch.device(mpt.rank_device(device, rank))
        inputs = step_inputs(mesh.shape[0])
        t0 = time.perf_counter()
        cmn.COUNTER.launches = 0
        with recording_cmn([]) as calls:
            loss, (w1, w2), counts = train_step(mesh, inputs, dev)
        launches = cmn.COUNTER.launches
        loss = float(loss)
        if not np.isfinite(loss):
            raise AssertionError(f"the dry run's loss is {loss}")
        step_s = time.perf_counter() - t0
        form = hold_cmn(calls[0]) if device == "cuda" else None
        shape = hybrid_check(mesh, device, rank)
        if out_dir:
            np.savez(os.path.join(out_dir, f"dryrun_rank{rank}.npz"), loss=np.float32(loss),
                     w1=w1.cpu().numpy(), w2=w2.cpu().numpy(),
                     model=mesh.get_local_rank("model"))
        results.put((rank, {"loss": loss, "collectives": counts, "cmn_launches": launches,
                            "step_seconds": round(step_s, 3), "hybrid_global_shape": shape,
                            "cmn_form": form}))
    finally:
        dist.destroy_process_group()


def gather_weights(out_dir: str, ranks: int):
    """(loss, w1, w2) assembled from the ranks' ``dryrun_rank{r}.npz``: w1's
    column blocks and w2's row blocks by model coordinate; the ranks of one
    model coordinate must hold equal shards."""
    shards = [np.load(os.path.join(out_dir, f"dryrun_rank{r}.npz")) for r in range(ranks)]
    by_model = {}
    for s in shards:
        seen = by_model.setdefault(int(s["model"]), s)
        if not (np.array_equal(seen["w1"], s["w1"]) and np.array_equal(seen["w2"], s["w2"])):
            raise AssertionError("two data rows hold different weight shards")
    blocks = [by_model[m] for m in sorted(by_model)]
    if len({float(s["loss"]) for s in shards}) != 1:
        raise AssertionError("the ranks' losses differ")
    return (float(shards[0]["loss"]), np.concatenate([b["w1"] for b in blocks], axis=1),
            np.concatenate([b["w2"] for b in blocks], axis=0))


def run(device: str = "cpu", ranks: int = 4, out_dir: str = None) -> dict:
    """Spawns ``ranks`` ranks; raises if any check failed on any rank."""
    import torch.multiprocessing as mp

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        results = ctx.SimpleQueue()
        mp.start_processes(worker, args=(ranks, os.path.join(tmp, "store"), device, out_dir,
                                         results),
                           nprocs=ranks, join=True, start_method="spawn")
        out = dict(results.get() for _ in range(ranks))
    return {"device": device, "ranks": ranks, "mesh": list(mesh_shape(ranks)),
            "by_rank": {r: out[r] for r in sorted(out)}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--out", default=None, help="directory for the ranks' dryrun_rank{r}.npz")
    args = ap.parse_args()
    sys.path.insert(0, mpt.ROOT)
    print(json.dumps(run(args.device, args.ranks, args.out)))


if __name__ == "__main__":
    main()
