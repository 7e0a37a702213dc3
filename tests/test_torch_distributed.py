"""Multi-GPU in the reference's model (ROADMAP Queue 1 item 6) against
dali_tpu on the CPU.

* (i) the shard semantics of ``tests/test_shard_semantics.py``, in process:
  the shard formula for 2, 3 and 4 shards over 11 files, the rotation
  without ``stick_to_shard``, ``stick_to_shard``, ``pad_last_batch`` and the
  ``LastBatchPolicy`` epoch lengths; every sample id equal to dali_tpu's;
* (ii) ``dali_tpu_torch.tools.multiprocess_test`` on 2 ranks (gloo, a
  ``file://`` store): the ranks' shards of phases (a) and (b) equal to
  ``dali_tpu.plugin.jax.DALIGenericIterator``'s global array over two CPU
  devices, phase (c)'s uint8 crops bit-equal and its float tail within 1e-4
  of dali_tpu's ``debug=True`` run of the same shard pipelines;
* (iii) ``dali_tpu_torch.tools.dryrun_multidevice`` on 4 ranks (2 x 2): the
  loss and the updated ``w1`` and ``w2`` within 1e-5 relative of the same
  step computed here from ``dali_tpu.kernels.resample.resample_batch`` and
  ``dali_tpu.kernels.cmn.crop_mirror_normalize`` on one CPU device;
* (iv) the ``ValueError``s for PARTIAL with a mesh and for a wrong pipeline
  count, raised in both packages, the 2-D mesh's ``NotImplementedError``,
  ``DALIPeekableIterator`` and ``data_iterator`` on a 1-rank mesh.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import dali_tpu
import dali_tpu_torch
from dali_tpu.plugin import jax as ref_jax
from dali_tpu_torch.plugin import distributed as port_dist
from dali_tpu_torch.tools import dryrun_multidevice as dm
from dali_tpu_torch.tools import multiprocess_test as mpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FILES = 11  # prime: uneven shards for every shard count


@pytest.fixture(scope="module")
def indexed(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    (root / "data").mkdir()
    for i in range(N_FILES):
        (root / "data" / f"f_{i:03d}.bin").write_bytes(bytes([i]))
    return str(root)


def _pipe(pkg, root, sid, shards, batch, stick=False, pad=False):
    extra = {"device": "cpu"} if pkg is dali_tpu_torch else {}

    @pkg.pipeline_def(batch_size=batch, num_threads=1, seed=5, **extra)
    def p():
        data, _ = pkg.fn.readers.file(file_root=root, shard_id=sid, num_shards=shards,
                                      random_shuffle=False, stick_to_shard=stick,
                                      pad_last_batch=pad, file_filters=["*.bin"], name="Reader")
        return data

    return p()


def _ids(pkg, root, sid, shards, batch, iters, **kw):
    pipe = _pipe(pkg, root, sid, shards, batch, **kw)
    out = []
    for _ in range(iters):
        (data,) = pipe.run()
        out += [int(np.asarray(data.at(i))[0]) for i in range(batch)]
    return out


def _bounds(sid, shards):
    return sid * N_FILES // shards, (sid + 1) * N_FILES // shards


# name -> (shard id, shard count, batch, iterations, reader flags, expected ids)
def _rotation(sid, shards, count):
    out, epoch = [], 0
    while len(out) < count:
        a, b = _bounds((sid + epoch) % shards, shards)
        out += list(range(a, b))
        epoch += 1
    return out[:count]


def _padded(sid, shards, batch):
    a, b = _bounds(sid, shards)
    steps = -(-(-(-N_FILES // shards)) // batch) * batch
    return (list(range(a, b)) + [b - 1] * (steps - (b - a))) * 2, 2 * steps // batch


SHARD_CASES = {
    **{f"formula_{s}_shards_shard_{i}": (i, s, 1, _bounds(i, s)[1] - _bounds(i, s)[0], {},
                                         list(range(*_bounds(i, s))))
       for s in (2, 3, 4) for i in range(s)},
    "rotation_without_stick": (1, 3, 1, N_FILES + 2, {}, _rotation(1, 3, N_FILES + 2)),
    "stick_to_shard": (2, 3, 1, 3 * 4, {"stick": True}, list(range(*_bounds(2, 3))) * 3),
    **{f"pad_last_batch_shard_{i}": (i, 3, 2, _padded(i, 3, 2)[1],
                                     {"stick": True, "pad": True}, _padded(i, 3, 2)[0])
       for i in range(3)},
}


@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_shard_semantics_equal_dali_tpu(indexed, case):
    sid, shards, batch, iters, kw, want = SHARD_CASES[case]
    got = _ids(dali_tpu_torch, indexed, sid, shards, batch, iters, **kw)
    assert got == _ids(dali_tpu, indexed, sid, shards, batch, iters, **kw) == want


def test_padded_epoch_size_uniform_and_equal(indexed):
    metas = {}
    for pkg in (dali_tpu_torch, dali_tpu):
        sizes = set()
        for sid in range(4):
            pipe = _pipe(pkg, indexed, sid, 4, 3, pad=True)
            pipe.build()
            sizes.add(pipe.reader_meta()["Reader"]["epoch_size_padded"])
        metas[pkg.__name__] = sizes
    assert metas["dali_tpu_torch"] == metas["dali_tpu"] == {-(-(-(-N_FILES // 4)) // 3) * 3 * 4}


@pytest.mark.parametrize("policy,pad", [("FILL", True), ("DROP", True), ("PARTIAL", True),
                                        ("DROP", False)])
def test_last_batch_policy_epochs_equal_dali_tpu(indexed, policy, pad):
    """Two epochs (auto_reset) of shard 0 of 2 (5 samples) at batch 4: the
    batch count, each batch's extent and ids in both packages' iterators."""
    epochs = {}
    for pkg, mod in ((dali_tpu_torch, port_dist), (dali_tpu, ref_jax)):
        it = mod.DALIGenericIterator([_pipe(pkg, indexed, 0, 2, 4, pad=pad)], ["data"],
                                     reader_name="Reader", auto_reset=True,
                                     last_batch_policy=getattr(mod.LastBatchPolicy, policy))
        epochs[pkg.__name__] = [[np.asarray(b["data"])[:, 0].tolist() for b in it]
                                for _ in range(2)]
    assert epochs["dali_tpu_torch"] == epochs["dali_tpu"]
    assert len(epochs["dali_tpu"][0]) == (1 if policy == "DROP" else 2)


# ------------------------------------------------------------ the 2-rank tool

def _ref_mesh():
    return Mesh(np.array(jax.devices("cpu")[:2]), ("data",))


def _ref_external_source():
    mesh = _ref_mesh()
    pipes = []
    for shard in range(2):
        @dali_tpu.pipeline_def(batch_size=mpt.BATCH, num_threads=1, seed=1)
        def p(shard=shard):
            return dali_tpu.fn.external_source(
                source=lambda: np.full((mpt.BATCH, 3), shard, np.int32), batch=True)

        pipes.append(p())
    it = ref_jax.DALIGenericIterator(pipes, ["data"], size=64,
                                     sharding=NamedSharding(mesh, P("data")))
    return np.asarray(next(it)["data"])


def _ref_reader(root):
    """Epoch ids per shard, then the ids of 2 batches per shard after a
    mid-epoch checkpoint of the second epoch, as the tool's phase (b)."""
    sharding = NamedSharding(_ref_mesh(), P("data"))

    def make(ck=None):
        pipes = []
        for shard in range(2):
            @dali_tpu.pipeline_def(batch_size=mpt.BATCH, num_threads=1, seed=123,
                                   enable_checkpointing=True, checkpoint=ck[shard] if ck else None)
            def rp(shard=shard):
                data, label = dali_tpu.fn.readers.file(
                    file_root=root, file_filters=["*.bin"], shuffle_after_epoch=True, seed=5,
                    shard_id=shard, num_shards=2, name="R")
                return data, label

            pipes.append(rp())
        return ref_jax.DALIGenericIterator(pipes, ["data", "label"], reader_name="R",
                                           sharding=sharding)

    def ids(batch):
        return [np.asarray(s.data)[:, 0].tolist() for s in batch["data"].addressable_shards]

    it = make()
    epoch = [[], []]
    for b in it:
        for k, v in enumerate(ids(b)):
            epoch[k] += v
    it.reset()
    for _ in range(2):
        next(it)
    ck = it.checkpoints()
    expect = [ids(next(it)) for _ in range(2)]
    it2 = make(ck["pipelines"])
    it2.restore_counter(ck["counter"])
    assert [ids(next(it2)) for _ in range(2)] == expect
    return epoch, [[b[k] for b in expect] for k in range(2)]


def _small_jpegs(root):
    """The reference multiprocess test's JPEG tree (``make_jpeg_dataset``):
    32 JPEGs of 80-104 px from ``hybrid_fixture.write_jpeg``."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from hybrid_fixture import write_jpeg

    os.makedirs(os.path.join(root, "cls"))
    for i in range(32):
        write_jpeg(os.path.join(root, "cls", f"j_{i:03d}.jpg"), np.random.default_rng(1000 + i),
                   80 + (i % 4) * 8, 96 + (i % 3) * 8)
    return root


def _ref_hybrid(jpeg_root):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from hybrid_fixture import hybrid_tail

    out = []
    for shard in range(2):
        @dali_tpu.pipeline_def(batch_size=mpt.BATCH, num_threads=1, seed=77, debug=True)
        def hp(shard=shard):
            enc, lab = dali_tpu.fn.readers.file(file_root=jpeg_root, shard_id=shard,
                                                num_shards=2, name="R")
            images, decoded = hybrid_tail(enc, with_decoded=True)
            return images, decoded, lab

        pipe = hp()
        pipe.build()
        out.append([np.asarray(o.as_tensor() if hasattr(o, "as_tensor") else o.as_array())
                    for o in pipe.run()])
    return out


def test_two_ranks_equal_dali_tpu_global_arrays(tmp_path):
    jpegs = _small_jpegs(str(tmp_path / "jpegs"))
    res = mpt.run("cpu", str(tmp_path), jpegs)
    assert res["by_rank"][0]["global_sum"] == res["by_rank"][1]["global_sum"] == 6
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    np.testing.assert_array_equal(np.concatenate([r["a_local"] for r in ranks]),
                                  _ref_external_source())
    epoch, resumed = _ref_reader(mpt.make_dataset(str(tmp_path / "data")))
    for r in range(2):
        assert ranks[r]["b_epoch_ids"].tolist() == epoch[r]
        assert ranks[r]["b_resumed_ids"].tolist() == resumed[r]
    assert sorted(epoch[0] + epoch[1]) == list(range(mpt.N_FILES))
    for r, (images, decoded, labels) in enumerate(_ref_hybrid(jpegs)):
        np.testing.assert_array_equal(ranks[r]["c_decoded"], decoded)
        np.testing.assert_array_equal(ranks[r]["c_labels"].reshape(-1), labels.reshape(-1))
        np.testing.assert_allclose(ranks[r]["c_images"], images, rtol=0, atol=1e-4)


# ------------------------------------------------------------ the dry run

def _ref_step(inputs):
    """dryrun_multichip's train step on one CPU device (no mesh)."""
    from dali_tpu.kernels.cmn import crop_mirror_normalize
    from dali_tpu.kernels.resample import resample_batch
    from dali_tpu.types import DALIInterpType

    n = inputs["padded"].shape[0]
    imgs = resample_batch(jnp.asarray(inputs["padded"]), jnp.asarray(inputs["shapes"]),
                          jnp.asarray(inputs["roi_start"]), jnp.asarray(inputs["roi_size"]),
                          dm.OUT, dm.OUT, DALIInterpType.INTERP_LINEAR, True, jnp.float32)
    zeros = jnp.zeros((n,), jnp.int32)
    x = crop_mirror_normalize(imgs, zeros, zeros, jnp.asarray(inputs["mirror"]), dm.OUT, dm.OUT,
                              mean=np.array(mpt.CMN_MEAN, np.float32),
                              std=np.array(mpt.CMN_STD, np.float32), output_layout="HWC",
                              out_dtype=jnp.bfloat16)
    feats = x.reshape(n, -1).astype(jnp.float32)
    labels = jnp.asarray(inputs["labels"])

    def loss_fn(p):
        h = jnp.maximum(feats @ p["w1"], 0.0)
        logp = jax.nn.log_softmax(h @ p["w2"])
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))

    params = {"w1": jnp.asarray(inputs["w1"]), "w2": jnp.asarray(inputs["w2"])}
    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), {k: np.asarray(params[k] - dm.LR * grads[k]) for k in params}


def test_dryrun_four_ranks_equal_the_reference_step(tmp_path):
    res = dm.run("cpu", 4, str(tmp_path))
    assert res["mesh"] == [2, 2]
    for r in res["by_rank"].values():
        assert r["hybrid_global_shape"] == [2 * dm.HYBRID_BATCH, 3, mpt.OUT_SIZE, mpt.OUT_SIZE]
        assert set(r["collectives"]) == {"all_reduce"}
    loss, w1, w2 = dm.gather_weights(str(tmp_path), 4)
    ref_loss, new = _ref_step(dm.step_inputs(2))
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for got, want in ((w1, new["w1"]), (w2, new["w2"])):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # the single-device step without DTensors, as the card phase holds the sharded one
    one_loss, one_w1, one_w2 = dm.reference_step(dm.step_inputs(2))
    assert abs(loss - one_loss) <= 1e-6 * abs(one_loss)
    np.testing.assert_allclose(w1, one_w1, rtol=0, atol=1e-6 * np.abs(one_w1).max())
    np.testing.assert_allclose(w2, one_w2, rtol=0, atol=1e-6 * np.abs(one_w2).max())


# ------------------------------------------------------------ the iterator's errors

@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _src_pipe(pkg, value=0):
    extra = {"device": "cpu"} if pkg is dali_tpu_torch else {}

    @pkg.pipeline_def(batch_size=2, num_threads=1, seed=1, **extra)
    def p():
        return pkg.fn.external_source(source=lambda: np.full((2, 3), value, np.int32),
                                      batch=True)

    return p()


def test_partial_and_pipeline_count_raise_in_both(one_rank_group):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (1,))
    sharding = NamedSharding(_ref_mesh(), P("data"))
    with pytest.raises(ValueError, match="PARTIAL"):
        ref_jax.DALIGenericIterator([_src_pipe(dali_tpu)], ["data"], sharding=sharding,
                                    last_batch_policy=ref_jax.LastBatchPolicy.PARTIAL)
    with pytest.raises(ValueError, match="PARTIAL"):
        port_dist.DALIGenericIterator([_src_pipe(dali_tpu_torch)], ["data"], device_mesh=mesh,
                                      last_batch_policy=port_dist.LastBatchPolicy.PARTIAL)
    with pytest.raises(ValueError, match="pipeline"):
        next(ref_jax.DALIGenericIterator([_src_pipe(dali_tpu, v) for v in range(3)], ["data"],
                                         size=6, sharding=sharding))
    with pytest.raises(ValueError, match="pipeline"):
        next(port_dist.DALIGenericIterator([_src_pipe(dali_tpu_torch, v) for v in range(2)],
                                           ["data"], size=4, device_mesh=mesh))
    with pytest.raises(NotImplementedError, match="item 6"):
        port_dist.DALIGenericIterator([_src_pipe(dali_tpu_torch)], ["data"],
                                      device_mesh=init_device_mesh("cpu", (1, 1)))


def test_peekable_and_data_iterator(one_rank_group):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    mesh = init_device_mesh("cpu", (1,))
    it = port_dist.DALIPeekableIterator([_src_pipe(dali_tpu_torch, 4)], ["data"], size=8,
                                        device_mesh=mesh)
    first = it.peek()
    assert it.peek_async()() is first and next(it) is first
    assert isinstance(first["data"], DTensor) and first["data"].placements == (Shard(0),)
    assert first["data"].full_tensor().tolist() == [[4] * 3] * 2

    def graph(shard_id=None, num_shards=None):
        data, _ = dali_tpu_torch.fn.readers.file(
            file_root=mpt.JPEG_ROOT, shard_id=shard_id, num_shards=num_shards, name="R")
        return dali_tpu_torch.fn.shapes(data)

    make = port_dist.data_iterator(graph, ["shape"], device_mesh=mesh, reader_name="R")
    batch = next(make(batch_size=4, num_threads=1))["shape"]
    assert isinstance(batch, DTensor) and tuple(batch.shape) == (4, 1)
    plain = port_dist.data_iterator(_src_graph, ["data"], size=4)(
        batch_size=2, num_threads=1, device="cpu")
    want = ref_jax.data_iterator(_src_graph_ref, ["data"], size=4)(batch_size=2, num_threads=1)
    np.testing.assert_array_equal(next(plain)["data"].numpy(), np.asarray(next(want)["data"]))


def _src_graph():
    return dali_tpu_torch.fn.external_source(source=lambda: np.full((2, 3), 7, np.int32),
                                             batch=True)


def _src_graph_ref():
    return dali_tpu.fn.external_source(source=lambda: np.full((2, 3), 7, np.int32), batch=True)


def test_process_exits_cleanly_with_pipelines_in_flight():
    """F7 (ROADMAP Queue 3): two prefetching hybrid-decode pipelines left
    running when the interpreter exits. Their daemon stage threads were still
    inside torch calls when Python finalized, and the process aborted
    ("terminate called without an active exception"); the executor now stops
    its threads at exit."""
    import subprocess

    code = f"""
import sys
sys.path.insert(0, {REPO!r})
import dali_tpu_torch as P
from dali_tpu_torch import fn

def make():
    @P.pipeline_def(batch_size=2, num_threads=1, seed=77, device="cpu")
    def p():
        enc, lab = fn.readers.file(file_root={mpt.JPEG_ROOT!r}, name="R")
        return fn.decoders.image_random_crop(enc, device="mixed", hybrid_device_decode=True,
                                             hybrid_scale=2), lab
    return p()

for pipe in (make(), make()):
    pipe.build()
    pipe._prefetch()
    pipe.run()
print("ran")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and "ran" in res.stdout, res.stderr[-2000:]


# ------------------------------------------------------------ F8: shards of different shapes

_F8_RANKS = r'''
import json, os, sys
import multiprocessing as mp
import numpy as np
import torch

def rank_main(rank, store, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    import dali_tpu_torch
    from dali_tpu_torch.plugin import distributed as port_dist
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=2)
    mesh = init_device_mesh("cpu", (2,))
    res = {}
    local = torch.zeros((2, 3 + rank, 4))
    try:
        port_dist.global_batch(local, mesh, "images")
        res["direct"] = "no error"
    except ValueError as e:
        res["direct"] = str(e)
    side = 3 + rank

    @dali_tpu_torch.pipeline_def(batch_size=2, num_threads=1, seed=1, device="cpu")
    def p():
        labels = dali_tpu_torch.fn.external_source(
            source=lambda: [np.zeros((1,), np.int32)] * 2, batch=True)
        boxes = dali_tpu_torch.fn.external_source(
            source=lambda: [np.zeros((side, 4), np.float32)] * 2, batch=True)
        return labels, boxes
    pipe = p()
    pipe.build()
    it = port_dist.DALIGenericIterator([pipe], ["labels", "boxes"], size=4, device_mesh=mesh)
    calls = []
    gather = dist.all_gather
    dist.all_gather = lambda *a, **k: (calls.append(1), gather(*a, **k))[1]
    try:
        next(it)
        res["iterator"] = "no error"
    except ValueError as e:
        res["iterator"] = str(e)
    dist.all_gather = gather
    res["iterator_collectives"] = len(calls)
    same = port_dist.global_batch(torch.full((2, 3), float(rank)), mesh, "ok")
    res["same_shape_sum"] = float(same.sum(0).full_tensor().sum().item())
    pipe.shutdown()
    dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)

if __name__ == "__main__":
    out = sys.argv[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, os.path.join(out, "store"), out))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(100)
    sys.exit(max(p.exitcode if p.exitcode is not None else 99 for p in procs))
'''


def test_f8_ranks_with_different_batch_shapes_raise_on_both(tmp_path):
    """Two gloo ranks whose local batches differ ([2, 3, 4] against
    [2, 4, 4], directly and as the second of an iterator's two outputs) both
    raise ValueError naming the output and each rank's shape, and neither
    aborts; the iterator checks all its outputs in one all_gather; shards
    of one shape still assemble."""
    import json
    import subprocess

    script = tmp_path / "ranks.py"
    script.write_text(_F8_RANKS)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, str(script), str(tmp_path)], check=True, timeout=150,
                   env=env, cwd=REPO)
    for r in range(2):
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert "output 'images'" in res["direct"], res
        assert "rank 0: [2, 3, 4], rank 1: [2, 4, 4]" in res["direct"], res
        assert "output 'boxes'" in res["iterator"], res
        assert "rank 0: [2, 3, 4], rank 1: [2, 4, 4]" in res["iterator"], res
        assert res["iterator_collectives"] == 1, res
        assert res["same_shape_sum"] == 6.0
