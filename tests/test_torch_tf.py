"""The TensorFlow and PaddlePaddle plugins of the port
(``dali_tpu_torch.plugin.tf``, ``.paddle``) on the CPU: the cases of
``tests/test_tf_plugin.py`` and ``tests/test_tf_checkpoint.py`` (a device
and a host output through ``DALIDataset``, the gated numba and paddle
plugins, checkpoints riding ``tf.train.Checkpoint``), each against
``dali_tpu``'s plugin on the same pipeline; and the paddle iterator through
the reference test's stand-in module (``tests/test_plugin_shims.py``),
against ``dali_tpu``'s."""

import sys

import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch

from .test_plugin_shims import _mock_paddle


def _tf():
    return pytest.importorskip("tensorflow")


def _kw(pkg):
    return {"device": "cpu"} if pkg is dali_tpu_torch else {}


def _two_outputs(pkg):
    data = [np.full((3,), i, np.float32) for i in range(8)]

    @pkg.pipeline_def(batch_size=4, num_threads=1, seed=1, **_kw(pkg))
    def pipe2():
        x = pkg.fn.external_source(source=lambda info: data[info.idx_in_epoch % 8])
        return x.gpu() * 2.0, x

    p = pipe2()
    p.build()
    return p


def test_dali_dataset():
    tf = _tf()
    from dali_tpu.plugin.tf import DALIDataset as RefDataset
    from dali_tpu_torch.plugin.tf import DALIDataset

    got, want = [], []
    for ds_cls, pkg, out in ((DALIDataset, dali_tpu_torch, got), (RefDataset, dali_tpu, want)):
        it = iter(ds_cls(_two_outputs(pkg), output_dtypes=(tf.float32, tf.float32),
                         output_shapes=((4, 3), (4, 3))))
        for _ in range(3):
            a, b = next(it)
            assert a.shape == (4, 3) and b.shape == (4, 3)
            out.append((a.numpy(), b.numpy()))
    np.testing.assert_array_equal(got[0][0], 2 * got[0][1])
    assert float(got[1][1][0, 0]) == 4.0  # the second batch starts at sample 4
    for (ga, gb), (wa, wb) in zip(got, want):
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(gb, wb)


def test_generic_iterator_and_legacy_factory():
    tf = _tf()
    from dali_tpu_torch.plugin import tf as dali_tf

    it = dali_tf.DALIGenericIterator(_two_outputs(dali_tpu_torch), ["dev", "host"],
                                     (tf.float32, tf.float32), size=8, auto_reset=True)
    batches = list(it)
    assert len(batches) == 2 and set(batches[0]) == {"dev", "host"}
    assert len(list(it)) == 2  # auto_reset: a second epoch
    legacy = dali_tf.DALIIterator()(_two_outputs(dali_tpu_torch), (tf.float32, tf.float32))
    np.testing.assert_array_equal(next(legacy)[1].numpy(), batches[0]["host"].numpy())


def test_numba_plugin_gated():
    try:
        import numba  # noqa: F401
        pytest.skip("numba is installed: the gate does not apply")
    except ImportError:
        pass
    from dali_tpu_torch.plugin import numba as numba_plugin

    with pytest.raises(ImportError, match="requires numba"):
        numba_plugin.numba_function(run_fn=None, out_types=[], in_types=[])


def test_paddle_plugin_gated(monkeypatch):
    from dali_tpu_torch.plugin.paddle import DALIGenericIterator

    monkeypatch.setitem(sys.modules, "paddle", None)  # as if not installed
    with pytest.raises(ImportError, match="PaddlePaddle"):
        DALIGenericIterator([], ["x"])


def test_paddle_iterator_through_stand_in(monkeypatch, tmp_path):
    """The reference shim test's reader pipeline, with a device output
    added: two batches an epoch as paddle tensors, equal to dali_tpu's."""
    monkeypatch.setitem(sys.modules, "paddle", _mock_paddle())
    d = tmp_path / "data"
    d.mkdir()
    for i in range(8):
        (d / f"f_{i}.bin").write_bytes(bytes([i, i]))
    from dali_tpu.plugin.paddle import DALIGenericIterator as RefIterator
    from dali_tpu_torch.plugin.paddle import DALIClassificationIterator, DALIGenericIterator

    def make(pkg):
        @pkg.pipeline_def(batch_size=4, num_threads=1, seed=3, **_kw(pkg))
        def p():
            data, label = pkg.fn.readers.file(file_root=str(tmp_path), file_filters=["*.bin"],
                                              name="R")
            return data, label, data.gpu()

        return p()

    got = [{k: v.numpy() for k, v in b.items()} for b in DALIGenericIterator(
        [make(dali_tpu_torch)], ["data", "label", "dev"], reader_name="R")]
    want = [{k: v.numpy() for k, v in b.items()} for b in RefIterator(
        [make(dali_tpu)], ["data", "label", "dev"], reader_name="R")]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("data", "label", "dev"):
            np.testing.assert_array_equal(g[k], w[k])
    it = DALIClassificationIterator([make(dali_tpu_torch)], reader_name="R", auto_reset=True)
    assert [set(b) for b in it] == [{"data", "label"}] * 2
    assert len(list(it)) == 2


# -- checkpoints in tf.train.Checkpoint ---------------------------------------------------------
@pytest.fixture()
def dataset(tmp_path):
    d = tmp_path / "d"
    d.mkdir()
    for i in range(10):
        (d / f"f_{i:02d}.bin").write_bytes(bytes([i]))
    return str(tmp_path)


def _make(pkg, root, ck=None):
    @pkg.pipeline_def(batch_size=2, num_threads=1, seed=5, enable_checkpointing=True,
                      checkpoint=ck, **_kw(pkg))
    def p():
        data, _ = pkg.fn.readers.file(file_root=root, file_filters=["*.bin"],
                                      random_shuffle=True, name="R")
        return data

    pipe = p()
    pipe.build()
    return pipe


def _vals(t):
    return tuple(int(v) for v in np.asarray(t[0])[:, 0])


def test_tf_checkpoint_resume_no_repeat(dataset, tmp_path):
    tf = _tf()
    from dali_tpu_torch.plugin import tf as dali_tf

    pipe = _make(dali_tpu_torch, dataset)
    it = iter(dali_tf.DALIDataset(pipe, output_dtypes=(tf.uint8,), prefetch_queue_depth=0))
    consumed = [_vals(next(it)) for _ in range(2)]
    path = tf.train.Checkpoint(dali=dali_tf.checkpointable(pipe)).save(str(tmp_path / "ck"))
    after = [_vals(next(it)) for _ in range(4)]

    pipe2 = _make(dali_tpu_torch, dataset)
    tf.train.Checkpoint(dali=dali_tf.checkpointable(pipe2)).restore(path)
    it2 = iter(dali_tf.DALIDataset(pipe2, output_dtypes=(tf.uint8,), prefetch_queue_depth=0))
    resumed = [_vals(next(it2)) for _ in range(3)]
    # a contiguous suffix of the post-checkpoint stream: TF's generator
    # look-ahead may skip the buffered head, never more than a few batches
    assert resumed[0] in after, (resumed, after)
    k = after.index(resumed[0])
    assert k <= 2, f"skipped too much: {k}"
    n = min(len(resumed), len(after) - k)
    assert resumed[:n] == after[k:k + n], (resumed, after)
    assert not set(consumed) & set(resumed)


def _stream(pkg, dataset, n, ck=None, checkpoint_after=None):
    """``n`` batches taken as the plugins take them, the pipeline running
    its prefetch ahead; with ``checkpoint_after`` also the checkpoint taken
    after that many batches."""
    p = _make(pkg, dataset, ck)
    p._prefetch()
    out, payload = [], None
    for k in range(n):
        if k == checkpoint_after:
            payload = p.checkpoint()
        out.append(_vals([p.outputs()[0].as_array()]))
        p.schedule_run()
    return out, payload


def test_consumed_aligned_checkpoint_under_pipeline_prefetch(dataset):
    """Without TF in the way the alignment is exact: checkpointing after
    two consumed batches resumes at the third although the pipeline ran
    ahead; the port's stream is dali_tpu's."""
    stream, payload = _stream(dali_tpu_torch, dataset, 5, checkpoint_after=2)
    assert _stream(dali_tpu_torch, dataset, 3, ck=payload)[0] == stream[2:]
    assert _stream(dali_tpu, dataset, 5)[0] == stream


def test_checkpointable_is_trackable(dataset, tmp_path):
    tf = _tf()
    from dali_tpu_torch.plugin import tf as dali_tf

    ckpt = tf.train.Checkpoint(dali=dali_tf.checkpointable(_make(dali_tpu_torch, dataset)))
    p = ckpt.save(str(tmp_path / "t"))
    assert tf.train.latest_checkpoint(str(tmp_path)) is not None
    ckpt.restore(p).assert_existing_objects_matched()
