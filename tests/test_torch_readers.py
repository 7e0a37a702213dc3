"""The dataset readers of dali_tpu_torch against dali_tpu on the CPU:
readers.TFRecord, Webdataset, Numpy (cpu and ``device="gpu"``), Sequence and
readers.File, over local files and ``s3://`` roots (an in-process mock S3
server, as in tests/test_s3.py), built node for node in both packages so that
implicit seeds key on the same op ids.

Every output is equal bit for bit (``np.array_equal``, dtype and shape
included): bytes, labels, arrays and sequences, in shard and shuffle order,
with ``pad_last_batch``; a checkpoint taken in either package resumes in the
other at the same sample. Each dataset is written small into pytest's tmp
dir from a numpy seed or from the committed corpus.
"""

import http.server
import io
import json
import os
import tarfile
import threading

import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch
from dali_tpu import _s3 as ref_s3
from dali_tpu import tfrecord as ref_tfrec
from dali_tpu_torch import _s3 as port_s3
from dali_tpu_torch import tfrecord as port_tfrec
from dali_tpu_torch.testdata.make_reader_datasets import corpus_samples, write_wds_shards

from .test_s3 import MockS3Handler

SEED = 23


# ---------------------------------------------------------------- helpers

def _build(pkg, graph, batch=4, seed=SEED, **kw):
    if pkg is dali_tpu_torch:
        kw.setdefault("device", "cpu")

    @pkg.pipeline_def(batch_size=batch, num_threads=1, seed=seed, **kw)
    def pipe():
        return graph(pkg)

    p = pipe()
    p.build()
    return p


def _close(pipe):
    if isinstance(pipe, dali_tpu_torch.Pipeline):
        pipe.shutdown()
    else:
        pipe._executor.shutdown()


def _samples(outs):
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    return [[np.asarray(o.as_cpu().at(i) if hasattr(o, "as_cpu") else o.at(i))
             for i in range(len(o))] for o in outs]


def _run(pkg, graph, iters=2, batch=4, **kw):
    pipe = _build(pkg, graph, batch=batch, **kw)
    try:
        return [_samples(pipe.run()) for _ in range(iters)]
    finally:
        _close(pipe)


def _run_both(graph, iters=2, batch=4, **kw):
    """[iteration][output][sample] numpy of the port and of dali_tpu."""
    return [_run(pkg, graph, iters, batch, **kw) for pkg in (dali_tpu_torch, dali_tpu)]


def _assert_equal(port, ref):
    assert len(port) == len(ref)
    for it_p, it_r in zip(port, ref):
        assert len(it_p) == len(it_r)
        for out_p, out_r in zip(it_p, it_r):
            assert len(out_p) == len(out_r)
            for a, b in zip(out_p, out_r):
                assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, a.shape, b.dtype,
                                                                   b.shape)
                np.testing.assert_array_equal(a, b)


def _both_raise(graph, exc, match, **kw):
    for pkg in (dali_tpu_torch, dali_tpu):
        with pytest.raises(exc, match=match):
            _run(pkg, graph, iters=1, **kw)


def _resume_both_ways(graph, batch=4):
    """A checkpoint after one batch, taken in each package, resumes in the
    other at the same sample: the next two batches are equal."""
    for src, dst in ((dali_tpu, dali_tpu_torch), (dali_tpu_torch, dali_tpu)):
        pipe = _build(src, graph, batch=batch, enable_checkpointing=True)
        try:
            pipe.run()
            ckpt = pipe.checkpoint()
            want = [_samples(pipe.run()) for _ in range(2)]
        finally:
            _close(pipe)
        pipe = _build(dst, graph, batch=batch, checkpoint=ckpt)
        try:
            _assert_equal([_samples(pipe.run()) for _ in range(2)], want)
        finally:
            _close(pipe)


# ---------------------------------------------------------------- datasets

@pytest.fixture(scope="module")
def wds(tmp_path_factory):
    """Two shards of 11 and 12 corpus samples (.jpg + .cls), with wds2idx
    index files."""
    root = tmp_path_factory.mktemp("wds")
    paths, index = write_wds_shards(str(root), 23, 2, index=True)
    return paths, index


def _tar(path, members):
    with tarfile.open(path, "w") as tar:
        for name, payload in members:
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))
    return str(path)


@pytest.fixture(scope="module")
def wds_ragged(tmp_path_factory):
    """A shard whose samples miss components, spell extensions in two cases
    and carry float32 payloads; a second shard of whole samples."""
    root = tmp_path_factory.mktemp("wds_ragged")
    rng = np.random.default_rng(3)
    members = []
    for i in range(7):
        key = f"s{i:03d}"
        if i != 2:
            members.append((f"{key}.{'JPG' if i % 3 == 0 else 'jpg'}", rng.bytes(20 + i)))
        if i == 4:
            members.append((f"{key}.jpeg", rng.bytes(9)))
        if i not in (1, 5):
            members.append((f"{key}.npy", rng.standard_normal(3 + i).astype(np.float32)
                            .tobytes()))
        members.append((f"{key}.cls", str(i).encode()))
    whole = [(f"t{i:03d}.{ext}", payload) for i in range(5)
             for ext, payload in (("jpg", rng.bytes(12)), ("npy", np.float32([i]).tobytes()),
                                  ("cls", str(i).encode()))]
    return [_tar(root / "a.tar", members), _tar(root / "b.tar", whole)]


@pytest.fixture(scope="module")
def tfrecords(tmp_path_factory):
    """Two TFRecord files of 9 and 10 records: the ResNet-50 features plus a
    float VarLenFeature of varying length, a scalar int and a feature most
    records lack; index files beside them."""
    root = tmp_path_factory.mktemp("tfrec")
    rng = np.random.default_rng(4)
    samples = corpus_samples(19)
    paths, index = [], []
    for k, (lo, hi) in enumerate(((0, 9), (9, 19))):
        path = str(root / f"part-{k}")
        with open(path, "wb") as f:
            for i in range(lo, hi):
                feats = {"image/encoded": samples[i][0],
                         "image/class/label": np.array([samples[i][1]], np.int64),
                         "bbox": rng.uniform(0, 1, int(rng.integers(0, 6))).astype(np.float32),
                         "id": np.array([i], np.int64)}
                if i % 4 == 0:
                    feats["text"] = f"record {i}"
                port_tfrec.write_record(f, port_tfrec.write_example(feats))
        port_tfrec.write_index(path, path + ".idx")
        paths.append(path)
        index.append(path + ".idx")
    return paths, index


def _features(tf):
    return {"image/encoded": tf.FixedLenFeature((), tf.string, ""),
            "image/class/label": tf.FixedLenFeature([1], tf.int64, -1),
            "bbox": tf.VarLenFeature(tf.float32, 0.0),
            "id": tf.FixedLenFeature((), tf.int64, -1),
            "text": tf.FixedLenFeature((), tf.string, "")}


@pytest.fixture(scope="module")
def npy_dir(tmp_path_factory):
    """Six .npy files (three dtypes, C and Fortran order, rank 3) and a
    file list."""
    root = tmp_path_factory.mktemp("npy")
    rng = np.random.default_rng(5)
    for i in range(6):
        a = rng.standard_normal((4 + i, 6, 5)).astype((np.float32, np.int16, np.uint8)[i % 3]
                                                       if i % 3 else np.float32)
        if i % 3 == 1:
            a = (a * 100).astype(np.int16)
        if i == 4:
            a = np.asfortranarray(a)
        np.save(root / f"v{i}.npy", a)
    (root / "skip.txt").write_text("not a volume")
    (root / "list.txt").write_text("\n".join(f"v{i}.npy" for i in (3, 0, 5)) + "\n")
    return str(root)


# ---------------------------------------------------------------- TFRecord

@pytest.mark.parametrize("dont_use_mmap", [False, True], ids=["mmap", "pread"])
@pytest.mark.parametrize("indexed", [True, False], ids=["index", "scan"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_tfrecord_reader(tfrecords, indexed, shuffle, dont_use_mmap):
    paths, index = tfrecords

    def graph(pkg):
        tf = pkg.tfrecord
        out = pkg.fn.readers.tfrecord(path=paths, index_path=index if indexed else None,
                                      features=_features(tf), random_shuffle=shuffle,
                                      initial_fill=8, dont_use_mmap=dont_use_mmap,
                                      name="Reader")
        return tuple(out[k] for k in _features(tf))

    port, ref = _run_both(graph, iters=6, batch=4)
    _assert_equal(port, ref)
    texts = {bytes(s) for it in port for s in it[4]}
    # records without the feature take its default
    assert any(t.startswith(b"record") for t in texts) and any(
        not t.startswith(b"record") for t in texts)


@pytest.mark.parametrize("pad_last_batch", [False, True])
def test_tfrecord_shards_cover_the_dataset(tfrecords, pad_last_batch):
    paths, index = tfrecords
    seen = []
    for shard in range(3):
        def graph(pkg, shard=shard):
            tf = pkg.tfrecord
            return pkg.fn.readers.tfrecord(
                path=paths, index_path=index, features={"id": tf.FixedLenFeature((), tf.int64, -1)},
                shard_id=shard, num_shards=3, stick_to_shard=True, pad_last_batch=pad_last_batch,
                name="Reader")["id"]

        port, ref = _run_both(graph, iters=3, batch=4)
        _assert_equal(port, ref)
        ids = [int(s) for it in port for s in it[0]]
        lo, hi = shard * 19 // 3, (shard + 1) * 19 // 3
        seen += ids[:hi - lo]
        if pad_last_batch:
            assert ids[hi - lo:8] == [ids[hi - lo - 1]] * (8 - (hi - lo))
    assert sorted(seen) == list(range(19))


def test_tfrecord_checkpoint_both_ways(tfrecords):
    paths, index = tfrecords

    def graph(pkg):
        tf = pkg.tfrecord
        out = pkg.fn.readers.tfrecord(path=paths, index_path=index, features=_features(tf),
                                      random_shuffle=True, initial_fill=6, name="Reader")
        return out["image/encoded"], out["id"]

    _resume_both_ways(graph)


def test_tfrecord_module_is_the_references():
    ex = {"a": b"\x00\x01", "b": np.array([3, 0, 2 ** 40], np.int64),
          "c": np.array([0.5, -2.25], np.float32)}
    blob = port_tfrec.write_example(ex)
    assert blob == ref_tfrec.write_example(ex)
    got, want = port_tfrec.parse_example(blob), ref_tfrec.parse_example(blob)
    assert got["a"] == want["a"] == [b"\x00\x01"]
    for k in ("b", "c"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_tfrecord_negative_int64_round_trips():
    """A negative int64 (a TFRecord writer's -1 label) is a 10-byte
    two's-complement varint; the reference's writer loops on it and its
    parser overflows, the port's round-trips it."""
    blob = port_tfrec.write_example({"label": np.array([-1, 5, -(2 ** 63)], np.int64)})
    np.testing.assert_array_equal(port_tfrec.parse_example(blob)["label"], [-1, 5, -(2 ** 63)])


# ---------------------------------------------------------------- Webdataset

@pytest.mark.parametrize("dont_use_mmap", [False, True], ids=["mmap", "pread"])
@pytest.mark.parametrize("indexed", [True, False], ids=["index", "scan"])
def test_webdataset_reader(wds, indexed, dont_use_mmap):
    paths, index = wds

    def graph(pkg):
        return tuple(pkg.fn.readers.webdataset(
            paths=paths, index_paths=index if indexed else None, ext=["jpg", "cls"],
            random_shuffle=True, initial_fill=10, dont_use_mmap=dont_use_mmap, name="Reader"))

    port, ref = _run_both(graph, iters=7, batch=4)
    _assert_equal(port, ref)
    # each .jpg came with its own .cls
    want = dict(corpus_samples(23))
    assert all(want[bytes(j)] == int(bytes(c)) for it in port for j, c in zip(it[0], it[1]))


WDS_CASES = {
    "empty": dict(ext=["jpg", "npy", "cls"]),
    "skip": dict(ext=["jpg", "npy", "cls"], missing_component_behavior="skip"),
    "alternatives": dict(ext=["jpg;jpeg", "cls"], missing_component_behavior="skip"),
    "case_insensitive": dict(ext=["JPG", "cls"], case_sensitive_extensions=False),
    "dtypes": dict(ext=["npy", "cls"], dtypes=[np.float32, np.uint8],
                   missing_component_behavior="skip"),
}


@pytest.mark.parametrize("case", sorted(WDS_CASES))
def test_webdataset_components(wds_ragged, case):
    kw = WDS_CASES[case]

    def graph(pkg):
        out = pkg.fn.readers.webdataset(paths=wds_ragged, name="Reader", **kw)
        return out if isinstance(out, tuple) else (out,)

    _assert_equal(*_run_both(graph, iters=4, batch=3))


def test_webdataset_missing_component_error(wds_ragged):
    def graph(pkg):
        return tuple(pkg.fn.readers.webdataset(paths=wds_ragged, ext=["jpg", "npy"],
                                               missing_component_behavior="error"))

    _both_raise(graph, ValueError, "missing components")


def test_webdataset_malformed_index(wds, tmp_path):
    paths, index = wds
    bad = tmp_path / "bad.idx"
    lines = open(index[0]).read().splitlines()
    bad.write_text("\n".join(lines[:3] + ["jpg 1024 77"] + lines[3:]) + "\n")

    def graph(pkg):
        return tuple(pkg.fn.readers.webdataset(paths=paths, index_paths=[str(bad), index[1]],
                                               ext=["jpg", "cls"]))

    _both_raise(graph, ValueError, r"bad.idx:4: malformed wds2idx line")


@pytest.mark.parametrize("pad_last_batch", [False, True])
def test_webdataset_shards_and_checkpoint(wds, pad_last_batch):
    paths, index = wds

    def graph(pkg):
        return tuple(pkg.fn.readers.webdataset(
            paths=paths, index_paths=index, ext=["jpg", "cls"], shard_id=1, num_shards=2,
            pad_last_batch=pad_last_batch, random_shuffle=True, initial_fill=5, name="Reader"))

    _assert_equal(*_run_both(graph, iters=5, batch=5))
    _resume_both_ways(graph, batch=5)


# ---------------------------------------------------------------- Numpy

@pytest.mark.parametrize("source", ["file_root", "files", "file_list", "header_cache"])
def test_numpy_reader(npy_dir, source):
    kw = {"file_root": dict(file_root=npy_dir),
          "files": dict(file_root=npy_dir, files=["v5.npy", os.path.join(npy_dir, "v1.npy")]),
          "file_list": dict(file_root=npy_dir, file_list=os.path.join(npy_dir, "list.txt")),
          "header_cache": dict(file_root=npy_dir, file_filter="v*.npy",
                               cache_header_information=True)}[source]

    def graph(pkg):
        return pkg.fn.readers.numpy(random_shuffle=True, initial_fill=4, name="Reader", **kw)

    port, ref = _run_both(graph, iters=3, batch=3)
    _assert_equal(port, ref)
    if source == "file_root":
        assert {s.dtype for it in port for s in it[0]} == {np.dtype(np.float32),
                                                           np.dtype(np.int16),
                                                           np.dtype(np.uint8)}


ROI_CASES = {
    "start_end": dict(roi_start=[1, 2, 0], roi_end=[3, 5, 4]),
    "start_shape_axes": dict(roi_start=[1, 1], roi_shape=[2, 3], roi_axes=[1, 2]),
    "relative": dict(rel_roi_start=[0.25, 0.1, 0.0], rel_roi_end=[0.75, 0.9, 0.5]),
    "rel_shape": dict(rel_roi_shape=[0.5], roi_axes=[0]),
    "pad": dict(roi_start=[-1, 4, 1], roi_end=[5, 8, 4], out_of_bounds_policy="pad",
                fill_value=-7.0),
    "trim": dict(roi_start=[-2, 3, 0], roi_end=[3, 9, 5], out_of_bounds_policy="trim_to_shape"),
    "cache_roi": dict(roi_start=[0, 1, 1], roi_end=[2, 4, 3], cache_header_information=True),
}


@pytest.mark.parametrize("case", sorted(ROI_CASES))
def test_numpy_reader_roi(npy_dir, case):
    def graph(pkg):
        return pkg.fn.readers.numpy(file_root=npy_dir, name="Reader", **ROI_CASES[case])

    _assert_equal(*_run_both(graph, iters=2, batch=3))


def test_numpy_reader_roi_out_of_bounds_error(npy_dir):
    def graph(pkg):
        return pkg.fn.readers.numpy(file_root=npy_dir, roi_start=[0, 0, 0], roi_end=[5, 7, 5])

    _both_raise(graph, ValueError, r"out_of_bounds_policy='error'")


def test_numpy_reader_gpu_device(npy_dir):
    """``device="gpu"`` is the mixed reader: its batch is on the device (the
    CPU here) and equals the cpu reader's and dali_tpu's."""
    def graph(pkg, device):
        return pkg.fn.readers.numpy(file_root=npy_dir, file_filter="v[03].npy", device=device,
                                    roi_start=[1, 1, 1], roi_shape=[3, 4, 4], name="Reader")

    port_pipe = _build(dali_tpu_torch, lambda pkg: graph(pkg, "gpu"), batch=3)
    try:
        (out,) = port_pipe.run()
        assert out.as_tensor().shape == (3, 3, 4, 4)
        port = [_samples(out)]
    finally:
        _close(port_pipe)
    _assert_equal(port, _run(dali_tpu_torch, lambda pkg: graph(pkg, "cpu"), iters=1, batch=3))
    _assert_equal(port, _run(dali_tpu, lambda pkg: graph(pkg, "gpu"), iters=1, batch=3))


def test_numpy_reader_checkpoint_both_ways(npy_dir):
    def graph(pkg):
        return pkg.fn.readers.numpy(file_root=npy_dir, random_shuffle=True, initial_fill=3,
                                    shuffle_after_epoch=False, name="Reader")

    _resume_both_ways(graph, batch=2)


# ---------------------------------------------------------------- Sequence

@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    """Three directories of 4, 7 and 2 JPEG frames of 48x64 from a seed (and
    a stray file)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("seq")
    rng = np.random.default_rng(6)
    for d, n in (("a", 4), ("b", 7), ("c", 2)):
        os.makedirs(root / d)
        for j in range(n):
            frame = rng.integers(0, 256, (48, 64, 3), np.uint8)
            Image.fromarray(frame).save(root / d / f"f{j:02d}.jpg", quality=90)
    (root / "stray.txt").write_text("x")
    return str(root)


@pytest.mark.parametrize("kw", [dict(sequence_length=3), dict(sequence_length=2, step=3, stride=2)],
                         ids=["length3", "step3_stride2"])
def test_sequence_reader(sequences, kw):
    def graph(pkg):
        return pkg.fn.readers.sequence(file_root=sequences, random_shuffle=True, initial_fill=3,
                                       name="Reader", **kw)

    port, ref = _run_both(graph, iters=3, batch=2)
    _assert_equal(port, ref)
    assert all(s.ndim == 4 and s.shape[0] == kw["sequence_length"] and s.shape[3] == 3
               for it in port for s in it[0])


# ---------------------------------------------------------------- s3:// roots

@pytest.fixture()
def mock_s3(monkeypatch, wds, npy_dir):
    """A mock S3 bucket holding a class tree of corpus JPEGs, the two
    webdataset shards and the .npy files."""
    store = {}
    for i, (jpeg, label) in enumerate(corpus_samples(32)[::4]):
        store[f"train/class{label}/img{i:02d}.jpg"] = jpeg
    store["train/class1/notes.txt"] = b"skipped by the filters"
    store["train/empty/sub/deep.jpg"] = corpus_samples(1)[0][0]
    for p in wds[0]:
        store[f"wds/{os.path.basename(p)}"] = open(p, "rb").read()
    for f in sorted(os.listdir(npy_dir)):
        store[f"npy/{f}"] = open(os.path.join(npy_dir, f), "rb").read()
    MockS3Handler.objects = {"bucket": store}
    MockS3Handler.auth_seen = []
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), MockS3Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    monkeypatch.setenv("AWS_ENDPOINT_URL", f"http://127.0.0.1:{server.server_port}")
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "test-access")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "test-secret")
    for mod in (port_s3, ref_s3):
        mod.reset_client()
    yield server
    for mod in (port_s3, ref_s3):
        mod.reset_client()
    server.shutdown()
    server.server_close()


def test_file_reader_s3_root(mock_s3):
    def graph(pkg):
        return tuple(pkg.fn.readers.file(file_root="s3://bucket/train", name="Reader"))

    port, ref = _run_both(graph, iters=3, batch=4)
    _assert_equal(port, ref)
    # the empty/ prefix takes label 2 and holds no file one level down
    assert [int(s[0]) for s in port[0][1] + port[1][1]] == [0] * 4 + [1] * 4
    assert all(a.startswith("AWS4-HMAC-SHA256 Credential=test-access/")
               for a in MockS3Handler.auth_seen)


def test_webdataset_s3(mock_s3, wds):
    _, index = wds
    uris = ["s3://bucket/wds/shard-00000.tar", "s3://bucket/wds/shard-00001.tar"]
    for idx in (None, index):
        def graph(pkg, idx=idx):
            return tuple(pkg.fn.readers.webdataset(paths=uris, index_paths=idx,
                                                   ext=["jpg", "cls"], name="Reader"))

        port, ref = _run_both(graph, iters=2, batch=5)
        _assert_equal(port, ref)
        local = _run(dali_tpu_torch, lambda pkg: tuple(pkg.fn.readers.webdataset(
            paths=wds[0], ext=["jpg", "cls"], name="Reader")), iters=2, batch=5)
        _assert_equal(port, local)


def test_numpy_reader_s3(mock_s3, npy_dir):
    def graph(pkg, root):
        return pkg.fn.readers.numpy(file_root=root, file_filter="v*.npy", roi_start=[1, 0, 0],
                                    roi_end=[3, 4, 5], random_shuffle=True, name="Reader")

    port, ref = _run_both(lambda pkg: graph(pkg, "s3://bucket/npy"), iters=3, batch=2)
    _assert_equal(port, ref)
    _assert_equal(port, _run(dali_tpu_torch, lambda pkg: graph(pkg, npy_dir), iters=3, batch=2))


def test_tfrecord_fn_returns_features_in_order(tfrecords):
    """fn.readers.tfrecord returns its outputs keyed by feature, in order."""
    paths, index = tfrecords

    def graph(pkg):
        out = pkg.fn.readers.tfrecord(path=paths, index_path=index, features=_features(
            pkg.tfrecord))
        assert list(out) == list(_features(pkg.tfrecord))
        return out["id"]

    port, ref = _run_both(graph, iters=1, batch=3)
    _assert_equal(port, ref)
    assert json.dumps([int(s) for s in port[0][0]]) == "[0, 1, 2]"
