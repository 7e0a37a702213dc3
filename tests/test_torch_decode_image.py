"""Whole-image hybrid decode (``fn.decoders.image(device="mixed",
hybrid_device_decode=True, hybrid_wire="int8")``) and the coefficient cache
of both hybrid decoders: dali_tpu_torch on the CPU against dali_tpu with
``debug=True`` (op by op: the jitted reference fuses multiply-adds into FMAs,
which moves a rounding tie on ~1e-5 of pixels).

Contract: the decoded uint8 images are bit-equal, at every decode scale and
sampling mode; the cache changes no output, and its hit and miss counts are
the reference's."""

import os

import cv2
import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch
from dali_tpu import native as ref_native
from dali_tpu_torch.batch import HostBatch

CORPUS = os.path.join(os.path.dirname(__file__), "..", "dali_tpu_torch", "testdata", "rn50")
SUBSAMP = {"420": 0, "444": 1, "422": 2}


def _corpus_files(k=None):
    files = sorted(os.path.join(r, f) for r, _, fs in os.walk(CORPUS) for f in fs
                   if f.endswith(".jpg"))
    return files[:k] if k else files


def _write(root, mode, k=8, quality=90):
    """The first ``k`` corpus images re-encoded in ``mode`` (4:2:0 files
    are the committed ones)."""
    d = os.path.join(str(root), "c")
    os.makedirs(d, exist_ok=True)
    for i, f in enumerate(_corpus_files(k)):
        if mode == "420":
            data = open(f, "rb").read()
        else:
            rgb = cv2.cvtColor(cv2.imread(f), cv2.COLOR_BGR2RGB)
            data = ref_native.jpeg_encode_rgb(rgb, quality=quality, subsamp=SUBSAMP[mode])
        with open(os.path.join(d, f"{i:02d}.jpg"), "wb") as fh:
            fh.write(data)
    return str(root)


def _decode_pipe(pkg, root, batch, scale, cache_size=0, rrc=False, **kw):
    fn = pkg.fn

    @pkg.pipeline_def(batch_size=batch, num_threads=2, seed=42, **kw)
    def p():
        jpegs, labels = fn.readers.file(file_root=root, random_shuffle=True, name="Reader",
                                        seed=1234)
        if rrc:
            return fn.decoders.image_random_crop(jpegs, device="mixed", hybrid_device_decode=True,
                                                 hybrid_scale=scale, seed=77,
                                                 cache_size=cache_size), labels
        return fn.decoders.image(jpegs, device="mixed", hybrid_device_decode=True,
                                 hybrid_scale=scale, hybrid_wire="int8",
                                 cache_size=cache_size), labels

    pipe = p()
    pipe.build()
    return pipe


def _ref(root, batch, scale, **kw):
    return _decode_pipe(dali_tpu, root, batch, scale, debug=True, **kw)


def _port(root, batch, scale, **kw):
    return _decode_pipe(dali_tpu_torch, root, batch, scale, device="cpu", **kw)


def _images(out):
    t = out[0]
    data = t.as_tensor()
    data = data.numpy() if hasattr(data, "numpy") else np.asarray(data)
    return [data[i][:h, :w] for i, (h, w, _) in enumerate(t.shape())], np.asarray(
        out[1].as_array())


def _impl(pipe, name):
    impls = pipe.executor.impls if hasattr(pipe, "executor") else pipe._executor.impls
    return next(i for i in impls.values() if type(i).__name__ == name)


@pytest.mark.parametrize("mode", ["420", "422", "444"])
@pytest.mark.parametrize("scale", [1, 2, 4])
def test_whole_image_decode_bit_equal(tmp_path, mode, scale):
    root = _write(tmp_path, mode)
    ref, port = _ref(root, 4, scale), _port(root, 4, scale)
    try:
        for _ in range(2):
            (want, lw), (got, lg) = _images(ref.run()), _images(port.run())
            np.testing.assert_array_equal(lg, lw)
            assert [g.shape for g in got] == [w.shape for w in want]
            for g, w in zip(got, want):
                assert g.dtype == np.uint8
                np.testing.assert_array_equal(g, w)
        # the device canvas is the reference's too
        assert tuple(port.run()[0].as_tensor().shape) == tuple(
            np.asarray(ref.run()[0].as_tensor()).shape)
    finally:
        ref._executor.shutdown()
        port.shutdown()


@pytest.mark.parametrize("rrc,scale", [(False, 1), (False, 2), (False, 4), (True, 2)])
def test_grayscale_decode_bit_equal(tmp_path, rrc, scale):
    """One-component JPEGs: luma from the stream, zero chroma planes, so
    R = G = B = Y; the sparse wire reads them through the dense baseline read."""
    d = tmp_path / "c"
    d.mkdir()
    for i, f in enumerate(_corpus_files(4)):
        cv2.imwrite(str(d / f"{i:02d}.jpg"), cv2.imread(f, cv2.IMREAD_GRAYSCALE))
    ref, port = _ref(str(tmp_path), 4, scale, rrc=rrc), _port(str(tmp_path), 4, scale, rrc=rrc)
    try:
        for _ in range(2):
            (want, lw), (got, lg) = _images(ref.run()), _images(port.run())
            np.testing.assert_array_equal(lg, lw)
            assert [g.shape for g in got] == [w.shape for w in want]
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
                np.testing.assert_array_equal(g[..., 0], g[..., 2])
    finally:
        ref._executor.shutdown()
        port.shutdown()


def test_whole_image_decode_output_shapes_follow_header(tmp_path):
    root = _write(tmp_path, "420", k=4)
    port = _port(root, 4, 2)
    try:
        out = port.run()[0]
        assert out.layout() == "HWC"
        hw = sorted(tuple(int(v) for v in s[:2]) for s in out.shape())
        files = [cv2.imread(f).shape[:2] for f in _corpus_files(4)]
        assert hw == sorted(((-(-h // 2)), -(-w // 2)) for h, w in files)
    finally:
        port.shutdown()


def test_mixed_sampling_batch_raises(tmp_path):
    d = tmp_path / "c"
    d.mkdir()
    rgb = np.random.default_rng(6).integers(0, 256, (32, 40, 3), np.uint8)
    (d / "a.jpg").write_bytes(ref_native.jpeg_encode_rgb(rgb, subsamp=0))
    (d / "b.jpg").write_bytes(ref_native.jpeg_encode_rgb(rgb, subsamp=1))
    port = _port(str(tmp_path), 2, 2)
    try:
        with pytest.raises(ValueError, match="mixed chroma samplings"):
            port.run()
    finally:
        port.shutdown()


def _with_exif_orientation(data: bytes, value: int) -> bytes:
    """``data`` with an APP1 Exif segment (little-endian TIFF, one IFD entry:
    Orientation = ``value``) after SOI."""
    tiff = (b"II*\x00" + (8).to_bytes(4, "little") + (1).to_bytes(2, "little")
            + (0x0112).to_bytes(2, "little") + (3).to_bytes(2, "little")
            + (1).to_bytes(4, "little") + value.to_bytes(2, "little") + b"\x00\x00"
            + (0).to_bytes(4, "little"))
    body = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + (len(body) + 2).to_bytes(2, "big") + body + data[2:]


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_exif_tagged_file_raises(tmp_path, pkg):
    d = tmp_path / "c"
    d.mkdir()
    data = open(_corpus_files(1)[0], "rb").read()
    (d / "a.jpg").write_bytes(_with_exif_orientation(data, 6))
    (d / "b.jpg").write_bytes(data)
    assert dali_tpu_torch.backend.decoders.exif_orientation(
        np.frombuffer((d / "a.jpg").read_bytes(), np.uint8)) == 6
    pipe = (_port if pkg == "port" else _ref)(str(tmp_path), 2, 2)
    try:
        with pytest.raises(ValueError, match="EXIF orientation"):
            pipe.run()
    finally:
        if pkg == "port":
            pipe.shutdown()
        else:
            pipe._executor.shutdown()


def test_exif_tag_ignored_with_adjust_orientation_false(tmp_path):
    d = tmp_path / "c"
    d.mkdir()
    data = open(_corpus_files(1)[0], "rb").read()
    (d / "a.jpg").write_bytes(_with_exif_orientation(data, 6))
    fn = dali_tpu_torch.fn

    @dali_tpu_torch.pipeline_def(batch_size=1, num_threads=1, seed=1, device="cpu")
    def p():
        jpegs, _ = fn.readers.file(file_root=str(tmp_path))
        return fn.decoders.image(jpegs, device="mixed", hybrid_device_decode=True,
                                 hybrid_wire="int8", hybrid_scale=2, adjust_orientation=False)

    pipe = p()
    pipe.build()
    try:
        (out,) = pipe.run()
        assert out.shape()[0] == (188, 250, 3)
    finally:
        pipe.shutdown()


# -- the coefficient cache ----------------------------------------------------------------------


@pytest.mark.parametrize("scale,cache_mb,k,batch", [
    (2, 64, 6, 4),   # every file fits: misses in epoch 1, hits after
    (1, 1, 6, 4),    # a 1 MB budget holds a few whole-image planes; the rest decode each time
    (4, 64, 5, 2),   # epochs of 5 files at batch 2: batches straddle epochs
])
def test_cache_changes_no_output_and_counts_as_reference(tmp_path, scale, cache_mb, k, batch):
    root = _write(tmp_path, "420", k=k)
    ref = _ref(root, batch, scale, cache_size=cache_mb)
    port, plain = _port(root, batch, scale, cache_size=cache_mb), _port(root, batch, scale)
    try:
        for _ in range(4):
            (want, _), (got, lg), (base, lb) = (_images(p.run()) for p in (ref, port, plain))
            np.testing.assert_array_equal(lg, lb)
            for g, w, b in zip(got, want, base):
                np.testing.assert_array_equal(g, b)
                np.testing.assert_array_equal(g, w)
        cache = _impl(port, "JpegCoeffsSplit")._ccache
        want_cache = _impl(ref, "JpegCoeffsSplit")._ccache
        assert (cache["hits"], cache["misses"]) == (want_cache["hits"], want_cache["misses"])
        assert cache["used"] == want_cache["used"] <= cache["cap"]
        assert sorted(cache["map"]) == sorted(want_cache["map"])
        assert cache["misses"] >= len(cache["map"]) and cache["hits"] > 0
    finally:
        ref._executor.shutdown()
        port.shutdown()
        plain.shutdown()


def test_cache_keyless_and_budget_samples_take_the_window_read(tmp_path):
    """At the operator: a batch whose source_info has holes. Keyless samples
    never enter the cache and, like samples past an exhausted budget, read
    only their blocks; the staged wire decodes to the uncached op's planes."""
    import torch

    from dali_tpu_torch.kernels import wire

    root = _write(tmp_path, "420", k=4)
    datas = [np.fromfile(os.path.join(root, "c", f), np.uint8)
             for f in sorted(os.listdir(os.path.join(root, "c")))]
    keys = ["a", "", "c", None]
    cached = _port(root, 4, 2, cache_size=64)
    plain = _port(root, 4, 2)
    try:
        c_op, p_op = _impl(cached, "JpegCoeffsSplit"), _impl(plain, "JpegCoeffsSplit")
        for it in range(3):
            if it == 2:  # the budget is spent: a new key reads its blocks only
                c_op._ccache["cap"] = c_op._ccache["used"]
                keys = ["a", "", "c", "d"]
            got = c_op.stage_batch_multi(None, [HostBatch(datas, source_info=keys)])
            want = p_op.stage_batch_multi(None, [HostBatch(datas, source_info=keys)])
            for g, w in zip(got[:4], want[:4]):
                planes = []
                for item in (g, w):
                    t = {k: torch.from_numpy(np.ascontiguousarray(getattr(item, k)))
                         for k in ("offsets", "shapes")}
                    if hasattr(item, "mask"):
                        planes.append(wire.unsparse_boundary(
                            torch.from_numpy(item.mask.view(np.int16)),
                            wire.decode_nib_stream(torch.from_numpy(item.nibs),
                                                   torch.from_numpy(item.esc)),
                            t["offsets"], t["shapes"], item.canvas))
                    else:
                        planes.append(wire.unflatten_boundary(
                            wire.decode_esc16_stream(torch.from_numpy(item.dc8),
                                                     torch.from_numpy(item.esc)),
                            t["offsets"], t["shapes"], item.canvas))
                torch.testing.assert_close(planes[0], planes[1], rtol=0, atol=0)
            np.testing.assert_array_equal(got[4].array, want[4].array)
            np.testing.assert_array_equal(np.stack(got[5].samples), np.stack(want[5].samples))
        cache = c_op._ccache
        assert len(cache["map"]) == 2  # "a" and "c"; "" and None never cache, "d" came late
        assert (cache["hits"], cache["misses"]) == (4, 8)
    finally:
        cached.shutdown()
        plain.shutdown()


@pytest.mark.parametrize("scale", [1, 2])
def test_rrc_decode_cache_changes_no_output(tmp_path, scale):
    """_JpegCoeffsSplitRRC with cache_size: the same crops as without, and
    the reference's counts (its test_hybrid_coefficient_cache: 4 misses, 8
    hits over three epochs of four files)."""
    root = _write(tmp_path, "420", k=4)
    ref = _ref(root, 4, scale, cache_size=64, rrc=True)
    port = _port(root, 4, scale, cache_size=64, rrc=True)
    plain = _port(root, 4, scale, rrc=True)
    try:
        for _ in range(3):
            (want, _), (got, _), (base, _) = (_images(p.run()) for p in (ref, port, plain))
            for g, w, b in zip(got, want, base):
                np.testing.assert_array_equal(g, b)
                np.testing.assert_array_equal(g, w)
        cache = _impl(port, "JpegCoeffsSplitRRC")._ccache
        assert (cache["misses"], cache["hits"]) == (4, 8)
        want_cache = _impl(ref, "JpegCoeffsSplitRRC")._ccache
        assert (cache["hits"], cache["misses"], cache["used"]) == (
            want_cache["hits"], want_cache["misses"], want_cache["used"])
    finally:
        ref._executor.shutdown()
        port.shutdown()
        plain.shutdown()


def test_not_ported_decoder_forms_raise():
    fn = dali_tpu_torch.fn

    def build(**kw):
        @dali_tpu_torch.pipeline_def(batch_size=2, device="cpu")
        def p():
            jpegs, _ = fn.readers.file(file_root=CORPUS)
            return fn.decoders.image(jpegs, **kw)

        p().build()

    def run(data, **kw):
        arr = np.frombuffer(data, np.uint8)

        @dali_tpu_torch.pipeline_def(batch_size=2, device="cpu")
        def p():
            return fn.decoders.image(fn.external_source(source=lambda: [arr, arr]), **kw)

        pipe = p()
        pipe.build()
        try:
            pipe.run()
        finally:
            pipe.shutdown()

    img = cv2.imread(_corpus_files(1)[0])
    # a format not ported, and a JPEG form the libjpeg-free decoder does not read
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md, Queue 1 items 1c-1e"):
        run(b"GIF89a" + bytes(26), device="mixed")
    data = cv2.imencode(".jpg", img)[1].tobytes()
    sof = data.index(b"\xff\xc0")
    arithmetic = data[:sof + 1] + b"\xc9" + data[sof + 2:]
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md, Queue 1 item 1a"):
        run(arithmetic, device="cpu")
    with pytest.raises(ValueError, match="hybrid_wire"):
        build(device="mixed", hybrid_device_decode=True, hybrid_wire="int4")
    with pytest.raises(ValueError, match="device='mixed'"):
        build(device="cpu", hybrid_device_decode=True, hybrid_wire="int8")
    with pytest.raises(ValueError, match="hybrid_scale"):
        build(device="mixed", hybrid_device_decode=True, hybrid_wire="int8", hybrid_scale=3)
    with pytest.raises(ValueError, match="uint8"):
        build(device="mixed", hybrid_device_decode=True, hybrid_wire="int8",
              dtype=dali_tpu_torch.types.FLOAT)
    with pytest.raises(TypeError, match="unexpected"):
        build(device="mixed", hybrid_device_decode=True, hybrid_wire="int8", bogus=1)


def test_graph_nodes_match_reference():
    """Two nodes, in the reference's order: implicit seeds key on op ids."""
    def ops(pkg, **kw):
        fn = pkg.fn

        @pkg.pipeline_def(batch_size=2, num_threads=1, seed=1, **kw)
        def p():
            jpegs, labels = fn.readers.file(file_root=CORPUS)
            img = fn.decoders.image(jpegs, device="mixed", hybrid_device_decode=True,
                                    hybrid_wire="int8")
            return fn.random_resized_crop(img, size=[8, 8]), labels

        pipe = p()
        pipe.build()
        graph = pipe.executor.graph if hasattr(pipe, "executor") else pipe._executor.graph
        names = [(n.id, n.spec.schema_name) for n in graph.ops]
        (pipe.shutdown() if pkg is dali_tpu_torch else pipe._executor.shutdown())
        return names

    assert ops(dali_tpu_torch, device="cpu") == ops(dali_tpu)
