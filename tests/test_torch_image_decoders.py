"""Host-decoded image operators and the int16 hybrid wire of dali_tpu_torch on
the CPU against dali_tpu (``debug=True``: op by op) on the same seeded
pipelines: ``decoders.image``, ``image_random_crop``, ``image_crop``,
``image_slice`` (cpu and mixed), ``peek_image_shape``, the eager ``ndd``
decoders, ``decoders.image(hybrid_device_decode=True)`` on its default
int16 wire, two training recipes and a dali_tpu checkpoint resuming in the
port.

Contract: decoded images bit-equal (the reference decodes with libjpeg-turbo,
the port with its libjpeg-free decoder), the same random windows for the same
seeds, the same cache hit and miss counts. The recipes, whose resize and CMN
run in float on different backends, hold within one uint8 step (one step /
std after CMN) on at most 1e-3 of the values."""

import json
import os

import cv2
import numpy as np
import pytest
import torch

import dali_tpu
import dali_tpu.experimental.dynamic as ref_ndd
import dali_tpu_torch
import dali_tpu_torch.experimental.dynamic as ndd

from .test_torch_jpeg_decode import _non_interleaved

CORPUS = os.path.join(os.path.dirname(__file__), "..", "dali_tpu_torch", "testdata", "rn50")
MEAN = [123.675, 116.28, 103.53]
STD = [58.395, 57.12, 57.375]
LSB = 1.0 / min(STD) + 1e-4
MAX_FLIP_FRACTION = 1e-3


def _corpus_files(k=None):
    files = sorted(os.path.join(r, f) for r, _, fs in os.walk(CORPUS) for f in fs
                   if f.endswith(".jpg"))
    return files[:k] if k else files


def _host(t):
    """Per-sample numpy arrays of a pipeline output, cropped to its shapes."""
    if "GPU" in type(t).__name__:
        data = t.as_tensor()
        data = data.numpy() if isinstance(data, torch.Tensor) else np.asarray(data)
        return [data[i][tuple(slice(0, int(e)) for e in s)] for i, s in enumerate(t.shape())]
    return [np.asarray(t.at(i)) for i in range(len(t))]


def _pair(graph, batch=4, root=CORPUS, num_threads=2, **kw):
    """The same graph built in dali_tpu (debug) and in the port (CPU)."""
    pipes = []
    for pkg, extra in ((dali_tpu, {"debug": True}), (dali_tpu_torch, {"device": "cpu"})):
        @pkg.pipeline_def(batch_size=batch, num_threads=num_threads, seed=42, **extra, **kw)
        def p():
            jpegs, labels = pkg.fn.readers.file(file_root=root, random_shuffle=True,
                                                name="Reader", seed=1234)
            outs = graph(pkg, jpegs)
            return (*outs, labels) if isinstance(outs, tuple) else (outs, labels)

        pipe = p()
        pipe.build()
        pipes.append(pipe)
    return pipes


def _close(ref, port):
    ref._executor.shutdown()
    port.shutdown()


def _assert_same(ref, port, iters=2):
    for _ in range(iters):
        want, got = ref.run(), port.run()
        assert len(want) == len(got)
        for w, g in zip(want, got):
            ws, gs = _host(w), _host(g)
            assert len(ws) == len(gs)
            for a, b in zip(ws, gs):
                assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
                np.testing.assert_array_equal(b, a)


def _run_pair(graph, iters=2, **kw):
    ref, port = _pair(graph, **kw)
    try:
        _assert_same(ref, port, iters)
    finally:
        _close(ref, port)


# -- decoders.image ----------------------------------------------------------------------------
OUTPUT_TYPES = ["RGB", "BGR", "GRAY", "YCbCr", "ANY_DATA"]


@pytest.mark.parametrize("device", ["cpu", "mixed"])
@pytest.mark.parametrize("output_type", OUTPUT_TYPES)
def test_image_output_types_and_dtypes(device, output_type):
    for dtype in ("UINT8", "UINT16", "FLOAT"):
        _run_pair(lambda pkg, j: pkg.fn.decoders.image(
            j, device=device, output_type=getattr(pkg.types.DALIImageType, output_type),
            dtype=getattr(pkg.types, dtype)), iters=1)


@pytest.mark.parametrize("device", ["cpu", "mixed"])
@pytest.mark.parametrize("fancy", [True, False])
def test_image_fancy_upsampling_and_hint(device, fancy):
    for hint in (0, 100, 40):
        _run_pair(lambda pkg, j: pkg.fn.decoders.image(
            j, device=device, jpeg_fancy_upsampling=fancy, downscale_shorter_hint=hint))


def _with_exif_orientation(data: bytes, value: int) -> bytes:
    """``data`` with an APP1 Exif segment (Orientation = ``value``) after SOI."""
    tiff = (b"II*\x00" + (8).to_bytes(4, "little") + (1).to_bytes(2, "little")
            + (0x0112).to_bytes(2, "little") + (3).to_bytes(2, "little")
            + (1).to_bytes(4, "little") + value.to_bytes(2, "little") + b"\x00\x00"
            + (0).to_bytes(4, "little"))
    body = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + (len(body) + 2).to_bytes(2, "big") + body + data[2:]


def _exif_corpus(tmp_path, orientation, k=4):
    d = tmp_path / "c"
    d.mkdir()
    for i, f in enumerate(_corpus_files(k)):
        data = open(f, "rb").read()
        (d / f"{i:02d}.jpg").write_bytes(_with_exif_orientation(data, orientation) if i % 2 == 0
                                         else data)
    return str(tmp_path)


@pytest.mark.parametrize("orientation", [2, 3, 4, 5, 6, 7, 8])
def test_exif_orientation(tmp_path, orientation):
    root = _exif_corpus(tmp_path, orientation)
    for device in ("cpu", "mixed"):
        for adjust in (True, False):
            _run_pair(lambda pkg, j: (
                pkg.fn.decoders.image(j, device=device, adjust_orientation=adjust),
                pkg.fn.decoders.image_random_crop(j, device=device, adjust_orientation=adjust,
                                                  seed=3),
                pkg.fn.peek_image_shape(j, adjust_orientation=adjust)), root=root, iters=1)


# -- the decoded-image cache -------------------------------------------------------------------
@pytest.mark.parametrize("cache_type,size,threshold", [
    ("threshold", 64, 0), ("threshold", 1, 0), ("largest", 1, 0), ("threshold", 64, 560_000)])
def test_image_decoder_cache(tmp_path, cache_type, size, threshold):
    d = tmp_path / "c"
    d.mkdir()
    for i, f in enumerate(_corpus_files(6)):
        (d / f"{i:02d}.jpg").write_bytes(open(f, "rb").read())
    ref, port = _pair(lambda pkg, j: pkg.fn.decoders.image(
        j, device="mixed", cache_size=size, cache_type=cache_type, cache_threshold=threshold),
        root=str(tmp_path), num_threads=1, prefetch_queue_depth=1)
    try:
        _assert_same(ref, port, iters=4)
        counts = []
        for pipe in (ref, port):
            impls = pipe._executor.impls if hasattr(pipe, "_executor") else pipe.executor.impls
            c = next(i for i in impls.values() if type(i).__name__ == "ImageDecoderMixed")
            c = c._img_cache
            counts.append((c.hits, c.misses, c.used, sorted(map(str, c.map))))
        assert counts[1] == counts[0]
        assert counts[0][0] > 0 or size == 1 or threshold
    finally:
        _close(ref, port)


# -- image_random_crop, image_crop, image_slice, peek_image_shape -------------------------------
@pytest.mark.parametrize("device", ["cpu", "mixed"])
@pytest.mark.parametrize("hint", [0, 60])
def test_image_random_crop(device, hint):
    _run_pair(lambda pkg, j: (
        pkg.fn.decoders.image_random_crop(j, device=device, seed=7, downscale_shorter_hint=hint),
        pkg.fn.decoders.image_random_crop(j, device=device, random_area=[0.1, 1.0],
                                          random_aspect_ratio=[0.8, 1.25], num_attempts=100,
                                          downscale_shorter_hint=hint),
        pkg.fn.decoders.image_random_crop(j, device=device, random_area=[0.9, 1.0],
                                          random_aspect_ratio=[3.0, 4.0], num_attempts=2,
                                          output_type=pkg.types.GRAY)), iters=3)


@pytest.mark.parametrize("device", ["cpu", "mixed"])
@pytest.mark.parametrize("rounding", ["round", "truncate"])
def test_image_crop(device, rounding):
    _run_pair(lambda pkg, j: (
        pkg.fn.decoders.image_crop(j, device=device, crop=(101, 123), crop_pos_x=0.3,
                                   crop_pos_y=0.71, rounding=rounding),
        pkg.fn.decoders.image_crop(j, device=device, crop_h=57, crop_w=1000,
                                   output_type=pkg.types.BGR),
        pkg.fn.decoders.image_crop(j, device=device, crop=(64, 64),
                                   crop_pos_x=pkg.fn.random.uniform(range=(0.0, 1.0), seed=9),
                                   rounding=rounding)))


@pytest.mark.parametrize("device", ["cpu", "mixed"])
@pytest.mark.parametrize("normalized", [True, False])
def test_image_slice(device, normalized):
    anchor = [np.array([0.25, 0.1] if normalized else [20, 31], np.float32)] * 4
    shape = [np.array([0.5, 0.6] if normalized else [90, 40], np.float32)] * 4

    def graph(pkg, j):
        a = pkg.fn.external_source(source=lambda: anchor, batch=True)
        s = pkg.fn.external_source(source=lambda: shape, batch=True)
        return (pkg.fn.decoders.image_slice(j, a, s, device=device, normalized_anchor=normalized,
                                            normalized_shape=normalized),
                pkg.fn.decoders.image_slice(j, a, s, device=device, axis_names="WH",
                                            normalized_anchor=normalized,
                                            normalized_shape=normalized,
                                            dtype=pkg.types.FLOAT, output_type=pkg.types.GRAY),
                pkg.fn.decoders.image_slice(j, device=device))

    _run_pair(graph)


@pytest.mark.parametrize("dtype", [None, "INT32", "FLOAT"])
def test_peek_image_shape(tmp_path, dtype):
    d = tmp_path / "c"
    d.mkdir()
    files = _corpus_files(3)
    (d / "a.jpg").write_bytes(open(files[0], "rb").read())
    (d / "b.jpg").write_bytes(_with_exif_orientation(open(files[1], "rb").read(), 6))
    cv2.imwrite(str(d / "c.jpg"), cv2.imread(files[2], cv2.IMREAD_GRAYSCALE))
    (d / "d.jpg").write_bytes(open(files[2], "rb").read())

    def graph(pkg, j):
        kw = {} if dtype is None else {"dtype": getattr(pkg.types, dtype)}
        return (pkg.fn.peek_image_shape(j, **kw),
                pkg.fn.peek_image_shape(j, image_type=pkg.types.GRAY, adjust_orientation=False,
                                        **kw))

    _run_pair(graph, root=str(tmp_path))


# -- the int16 wire ----------------------------------------------------------------------------
def _reencode(tmp_path, mode, k=6):
    d = tmp_path / "c"
    d.mkdir()
    flag = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
    for i, f in enumerate(_corpus_files(k)):
        img = cv2.imread(f)
        if mode == "gray":
            cv2.imwrite(str(d / f"{i:02d}.jpg"), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY),
                        [cv2.IMWRITE_JPEG_PROGRESSIVE, i % 2])
        else:
            # odd sizes: sides not a multiple of 16
            img = cv2.resize(img, (img.shape[1] - 3 * i - 1, img.shape[0] - 5 * i - 2))
            cv2.imwrite(str(d / f"{i:02d}.jpg"), img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag[mode],
                                                       cv2.IMWRITE_JPEG_PROGRESSIVE, i % 2])
    return str(tmp_path)


@pytest.mark.parametrize("mode", ["420", "422", "444", "gray"])
@pytest.mark.parametrize("scale", [1, 2, 4])
def test_int16_wire_bit_equal(tmp_path, mode, scale):
    root = _reencode(tmp_path, mode)
    ref, port = _pair(lambda pkg, j: pkg.fn.decoders.image(
        j, device="mixed", hybrid_device_decode=True, hybrid_scale=scale), root=root)
    try:
        _assert_same(ref, port, iters=2)
        assert tuple(port.run()[0].as_tensor().shape) == tuple(
            np.asarray(ref.run()[0].as_tensor()).shape)
    finally:
        _close(ref, port)


@pytest.mark.parametrize("size", [64, 1])
def test_int16_wire_cache(tmp_path, size):
    root = _reencode(tmp_path, "420")
    ref, port = _pair(lambda pkg, j: pkg.fn.decoders.image(
        j, device="mixed", hybrid_device_decode=True, hybrid_scale=2, cache_size=size), root=root,
        num_threads=1, prefetch_queue_depth=1)
    try:
        _assert_same(ref, port, iters=4)
        counts = []
        for pipe in (ref, port):
            impls = pipe._executor.impls if hasattr(pipe, "_executor") else pipe.executor.impls
            c = next(i for i in impls.values() if type(i).__name__ == "JpegCoeffs")._ccache
            counts.append((c["hits"], c["misses"], c["used"], len(c["map"])))
        assert counts[1] == counts[0] and counts[0][0] > 0
    finally:
        _close(ref, port)


def test_int16_wire_rejects_what_the_reference_rejects(tmp_path):
    d = tmp_path / "c"
    d.mkdir()
    img = cv2.imread(_corpus_files(1)[0])
    cv2.imwrite(str(d / "a.jpg"), img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])
    cv2.imwrite(str(d / "b.jpg"), img)
    for pkg, extra in ((dali_tpu, {"debug": True}), (dali_tpu_torch, {"device": "cpu"})):
        @pkg.pipeline_def(batch_size=2, num_threads=1, seed=1, **extra)
        def p():
            jpegs, _ = pkg.fn.readers.file(file_root=str(tmp_path))
            return pkg.fn.decoders.image(jpegs, device="mixed", hybrid_device_decode=True)

        pipe = p()
        pipe.build()
        try:
            with pytest.raises(ValueError, match="4:2:0/4:2:2/4:4:4"):
                pipe.run()
        finally:
            (pipe._executor if pkg is dali_tpu else pipe).shutdown()


# -- the two recipes and a checkpoint ----------------------------------------------------------
def _rn50_host_decode(pkg, jpegs):
    fn, types = pkg.fn, pkg.types
    images = fn.decoders.image_random_crop(
        jpegs, device="mixed", output_type=types.RGB, random_area=[0.1, 1.0],
        random_aspect_ratio=[0.8, 1.25], num_attempts=100)
    resized = fn.resize(images, resize_x=224, resize_y=224, interp_type=types.INTERP_TRIANGULAR)
    out = fn.crop_mirror_normalize(resized, mirror=fn.random.coin_flip(probability=0.5),
                                   dtype=types.FLOAT, output_layout="CHW", mean=MEAN, std=STD)
    return out, images, resized


def _proxy_int16_wire(pkg, jpegs):
    fn, types = pkg.fn, pkg.types
    images = fn.decoders.image(jpegs, device="mixed", hybrid_device_decode=True)
    resized = fn.random_resized_crop(images, size=[224, 224])
    out = fn.crop_mirror_normalize(
        resized, mirror=fn.random.coin_flip(), dtype=types.FLOAT, output_layout="CHW",
        mean=[0.485 * 255, 0.456 * 255, 0.406 * 255], std=[0.229 * 255, 0.224 * 255, 0.225 * 255])
    return out, images, resized


def _assert_recipe_close(want, got):
    (w_out, w_dec, w_res, w_lab), (g_out, g_dec, g_res, g_lab) = want, got
    np.testing.assert_array_equal(np.asarray(g_lab.as_array()), np.asarray(w_lab.as_array()))
    for a, b in zip(_host(w_dec), _host(g_dec)):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(_host(w_res), _host(g_res)):
        assert a.shape == b.shape
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert d.max() <= 1 and (d > 0).mean() <= MAX_FLIP_FRACTION
    w, g = _host(w_out), _host(g_out)
    for a, b in zip(w, g):
        assert a.shape == b.shape == (3, 224, 224) and b.dtype == np.float32
        diff = np.abs(a - b)
        assert diff.max() <= LSB and (diff > 1e-4).mean() <= MAX_FLIP_FRACTION


@pytest.mark.parametrize("recipe", [_rn50_host_decode, _proxy_int16_wire],
                         ids=["rn50_host_decode", "proxy_int16_wire"])
def test_recipes_match_dali_tpu(recipe):
    ref, port = _pair(recipe, batch=8)
    try:
        for _ in range(2):
            _assert_recipe_close(ref.run(), port.run())
    finally:
        _close(ref, port)


def test_host_decode_checkpoint_from_dali_tpu_resumes_in_port():
    """The reader, ImageRandomCrop and coin_flip states of a dali_tpu
    checkpoint continue in the port (op ids and seeds node for node)."""
    ref, port = _pair(_rn50_host_decode, batch=8, enable_checkpointing=True)
    port.shutdown()
    try:
        ref.run()
        ckpt = ref.checkpoint()
        want = ref.run()
    finally:
        ref._executor.shutdown()
    assert json.loads(ckpt)["executor"]["iteration"] == 1

    @dali_tpu_torch.pipeline_def(batch_size=8, num_threads=2, seed=42, device="cpu",
                                 checkpoint=ckpt)
    def p():
        jpegs, labels = dali_tpu_torch.fn.readers.file(file_root=CORPUS, random_shuffle=True,
                                                       name="Reader", seed=1234)
        return (*_rn50_host_decode(dali_tpu_torch, jpegs), labels)

    port = p()
    port.build()
    try:
        _assert_recipe_close(want, port.run())
    finally:
        port.shutdown()


# -- eager ndd decoders ------------------------------------------------------------------------
def _np(b):
    host = b.cpu()
    return [np.asarray(host.at(i)) for i in range(len(host))]


@pytest.mark.parametrize("device", ["cpu", "mixed"])
def test_eager_decoders_match_dali_tpu(device):
    outs = []
    for m, types, ctx in ((ref_ndd, dali_tpu.types, ref_ndd.EvalContext(seed=5)),
                          (ndd, dali_tpu_torch.types, ndd.EvalContext(seed=5, device="cpu"))):
        with ctx:
            jpegs, _ = m.readers.file(file_root=CORPUS, random_shuffle=True, batch_size=4,
                                      name="R", seed=9)
            res = [m.decoders.image(jpegs, device=device),
                   m.decoders.image_random_crop(jpegs, device=device, seed=3),
                   m.decoders.image_crop(jpegs, device=device, crop=(50, 70)),
                   m.decoders.image_slice(jpegs, device=device),
                   m.decoders.image(jpegs, device=device, output_type=types.GRAY)]
            assert all(r.is_gpu == (device == "mixed") for r in res)
            outs.append([_np(r) for r in res])
    for want, got in zip(*outs):
        assert len(want) == len(got)
        for w, g in zip(want, got):
            assert w.shape == g.shape and w.dtype == g.dtype
            np.testing.assert_array_equal(g, w)


# -- the int8 wire on streams its fast decoders decline ----------------------------------------
@pytest.mark.parametrize("rrc", [False, True])
def test_int8_wire_reads_streams_the_fast_decoders_decline(tmp_path, rrc):
    """Progressive grayscale and one-scan-per-component baseline streams: the
    reference reads them through libjpeg, the port through its full read."""
    d = tmp_path / "c"
    d.mkdir()
    for i, f in enumerate(_corpus_files(4)):
        img = cv2.imread(f)
        if rrc:  # one colour sampling per batch
            data = _non_interleaved(cv2.imencode(".jpg", img)[1].tobytes())
        else:
            data = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_BGR2GRAY),
                                [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
        (d / f"{i:02d}.jpg").write_bytes(data)

    def graph(pkg, j):
        if rrc:
            return pkg.fn.decoders.image_random_crop(j, device="mixed", hybrid_device_decode=True,
                                                     hybrid_scale=2, seed=77)
        return pkg.fn.decoders.image(j, device="mixed", hybrid_device_decode=True,
                                     hybrid_scale=2, hybrid_wire="int8")

    _run_pair(graph, root=str(tmp_path))
