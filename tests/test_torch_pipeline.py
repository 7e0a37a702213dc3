"""The image recipes end to end in both packages on the CPU: the rn50_train
pipeline of bench.py at the tools/hybrid_fixture.py shape (64x64 output,
hybrid_scale=2, ImageNet CMN constants, explicit seeds), and at full output
size the ImageNet training recipe of docs/examples/imagenet_training.py
(whole-image decode, RandomResizedCrop 224, implicit seeds) and the RN50
validation recipe (resize_shorter 256, CMN crop 224).

Labels must be equal. Images agree within one uint8 step divided by the
smallest std (0.0176): the decoded uint8 images are equal, and the resize's
uint8 rounding may split a tie differently (fraction bounded here, measured
in PERF.md). The recipes hold the whole-image decode bit-equal, against
dali_tpu with debug=True (its jit fuses multiply-adds into FMAs)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import dali_tpu
import dali_tpu_torch
from dali_tpu_torch.plugin.pytorch import DALIClassificationIterator

CORPUS = os.path.join(os.path.dirname(__file__), "..", "dali_tpu_torch", "testdata", "rn50")
MEAN = [123.675, 116.28, 103.53]
STD = [58.395, 57.12, 57.375]
LSB = 1.0 / min(STD) + 1e-4
MAX_FLIP_FRACTION = 1e-3
BATCH = 8


def _rn50(pkg, **kw):
    fn, types = pkg.fn, pkg.types

    @pkg.pipeline_def(batch_size=BATCH, num_threads=2, seed=42, **kw)
    def rn50_train():
        jpegs, labels = fn.readers.file(file_root=CORPUS, random_shuffle=True, name="Reader",
                                        seed=1234)
        images = fn.decoders.image_random_crop(jpegs, device="mixed", hybrid_device_decode=True,
                                               hybrid_scale=2, seed=77)
        images = fn.resize(images, resize_x=64, resize_y=64)
        mirror = fn.random.coin_flip(probability=0.5, seed=5)
        images = fn.crop_mirror_normalize(images, mirror=mirror, dtype=types.FLOAT,
                                          output_layout="CHW", mean=MEAN, std=STD)
        return images, labels

    pipe = rn50_train()
    pipe.build()
    return pipe


def _assert_close(got, want):
    imgs_g, labels_g = got
    imgs_w, labels_w = want
    np.testing.assert_array_equal(labels_g, labels_w)
    assert imgs_g.shape == imgs_w.shape == (BATCH, 3, 64, 64)
    diff = np.abs(imgs_g - imgs_w)
    assert diff.max() <= LSB
    assert (diff > 1e-4).mean() <= MAX_FLIP_FRACTION


def _ref_out(outs):
    return np.asarray(outs[0].as_tensor()), np.asarray(outs[1].as_array())


def _port_out(outs):
    return outs[0].as_tensor().numpy(), outs[1].as_array()


def test_rn50_two_iterations_match_dali_tpu():
    ref = _rn50(dali_tpu)
    port = _rn50(dali_tpu_torch, device="cpu")
    try:
        for _ in range(2):
            _assert_close(_port_out(port.run()), _ref_out(ref.run()))
    finally:
        ref._executor.shutdown()
        port.shutdown()


def test_checkpoint_from_dali_tpu_resumes_in_port():
    ref = _rn50(dali_tpu, enable_checkpointing=True)
    try:
        ref.run()
        ckpt = ref.checkpoint()
        want = _ref_out(ref.run())
    finally:
        ref._executor.shutdown()
    assert json.loads(ckpt)["executor"]["iteration"] == 1
    port = _rn50(dali_tpu_torch, device="cpu", checkpoint=ckpt)
    try:
        _assert_close(_port_out(port.run()), want)
    finally:
        port.shutdown()


def test_port_checkpoint_round_trip():
    port = _rn50(dali_tpu_torch, device="cpu", enable_checkpointing=True)
    try:
        port.run()
        ckpt = port.checkpoint()
        want = _port_out(port.run())
    finally:
        port.shutdown()
    again = _rn50(dali_tpu_torch, device="cpu", checkpoint=ckpt)
    try:
        got = _port_out(again.run())
    finally:
        again.shutdown()
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def test_classification_iterator_yields_tensors():
    port = _rn50(dali_tpu_torch, device="cpu")
    try:
        it = DALIClassificationIterator(port, reader_name="Reader")
        assert len(it) == 4  # 32 files / batch 8
        batch = next(it)
        assert isinstance(batch, list) and set(batch[0]) == {"data", "label"}
        data, label = batch[0]["data"], batch[0]["label"]
        assert data.dtype == torch.float32 and tuple(data.shape) == (BATCH, 3, 64, 64)
        assert label.dtype == torch.int32 and tuple(label.shape) == (BATCH, 1)
        assert bool(torch.isfinite(data).all())
    finally:
        port.shutdown()


def test_port_never_imports_jax_or_dali_tpu():
    code = (
        "import sys\n"
        "import dali_tpu_torch, dali_tpu_torch.plugin.pytorch, dali_tpu_torch.native.build\n"
        "import dali_tpu_torch.auto_aug\n"
        "import dali_tpu_torch.experimental.dynamic, dali_tpu_torch._multiproc\n"
        "import dali_tpu_torch.external_source, dali_tpu_torch.pickling\n"
        "import dali_tpu_torch.backend.decoders, dali_tpu_torch.backend.image\n"
        "import dali_tpu_torch.kernels.resample, dali_tpu_torch.native, dali_tpu_torch.imgcodec\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'dali_tpu', 'cv2', 'PIL')]\n"
        "assert not bad, bad\n"
    )
    root = os.path.join(os.path.dirname(__file__), "..")
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120)


def _imagenet(pkg, train, batch=BATCH, **kw):
    """imagenet_train (decode at hybrid_scale=2, RandomResizedCrop 224,
    coin-flip mirror) or rn50_val (decode at hybrid_scale=1, resize_shorter
    256 with a triangular filter, CMN crop 224, no mirror). Outputs: CMN
    images, labels, the decoded images, the resized images."""
    fn, types = pkg.fn, pkg.types

    @pkg.pipeline_def(batch_size=batch, num_threads=2, seed=42, **kw)
    def recipe():
        jpegs, labels = fn.readers.file(file_root=CORPUS, random_shuffle=True, name="Reader",
                                        seed=1234)
        images = fn.decoders.image(jpegs, device="mixed", hybrid_device_decode=True,
                                   hybrid_scale=2 if train else 1, hybrid_wire="int8")
        if train:
            resized = fn.random_resized_crop(images, size=[224, 224])
            mirror = fn.random.coin_flip(probability=0.5)
            out = fn.crop_mirror_normalize(resized, mirror=mirror, dtype=types.FLOAT,
                                           output_layout="CHW", mean=MEAN, std=STD)
        else:
            resized = fn.resize(images, resize_shorter=256, interp_type=types.INTERP_TRIANGULAR)
            out = fn.crop_mirror_normalize(resized, crop=(224, 224), dtype=types.FLOAT,
                                           output_layout="CHW", mean=MEAN, std=STD)
        return out, labels, images, resized

    pipe = recipe()
    pipe.build()
    return pipe


def _recipe_out(outs):
    def host(t):
        x = t.as_tensor()
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    return ([host(o) for o in (outs[0], outs[2], outs[3])], np.asarray(outs[1].as_array()),
            [[tuple(int(v) for v in s) for s in o.shape()] for o in (outs[2], outs[3])])


def _assert_recipe_close(got, want):
    (g_img, g_dec, g_res), g_lab, g_shapes = got
    (w_img, w_dec, w_res), w_lab, w_shapes = want
    np.testing.assert_array_equal(g_lab, w_lab)
    assert g_shapes == w_shapes
    assert g_dec.shape == w_dec.shape and g_res.shape == w_res.shape
    for i, (h, w, _) in enumerate(g_shapes[0]):
        np.testing.assert_array_equal(g_dec[i, :h, :w], w_dec[i, :h, :w])
    d = np.abs(g_res.astype(np.int16) - w_res.astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() <= MAX_FLIP_FRACTION
    assert g_img.shape == w_img.shape == (BATCH, 3, 224, 224)
    diff = np.abs(g_img - w_img)
    assert diff.max() <= LSB
    assert (diff > 1e-4).mean() <= MAX_FLIP_FRACTION


@pytest.mark.parametrize("recipe", ["imagenet_train", "rn50_val"])
def test_imagenet_recipes_two_iterations_match_dali_tpu(recipe):
    train = recipe == "imagenet_train"
    ref = _imagenet(dali_tpu, train, debug=True)
    port = _imagenet(dali_tpu_torch, train, device="cpu")
    try:
        for _ in range(2):
            _assert_recipe_close(_recipe_out(port.run()), _recipe_out(ref.run()))
    finally:
        ref._executor.shutdown()
        port.shutdown()


def test_imagenet_checkpoint_from_dali_tpu_resumes_in_port():
    """The reader, RandomResizedCrop and coin_flip states of a dali_tpu
    checkpoint continue in the port: implicit seeds key on op ids, so the
    port's graph must be the reference's node for node."""
    ref = _imagenet(dali_tpu, True, debug=True, enable_checkpointing=True)
    try:
        ref.run()
        ckpt = ref.checkpoint()
        want = _recipe_out(ref.run())
    finally:
        ref._executor.shutdown()
    assert json.loads(ckpt)["executor"]["iteration"] == 1
    port = _imagenet(dali_tpu_torch, True, device="cpu", checkpoint=ckpt)
    try:
        _assert_recipe_close(_recipe_out(port.run()), want)
    finally:
        port.shutdown()


def test_unported_names_raise_not_implemented():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dali_tpu_torch.fn.decoders.inflate
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dali_tpu_torch.fn.water
    gif = np.frombuffer(b"GIF89a" + bytes(26), np.uint8)

    @dali_tpu_torch.pipeline_def(batch_size=2, device="cpu")
    def p():
        enc = dali_tpu_torch.fn.external_source(source=lambda: [gif, gif])
        return dali_tpu_torch.fn.decoders.image_random_crop(enc, device="mixed")

    pipe = p()
    pipe.build()
    try:
        with pytest.raises(NotImplementedError, match=r"ROADMAP.md, Queue 1 items 1c-1e"):
            pipe.run()
    finally:
        pipe.shutdown()


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dali_tpu_torch.Pipeline(batch_size=2)


def test_shutdown_with_full_queues_stops_threads():
    """Both bounded queues full and the host stage blocked in put(): shutdown
    still stops every thread and releases the decoder's task pool."""
    port = _rn50(dali_tpu_torch, device="cpu", prefetch_queue_depth=1)
    for _ in range(4):
        port.schedule_run()
    ex = port.executor
    threads = list(ex._threads)
    port.shutdown()
    assert threads and not any(t.is_alive() for t in threads)
    assert all(getattr(impl, "_pool", None) is None for impl in ex.impls.values())


@pytest.mark.parametrize("policy,n_batches,last", [("FILL", 3, 12), ("DROP", 2, 12),
                                                   ("PARTIAL", 3, 8)])
def test_last_batch_policy_epoch(policy, n_batches, last):
    """32 files at batch 12: the reference's epoch accounting
    (base_iterator.py) per LastBatchPolicy, over two epochs with auto_reset."""
    from dali_tpu_torch.plugin.pytorch import LastBatchPolicy

    @dali_tpu_torch.pipeline_def(batch_size=12, num_threads=2, seed=3, device="cpu")
    def p():
        jpegs, labels = dali_tpu_torch.fn.readers.file(file_root=CORPUS, name="Reader")
        img = dali_tpu_torch.fn.decoders.image_random_crop(
            jpegs, device="mixed", hybrid_device_decode=True, hybrid_scale=4)
        return dali_tpu_torch.fn.resize(img, resize_x=8, resize_y=8), labels

    pipe = p()
    try:
        it = DALIClassificationIterator(pipe, reader_name="Reader", auto_reset=True,
                                        last_batch_policy=LastBatchPolicy[policy])
        assert len(it) == n_batches
        for _ in range(2):
            sizes = [b[0]["data"].shape[0] for b in it]
            assert sizes == [12] * (n_batches - 1) + [last]
    finally:
        pipe.shutdown()


def test_file_reader_mapped_reads_equal_plain_reads():
    """readers.File maps each file per read (no cache); the bytes equal
    those of plain reads (``dont_use_mmap``), batch after batch."""
    got = {}
    for mmap_off in (False, True):
        @dali_tpu_torch.pipeline_def(batch_size=BATCH, num_threads=1, seed=3, device="cpu")
        def p():
            return dali_tpu_torch.fn.readers.file(file_root=CORPUS, random_shuffle=True,
                                                  dont_use_mmap=mmap_off, name="Reader")

        pipe = p()
        pipe.build()
        try:
            got[mmap_off] = [pipe.run() for _ in range(3)]
        finally:
            pipe.shutdown()
    for (a, la), (b, lb) in zip(got[False], got[True]):
        np.testing.assert_array_equal(la.as_array(), lb.as_array())
        for i in range(BATCH):
            np.testing.assert_array_equal(a.at(i), b.at(i))


def test_file_reader_reads_more_files_than_the_descriptor_limit(tmp_path):
    """An epoch over more files than the process may hold open (a soft
    descriptor limit of 1024, the common default): a mapping lives only as
    long as its sample, so the rest of the process can still open files
    (an unbounded cache of mappings held one descriptor per file read)."""
    for i in range(1100):
        (tmp_path / f"f{i:04d}.bin").write_bytes(bytes([i % 256]) * 16)
    code = (
        "import resource, sys, numpy as np\n"
        "resource.setrlimit(resource.RLIMIT_NOFILE, (1024, resource.getrlimit("
        "resource.RLIMIT_NOFILE)[1]))\n"
        "import dali_tpu_torch as d\n"
        f"files = [r'{tmp_path}/f%04d.bin' % i for i in range(1100)]\n"
        "@d.pipeline_def(batch_size=100, num_threads=1, seed=1, device='cpu')\n"
        "def p():\n"
        "    return d.fn.readers.file(files=files)[0]\n"
        "pipe = p(); pipe.build()\n"
        "for it in range(11):\n"
        "    out = pipe.run()[0]\n"
        "    assert all(int(out.at(i)[0]) == (it * 100 + i) % 256 for i in range(100))\n"
        "extra = [open(files[0], 'rb') for _ in range(64)]\n"
        "for f in extra:\n"
        "    f.close()\n"
        "pipe.shutdown(); print('read', 1100)\n")
    root = os.path.join(os.path.dirname(__file__), "..")
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and "read 1100" in r.stdout, r.stderr[-2000:]
