"""Automatic augmentation in dali_tpu_torch against dali_tpu, on the CPU:
each augmentation at three magnitude bins, TrivialAugment Wide, AutoAugment
(ImageNet policy) and RandAugment, the graph identity that makes their random
draws equal, the EfficientNet training recipe from the committed corpus, and
a checkpoint taken in dali_tpu and resumed in the port.

The same seeded batches go through both packages. dali_tpu's device ops run
op by op (``debug=True``), as the port's do: under ``jit``, XLA contracts
``a * f + b * g`` across fused ops into fused multiply-adds, which moves the
truncating uint8 cast of ``sharpness`` by one step on about 1e-2 of its
values (``test_trivial_augment_against_jit``). Tolerances:

* quantised augmentations (identity, invert, posterize, equalize): bit-equal;
* the other augmentations and ``trivial_augment_wide``: within one uint8
  step on at most 1e-4 of values;
* chained policies (``auto_augment_image_net``, ``rand_augment``): at least
  99.9% of values bit-equal (a one-step tie upstream can move a later
  posterize or equalize by more than one step);
* the whole recipe, CMN output: within one uint8 step / std on at most 1e-3
  of values (TrivialAugment), at least 99.9% of values within 1e-4
  (AutoAugment)."""

import json
import os

import numpy as np
import pytest

import dali_tpu
import dali_tpu.auto_aug
import dali_tpu_torch
import dali_tpu_torch.auto_aug

CORPUS = os.path.join(os.path.dirname(__file__), "..", "dali_tpu_torch", "testdata", "rn50")
MEAN = [123.675, 116.28, 103.53]
STD = [58.395, 57.12, 57.375]
LSB = 1.0 / min(STD) + 1e-4
N = 8
DATA = np.random.default_rng(17).integers(0, 256, (N, 64, 64, 3)).astype(np.uint8)
NAMES = ["shear_x", "shear_y", "translate_x_no_shape", "translate_y_no_shape", "rotate",
         "brightness", "contrast", "color", "sharpness", "posterize", "solarize",
         "solarize_add", "invert", "equalize", "auto_contrast", "identity"]
QUANTISED = {"identity", "invert", "posterize", "equalize"}
POLICIES = {
    "trivial_augment_wide": lambda aa, x: aa.trivial_augment_wide(x),
    "auto_augment_image_net": lambda aa, x: aa.auto_augment_image_net(x),
    "rand_augment": lambda aa, x: aa.rand_augment(x, n=2, m=9),
}


def _pipes(build, n=N, ref_kw=None, **extra):
    pipes = []
    for pkg, kw in ((dali_tpu_torch, {"device": "cpu"}),
                    (dali_tpu, {"debug": True} if ref_kw is None else ref_kw)):
        @pkg.pipeline_def(batch_size=n, num_threads=2, seed=42, enable_conditionals=True,
                          **kw, **extra)
        def p():
            outs = build(pkg)
            return outs if isinstance(outs, tuple) else (outs,)

        pipe = p()
        pipe.build()
        pipes.append(pipe)
    return pipes


def _close(pipes):
    pipes[0].shutdown()
    pipes[1]._executor.shutdown()


def _arrays(outs, port):
    return [o.as_tensor().numpy() if port and type(o).__name__ == "TensorListGPU"
            else np.asarray(o.as_tensor()) if type(o).__name__ == "TensorListGPU"
            else o.as_array() for o in outs]


def _run(build, iters=1, **kw):
    pipes = _pipes(build, **kw)
    try:
        return [(_arrays(pipes[0].run(), True), _arrays(pipes[1].run(), False))
                for _ in range(iters)]
    finally:
        _close(pipes)


def _src(pkg):
    return pkg.fn.external_source(source=lambda: DATA, batch=True, layout="HWC").gpu()


def _diff(g, w):
    assert g.dtype == w.dtype and g.shape == w.shape
    return np.abs(g.astype(np.int64) - w.astype(np.int64))


@pytest.mark.parametrize("name", NAMES)
def test_augmentation_matches_dali_tpu(name):
    bins = [0, 5, 10]

    def build(pkg):
        aug = getattr(pkg.auto_aug.augmentations, name)
        x = _src(pkg)
        return tuple(aug(x, magnitude_bin=b, num_magnitude_bins=11) for b in bins)

    (got, want), = _run(build)
    for b, g, w in zip(bins, got, want):
        d = _diff(g, w)
        if name in QUANTISED:
            assert d.max() == 0, f"{name} bin {b}"
        else:
            assert d.max() <= 1 and (d > 0).mean() <= 1e-4, f"{name} bin {b}"


def test_augmentation_outputs_are_contiguous():
    """The card's CMN kernel takes contiguous batches: every augmentation
    hands one on."""
    @dali_tpu_torch.pipeline_def(batch_size=N, num_threads=1, seed=42, device="cpu")
    def p():
        x = _src(dali_tpu_torch)
        return tuple(getattr(dali_tpu_torch.auto_aug.augmentations, nm)(
            x, magnitude_bin=5, num_magnitude_bins=11) for nm in NAMES)

    pipe = p()
    try:
        for nm, out in zip(NAMES, pipe.run()):
            assert out.as_tensor().is_contiguous(), nm
    finally:
        pipe.shutdown()


@pytest.mark.parametrize("policy", list(POLICIES))
def test_policy_matches_dali_tpu(policy):
    runs = _run(lambda pkg: POLICIES[policy](pkg.auto_aug, _src(pkg)), iters=2)
    for got, want in runs:
        d = _diff(got[0], want[0])
        if policy == "trivial_augment_wide":
            assert d.max() <= 1 and (d > 0).mean() <= 1e-4
        else:
            assert (d == 0).mean() >= 0.999


def test_trivial_augment_against_jit():
    """Against dali_tpu's jitted device program: its fused multiply-adds
    round sharpness differently (measured: one step on 5.3e-4 of values)."""
    runs = _run(lambda pkg: POLICIES["trivial_augment_wide"](pkg.auto_aug, _src(pkg)),
                iters=2, ref_kw={})
    for got, want in runs:
        d = _diff(got[0], want[0])
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3


@pytest.mark.parametrize("policy", list(POLICIES))
def test_graph_identity(policy):
    """Implicit-seed random streams are keyed by op id, so both packages
    must create the same operators in the same order."""
    pipes = _pipes(lambda pkg: POLICIES[policy](pkg.auto_aug, _src(pkg)))
    try:
        seqs = [[(n.spec.schema_name, n.device, n.id) for n in p._graph.ops] for p in pipes]
    finally:
        _close(pipes)
    assert seqs[0] == seqs[1]
    assert len(seqs[0]) > 100


def test_shape_relative_translates_not_ported():
    """The shape-relative translates are ported now: ``shape=`` builds a
    graph that reads each image's shape on the device and runs (held
    against dali_tpu in ``tests/test_torch_shape_ops.py``)."""
    @dali_tpu_torch.pipeline_def(batch_size=N, device="cpu", enable_conditionals=True)
    def p():
        return dali_tpu_torch.auto_aug.trivial_augment_wide(_src(dali_tpu_torch), shape=[64, 64])

    pipe = p()
    pipe.build()
    try:
        ops = {(n.spec.schema_name, n.device) for n in pipe._graph.ops}
        assert {("Shapes", "gpu"), ("_TensorSubscript", "gpu")} <= ops
        assert tuple(pipe.run()[0].as_tensor().shape) == (N, 64, 64, 3)
    finally:
        pipe.shutdown()


def _recipe(pkg, policy, batch=4, out=64, **kw):
    fn, types = pkg.fn, pkg.types

    @pkg.pipeline_def(batch_size=batch, num_threads=2, seed=42, enable_conditionals=True, **kw)
    def effnet_train():
        jpegs, labels = fn.readers.file(file_root=CORPUS, random_shuffle=True, name="Reader",
                                        seed=1234)
        images = fn.decoders.image_random_crop(jpegs, device="mixed", hybrid_device_decode=True,
                                               hybrid_scale=2, seed=77)
        images = fn.resize(images, resize_x=out, resize_y=out)
        images = POLICIES[policy](pkg.auto_aug, images)
        mirror = fn.random.coin_flip(probability=0.5, seed=5)
        images = fn.crop_mirror_normalize(images, mirror=mirror, dtype=types.FLOAT,
                                          output_layout="CHW", mean=MEAN, std=STD)
        return images, labels

    pipe = effnet_train()
    pipe.build()
    return pipe


def _recipe_close(got, want, policy):
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].shape == want[0].shape == (4, 3, 64, 64)
    d = np.abs(got[0] - want[0])
    if policy == "trivial_augment_wide":
        assert d.max() <= LSB and (d > 1e-4).mean() <= 1e-3
    else:
        assert (d <= 1e-4).mean() >= 0.999


@pytest.mark.parametrize("policy", ["trivial_augment_wide", "auto_augment_image_net"])
def test_recipe_from_corpus_matches_dali_tpu(policy):
    ref = _recipe(dali_tpu, policy, debug=True)
    port = _recipe(dali_tpu_torch, policy, device="cpu")
    try:
        for _ in range(2):
            got, want = _arrays(port.run(), True), _arrays(ref.run(), False)
            _recipe_close(got, want, policy)
    finally:
        _close([port, ref])


def test_checkpoint_from_dali_tpu_resumes_trivial_augment_in_port():
    ref = _recipe(dali_tpu, "trivial_augment_wide", debug=True, enable_checkpointing=True)
    try:
        ref.run()
        ref.run()
        ckpt = ref.checkpoint()
        want = _arrays(ref.run(), False)
    finally:
        ref._executor.shutdown()
    assert json.loads(ckpt)["executor"]["iteration"] == 2
    port = _recipe(dali_tpu_torch, "trivial_augment_wide", device="cpu", checkpoint=ckpt)
    try:
        _recipe_close(_arrays(port.run(), True), want, "trivial_augment_wide")
    finally:
        port.shutdown()
