"""The shape, tensor, value and reduction operators of dali_tpu_torch against
dali_tpu, on the CPU: Shapes, CastLike, ExpandDims, Squeeze, OneHot, the
subscript of ``DataNode.__getitem__``, Reshape, Slice, Crop, Stack, Cat,
PermuteBatch, GetProperty, Paste, the Zeros/Ones/Full family, the eight
reductions and Reinterpret.

The same seeded batches (ragged and uniform HWC uint8, ragged float32, DHWC
volumes) go through ``fn.external_source`` into both packages: the cpu
placement against dali_tpu's cpu operator, the gpu placement against
dali_tpu's gpu lowering run op by op (``debug=True``). Shape, integer and
copy ops are bit-equal, with equal per-sample shapes and layouts; float
reductions agree within 1e-5 relative. ``Shapes`` on the device gives the
schema's int64 where the reference's device program, without JAX's 64-bit
mode, gives int32: the values are equal.

Also here: the translates relative to the image shape in all three
automatic augmentation policies, against dali_tpu with ``debug=True`` and
two test-time patches that let the reference run them on device data (see
``reference_translates_on_device``), and the device placements of
``docs/examples/transforms_3d.py``'s crop.
"""

import numpy as np
import pytest

import dali_tpu
import dali_tpu.auto_aug
import dali_tpu_torch
import dali_tpu_torch.auto_aug

N = 5
RNG = np.random.default_rng(71)
RAGGED = [RNG.integers(0, 256, (20 + 4 * i, 30 - 3 * i, 3)).astype(np.uint8) for i in range(N)]
UNIFORM = RNG.integers(0, 256, (N, 24, 28, 3)).astype(np.uint8)
FLOATS = [RNG.standard_normal((9 + i, 7 + 2 * i, 1)).astype(np.float32) for i in range(N)]
FLOAT_UNIFORM = (RNG.standard_normal((N, 12, 10, 3)) * 4 + 1).astype(np.float32)
VOLUME = RNG.integers(0, 256, (N, 10, 14, 16, 1)).astype(np.uint8)
LABELS = RNG.integers(0, 6, (N, 1)).astype(np.int32)
INDEX_MAPS = [RNG.integers(0, 4, (3, 2 + i)).astype(np.int32) for i in range(N)]
PER_SAMPLE_INT = np.array([[1], [-2], [3], [0], [-1]], np.int32)
REL_STARTS = RNG.uniform(0.0, 0.4, (N, 2)).astype(np.float32)
CROP_SIZES = np.array([[10.0], [12.0], [16.0], [8.0], [14.0]], np.float32)
PERM = [4, 2, 0, 1, 3]

INPUTS = {"ragged": (RAGGED, "HWC"), "uniform": (UNIFORM, "HWC"), "float": (FLOATS, "HWC"),
          "float_uniform": (FLOAT_UNIFORM, "HWC"), "volume": (VOLUME, "DHWC"),
          "labels": (LABELS, ""), "index_maps": (INDEX_MAPS, "")}


def _source(fn, data, layout=""):
    return fn.external_source(source=lambda: data, batch=True, layout=layout)


def _run(build, data, layout, device, n=N):
    """The same graph in both packages, the input on ``device``; returns
    (port, reference) as (per-output lists of per-sample arrays, layouts)."""
    res = []
    for pkg, kw in ((dali_tpu_torch, {"device": "cpu"}), (dali_tpu, {"debug": True})):
        @pkg.pipeline_def(batch_size=n, num_threads=1, seed=11, **kw)
        def p():
            x = _source(pkg.fn, data, layout)
            outs = build(pkg.fn, x.gpu() if device == "gpu" else x, pkg.types)
            return outs if isinstance(outs, tuple) else (outs,)

        pipe = p()
        pipe.build()
        try:
            outs = pipe.run()
        finally:
            (pipe.shutdown if pkg is dali_tpu_torch else pipe._executor.shutdown)()
        res.append(([_samples(tl) for tl in outs], [tl.layout() for tl in outs]))
    return res


def _samples(tl):
    if hasattr(tl, "as_cpu"):
        tl = tl.as_cpu()
    return [np.asarray(tl.at(i)) for i in range(len(tl))]


def _exact(got, want, dtype_equal=True):
    (g_outs, g_lay), (w_outs, w_lay) = got, want
    assert g_lay == w_lay
    for g_out, w_out in zip(g_outs, w_outs):
        assert len(g_out) == len(w_out)
        for g, w in zip(g_out, w_out):
            assert g.shape == w.shape
            if dtype_equal:
                assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _close(got, want, rtol=1e-5):
    (g_outs, g_lay), (w_outs, w_lay) = got, want
    assert g_lay == w_lay
    for g_out, w_out in zip(g_outs, w_outs):
        for g, w in zip(g_out, w_out):
            assert g.dtype == w.dtype and g.shape == w.shape
            atol = rtol * max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


# name: (graph, inputs, devices); each runs at every (input, device) pair
CASES = {
    "shapes_int32": (lambda fn, x, t: fn.shapes(x, dtype=t.INT32),
                     ("ragged", "uniform", "volume"), ("cpu", "gpu")),
    "shape_method": (lambda fn, x, t: x.shape(dtype=t.INT32), ("ragged",), ("cpu", "gpu")),
    "cast_like": (lambda fn, x, t: fn.cast_like(x, _source(fn, FLOAT_UNIFORM) if x.device == "cpu"
                                                else _source(fn, FLOAT_UNIFORM).gpu()),
                  ("uniform",), ("cpu", "gpu")),
    "expand_dims": (lambda fn, x, t: fn.expand_dims(x, axes=[0, 2], new_axis_names="FZ"),
                    ("ragged", "uniform"), ("cpu", "gpu")),
    "expand_dims_no_names": (lambda fn, x, t: fn.expand_dims(x, axes=[3]), ("ragged",),
                             ("cpu", "gpu")),
    "squeeze_axes": (lambda fn, x, t: fn.squeeze(x, axes=[2]), ("float",), ("cpu", "gpu")),
    "squeeze_names": (lambda fn, x, t: fn.squeeze(
        fn.expand_dims(x, axes=[0], new_axis_names="F"), axis_names="F"), ("ragged", "uniform"),
        ("cpu", "gpu")),
    "one_hot": (lambda fn, x, t: fn.one_hot(x, num_classes=6), ("labels",), ("cpu", "gpu")),
    "one_hot_values": (lambda fn, x, t: fn.one_hot(x, num_classes=6, on_value=7.0,
                                                   off_value=-1.0, dtype=t.INT32,
                                                   axis_name="K"),
                       ("labels",), ("cpu", "gpu")),
    "one_hot_maps": (lambda fn, x, t: fn.one_hot(x, num_classes=4), ("index_maps",), ("cpu",)),
    "subscript_index": (lambda fn, x, t: x[1], ("ragged", "uniform"), ("cpu", "gpu")),
    "subscript_negative": (lambda fn, x, t: x[-1, 2:-3], ("ragged", "uniform"), ("cpu", "gpu")),
    "subscript_ranges": (lambda fn, x, t: x[3:15, :9, 0], ("ragged", "float"), ("cpu", "gpu")),
    "subscript_datanode": (lambda fn, x, t: x[_source(fn, PER_SAMPLE_INT):, 2],
                           ("ragged", "uniform"), ("cpu", "gpu")),
    "subscript_datanode_index": (lambda fn, x, t: x[:, _source(fn, PER_SAMPLE_INT)],
                                 ("ragged",), ("cpu", "gpu")),
    "reshape_static": (lambda fn, x, t: fn.reshape(x, shape=[-1, 3], layout="NC"),
                       ("uniform",), ("cpu", "gpu")),
    "reshape_layout_only": (lambda fn, x, t: fn.reshape(x, layout="YXC"), ("uniform",),
                            ("cpu", "gpu")),
    "reshape_layout_only_ragged": (lambda fn, x, t: fn.reshape(x, layout="YXC"), ("ragged",),
                                   ("cpu",)),
    "slice_rel": (lambda fn, x, t: fn.slice(x, rel_start=[0.25, 0.1], rel_shape=[0.5, 0.6],
                                            axis_names="HW"), ("ragged", "uniform"),
                  ("cpu", "gpu")),
    "slice_abs_axes": (lambda fn, x, t: fn.slice(x, start=[2, 1], shape=[6, 5], axes=[0, 1]),
                       ("ragged", "float"), ("cpu", "gpu")),
    "slice_end_default_axes": (lambda fn, x, t: fn.slice(x, start=[1, 2], end=[12, 9]),
                               ("ragged",), ("cpu", "gpu")),
    "slice_pad": (lambda fn, x, t: fn.slice(x, start=[-3, 5], shape=[30, 40], axis_names="HW",
                                            out_of_bounds_policy="pad", fill_values=[9.0]),
                  ("ragged", "uniform"), ("cpu", "gpu")),
    "slice_trim": (lambda fn, x, t: fn.slice(x, start=[10, 10], shape=[30, 40], axis_names="HW",
                                             out_of_bounds_policy="trim_to_shape"),
                   ("ragged",), ("cpu", "gpu")),
    "slice_tensor_start": (lambda fn, x, t: fn.slice(
        x, rel_start=_source(fn, REL_STARTS), shape=[8, 8], axis_names="HW", dtype=t.INT16),
        ("ragged", "uniform"), ("cpu", "gpu")),
    "slice_volume": (lambda fn, x, t: fn.slice(x, start=[2, 3, 4], shape=[5, 6, 7],
                                               axis_names="DHW"), ("volume",), ("cpu", "gpu")),
    "slice_positional": (lambda fn, x, t: fn.slice(
        x, _source(fn, np.full((N, 2), 0.25, np.float32)),
        _source(fn, np.full((N, 2), 0.5, np.float32)), axes=[0, 1]), ("ragged",), ("cpu",)),
    "crop": (lambda fn, x, t: fn.crop(x, crop=(8, 10)), ("ragged", "uniform"), ("cpu", "gpu")),
    "crop_pos": (lambda fn, x, t: fn.crop(x, crop_h=9, crop_w=7, crop_pos_x=0.2,
                                          crop_pos_y=0.9, rounding="truncate", dtype=t.FLOAT),
                 ("ragged", "uniform"), ("cpu", "gpu")),
    "crop_pos_tensor": (lambda fn, x, t: fn.crop(
        x, crop=(6, 6), crop_pos_x=_source(fn, REL_STARTS[:, :1] * 2),
        crop_pos_y=_source(fn, REL_STARTS[:, 1:])), ("ragged",), ("cpu", "gpu")),
    "crop_tensor_sizes": (lambda fn, x, t: fn.crop(
        x, crop_h=_source(fn, CROP_SIZES), crop_w=_source(fn, CROP_SIZES + 2)),
        ("ragged", "uniform"), ("cpu", "gpu")),
    "crop_volume": (lambda fn, x, t: fn.crop(x, crop_d=6, crop_h=8, crop_w=9, crop_pos_z=0.3),
                    ("volume",), ("cpu", "gpu")),
    "crop_pad": (lambda fn, x, t: fn.crop(x, crop=(40, 40), out_of_bounds_policy="pad"),
                 ("ragged",), ("cpu",)),
    "stack": (lambda fn, x, t: fn.stack(x, x, axis=0), ("ragged", "uniform"), ("cpu", "gpu")),
    "stack_named": (lambda fn, x, t: fn.stack(x, x, x, axis=-1, axis_name="K"),
                    ("uniform", "float"), ("cpu", "gpu")),
    "cat": (lambda fn, x, t: fn.cat(x, x, axis=1), ("ragged", "uniform"), ("cpu", "gpu")),
    "cat_named": (lambda fn, x, t: fn.cat(x, x, x, axis_name="W"), ("ragged", "uniform"),
                  ("cpu", "gpu")),
    "permute_batch": (lambda fn, x, t: fn.permute_batch(x, indices=PERM), ("ragged", "uniform"),
                      ("cpu", "gpu")),
    "permute_batch_tensor": (lambda fn, x, t: fn.permute_batch(
        x, indices=_source(fn, np.array(PERM, np.int32)[:, None])), ("ragged",), ("cpu", "gpu")),
    "get_property_layout": (lambda fn, x, t: fn.get_property(x, key="layout"), ("ragged",),
                            ("cpu",)),
    "paste": (lambda fn, x, t: fn.paste(x, ratio=1.5, paste_x=0.25, paste_y=0.75,
                                        fill_value=[10.0, 20.0, 30.0]), ("ragged", "uniform"),
              ("gpu",)),
    "paste_min_canvas": (lambda fn, x, t: fn.paste(x, ratio=1.0, min_canvas_size=40.0),
                         ("ragged",), ("gpu",)),
    "zeros_like": (lambda fn, x, t: fn.zeros_like(x), ("ragged", "uniform"), ("cpu", "gpu")),
    "ones_like": (lambda fn, x, t: fn.ones_like(x, dtype=t.FLOAT), ("uniform",), ("cpu", "gpu")),
    "full_like": (lambda fn, x, t: fn.full_like(x, fill_value=[1.0, 2.0, 3.0]),
                  ("uniform",), ("cpu", "gpu")),
    "full_like_tensor": (lambda fn, x, t: fn.full_like(
        x, fill_value=_source(fn, np.arange(N, dtype=np.float32)[:, None])), ("uniform",),
        ("cpu", "gpu")),
    "reinterpret_int32": (lambda fn, x, t: fn.reinterpret(x, dtype=t.INT32),
                          ("float", "float_uniform"), ("cpu", "gpu")),
    "reinterpret_narrow": (lambda fn, x, t: fn.reinterpret(x, dtype=t.UINT8), ("float",),
                           ("cpu", "gpu")),
    "reinterpret_shape": (lambda fn, x, t: fn.reinterpret(x, shape=[-1], layout="X"),
                          ("uniform",), ("cpu", "gpu")),
    "reinterpret_widen": (lambda fn, x, t: fn.reinterpret(fn.reshape(x, shape=[24, 84]),
                                                          dtype=t.INT16),
                          ("uniform",), ("cpu", "gpu")),
}


@pytest.mark.parametrize("name,inp,device", [(k, i, d) for k, (_, ins, devs) in CASES.items()
                                             for i in ins for d in devs])
def test_shape_and_tensor_ops_bit_equal(name, inp, device):
    data, layout = INPUTS[inp]
    _exact(*_run(CASES[name][0], data, layout, device))


@pytest.mark.parametrize("device", ["cpu", "gpu"])
def test_shapes_default_dtype(device):
    """Default INT64: the cpu ops are bit-equal; on the device the port keeps
    int64 where the reference's device program holds int32."""
    got, want = _run(lambda fn, x, t: fn.shapes(x), RAGGED, "HWC", device)
    assert all(g.dtype == np.int64 for g in got[0][0])
    _exact(got, want, dtype_equal=device == "cpu")


# value ops with no input: their batch size is the iteration's
VALUE_CASES = {
    "zeros": lambda fn, t, d: fn.zeros(shape=[2, 3], device=d),
    "ones": lambda fn, t, d: fn.ones(shape=[4], dtype=t.UINT8, device=d),
    "full": lambda fn, t, d: fn.full(fill_value=[2.5], shape=[3, 2], device=d),
    "full_vector": lambda fn, t, d: fn.full(fill_value=[1.0, 2.0, 3.0], shape=[2, 3], device=d),
    "full_tensor": lambda fn, t, d: fn.full(
        fill_value=_source(fn, np.arange(N, dtype=np.float32)[:, None]), shape=[2], device=d),
}


@pytest.mark.parametrize("device", ["cpu", "gpu"])
@pytest.mark.parametrize("name", list(VALUE_CASES))
def test_value_ops_bit_equal(name, device):
    _exact(*_run(lambda fn, x, t: (VALUE_CASES[name](fn, t, device), x), LABELS, "", "cpu"))


def test_get_property_source_info():
    """``source_info`` of a file reader's samples."""
    import os

    corpus = os.path.join(os.path.dirname(__file__), "..", "dali_tpu_torch", "testdata", "rn50")
    res = []
    for pkg, kw in ((dali_tpu_torch, {"device": "cpu"}), (dali_tpu, {})):
        @pkg.pipeline_def(batch_size=4, num_threads=1, seed=3, **kw)
        def p():
            jpegs, _ = pkg.fn.readers.file(file_root=corpus, random_shuffle=True, seed=5)
            return pkg.fn.get_property(jpegs, key="source_info")

        pipe = p()
        pipe.build()
        try:
            res.append(_samples(pipe.run()[0]))
        finally:
            (pipe.shutdown if pkg is dali_tpu_torch else pipe._executor.shutdown)()
    for g, w in zip(*res):
        np.testing.assert_array_equal(g, w)
        assert bytes(g).decode().endswith(".jpg")


REDUCTIONS = ["sum", "mean", "max", "min", "mean_square", "root_mean_square", "std_dev",
              "variance"]
REDUCE_ARGS = {"all": {}, "axes": {"axes": [0, 1]}, "names_keep": {"axis_names": "HW",
                                                                   "keep_dims": True},
               "w": {"axes": [1]}}


@pytest.mark.parametrize("args", list(REDUCE_ARGS))
@pytest.mark.parametrize("kind", REDUCTIONS)
@pytest.mark.parametrize("inp,device", [("float", "cpu"), ("ragged", "cpu"),
                                        ("float_uniform", "cpu"), ("float_uniform", "gpu"),
                                        ("uniform", "gpu")])
def test_reductions_within_tolerance(kind, args, inp, device):
    data, layout = INPUTS[inp]
    _close(*_run(lambda fn, x, t: getattr(fn.reductions, kind)(x, **REDUCE_ARGS[args]),
                 data, layout, device))


@pytest.mark.parametrize("device", ["cpu", "gpu"])
def test_reduction_output_dtype(device):
    _exact(*_run(lambda fn, x, t: (fn.reductions.max(x, axes=[2], dtype=t.INT16),
                                   fn.reductions.min(x, axis_names="W", dtype=t.INT32)),
                 UNIFORM, "HWC", device))


@pytest.mark.parametrize("kind", ["std_dev", "variance"])
@pytest.mark.parametrize("ddof", [0, 1])
@pytest.mark.parametrize("keep_mean", [True, False])
@pytest.mark.parametrize("inp,device", [("float", "cpu"), ("float_uniform", "cpu"),
                                        ("float_uniform", "gpu")])
def test_std_dev_variance_with_mean_input(kind, ddof, keep_mean, inp, device):
    data, layout = INPUTS[inp]

    def build(fn, x, t):
        mean = fn.reductions.mean(x, axis_names="HW", keep_dims=keep_mean)
        return (getattr(fn.reductions, kind)(x, mean, axis_names="HW", ddof=ddof),
                getattr(fn.reductions, kind)(x, axes=[0], ddof=ddof, keep_dims=True))

    _close(*_run(build, data, layout, device))


def test_legacy_rms_alias_matches_root_mean_square():
    got, want = _run(lambda fn, x, t: (fn.reductions.rms(x), fn.reductions.root_mean_square(x)),
                     FLOAT_UNIFORM, "HWC", "gpu")
    _close(got, want)
    np.testing.assert_array_equal(got[0][0][0], got[0][1][0])


def test_gpu_reductions_on_ragged_batches_raise():
    """As in the reference, the device reductions take uniform batches."""
    @dali_tpu_torch.pipeline_def(batch_size=N, num_threads=1, seed=1, device="cpu")
    def p():
        return dali_tpu_torch.fn.reductions.sum(_source(dali_tpu_torch.fn, RAGGED, "HWC").gpu())

    pipe = p()
    pipe.build()
    try:
        with pytest.raises(NotImplementedError, match="uniform batches"):
            pipe.run()
    finally:
        pipe.shutdown()


def test_reshape_per_sample_tensor_shape_on_device():
    """A per-sample ``shape`` (a cpu tensor argument) reshapes each sample of
    a ragged device batch onto a grow-only canvas."""
    shapes = np.array([[s.shape[0] * s.shape[1], 3] for s in RAGGED], np.float32)
    _exact(*_run(lambda fn, x, t: fn.reshape(x, shape=_source(fn, shapes)), RAGGED, "HWC", "gpu"))


@pytest.mark.parametrize("subscript", [(Ellipsis,), (slice(0, 4, 2),), (None,)],
                         ids=["ellipsis", "strided", "newaxis"])
def test_unsupported_subscripts_raise_as_the_reference(subscript):
    for pkg in (dali_tpu_torch, dali_tpu):
        kw = {"device": "cpu"} if pkg is dali_tpu_torch else {}
        pipe = pkg.Pipeline(batch_size=2, **kw)
        with pipe:
            x = _source(pkg.fn, RAGGED[:2], "HWC")
            with pytest.raises(NotImplementedError, match="not supported yet"):
                x[subscript]


def test_data_node_property_raises_as_the_reference():
    for pkg in (dali_tpu_torch, dali_tpu):
        kw = {"device": "cpu"} if pkg is dali_tpu_torch else {}
        with pkg.Pipeline(batch_size=2, **kw):
            x = _source(pkg.fn, RAGGED[:2], "HWC")
            with pytest.raises(NotImplementedError, match="get_property"):
                x.property


# ------------------------------------------------ the shape-relative translates


@pytest.fixture
def reference_translates_on_device(monkeypatch):
    """Two reference faults keep dali_tpu from running a shape-relative
    translate on device data: the code that builds its matrix makes host
    constants for a device ``cat``, and its device ``Shapes`` propagates no
    host shapes for the subscript that reads them. The port fixes both; here they are
    patched in the reference for the test's duration, so it builds the
    port's graph node for node."""
    from dali_tpu.auto_aug import augmentations
    from dali_tpu.backend.generic import ShapesGPU
    from dali_tpu.data_node import DataNode

    fn, types = dali_tpu.fn, dali_tpu.types

    def stack_matrix(*values):
        device = "gpu" if any(isinstance(v, DataNode) and v.device == "gpu"
                              for v in values) else "cpu"
        nodes = [fn.reshape(fn.cast(v, dtype=types.FLOAT), shape=[1]) if isinstance(v, DataNode)
                 else fn.full(fill_value=[float(v)], shape=[1], dtype=types.FLOAT, device=device)
                 for v in values]
        return fn.cat(*nodes, axis=0)

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        sh = input_shapes[0] if input_shapes else None
        return None if sh is None else [np.full((len(sh), 1), np.asarray(sh).shape[1], np.int32)]

    monkeypatch.setattr(augmentations, "_stack_matrix", stack_matrix)
    monkeypatch.setattr(ShapesGPU, "host_output_shapes", host_output_shapes, raising=False)


AUG_DATA = np.random.default_rng(29).integers(0, 256, (8, 48, 40, 3)).astype(np.uint8)
SHAPE_POLICIES = {
    "trivial_augment_wide": lambda aa, x: aa.trivial_augment_wide(x, shape=[48, 40]),
    "auto_augment_image_net": lambda aa, x: aa.auto_augment_image_net(x, shape=[48, 40]),
    "rand_augment": lambda aa, x: aa.rand_augment(x, n=2, m=9, shape=[48, 40]),
}


def _aug_run(build, iters=2):
    res = []
    for pkg, kw in ((dali_tpu_torch, {"device": "cpu"}), (dali_tpu, {"debug": True})):
        @pkg.pipeline_def(batch_size=len(AUG_DATA), num_threads=1, seed=42,
                          enable_conditionals=True, **kw)
        def p():
            return build(pkg, _source(pkg.fn, AUG_DATA, "HWC").gpu())

        pipe = p()
        pipe.build()
        try:
            res.append([np.asarray(pipe.run()[0].as_tensor()) for _ in range(iters)])
            ids = [(n.spec.schema_name, n.id) for n in pipe._graph.ops]
        finally:
            (pipe.shutdown if pkg is dali_tpu_torch else pipe._executor.shutdown)()
        res.append(ids)
    return res


@pytest.mark.parametrize("name", ["translate_x", "translate_y"])
def test_shape_relative_translate_matches_dali_tpu(name, reference_translates_on_device):
    def build(pkg, x):
        aug = getattr(pkg.auto_aug.augmentations, name)
        return tuple(aug(x, magnitude_bin=b, num_magnitude_bins=11) for b in (0, 5, 10))[-1]

    got, g_ids, want, w_ids = _aug_run(build, iters=1)
    assert g_ids == w_ids
    d = np.abs(got[0].astype(np.int64) - want[0].astype(np.int64))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-4


@pytest.mark.parametrize("policy", list(SHAPE_POLICIES))
def test_shape_relative_policies_match_dali_tpu(policy, reference_translates_on_device):
    """The same operators in the same order as the reference (implicit-seed
    streams key on op ids), the translates reading each image's shape on the
    device; tolerances as in ``test_torch_auto_aug.py``."""
    got, g_ids, want, w_ids = _aug_run(lambda pkg, x: SHAPE_POLICIES[policy](pkg.auto_aug, x))
    assert g_ids == w_ids
    assert {"Shapes", "_TensorSubscript"} <= {s for s, _ in g_ids}
    for g, w in zip(got, want):
        d = np.abs(g.astype(np.int64) - w.astype(np.int64))
        if policy == "trivial_augment_wide":
            assert d.max() <= 1 and (d > 0).mean() <= 1e-4
        else:
            assert (d == 0).mean() >= 0.999


# ------------------------------------------------ transforms_3d.py's crop, on the device

def _synth_volumes():
    """docs/examples/transforms_3d.py's volumes."""
    rng = np.random.default_rng(17)
    vols = []
    for _ in range(2):
        v = rng.integers(0, 256, (12, 24, 28, 1), np.uint8)
        v[4:8, 8:16, 9:18] = 255
        vols.append(v)
    return vols


def test_transforms_3d_crop_on_device():
    """The example's ``crop(crop_d=8, crop_h=16, crop_w=16)`` of DHWC
    volumes, and its resize beside it, on the device (its flip and pad run
    only on the cpu, and volumes through rotate and warp_affine, not ported
    yet: ROADMAP.md Queue 1 item 5h)."""
    vols = _synth_volumes()

    def build(fn, v, t):
        return (fn.crop(v, crop_d=8, crop_h=16, crop_w=16),
                fn.resize(v, resize_x=16, resize_y=16, resize_z=8))

    got, want = _run(build, vols, "DHWC", "gpu", n=2)
    cropped = got[0][0]
    assert [c.shape for c in cropped] == [(8, 16, 16, 1)] * 2
    np.testing.assert_array_equal(cropped[0], vols[0][2:10, 4:20, 6:22])
    _exact(([got[0][0]], got[1][:1]), ([want[0][0]], want[1][:1]))
    for g_out, w_out in zip(got[0][1:], want[0][1:]):
        for g, w in zip(g_out, w_out):
            assert g.shape == w.shape
            d = np.abs(g.astype(np.int64) - w.astype(np.int64))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3
