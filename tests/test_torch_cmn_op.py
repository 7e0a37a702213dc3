"""fn.crop_mirror_normalize on the device through dali_tpu_torch (on the CPU:
the kernel's plain version) against dali_tpu's gpu lowering run op by op
(``debug=True``), on the same seeded batches fed by ``fn.external_source``:
the pad policy with fill values, ``pad_output`` in CHW and HWC, FLOAT16,
float input, tensor crop positions from ``fn.random.uniform``, truncating
rounding and ``trim_to_shape`` on ragged input.

Per-sample shapes, dtypes and layouts are equal; values are within 1e-5 for
float32 (the tolerance of the kernel's own tests) and one float16 step at the
value's magnitude for float16."""

import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch

N = 6
RNG = np.random.default_rng(41)
UNIFORM = RNG.integers(0, 256, (N, 40, 48, 3)).astype(np.uint8)
RAGGED = [RNG.integers(0, 256, (30 + 4 * i, 56 - 5 * i, 3)).astype(np.uint8) for i in range(N)]
FLOATS = (RNG.random((N, 36, 44, 3)) * 255).astype(np.float32)
HALVES = [(RNG.random((28 + 3 * i, 30 + 2 * i, 3)) * 255).astype(np.float16) for i in range(N)]
MEAN = [123.675, 116.28, 103.53]
STD = [58.395, 57.12, 57.375]


def _uniform_pos(fn, seed):
    return fn.random.uniform(range=[0.0, 1.0], seed=seed)


# name -> (input batch, mirror from a coin flip, arguments; a callable value
# is built in the graph from (fn, types))
CASES = {
    "pad_fill_chw": (RAGGED, True, dict(
        crop=(48, 52), out_of_bounds_policy="pad", fill_values=[0.5, -1.0, 2.0])),
    "pad_fill_scalar_hwc_tensor_pos": (RAGGED, True, dict(
        crop=(40, 60), out_of_bounds_policy="pad", fill_values=[3.0], output_layout="HWC",
        crop_pos_x=lambda fn, t: _uniform_pos(fn, 5),
        crop_pos_y=lambda fn, t: _uniform_pos(fn, 6))),
    "pad_output_chw": (UNIFORM, True, dict(crop=(32, 40), pad_output=True)),
    "pad_output_hwc": (UNIFORM, False, dict(crop=(33, 33), pad_output=True, output_layout="HWC")),
    "float16_hwc_pad_output": (UNIFORM, True, dict(
        crop=(32, 40), pad_output=True, output_layout="HWC",
        dtype=lambda fn, t: t.FLOAT16, scale=1.25, shift=0.5)),
    "float32_input_float16": (FLOATS, True, dict(
        crop=(30, 35), crop_pos_x=0.8, dtype=lambda fn, t: t.FLOAT16)),
    "float16_input_pad": (HALVES, True, dict(
        crop=(31, 37), out_of_bounds_policy="pad", fill_values=[9.0, 8.0, 7.0],
        output_layout="HWC", pad_output=True)),
    "tensor_crop_pos": (RAGGED, True, dict(
        crop=(24, 28), crop_pos_x=lambda fn, t: _uniform_pos(fn, 7),
        crop_pos_y=lambda fn, t: _uniform_pos(fn, 8))),
    "truncate": (RAGGED, False, dict(
        crop=(25, 31), crop_pos_x=0.3, crop_pos_y=0.7, rounding="truncate")),
    "trim_to_shape_chw": (RAGGED, True, dict(
        crop=(44, 50), out_of_bounds_policy="trim_to_shape", crop_pos_x=0.6)),
    "trim_to_shape_hwc_pad_output": (RAGGED, True, dict(
        crop=(44, 50), out_of_bounds_policy="trim_to_shape", output_layout="HWC",
        pad_output=True)),
}


def _run(case):
    """The case's graph in both packages; returns (port, reference), each a
    (layout, per-sample numpy arrays) pair."""
    data, with_mirror, kw = CASES[case]
    res = []
    for pkg, extra in ((dali_tpu_torch, {"device": "cpu"}), (dali_tpu, {"debug": True})):
        @pkg.pipeline_def(batch_size=N, num_threads=1, seed=17, **extra)
        def p():
            fn, types = pkg.fn, pkg.types
            args = {k: v(fn, types) if callable(v) else v for k, v in kw.items()}
            if with_mirror:
                args["mirror"] = fn.random.coin_flip(probability=0.5, seed=3)
            x = fn.external_source(source=lambda: data, batch=True, layout="HWC").gpu()
            return fn.crop_mirror_normalize(x, mean=MEAN, std=STD, **args)

        pipe = p()
        pipe.build()
        try:
            (out,) = pipe.run()
        finally:
            (pipe.shutdown if pkg is dali_tpu_torch else pipe._executor.shutdown)()
        res.append((out.layout(), [np.asarray(out.at(i)) for i in range(len(out))]))
    return res


@pytest.mark.parametrize("case", sorted(CASES))
def test_cmn_op_matches_dali_tpu(case):
    (got_layout, got), (want_layout, want) = _run(case)
    assert got_layout == want_layout
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == np.float32:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
        else:
            g32, w32 = g.astype(np.float32), w.astype(np.float32)
            step = np.spacing(np.maximum(np.abs(g32), np.abs(w32)).astype(np.float16))
            assert np.all(np.abs(g32 - w32) <= step.astype(np.float32))


def test_cmn_op_error_policy_names_the_sample():
    @dali_tpu_torch.pipeline_def(batch_size=N, num_threads=1, seed=1, device="cpu")
    def p():
        x = dali_tpu_torch.fn.external_source(source=lambda: RAGGED, batch=True,
                                              layout="HWC").gpu()
        return dali_tpu_torch.fn.crop_mirror_normalize(x, crop=(40, 60))

    pipe = p()
    pipe.build()
    try:
        with pytest.raises(ValueError, match="out of bounds for sample 0"):
            pipe.run()
    finally:
        pipe.shutdown()
