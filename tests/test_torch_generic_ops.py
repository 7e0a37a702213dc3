"""Flip, Transpose, Pad, Erase, Laplacian and Copy on the device in
dali_tpu_torch against dali_tpu's gpu lowering run op by op (``debug=True``),
on the CPU.

Seeded uint8 and float32 batches (6 samples, ragged HWC and uniform, a DHWC
volume and an FHWC sequence) go through ``fn.external_source`` into both
packages. Flip, Transpose, Pad, Erase and Copy move values only and are
bit-equal with equal per-sample shapes; Laplacian's float output agrees
within atol 1e-4 (relative 1e-5 of its range), its uint8 output within one
step on at most 1e-3 of values.
"""

import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch

N = 6
RNG = np.random.default_rng(55)
RAGGED = [RNG.integers(0, 256, (20 + 5 * i, 33 - 2 * i, 3)).astype(np.uint8) for i in range(N)]
UNIFORM = RNG.integers(0, 256, (N, 24, 28, 3)).astype(np.uint8)
FLOATS = [RNG.standard_normal((9 + i, 7 + 2 * i, 1)).astype(np.float32) for i in range(N)]
VOLUME = RNG.integers(0, 256, (N, 5, 8, 9, 1)).astype(np.uint8)
SEQUENCE = RNG.integers(0, 256, (N, 3, 10, 12, 3)).astype(np.uint8)
FLAGS = np.array([[0], [1], [1], [0], [1], [0]], np.int32)
ANCHORS = np.array([[2.0, 3.0], [0.0, 0.0], [5.0, 1.0], [10.0, 10.0], [1.0, 7.0], [3.0, 3.0]],
                   np.float32)

INPUTS = {"ragged": (RAGGED, "HWC"), "uniform": (UNIFORM, "HWC"), "float": (FLOATS, "HWC"),
          "volume": (VOLUME, "DHWC"), "sequence": (SEQUENCE, "FHWC")}


def _run(build, data, layout):
    """The same graph in both packages; (port, reference) outputs as lists
    of per-sample numpy arrays, plus the output layouts."""
    res = []
    for pkg, kw in ((dali_tpu_torch, {"device": "cpu"}), (dali_tpu, {"debug": True})):
        @pkg.pipeline_def(batch_size=N, num_threads=1, seed=11, **kw)
        def p():
            x = pkg.fn.external_source(source=lambda: data, batch=True, layout=layout).gpu()
            outs = build(pkg.fn, x, pkg.types)
            return outs if isinstance(outs, tuple) else (outs,)

        pipe = p()
        pipe.build()
        try:
            outs = pipe.run()
        finally:
            (pipe.shutdown if pkg is dali_tpu_torch else pipe._executor.shutdown)()
        res.append(([[np.asarray(tl.as_cpu().at(i)) for i in range(len(tl))] for tl in outs],
                    [tl.layout() for tl in outs]))
    return res


def _exact(got, want):
    (g_outs, g_lay), (w_outs, w_lay) = got, want
    assert g_lay == w_lay
    for g_out, w_out in zip(g_outs, w_outs):
        for g, w in zip(g_out, w_out):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


CASES = {
    "flip_h": (lambda fn, x, t: fn.flip(x), ("ragged", "uniform", "float", "sequence")),
    "flip_hv": (lambda fn, x, t: fn.flip(x, horizontal=1, vertical=1),
                ("ragged", "uniform", "volume", "sequence")),
    "flip_v_only": (lambda fn, x, t: fn.flip(x, horizontal=0, vertical=1), ("ragged",)),
    "flip_depthwise": (lambda fn, x, t: fn.flip(x, horizontal=0, depthwise=1), ("volume",)),
    "flip_per_sample": (lambda fn, x, t: fn.flip(
        x, horizontal=fn.external_source(source=lambda: FLAGS, batch=True),
        vertical=fn.external_source(source=lambda: 1 - FLAGS, batch=True)),
        ("ragged", "uniform")),
    "transpose_chw": (lambda fn, x, t: fn.transpose(x, perm=[2, 0, 1]),
                      ("ragged", "uniform", "float")),
    "transpose_layout": (lambda fn, x, t: fn.transpose(x, perm=[1, 0, 2], output_layout="WHC"),
                         ("ragged",)),
    "transpose_no_layout": (lambda fn, x, t: fn.transpose(x, perm=[1, 0, 2],
                                                          transpose_layout=False), ("ragged",)),
    "pad_all": (lambda fn, x, t: fn.pad(x, fill_value=9.0), ("ragged", "float")),
    "pad_axes_align": (lambda fn, x, t: fn.pad(x, axes=[0, 1], align=[8, 16], fill_value=3.0),
                       ("ragged", "uniform")),
    "pad_shape": (lambda fn, x, t: fn.pad(x, axes=[1], shape=[80]), ("ragged", "uniform")),
    "pad_axis_names": (lambda fn, x, t: fn.pad(x, axis_names="W", fill_value=7.0),
                       ("ragged", "float")),
    "erase": (lambda fn, x, t: fn.erase(x, anchor=[2.0, 2.0], shape=[5.0, 5.0],
                                        axis_names="HW"), ("ragged", "uniform")),
    "erase_regions_fill": (lambda fn, x, t: fn.erase(
        x, anchor=[1.0, 1.0, 10.0, 4.0], shape=[3.0, 30.0, 4.0, 4.0], axes=[0, 1],
        fill_value=[10.0, 20.0, 30.0]), ("ragged", "uniform")),
    "erase_normalized_centered": (lambda fn, x, t: fn.erase(
        x, anchor=[0.5, 0.5], shape=[0.3, 0.4], normalized=True, centered_anchor=True,
        axis_names="HW"), ("ragged", "float")),
    "erase_per_sample": (lambda fn, x, t: fn.erase(
        x, anchor=fn.external_source(source=lambda: ANCHORS, batch=True), shape=[4.0, 6.0],
        axes=[0, 1], fill_value=255.0), ("ragged",)),
    "copy": (lambda fn, x, t: fn.copy(x), ("ragged", "uniform")),
}


@pytest.mark.parametrize("name,inp", [(k, i) for k, (_, ins) in CASES.items() for i in ins])
def test_value_moving_ops_bit_equal(name, inp):
    data, layout = INPUTS[inp]
    _exact(*_run(CASES[name][0], data, layout))


@pytest.mark.parametrize("inp", ["ragged", "uniform", "float", "volume", "sequence"])
@pytest.mark.parametrize("kw", [{"window_size": 3}, {"window_size": 5, "normalized_kernel": True},
                                {"window_size": 7, "scale": 0.01}])
def test_laplacian_float(inp, kw):
    data, layout = INPUTS[inp]
    got, want = _run(lambda fn, x, t: fn.laplacian(x, dtype=t.FLOAT, **kw), data, layout)
    assert got[1] == want[1]
    for g, w in zip(got[0][0], want[0][0]):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=max(1e-4, 1e-5 * float(np.abs(w).max())), rtol=0)


def test_laplacian_uint8_saturates():
    got, want = _run(lambda fn, x, t: fn.laplacian(x, window_size=3, dtype=t.UINT8),
                     RAGGED, "HWC")
    flips = total = 0
    for g, w in zip(got[0][0], want[0][0]):
        assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape
        d = np.abs(g.astype(int) - w.astype(int))
        assert d.max() <= 1
        flips, total = flips + int((d > 0).sum()), total + d.size
    assert flips <= 1e-3 * total


def test_pad_grows_canvas_and_fills_exactly():
    """Pad a ragged batch past its canvas: the fill lands between each
    extent and the target, the data is untouched."""
    got, want = _run(lambda fn, x, t: fn.pad(x, axes=[0], shape=[100], fill_value=5.0),
                     RAGGED, "HWC")
    _exact(got, want)
    for s, orig in zip(got[0][0], RAGGED):
        assert s.shape == (100, orig.shape[1], 3)
        np.testing.assert_array_equal(s[:orig.shape[0], :orig.shape[1]], orig)
        assert (s[orig.shape[0]:, :orig.shape[1]] == 5).all()
