"""The gpu operators on FHWC sequences and DHWC volumes (ROADMAP.md Queue 1
item 5h.7), and the repairs of Crop(gpu) on sequences and of ColorTwist and
Hsv gpu on rounding ties (Queue 3 F1-F2), in dali_tpu_torch on the CPU
against dali_tpu's gpu lowerings with ``debug=True``.

Inputs come from a numpy seed, batch 2, uniform and ragged. Tolerances:

* uint8 outputs bit-equal (WarpAffine, Rotate, GaussianBlur, Equalize,
  ColorTwist, Hsv);
* float32 outputs (volumes, ``dtype=FLOAT`` colour twists) within 1e-5
  absolute (the colour twists within 1e-6).

Where dali_tpu fails or departs (Crop(gpu) and Equalize(gpu) on ragged 5-D
batches raise; Rotate(gpu) of a ragged batch of volumes returns the whole
padded canvas), the tests pin both behaviours (ROADMAP.md Queue 3).
"""

import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch

SEED = 17
RNG = np.random.default_rng(23)
UINT8_TOL = 0
FLOAT_TOL = 1e-5
COLOR_FLOAT_TOL = 1e-6


def _u8(shape):
    return RNG.integers(0, 256, shape, np.uint8)


DATA = {
    ("FHWC", "uniform"): [_u8((3, 6, 8, 3)) for _ in range(2)],
    ("FHWC", "ragged"): [_u8((3 + i, 6 + 2 * i, 8 - i, 3)) for i in range(2)],
    ("DHWC", "uniform"): [_u8((5, 6, 8, 2)) for _ in range(2)],
    ("DHWC", "ragged"): [_u8((5 + i, 6 + 2 * i, 8 - i, 2)) for i in range(2)],
}
FLOAT_VOLUMES = {
    "uniform": [RNG.normal(0, 1, (6, 7, 9, 2)).astype(np.float32) for _ in range(2)],
    "ragged": [RNG.normal(0, 1, (6 - i, 7 + i, 9 - 2 * i, 2)).astype(np.float32)
               for i in range(2)],
}
M2 = [0.9, 0.2, 1.0, -0.1, 1.1, 0.5]
M2_ALIGNED = [1.25, 0.0, -0.5, 0.0, 0.8, 0.75]
M3 = [0.9, 0.1, 0.05, 0.5, -0.1, 1.05, 0.1, 0.2, 0.05, -0.1, 0.95, 0.3]


def _build(pkg, graph, batch=2, **kw):
    if pkg is dali_tpu_torch:
        kw.setdefault("device", "cpu")
    else:
        kw.setdefault("debug", True)

    @pkg.pipeline_def(batch_size=batch, num_threads=1, seed=SEED, **kw)
    def pipe():
        out = graph(pkg.fn, pkg.types)
        return out if isinstance(out, tuple) else (out,)

    p = pipe()
    p.build()
    return p


def _close(pipe):
    if isinstance(pipe, dali_tpu_torch.Pipeline):
        pipe.shutdown()
    else:
        pipe._executor.shutdown()


def _run(pkg, graph, batch=2):
    pipe = _build(pkg, graph, batch)
    try:
        outs = []
        for tl in pipe.run():
            tl = tl.as_cpu() if hasattr(tl, "as_cpu") else tl
            outs.append([np.asarray(tl.at(i)) for i in range(len(tl))])
        return outs
    finally:
        _close(pipe)


def _src(fn, samples, layout):
    return fn.external_source(source=lambda: samples, batch=True, layout=layout)


def _per_sample(fn, values):
    return fn.external_source(source=lambda: [np.asarray(v, np.float32) for v in values],
                              batch=True)


def _compare(graph, tol=UINT8_TOL, crop_reference=False, batch=2):
    got, want = (_run(pkg, graph, batch) for pkg in (dali_tpu_torch, dali_tpu))
    assert len(got) == len(want)
    for g_out, w_out in zip(got, want):
        for g, w in zip(g_out, w_out):
            if crop_reference:  # the reference's sample is the padded canvas
                w = w[tuple(slice(0, s) for s in g.shape)]
            assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, g.shape, w.dtype,
                                                                 w.shape)
            if tol == 0:
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=tol)
    return got


def _raises(pkg, graph, exc, match=None):
    pipe = _build(pkg, graph)
    try:
        with pytest.raises(exc, match=match):
            pipe.run()
    finally:
        _close(pipe)


# ------------------------------------------------------------------ F1: Crop(gpu) on sequences


@pytest.mark.parametrize("kind", ["uniform", "ragged"])
def test_crop_gpu_of_a_sequence_raises_in_both(kind):
    """Crop(gpu) crops HWC images and DHWC volumes; on an FHWC batch both
    packages raise ValueError, and the port's message points to the cpu
    placement, which crops H and W of every frame in both packages."""
    seqs = DATA[("FHWC", kind)]

    def graph(on_gpu):
        def g(fn, t):
            x = _src(fn, seqs, "FHWC")
            return fn.crop(x.gpu() if on_gpu else x, crop=(4, 4), crop_pos_x=0.3, crop_pos_y=0.7)
        return g

    _raises(dali_tpu_torch, graph(True), ValueError, r"layout 'FHWC'.*device='cpu'")
    _raises(dali_tpu, graph(True), ValueError)
    got = _compare(graph(False))
    assert [g.shape for g in got[0]] == [(s.shape[0], 4, 4, 3) for s in seqs]


# ------------------------------------------------------------------ F2: colour twists on ties

TIES = {
    "brightness_0.9": (3, lambda fn, t, x: fn.color_twist(x, brightness=0.9)),
    "brightness_0.7": (3, lambda fn, t, x: fn.color_twist(x, brightness=0.7)),
    "hsv_value_0.9": (3, lambda fn, t, x: fn.hsv(x, value=0.9)),
    "gray_hue_saturation_brightness": (1, lambda fn, t, x: fn.color_twist(
        x, hue=10.0, saturation=1.2, brightness=0.9)),
}


@pytest.mark.parametrize("case", sorted(TIES))
def test_color_twist_and_hsv_gpu_bit_equal_on_ties(case):
    """Matrices and products summed in XLA-CPU's order: values such as
    103.5 round to the reference's side. uint8 bit-equal."""
    channels, op = TIES[case]
    imgs = [_u8((64, 80, channels)) for _ in range(2)]
    _compare(lambda fn, t: op(fn, t, _src(fn, imgs, "HWC").gpu()))


@pytest.mark.parametrize("case", ["brightness", "hue_saturation", "per_sample"])
def test_color_twist_float_output_within_1e6(case):
    imgs = [_u8((32, 40, 3)) for _ in range(2)]

    def graph(fn, t):
        x = _src(fn, imgs, "HWC").gpu()
        if case == "brightness":
            return fn.color_twist(x, brightness=0.9, dtype=t.FLOAT)
        if case == "hue_saturation":
            return fn.color_twist(x, hue=10.0, saturation=1.2, brightness=0.7, dtype=t.FLOAT)
        return fn.hsv(x, hue=_per_sample(fn, [12.0, -30.0]), saturation=_per_sample(fn, [0.7, 1.3]),
                      value=_per_sample(fn, [0.9, 1.1]), dtype=t.FLOAT)

    _compare(graph, tol=COLOR_FLOAT_TOL)


@pytest.mark.parametrize("batch", [1, 64, 256])
@pytest.mark.parametrize("op", ["hsv", "color_twist"])
def test_hue_twists_bit_equal_at_any_batch(op, batch):
    """A per-sample hue other than 0: XLA's CPU dot sums the hue product's
    first two columns unfused in whole tiles of 8 rows, its cos and sin are
    the C library's, and it folds a batch of one image into a plain dot.
    uint8 and float32 outputs bit-equal."""
    rng = np.random.default_rng(batch)
    imgs = [rng.integers(0, 256, (8, 10, 3), np.uint8) for _ in range(batch)]
    params = [list(rng.uniform(lo, hi, batch)) for lo, hi in ((-40, 40), (0.6, 1.4), (0.7, 1.2))]

    def graph(fn, t):
        x = _src(fn, imgs, "HWC").gpu()
        h, s, v = (_per_sample(fn, p) for p in params)
        if op == "hsv":
            return fn.hsv(x, hue=h, saturation=s, value=v), fn.hsv(
                x, hue=h, saturation=s, value=v, dtype=t.FLOAT)
        return fn.color_twist(x, hue=h, saturation=s, brightness=v), fn.color_twist(
            x, hue=h, saturation=s, brightness=v, dtype=t.FLOAT)

    _compare(graph, batch=batch)


# ------------------------------------------------------------------ item 5h.7

OPS = {
    "warp_affine": lambda fn, t, x, lay: fn.warp_affine(x, matrix=M2 if lay == "FHWC" else M3),
    "warp_affine_nn_fill": lambda fn, t, x, lay: fn.warp_affine(
        x, matrix=M2 if lay == "FHWC" else M3, interp_type=t.INTERP_NN, fill_value=77.0),
    "warp_affine_inverse_map_false": lambda fn, t, x, lay: fn.warp_affine(
        x, matrix=M2 if lay == "FHWC" else M3, inverse_map=False),
    "warp_affine_identity": lambda fn, t, x, lay: fn.warp_affine(x),
    "rotate": lambda fn, t, x, lay: fn.rotate(x, angle=15.0, axis=[0.3, 0.5, 1.0]),
    "rotate_keep_size_nn": lambda fn, t, x, lay: fn.rotate(x, angle=-20.0, keep_size=True,
                                                           interp_type=t.INTERP_NN),
    "rotate_tensor_angle_axis": lambda fn, t, x, lay: fn.rotate(
        x, angle=_per_sample(fn, [10.0, -25.0]),
        axis=_per_sample(fn, [[1.0, 0.0, 0.0], [0.2, -0.6, 0.4]])),
    "gaussian_blur": lambda fn, t, x, lay: fn.gaussian_blur(
        x, sigma=[0.8, 1.2, 1.6] if lay == "DHWC" else 1.1),
    "gaussian_blur_per_sample": lambda fn, t, x, lay: fn.gaussian_blur(
        x, sigma=_per_sample(fn, [0.6, 1.9])),
    "gaussian_blur_window": lambda fn, t, x, lay: fn.gaussian_blur(x, window_size=5),
    "equalize": lambda fn, t, x, lay: fn.experimental.equalize(x),
}


def _crops_reference(name, layout, kind):
    return name.startswith("rotate") and layout == "DHWC" and kind == "ragged"


@pytest.mark.parametrize("kind", ["uniform", "ragged"])
@pytest.mark.parametrize("layout", ["FHWC", "DHWC"])
@pytest.mark.parametrize("name", sorted(OPS))
def test_sequence_and_volume_ops_bit_equal(name, layout, kind):
    data = DATA[(layout, kind)]

    def graph(fn, t):
        return OPS[name](fn, t, _src(fn, data, layout).gpu(), layout)

    if name == "equalize" and kind == "ragged":
        _raises(dali_tpu_torch, graph, NotImplementedError, r"dali_tpu's gpu op fails there")
        _raises(dali_tpu, graph, ValueError, r"broadcast")
        return
    got = _compare(graph, crop_reference=_crops_reference(name, layout, kind))
    if name.startswith("rotate") and layout == "DHWC" and "keep" not in name:
        assert [g.shape for g in got[0]] == [d.shape for d in data]  # a volume keeps its size


def test_rotate_sequence_grows_each_frame_canvas():
    """A [3, 6, 8, 3] sequence rotated by 15 degrees: [3, 8, 9, 3] in both."""
    seqs = [_u8((3, 6, 8, 3)) for _ in range(2)]
    got = _compare(lambda fn, t: fn.rotate(_src(fn, seqs, "FHWC").gpu(), angle=15.0))
    assert [g.shape for g in got[0]] == [(3, 8, 9, 3)] * 2


def test_rotate_ragged_volumes_departs_by_cropping():
    """dali_tpu returns each rotated volume of a ragged batch on the whole
    padded canvas (its gpu op gives no host shapes); the port returns each at
    its own size, equal to the reference's canvas cut to that size."""
    data = DATA[("DHWC", "ragged")]
    graph = lambda fn, t: fn.rotate(_src(fn, data, "DHWC").gpu(), angle=30.0, axis=[0, 1, 0])
    got, want = (_run(pkg, graph) for pkg in (dali_tpu_torch, dali_tpu))
    for g, w, d in zip(got[0], want[0], data):
        assert g.shape == d.shape and w.shape != d.shape
        np.testing.assert_array_equal(g, w[tuple(slice(0, s) for s in g.shape)])


def test_warp_affine_volume_matrix_input_and_size():
    """A 12-value matrix as a per-sample tensor argument, and an output
    ``size`` of three values."""
    mats = [np.asarray(M3, np.float32),
            np.asarray([1, 0, 0, -1.5, 0, 1, 0, 2, 0, 0, 1, 0.5], np.float32)]
    data = DATA[("DHWC", "uniform")]
    got = _compare(lambda fn, t: fn.warp_affine(
        _src(fn, data, "DHWC").gpu(), matrix=fn.external_source(source=lambda: mats, batch=True),
        size=[4.0, 7.0, 5.0]))
    assert [g.shape for g in got[0]] == [(4, 7, 5, 2)] * 2


@pytest.mark.parametrize("name", ["warp_affine", "rotate", "gaussian_blur"])
@pytest.mark.parametrize("kind", ["uniform", "ragged"])
def test_float_volumes_within_1e5(name, kind):
    data = FLOAT_VOLUMES[kind]
    _compare(lambda fn, t: OPS[name](fn, t, _src(fn, data, "DHWC").gpu(), "DHWC"),
             tol=FLOAT_TOL, crop_reference=_crops_reference(name, "DHWC", kind))


def test_warp_affine_sequence_axis_aligned_takes_separable_route():
    """An axis-aligned matrix on a sequence takes the separable route per
    frame, in both packages."""
    data = DATA[("FHWC", "ragged")]
    _compare(lambda fn, t: fn.warp_affine(_src(fn, data, "FHWC").gpu(), matrix=M2_ALIGNED))


def test_volumetric_kernel_against_host_and_reference_kernels():
    """kernels.warp.warp_affine_volumetric_batch against the port's own
    warp_affine_volumetric_np and dali_tpu's batch function, nearest and
    trilinear, float32 within 1e-5 and uint8 bit-equal."""
    import jax.numpy as jnp
    import torch

    from dali_tpu.kernels import warp as ref_warp
    from dali_tpu_torch.kernels import warp as warp_kernel
    from dali_tpu_torch.types import DALIInterpType

    vols = np.stack([_u8((6, 7, 9, 3)) for _ in range(2)])
    mats = np.stack([np.asarray(M3, np.float32).reshape(3, 4),
                     warp_kernel.rotation_matrix_3d(25.0, [0.2, 1.0, -0.3], (4, 3, 2.5),
                                                    (4, 3, 2.5))])
    for interp in (DALIInterpType.INTERP_NN, DALIInterpType.INTERP_LINEAR):
        for dt in (torch.float32, torch.uint8):
            got = warp_kernel.warp_affine_volumetric_batch(
                torch.from_numpy(vols), torch.from_numpy(mats), 6, 7, 9, None, interp, 9.0,
                dt).numpy()
            ref = np.asarray(ref_warp.warp_affine_volumetric_batch(
                jnp.asarray(vols), jnp.asarray(mats), 6, 7, 9, None, interp, 9.0,
                jnp.float32 if dt == torch.float32 else jnp.uint8))
            host = np.stack([warp_kernel.warp_affine_volumetric_np(v, m, 6, 7, 9, interp, 9.0)
                             for v, m in zip(vols, mats)])
            if dt == torch.float32:
                np.testing.assert_allclose(got, ref, rtol=0, atol=FLOAT_TOL)
                np.testing.assert_allclose(got, host, rtol=0, atol=FLOAT_TOL)
            else:
                np.testing.assert_array_equal(got, ref)
                np.testing.assert_array_equal(
                    got, np.clip(np.round(host), 0, 255).astype(np.uint8))


# ------------------------------------------------------------------ the slice's paths, small


def test_sequence_augment_graph_bit_equal(tmp_path):
    """chip_smoke.py's sequence_augment graph (tools/bench_seq_volumes.py) at
    batch 2, sequences of 4 frames of 32x32 from the corpus: readers.sequence,
    the transforms' per-sequence warp, blur, equalize (uint8, bit-equal) and
    CMN to FCHW (float32 within 1e-5), two iterations."""
    from dali_tpu_torch.tools import bench_seq_volumes as bsv

    root = bsv.ensure_sequence_corpus(str(tmp_path / "seqs"), frames=4, size=32)
    outs = []
    for pkg, kw in ((dali_tpu_torch, {"device": "cpu"}), (dali_tpu, {"debug": True})):
        @pkg.pipeline_def(batch_size=2, num_threads=1, seed=42, **kw)
        def pipe():
            return bsv.sequence_graph(pkg.fn, pkg.types, root, 4, 32, stages=True)

        p = pipe()
        p.build()
        try:
            outs.append([[np.asarray((o.as_cpu() if hasattr(o, "as_cpu") else o).at(i))
                          for i in range(2)] for _ in range(2) for o in p.run()])
        finally:
            _close(p)
    for k, (g_out, w_out) in enumerate(zip(*outs)):
        for g, w in zip(g_out, w_out):
            assert g.shape == w.shape and g.dtype == w.dtype
            if g.dtype == np.uint8:
                np.testing.assert_array_equal(g, w)
            else:
                assert g.shape == (4, 3, 32, 32)
                np.testing.assert_allclose(g, w, rtol=0, atol=FLOAT_TOL)


def _volume_runs(pkg, graph, vols, n=2):
    @pkg.pipeline_def(batch_size=2, num_threads=1, seed=42,
                      **({"device": "cpu"} if pkg is dali_tpu_torch else {"debug": True}))
    def pipe():
        return graph(pkg.fn, vols)

    p = pipe()
    p.build()
    try:
        return [[np.asarray((o.as_cpu() if hasattr(o, "as_cpu") else o).at(i)) for i in range(2)]
                for _ in range(n) for o in p.run()]
    finally:
        _close(p)


def test_volume_augment_graph_within_1e5():
    """chip_smoke.py's volume_augment graph on small CDHW float32 volumes: the
    blur and rotation of DHWC volumes against dali_tpu within 1e-5, and the
    port's whole graph (transpose first) equal to its run on DHWC input."""
    from dali_tpu_torch.tools import bench_seq_volumes as bsv

    rng = np.random.default_rng(5)
    vols = [rng.standard_normal((4, 12, 16, 20)).astype(np.float32) for _ in range(2)]
    dhwc = [np.ascontiguousarray(v.transpose(1, 2, 3, 0)) for v in vols]
    on_dhwc = lambda fn, v: bsv.augment_volumes(fn, _src(fn, v, "DHWC").gpu())  # noqa: E731
    got, want = (_volume_runs(pkg, on_dhwc, dhwc) for pkg in (dali_tpu_torch, dali_tpu))
    for g_out, w_out in zip(got, want):
        for g, w in zip(g_out, w_out):
            assert g.shape == w.shape == (12, 16, 20, 4)
            np.testing.assert_allclose(g, w, rtol=0, atol=FLOAT_TOL)
    whole = _volume_runs(dali_tpu_torch,
                         lambda fn, v: bsv.volume_graph(fn, _src(fn, v, "CDHW").gpu()), vols)
    for g_out, w_out in zip(whole, got):
        for g, w in zip(g_out, w_out):
            np.testing.assert_array_equal(g, w)


def test_rotate_after_transpose_fails_in_dali_tpu():
    """dali_tpu's Transpose(gpu) gives no host shapes, so its Rotate(gpu),
    whose canvas math runs on the host, fails after it; the port's
    Transpose(gpu) gives them, and its result equals dali_tpu's Rotate(gpu)
    of the volumes transposed on the host (ROADMAP.md Queue 3). float32
    within 1e-5."""
    vols = [RNG.normal(0, 1, (2, 3, 4, 5)).astype(np.float32) for _ in range(2)]

    def graph(on_gpu):
        def g(fn, t):
            x = _src(fn, vols, "CDHW")
            x = x.gpu() if on_gpu else x
            x = fn.transpose(x, perm=[1, 2, 3, 0], output_layout="DHWC")
            return fn.rotate(x if on_gpu else x.gpu(), angle=10.0, keep_size=True)
        return g

    _raises(dali_tpu, graph(True), RuntimeError, "host-known input shapes")
    got, want = _run(dali_tpu_torch, graph(True)), _run(dali_tpu, graph(False))
    assert [g.shape for g in got[0]] == [(3, 4, 5, 2)] * 2
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, rtol=0, atol=FLOAT_TOL)
