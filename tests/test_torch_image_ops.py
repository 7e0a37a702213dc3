"""The device image operators of dali_tpu_torch against dali_tpu's gpu
lowering, on the CPU, and the host operators the augmentations build their
parameters with.

Seeded uint8 batches (4-8 samples, 32x32 to 64x64, 1 and 3 channels, some
ragged) go through ``fn.external_source`` into both packages; dali_tpu's
device ops run op by op (``debug=True``), as the port's do. Tolerances:

* quantised ops (equalize, lookup, cast, the host ops) are bit-equal;
* float-then-rounded uint8 ops (warps, rotate, colour, blur) are within one
  uint8 step on at most 1e-4 of values;
* float outputs are within atol 1e-4.
"""

import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch

N = 6
RNG = np.random.default_rng(33)
RGB = RNG.integers(0, 256, (N, 40, 48, 3)).astype(np.uint8)
GRAY = RNG.integers(0, 256, (N, 32, 36, 1)).astype(np.uint8)
RAGGED = [RNG.integers(0, 256, (32 + 5 * i, 64 - 4 * i, 3)).astype(np.uint8) for i in range(N)]
ANGLES = np.array([0.0, 30.0, 45.0, -60.0, 135.0, 90.0], np.float32)
FACTORS = np.array([0.2, 0.9, 1.0, 1.4, 1.9, 0.55], np.float32)


def _run(build, n=N, **extra):
    """Build the same graph in both packages; returns (port, reference)
    outputs as lists of per-sample numpy arrays."""
    res = []
    for pkg, kw in ((dali_tpu_torch, {"device": "cpu"}), (dali_tpu, {"debug": True})):
        @pkg.pipeline_def(batch_size=n, num_threads=1, seed=11, **kw, **extra)
        def p():
            outs = build(pkg, pkg.fn, pkg.types)
            return outs if isinstance(outs, tuple) else (outs,)

        pipe = p()
        pipe.build()
        try:
            outs = pipe.run()
        finally:
            (pipe.shutdown if pkg is dali_tpu_torch else pipe._executor.shutdown)()
        res.append([[np.asarray(tl.at(i)) for i in range(len(tl))]
                    for tl in (o.as_cpu() if type(o).__name__ == "TensorListGPU" else o
                               for o in outs)])
    return res


def _src(fn, data, gpu=True, layout="HWC"):
    node = fn.external_source(source=lambda: data, batch=True, layout=layout)
    return node.gpu() if gpu else node


def _exact(got, want):
    for g_out, w_out in zip(got, want):
        for g, w in zip(g_out, w_out):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def _one_step(got, want, frac=1e-4):
    for g_out, w_out in zip(got, want):
        flips = total = 0
        for g, w in zip(g_out, w_out):
            assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape
            d = np.abs(g.astype(int) - w.astype(int))
            assert d.max() <= 1
            flips += int((d > 0).sum())
            total += d.size
        assert flips <= frac * total, f"{flips} of {total} values differ by one step"


def _float(got, want, atol=1e-4):
    for g_out, w_out in zip(got, want):
        for g, w in zip(g_out, w_out):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=atol, rtol=0)


@pytest.mark.parametrize("interp", ["INTERP_NN", "INTERP_LINEAR"])
@pytest.mark.parametrize("route,matrix", [
    ("separable", [1.37, 0.0, 2.3, 0.0, 0.83, -1.1]),
    ("gather", [1.0, 0.3, -2.0, 0.1, 0.9, 1.5])])
def test_warp_affine_routes(route, matrix, interp, monkeypatch):
    """Both routes, constant and per-sample matrices, inverse_map True and
    False, zero and non-zero fill, uint8 and float output. The separable
    route is two matrix products in both packages, and the two libraries
    order their multiply-adds differently: a scale and offset that put many
    taps exactly half-way (0.8 and -1.2) made 1.7e-4 of values land on the
    other side of a rounding tie."""
    from dali_tpu_torch.kernels import warp as warp_kernel

    calls = []
    real = getattr(warp_kernel, "warp_affine_separable_batch")
    monkeypatch.setattr(warp_kernel, "warp_affine_separable_batch",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    per_sample = np.stack([np.asarray(matrix, np.float32) * (1 + 0.05 * i)
                           for i in range(N)]).astype(np.float32)
    if route == "separable":
        per_sample[:, [1, 3]] = 0.0

    def build(pkg, fn, types):
        x, g = _src(fn, RGB), _src(fn, GRAY)
        m = fn.external_source(source=lambda: per_sample, batch=True)
        it = getattr(types, interp)
        return (fn.warp_affine(x, matrix=matrix, interp_type=it),
                fn.warp_affine(x, matrix=m, interp_type=it, fill_value=77, inverse_map=False),
                fn.warp_affine(g, matrix=m, interp_type=it, size=[30, 50], fill_value=200),
                fn.warp_affine(x, matrix=matrix, interp_type=it, dtype=types.FLOAT))

    got, want = _run(build)
    _one_step(got[:3], want[:3])
    _float(got[3:], want[3:])
    assert len(calls) == (4 if route == "separable" else 0)


@pytest.mark.parametrize("keep_size", [True, False])
def test_rotate_mixed_angles(keep_size):
    """Mixed angles in one batch: keep_size, or the grown canvas (ragged,
    32-aligned) with per-sample extents; ragged inputs and one channel."""
    def build(pkg, fn, types):
        a = fn.external_source(source=lambda: ANGLES, batch=True)
        return (fn.rotate(_src(fn, RGB), angle=a, keep_size=keep_size, fill_value=128),
                fn.rotate(_src(fn, RAGGED), angle=a, keep_size=keep_size),
                fn.rotate(_src(fn, GRAY), angle=a, keep_size=keep_size,
                          interp_type=types.INTERP_NN))

    got, want = _run(build)
    _one_step(got, want)
    if not keep_size:
        assert got[0][3].shape != RGB[3].shape


def test_brightness_contrast_with_gpu_contrast_center():
    def build(pkg, fn, types):
        x = _src(fn, RGB)
        f = fn.external_source(source=lambda: FACTORS, batch=True)
        gray = fn.color_space_conversion(x, image_type=types.RGB, output_type=types.GRAY)
        center = fn.reductions.mean(fn.cast(gray, dtype=types.FLOAT))
        return (fn.brightness(x, brightness=f),
                fn.contrast(x, contrast=f, contrast_center=center),
                fn.contrast(_src(fn, GRAY), contrast=1.3),
                fn.brightness_contrast(x, brightness=1.1, brightness_shift=0.05, contrast=f,
                                       contrast_center=100.0),
                fn.brightness(x, brightness=f, dtype=types.FLOAT))

    got, want = _run(build)
    _one_step(got[:4], want[:4])
    _float(got[4:], want[4:])


def test_saturation_hue_hsv_and_gray():
    def build(pkg, fn, types):
        x = _src(fn, RGB)
        f = fn.external_source(source=lambda: FACTORS, batch=True)
        a = fn.external_source(source=lambda: ANGLES, batch=True)
        return (fn.saturation(x, saturation=f), fn.hue(x, hue=a),
                fn.hsv(x, hue=a, saturation=f, value=0.9),
                fn.color_space_conversion(x, image_type=types.RGB, output_type=types.GRAY),
                fn.color_space_conversion(x, image_type=types.RGB, output_type=types.YCbCr))

    got, want = _run(build)
    _one_step(got, want)


@pytest.mark.parametrize("where", ["cpu", "gpu"])
def test_reductions_mean_min_max(where):
    def build(pkg, fn, types):
        x = _src(fn, RGB, gpu=where == "gpu")
        r = fn.reductions
        return (r.mean(x), r.min(x), r.max(x),
                r.mean(fn.cast(x, dtype=types.FLOAT), axes=[0, 1], keep_dims=True),
                r.min(x, axes=[0, 1], keep_dims=True), r.max(x, axis_names="HW"))

    got, want = _run(build)
    _float(got[:1] + got[3:4], want[:1] + want[3:4])
    _exact(got[1:3] + got[4:], want[1:3] + want[4:])


def test_gaussian_blur():
    """Fixed and per-sample sigmas (kernels of different lengths, padded to
    the latched common length), on uniform and ragged batches: the
    reflect-101 border sits at each sample's extent."""
    sig = np.array([0.5, 0.85, 1.5, 2.5, 0.0, 1.0], np.float32)

    def build(pkg, fn, types):
        s = fn.external_source(source=lambda: sig, batch=True)
        return (fn.gaussian_blur(_src(fn, RGB), window_size=[3], sigma=[0.85]),
                fn.gaussian_blur(_src(fn, RAGGED), sigma=s),
                fn.gaussian_blur(_src(fn, GRAY), window_size=[5]),
                fn.gaussian_blur(_src(fn, RGB), sigma=[1.2], dtype=types.FLOAT))

    got, want = _run(build)
    _one_step(got[:3], want[:3])
    _float(got[3:], want[3:])


def test_equalize_bit_equal():
    def build(pkg, fn, types):
        return tuple(fn.experimental.equalize(_src(fn, d)) for d in (RGB, GRAY, RAGGED))

    got, want = _run(build)
    _exact(got, want)


@pytest.mark.parametrize("where", ["cpu", "gpu"])
def test_lookup_table_bit_equal(where):
    idx = RNG.integers(-3, 40, (N, 7)).astype(np.int32)

    def build(pkg, fn, types):
        k = _src(fn, idx, gpu=where == "gpu", layout="")
        return (fn.lookup_table(k, keys=list(range(0, 40, 3)), values=[0.5 * i for i in range(14)],
                                default_value=-1.0),
                fn.lookup_table(_src(fn, RGB, gpu=where == "gpu"), keys=[0, 255, 7],
                                values=[9, 3, 1], dtype=types.UINT8))

    got, want = _run(build)
    _exact(got, want)


@pytest.mark.parametrize("where", ["cpu", "gpu"])
def test_cast_bit_equal(where):
    vals = (RNG.standard_normal((N, 5, 3)) * 100).astype(np.float32)

    def build(pkg, fn, types):
        x = _src(fn, vals, gpu=where == "gpu", layout="")
        return (fn.cast(x, dtype=types.INT32), fn.cast(x, dtype=types.UINT8),
                fn.cast(fn.cast(x, dtype=types.INT16), dtype=types.FLOAT),
                fn.cast(_src(fn, RGB, gpu=where == "gpu"), dtype=types.FLOAT))

    got, want = _run(build)
    # float -> uint8 of negative values is implementation-defined: compare
    # only the values both define
    _exact(got[:1] + got[2:], want[:1] + want[2:])
    for g, w, v in zip(got[1], want[1], vals):
        ok = (v >= 0) & (v < 256)
        np.testing.assert_array_equal(g[ok], w[ok])


def test_host_ops_cat_reshape_full_random():
    """The host ops the augmentations build their parameters with; the
    implicit-seed random streams must draw the same values."""
    def build(pkg, fn, types):
        u = fn.random.uniform(range=[-2.0, 3.0])
        v = fn.random.uniform(values=[0.0, 1.0, 2.0, 5.0])
        c = fn.random.coin_flip(probability=0.3, dtype=types.BOOL)
        ci = fn.random.coin_flip(probability=0.7, dtype=types.INT32)
        w = fn.random.uniform(range=[0.0, 1.0], shape=[2, 3])
        m = fn.cat(fn.reshape(fn.cast(u, dtype=types.FLOAT), shape=[1]),
                   fn.full(fill_value=[2.5], shape=[1], dtype=types.FLOAT),
                   fn.reshape(w, shape=[6]), axis=0)
        return u, v, c, ci, m, fn.reshape(w, shape=[3, -1]), fn.zeros(shape=[2], dtype=types.INT32)

    got, want = _run(build)
    _exact(got, want)
    assert got[2][0].dtype == np.bool_


@pytest.mark.parametrize("device", ["cpu", "gpu"])
def test_constant_bit_equal(device):
    """types.Constant of an array: a Constant node on the given device."""
    def build(pkg, fn, types):
        return (types.Constant(np.arange(6, dtype=np.int32).reshape(2, 3), device=device),
                types.Constant(np.float32([0.5, -1.25]), device=device))

    got, want = _run(build)
    _exact(got, want)


def test_unported_paths_raise_not_implemented():
    """A cpu argument the reference never reads names ROADMAP.md; nothing
    falls back. The gpu paths of volumes, which raised until item 5h.7,
    now run and equal dali_tpu's."""
    fn = dali_tpu_torch.fn

    def build(body):
        @dali_tpu_torch.pipeline_def(batch_size=2, device="cpu")
        def p():
            return body()
        return p()

    maps = [np.zeros((8, 8), np.float32)] * 2
    cpu_remap = build(lambda: fn.experimental.remap(
        fn.external_source(source=lambda: RGB[:2], batch=True),
        fn.external_source(source=lambda: maps, batch=True),
        fn.external_source(source=lambda: maps, batch=True), pixel_origin="center"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cpu_remap.build()
    # the gpu paths of volumes run since item 5h.7, bit-equal to dali_tpu's
    vol = RNG.integers(0, 256, (2, 4, 8, 8, 1), np.uint8)
    for name, kw in (("rotate", {"angle": 10.0}), ("gaussian_blur", {}),
                     ("equalize", {}), ("warp_affine", {})):
        def graph(pkg, f, t, name=name, kw=kw):
            op = f.experimental.equalize if name == "equalize" else getattr(f, name)
            return op(_src(f, vol, layout="DHWC"), **kw)

        _exact(*_run(graph, n=2))
