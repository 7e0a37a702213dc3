"""Resize(gpu) in every form and RandomResizedCrop(gpu): dali_tpu_torch on
the CPU against dali_tpu with ``debug=True``, on ragged batches fed by an
external source.

uint8 outputs agree within one step (the two sides sum the interpolation
products in different orders, so a value within float error of .5 may round
the other way): on at most 2e-3 of the canvas for Resize, the bound of
tests/test_torch_resample.py (measured up to 1.2e-3 on these random images),
and 1e-3 for RandomResizedCrop; float outputs within 1e-3 (values up to 255);
per-sample output shapes, canvases and save_attrs outputs equal."""

import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch

MAX_FLIP = 2e-3
MAX_FLIP_RRC = 1e-3


def _images(seed, n=5, lo=20, hi=72, c=3, lead=()):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, lead + (int(rng.integers(lo, hi)), int(rng.integers(lo, hi)), c),
                         dtype=np.uint8) for _ in range(n)]


def _run(pkg, batches, layout, make, iters=2, args=None, **kw):
    """Run ``make(fn, images[, arg])`` over ``batches`` (one per iteration)
    with the images on the device; ``args`` feeds a per-sample argument."""
    fn = pkg.fn
    it = iter(range(10 ** 6))
    box = {}

    def src():
        box["i"] = next(it)
        return batches[box["i"] % len(batches)]

    def arg_src():
        return args[box["i"] % len(args)]

    @pkg.pipeline_def(batch_size=len(batches[0]), num_threads=1, seed=17, **kw)
    def p():
        imgs = fn.external_source(source=src, batch=True, layout=layout).gpu()
        if args is None:
            out = make(fn, imgs)
        else:
            out = make(fn, imgs, fn.external_source(source=arg_src, batch=True))
        return out if isinstance(out, tuple) else (out,)

    pipe = p()
    pipe.build()
    res = []
    try:
        for _ in range(iters):
            outs = pipe.run()
            res.append([(np.asarray(o.as_tensor().cpu() if hasattr(o.as_tensor(), "cpu")
                                    else o.as_tensor()), [tuple(s) for s in o.shape()])
                        for o in outs])
    finally:
        pipe.shutdown() if pkg is dali_tpu_torch else pipe._executor.shutdown()
    return res


def _both(batches, make, layout="HWC", **kw):
    want = _run(dali_tpu, batches, layout, make, debug=True, **kw)
    got = _run(dali_tpu_torch, batches, layout, make, device="cpu", **kw)
    return got, want


def _assert_close(got, want, shapes=True, max_flip=MAX_FLIP):
    for g_it, w_it in zip(got, want):
        for k, ((g, g_sh), (w, w_sh)) in enumerate(zip(g_it, w_it)):
            assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape, w.shape)
            if shapes and k == 0:
                assert g_sh == w_sh
            if np.issubdtype(g.dtype, np.integer) and g.dtype.itemsize == 1:
                d = np.abs(g.astype(np.int16) - w.astype(np.int16))
                assert d.max() <= 1 and (d > 0).mean() <= max_flip, (d.max(), (d > 0).mean())
            elif np.issubdtype(g.dtype, np.integer):
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, atol=1e-3, rtol=0)


SIZE_MODES = {
    "static": dict(resize_x=40, resize_y=30),
    "size": dict(size=[24, 36]),
    "size_scalar": dict(size=[28]),
    "resize_x": dict(resize_x=40),
    "resize_y": dict(resize_y=30),
    "shorter": dict(resize_shorter=32),
    "longer": dict(resize_longer=48),
    "not_larger": dict(resize_x=40, resize_y=30, mode="not_larger"),
    "not_smaller": dict(resize_x=40, resize_y=30, mode="not_smaller"),
    "stretch": dict(resize_x=40, resize_y=30, mode="stretch"),
    "shorter_max_size": dict(resize_shorter=48, max_size=[56, 60]),
    "longer_max_size": dict(resize_longer=64, max_size=[40]),
    "heavy_downscale": dict(resize_shorter=6),
    "triangular": dict(resize_shorter=28, interp_type=dali_tpu_torch.types.INTERP_TRIANGULAR),
    "nn_float": dict(resize_longer=50, interp_type=dali_tpu_torch.types.INTERP_NN,
                     dtype=dali_tpu_torch.types.FLOAT),
    "no_antialias": dict(resize_shorter=12, antialias=False),
}


def _ref_kw(kw):
    """The same arguments with dali_tpu's enums."""
    out = {}
    for k, v in kw.items():
        if isinstance(v, dali_tpu_torch.types.DALIInterpType):
            v = dali_tpu.types.DALIInterpType(int(v))
        elif isinstance(v, dali_tpu_torch.types.DALIDataType):
            v = dali_tpu.types.DALIDataType(int(v))
        out[k] = v
    return out


def _make(kw):
    def make(fn, imgs, *arg):
        pkg_kw = kw if fn is dali_tpu_torch.fn else _ref_kw(kw)
        return fn.resize(imgs, **pkg_kw)

    return make


@pytest.mark.parametrize("mode", sorted(SIZE_MODES))
def test_resize_size_modes(mode):
    batches = [_images(1), _images(2)]
    _assert_close(*_both(batches, _make(SIZE_MODES[mode])))


@pytest.mark.parametrize("kw", [
    dict(resize_shorter=24, min_filter="INTERP_CUBIC", mag_filter="INTERP_NN"),
    dict(resize_shorter=80, min_filter="INTERP_CUBIC", mag_filter="INTERP_NN"),
    dict(resize_x=30, resize_y=30, min_filter="INTERP_LANCZOS3"),
    dict(resize_x=90, resize_y=90, mag_filter="INTERP_GAUSSIAN"),
], ids=["down", "up", "static_down", "static_up"])
def test_resize_filter_overrides(kw):
    kw = {k: (dali_tpu_torch.types.DALIInterpType[v] if k.endswith("filter") else v)
          for k, v in kw.items()}
    # the first batch latches the filter: the second keeps it either way
    batches = [_images(3), _images(4, lo=60, hi=100)]
    _assert_close(*_both(batches, _make(kw)))


@pytest.mark.parametrize("kw", [dict(resize_shorter=30), dict(resize_x=30, resize_y=20)])
def test_resize_save_attrs(kw):
    got, want = _both([_images(5), _images(6)], _make(dict(kw, save_attrs=True)))
    _assert_close(got, want)
    for g_it in got:
        assert g_it[1][0].dtype == np.int32 and g_it[1][0].shape == (5, 2)
        assert g_it[1][1] == [(2,)] * 5


@pytest.mark.parametrize("name", ["resize_x", "resize_shorter", "size"])
def test_resize_tensor_size_arguments(name):
    rng = np.random.default_rng(7)
    if name == "size":
        args = [[np.float32(rng.integers(16, 60, 2)) for _ in range(5)] for _ in range(2)]
    else:
        args = [[np.float32(rng.integers(16, 60)) for _ in range(5)] for _ in range(2)]

    def make(fn, imgs, arg):
        return fn.resize(imgs, **{name: arg})

    batches = [_images(8), _images(9)]
    want = _run(dali_tpu, batches, "HWC", make, args=args, debug=True)
    got = _run(dali_tpu_torch, batches, "HWC", make, args=args, device="cpu")
    _assert_close(got, want)


@pytest.mark.parametrize("kw", [dict(resize_x=24, resize_y=20), dict(size=[16, 32]),
                                dict(resize_x=24, resize_y=20, save_attrs=True)])
def test_resize_sequences_per_frame(kw):
    batches = [_images(10, n=3, lead=(4,)), _images(11, n=3, lead=(4,))]
    got, want = _both(batches, _make(kw), layout="FHWC")
    _assert_close(got, want)
    oh, ow = kw.get("resize_y", 16), kw.get("resize_x", 32)
    assert got[0][0][0].shape[2:] == (oh, ow, 3)  # F pads to the canvas like H, W
    assert got[0][0][1] == [(4, oh, ow, 3)] * 3


@pytest.mark.parametrize("kw", [dict(size=[6, 20, 24]), dict(resize_x=16, resize_y=12, resize_z=5),
                                dict(resize_x=40, resize_y=30, resize_z=7, mag_filter="INTERP_NN",
                                     save_attrs=True)])
def test_resize_volumes(kw):
    kw = {k: (dali_tpu_torch.types.DALIInterpType[v] if k.endswith("filter") else v)
          for k, v in kw.items()}
    rng = np.random.default_rng(12)
    batches = [[rng.integers(0, 256, (int(rng.integers(4, 9)), 28, 36, 2), dtype=np.uint8)
                for _ in range(3)] for _ in range(2)]
    _assert_close(*_both(batches, _make(kw), layout="DHWC"), shapes=False)


def test_resize_not_ported_paths_raise():
    imgs = [_images(13)]
    for kw, what in ((dict(resize_x=20, resize_y=20, roi_start=[0.1, 0.1]), "never reads"),
                     (dict(resize_x=20, resize_y=20, roi_relative=True), "never reads"),
                     (dict(resize_shorter=20), "sequences")):
        with pytest.raises(NotImplementedError, match=what):
            _run(dali_tpu_torch, [_images(13, n=2, lead=(3,))] if what == "sequences" else imgs,
                 "FHWC" if what == "sequences" else "HWC", _make(kw), iters=1, device="cpu")
    # dali_tpu's ResizeCPU never reads the ROI either (ROADMAP.md Queue 3)
    with pytest.raises(NotImplementedError, match=r"Resize\(cpu\).*'roi_start'.*Queue 3"):
        _run(dali_tpu_torch, imgs, "HWC",
             lambda fn, x: fn.resize(fn.external_source(source=lambda: imgs[0], batch=True),
                                     resize_x=8, resize_y=8, roi_start=[0.1, 0.1]),
             iters=1, device="cpu")


# -- RandomResizedCrop ----------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(size=[24, 24]),
    dict(size=[32, 20], random_area=[0.3, 0.6], random_aspect_ratio=[0.5, 2.0], num_attempts=4),
    dict(size=[40, 40], interp_type="INTERP_CUBIC", dtype="FLOAT"),
    dict(size=[16], min_filter="INTERP_TRIANGULAR", mag_filter="INTERP_NN", seed=3),
], ids=["default", "ranges", "cubic_float", "filters"])
def test_random_resized_crop(kw):
    def conv(pkg):
        types = pkg.types
        out = {}
        for k, v in kw.items():
            if k in ("interp_type", "min_filter", "mag_filter"):
                v = types.DALIInterpType[v]
            elif k == "dtype":
                v = types.DALIDataType[v]
            out[k] = v
        return out

    def make(fn, imgs):
        pkg = dali_tpu_torch if fn is dali_tpu_torch.fn else dali_tpu
        return fn.random_resized_crop(imgs, **conv(pkg))

    _assert_close(*_both([_images(14), _images(15)], make), max_flip=MAX_FLIP_RRC)


def test_random_resized_crop_cpu_raises():
    """On an argument dali_tpu's RandomResizedCropCPU never reads (ROADMAP.md
    Queue 3); the placement itself runs (tests/test_torch_host_geometry.py)."""
    imgs = [_images(16)]
    with pytest.raises(NotImplementedError, match=r"RandomResizedCrop\(cpu\).*'dtype'.*Queue 3"):
        _run(dali_tpu_torch, imgs, "HWC",
             lambda fn, x: fn.random_resized_crop(
                 fn.external_source(source=lambda: imgs[0], batch=True), size=[8, 8],
                 dtype=dali_tpu_torch.types.FLOAT),
             iters=1, device="cpu")
