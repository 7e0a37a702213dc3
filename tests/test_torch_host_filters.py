"""The host (cpu) image filters and the rest of the host image operators of
dali_tpu_torch against dali_tpu, on the CPU: GaussianBlur, Laplacian and
experimental.Filter; experimental.Equalize; Water, Sphere, Jitter and
GridMask; experimental.MedianBlur, Dilate and Erode; experimental.Clahe and
the bilinear experimental.Debayer; MultiPaste and DumpImage; TensorResize
(and its experimental name); ResizeCropMirror and FastResizeCropMirror.

Every output is bit-equal to the reference's cpu placement (equal dtype,
shape, values and layout): inputs are seeded numpy batches fed through
``fn.external_source`` (ragged, gray and RGB, uint8, uint16 and float32
where the reference takes them, FHWC sequences and DHWC volumes for the
separable filters, per-sample tensor arguments); the reference runs with
``debug=True``. The port's copy of the reference's C++
(``csrc/host/host_ops.cc``) is held against ``dali_tpu.native`` entry by
entry. DumpImage's files are held by name and by their pixels, read back
through the port's PNG decoder and through cv2.
"""

import os

import cv2
import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch
from dali_tpu import native as ref_native
from dali_tpu_torch import imgcodec, native
from dali_tpu_torch.tools import bench_dali_cpu
from tests.test_torch_host_geometry import _run_example

N = 5
RNG = np.random.default_rng(515)


def _hw(lo=18, hi=44):
    return int(RNG.integers(lo, hi)), int(RNG.integers(lo, hi))


IMGS = [RNG.integers(0, 256, (*_hw(), 3), dtype=np.uint8) for _ in range(N)]
GRAY = [im[..., :1].copy() for im in IMGS]
U16 = [RNG.integers(0, 65536, (*_hw(), 3), dtype=np.uint16) for _ in range(N)]
FLOATS = [RNG.uniform(-20, 280, (*_hw(), 3)).astype(np.float32) for _ in range(N)]
SEQS = [RNG.integers(0, 256, (3, *_hw(14, 24), 3), dtype=np.uint8) for _ in range(N)]
VOLS = [RNG.integers(0, 256, (int(RNG.integers(5, 9)), 12, 14, 1), dtype=np.uint8)
        for _ in range(N)]
MOSAICS = [RNG.integers(0, 256, (2 * int(RNG.integers(8, 20)), 2 * int(RNG.integers(8, 20))),
                        dtype=np.uint8) for _ in range(N)]
SIGMAS = [np.float32(s) for s in (0.5, 1.2, 2.5, 0.8, 3.0)]
FLAGS = [np.int32(f) for f in (1, 0, 1, 1, 0)]


def _run(build, data, layout, args=(), iters=1, threads=2):
    """The same host graph in both packages: ``build(fn, types, x, *args)``
    with ``x`` the batch and ``args`` per-sample argument batches. Returns
    (port, reference), each a list per iteration of (outputs as lists of
    arrays, layouts)."""
    res = []
    for pkg, kw in ((dali_tpu_torch, {"device": "cpu"}), (dali_tpu, {"debug": True})):
        @pkg.pipeline_def(batch_size=len(data), num_threads=threads, seed=11, **kw)
        def p():
            x = pkg.fn.external_source(source=lambda: data, batch=True, layout=layout)
            a = [pkg.fn.external_source(source=lambda v=v: v, batch=True) for v in args]
            outs = build(pkg.fn, pkg.types, x, *a)
            return outs if isinstance(outs, tuple) else (outs,)

        pipe = p()
        pipe.build()
        its = []
        try:
            for _ in range(iters):
                outs = pipe.run()
                its.append(([[np.asarray(tl.at(i)) for i in range(len(tl))] for tl in outs],
                            [tl.layout() for tl in outs]))
        finally:
            (pipe.shutdown if pkg is dali_tpu_torch else pipe._executor.shutdown)()
        res.append(its)
    return res


def _bit_equal(got, want):
    assert len(got) == len(want)
    for (g_outs, g_lay), (w_outs, w_lay) in zip(got, want):
        assert g_lay == w_lay
        for g_out, w_out in zip(g_outs, w_outs):
            assert len(g_out) == len(w_out)
            for g, w in zip(g_out, w_out):
                assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape,
                                                                  w.shape)
                np.testing.assert_array_equal(g, w)


def _same(build, data, layout, args=(), iters=1):
    _bit_equal(*_run(build, data, layout, args, iters))


# ------------------------------------------------------------------ the C++ against dali_tpu's


def _c_cases():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (27, 35, 3), dtype=np.uint8)
    f = rng.uniform(-10, 300, (23, 31, 3)).astype(np.float32)
    k2 = rng.uniform(-1, 1, (4, 5)).astype(np.float32)
    ky, kx = rng.uniform(-1, 1, 7).astype(np.float32), rng.uniform(-1, 1, 4).astype(np.float32)
    mos = rng.integers(0, 65536, (22, 30), dtype=np.uint16)
    cases = {
        "median_k3": ("median_blur_u8", (img, 3)),
        "median_k7_gray": ("median_blur_u8", (img[..., 0], 7)),
        "morph_dilate": ("morph_u8", (img, 3, 5, -1, -1, 1, True, False)),
        "morph_erode_anchor_iter": ("morph_u8", (img, 4, 2, 0, 1, 3, False, True)),
        "clahe": ("clahe_f32", (f[..., 0].clip(0, 255), 2.5, 4, 3, 256)),
        "clahe_bins64": ("clahe_f32", (f[..., 1].clip(0, 255), 40.0, 8, 8, 64)),
        "debayer_u8": ("debayer_bilinear", (mos.astype(np.uint8), 0, 1)),
        "debayer_u16": ("debayer_bilinear", (mos, 1, 1)),
        "sep_conv": ("sep_conv_f32", (f, ky, kx)),
        "sep_conv_gray": ("sep_conv_f32", (f[..., 0], kx, ky)),
    }
    for b in ("reflect_101", "reflect", "replicate", "wrap", "constant"):
        cases[f"sep_conv_{b}"] = ("sep_conv_f32", (f, ky, kx, b, 2.5, 1, 3))
        cases[f"filter2d_{b}"] = ("filter2d_f32", (f, k2, b, -3.0))
        cases[f"filter2d_{b}_anchor"] = ("filter2d_f32", (f[:3, :2], k2, b, 7.0, 3, 0))
    return cases


C_CASES = _c_cases()


@pytest.mark.parametrize("case", sorted(C_CASES))
def test_host_ops_cpp_equals_dali_tpu(case):
    name, args = C_CASES[case]
    got = getattr(native, name)(*args)
    want = getattr(ref_native, name)(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ GaussianBlur, Laplacian, Filter


GB_CASES = {
    "sigma": lambda fn, t, x: fn.gaussian_blur(x, sigma=1.4),
    "window": lambda fn, t, x: fn.gaussian_blur(x, window_size=5),
    "both_float_out": lambda fn, t, x: fn.gaussian_blur(x, sigma=0.7, window_size=7,
                                                        dtype=t.FLOAT),
    "default": lambda fn, t, x: fn.gaussian_blur(x),
}


@pytest.mark.parametrize("case", sorted(GB_CASES))
@pytest.mark.parametrize("data", ["rgb", "gray", "u16", "float"])
def test_gaussian_blur_cpu_bit_equal(case, data):
    _same(GB_CASES[case], {"rgb": IMGS, "gray": GRAY, "u16": U16, "float": FLOATS}[data], "HWC")


def test_gaussian_blur_cpu_per_sample_sigma_sequences_and_volumes():
    _same(lambda fn, t, x, s: fn.gaussian_blur(x, sigma=s), IMGS, "HWC", (SIGMAS,))
    _same(lambda fn, t, x, s: fn.gaussian_blur(x, sigma=s), SEQS, "FHWC", (SIGMAS,))
    _same(lambda fn, t, x: fn.gaussian_blur(x, sigma=[0.8, 1.5, 0.6], dtype=t.FLOAT), VOLS,
          "DHWC")
    _same(lambda fn, t, x: fn.gaussian_blur(x, window_size=[3, 5, 7]), VOLS, "DHWC")


LAP_CASES = {
    "w3": dict(window_size=3),
    "w5_scale": dict(window_size=5, scale=0.25),
    "w7_normalized": dict(window_size=7, normalized_kernel=True),
    "u8_out": dict(window_size=3, dtype="UINT8"),
    "i16_out": dict(window_size=5, dtype="INT16"),
}


@pytest.mark.parametrize("case", sorted(LAP_CASES))
@pytest.mark.parametrize("data,layout", [(IMGS, "HWC"), (FLOATS, "HWC"), (SEQS, "FHWC"),
                                         (VOLS, "DHWC")], ids=["rgb", "float", "fhwc", "dhwc"])
def test_laplacian_cpu_bit_equal(case, data, layout):
    def build(fn, t, x):
        kw = dict(LAP_CASES[case])
        if "dtype" in kw:
            kw["dtype"] = getattr(t, kw["dtype"])
        return fn.laplacian(x, **kw)

    _same(build, data, layout)


KERNELS = [RNG.uniform(-1, 1, (int(RNG.integers(1, 6)), int(RNG.integers(1, 6))))
           .astype(np.float32) for _ in range(N)]
FILLS = [np.float32(v) for v in (0.0, 12.5, -3.0, 255.0, 7.0)]
FILTER_CASES = {
    "default": dict(),
    "reflect": dict(border="reflect"),
    "replicate": dict(border="replicate"),
    "wrap": dict(border="wrap"),
    "constant_fill": dict(border="constant", fill_value=40.0),
    "anchor": dict(anchor=[0, 0]),
    "valid": dict(mode="valid"),
    "float_out": dict(dtype="FLOAT"),
}


@pytest.mark.parametrize("case", sorted(FILTER_CASES))
@pytest.mark.parametrize("data", ["rgb", "float"])
def test_filter_cpu_bit_equal(case, data):
    def build(fn, t, x, k):
        kw = dict(FILTER_CASES[case])
        if "dtype" in kw:
            kw["dtype"] = getattr(t, kw["dtype"])
        return fn.experimental.filter(x, k, **kw)

    _same(build, IMGS if data == "rgb" else FLOATS, "HWC", (KERNELS,))


def test_filter_cpu_fill_input_and_legacy_name():
    _same(lambda fn, t, x, k, f: fn.experimental.filter(x, k, f, border="constant"), IMGS, "HWC",
          (KERNELS, FILLS))
    _same(lambda fn, t, x, k: fn.filter(x, k), GRAY, "HWC", (KERNELS,))


# ------------------------------------------------------------------ Equalize


@pytest.mark.parametrize("data,layout", [(IMGS, "HWC"), (GRAY, "HWC"), (SEQS, "FHWC")],
                         ids=["rgb", "gray", "fhwc"])
def test_equalize_cpu_bit_equal(data, layout):
    flat = [np.full((9, 11, 3), 17, np.uint8)]  # one value: the identity LUT
    _same(lambda fn, t, x: fn.experimental.equalize(x), data + flat if layout == "HWC" else data,
          layout)


# ------------------------------------------------------------------ Water, Sphere, Jitter, GridMask


DISPLACEMENTS = {
    "water": lambda fn, t, x: fn.water(x),
    "water_linear": lambda fn, t, x: fn.water(x, ampl_x=4.5, ampl_y=7.0, freq_x=0.1,
                                              phase_y=0.7, fill_value=33.0,
                                              interp_type=t.INTERP_LINEAR),
    "sphere": lambda fn, t, x: fn.sphere(x, fill_value=9.0),
    "sphere_linear": lambda fn, t, x: fn.sphere(x, interp_type=t.INTERP_LINEAR),
    "jitter": lambda fn, t, x: fn.jitter(x, nDegree=3, seed=17),
    "jitter_linear": lambda fn, t, x: fn.jitter(x, nDegree=4, fill_value=5.0,
                                                interp_type=t.INTERP_LINEAR),
    "grid_mask": lambda fn, t, x: fn.grid_mask(x, tile=16, ratio=0.4, angle=0.3),
    "grid_mask_shift": lambda fn, t, x: fn.grid_mask(x, tile=7, ratio=0.6, shift_x=2.5,
                                                     shift_y=-1.0),
}


@pytest.mark.parametrize("case", sorted(DISPLACEMENTS))
@pytest.mark.parametrize("data", ["rgb", "float"])
def test_displacement_and_grid_mask_cpu_bit_equal(case, data):
    _same(DISPLACEMENTS[case], IMGS if data == "rgb" else FLOATS, "HWC", iters=2)


def test_displacement_mask_and_grid_mask_tensor_arguments():
    for op in ("water", "sphere", "jitter"):
        _same(lambda fn, t, x, m, op=op: getattr(fn, op)(x, mask=m), IMGS, "HWC", (FLAGS,),
              iters=2)
    tiles = [np.int32(v) for v in (8, 12, 20, 9, 31)]
    angles = [np.float32(v) for v in (0.0, 0.5, -1.0, 2.0, 0.25)]
    _same(lambda fn, t, x, tl, a: fn.grid_mask(x, tile=tl, angle=a, ratio=0.3), IMGS, "HWC",
          (tiles, angles))


# ------------------------------------------------------------------ MedianBlur, Dilate, Erode


MORPH_CASES = {
    "default": dict(),
    "wide": dict(mask_size=[5, 3]),
    "anchor": dict(mask_size=[4, 4], anchor=[0, 3]),
    "iterations": dict(iterations=3),
    "replicate": dict(border_mode="replicate", mask_size=[3, 7]),
}


@pytest.mark.parametrize("case", sorted(MORPH_CASES))
@pytest.mark.parametrize("op", ["dilate", "erode"])
@pytest.mark.parametrize("data", ["rgb", "gray"])
def test_morphology_cpu_uint8_bit_equal(case, op, data):
    _same(lambda fn, t, x: getattr(fn.experimental, op)(x, **MORPH_CASES[case]),
          IMGS if data == "rgb" else GRAY, "HWC")


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("data", ["rgb", "gray"])
def test_median_blur_cpu_uint8_bit_equal(k, data):
    _same(lambda fn, t, x: fn.experimental.median_blur(x, window_size=k),
          IMGS if data == "rgb" else GRAY, "HWC")


# ------------------------------------------------------------------ Clahe, Debayer


CLAHE_CASES = {
    "default": dict(),
    "per_channel": dict(luma_only=False),
    "tiles_clip": dict(tiles_x=3, tiles_y=5, clip_limit=1.5),
    "bins": dict(bins=64, clip_limit=10.0),
}


@pytest.mark.parametrize("case", sorted(CLAHE_CASES))
@pytest.mark.parametrize("data", ["rgb", "gray", "u16", "float"])
def test_clahe_cpu_bit_equal(case, data):
    src = {"rgb": IMGS, "gray": GRAY, "u16": [(u >> 8).astype(np.uint16) for u in U16],
           "float": [f.clip(0, 255) for f in FLOATS]}[data]
    _same(lambda fn, t, x: fn.experimental.clahe(x, **CLAHE_CASES[case]), src, "HWC")


@pytest.mark.parametrize("bp", [(0, 0), (0, 1), (1, 0), (1, 1)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_debayer_bilinear_cpu_bit_equal(bp, dtype):
    data = [(m.astype(dtype) * (257 if dtype == np.uint16 else 1)) for m in MOSAICS]
    _same(lambda fn, t, x: fn.experimental.debayer(x, blue_position=list(bp)), data, "HW")
    _same(lambda fn, t, x: fn.debayer(x, blue_position=list(bp)), [d[..., None] for d in data],
          "HWC")


# ------------------------------------------------------------------ MultiPaste, DumpImage


def _mp_args():
    ids = [np.array([1, 0, 3], np.int32), np.array([4], np.int32), np.array([2, 2], np.int32),
           np.array([0, 1, 2, 3], np.int32), np.array([3], np.int32)]
    k = [len(i) for i in ids]
    anchors = [RNG.integers(0, 12, (n, 2)).astype(np.int32) for n in k]
    shapes = [RNG.integers(4, 20, (n, 2)).astype(np.int32) for n in k]
    outs = [RNG.integers(0, 20, (n, 2)).astype(np.int32) for n in k]
    rel = [RNG.uniform(0, 0.6, (n, 2)).astype(np.float32) for n in k]
    sizes = [np.array([30 + i, 26 - i], np.int32) for i in range(N)]
    return ids, anchors, shapes, outs, rel, sizes


MP_IDS, MP_ANCHORS, MP_SHAPES, MP_OUTS, MP_REL, MP_SIZES = _mp_args()


def test_multipaste_cpu_bit_equal():
    _same(lambda fn, t, x, i: fn.multi_paste(x, in_ids=i), IMGS, "HWC", (MP_IDS,))
    _same(lambda fn, t, x, i, a, s, o, sz: fn.multi_paste(x, in_ids=i, in_anchors=a, shapes=s,
                                                          out_anchors=o, output_size=sz),
          IMGS, "HWC", (MP_IDS, MP_ANCHORS, MP_SHAPES, MP_OUTS, MP_SIZES))
    _same(lambda fn, t, x, i, r, o: fn.multi_paste(x, in_ids=i, in_anchors_rel=r, shapes_rel=r,
                                                   out_anchors_rel=r, output_size=o),
          FLOATS, "HWC", (MP_IDS, MP_REL, MP_SIZES))


def test_multipaste_cpu_refuses_dtype():
    with pytest.raises(NotImplementedError, match="Queue 3"):
        _run(lambda fn, t, x, i: fn.multi_paste(x, in_ids=i, dtype=t.FLOAT), IMGS, "HWC",
             (MP_IDS,))


@pytest.mark.parametrize("pkg", [dali_tpu_torch, dali_tpu], ids=["port", "reference"])
def test_multipaste_cpu_negative_out_anchor_fails_in_both(pkg):
    """A region pasted at a negative anchor: numpy's slice starts from the
    end and the copy fails, in both packages (ROADMAP.md Queue 3)."""
    kw = {"device": "cpu"} if pkg is dali_tpu_torch else {"debug": True}

    @pkg.pipeline_def(batch_size=2, num_threads=1, **kw)
    def p():
        x = pkg.fn.external_source(source=lambda: IMGS[:2], batch=True, layout="HWC")
        i = pkg.fn.external_source(source=lambda: [np.array([1], np.int32)] * 2, batch=True)
        o = pkg.fn.external_source(source=lambda: [np.array([-2, 3], np.int32)] * 2, batch=True)
        return pkg.fn.multi_paste(x, in_ids=i, out_anchors=o)

    pipe = p()
    pipe.build()
    try:
        with pytest.raises(ValueError, match="broadcast"):
            pipe.run()
    finally:
        (pipe.shutdown if pkg is dali_tpu_torch else pipe._executor.shutdown)()


@pytest.mark.parametrize("data,layout,suffix", [
    (IMGS, "HWC", ""), (GRAY, "HWC", "g"), (U16, "HWC", "u16"),
    ([np.ascontiguousarray(im.transpose(2, 0, 1)) for im in IMGS], "CHW", "chw")],
    ids=["rgb", "gray", "u16", "chw"])
def test_dump_image_files_and_pixels(tmp_path, monkeypatch, data, layout, suffix):
    """The same files in each package's run (names from the iteration and
    the sample, in the working directory), each decoding to the sample's
    pixels through the port's decoder and through cv2; both pass the input
    through."""
    got_dir, want_dir = tmp_path / "port", tmp_path / "ref"
    got_dir.mkdir()
    want_dir.mkdir()
    monkeypatch.chdir(got_dir)
    res = []
    for pkg, kw, d in ((dali_tpu_torch, {"device": "cpu"}, got_dir),
                       (dali_tpu, {"debug": True}, want_dir)):
        monkeypatch.chdir(d)

        @pkg.pipeline_def(batch_size=N, num_threads=1, seed=3, prefetch_queue_depth=1, **kw)
        def p():
            x = pkg.fn.external_source(source=lambda: data, batch=True, layout=layout)
            return pkg.fn.dump_image(x, suffix=suffix)

        pipe = p()
        pipe.build()
        try:
            res.append([[np.asarray(o.at(i)) for i in range(N)] for o in pipe.run()
                        for _ in range(1)])
            pipe.run()
        finally:
            (pipe.shutdown if pkg is dali_tpu_torch else pipe._executor.shutdown)()
    for g, w, s in zip(res[0][0], res[1][0], data):
        np.testing.assert_array_equal(g, s)
        np.testing.assert_array_equal(w, s)
    names = sorted(os.listdir(got_dir))
    assert names == sorted(os.listdir(want_dir)) and len(names) == 2 * N
    for name in names:
        i = int(name.split("_")[2].split(".")[0])
        s = data[i].transpose(1, 2, 0) if layout == "CHW" else data[i]
        raw = (got_dir / name).read_bytes()
        want = cv2.imread(str(want_dir / name), cv2.IMREAD_UNCHANGED)
        mine = cv2.imread(str(got_dir / name), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(mine, want)
        np.testing.assert_array_equal(mine.reshape(s.shape[:2] + (-1,))[..., ::-1]
                                      if s.shape[2] == 3 else mine.reshape(s.shape), s)
        dec, _ = imgcodec.decode_png(raw, gray=s.shape[2] == 1)
        np.testing.assert_array_equal(dec, s)


# ------------------------------------------------------------------ TensorResize


TR_CASES = {
    "sizes": dict(sizes=[20.0, 31.0], axes=[0, 1]),
    "scales_nn": dict(scales=[0.5, 1.7], axes=[0, 1], interp_type="INTERP_NN"),
    "axis_names": dict(sizes=[17.0], axis_names="W"),
    "not_larger": dict(sizes=[25.0, 25.0], axes=[0, 1], mode="not_larger"),
    "not_smaller_ceil": dict(sizes=[25.0, 20.0], axes=[0, 1], mode="not_smaller",
                             size_rounding="ceil"),
    "roi": dict(sizes=[16.0, 16.0], axes=[0, 1], roi_start=[2.0, 3.0], roi_end=[15.0, 17.0]),
    "roi_relative": dict(scales=[1.5, 0.75], axes=[0, 1], roi_start=[0.1, 0.2],
                         roi_end=[0.9, 0.7], roi_relative=True),
    "float_out": dict(sizes=[12.0, 10.0, 2.0], dtype="FLOAT"),
}


@pytest.mark.parametrize("case", sorted(TR_CASES))
@pytest.mark.parametrize("data", ["rgb", "float"])
def test_tensor_resize_cpu_bit_equal(case, data):
    def build(fn, t, x):
        kw = dict(TR_CASES[case])
        for k in ("interp_type", "dtype"):
            if k in kw:
                kw[k] = getattr(t, kw[k]) if k == "dtype" else t.DALIInterpType[kw[k]]
        return fn.tensor_resize(x, **kw), fn.experimental.tensor_resize(x, **kw)

    _same(build, IMGS if data == "rgb" else FLOATS, "HWC")


def test_tensor_resize_cpu_per_sample_sizes_and_refusals():
    sizes = [np.array([10 + 3 * i, 30 - 2 * i], np.float32) for i in range(N)]
    _same(lambda fn, t, x, s: fn.tensor_resize(x, sizes=s, axes=[0, 1]), IMGS, "HWC", (sizes,))
    with pytest.raises(NotImplementedError, match="subpixel_scale"):
        _run(lambda fn, t, x: fn.tensor_resize(x, sizes=[9.0, 9.0], axes=[0, 1],
                                               subpixel_scale=False), IMGS, "HWC")


# ------------------------------------------------------------------ ResizeCropMirror


RCM_CASES = {
    "crop": dict(resize_shorter=30.0, crop=[20, 24]),
    "crop_pos_mirror": dict(resize_x=40.0, resize_y=36.0, crop=[24, 18], crop_pos_x=0.1,
                            crop_pos_y=0.9, mirror=1),
    "no_crop": dict(resize_x=33.0, resize_y=21.0),
    "roi": dict(resize_shorter=26.0, crop=[16, 16], roi_start=[3.0, 4.0], roi_end=[17.0, 21.0]),
    "roi_relative_truncate": dict(resize_longer=40.0, crop=[14, 12], roi_start=[0.1, 0.2],
                                  roi_end=[0.8, 0.9], roi_relative=True, rounding="truncate"),
    "cubic_float_out": dict(resize_shorter=50.0, crop=[30, 30], interp_type="INTERP_CUBIC",
                            dtype="FLOAT"),
    "filters_no_antialias": dict(resize_shorter=12.0, crop=[10, 10], antialias=False,
                                 min_filter="INTERP_LANCZOS3", mag_filter="INTERP_NN"),
}


@pytest.mark.parametrize("case", sorted(RCM_CASES))
@pytest.mark.parametrize("op", ["resize_crop_mirror", "fast_resize_crop_mirror"])
def test_resize_crop_mirror_cpu_bit_equal(case, op):
    def build(fn, t, x):
        kw = dict(RCM_CASES[case])
        for k in ("interp_type", "min_filter", "mag_filter"):
            if k in kw:
                kw[k] = t.DALIInterpType[kw[k]]
        if "dtype" in kw:
            kw["dtype"] = getattr(t, kw["dtype"])
        return getattr(fn, op)(x, **kw)

    _same(build, IMGS, "HWC")


@pytest.mark.parametrize("arg", [dict(subpixel_scale=False), dict(resize_z=4.0),
                                 dict(crop_d=2.0), dict(crop_pos_z=0.1)],
                         ids=["subpixel_scale", "resize_z", "crop_d", "crop_pos_z"])
def test_resize_crop_mirror_cpu_refuses_what_the_reference_never_reads(arg):
    with pytest.raises(NotImplementedError, match=next(iter(arg))):
        _run(lambda fn, t, x: fn.resize_crop_mirror(x, resize_shorter=20.0, crop=[10, 10],
                                                    **arg), IMGS, "HWC")


def test_resize_crop_mirror_cpu_per_sample_arguments():
    ch = [np.float32(v) for v in (12, 20, 16, 9, 22)]
    pos = [np.float32(v) for v in (0.0, 0.3, 1.0, 0.5, 0.7)]
    _same(lambda fn, t, x, h, p, m: fn.resize_crop_mirror(x, resize_shorter=28.0, crop_h=h,
                                                          crop_w=h, crop_pos_x=p, mirror=m),
          IMGS, "HWC", (ch, pos, FLAGS))
    _same(lambda fn, t, x: fn.resize_crop_mirror(x, resize_shorter=25.0, crop=[20, 20]), FLOATS,
          "HWC")


# ------------------------------------------------------------------ host against device placements


@pytest.mark.parametrize("name", sorted(set(bench_dali_cpu.PLACEMENT_BOUNDS)
                                        - {"experimental.Filter", "MultiPaste"}))
def test_dali_tpu_placements_agree_within_bound(name):
    """dali_tpu's cpu and gpu placements of each op (``debug=True``, one
    sample size: its gpu Debayer normalizes over the padded canvas of a
    ragged batch) within the bound the card check holds the port's to. Its
    Filter is left out (its placements disagree on the border, ROADMAP.md
    Queue 3), and so is MultiPaste, whose gpu lowering fails under
    ``debug=True``."""
    pairs = bench_dali_cpu.placement_pairs(dali_tpu, None, names=[name], ragged=False,
                                           debug=True)
    bench_dali_cpu.check_placements(pairs)


@pytest.mark.parametrize("name", sorted(bench_dali_cpu.PLACEMENT_BOUNDS))
def test_port_placements_agree_within_bound(name):
    """The port's two placements of each op on the CPU (its device stage in
    plain torch), within the same bound."""
    pairs = bench_dali_cpu.placement_pairs(dali_tpu_torch, "cpu", names=[name])
    bench_dali_cpu.check_placements(pairs)


# ------------------------------------------------------------------ augmentation_gallery.py


def test_augmentation_gallery_runs_whole_and_equals_dali_tpu():
    """Every output of docs/examples/augmentation_gallery.py on the host, op
    by op, bit-equal to dali_tpu's (its random ops draw from the same host
    streams)."""
    got, want = (_run_example("augmentation_gallery.py", pkg) for pkg in (dali_tpu_torch,
                                                                         dali_tpu))
    assert len(got) == len(want) == 1 and len(got[0]) == 18
    for g_out, w_out in zip(got[0], want[0]):
        for g, w in zip(g_out, w_out):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_host_code_imports_no_cv2():
    """The port's host image code calls no cv2: no module imports it, the C++
    includes none of OpenCV's headers, and a pipeline of the ops whose
    reference calls cv2 runs in a fresh interpreter without loading it."""
    import re
    import subprocess
    import sys

    import dali_tpu_torch.backend as backend

    root = os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))
    files = [os.path.join(os.path.dirname(backend.__file__), f) for f in (
        "convolution.py", "distortion.py", "enhance.py", "enhance2.py", "misc.py", "misc2.py",
        "parity.py", "tail.py")]
    files += [native.__file__, os.path.join(root, "tools", "bench_dali_cpu.py")]
    files += [os.path.join(root, "csrc", "host", f) for f in ("host_ops.cc", "jpeg_encode.cc",
                                                             "warp_affine.cc")]
    for path in files:
        with open(path) as f:
            src = f.read()
        assert not re.search(r"^\s*(import|from)\s+cv2\b|import_module\(.cv2|__import__\(.cv2"
                             r"|#include\s*[<\"]opencv", src, re.M), path
    code = """
import sys
import numpy as np
from dali_tpu_torch import fn, pipeline_def
rng = np.random.default_rng(0)
imgs = [rng.integers(0, 256, (20, 24, 3), np.uint8) for _ in range(2)]
maps = [np.full((20, 24), 3.5, np.float32)] * 2
@pipeline_def(batch_size=2, num_threads=1, device="cpu")
def p():
    x = fn.external_source(source=lambda: imgs, batch=True, layout="HWC")
    m = fn.external_source(source=lambda: maps, batch=True)
    return (fn.jpeg_compression_distortion(x, quality=40.0), fn.experimental.remap(x, m, m),
            fn.experimental.warp_perspective(x, matrix=[1, 0, 1, 0, 1, 2, 0, 0, 1]),
            fn.experimental.median_blur(x),
            fn.experimental.debayer(fn.external_source(source=lambda: [i[..., 0] for i in imgs],
                                                       batch=True), algorithm="edge_aware"))
pipe = p()
pipe.build()
pipe.run()
pipe.shutdown()
assert "cv2" not in sys.modules
"""
    subprocess.run([sys.executable, "-c", code], check=True, cwd=os.path.dirname(root),
                   env=dict(os.environ, PYTHONPATH=os.path.dirname(root)))


# ------------------------------------------------------------------ rn50_host_augment


@pytest.mark.parametrize("cmn_cpu", [False, True], ids=["cmn_gpu", "cmn_cpu"])
def test_rn50_host_augment_path_matches_dali_tpu(tmp_path, cmn_cpu):
    """The --dali-cpu recipe with the host JPEG round trip, Gaussian blur and
    equalization (``tools/bench_dali_cpu.py`` ``host_augment``) at batch 4 and
    64 px, two iterations: every host op bit-equal (their qualities and
    sigmas drawn from the same host streams), so labels equal and the
    normalised images within 1e-5 (the device CMN against the reference's
    lowering) or equal (CMN on the host)."""
    corpus = os.path.join(os.path.dirname(__file__), "..", "dali_tpu_torch", "testdata", "rn50")
    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(corpus) for f in fs)
    file_list = tmp_path / "list.txt"
    file_list.write_text("".join(f"{f} {i % 3}\n" for i, f in enumerate(files[:12])))
    res = []
    for pkg, kw in ((dali_tpu_torch, {"device": "cpu"}), (dali_tpu, {"debug": True})):
        @pkg.pipeline_def(batch_size=4, num_threads=2, seed=42, **kw)
        def p():
            return bench_dali_cpu.rn50_dali_cpu_graph(pkg.fn, pkg.types, str(file_list), size=64,
                                                      cmn_cpu=cmn_cpu, augment=True)

        pipe = p()
        pipe.build()
        try:
            res.append([[np.asarray(o.as_tensor().cpu() if hasattr(o.as_tensor(), "cpu")
                                    else o.as_tensor()) for o in pipe.run()] for _ in range(2)])
        finally:
            (pipe.shutdown if pkg is dali_tpu_torch else pipe._executor.shutdown)()
    for (g_img, g_lab), (w_img, w_lab) in zip(*res):
        np.testing.assert_array_equal(g_lab, w_lab)
        assert g_img.shape == w_img.shape == (4, 3, 64, 64) and g_img.dtype == w_img.dtype
        np.testing.assert_allclose(g_img, w_img, atol=0 if cmn_cpu else 1e-5, rtol=0)
