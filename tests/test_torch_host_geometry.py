"""The host (cpu) geometry and colour operators of dali_tpu_torch against
dali_tpu, on the CPU: Resize and RandomResizedCrop through the numpy
resampler, Flip, WarpAffine and Rotate, Transpose, Pad, Erase and Paste,
the eight colour operators, and the graphs of docs/examples/serialization.py,
transforms_3d.py and audio_processing.py run whole.

Every host operator of the reference is numpy or cv2, so every output here
is bit-equal (equal dtype, shape and values, and equal layouts). Inputs are
seeded numpy batches fed through ``fn.external_source``; the reference runs
with ``debug=True``. The 2-D warps, where the reference calls
``cv2.warpAffine``, run the port's C++ (``native.warp_affine``), held here
against cv2 5.0 directly as well, over translate, rotate, shear and scale
matrices, fill values, uint8 and float32 (and the other types cv2 takes),
nearest and linear interpolation. The one float tolerance is the examples'
device MFCC (the reference's XLA against torch; 1e-3 as the ASR tests, plus
1e-6 of the clip's largest coefficient, which reaches 6400: each coefficient
sums 40 dB values).
"""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch
from dali_tpu.kernels import resample as ref_resample
from dali_tpu_torch import native
from dali_tpu_torch.kernels import host_resample
from dali_tpu_torch.types import DALIInterpType

N = 5
RNG = np.random.default_rng(2024)
IMGS = [RNG.integers(0, 256, (int(RNG.integers(24, 60)), int(RNG.integers(24, 60)), 3),
                     dtype=np.uint8) for _ in range(N)]
FLOATS = [RNG.uniform(-50, 300, (int(RNG.integers(16, 40)), int(RNG.integers(16, 40)), 3))
          .astype(np.float32) for _ in range(N)]
GRAY = [im[..., :1].copy() for im in IMGS]
VOLS = [RNG.integers(0, 256, (int(RNG.integers(5, 9)), 20, 24, 1), dtype=np.uint8)
        for _ in range(N)]
SEQS = [RNG.integers(0, 256, (3, 18, 22, 3), dtype=np.uint8) for _ in range(N)]
ANGLES = [np.float32(a) for a in (-33.5, 12.0, 90.0, 170.25, 0.0)]
FLAGS = [np.int32(f) for f in (1, 0, 1, 1, 0)]
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "docs", "examples")


def _run(build, data, layout, args=(), iters=1):
    """The same host graph in both packages: ``build(fn, types, x, *args)``
    with ``x`` the batch and ``args`` per-sample argument batches. Returns
    (port, reference), each a list per iteration of (outputs as lists of
    arrays, layouts)."""
    res = []
    for pkg, kw in ((dali_tpu_torch, {"device": "cpu"}), (dali_tpu, {"debug": True})):
        @pkg.pipeline_def(batch_size=len(data), num_threads=2, seed=11, **kw)
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


# ------------------------------------------------------------------ the resampler


@pytest.mark.parametrize("interp", ["INTERP_NN", "INTERP_LINEAR", "INTERP_TRIANGULAR",
                                    "INTERP_CUBIC", "INTERP_GAUSSIAN", "INTERP_LANCZOS3"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_host_resample_bit_equal(interp, dtype):
    rng = np.random.default_rng(3)
    img = (rng.integers(0, 256, (37, 45, 3)) if dtype == np.uint8
           else rng.uniform(-1, 2, (37, 45, 3))).astype(dtype)
    it = DALIInterpType[interp]
    for oh, ow, aa, roi in ((20, 61, True, None), (50, 17, False, None),
                            (24, 24, True, ((3.5, 2.0), (20.0, 31.5)))):
        kw = {} if roi is None else {"roi_start": roi[0], "roi_size": roi[1]}
        got = host_resample.host_resample(img, oh, ow, it, aa, **kw)
        want = ref_resample.host_resample(img, oh, ow, it, aa, **kw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ Resize and RandomResizedCrop


RESIZE_CASES = {
    "xy": dict(resize_x=31, resize_y=20),
    "shorter": dict(resize_shorter=30),
    "longer_max": dict(resize_longer=70, max_size=[48, 60]),
    "not_larger": dict(resize_x=40, resize_y=40, mode="not_larger"),
    "not_smaller_cubic": dict(resize_x=40, resize_y=22, mode="not_smaller",
                              interp_type="INTERP_CUBIC"),
    "size_nn": dict(size=[33, 17], interp_type="INTERP_NN"),
    "filters": dict(resize_shorter=40, min_filter="INTERP_TRIANGULAR",
                    mag_filter="INTERP_LANCZOS3", antialias=False),
    "save_attrs": dict(resize_x=16, resize_y=24, save_attrs=True),
}


def _conv(types, kw):
    out = {}
    for k, v in kw.items():
        if k in ("interp_type", "min_filter", "mag_filter"):
            v = types.DALIInterpType[v]
        out[k] = v
    return out


@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
def test_resize_cpu_bit_equal(case):
    kw = RESIZE_CASES[case]
    _same(lambda fn, types, x: fn.resize(x, **_conv(types, kw)), IMGS, "HWC")


def test_resize_cpu_floats_gray_and_per_sample_sizes():
    sizes = [np.float32(v) for v in (17, 40, 25, 33, 60)]
    _same(lambda fn, types, x, s: fn.resize(x, resize_shorter=s), IMGS, "HWC", (sizes,))
    _same(lambda fn, types, x: fn.resize(x, resize_x=30, resize_y=19), FLOATS, "HWC")
    _same(lambda fn, types, x: fn.experimental.resize(x, resize_x=21, resize_y=35), GRAY, "HWC")


@pytest.mark.parametrize("kw", [dict(size=[10, 12, 14]), dict(resize_x=12, resize_y=30,
                                                              resize_z=4, save_attrs=True)],
                         ids=["size", "xyz"])
def test_resize_cpu_volumes(kw):
    """DHWC volumes of per-sample depths: each slice in float, the depth
    pass, one quantization (what dali_tpu runs only on the cpu)."""
    _same(lambda fn, types, x: fn.resize(x, **kw), VOLS, "DHWC")


def test_resize_cpu_per_sample_volume_sizes():
    sizes = [np.array([4 + i, 10, 16 - i], np.float32) for i in range(N)]
    _same(lambda fn, types, x, s: fn.resize(x, size=s), VOLS, "DHWC", (sizes,))


@pytest.mark.parametrize("kw", [
    dict(size=[24, 24]),
    dict(size=[32, 20], random_area=[0.3, 0.6], random_aspect_ratio=[0.5, 2.0], num_attempts=4),
    dict(size=[40, 40], interp_type="INTERP_CUBIC", antialias=False),
    dict(size=[16], min_filter="INTERP_TRIANGULAR", mag_filter="INTERP_NN", seed=3),
], ids=["default", "ranges", "cubic", "filters"])
def test_random_resized_crop_cpu_bit_equal(kw):
    _same(lambda fn, types, x: fn.random_resized_crop(x, **_conv(types, kw)), IMGS, "HWC",
          iters=2)


# ------------------------------------------------------------------ Flip


@pytest.mark.parametrize("data,layout", [(IMGS, "HWC"), (VOLS, "DHWC"), (SEQS, "FHWC")],
                         ids=["hwc", "dhwc", "fhwc"])
def test_flip_cpu_bit_equal(data, layout):
    _same(lambda fn, types, x, f: (fn.flip(x, horizontal=f, vertical=1),
                                   fn.flip(x, horizontal=0, vertical=f)), data, layout, (FLAGS,))
    if layout == "DHWC":
        _same(lambda fn, types, x, f: fn.flip(x, depthwise=f, horizontal=0), data, layout,
              (FLAGS,))


# ------------------------------------------------------------------ warps


def _matrices():
    rng = np.random.default_rng(8)
    out = {"identity": np.eye(2, 3, dtype=np.float32),
           "translate": np.array([[1, 0, 3.25], [0, 1, -4.5]], np.float32),
           "scale": np.array([[0.5, 0, 0.25], [0, 1.5, 0.5]], np.float32)}
    for k in range(3):
        a = np.deg2rad(rng.uniform(-180, 180))
        s = rng.uniform(0.6, 1.7)
        out[f"rotate{k}"] = np.array([[np.cos(a) * s, -np.sin(a) * s, rng.uniform(-20, 20)],
                                      [np.sin(a) * s, np.cos(a) * s, rng.uniform(-20, 20)]],
                                     np.float32)
        out[f"shear{k}"] = np.array([[1, rng.uniform(-0.6, 0.6), rng.uniform(-5, 5)],
                                     [rng.uniform(-0.6, 0.6), 1, rng.uniform(-5, 5)]], np.float32)
    return out


MATRICES = _matrices()


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.uint16, np.int16, np.float64])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_native_warp_affine_equals_cv2(dtype, channels):
    """OpenCV's two routes: floats for 8/16-bit unsigned and float32 images
    of 1, 3 or 4 channels (a SIMD body in blocks of 16 columns and a scalar
    tail), fixed point for the rest; the output sizes cover both."""
    rng = np.random.default_rng(channels)
    for name, m in MATRICES.items():
        for nearest in (False, True):
            for fill in (0.0, 7.5, 300.0):
                h, w = int(rng.integers(9, 70)), int(rng.integers(9, 70))
                if np.issubdtype(dtype, np.floating):
                    img = rng.uniform(-100, 300, (h, w, channels)).astype(dtype)
                else:
                    info = np.iinfo(dtype)
                    img = rng.integers(info.min, int(info.max) + 1, (h, w, channels)).astype(dtype)
                oh, ow = int(rng.integers(9, 80)), int(rng.integers(9, 80))
                want = cv2.warpAffine(
                    img if channels > 1 else img[..., 0], m, (ow, oh),
                    flags=(cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR)
                    | cv2.WARP_INVERSE_MAP, borderMode=cv2.BORDER_CONSTANT,
                    borderValue=(fill,) * 4)
                got = native.warp_affine(img, m, oh, ow, nearest, fill)
                np.testing.assert_array_equal(got, want.reshape(got.shape),
                                              err_msg=f"{name} nearest={nearest} fill={fill}")


def test_native_warp_affine_refuses_what_cv2_refuses():
    img = np.zeros((8, 8, 1), np.int8)
    with pytest.raises(cv2.error):
        cv2.warpAffine(img[..., 0], MATRICES["identity"], (8, 8), flags=cv2.INTER_LINEAR)
    with pytest.raises(ValueError, match="linear interpolation of int8"):
        native.warp_affine(img, MATRICES["identity"], 8, 8, False, 0.0)
    np.testing.assert_array_equal(native.warp_affine(img, MATRICES["identity"], 8, 8, True, 0),
                                  img)


@pytest.mark.parametrize("interp", ["INTERP_LINEAR", "INTERP_NN"])
@pytest.mark.parametrize("data", ["uint8", "float32"])
def test_warp_affine_cpu_bit_equal(interp, data):
    imgs = IMGS if data == "uint8" else FLOATS
    mats = [MATRICES[k].reshape(-1) for k in ("rotate0", "shear1", "scale", "translate",
                                              "rotate2")]

    def build(fn, types, x, m):
        it = types.DALIInterpType[interp]
        return (fn.warp_affine(x, matrix=m, interp_type=it, fill_value=12.0),
                fn.warp_affine(x, m, size=[30, 41], interp_type=it),
                fn.warp_affine(x, matrix=m, inverse_map=False, interp_type=it),
                fn.warp_affine(x, matrix=MATRICES["rotate1"].reshape(-1).tolist(),
                               interp_type=it))

    _same(build, imgs, "HWC", (mats,))


def test_warp_affine_cpu_sequences_and_volumes():
    mats = [MATRICES["rotate1"].reshape(-1)] * N
    _same(lambda fn, types, x, m: fn.warp_affine(x, matrix=m, fill_value=3.0), SEQS, "FHWC",
          (mats,))
    vol_m = [1.0, 0.1, 0.0, -1.5, 0.0, 1.0, 0.2, 0.5, 0.05, 0.0, 1.0, 0.25]
    for interp in ("INTERP_LINEAR", "INTERP_NN"):
        _same(lambda fn, types, x: fn.warp_affine(
            x, matrix=vol_m, size=[6, 18, 20], interp_type=types.DALIInterpType[interp],
            fill_value=9.0), VOLS, "DHWC")


@pytest.mark.parametrize("data", ["uint8", "float32", "gray"])
def test_rotate_cpu_bit_equal(data):
    imgs = {"uint8": IMGS, "float32": FLOATS, "gray": GRAY}[data]

    def build(fn, types, x, a):
        return (fn.rotate(x, angle=a), fn.rotate(x, angle=a, keep_size=True, fill_value=40.0),
                fn.rotate(x, angle=a, size=[20, 36], interp_type=types.INTERP_NN),
                fn.rotate(x, angle=30.0))

    _same(build, imgs, "HWC", (ANGLES,), iters=2)


def test_rotate_cpu_sequences_and_volumes():
    _same(lambda fn, types, x, a: fn.rotate(x, angle=a, keep_size=True), SEQS, "FHWC",
          (ANGLES,))
    _same(lambda fn, types, x, a: (fn.rotate(x, angle=a, axis=[0.0, 0.0, 1.0]),
                                   fn.rotate(x, angle=a, axis=[1.0, 0.5, 0.0], size=[6, 16, 18],
                                             interp_type=types.INTERP_NN)),
          VOLS, "DHWC", (ANGLES,))


def test_host_warps_raise_on_dtype():
    """dali_tpu's cpu warps keep the input's type whatever ``dtype`` says
    (ROADMAP.md Queue 3): the port raises."""
    for build in (lambda fn, types, x: fn.warp_affine(x, matrix=[1, 0, 0, 0, 1, 0],
                                                      dtype=types.FLOAT),
                  lambda fn, types, x: fn.rotate(x, angle=3.0, dtype=types.FLOAT)):
        with pytest.raises(NotImplementedError, match=r"\(cpu\): argument 'dtype'.*Queue 3"):
            _run(build, IMGS, "HWC")


# ------------------------------------------------------------------ Transpose, Pad, Erase, Paste


def test_transpose_and_pad_cpu_bit_equal():
    _same(lambda fn, types, x: (fn.transpose(x, perm=[2, 0, 1]),
                                fn.transpose(x, perm=[1, 0, 2], output_layout="WHC"),
                                fn.pad(x, fill_value=7.0),
                                fn.pad(x, axes=[0], align=[16]),
                                fn.pad(x, axis_names="HW", shape=[64, -1], fill_value=-1.0)),
          IMGS, "HWC")
    _same(lambda fn, types, x: fn.pad(x, axis_names="DHW", shape=[10, 32, 32]), VOLS, "DHWC")


def test_erase_and_paste_cpu_bit_equal():
    anchors = [np.array([2.0, 3.0, 10.0, 1.0], np.float32) * (i + 1) for i in range(N)]
    shapes = [np.array([5.0, 6.0, 4.5, 9.0], np.float32)] * N
    ratios = [np.float32(r) for r in (1.0, 1.5, 2.25, 1.1, 3.0)]
    _same(lambda fn, types, x, a, s, r: (
        fn.erase(x, anchor=a, shape=s, fill_value=[10.0, 20.0, 30.0]),
        fn.erase(x, anchor=[0.1, 0.2], shape=[0.3, 0.25], normalized=True, centered_anchor=True,
                 fill_value=255.0),
        fn.erase(x, anchor=[4.0], shape=[5.0], axis_names="W"),
        fn.paste(x, ratio=r, paste_x=0.2, paste_y=0.7, fill_value=[1.0, 2.0, 3.0]),
        fn.paste(x, ratio=1.5, min_canvas_size=80.0, n_channels=4, fill_value=[9.0] * 4)),
        IMGS, "HWC", (anchors, shapes, ratios))


# ------------------------------------------------------------------ colour


COLOUR = {
    "brightness_contrast": lambda fn, types, x, v: fn.brightness_contrast(
        x, brightness=v, brightness_shift=0.05, contrast=1.3),
    "brightness_float": lambda fn, types, x, v: fn.brightness(x, brightness=v,
                                                             dtype=types.FLOAT),
    "contrast_center": lambda fn, types, x, v: fn.contrast(x, contrast=v, contrast_center=100.0),
    "hue": lambda fn, types, x, v: fn.hue(x, hue=v * 40.0),
    "saturation": lambda fn, types, x, v: fn.saturation(x, saturation=v),
    "hsv": lambda fn, types, x, v: fn.hsv(x, hue=-25.0, saturation=v, value=1.1,
                                          dtype=types.FLOAT),
    "color_twist": lambda fn, types, x, v: fn.color_twist(x, hue=v * 20.0, saturation=1.4,
                                                          brightness=v, contrast=0.7),
    "csc": lambda fn, types, x, v: tuple(
        fn.color_space_conversion(x, image_type=getattr(types, a), output_type=getattr(types, b))
        for a, b in (("RGB", "YCbCr"), ("RGB", "GRAY"), ("BGR", "RGB"), ("YCbCr", "BGR"),
                     ("YCbCr", "GRAY"))),
}


@pytest.mark.parametrize("case", sorted(COLOUR))
@pytest.mark.parametrize("data", ["uint8", "float32"])
def test_colour_ops_cpu_bit_equal(case, data):
    imgs = IMGS if data == "uint8" else [np.clip(f / 300.0, 0, 1).astype(np.float32)
                                         for f in FLOATS]
    values = [np.float32(v) for v in (0.5, 1.0, 1.25, 0.8, 2.0)]
    _same(lambda fn, types, x, v: COLOUR[case](fn, types, x, v), imgs, "HWC", (values,))


def test_gray_to_colour_cpu_bit_equal():
    _same(lambda fn, types, x: (fn.color_space_conversion(x, image_type=types.GRAY,
                                                          output_type=types.RGB),
                                fn.color_space_conversion(x, image_type=types.GRAY,
                                                          output_type=types.YCbCr)),
          GRAY, "HWC")


# ------------------------------------------------------------------ the examples, whole


def _run_example(name, pkg):
    """Run docs/examples/<name>'s ``main`` with its imports pointing at
    ``pkg``; the port's pipelines and eager calls on the CPU. Returns every
    output of every pipeline's ``run()``, as lists of host arrays."""
    path = os.path.join(EXAMPLES, name)
    with open(path) as f:
        src = f.read()
    if pkg is dali_tpu_torch:
        src = src.replace("import dali_tpu.", "import dali_tpu_torch.").replace(
            "from dali_tpu import", "from dali_tpu_torch import")
    ns = {"__name__": "example", "__file__": path}
    exec(compile(src, path, "exec"), ns)
    runs = []
    base = ns["pipeline_def"]

    def pipeline_def(*a, **kw):
        if pkg is dali_tpu_torch:
            kw.setdefault("device", "cpu")
        decorate = base(*a, **kw)

        def wrap(fn):
            make = decorate(fn)

            def factory(*fa, **fkw):
                pipe = make(*fa, **fkw)
                run = pipe.run

                def recording_run(*ra, **rk):
                    outs = run(*ra, **rk)
                    runs.append([[np.asarray(tl.as_cpu().at(i) if hasattr(tl, "as_cpu")
                                             else tl.at(i)) for i in range(len(tl))]
                                 for tl in outs])
                    return outs

                pipe.run = recording_run
                return pipe

            return factory

        return wrap

    ns["pipeline_def"] = pipeline_def
    if pkg is dali_tpu_torch:
        if "Pipeline" in ns:
            class CpuPipeline(dali_tpu_torch.Pipeline):
                @classmethod
                def deserialize(cls, *a, **kw):
                    return dali_tpu_torch.Pipeline.deserialize(*a, device="cpu", **kw)

            ns["Pipeline"] = CpuPipeline
        if "ndd" in ns:
            with ns["ndd"].EvalContext(seed=7, device="cpu"):
                ns["main"]()
            return runs
    ns["main"]()
    return runs


@pytest.mark.parametrize("name", ["serialization.py", "transforms_3d.py"])
def test_example_runs_whole_and_equals_dali_tpu(name):
    got, want = _run_example(name, dali_tpu_torch), _run_example(name, dali_tpu)
    assert len(got) == len(want) == 1
    for g_out, w_out in zip(got[0], want[0]):
        for g, w in zip(g_out, w_out):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_audio_processing_example_runs_whole_and_equals_dali_tpu():
    """Trim, resample on the cpu (scipy's polyphase filter, bit-equal) and
    the MFCC chain on the device (the tolerance of this module's docstring)."""
    got, want = (_run_example("audio_processing.py", pkg) for pkg in (dali_tpu_torch, dali_tpu))
    assert len(got) == len(want) == 1
    *exact_g, mfcc_g = got[0]
    *exact_w, mfcc_w = want[0]
    for g_out, w_out in zip(exact_g, exact_w):
        for g, w in zip(g_out, w_out):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    for g, w in zip(mfcc_g, mfcc_w):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-3 + 1e-6 * float(np.abs(w).max()), rtol=0)


def test_host_warps_run_without_cv2():
    """WarpAffine and Rotate on the cpu in a fresh interpreter: cv2, jax and
    dali_tpu are never imported."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from dali_tpu_torch import fn, pipeline_def\n"
        "imgs = [np.full((12, 14, 3), i, np.uint8) for i in range(2)]\n"
        "@pipeline_def(batch_size=2, num_threads=2, device='cpu')\n"
        "def p():\n"
        "    x = fn.external_source(source=lambda: imgs, batch=True, layout='HWC')\n"
        "    return (fn.warp_affine(x, matrix=[1, 0.2, 1, 0, 1, 2]), fn.rotate(x, angle=20.0),\n"
        "            fn.resize(x, resize_x=7, resize_y=9))\n"
        "pipe = p()\n"
        "pipe.build()\n"
        "outs = pipe.run()\n"
        "assert [o.at(0).shape for o in outs] == [(12, 14, 3), (16, 17, 3), (9, 7, 3)]\n"
        "pipe.shutdown()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'dali_tpu', 'cv2')]\n"
        "assert not bad, bad\n"
    )
    root = os.path.join(os.path.dirname(__file__), "..")
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120)


@pytest.mark.parametrize("cmn_cpu", [False, True], ids=["cmn_gpu", "cmn_cpu"])
def test_rn50_dali_cpu_path_matches_dali_tpu(tmp_path, cmn_cpu):
    """DeepLearningExamples' --dali-cpu recipe (``tools/bench_dali_cpu.py``)
    at batch 4 and 64 px, two iterations: the host decode and
    RandomResizedCrop bit-equal, so labels equal and the normalised images
    within 1e-5 (the device CMN against the reference's lowering) or equal
    (CMN on the host)."""
    from dali_tpu_torch.tools import bench_dali_cpu

    corpus = os.path.join(os.path.dirname(__file__), "..", "dali_tpu_torch", "testdata", "rn50")
    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(corpus) for f in fs)
    file_list = tmp_path / "list.txt"
    file_list.write_text("".join(f"{f} {i % 3}\n" for i, f in enumerate(files[:12])))
    res = []
    for pkg, kw in ((dali_tpu_torch, {"device": "cpu"}), (dali_tpu, {"debug": True})):
        @pkg.pipeline_def(batch_size=4, num_threads=2, seed=42, **kw)
        def p():
            return bench_dali_cpu.rn50_dali_cpu_graph(pkg.fn, pkg.types, str(file_list), size=64,
                                                      cmn_cpu=cmn_cpu)

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
