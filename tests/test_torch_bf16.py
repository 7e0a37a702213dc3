"""bfloat16 outputs of dali_tpu_torch against dali_tpu with ``debug=True``.

The reference writes bfloat16 wherever an operator's ``dtype`` is
``types.BFLOAT16``: on its device through XLA's convert, on the host through
``ml_dtypes``. Both round float32 to nearest even, so the port must give the
same bits: every comparison here views the outputs as uint16. The port holds
a host bfloat16 sample as a ``torch.bfloat16`` CPU tensor (``types.py``).

* CropMirrorNormalize on the device (CHW, HWC, ``pad_output``, mirror, the
  pad policy's ``fill``, a float input) and on the host, and Cast on the
  host from uint8, float32, float64 and int32, bit-equal;
* the kernel's plain version with bfloat16 input and output against
  ``dali_tpu.kernels.cmn``, NaN included (XLA's 0x7FC0 with its sign);
* a host bfloat16 output crossing to the device (``.gpu()``) and through the
  PyTorch iterator as ``torch.bfloat16``;
* a sweep over every registered cpu and gpu schema with a ``dtype``
  argument (aliases by their canonical name, the two internal audio stages
  left out): built with ``dtype=BFLOAT16`` on the same seeded inputs, both
  packages give equal bits, or both raise. Device random draws differ by
  design (ROADMAP Queue 3, the device-random contract), so there the dtype
  and shapes are compared. The pairs where the packages part for older
  reasons are pinned in ``DEPARTS`` (each in ROADMAP Queue 3);
* every cpu placement fed a bfloat16 input: the placements dali_tpu
  computes on give its dtype and bits in the port, with default arguments
  and with arguments that move the values (NaN and infinities in the
  input), in pipelines and in eager mode; the rest raise in both.
"""

import io
import os
import wave
import zlib

import cv2
import numpy as np
import pytest
import torch

import dali_tpu
import dali_tpu_torch
from dali_tpu import _schema as ref_schema
from dali_tpu.kernels import cmn as ref_cmn
from dali_tpu_torch import _schema as port_schema
from dali_tpu_torch.kernels import cmn as port_cmn

N = 2
RNG = np.random.default_rng(20)
IMG = [RNG.integers(0, 256, (12, 14, 3)).astype(np.uint8) for _ in range(N)]
RAGGED = [RNG.integers(0, 256, (10 + 3 * i, 15 - 2 * i, 3)).astype(np.uint8) for i in range(N)]
FLT = [(RNG.random((12, 14, 3)) * 255 - 40).astype(np.float32) for _ in range(N)]
AUDIO = [RNG.standard_normal(96).astype(np.float32) for _ in range(N)]
POINTS = [RNG.random((5, 2)).astype(np.float32) for _ in range(N)]
LABELS = [np.array(i + 1, np.int32) for i in range(N)]
MEAN = [123.675, 116.28, 103.53]
VIDEO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "dali_tpu_torch", "testdata", "video", "pan_64x48.mp4")
STD = [58.395, 57.12, 57.375]


def _bits(x) -> np.ndarray:
    """The uint16 bits of a bfloat16 sample of either package."""
    if torch.is_tensor(x):
        assert x.dtype == torch.bfloat16, x.dtype
        return x.contiguous().view(torch.int16).numpy().view(np.uint16)
    x = np.asarray(x)
    assert x.dtype.name == "bfloat16", x.dtype
    return x.view(np.uint16)


def _samples(tl):
    if type(tl).__name__ == "TensorListGPU":
        tl = tl.as_cpu()
    return [tl.at(i) for i in range(len(tl))]


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _run_both(graph, extra_port=None):
    """``graph(fn, types)`` -> output nodes, in both packages on the same
    inputs. Returns {package name: list of outputs, each a list of samples}
    or the exception's type."""
    res = {}
    for pkg, extra in ((dali_tpu_torch, dict(device="cpu", **(extra_port or {}))),
                       (dali_tpu, {"debug": True})):
        try:
            @pkg.pipeline_def(batch_size=N, num_threads=1, seed=17, **extra)
            def p():
                return graph(pkg.fn, pkg.types)

            pipe = p()
            pipe.build()
            res[pkg.__name__] = [_samples(o) for o in pipe.run()]
        except Exception as e:  # noqa: BLE001  (the sweep compares what each raises)
            res[pkg.__name__] = type(e)
    return res


def _assert_bits_equal(res):
    port, ref = res["dali_tpu_torch"], res["dali_tpu"]
    assert not isinstance(port, type), f"the port raised {port.__name__}"
    assert not isinstance(ref, type), f"dali_tpu raised {ref.__name__}"
    for po, ro in zip(port, ref):
        for a, b in zip(po, ro):
            assert _dtype_name(a) == _dtype_name(b) == "bfloat16"
            np.testing.assert_array_equal(_bits(a), _bits(b))


def _src(fn, data, layout="HWC"):
    return fn.external_source(source=lambda: data, batch=True, layout=layout)


# ---------------------------------------------------------------- CMN and Cast

CMN_FORMS = {
    "chw": (IMG, dict(crop=(10, 11))),
    "hwc": (IMG, dict(crop=(9, 12), output_layout="HWC")),
    "pad_output_chw": (IMG, dict(crop=(8, 8), pad_output=True)),
    "pad_output_hwc": (IMG, dict(crop=(11, 13), pad_output=True, output_layout="HWC")),
    "mirror": (RAGGED, dict(crop=(9, 9), crop_pos_x=0.7, mirror=1)),
    "fill": (RAGGED, dict(crop=(14, 16), out_of_bounds_policy="pad",
                          fill_values=[0.5, -1.25, 2.0], output_layout="HWC")),
    "float_input_scale_shift": (FLT, dict(crop=(12, 14), scale=1.5, shift=-0.25)),
}


@pytest.mark.parametrize("device", ["gpu", "cpu"])
@pytest.mark.parametrize("form", sorted(CMN_FORMS))
def test_cmn_to_bfloat16_bit_equal(form, device):
    data, kw = CMN_FORMS[form]

    def graph(fn, types):
        x = _src(fn, data)
        x = x.gpu() if device == "gpu" else x
        return fn.crop_mirror_normalize(x, mean=MEAN, std=STD, dtype=types.BFLOAT16, **kw)

    _assert_bits_equal(_run_both(graph))


@pytest.mark.parametrize("src", ["uint8", "float32", "float64", "int32"])
def test_cast_cpu_to_bfloat16_bit_equal(src):
    scale = {"uint8": 1, "float32": 1.37, "float64": 1.0 + 2.0 ** -30, "int32": 65537}[src]
    data = [(a.astype(np.float64) * scale + (2.0 ** -9 if src == "float64" else 0)).astype(src)
            for a in IMG]

    def graph(fn, types):
        return fn.cast(_src(fn, data), dtype=types.BFLOAT16)

    _assert_bits_equal(_run_both(graph))


def test_bfloat16_round_trips_through_cast_and_the_device():
    """A host bfloat16 output crosses to the device and casts back to
    float32 as the reference's does."""
    def graph(fn, types):
        b = fn.cast(_src(fn, FLT), dtype=types.BFLOAT16)
        return b.gpu(), fn.cast(b, dtype=types.FLOAT)

    res = _run_both(graph)
    port, ref = res["dali_tpu_torch"], res["dali_tpu"]
    for a, b in zip(port[0], ref[0]):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    for a, b in zip(port[1], ref[1]):
        np.testing.assert_array_equal(a, b)


def test_iterator_hands_bfloat16_over_as_torch_bfloat16():
    from dali_tpu_torch.plugin.pytorch import DALIGenericIterator

    @dali_tpu_torch.pipeline_def(batch_size=N, num_threads=1, seed=3, device="cpu")
    def p():
        fn, types = dali_tpu_torch.fn, dali_tpu_torch.types
        x = _src(fn, IMG)
        return (fn.crop_mirror_normalize(x.gpu(), mean=MEAN, std=STD, dtype=types.BFLOAT16),
                fn.cast(x, dtype=types.BFLOAT16))

    pipe = p()
    pipe.build()
    out = next(DALIGenericIterator([pipe], ["dev", "host"], size=N))[0]
    assert out["dev"].dtype == out["host"].dtype == torch.bfloat16
    assert tuple(out["dev"].shape) == (N, 3, 12, 14) and tuple(out["host"].shape) == (N, 12, 14, 3)
    np.testing.assert_array_equal(out["host"].float().numpy(), np.stack(IMG).astype(np.float32))
    with pytest.raises(TypeError, match="as_tensor"):
        pipe.run()[1].as_array()


@pytest.mark.parametrize("in_dtype", ["uint8", "float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["CHW", "HWC"])
def test_plain_cmn_bfloat16_against_the_reference_kernel(in_dtype, layout):
    """The plain version (what the card's kernel is held to) with bfloat16
    output and, in one form, bfloat16 input, against dali_tpu.kernels.cmn;
    a NaN input writes XLA's NaN with its sign."""
    import jax.numpy as jnp
    import ml_dtypes

    x = (RNG.random((3, 9, 11, 3)) * 300 - 20).astype(np.float32)
    x[0, 1, 4, 0], x[1, 2, 3, 1] = np.nan, -np.nan  # inside both windows
    if in_dtype == "uint8":
        x = np.clip(np.nan_to_num(x), 0, 255).astype(np.uint8)
    cy, cx = np.array([0, 1, 2], np.int32), np.array([2, 0, 1], np.int32)
    mirror = np.array([1, 0, 1], np.int32)
    ext_w = np.array([11, 9, 10], np.int32)
    args = (7, 8, MEAN, STD, 1.25, 0.5, layout)
    if in_dtype == "bfloat16":
        ref_in = jnp.asarray(x.astype(ml_dtypes.bfloat16))
        port_in = torch.from_numpy(x.astype(ml_dtypes.bfloat16).view(np.int16)).view(
            torch.bfloat16)
    else:
        ref_in, port_in = jnp.asarray(x), torch.from_numpy(x)
    want = ref_cmn.crop_mirror_normalize(ref_in, cy, cx, mirror, *args, out_dtype=jnp.bfloat16,
                                         pad_output=True, ext_w=ext_w)
    got = port_cmn.crop_mirror_normalize(port_in, cy, cx, mirror, *args,
                                         out_dtype=torch.bfloat16, pad_output=True, ext_w=ext_w)
    np.testing.assert_array_equal(_bits(got), np.asarray(want).view(np.uint16))
    if in_dtype != "uint8":
        assert {0x7FC0, 0xFFC0} <= set(_bits(got).ravel().tolist())


def test_kernel_wrapper_takes_bfloat16_codes():
    assert port_cmn._IN_CODES[torch.bfloat16] == 3
    assert port_cmn._OUT_CODES[torch.bfloat16] == 6
    assert len(set(port_cmn._OUT_CODES.values())) == len(port_cmn._OUT_CODES) == 7


# ---------------------------------------------------------------- the sweep

def _jpeg(shape, seed):
    img = np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)
    return np.frombuffer(cv2.imencode(".jpg", img)[1].tobytes(), np.uint8)


JPEGS = [_jpeg((16, 24, 3), 1), _jpeg((20, 16, 3), 2)]


def _wav(seed):
    pcm = (np.random.default_rng(seed).standard_normal(80) * 3000).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return np.frombuffer(buf.getvalue(), np.uint8)


def _npy(a):
    buf = io.BytesIO()
    np.save(buf, a)
    return np.frombuffer(buf.getvalue(), np.uint8)


RAW = [(np.arange(12, dtype=np.float32) * (i + 1.5)) for i in range(N)]
INPUTS = {
    "img": (IMG, "HWC"), "flt": (FLT, "HWC"), "audio": (AUDIO, ""), "points": (POINTS, ""),
    "labels": (LABELS, ""), "jpeg": (JPEGS, ""), "wav": ([_wav(1), _wav(2)], ""),
    "deflate": ([np.frombuffer(zlib.compress(r.tobytes()), np.uint8) for r in RAW], ""),
    "npy": ([_npy(r.reshape(3, 4)) for r in RAW], ""),
}


def _inp(name):
    def make(fn, types, device):
        data, layout = INPUTS[name]
        x = fn.external_source(source=lambda: data, batch=True, layout=layout)
        return x.gpu() if device == "gpu" else x
    return make


def _none(fn, types, device):
    return None


def _const(fn, value, device="cpu"):
    """The same array in every sample, as a graph input."""
    x = fn.external_source(source=lambda: [value] * N, batch=True)
    return x.gpu() if device == "gpu" else x


# canonical schema -> (input maker, the fn call taking (fn, input, device, dtype))
SWEEP = {
    "decoders.Audio": (_inp("wav"), lambda fn, x, d, t: fn.decoders.audio(x, dtype=t)[0]),
    "experimental.AudioResample": (_inp("audio"), lambda fn, x, d, t: fn.experimental.audio_resample(
        x, in_rate=16000.0, out_rate=12000.0, dtype=t)),
    "Brightness": (_inp("img"), lambda fn, x, d, t: fn.brightness(x, brightness=1.3, dtype=t)),
    "BrightnessContrast": (_inp("img"), lambda fn, x, d, t: fn.brightness_contrast(
        x, brightness=1.1, contrast=0.8, dtype=t)),
    "Cast": (_inp("flt"), lambda fn, x, d, t: fn.cast(x, dtype=t)),
    "random.CoinFlip": (_none, lambda fn, x, d, t: fn.random.coin_flip(
        probability=0.5, shape=[4], dtype=t, device=d, seed=5)),
    "ColorTwist": (_inp("img"), lambda fn, x, d, t: fn.color_twist(
        x, brightness=1.2, contrast=0.9, saturation=1.1, dtype=t)),
    "Constant": (_none, lambda fn, x, d, t: fn.constant(
        fdata=[1.5, -2.25, 3.0078125], shape=[3], dtype=t, device=d)),
    "Contrast": (_inp("img"), lambda fn, x, d, t: fn.contrast(x, contrast=1.4, dtype=t)),
    "CoordTransform": (_inp("points"), lambda fn, x, d, t: fn.coord_transform(
        x, M=[1.5, 0.25, -0.5, 2.0], T=[0.125, 3.0], dtype=t)),
    "Crop": (_inp("img"), lambda fn, x, d, t: fn.crop(x, crop=(8, 9), dtype=t)),
    "CropMirrorNormalize": (_inp("img"), lambda fn, x, d, t: fn.crop_mirror_normalize(
        x, crop=(8, 9), mean=MEAN, std=STD, dtype=t)),
    "ExternalSource": (_none, lambda fn, x, d, t: fn.external_source(
        source=lambda: FLT, batch=True, dtype=t)),
    "FastResizeCropMirror": (_inp("img"), lambda fn, x, d, t: fn.fast_resize_crop_mirror(
        x, crop=(8, 8), resize_shorter=10.0, dtype=t)),
    "experimental.Filter": (_inp("flt"), lambda fn, x, d, t: fn.experimental.filter(
        x, _const(fn, np.full((3, 3), 1 / 9, np.float32), d), dtype=t)),
    "Full": (_none, lambda fn, x, d, t: fn.full(
        fill_value=2.5078125, shape=[2, 3], dtype=t, device=d)),
    "FullLike": (_inp("flt"), lambda fn, x, d, t: fn.full_like(x, fill_value=1.75, dtype=t)),
    "GaussianBlur": (_inp("img"), lambda fn, x, d, t: fn.gaussian_blur(
        x, window_size=3, sigma=0.8, dtype=t)),
    "Hsv": (_inp("img"), lambda fn, x, d, t: fn.hsv(x, hue=20.0, saturation=1.2, dtype=t)),
    "Hue": (_inp("img"), lambda fn, x, d, t: fn.hue(x, hue=15.0, dtype=t)),
    "decoders.Image": (_inp("jpeg"), lambda fn, x, d, t: fn.decoders.image(x, dtype=t)),
    "decoders.ImageCrop": (_inp("jpeg"), lambda fn, x, d, t: fn.decoders.image_crop(
        x, crop=(8, 8), dtype=t)),
    "decoders.ImageRandomCrop": (_inp("jpeg"), lambda fn, x, d, t: fn.decoders.image_random_crop(
        x, dtype=t, seed=9)),
    "decoders.ImageSlice": (_inp("jpeg"), lambda fn, x, d, t: fn.decoders.image_slice(
        x, _const(fn, np.array([0.25, 0.25], np.float32)),
        _const(fn, np.array([0.5, 0.5], np.float32)), dtype=t)),
    "Laplacian": (_inp("flt"), lambda fn, x, d, t: fn.laplacian(x, window_size=3, dtype=t)),
    "LookupTable": (_inp("img"), lambda fn, x, d, t: fn.lookup_table(
        x, keys=[0, 1, 2, 255], values=[0.5, 1.25, -3.0, 9.0], default_value=0.25, dtype=t)),
    "MultiPaste": (_inp("img"), lambda fn, x, d, t: fn.multi_paste(
        x, in_ids=np.array([0, 1], np.int32), output_size=np.array([16, 16], np.int32),
        dtype=t)),
    "readers.NemoAsr": None,  # built by the test (a manifest in tmp_path)
    "readers.Video": None,  # built by the test (a committed MP4 fixture)
    "readers.VideoResize": None,  # built by the test (the same fixture)
    "random.Normal": (_none, lambda fn, x, d, t: fn.random.normal(
        shape=[4], dtype=t, device=d, seed=6)),
    "Normalize": (_inp("flt"), lambda fn, x, d, t: fn.normalize(x, dtype=t)),
    "OneHot": (_inp("labels"), lambda fn, x, d, t: fn.one_hot(x, num_classes=4, dtype=t)),
    "Ones": (_none, lambda fn, x, d, t: fn.ones(shape=[2, 2], dtype=t, device=d)),
    "OnesLike": (_inp("flt"), lambda fn, x, d, t: fn.ones_like(x, dtype=t)),
    "PeekImageShape": (_inp("jpeg"), lambda fn, x, d, t: fn.peek_image_shape(x, dtype=t)),
    "PreemphasisFilter": (_inp("audio"), lambda fn, x, d, t: fn.preemphasis_filter(x, dtype=t)),
    "RandomResizedCrop": (_inp("img"), lambda fn, x, d, t: fn.random_resized_crop(
        x, size=[8, 8], dtype=t, seed=4)),
    "Reinterpret": (_inp("flt"), lambda fn, x, d, t: fn.reinterpret(x, dtype=t)),
    "Resize": (_inp("img"), lambda fn, x, d, t: fn.resize(x, resize_x=9, resize_y=7, dtype=t)),
    "ResizeCropMirror": (_inp("img"), lambda fn, x, d, t: fn.resize_crop_mirror(
        x, crop=(8, 8), resize_shorter=10.0, dtype=t)),
    "Rotate": (_inp("img"), lambda fn, x, d, t: fn.rotate(x, angle=30.0, dtype=t)),
    "Saturation": (_inp("img"), lambda fn, x, d, t: fn.saturation(x, saturation=0.6, dtype=t)),
    "Shapes": (_inp("img"), lambda fn, x, d, t: fn.shapes(x, dtype=t)),
    "Slice": (_inp("img"), lambda fn, x, d, t: fn.slice(
        x, rel_start=[0.25, 0.25], rel_shape=[0.5, 0.5], axes=[0, 1], dtype=t)),
    "TensorResize": (_inp("flt"), lambda fn, x, d, t: fn.tensor_resize(
        x, sizes=[6, 7], axes=[0, 1], dtype=t)),
    "random.Uniform": (_none, lambda fn, x, d, t: fn.random.uniform(
        range=[-2.0, 3.0], shape=[4], dtype=t, device=d, seed=7)),
    "WarpAffine": (_inp("img"), lambda fn, x, d, t: fn.warp_affine(
        x, matrix=[0.9, 0.1, 0.5, -0.1, 1.1, -0.25], dtype=t)),
    "Zeros": (_none, lambda fn, x, d, t: fn.zeros(shape=[3], dtype=t, device=d)),
    "ZerosLike": (_inp("flt"), lambda fn, x, d, t: fn.zeros_like(x, dtype=t)),
    "decoders.Inflate": (_inp("deflate"), lambda fn, x, d, t: fn.decoders.inflate(
        x, shape=[12], dtype=t)),
    "decoders.Numpy": (_inp("npy"), lambda fn, x, d, t: fn.decoders.numpy(x, dtype=t)),
    "random.Beta": (_none, lambda fn, x, d, t: fn.random.beta(
        alpha=2.0, beta=3.0, shape=[4], dtype=t, device=d, seed=8)),
    "random.Choice": (_none, lambda fn, x, d, t: fn.random.choice(
        _const(fn, np.array([1.5, 2.25, -3.0], np.float32)), shape=[4], dtype=t, seed=10)),
    "reductions.Max": (_inp("flt"), lambda fn, x, d, t: fn.reductions.max(x, dtype=t)),
    "reductions.Mean": (_inp("flt"), lambda fn, x, d, t: fn.reductions.mean(x, dtype=t)),
    "reductions.MeanSquare": (_inp("flt"), lambda fn, x, d, t: fn.reductions.mean_square(
        x, dtype=t)),
    "reductions.Min": (_inp("flt"), lambda fn, x, d, t: fn.reductions.min(x, dtype=t)),
    "reductions.RootMeanSquare": (_inp("flt"), lambda fn, x, d, t: fn.reductions.rms(
        x, dtype=t)),
    "reductions.StdDev": (_inp("flt"), lambda fn, x, d, t: fn.reductions.std_dev(x, dtype=t)),
    "reductions.Sum": (_inp("flt"), lambda fn, x, d, t: fn.reductions.sum(x, dtype=t)),
    "reductions.Variance": (_inp("flt"), lambda fn, x, d, t: fn.reductions.variance(
        x, dtype=t)),
}
# device random draws: the port's torch generators cannot give JAX's threefry
# bits, so these compare dtype and shapes only
DEVICE_RANDOM = {"random.CoinFlip", "random.Normal", "random.Uniform", "random.Beta"}
# gpu ops whose float32 output is held to dali_tpu's within a tolerance, not
# bit-equal (their sums run in another order): a value within a float32 ulp
# of a bfloat16 rounding tie may round the other way, one bfloat16 step
FLOAT_TOLERANT = {("FastResizeCropMirror", "gpu"), ("ResizeCropMirror", "gpu"),
                  ("Normalize", "gpu")}
# (schema, device) -> (the reference's outcome, the port's): pairs that part
# for reasons older than bfloat16, each in ROADMAP Queue 3 ("found in the
# reference; the port raises rather than copy a silent wrong answer"): these
# cpu ops ignore ``dtype`` in dali_tpu and the port raises; the gpu
# MultiPaste's debug=True lowering fails in dali_tpu; the gpu Filter ignores
# ``dtype`` in dali_tpu and the port raises
DEPARTS = {
    ("MultiPaste", "cpu"): (("uint8",), "raises"),
    ("RandomResizedCrop", "cpu"): (("uint8",), "raises"),
    ("Resize", "cpu"): (("uint8",), "raises"),
    ("Rotate", "cpu"): (("uint8",), "raises"),
    ("WarpAffine", "cpu"): (("uint8",), "raises"),
    ("MultiPaste", "gpu"): ("raises", ("bfloat16",)),
    ("experimental.Filter", "gpu"): (("float32",), "raises"),
}


def _dtype_schemas():
    """Every registered cpu and gpu placement whose schema has a ``dtype``
    argument, by canonical name, in the port's registry."""
    out = set()
    for name in port_schema.RegisteredSchemas():
        sc = port_schema.GetSchema(name)
        if "dtype" not in sc.args or sc.name.startswith("_"):
            continue
        for dev in ("cpu", "gpu"):
            if port_schema.has_operator_impl(sc.name, dev):
                out.add((sc.name, dev))
    return sorted(out)


SWEEP_CASES = _dtype_schemas()


def test_sweep_covers_every_dtype_schema_of_both_packages():
    assert {s for s, _ in SWEEP_CASES} == set(SWEEP)
    ref = set()
    for name in ref_schema.RegisteredSchemas():
        sc = ref_schema.GetSchema(name)
        if "dtype" in sc.args and not sc.name.startswith("_"):
            ref |= {(sc.name, d) for d in ("cpu", "gpu") if ref_schema.has_operator_impl(sc.name, d)}
    # readers.VideoResize joined with item 8b's registry part
    assert ref == set(SWEEP_CASES)


def _outcome(res, schema):
    """'raises' for a package that raised, else its outputs' dtypes."""
    out = {}
    for k, v in res.items():
        out[k] = "raises" if isinstance(v, type) else tuple(
            sorted({_dtype_name(s) for o in v for s in o}))
    return out


@pytest.mark.parametrize("schema,device", SWEEP_CASES, ids=[f"{s}-{d}" for s, d in SWEEP_CASES])
def test_sweep_dtype_bfloat16(schema, device, tmp_path):
    if schema == "readers.NemoAsr":
        wav = tmp_path / "a.wav"
        wav.write_bytes(INPUTS["wav"][0][0].tobytes())
        manifest = tmp_path / "m.json"
        manifest.write_text('{"audio_filepath": "%s", "duration": 0.005, "text": "a"}\n' % wav)

        def graph(fn, types):
            return fn.readers.nemo_asr(manifest_filepaths=[str(manifest)], dtype=types.BFLOAT16,
                                       read_text=False)
    elif schema == "readers.Video":
        def graph(fn, types):
            return fn.readers.video(filenames=[VIDEO], sequence_length=3, dtype=types.BFLOAT16)
    elif schema == "readers.VideoResize":
        def graph(fn, types):
            return fn.readers.video_resize(filenames=[VIDEO], sequence_length=3, resize_x=40,
                                           resize_y=30, dtype=types.BFLOAT16)
    else:
        make, call = SWEEP[schema]

        def graph(fn, types):
            out = call(fn, make(fn, types, device), device, types.BFLOAT16)
            return tuple(out) if isinstance(out, (list, tuple)) else (out,)

    res = _run_both(graph)
    got = _outcome(res, schema)
    if (schema, device) in DEPARTS:
        assert (got["dali_tpu"], got["dali_tpu_torch"]) == DEPARTS[schema, device], got
        return
    assert got["dali_tpu_torch"] == got["dali_tpu"], got
    if got["dali_tpu"] == "raises":
        return
    port, ref = res["dali_tpu_torch"], res["dali_tpu"]
    for po, ro in zip(port, ref):
        for a, b in zip(po, ro):
            assert tuple(a.shape) == tuple(b.shape)
            if _dtype_name(b) != "bfloat16":
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            elif (schema, device) in FLOAT_TOLERANT:
                step = np.abs(_bits(a).astype(np.int32) - _bits(b).astype(np.int32))
                assert step.max() <= 1 and (_bits(a) >> 15 == _bits(b) >> 15).all()
            elif not (device == "gpu" and schema in DEVICE_RANDOM):
                np.testing.assert_array_equal(_bits(a), _bits(b))


def test_host_ops_reading_bfloat16_depart():
    """F6-residue, closed: host ops reading a bfloat16 input give dali_tpu's
    dtype and values: a reduction (float32 from an exact upcast; Max the
    chosen element, still bfloat16), a bit mover (Flip), a bfloat16 result
    (Brightness, rounded once from float32), a float32 one (Normalize) and
    CastLike to and from another type."""
    graphs = {
        "sum": lambda fn, t, x: fn.reductions.sum(x, axes=[0, 1]),
        "max": lambda fn, t, x: fn.reductions.max(x, axes=[0, 1]),
        "std_dev": lambda fn, t, x: fn.reductions.std_dev(x, axes=[0, 1]),
        "flip": lambda fn, t, x: fn.flip(x, horizontal=1, vertical=1),
        "brightness": lambda fn, t, x: fn.brightness(x, brightness=1.3, brightness_shift=0.1),
        "normalize": lambda fn, t, x: fn.normalize(x, mean=100.0, stddev=40.0, scale=1.5),
        "cast_like_int": lambda fn, t, x: fn.cast_like(x, fn.cast(x, dtype=t.INT32)),
        "cast_like_float": lambda fn, t, x: fn.cast_like(fn.cast(x, dtype=t.FLOAT), x)}
    for kind, op in graphs.items():
        def graph(fn, types, op=op):
            return op(fn, types, fn.cast(_src(fn, FLT), dtype=types.BFLOAT16))

        res = _run_both(graph)
        for a, b in zip(res["dali_tpu_torch"][0], res["dali_tpu"][0]):
            assert _dtype_name(a) == _dtype_name(b), kind
            if _dtype_name(b) == "bfloat16":
                np.testing.assert_array_equal(_bits(a), _bits(b))
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# Every cpu placement of the port with an input (readers and inputs have
# none), fed a bfloat16 image: the placements dali_tpu computes on it (its
# ml_dtypes arrays behave as numpy floats). The port gives dali_tpu's dtype
# and bits on each (F6-residue, closed); every other placement raises in
# both.
BF16_INPUT_COMPUTES = {
    "BbFlip", "Brightness", "BrightnessContrast", "CastLike", "Cat", "ColorTwist", "Contrast",
    "CoordFlip", "CoordTransform", "Copy", "CropMirrorNormalize", "Erase", "Flip",
    "GaussianBlur", "GridMask", "Hsv", "Hue", "Jitter", "Laplacian", "LookupTable", "MFCC",
    "NonsilentRegion", "Normalize", "Ones", "OnesLike", "Pad", "PerFrame", "PowerSpectrum",
    "PreemphasisFilter", "RandomBBoxCrop", "RandomCropGenerator", "Reinterpret", "Reshape",
    "SSDRandomCrop", "Saturation", "Shapes", "Slice", "Spectrogram", "Sphere", "Squeeze",
    "Stack", "ToDecibels", "Water", "Zeros", "ZerosLike", "experimental.AudioResample",
    "experimental.Clahe", "noise.Gaussian", "noise.SaltAndPepper", "random.Beta",
    "random.Choice", "random.CoinFlip", "random.Normal", "random.Uniform", "reductions.Max",
    "reductions.Mean", "reductions.MeanSquare", "reductions.Min", "reductions.RootMeanSquare",
    "reductions.StdDev", "reductions.Sum", "reductions.Variance",
    "segmentation.RandomMaskPixel", "segmentation.RandomObjectBBox", "transforms.Combine"}
BF16_INPUT_PORTED = set(BF16_INPUT_COMPUTES)


def _with_input(name):
    sc = port_schema.GetSchema(name)
    return sc.max_inputs > 0 and not (name.startswith("readers.")
                                      or name.startswith("experimental.readers.")
                                      or name.startswith("experimental.inputs."))


BF16_INPUT_SWEEP = sorted(n for (n, d) in port_schema._impl_registry
                          if d == "cpu" and not n.startswith("_")
                          and n not in port_schema._alias_targets and _with_input(n))


def _bf16_input_run(pkg, name):
    """The op's outputs on a bfloat16 image, or the exception it raised."""
    sc = pkg._schema.GetSchema(name)
    extra = {"device": "cpu"} if pkg is dali_tpu_torch else {"debug": True}
    try:
        @pkg.pipeline_def(batch_size=N, num_threads=1, seed=17, **extra)
        def p():
            x = pkg.fn.cast(_src(pkg.fn, FLT), dtype=pkg.types.BFLOAT16)
            op = pkg.ops
            for part in name.split("."):
                op = getattr(op, part)
            out = op(device="cpu")(*([x] * max(sc.min_inputs, 1)))
            return tuple(out) if isinstance(out, (list, tuple)) else out

        pipe = p()
        pipe.build()
        return [_samples(o) for o in pipe.run()]
    except Exception as e:  # noqa: BLE001  (the sweep records what each raises)
        return e


def test_bf16_input_sweep_covers_the_registry():
    assert len(BF16_INPUT_SWEEP) >= 120
    assert BF16_INPUT_COMPUTES <= set(BF16_INPUT_SWEEP)
    assert len(BF16_INPUT_COMPUTES - BF16_INPUT_PORTED) == 0  # F6-residue closed


@pytest.mark.parametrize("name", BF16_INPUT_SWEEP)
def test_bf16_input_sweep(name):
    ref = _bf16_input_run(dali_tpu, name)
    port = _bf16_input_run(dali_tpu_torch, name)
    assert (not isinstance(ref, Exception)) == (name in BF16_INPUT_COMPUTES), ref
    if name in BF16_INPUT_PORTED:
        assert not isinstance(port, Exception), port
        for po, ro in zip(port, ref):
            for a, b in zip(po, ro):
                assert _dtype_name(a) == _dtype_name(b)
                if _dtype_name(b) == "bfloat16":
                    np.testing.assert_array_equal(_bits(a), _bits(b))
                else:
                    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert isinstance(port, Exception), port


# Each placement dali_tpu computes on, with arguments that move the values
# (defaults leave many ops near the identity, which would hide a rounding),
# on random float32 values cast to bfloat16 with NaN and infinities among
# them: (input kind, inputs, arguments). Inputs are drawn per kind.
def _bf16_case_input(kind, rng):
    """N samples of one input kind, float32 (cast to bfloat16 in the graph)."""
    out = []
    for i in range(N):
        if kind == "img":
            x = (rng.standard_normal((12, 14, 3)) * 60 + 100).astype(np.float32)
            x.reshape(-1)[[0, 40 + i, 77, 150]] = [np.nan, np.inf, -np.inf, -np.nan]
        elif kind == "ints":
            x = rng.integers(0, 6, (12, 14, 3)).astype(np.float32)
        elif kind == "boxes":
            lt = rng.random((5, 2)) * 0.5
            x = np.concatenate([lt, lt + 0.1 + rng.random((5, 2)) * 0.4], 1).astype(np.float32)
        elif kind == "points":
            x = (rng.random((5, 2)) * 3 - 1).astype(np.float32)
            x[1, 1] = np.nan
        elif kind == "audio":
            x = (rng.standard_normal(200) * 0.3).astype(np.float32)
        elif kind == "spec":
            x = (rng.random((20, 12)) * 50 + 1e-3).astype(np.float32)
        elif kind == "shape":
            x = np.array([200 + 20 * i, 300, 3], np.float32)
        elif kind == "mask":
            x = np.zeros((12, 14), np.float32)
            x[2:6, 3:8] = 1
            x[7:11, 1 + i:6] = 2
        elif kind == "matrix":
            x = (rng.standard_normal((2, 3)) * 2).astype(np.float32)
        elif kind == "squeeze":
            x = (rng.standard_normal((12, 1, 3)) * 60 + 100).astype(np.float32)
        out.append(x)
    return out


BF16_CASE_LAYOUT = {"img": "HWC", "ints": "HWC", "squeeze": "HWC", "audio": "", "spec": "ft",
                    "mask": "HW", "boxes": "", "points": "", "shape": "", "matrix": ""}

# name: (input kind, inputs, kwargs)
BF16_CASES = {
    "BbFlip": ("boxes", 1, dict(horizontal=1, vertical=1, ltrb=True)),
    "Brightness": ("img", 1, dict(brightness=1.3, brightness_shift=0.1)),
    "BrightnessContrast": ("img", 1, dict(brightness=1.3, brightness_shift=0.1, contrast=0.7,
                                          contrast_center=90.0)),
    "CastLike": ("img", 2, {}),
    "Cat": ("img", 2, dict(axis=1)),
    "ColorTwist": ("img", 1, dict(brightness=1.3, contrast=0.8, hue=40.0, saturation=1.2)),
    "Contrast": ("img", 1, dict(contrast=1.4, contrast_center=90.0)),
    "CoordFlip": ("points", 1, dict(flip_x=1, flip_y=1, center_x=0.3, center_y=0.7)),
    "CoordTransform": ("points", 1, dict(M=[1.5, 0.2, -0.3, 0.8], T=[0.1, -2.0])),
    "Copy": ("img", 1, {}),
    "CropMirrorNormalize": ("img", 1, dict(crop=(8, 9), crop_pos_x=0.3, mirror=1,
                                           mean=[100.5, 90.25, 80.0], std=[50.0, 60.0, 70.0],
                                           scale=1.3, shift=0.2)),
    "Erase": ("img", 1, dict(anchor=[2, 3], shape=[4, 5], axis_names="HW",
                             fill_value=[1.7, 2.3, 3.1])),
    "Flip": ("img", 1, dict(horizontal=1, vertical=1)),
    "GaussianBlur": ("img", 1, dict(sigma=1.5)),
    "GridMask": ("img", 1, dict(ratio=0.4, tile=5, angle=0.3, shift_x=1.5)),
    "Hsv": ("img", 1, dict(hue=40.0, saturation=1.3, value=0.9)),
    "Hue": ("img", 1, dict(hue=40.0)),
    "Jitter": ("img", 1, dict(nDegree=3, fill_value=2.7)),
    "Laplacian": ("img", 1, dict(window_size=5, scale=0.7)),
    "LookupTable": ("ints", 1, dict(keys=[1, 2, 3], values=[10.5, 20.25, -3.3], default_value=0.7)),
    "MFCC": ("spec", 1, dict(n_mfcc=8, lifter=2.0, normalize=True)),
    "NonsilentRegion": ("audio", 1, dict(cutoff_db=-30.0, window_length=16)),
    "Normalize": ("img", 1, dict(mean=100.0, stddev=40.0, scale=1.5, shift=0.2)),
    "Ones": ("img", 1, {}),
    "OnesLike": ("img", 1, {}),
    "Pad": ("img", 1, dict(axes=[0, 1], shape=[16, 18], fill_value=2.7)),
    "PerFrame": ("img", 1, {}),
    "PowerSpectrum": ("audio", 1, dict(nfft=32, power=1)),
    "PreemphasisFilter": ("audio", 1, dict(preemph_coeff=0.9, border="zero")),
    "RandomBBoxCrop": ("boxes", 1, dict(aspect_ratio=[0.5, 2.0], thresholds=[0.1, 0.3],
                                        scaling=[0.3, 1.0])),
    "RandomCropGenerator": ("shape", 1, dict(random_area=[0.2, 0.9])),
    "Reinterpret": ("img", 1, dict(rel_shape=[1, 1, 1], layout="ABC")),
    "Reshape": ("img", 1, dict(shape=[14, 12, 3])),
    "SSDRandomCrop": ("img", 3, dict(num_attempts=3)),
    "Saturation": ("img", 1, dict(saturation=1.4)),
    "Shapes": ("img", 1, {}),
    "Slice": ("img", 1, dict(start=[2, 3], shape=[12, 14], axis_names="HW",
                             out_of_bounds_policy="pad", fill_values=2.7)),
    "Spectrogram": ("audio", 1, dict(nfft=32, window_length=32, window_step=8)),
    "Sphere": ("img", 1, dict(fill_value=2.7)),
    "Squeeze": ("squeeze", 1, dict(axes=[1])),
    "Stack": ("img", 2, dict(axis=1)),
    "ToDecibels": ("spec", 1, dict(multiplier=20.0, reference=3.0, cutoff_db=-50.0)),
    "Water": ("img", 1, dict(ampl_x=3.0, ampl_y=2.0, freq_x=0.3, phase_y=0.5, fill_value=2.7)),
    "Zeros": ("img", 1, {}),
    "ZerosLike": ("img", 1, {}),
    "experimental.AudioResample": ("audio", 1, dict(scale=0.7)),
    "experimental.Clahe": ("img", 1, dict(tiles_x=2, tiles_y=2, clip_limit=3.0)),
    "noise.Gaussian": ("img", 1, dict(stddev=5.0, mean=1.5)),
    "noise.SaltAndPepper": ("img", 1, dict(prob=0.2, salt_val=200.7, pepper_val=-3.3)),
    "random.Beta": ("img", 1, dict(alpha=2.0, beta=3.0)),
    "random.Choice": ("audio", 1, dict(shape=[4])),
    "random.CoinFlip": ("img", 1, dict(probability=0.3)),
    "random.Normal": ("img", 1, dict(mean=2.0, stddev=3.0)),
    "random.Uniform": ("img", 1, dict(range=[-2.0, 5.0])),
    "segmentation.RandomMaskPixel": ("mask", 1, dict(value=1)),
    "segmentation.RandomObjectBBox": ("mask", 1, dict(classes=[1, 2], k_largest=2)),
    "transforms.Combine": ("matrix", 2, {}),
    "reductions.Max": ("img", 1, dict(axes=[0, 1])),
    "reductions.Min": ("img", 1, dict(axes=[1], keep_dims=True)),
    "reductions.Sum": ("img", 1, dict(axes=[0, 1])),
    "reductions.Mean": ("img", 1, dict(axes=[1])),
    "reductions.MeanSquare": ("img", 1, dict(axes=[0])),
    "reductions.RootMeanSquare": ("img", 1, dict(axes=[0, 2])),
    "reductions.StdDev": ("img", 1, dict(axes=[0, 1], ddof=1)),
    "reductions.Variance": ("img", 1, dict(axes=[1], ddof=1)),
}
_CASE_RNG = np.random.default_rng(31)
BF16_CASE_INPUTS = {k: _bf16_case_input(k, _CASE_RNG) for k in BF16_CASE_LAYOUT}


def test_bf16_case_sweep_covers_every_computing_placement():
    assert set(BF16_CASES) == BF16_INPUT_COMPUTES
    img = np.concatenate([x.reshape(-1) for x in BF16_CASE_INPUTS["img"]])
    assert np.isnan(img).any() and np.isposinf(img).any() and np.isneginf(img).any()


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_bf16_input_with_arguments(name):
    """dali_tpu computes on each case, and the port gives the same dtype and
    bits (bfloat16 compared as uint16, NaN at the same places)."""
    kind, n_in, kw = BF16_CASES[name]
    data = BF16_CASE_INPUTS[kind]

    def graph(fn, types):
        x = fn.cast(_src(fn, data, BF16_CASE_LAYOUT[kind]), dtype=types.BFLOAT16)
        op = (dali_tpu if types is dali_tpu.types else dali_tpu_torch).ops
        for part in name.split("."):
            op = getattr(op, part)
        out = op(device="cpu", **kw)(*([x] * n_in))
        return tuple(out) if isinstance(out, (list, tuple)) else (out,)

    res = _run_both(graph)
    port, ref = res["dali_tpu_torch"], res["dali_tpu"]
    assert not isinstance(ref, type), ref
    assert not isinstance(port, type), port
    assert len(port) == len(ref)
    for po, ro in zip(port, ref):
        for a, b in zip(po, ro):
            assert _dtype_name(a) == _dtype_name(b)
            assert tuple(a.shape) == tuple(b.shape)
            if _dtype_name(b) == "bfloat16":
                np.testing.assert_array_equal(_bits(a), _bits(b))
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------------- eager mode

@pytest.mark.parametrize("data", [FLT, [f[:9 + 2 * i] for i, f in enumerate(FLT)]],
                         ids=["uniform", "ragged"])
def test_ndd_bfloat16_host_batch_to_the_device(data):
    """Eager mode: a host cast to BFLOAT16, ``.gpu()`` of it, a device CMN
    reading it and a cast back to FLOAT, each equal to dali_tpu's ndd."""
    import dali_tpu.experimental.dynamic as ref_ndd
    import dali_tpu_torch.experimental.dynamic as ndd

    out = {}
    for name, nd, types, kw in (("port", ndd, dali_tpu_torch.types, {"device": "cpu"}),
                                ("ref", ref_ndd, dali_tpu.types, {})):
        with nd.EvalContext(seed=5, **kw):
            host = nd.cast(nd.as_batch(data, layout="HWC"), dtype=types.BFLOAT16)
            dev = host.gpu()
            cmn = nd.crop_mirror_normalize(dev, crop=(8, 9), mean=MEAN, std=STD,
                                           dtype=types.BFLOAT16)
            back = nd.cast(dev, dtype=types.FLOAT)
            out[name] = [[b.at(i) for i in range(N)] for b in (host, dev, cmn, back)]
    for port, ref in zip(out["port"][:3], out["ref"][:3]):
        for a, b in zip(port, ref):
            assert tuple(a.shape) == b.shape
            np.testing.assert_array_equal(_bits(a), _bits(b))
    for a, b in zip(out["port"][3], out["ref"][3]):
        np.testing.assert_array_equal(a, b)


def test_ndd_host_op_reading_bfloat16_departs():
    """F6-residue, closed in eager mode too: host ops reading a bfloat16
    batch give dali_tpu's ndd's dtype and bits (a reduction, Flip, Pad with a
    fill that rounds, Hue, GaussianBlur, Normalize), NaN and infinities
    included."""
    import dali_tpu.experimental.dynamic as ref_ndd
    import dali_tpu_torch.experimental.dynamic as ndd

    data = BF16_CASE_INPUTS["img"]
    calls = [lambda m, b: m.reductions.sum(b), lambda m, b: m.reductions.max(b),
             lambda m, b: m.flip(b, horizontal=1),
             lambda m, b: m.pad(b, axes=[0, 1], shape=[16, 18], fill_value=2.7),
             lambda m, b: m.hue(b, hue=40.0), lambda m, b: m.gaussian_blur(b, sigma=1.5),
             lambda m, b: m.normalize(b, mean=100.0, stddev=40.0, scale=1.5, shift=0.2)]
    out = []
    for m, types, ctx in ((ref_ndd, dali_tpu.types, ref_ndd.EvalContext(seed=5)),
                          (ndd, dali_tpu_torch.types, ndd.EvalContext(seed=5, device="cpu"))):
        with ctx:
            b = m.cast(m.as_batch(data, layout="HWC"), dtype=types.BFLOAT16)
            out.append([[r.at(i) for i in range(N)] for r in (c(m, b) for c in calls)])
    for want, got in zip(*out):
        for a, b in zip(got, want):
            assert _dtype_name(a) == _dtype_name(b)
            if _dtype_name(b) == "bfloat16":
                np.testing.assert_array_equal(_bits(a), _bits(b))
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))