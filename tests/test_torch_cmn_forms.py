"""CropMirrorNormalize's remaining forms in dali_tpu_torch against dali_tpu,
on the CPU: integer output dtypes, DHWC volumes and FHWC sequences on the
device (folded into the batch), the cpu placement, and the tensor crop
sizes the reference ignores.

* Integer outputs: the plain version (``kernels/cmn.py``) against the
  reference's function (``dali_tpu.kernels.cmn``, whose XLA convert
  truncates toward zero, saturates and sends NaN to 0), bit-equal on
  values in range, out of range, infinite and NaN; through pipelines, the
  gpu op against ``debug=True``, bit-equal. The cpu placement casts with
  numpy's ``astype``, as the reference's does: bit-equal to it.
* Volumes and sequences on the device: against the reference's gpu lowering
  with ``debug=True``, within 1e-5 (float32) and bit-equal (integers).
* The cpu placement: bit-equal to the reference's over every
  ``out_of_bounds_policy``, ``fill_values``, mirror, ``pad_output``, layouts,
  dtypes and DHWC volumes with ``crop_d``/``crop_pos_z``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dali_tpu
import dali_tpu_torch
from dali_tpu.kernels import cmn as ref_cmn
from dali_tpu_torch.kernels import cmn

N = 5
RNG = np.random.default_rng(77)
RAGGED = [RNG.integers(0, 256, (30 + 4 * i, 52 - 5 * i, 3)).astype(np.uint8) for i in range(N)]
UNIFORM = RNG.integers(0, 256, (N, 36, 40, 3)).astype(np.uint8)
VOLUMES = [RNG.random((6 + i, 20 + i, 24, 2)).astype(np.float32) * 100 for i in range(N)]
UVOLUMES = RNG.integers(0, 256, (N, 7, 20, 22, 3)).astype(np.uint8)
SEQUENCES = RNG.integers(0, 256, (N, 4, 22, 26, 3)).astype(np.uint8)
MIRROR = [np.int32(m) for m in (1, 0, 1, 1, 0)]
POS = [np.float32(p) for p in (0.0, 0.3, 0.5, 0.9, 1.0)]
INT_DTYPES = {"UINT8": torch.uint8, "INT8": torch.int8, "INT16": torch.int16,
              "INT32": torch.int32}
# pushes x*a+b out of each integer range: (x - 64) / 0.01 spans [-6400, 19100]
WIDE = dict(mean=[64.0], std=[0.01], shift=0.5)


def _graph_run(pkg, build, data, layout, device, args=(), iters=1):
    kw = {"device": "cpu"} if pkg is dali_tpu_torch else {"debug": True}

    @pkg.pipeline_def(batch_size=len(data), num_threads=1, seed=5, **kw)
    def p():
        x = pkg.fn.external_source(source=lambda: data, batch=True, layout=layout)
        x = x.gpu() if device == "gpu" else x
        a = [pkg.fn.external_source(source=lambda v=v: v, batch=True) for v in args]
        outs = build(pkg.fn, pkg.types, x, *a)
        return outs if isinstance(outs, tuple) else (outs,)

    pipe = p()
    pipe.build()
    res = []
    try:
        for _ in range(iters):
            outs = pipe.run()
            res.append(([[np.asarray(tl.as_cpu().at(i) if hasattr(tl, "as_cpu") else tl.at(i))
                          for i in range(len(tl))] for tl in outs], [tl.layout() for tl in outs]))
    finally:
        (pipe.shutdown if pkg is dali_tpu_torch else pipe._executor.shutdown)()
    return res


def _compare(build, data, layout, device, args=(), atol=0.0):
    got = _graph_run(dali_tpu_torch, build, data, layout, device, args)
    want = _graph_run(dali_tpu, build, data, layout, device, args)
    for (g_outs, g_lay), (w_outs, w_lay) in zip(got, want):
        assert g_lay == w_lay
        for g_out, w_out in zip(g_outs, w_outs):
            for g, w in zip(g_out, w_out):
                assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape,
                                                                  w.shape)
                if atol and np.issubdtype(g.dtype, np.floating):
                    np.testing.assert_allclose(g, w, atol=atol, rtol=0)
                else:
                    np.testing.assert_array_equal(g, w)
    return got


# ------------------------------------------------------------------ integer outputs


@pytest.mark.parametrize("name", sorted(INT_DTYPES))
@pytest.mark.parametrize("layout", ["CHW", "HWC"])
def test_integer_outputs_plain_matches_the_xla_convert(name, layout):
    """Float input holding values inside and outside the type's range, the
    extremes of int32, infinities and NaN, and the pad policy's fill: the
    reference converts each after float32 math; so does the plain version."""
    rng = np.random.default_rng(3)
    data = rng.uniform(-3e9, 3e9, (3, 12, 14, 3)).astype(np.float32)
    data[0] = rng.uniform(-300, 300, (12, 14, 3))
    data[1, :4] = rng.uniform(-1.5, 1.5, (4, 14, 3))
    data[2, 0, :6, 0] = [np.nan, np.inf, -np.inf, -0.7, 2.0 ** 31, -2.0 ** 31]
    cy, cx = np.array([1, 0, -2], np.int32), np.array([2, 0, 5], np.int32)
    mirror = np.array([1, 0, 1], np.int32)
    for fill in (None, [300.7, -1.5, np.nan]):
        kw = dict(output_layout=layout, ext_h=np.array([12, 10, 12], np.int32),
                  ext_w=np.array([14, 14, 9], np.int32),
                  fill=None if fill is None else np.asarray(fill, np.float32))
        size = (10, 11) if fill is None else (12, 14)
        want = ref_cmn.crop_mirror_normalize(
            jnp.asarray(data), jnp.asarray(cy if fill else np.maximum(cy, 0)), jnp.asarray(cx),
            jnp.asarray(mirror), *size, [0.0], [1.0], 1.0, 0.0,
            out_dtype=getattr(jnp, name.lower()), **kw)
        got = cmn.crop_mirror_normalize(
            torch.from_numpy(data), torch.from_numpy(cy if fill else np.maximum(cy, 0)),
            torch.from_numpy(cx), torch.from_numpy(mirror), *size, [0.0], [1.0], 1.0, 0.0,
            out_dtype=INT_DTYPES[name], **kw)
        assert got.dtype == INT_DTYPES[name]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", sorted(INT_DTYPES))
@pytest.mark.parametrize("device", ["cpu", "gpu"])
def test_integer_outputs_through_pipelines(name, device):
    """In range (mean/std of ImageNet, scale 64) and out of range (WIDE):
    the gpu op bit-equal to the reference's lowering, the cpu op to the
    reference's cpu op (numpy's astype on both sides, wrapping out of range
    as an x86 conversion does)."""
    def build(fn, types, x, m):
        dt = getattr(types, name)
        return (fn.crop_mirror_normalize(x, dtype=dt, mirror=m, crop=(24, 30), scale=64.0,
                                         mean=[123.7, 116.3, 103.5], std=[58.4, 57.1, 57.4]),
                fn.crop_mirror_normalize(x, dtype=dt, output_layout="HWC", crop=(28, 20),
                                         out_of_bounds_policy="pad", fill_values=[7.0],
                                         crop_pos_x=1.3, **WIDE))

    _compare(build, RAGGED, "HWC", device, (MIRROR,))


# ------------------------------------------------------------------ volumes and sequences


@pytest.mark.parametrize("kw", [
    dict(crop=(16, 18), crop_d=4, output_layout="CHW"),
    dict(crop=(12, 20), crop_d=3, output_layout="HWC", pad_output=True, crop_pos_y=0.2,
         rounding="truncate"),
    dict(output_layout="DCHW", crop_d=6, crop=(20, 24)),
], ids=["dchw", "dhwc_pad_output", "dchw_named"])
def test_volumes_fold_on_device(kw):
    """DHWC volumes of per-sample depth: the depth window at a per-sample
    ``crop_pos_z``, per-sample mirror; one launch over the folded slices."""
    def build(fn, types, x, m, z):
        return (fn.crop_mirror_normalize(x, mirror=m, crop_pos_z=z, mean=[10.0, 20.0],
                                         std=[30.0, 40.0], **kw),
                fn.crop_mirror_normalize(x, crop_pos_z=0.25, dtype=types.FLOAT16, mean=[50.0],
                                         std=[25.0], crop=(10, 10), crop_d=2))

    _compare(build, VOLUMES, "DHWC", "gpu", (MIRROR, POS), atol=1e-5)


def test_uint8_volumes_to_integers_fold_on_device():
    def build(fn, types, x, m):
        return fn.crop_mirror_normalize(x, mirror=m, crop_d=5, crop=(16, 16), dtype=types.INT16,
                                        **WIDE)

    _compare(build, UVOLUMES, "DHWC", "gpu", (MIRROR,))


@pytest.mark.parametrize("kw", [dict(output_layout="FCHW"), dict(output_layout="HWC",
                                                                 dtype="UINT8", scale=0.5)],
                         ids=["fchw", "fhwc_uint8"])
def test_sequences_fold_on_device(kw):
    """FHWC sequences: every frame of a sequence takes its sequence's
    per-sample arguments."""
    def build(fn, types, x, m, p):
        k = dict(kw, dtype=getattr(types, kw["dtype"])) if "dtype" in kw else kw
        return fn.crop_mirror_normalize(x, mirror=m, crop_pos_x=p, crop=(16, 20),
                                        mean=[100.0], std=[50.0], **k)

    _compare(build, SEQUENCES, "FHWC", "gpu", (MIRROR, POS), atol=1e-5)


# ------------------------------------------------------------------ the cpu placement


CPU_CASES = {
    "default": dict(crop=(24, 28)),
    "error_mirror_hwc": dict(crop=(30, 30), output_layout="HWC", crop_pos_x=0.2),
    "pad_fill": dict(crop=(40, 60), out_of_bounds_policy="pad", fill_values=[1.0, 2.0, 3.0],
                     crop_pos_x=1.2, crop_pos_y=-0.1),
    "pad_scalar_fill_pad_output": dict(crop=(44, 50), out_of_bounds_policy="pad",
                                       fill_values=[-5.0], pad_output=True),
    "trim": dict(crop=(44, 60), out_of_bounds_policy="trim_to_shape", crop_pos_x=0.7),
    "truncate_float16": dict(crop=(25, 31), crop_pos_y=0.7, rounding="truncate",
                             dtype="FLOAT16", scale=2.0, shift=-1.0),
    "uint8_out": dict(crop=(20, 20), dtype="UINT8", mean=[100.0], std=[0.5]),
    "int16_pad": dict(crop=(40, 40), out_of_bounds_policy="pad", dtype="INT16",
                      fill_values=[-3.0], **WIDE),
    "no_crop": dict(mean=[120.0, 110.0, 100.0], std=[60.0, 55.0, 50.0]),
}


@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_cpu_placement_bit_equal(case):
    def build(fn, types, x, m):
        kw = dict(CPU_CASES[case])
        if "dtype" in kw:
            kw["dtype"] = getattr(types, kw["dtype"])
        return fn.crop_mirror_normalize(x, mirror=m, **kw)

    _compare(build, RAGGED, "HWC", "cpu", (MIRROR,))


@pytest.mark.parametrize("kw", [
    dict(crop=(12, 16), crop_d=4),
    dict(crop=(24, 30), crop_d=9, out_of_bounds_policy="pad", fill_values=[5.0],
         output_layout="HWC"),
    dict(crop=(30, 30), crop_d=9, out_of_bounds_policy="trim_to_shape", pad_output=True),
], ids=["dchw", "pad_dhwc", "trim_pad_output"])
def test_cpu_placement_volumes_bit_equal(kw):
    def build(fn, types, x, m, z):
        return fn.crop_mirror_normalize(x, mirror=m, crop_pos_z=z, mean=[3.0], std=[7.0], **kw)

    _compare(build, VOLUMES, "DHWC", "cpu", (MIRROR, POS))


def test_cpu_placement_reads_a_tensor_crop_d():
    depths = [np.float32(d) for d in (2, 3, 4, 5, 6)]

    def build(fn, types, x, d):
        return fn.crop_mirror_normalize(x, crop_d=d, crop=(10, 12), mean=[5.0], std=[2.0])

    _compare(build, VOLUMES, "DHWC", "cpu", (depths,))


def test_cpu_placement_error_policy_raises():
    with pytest.raises(Exception, match="out of bounds"):
        _graph_run(dali_tpu_torch, lambda fn, types, x: fn.crop_mirror_normalize(
            x, crop=(60, 60)), RAGGED, "HWC", "cpu")


# ------------------------------------------------------------------ tensor crop sizes


@pytest.mark.parametrize("device", ["cpu", "gpu"])
def test_tensor_crop_size_is_ignored_by_the_reference_and_raises_in_the_port(device):
    """dali_tpu reads crop_h/crop_w with GetArgument (and, on the gpu,
    crop_d): a DataNode is ignored and the whole image comes out (ROADMAP.md
    Queue 3). The port raises."""
    sizes = [np.float32(16)] * N

    def build(fn, types, x, s):
        return fn.crop_mirror_normalize(x, crop_h=s, crop_w=s)

    (outs, _), = _graph_run(dali_tpu, build, RAGGED, "HWC", device, (sizes,))
    assert [o.shape for o in outs[0]] == [(3,) + r.shape[:2] for r in RAGGED]
    with pytest.raises(NotImplementedError, match=r"'crop_h'.*Queue 3, found in the reference"):
        _graph_run(dali_tpu_torch, build, RAGGED, "HWC", device, (sizes,))
