"""The transforms, CoordTransform and the gpu distortion operators of
dali_tpu_torch against dali_tpu on the CPU.

``transforms.*`` build [2, 3] float32 matrices on the host as the reference
does and agree within 1e-6 (they are bit-equal here); CoordTransform agrees
within 1e-6 on the cpu and on its gpu placement run on the CPU (against the
reference's gpu lowering with ``debug=True``). A warp by a composed matrix with
``inverse_map=False`` (the rn50_affine_mixup path's) is bit-equal. Water,
Sphere, GridMask and ColorTwist gpu agree with dali_tpu's lowerings within one
uint8 step (bit-equal here, ragged batches included); Jitter, whose
displacements the reference draws from threefry, is held by its determinism
and the range of its displacements.
"""

import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch

SEED = 31
RNG = np.random.default_rng(11)
IMGS = [RNG.integers(0, 256, (40 - 6 * (i % 3), 48 - 4 * (i % 2), 3), np.uint8)
        for i in range(5)]
POINTS = [RNG.uniform(-5, 60, (7 - i, 2)).astype(np.float32) for i in range(5)]
POINTS3 = [RNG.uniform(-5, 60, (4, 3)).astype(np.float32) for _ in range(5)]
POINTS_U = [RNG.uniform(-5, 60, (6, 2)).astype(np.float32) for _ in range(5)]
MATS = [RNG.uniform(-1, 1, (6,)).astype(np.float32) for _ in range(5)]
TOL = 1e-6


def _build(pkg, graph, batch=5, **kw):
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


def _runs(pkg, graph, n=2, **kw):
    pipe = _build(pkg, graph, **kw)
    try:
        res = []
        for _ in range(n):
            outs = []
            for tl in pipe.run():
                tl = tl.as_cpu() if hasattr(tl, "as_cpu") else tl
                outs.append([np.asarray(tl.at(i)) for i in range(len(tl))])
            res.append(outs)
        return res
    finally:
        if isinstance(pipe, dali_tpu_torch.Pipeline):
            pipe.shutdown()
        else:
            pipe._executor.shutdown()


def _close(g, w):
    """Integers equal; floats within TOL relative to the output's magnitude
    (XLA's CPU backend contracts the reference's small matrix products into
    FMAs, which moves float32 results by an ulp)."""
    assert g.dtype == w.dtype and g.shape == w.shape
    if np.issubdtype(w.dtype, np.floating):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL * max(1.0, float(np.abs(w).max())))
    else:
        np.testing.assert_array_equal(g, w)


def _compare(graph, **kw):
    got, want = _runs(dali_tpu_torch, graph, **kw), _runs(dali_tpu, graph, **kw)
    for g_it, w_it in zip(got, want):
        assert len(g_it) == len(w_it)
        for g_out, w_out in zip(g_it, w_it):
            for g, w in zip(g_out, w_out):
                _close(g, w)
    return got


def _src(fn, data, layout=""):
    return fn.external_source(source=lambda: data, batch=True, layout=layout)


def _u(fn, lo, hi, shape=None, **kw):
    return fn.random.uniform(range=[lo, hi], **({} if shape is None else {"shape": shape}), **kw)


TRANSFORMS = {
    "rotation": lambda fn, t: fn.transforms.rotation(angle=_u(fn, -30, 30), center=[16.0, 9.0]),
    "rotation_const": lambda fn, t: fn.transforms.rotation(angle=37.5),
    "scale": lambda fn, t: fn.transforms.scale(scale=_u(fn, 0.5, 2.0, [2]), center=[3.0, 4.0]),
    "scale_ndim": lambda fn, t: fn.transforms.scale(scale=[1.5], ndim=2),
    "translation": lambda fn, t: fn.transforms.translation(offset=_u(fn, -8, 8, [2])),
    "shear": lambda fn, t: fn.transforms.shear(shear=[0.2, -0.1], center=[5.0, 5.0]),
    "shear_angles": lambda fn, t: fn.transforms.shear(angles=fn.random.normal(
        stddev=3.0, shape=[2]), center=[112.0, 112.0]),
    "crop": lambda fn, t: fn.transforms.crop(from_start=_u(fn, 0, 0.3, [2]), from_end=[0.9, 1.0],
                                             to_start=[0.0, 0.0], to_end=[64.0, 48.0]),
    "crop_absolute": lambda fn, t: fn.transforms.crop(from_start=[10.0, 40.0], from_end=[2.0, 5.0],
                                                      to_end=[1.0, 1.0], absolute=True),
    "chain": lambda fn, t: fn.transforms.shear(
        fn.transforms.scale(fn.transforms.rotation(angle=_u(fn, -15, 15), center=[112.0, 112.0]),
                            scale=_u(fn, 0.9, 1.1, [2]), center=[112.0, 112.0]),
        angles=fn.random.normal(stddev=3.0, shape=[2]), center=[112.0, 112.0]),
    "chain_reverse": lambda fn, t: fn.transforms.translation(
        fn.transforms.rotation(angle=20.0), offset=[3.0, -2.0], reverse_order=True),
    "combine": lambda fn, t: fn.transforms.combine(
        fn.transforms.rotation(angle=_u(fn, -15, 15)),
        fn.transforms.translation(offset=_u(fn, -8, 8, [2])), fn.transforms.scale(scale=[2.0, 0.5])),
    "combine_reverse": lambda fn, t: fn.transforms.combine(
        fn.transforms.rotation(angle=10.0), fn.transforms.translation(offset=[1.0, 2.0]),
        reverse_order=True),
    "legacy_translation": lambda fn, t: fn.transform_translation(offset=[4.0, -1.0]),
}


@pytest.mark.parametrize("case", sorted(TRANSFORMS))
def test_transforms_match_dali_tpu(case):
    got = _compare(TRANSFORMS[case])
    assert all(m.shape == (2, 3) and m.dtype == np.float32 for m in got[0][0])


COORDS = {
    "identity": lambda fn, t, p, **kw: fn.coord_transform(p, **kw),
    "m_t": lambda fn, t, p, **kw: fn.coord_transform(p, M=[0.5, 1.0, -1.0, 2.0], T=[3.0, -4.0],
                                                     **kw),
    "m_raises_dim": lambda fn, t, p, **kw: fn.coord_transform(
        p, M=[1.0, 0.0, 0.0, 1.0, 1.0, 1.0], **kw),
    # explicit seeds: the draws do not depend on where the copy to the device sits
    "m_per_sample": lambda fn, t, p, **kw: fn.coord_transform(
        p, M=_u(fn, -1, 1, [4], seed=3), T=_u(fn, -2, 2, [2], seed=4), **kw),
    "m_per_sample_dim": lambda fn, t, p, **kw: fn.coord_transform(p, M=_src(fn, MATS), **kw),
}


def _coords(case, points, device):
    def graph(fn, t):
        p = _src(fn, points)
        if device == "gpu":
            return COORDS[case](fn, t, p.gpu(), device="gpu")
        return COORDS[case](fn, t, p)

    return graph


@pytest.mark.parametrize("device", ["cpu", "gpu"])
@pytest.mark.parametrize("case", sorted(COORDS))
def test_coord_transform_matches_dali_tpu(case, device):
    """The gpu placement on uniform point sets: the reference's gpu lowering
    raises on ragged ones (below)."""
    _compare(_coords(case, POINTS if device == "cpu" else POINTS_U, device))


def test_coord_transform_three_d_and_dtype():
    _compare(lambda fn, t: (
        fn.coord_transform(_src(fn, POINTS3), T=[1.0, 2.0, 3.0], dtype=t.FLOAT64),
        fn.coord_transform(_src(fn, POINTS3).gpu(), T=[1.0, 2.0, 3.0], device="gpu")))


@pytest.mark.parametrize("case", sorted(COORDS))
def test_coord_transform_gpu_on_ragged_points(case):
    """Ragged point sets on the device keep their per-sample counts and
    equal the host op. Where the matrix keeps the coordinate dim, the
    reference's gpu lowering raises there (``DeviceBatch.with_data`` compares
    the host shapes array with "keep", ``dali_tpu/backend/warp.py:712``;
    ROADMAP.md Queue 3); elsewhere the port equals it."""
    gpu = _runs(dali_tpu_torch, _coords(case, POINTS, "gpu"))
    cpu = _runs(dali_tpu_torch, _coords(case, POINTS, "cpu"))
    for g_it, c_it in zip(gpu, cpu):
        for g, c in zip(g_it[0], c_it[0]):
            _close(g, c)
    if case in ("identity", "m_t", "m_per_sample"):  # the coordinate dim kept
        with pytest.raises(ValueError, match="truth value"):
            _runs(dali_tpu, _coords(case, POINTS, "gpu"), n=1)
    else:
        want = _runs(dali_tpu, _coords(case, POINTS, "gpu"))
        for g_it, w_it in zip(gpu, want):
            for g, w in zip(g_it[0], w_it[0]):
                _close(g, w)


def test_coord_transform_positional_matrix_input():
    """A transforms matrix as CoordTransform's second input (cpu): its last
    column is the translation."""
    _compare(lambda fn, t: fn.coord_transform(
        _src(fn, POINTS), fn.transforms.rotation(angle=_u(fn, -40, 40), center=[20.0, 20.0])))


def test_coord_transform_gpu_positional_matrix_raises():
    with pytest.raises(ValueError, match="keyword"):
        _runs(dali_tpu_torch, lambda fn, t: fn.coord_transform(
            _src(fn, POINTS).gpu(), fn.transforms.rotation(angle=5.0).gpu()), n=1)


@pytest.mark.parametrize("inverse_map", [False, True])
def test_warp_by_composed_transforms_matches_dali_tpu(inverse_map):
    """The rn50_affine_mixup warp: a rotation, scale, shear and translation
    composed on the host, applied on the device; the gather route (a rotation
    is not separable), the matrix inverted on the host for
    ``inverse_map=False``."""
    def graph(fn, t):
        c = [24.0, 20.0]
        mt = fn.transforms.rotation(angle=_u(fn, -15, 15), center=c)
        mt = fn.transforms.scale(mt, scale=_u(fn, 0.9, 1.1, [2]), center=c)
        mt = fn.transforms.shear(mt, angles=fn.random.normal(stddev=3.0, shape=[2]), center=c)
        mt = fn.transforms.combine(mt, fn.transforms.translation(offset=_u(fn, -8, 8, [2])))
        return fn.warp_affine(_src(fn, IMGS, "HWC").gpu(), matrix=mt, fill_value=0.0,
                              inverse_map=inverse_map), mt

    _compare(graph)


DISTORTIONS = {
    "water": lambda fn, t, x: fn.water(x),
    "water_linear_fill": lambda fn, t, x: fn.water(x, interp_type=1, fill_value=17.0,
                                                   ampl_x=4.0, freq_y=0.2, phase_x=0.5),
    "water_mask": lambda fn, t, x: fn.water(x, mask=fn.random.coin_flip()),
    "sphere": lambda fn, t, x: fn.sphere(x),
    "sphere_linear_mask": lambda fn, t, x: fn.sphere(x, interp_type=1,
                                                     mask=fn.random.coin_flip(probability=0.7)),
    "grid_mask": lambda fn, t, x: fn.grid_mask(x, tile=16, ratio=0.4, angle=0.3),
    "grid_mask_per_sample": lambda fn, t, x: fn.grid_mask(
        x, tile=fn.cast(_u(fn, 8, 20), dtype=t.INT32), ratio=_u(fn, 0.2, 0.6),
        angle=_u(fn, -1, 1), shift_x=_u(fn, 0, 5), shift_y=_u(fn, 0, 5)),
    "color_twist": lambda fn, t, x: fn.color_twist(x, hue=15.0, saturation=0.8, brightness=1.1,
                                                   contrast=1.2),
    "color_twist_per_sample": lambda fn, t, x: fn.color_twist(
        x, hue=_u(fn, -40, 40), saturation=_u(fn, 0.5, 1.5), brightness=_u(fn, 0.7, 1.3),
        contrast=_u(fn, 0.6, 1.4)),
    "color_twist_float_out": lambda fn, t, x: fn.color_twist(x, hue=30.0, dtype=t.FLOAT),
}


@pytest.mark.parametrize("uniform", [False, True], ids=["ragged", "uniform"])
@pytest.mark.parametrize("case", sorted(DISTORTIONS))
def test_distortion_ops_match_dali_tpu(case, uniform):
    data = [im[:28, :36] for im in IMGS] if uniform else IMGS
    got = _compare(lambda fn, t: DISTORTIONS[case](fn, t, _src(fn, data, "HWC").gpu()))
    assert [g.shape for g in got[0][0]] == [d.shape for d in data]


def test_distortion_cpu_placements_name_their_item():
    for op in ("water", "sphere", "jitter", "grid_mask", "color_twist"):
        with pytest.raises(NotImplementedError, match=r"Queue 1, item 5h"):
            _build(dali_tpu_torch, lambda fn, t, op=op: getattr(fn, op)(_src(fn, IMGS, "HWC")))


def test_jitter_by_determinism_and_displacement_range():
    """nDegree 4: each output pixel is a source pixel at most 2 away in each
    axis, or the fill; the same seed gives the same output, the next
    iteration new displacements."""
    ramp = [np.stack([np.broadcast_to(np.arange(48, dtype=np.uint8)[None, :], (40, 48)),
                      np.broadcast_to(np.arange(40, dtype=np.uint8)[:, None], (40, 48)),
                      np.full((40, 48), 200, np.uint8)], -1) for _ in range(5)]

    def graph(fn, t):
        return fn.jitter(_src(fn, ramp, "HWC").gpu(), nDegree=4, fill_value=255.0)

    a, b = _runs(dali_tpu_torch, graph), _runs(dali_tpu_torch, graph)
    for x, y in zip(a, b):
        for g, w in zip(x[0], y[0]):
            np.testing.assert_array_equal(g, w)
    assert not all(np.array_equal(g, w) for g, w in zip(a[0][0], a[1][0]))
    ys, xs = np.mgrid[:40, :48]
    moved = 0
    for out in a[0][0]:
        inside = out[..., 2] == 200
        dx = out[..., 0].astype(int) - xs
        dy = out[..., 1].astype(int) - ys
        assert (np.abs(dx[inside]) <= 2).all() and (np.abs(dy[inside]) <= 2).all()
        assert ((out[~inside] == 255).all())
        moved += int((dx[inside] != 0).sum())
    assert moved > 0
