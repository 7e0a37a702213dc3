"""The random and noise operators of dali_tpu_torch on the CPU, and the
rn50_affine_mixup path against dali_tpu.

Host ops (random.Uniform, Normal, CoinFlip, Beta, Choice, BatchPermutation,
noise.Gaussian, noise.SaltAndPepper and noise.Shot cpu) key the reference's
Philox streams and are bit-equal to dali_tpu through pipelines built node for
node. Device ops (random.* and noise.* gpu) draw from a torch generator keyed
by (seed, the batch's iteration), which cannot reproduce the reference's
threefry: they are held to the contract of ROADMAP.md Queue 3 (the right
distribution by a KS test against scipy at a fixed seed, p > 1e-3 (each
float32 draw standing for its rounding cell), or by
moments within 3 standard errors; bit-identical output for the same seed and
iteration; a new stream for a new iteration; a checkpoint that resumes the
same batches; the global torch generator untouched). Their deterministic
parts (noise.Gaussian with stddev 0, rounding half to even and clipping;
noise.Shot with factor <= 0; salt and pepper at probability 0 or 1) are
bit-equal to dali_tpu's gpu lowerings with ``debug=True``.
"""

import os

import numpy as np
import pytest
import torch
from scipy import stats

import chip_smoke
import dali_tpu
import dali_tpu_torch
from dali_tpu_torch.tools import bench_affine_mixup

SEED = 23
RNG = np.random.default_rng(5)
IMGS = [RNG.integers(0, 256, (20 + 4 * i, 24 - 2 * i, 3), np.uint8) for i in range(6)]
FIMGS = [RNG.uniform(0, 200, (12, 10 + i, 3)).astype(np.float32) for i in range(6)]
SCALARS = [np.asarray(v, np.int32) for v in (5, 3, 7, 1, 9, 4)]
VECS = [RNG.integers(-50, 50, (6,)).astype(np.int16) for _ in range(6)]
WEIGHTS = [RNG.uniform(0.1, 1.0, (6,)).astype(np.float32) for _ in range(6)]
KS_P = 1e-3


def _build(pkg, graph, batch=6, seed=SEED, **kw):
    if pkg is dali_tpu_torch:
        kw.setdefault("device", "cpu")
    else:
        kw.setdefault("debug", True)

    @pkg.pipeline_def(batch_size=batch, num_threads=1, seed=seed, **kw)
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


def _outputs(outs):
    res = []
    for tl in outs:
        if hasattr(tl, "as_cpu"):
            tl = tl.as_cpu()
        res.append([np.asarray(tl.at(i)) for i in range(len(tl))])
    return res


def _runs(pkg, graph, n=2, **kw):
    pipe = _build(pkg, graph, **kw)
    try:
        return [_outputs(pipe.run()) for _ in range(n)]
    finally:
        _close(pipe)


def _bit_equal(got, want):
    for g_it, w_it in zip(got, want):
        assert len(g_it) == len(w_it)
        for g_out, w_out in zip(g_it, w_it):
            for g, w in zip(g_out, w_out):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)


def _src(fn, data, layout=""):
    return fn.external_source(source=lambda: data, batch=True, layout=layout)


# ------------------------------------------------------------------ host ops, bit-equal

HOST_CASES = {
    "uniform_range": lambda fn, t: fn.random.uniform(range=[-3.0, 5.0]),
    "uniform_values_shape": lambda fn, t: fn.random.uniform(values=[0.5, 2.0, 7.0], shape=[3, 2]),
    "uniform_per_sample_shape": lambda fn, t: fn.random.uniform(
        shape=fn.cast(fn.random.uniform(range=[1.0, 5.0], shape=[2]), dtype=t.INT32)),
    "uniform_like_input": lambda fn, t: fn.random.uniform(_src(fn, IMGS, "HWC"), seed=4),
    "normal": lambda fn, t: fn.random.normal(mean=2.0, stddev=0.5),
    "normal_shape_dtype": lambda fn, t: fn.random.normal(shape=[4], dtype=t.FLOAT64),
    # dtype=UINT8 is enum value 0: the reference's `dtype or default` gives float
    "normal_dtype_uint8_quirk": lambda fn, t: fn.random.normal(dtype=t.UINT8, shape=[3]),
    "normal_per_sample": lambda fn, t: fn.random.normal(
        mean=fn.random.uniform(range=[0.0, 10.0]), stddev=fn.random.uniform(range=[0.1, 2.0]),
        shape=[5]),
    "normal_explicit_seed": lambda fn, t: fn.random.normal(seed=99),
    "coin_flip_per_sample": lambda fn, t: fn.random.coin_flip(
        probability=fn.random.uniform(range=[0.0, 1.0]), shape=[8]),
    "beta": lambda fn, t: fn.random.beta(alpha=0.2, beta=0.2),
    "beta_per_sample_shape": lambda fn, t: fn.random.beta(
        alpha=fn.random.uniform(range=[0.5, 3.0]), beta=2.5, shape=[2, 3]),
    "choice_range": lambda fn, t: fn.random.choice(_src(fn, SCALARS)),
    "choice_range_shape": lambda fn, t: fn.random.choice(_src(fn, SCALARS), shape=[4]),
    "choice_values_p": lambda fn, t: fn.random.choice(_src(fn, VECS), p=_src(fn, WEIGHTS),
                                                      shape=[3]),
    "choice_const_p": lambda fn, t: fn.random.choice(_src(fn, VECS),
                                                     p=[0.5, 0.1, 0.1, 0.1, 0.1, 0.1]),
    "batch_permutation": lambda fn, t: fn.batch_permutation(),
    "batch_permutation_no_fixed_points": lambda fn, t: fn.batch_permutation(
        no_fixed_points=True),
    "batch_permutation_repetitions": lambda fn, t: fn.batch_permutation(allow_repetitions=True),
    "batch_permutation_repetitions_no_fixed": lambda fn, t: fn.batch_permutation(
        allow_repetitions=True, no_fixed_points=True, seed=11),
    "gaussian_uint8": lambda fn, t: fn.noise.gaussian(_src(fn, IMGS, "HWC"), stddev=20.0),
    "gaussian_float_per_sample": lambda fn, t: fn.noise.gaussian(
        _src(fn, FIMGS, "HWC"), mean=fn.random.uniform(range=[-1.0, 1.0]), stddev=3.0),
    "salt_and_pepper": lambda fn, t: fn.noise.salt_and_pepper(_src(fn, IMGS, "HWC"), prob=0.2),
    "salt_and_pepper_per_channel": lambda fn, t: fn.noise.salt_and_pepper(
        _src(fn, IMGS, "HWC"), prob=fn.random.uniform(range=[0.0, 0.5]), salt_vs_pepper=0.3,
        per_channel=True, salt_val=200.0, pepper_val=10.0),
    "salt_and_pepper_float": lambda fn, t: fn.noise.salt_and_pepper(_src(fn, FIMGS, "HWC")),
    "shot_uint8": lambda fn, t: fn.noise.shot(_src(fn, IMGS, "HWC"), factor=3.0),
    "shot_float_per_sample": lambda fn, t: fn.noise.shot(
        _src(fn, FIMGS, "HWC"), factor=fn.random.uniform(range=[-2.0, 8.0])),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_random_ops_bit_equal_dali_tpu(case):
    graph = HOST_CASES[case]
    _bit_equal(_runs(dali_tpu_torch, graph), _runs(dali_tpu, graph))


def test_batch_permutation_properties():
    got = _runs(dali_tpu_torch, lambda fn, t: (
        fn.batch_permutation(), fn.batch_permutation(no_fixed_points=True),
        fn.batch_permutation(allow_repetitions=True)), n=3, batch=7)
    for perm, derange, rep in got:
        assert sorted(int(p) for p in perm) == list(range(7))
        assert sorted(int(p) for p in derange) == list(range(7))
        assert all(int(p) != i for i, p in enumerate(derange))
        assert all(0 <= int(p) < 7 and p.dtype == np.int32 for p in rep)


# ------------------------------------------------------------------ schemas

NEW_SCHEMAS = ["random.Normal", "random.Beta", "random.Choice", "BatchPermutation",
               "random.Uniform", "random.CoinFlip", "noise.Gaussian", "noise.SaltAndPepper",
               "noise.Shot", "transforms.Rotation", "transforms.Scale", "transforms.Translation",
               "transforms.Shear", "transforms.Crop", "transforms.Combine", "TransformTranslation",
               "CoordTransform", "PythonFunction", "DLTensorPythonFunction",
               "TorchPythonFunction", "NumbaFunction", "Water", "Sphere", "Jitter", "GridMask",
               "ColorTwist"]


@pytest.mark.parametrize("name", NEW_SCHEMAS)
def test_schemas_declare_the_references_arguments(name):
    from dali_tpu import _schema as ref_schema
    from dali_tpu_torch import _schema

    mine, ref = _schema.GetSchema(name), ref_schema.GetSchema(name)
    assert set(mine.args) == set(ref.args)
    for k, a in mine.args.items():
        r = ref.args[k]
        assert (a.type, a.default, a.tensor_ok, a.per_sample, a.required) == (
            r.type, r.default, r.tensor_ok, r.per_sample, r.required), (name, k)
    assert (mine.min_inputs, mine.max_inputs, set(mine.devices), mine.has_random_seed) == (
        ref.min_inputs, ref.max_inputs, set(ref.devices), ref.has_random_seed)


def test_ported_names_register_on_every_device_of_the_reference():
    from dali_tpu import _schema as ref_schema
    from dali_tpu_torch import _schema
    from dali_tpu_torch.backend import parity

    names = ["random.Normal", "random.Beta", "random.Choice", "BatchPermutation",
             "noise.Gaussian", "noise.Shot", "noise.SaltAndPepper", "random.Uniform",
             "random.CoinFlip", "Uniform", "CoinFlip", "NormalDistribution",
             "transforms.Rotation", "transforms.Scale", "transforms.Translation",
             "transforms.Shear", "transforms.Crop", "transforms.Combine",
             "TransformTranslation", "CoordTransform", "PythonFunction",
             "DLTensorPythonFunction", "TorchPythonFunction", "NumbaFunction"]
    for name in names:
        devices = {d for (n, d) in ref_schema._impl_registry if n == name}
        assert devices and all(_schema.has_operator_impl(name, d) for d in devices), name
    for name in ("Water", "Sphere", "Jitter", "GridMask"):  # both placements since item 5h
        assert _schema.has_operator_impl(name, "gpu")
        assert _schema.has_operator_impl(name, "cpu")
    assert all(_schema.has_operator_impl("ColorTwist", d) for d in ("cpu", "gpu"))
    assert parity.RENAMED == {"_JaxFunction": "_TorchFunction"}
    assert _schema.has_operator_impl("_TorchFunction", "gpu")
    for item in ("item 5b", "item 5c", "item 5f"):
        assert item not in parity.QUEUE_ITEMS.values()


# ------------------------------------------------------------------ device ops: the contract

def _device_graph(fn, t):
    x = _src(fn, IMGS, "HWC").gpu()
    f = _src(fn, FIMGS, "HWC").gpu()
    return (fn.random.uniform(range=[-1.0, 2.0], shape=[5], device="gpu"),
            fn.random.normal(mean=fn.random.uniform(range=[0.0, 3.0]), shape=[4], device="gpu"),
            fn.random.coin_flip(device="gpu"),
            fn.random.beta(alpha=fn.random.uniform(range=[0.5, 1.0], device="gpu"), beta=2.0,
                           device="gpu"),
            fn.random.uniform(values=[1.0, 4.0, 9.0], shape=[3], dtype=t.INT32, device="gpu"),
            fn.noise.gaussian(x, stddev=fn.random.uniform(range=[1.0, 8.0], device="gpu")),
            fn.noise.salt_and_pepper(x, prob=0.3),
            fn.noise.shot(f, factor=2.0),
            fn.jitter(x, nDegree=4))


def test_device_random_ops_same_seed_same_output_new_iteration_new_stream():
    a = _runs(dali_tpu_torch, _device_graph, n=3)
    b = _runs(dali_tpu_torch, _device_graph, n=3)
    _bit_equal(a, b)
    for k in range(len(a[0])):
        assert not all(np.array_equal(x, y) for x, y in zip(a[0][k], a[1][k])), k
    c = _runs(dali_tpu_torch, _device_graph, n=1, seed=SEED + 1)
    assert not all(np.array_equal(x, y) for x, y in zip(a[0][0], c[0][0]))


def test_device_draws_key_on_the_batch_not_the_prefetch_depth():
    shallow = _runs(dali_tpu_torch, _device_graph, n=4, prefetch_queue_depth=1)
    deep = _runs(dali_tpu_torch, _device_graph, n=4, prefetch_queue_depth=3)
    _bit_equal(shallow, deep)


def test_explicit_seed_is_position_independent_on_the_device():
    def one(fn, t):
        return fn.random.normal(shape=[6], seed=77, device="gpu")

    def shifted(fn, t):
        fn.random.uniform(device="gpu")
        return fn.random.normal(shape=[6], seed=77, device="gpu")

    _bit_equal(_runs(dali_tpu_torch, one), _runs(dali_tpu_torch, shifted))


def test_device_checkpoint_resumes_the_same_batches():
    pipe = _build(dali_tpu_torch, _device_graph, enable_checkpointing=True)
    try:
        pipe.run()
        ckpt = pipe.checkpoint()
        want = [_outputs(pipe.run()) for _ in range(2)]
    finally:
        pipe.shutdown()
    again = _build(dali_tpu_torch, _device_graph, checkpoint=ckpt)
    try:
        got = [_outputs(again.run()) for _ in range(2)]
    finally:
        again.shutdown()
    _bit_equal(got, want)


def test_pipeline_leaves_the_global_generators_untouched():
    torch.manual_seed(1234)
    before = torch.random.get_rng_state()
    np_before = np.random.get_state()[1].copy()
    _runs(dali_tpu_torch, _device_graph, n=2)
    assert torch.equal(torch.random.get_rng_state(), before)
    np.testing.assert_array_equal(np.random.get_state()[1], np_before)


def test_port_draws_pass_a_generator():
    """No device draw of the port may fall back to the global generator:
    every torch.rand/randn/randint/poisson/_standard_gamma call in the
    operators passes ``generator=``, and nothing reseeds torch."""
    import re

    root = os.path.join(os.path.dirname(dali_tpu_torch.__file__), "backend")
    for name in sorted(os.listdir(root)):
        src = open(os.path.join(root, name)).read() if name.endswith(".py") else ""
        assert "manual_seed(" not in src.replace("g.manual_seed(", ""), name
        assert ".sample(" not in src, name
        for m in re.finditer(r"torch\.(rand|randn|randint|poisson|_standard_gamma)\(", src):
            depth, i = 1, m.end()
            while depth:
                depth += {"(": 1, ")": -1}.get(src[i], 0)
                i += 1
            assert "generator=" in src[m.end():i], (name, src[m.start():i])


DIST = 6000


def _dist_graph(fn, t):
    return (fn.random.uniform(range=[-2.0, 3.0], shape=[DIST], device="gpu"),
            fn.random.normal(mean=1.0, stddev=2.0, shape=[DIST], device="gpu"),
            fn.random.beta(alpha=0.2, beta=0.2, shape=[DIST], device="gpu"),
            fn.random.beta(alpha=2.0, beta=5.0, shape=[DIST], device="gpu"),
            fn.random.coin_flip(probability=0.3, shape=[DIST], device="gpu"),
            fn.random.uniform(values=[1.0, 4.0, 9.0], shape=[DIST], device="gpu"))


@pytest.mark.parametrize("k,dist", [(0, stats.uniform(-2.0, 5.0)), (1, stats.norm(1.0, 2.0)),
                                    (2, stats.beta(0.2, 0.2)), (3, stats.beta(2.0, 5.0))],
                         ids=["uniform", "normal", "beta_mixup", "beta_2_5"])
def test_device_random_ops_ks_against_scipy(k, dist):
    (outs,) = _runs(dali_tpu_torch, _dist_graph, n=1, batch=4)
    values = np.concatenate([s.astype(np.float64) for s in outs[k]])
    assert values.size == 4 * DIST and outs[k][0].dtype == np.float32
    assert bench_affine_mixup.ks_pvalue(values, dist.cdf) > KS_P


def test_device_discrete_draws_by_chi_square():
    (outs,) = _runs(dali_tpu_torch, _dist_graph, n=1, batch=4)
    coin = np.concatenate(outs[4])
    assert coin.dtype == np.int32 and set(np.unique(coin)) <= {0, 1}
    assert stats.binomtest(int(coin.sum()), coin.size, 0.3).pvalue > KS_P
    vals = np.concatenate(outs[5])
    counts = [(vals == v).sum() for v in (1.0, 4.0, 9.0)]
    assert sum(counts) == vals.size
    assert stats.chisquare(counts).pvalue > KS_P


def test_device_noise_by_its_distribution():
    x = [np.full((40, 50, 3), v, np.uint8) for v in (0, 3, 128, 250, 255, 90)]
    f = [np.full((30, 40, 3), v, np.float32) for v in (10.0, 40.0, 100.0, 7.0, 55.0, 0.0)]

    def graph(fn, t):
        s = fn.random.uniform(range=[0.5, 6.0])
        return (fn.noise.gaussian(_src(fn, x, "HWC").gpu(), stddev=s), s,
                fn.noise.shot(_src(fn, f, "HWC").gpu(), factor=5.0),
                fn.noise.salt_and_pepper(_src(fn, x, "HWC").gpu(), prob=0.25, salt_vs_pepper=0.4))

    (outs,) = _runs(dali_tpu_torch, graph, n=1)
    noisy, std, shot, snp = outs
    z = bench_affine_mixup.hold_noise(torch.from_numpy(np.stack(x)),
                                      torch.from_numpy(np.stack(noisy)),
                                      torch.from_numpy(np.stack(std)))
    assert all(abs(v) <= 3.0 for v in z)
    for s, v in zip(shot, f):
        q = s.astype(np.float64) / 5.0
        np.testing.assert_array_equal(q, np.round(q))
        lam = v[0, 0, 0] / 5.0
        if lam == 0:
            assert not s.any()
        else:
            assert abs(q.mean() - lam) <= 3 * np.sqrt(lam / q.size)
    # one draw per pixel: salt (255) with probability 0.1, pepper (0) 0.15;
    # salt on a 255 pixel or pepper on a 0 pixel leaves it as it was
    for a, b in zip(snp, x):
        v = int(b[0, 0, 0])
        p = 0.1 * (v != 255) + 0.15 * (v != 0)
        hit = (a != b).any(-1)
        assert abs(hit.mean() - p) <= 3 * np.sqrt(p * (1 - p) / hit.size)
        assert set(np.unique(a[a != b])) <= {0, 255}


# the deterministic parts of the device noise, bit-equal to dali_tpu's lowerings
NOISE_EXACT = {
    "gaussian_round_half_even": lambda fn, t: fn.noise.gaussian(
        _src(fn, IMGS, "HWC").gpu(), mean=0.5, stddev=0.0),
    "gaussian_clip": lambda fn, t: fn.noise.gaussian(
        _src(fn, IMGS, "HWC").gpu(), mean=fn.random.uniform(range=[-300.0, 300.0]), stddev=0.0),
    "gaussian_float": lambda fn, t: fn.noise.gaussian(_src(fn, FIMGS, "HWC").gpu(), mean=-2.5,
                                                      stddev=0.0),
    "shot_factor_off": lambda fn, t: fn.noise.shot(_src(fn, IMGS, "HWC").gpu(), factor=0.0),
    "salt_and_pepper_off": lambda fn, t: fn.noise.salt_and_pepper(
        _src(fn, IMGS, "HWC").gpu(), prob=0.0),
    "salt_all": lambda fn, t: fn.noise.salt_and_pepper(
        _src(fn, IMGS, "HWC").gpu(), prob=1.0, salt_vs_pepper=1.0),
    "pepper_all_float": lambda fn, t: fn.noise.salt_and_pepper(
        _src(fn, FIMGS, "HWC").gpu(), prob=1.0, salt_vs_pepper=0.0, pepper_val=-1.0),
}


@pytest.mark.parametrize("case", sorted(NOISE_EXACT))
def test_device_noise_deterministic_parts_equal_dali_tpu(case):
    graph = NOISE_EXACT[case]
    _bit_equal(_runs(dali_tpu_torch, graph), _runs(dali_tpu, graph))


def test_device_random_per_sample_shape_canvas():
    shapes = [np.asarray(s, np.int32) for s in ([2, 3], [4, 1], [1, 5], [3, 3], [2, 2], [4, 4])]
    pipe = _build(dali_tpu_torch, lambda fn, t: fn.random.normal(
        shape=_src(fn, shapes), device="gpu"))
    ref = _build(dali_tpu, lambda fn, t: fn.random.normal(shape=_src(fn, shapes), device="gpu"))
    try:
        (out,) = pipe.run()
        (want,) = ref.run()
    finally:
        _close(pipe)
        _close(ref)
    assert tuple(out.as_tensor().shape) == (6, 4, 5) == tuple(np.asarray(want.as_tensor()).shape)
    assert [out.at(i).shape for i in range(6)] == [tuple(s) for s in shapes]
    assert [out.at(i).shape for i in range(6)] == [np.asarray(want.at(i)).shape for i in range(6)]


def test_device_random_shape_on_a_gpu_edge_raises():
    with pytest.raises(ValueError, match="cpu tensor"):
        _runs(dali_tpu_torch, lambda fn, t: fn.random.uniform(
            shape=fn.cast(fn.random.uniform(range=[1.0, 3.0], shape=[2], device="gpu"),
                          dtype=t.INT32), device="gpu"), n=1)


def test_eager_device_random_draws_on_the_device():
    import dali_tpu_torch.experimental.dynamic as ndd

    with ndd.EvalContext(seed=3, device="cpu"):
        b = ndd.as_batch(IMGS, layout="HWC").gpu()
        u1 = ndd.random.uniform(b, range=[0.0, 1.0])
        u2 = ndd.random.uniform(b, range=[0.0, 1.0])
        n = ndd.noise.gaussian(b, stddev=2.0)
    assert u1.is_gpu and n.is_gpu
    v1 = np.asarray([np.asarray(s) for s in u1.cpu()._samples])
    assert v1.shape == (6,) and ((v1 >= 0) & (v1 < 1)).all()
    assert not np.array_equal(v1, np.asarray([np.asarray(s) for s in u2.cpu()._samples]))


# ------------------------------------------------------------------ the rn50_affine_mixup graph

def test_rn50_affine_mixup_matches_dali_tpu():
    """The whole graph at batch 4, 64 px, in both packages with the device
    noise's stddev a constant 0: labels, permutations, lam and matrices
    equal; images within one uint8 step / std (here bit-equal)."""
    file_list = chip_smoke.write_file_list()
    lsb = 1.0 / min(bench_affine_mixup.STD) + 1e-4
    names = bench_affine_mixup.OUTPUTS + bench_affine_mixup.EXTRAS
    graph = lambda fn, t: bench_affine_mixup.affine_mixup_graph(  # noqa: E731
        fn, t, file_list, 64, noise_stddev=0.0, extras=True)
    got = _runs(dali_tpu_torch, graph, batch=4, seed=42)
    want = _runs(dali_tpu, graph, batch=4, seed=42)
    for g_it, w_it in zip(got, want):
        g, w = dict(zip(names, g_it)), dict(zip(names, w_it))
        for k in ("label", "label_b", "lam", "matrix", "perm", "warped", "noisy"):
            for a, b in zip(g[k], w[k]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        for k in ("data", "normalized"):
            d = np.abs(np.stack(g[k]) - np.stack(w[k]))
            assert d.shape == (4, 3, 64, 64) and d.max() <= lsb and (d > 1e-4).mean() <= 1e-3
        lam = np.stack(g["lam"])
        assert ((lam >= 0) & (lam <= 1)).all()
        assert sorted(int(p) for p in g["perm"]) == [0, 1, 2, 3]


def test_rn50_affine_mixup_device_noise_on_the_cpu():
    """The path with its device-drawn stddev on the CPU: host draws equal
    between two runs, the noise held by its distribution, mixup by its
    formula, and the same seed bit-identical."""
    file_list = chip_smoke.write_file_list()
    names = bench_affine_mixup.OUTPUTS + bench_affine_mixup.EXTRAS + ("stddev",)
    runs = []
    for _ in range(2):
        pipe = bench_affine_mixup.make_pipe(file_list, 8, 64, "cpu", extras=True, num_threads=2)
        try:
            runs.append([dict(zip(names, [o.as_tensor() for o in pipe.run()])) for _ in range(2)])
        finally:
            pipe.shutdown()
    for a, b in zip(*runs):
        for k in names:
            assert torch.equal(a[k], b[k]), k
        s = a["stddev"]
        assert s.shape == (8,) and bool(((s >= 0) & (s < bench_affine_mixup.NOISE_MAX)).all())
        z = bench_affine_mixup.hold_noise(a["warped"], a["noisy"], s)
        assert all(abs(v) <= 3.0 for v in z)
        lam = a["lam"].reshape(-1, 1, 1, 1)
        want = a["normalized"] * lam + a["normalized"][a["perm"].long()] * (1.0 - lam)
        assert float((a["data"] - want).abs().max()) <= 1e-5
    assert not torch.equal(runs[0][0]["stddev"], runs[0][1]["stddev"])
