"""rn50_affine_mixup: RN50 training input with DALI's geometric-transforms
recipe, device noise and mixup, and the random, noise, distortion and
Python-function operators on the card.

* rn50_affine_mixup: rn50_train's reader, hybrid decode and resize; a
  per-sample affine matrix built on the host by ``transforms.rotation``,
  ``scale``, ``shear``, ``translation`` and ``combine`` from host random
  draws, applied by ``warp_affine`` (``inverse_map=False``: the gather
  route); ``noise.gaussian`` whose per-sample ``stddev`` is drawn on the
  device (``random.uniform(device="gpu")``); CMN with a coin-flip mirror;
  then mixup (alpha = 0.2) with a ``batch_permutation``: images * lam +
  images[perm] * (1 - lam), with the permuted labels and lam as outputs.
* random_ops: every device random and noise operator at a full batch
  ([256, 224, 224, 3]), held by its moments and a KS test against scipy;
  the gpu distortion operators card against CPU; the graph of
  ``docs/examples/custom_operators.py`` with ``fn.torch_function`` on the
  card, to the example's own asserted values.

``chip_smoke.py`` runs both on the card. Alone, on the card:
``python dali_tpu_torch/tools/bench_affine_mixup.py [--timed N]`` (one JSON
line). ``affine_mixup_graph`` takes the ``fn``/``types`` modules of the
package to build in, so the tests build the same graph in ``dali_tpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

MEAN = [0.485 * 255, 0.456 * 255, 0.406 * 255]
STD = [0.229 * 255, 0.224 * 255, 0.225 * 255]
ALPHA = 0.2  # mixup's alpha in timm's ResNet training recipes
NOISE_MAX = 8.0  # the device noise's stddev is uniform in [0, NOISE_MAX)
OUTPUTS = ("data", "label", "label_b", "lam")
EXTRAS = ("matrix", "perm", "warped", "noisy", "normalized")
Z_LIMIT = 3.0  # standard errors
KS_P_MIN = 1e-3


def affine_mixup_graph(fn, types, file_list, out, noise_stddev=None, extras=False):
    """The graph's outputs: mixed images, labels, permuted labels and lam;
    with ``extras`` also the matrices, the permutation, the warped and the
    noisy uint8 images and the CMN output, then the drawn stddev. A constant
    ``noise_stddev`` replaces the device draw (a parity test's only way
    around the reference's threefry)."""
    c = [out / 2.0, out / 2.0]
    jpegs, labels = fn.readers.file(file_list=file_list, random_shuffle=True, name="Reader")
    images = fn.decoders.image_random_crop(jpegs, device="mixed", hybrid_device_decode=True,
                                           hybrid_scale=2)
    images = fn.resize(images, resize_x=out, resize_y=out)
    mt = fn.transforms.rotation(angle=fn.random.uniform(range=[-15.0, 15.0]), center=c)
    mt = fn.transforms.scale(mt, scale=fn.random.uniform(range=[0.9, 1.1], shape=[2]), center=c)
    mt = fn.transforms.shear(mt, angles=fn.random.normal(stddev=3.0, shape=[2]), center=c)
    mt = fn.transforms.combine(mt, fn.transforms.translation(
        offset=fn.random.uniform(range=[-8.0, 8.0], shape=[2])))
    warped = fn.warp_affine(images, matrix=mt, fill_value=0.0, inverse_map=False)
    stddev = (fn.random.uniform(range=[0.0, NOISE_MAX], device="gpu") if noise_stddev is None
              else noise_stddev)
    noisy = fn.noise.gaussian(warped, stddev=stddev)
    normalized = fn.crop_mirror_normalize(noisy, mirror=fn.random.coin_flip(), dtype=types.FLOAT,
                                          output_layout="CHW", mean=MEAN, std=STD)
    perm = fn.batch_permutation()
    lam = fn.random.beta(alpha=ALPHA, beta=ALPHA)
    other = fn.permute_batch(normalized, indices=perm)
    images = normalized * lam.gpu() + other * (1.0 - lam.gpu())
    outs = (images, labels, fn.permute_batch(labels, indices=perm), lam)
    if extras:
        outs += (mt, perm, warped, noisy, normalized)
        outs += (stddev,) if noise_stddev is None else ()
    return outs


def make_pipe(file_list, batch, out, device, noise_stddev=None, extras=False, seed=42,
              num_threads=None):
    from dali_tpu_torch import fn, pipeline_def, types

    @pipeline_def(batch_size=batch, num_threads=num_threads or os.cpu_count() or 1, seed=seed,
                  prefetch_queue_depth=2, device=device)
    def rn50_affine_mixup():
        return affine_mixup_graph(fn, types, file_list, out, noise_stddev, extras)

    pipe = rn50_affine_mixup()
    pipe.build()
    return pipe


def _check(b, batch, out):
    d, lab, lab_b, lam = (b[0][k] for k in OUTPUTS)
    if not (d.is_cuda and d.dtype == torch.float32 and tuple(d.shape) == (batch, 3, out, out)):
        raise AssertionError(f"rn50_affine_mixup: images {tuple(d.shape)} {d.dtype} on {d.device}")
    if not bool(torch.isfinite(d).all()):
        raise AssertionError("rn50_affine_mixup: non-finite values in a batch")
    if tuple(lab.shape) != (batch, 1) or tuple(lab_b.shape) != (batch, 1):
        raise AssertionError(f"rn50_affine_mixup: labels {tuple(lab.shape)} {tuple(lab_b.shape)}")
    if tuple(lam.shape) != (batch,) or not bool(((lam >= 0) & (lam <= 1)).all()):
        raise AssertionError(f"rn50_affine_mixup: lam {tuple(lam.shape)} outside [0, 1]")


def run_path(file_list, batch=256, out=224, warmup=3, timed=10):
    """The path on the card through ``DALIGenericIterator``: ``warmup`` +
    ``timed`` batches, each checked; images/s, host ms/batch by schema,
    device wait, the CMN launches of the run (set to 0 just before it),
    then device ms by stage of one batch run alone and peak memory."""
    from dali_tpu_torch.kernels import cmn
    from dali_tpu_torch.plugin.pytorch import DALIGenericIterator

    torch.cuda.reset_peak_memory_stats()
    pipe = make_pipe(file_list, batch, out, "cuda:0")
    ex = pipe.executor
    cmn.COUNTER.launches = 0
    it = DALIGenericIterator(pipe, list(OUTPUTS))
    for _ in range(warmup):
        _check(next(it), batch, out)
    torch.cuda.synchronize()
    st0, by0 = dict(ex.stats), dict(ex.host_seconds_by_schema)
    t0 = time.perf_counter()
    for _ in range(timed):
        _check(next(it), batch, out)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = {k: v - st0[k] for k, v in ex.stats.items()}
    by = {k: 1e3 * (v - by0.get(k, 0.0)) / st["host_batches"]
          for k, v in ex.host_seconds_by_schema.items()}
    for _ in range(pipe.prefetch_queue_depth):
        pipe.outputs()
    torch.cuda.synchronize()
    launches = cmn.COUNTER.launches
    ran = warmup + timed + pipe.prefetch_queue_depth
    if launches != ran:
        raise AssertionError(f"rn50_affine_mixup: CMN kernel launched {launches} times for {ran} "
                             "batches")
    ex.record_stage_events = True
    pipe.run()
    torch.cuda.synchronize()
    if ex.record_stage_events or not ex.stage_events:
        raise AssertionError("the instrumented batch did not run")
    stages = {}
    for name, a, b in ex.stage_events:
        stages[name] = stages.get(name, 0.0) + a.elapsed_time(b)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_dev, n_host = len(ex.device_ops), len(ex.host_ops)
    pipe.shutdown()
    return {"images_per_s": timed * batch / dt, "timed": timed, "cmn_launches": launches,
            "host_ms_per_batch": 1e3 * st["host_phase_seconds"] / st["host_batches"],
            "device_wait_ms_per_batch": 1e3 * st["device_wait_seconds"] / timed,
            "host_ms_by_schema": dict(sorted(by.items(), key=lambda kv: -kv[1])),
            "stage_ms": stages, "device_ms": sum(v for k, v in stages.items() if k != "h2d"),
            "peak_gib": peak, "device_ops": n_dev, "host_ops": n_host}


def rounded_noise_moments(x, s, lo=0.0, hi=255.0):
    """The exact first, second and fourth moments of d = clip(round(x + s*Z)) - x for
    Z standard normal, per element of uint8-valued ``x`` (float64) and
    ``s``: sums over the 256 output values of a rounded, clipped normal."""
    k = torch.arange(int(lo), int(hi) + 1, dtype=torch.float64, device=x.device)
    xs, ss = x[..., None], s[..., None]
    safe = torch.where(ss > 0, ss, 1.0)
    upper = torch.where(k < hi, torch.special.ndtr((k + 0.5 - xs) / safe), 1.0)
    lower = torch.where(k > lo, torch.special.ndtr((k - 0.5 - xs) / safe), 0.0)
    p = torch.where(ss > 0, upper - lower, (k == xs).to(torch.float64))
    d = k - xs
    return [(p * d ** j).sum(-1) for j in (1, 2, 4)]


def hold_noise(warped, noisy, stddev):
    """The device noise held by its distribution: over the batch, the sum
    and the sum of squares of noisy - warped against the exact moments of
    the rounded and clipped normal of each pixel's value and its sample's
    drawn stddev, each within ``Z_LIMIT`` standard errors. Returns the two
    z-scores."""
    x = warped.to(torch.float64)
    d = noisy.to(torch.float64) - x
    n = x.shape[0]
    # the expected moments depend only on (sample, input value): 256 per sample
    counts = torch.stack([torch.bincount(x[i].reshape(-1).long(), minlength=256)
                          for i in range(n)]).to(torch.float64)
    levels = torch.arange(256, dtype=torch.float64, device=x.device).expand(n, 256)
    m1, m2, m4 = rounded_noise_moments(
        levels, stddev.to(device=x.device, dtype=torch.float64).reshape(n, 1).expand(n, 256))
    z = []
    for obs, mean, var in ((d.sum(), (counts * m1).sum(), (counts * (m2 - m1 ** 2)).sum()),
                           ((d ** 2).sum(), (counts * m2).sum(), (counts * (m4 - m2 ** 2)).sum())):
        se, diff = math.sqrt(float(var)), float(obs - mean)
        z.append(diff / se if se > 0 else (0.0 if diff == 0 else math.inf))
        if not abs(z[-1]) <= Z_LIMIT:
            raise AssertionError(f"noise.gaussian: moment {len(z)} of noisy - warped is "
                                 f"{z[-1]:.2f} standard errors from its expected value over "
                                 f"{int(counts.sum())} values")
    return z


def check_against_cpu(file_list, batch=16, out=224, iterations=2):
    """The path at ``batch`` on the card and on the CPU: the host draws
    (labels, permuted labels, lam, matrices, permutation) equal; the warped
    uint8 images within one step on at most 1e-3 of values; the card's
    noise by its distribution against its own drawn stddev
    (``hold_noise``); mixup's arithmetic on the card equal to the formula
    on its own CMN output; and the same seed twice on the card bit-equal."""
    runs = {}
    for device in ("cuda:0", "cpu", "cuda:0 again"):
        pipe = make_pipe(file_list, batch, out, device.split()[0], extras=True)
        runs[device] = [[o.as_tensor().cpu() for o in pipe.run()] for _ in range(iterations)]
        pipe.shutdown()
    names = OUTPUTS + EXTRAS + ("stddev",)
    worst, frac, zs, mix_err = 0, 0.0, [], 0.0
    for g, c, again in zip(runs["cuda:0"], runs["cpu"], runs["cuda:0 again"]):
        g, c, again = (dict(zip(names, r)) for r in (g, c, again))
        for k in ("label", "label_b", "lam", "matrix", "perm"):
            if not torch.equal(g[k], c[k]):
                raise AssertionError(f"rn50_affine_mixup: host draw {k} differs card vs CPU")
        dw = (g["warped"].to(torch.int32) - c["warped"].to(torch.int32)).abs()
        worst, frac = max(worst, int(dw.max())), max(frac, float((dw > 0).float().mean()))
        zs.append(hold_noise(g["warped"], g["noisy"], g["stddev"]))
        lam = g["lam"].reshape(-1, 1, 1, 1)
        want = g["normalized"] * lam + g["normalized"][g["perm"].long()] * (1.0 - lam)
        mix_err = max(mix_err, float((g["data"] - want).abs().max()))
        if not mix_err <= 1e-5:
            raise AssertionError(f"rn50_affine_mixup: mixup output {mix_err} from its formula")
        for k in names:
            if not torch.equal(g[k], again[k]):
                raise AssertionError(f"rn50_affine_mixup: output {k} differs between two runs "
                                     "of the same seed on the card")
    if not (worst <= 1 and frac <= 1e-3):
        raise AssertionError(f"rn50_affine_mixup: warped images card vs CPU max diff {worst}, "
                             f"{frac:.2e} of values differ")
    return {"batch": batch, "iterations": iterations, "warped_max_diff": worst,
            "warped_frac_differing": frac, "noise_z": zs, "mix_max_err": mix_err}


# -- random_ops --------------------------------------------------------------------------------


def ks_pvalue(values, cdf) -> float:
    """The KS test's p-value of float32 draws against a continuous ``cdf``,
    each draw standing for its float32 rounding cell: float32 holds no value
    between 1 - 2^-24 and 1, so a Beta(0.2, 0.2) draw rounds to 1.0 with
    probability ~0.02, an atom a test of the continuous cdf would reject."""
    from scipy import stats

    x = np.sort(np.asarray(values, np.float32))
    n = x.size
    mid = lambda toward: (x.astype(np.float64)  # noqa: E731
                          + np.nextafter(x, np.float32(toward)).astype(np.float64)) / 2
    i = np.arange(1, n + 1)
    d = max(float((i / n - cdf(mid(np.inf))).max()), float((cdf(mid(-np.inf)) - (i - 1) / n).max()))
    return float(stats.kstwo.sf(d, n))


def _sub(t, n=200_000):
    """A strided subsample of ``t``'s values as float64 numpy."""
    flat = t.reshape(-1)
    step = max(flat.numel() // n, 1)
    return flat[::step][:n].to(torch.float64).cpu().numpy()


def _z(obs, mean, se, what):
    z = (obs - mean) / se
    if not abs(z) <= Z_LIMIT:
        raise AssertionError(f"{what}: {z:.2f} standard errors from its expected value")
    return z


def random_ops(batch=256, shape=(224, 224, 3), seed=7):
    """Every device random and noise operator at [batch, *shape] on the card:
    moments within ``Z_LIMIT`` standard errors and KS p-values above
    ``KS_P_MIN``; each op's device ms of one batch alone."""
    from scipy import stats

    from dali_tpu_torch import fn, pipeline_def

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (batch, *shape), dtype=np.uint8)
    flat = np.full((batch, *shape), 100.0, np.float32)

    @pipeline_def(batch_size=batch, num_threads=1, seed=seed, device="cuda:0")
    def ops():
        x = fn.external_source(source=lambda: img, batch=True, layout="HWC").gpu()
        f = fn.external_source(source=lambda: flat, batch=True, layout="HWC").gpu()
        return (fn.random.uniform(range=[-2.0, 3.0], shape=list(shape), device="gpu"),
                fn.random.normal(mean=1.0, stddev=2.0, shape=list(shape), device="gpu"),
                fn.random.coin_flip(probability=0.3, shape=list(shape), device="gpu"),
                fn.random.beta(alpha=ALPHA, beta=ALPHA, shape=list(shape), device="gpu"),
                fn.noise.gaussian(x, stddev=5.0), fn.noise.salt_and_pepper(x, prob=0.1),
                fn.noise.shot(f, factor=4.0), x)

    pipe = ops()
    ex = pipe.executor
    ex.record_stage_events = True
    outs = [o.as_tensor() for o in pipe.run()]
    torch.cuda.synchronize()
    stage_ms = {}
    for name, a, b in ex.stage_events:
        stage_ms[name] = stage_ms.get(name, 0.0) + a.elapsed_time(b)
    again = [o.as_tensor() for o in pipe.run()]
    pipe.shutdown()
    u, nrm, coin, beta, gauss, snp, shot, x = outs
    n = u.numel()
    r = {"shape": [batch, *shape], "stage_ms": stage_ms}
    r["uniform_ks_p"] = ks_pvalue(_sub(u), stats.uniform(-2.0, 5.0).cdf)
    r["uniform_mean_z"] = _z(float(u.double().mean()), 0.5, 5.0 / math.sqrt(12 * n),
                             "random.uniform(gpu) mean")
    r["normal_ks_p"] = ks_pvalue(_sub(nrm), stats.norm(1.0, 2.0).cdf)
    r["normal_mean_z"] = _z(float(nrm.double().mean()), 1.0, 2.0 / math.sqrt(n),
                            "random.normal(gpu) mean")
    r["normal_var_z"] = _z(float(nrm.double().var()), 4.0, 4.0 * math.sqrt(2.0 / n),
                           "random.normal(gpu) variance")
    p = 0.3
    r["coin_flip_z"] = _z(float(coin.double().mean()), p, math.sqrt(p * (1 - p) / n),
                          "random.coin_flip(gpu) share of ones")
    if not bool(((coin == 0) | (coin == 1)).all()) or coin.dtype != torch.int32:
        raise AssertionError("random.coin_flip(gpu): values other than int32 0/1")
    r["beta_ks_p"] = ks_pvalue(_sub(beta), stats.beta(ALPHA, ALPHA).cdf)
    r["beta_mean_z"] = _z(float(beta.double().mean()), 0.5,
                          math.sqrt(0.25 / (2 * ALPHA + 1) / n), "random.beta(gpu) mean")
    zs = hold_noise(x, gauss, torch.full((batch,), 5.0, device=x.device))
    r["gaussian_mean_z"], r["gaussian_meansq_z"] = zs
    # one draw per pixel (per_channel=False): a pixel is corrupted with
    # probability 0.1 and then salt or pepper with probability 1/2 (a pixel
    # whose three values already equal its new value looks untouched: 2^-24)
    changed = (snp != x).any(-1)
    salt = ((snp == 255).all(-1) & changed).double().sum()
    pix = changed.numel()
    r["salt_and_pepper_pixel_z"] = _z(float(changed.double().mean()), 0.1,
                                      math.sqrt(0.09 / pix), "noise.salt_and_pepper(gpu) share")
    k = float(changed.double().sum())
    r["salt_share_z"] = _z(float(salt) / k, 0.5, math.sqrt(0.25 / k),
                           "noise.salt_and_pepper(gpu) salt share")
    if not bool(((snp == x) | (snp == 0) | (snp == 255)).all()):
        raise AssertionError("noise.salt_and_pepper(gpu): values other than the input's, salt "
                             "and pepper")
    lam = 100.0 / 4.0
    q = shot.double() / 4.0
    if not bool((q == torch.round(q)).all()):
        raise AssertionError("noise.shot(gpu): values not multiples of the factor")
    r["shot_mean_z"] = _z(float(q.mean()), lam, math.sqrt(lam / n), "noise.shot(gpu) mean")
    r["shot_var_z"] = _z(float(q.var()), lam, math.sqrt((lam + 2 * lam * lam) / n),
                         "noise.shot(gpu) variance")
    r["same_seed_iteration_differs"] = not torch.equal(u, again[0])
    if not r["same_seed_iteration_differs"]:
        raise AssertionError("device random ops: the next iteration drew the same stream")
    return r


def distortion_ops(batch=16, size=(96, 128), seed=3):
    """Water, Sphere, GridMask and ColorTwist on the card against the CPU
    (within one uint8 step on at most 1e-3 of values); Jitter by its
    determinism and the range of its displacements."""
    from dali_tpu_torch import fn, pipeline_def

    rng = np.random.default_rng(seed)
    img = [rng.integers(0, 256, (size[0] - 8 * (i % 3), size[1] - 4 * (i % 2), 3), np.uint8)
           for i in range(batch)]
    hue = rng.uniform(-30, 30, batch).astype(np.float32)

    def build(device):
        @pipeline_def(batch_size=batch, num_threads=1, seed=seed, device=device)
        def distort():
            x = fn.external_source(source=lambda: img, batch=True, layout="HWC").gpu()
            h = fn.external_source(source=lambda: list(hue), batch=True)
            return (fn.water(x), fn.sphere(x), fn.grid_mask(x, tile=16, ratio=0.4, angle=0.3),
                    fn.color_twist(x, hue=h, saturation=0.8, brightness=1.1, contrast=1.2),
                    fn.water(x, interp_type=1), fn.jitter(x, nDegree=3), x)

        pipe = distort()
        pipe.build()
        res = [[o.as_tensor().cpu() for o in pipe.run()] for _ in range(2)]
        pipe.shutdown()
        return res

    card, cpu, card2 = build("cuda:0"), build("cpu"), build("cuda:0")
    r = {}
    for k, name in enumerate(("water", "sphere", "grid_mask", "color_twist", "water_linear")):
        d = (card[0][k].to(torch.int32) - cpu[0][k].to(torch.int32)).abs()
        worst, frac = int(d.max()), float((d > 0).float().mean())
        r[name] = {"max_diff": worst, "frac_differing": frac}
        if not (worst <= 1 and frac <= 1e-3):
            raise AssertionError(f"{name}(gpu): card vs CPU max diff {worst}, {frac:.2e} differ")
    for a, b in zip(card, card2):
        if not torch.equal(a[5], b[5]):
            raise AssertionError("jitter(gpu): the same seed gave different output")
    if torch.equal(card[0][5], card[1][5]):
        raise AssertionError("jitter(gpu): two iterations drew the same displacements")
    r["jitter_deterministic"] = True
    return r


def custom_operators(device="cuda:0", batch=4, seed=8):
    """``docs/examples/custom_operators.py``'s graph with the device
    function in torch (``fn.torch_function``), checked against the example's
    own asserted values."""
    from dali_tpu_torch import fn, pipeline_def, types

    rng = np.random.default_rng(seed)
    samples = [rng.integers(0, 256, (24, 32, 3), np.uint8) for _ in range(batch)]

    def edge_enhance(img):
        f = img.astype(np.float32)
        blur = (f + np.roll(f, 1, 0) + np.roll(f, -1, 0) + np.roll(f, 1, 1)
                + np.roll(f, -1, 1)) / 5.0
        return np.clip(f + (f - blur) * 2.0, 0, 255).astype(np.uint8)

    def channel_mix(x):
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        return torch.stack([b, torch.clamp(g * 1.25, 0, 255), r], dim=-1)

    def dl_negate(dl):
        return 255 - np.from_dlpack(dl)

    def threshold(out_img, in_img):
        for i in range(in_img.shape[0]):
            for j in range(in_img.shape[1]):
                for c in range(in_img.shape[2]):
                    out_img[i, j, c] = 255 if in_img[i, j, c] > 127 else 0

    @pipeline_def(batch_size=batch, num_threads=1, seed=4, device=device)
    def pipe():
        x = fn.external_source(source=lambda: samples, batch=True, cycle=True, layout="HWC")
        return (fn.python_function(x, function=edge_enhance),
                fn.torch_function(fn.cast(x.gpu(), dtype=types.FLOAT), function=channel_mix),
                fn.dl_tensor_python_function(x, function=dl_negate, batch_processing=False),
                fn.numba_function(x, run_fn=threshold, out_types=[types.UINT8],
                                  in_types=[types.UINT8], outs_ndim=[3], ins_ndim=[3],
                                  setup_fn=None, batch_processing=False))

    p = pipe()
    p.build()
    enhanced, mixed, negated, thresholded = p.run()
    p.shutdown()
    if not (mixed.as_tensor().device.type == torch.device(device).type):
        raise AssertionError(f"torch_function ran on {mixed.as_tensor().device}")
    for i, src in enumerate(samples):
        np.testing.assert_array_equal(np.asarray(enhanced.at(i)), edge_enhance(src))
        got = np.asarray(mixed.at(i))
        np.testing.assert_allclose(got[..., 0], src[..., 2], atol=1e-4)
        np.testing.assert_allclose(got[..., 1], np.clip(src[..., 1].astype(np.float32) * 1.25,
                                                        0, 255), atol=1e-3)
        np.testing.assert_array_equal(np.asarray(negated.at(i)), 255 - src)
        np.testing.assert_array_equal(np.asarray(thresholded.at(i)),
                                      np.where(src > 127, 255, 0).astype(np.uint8))
    return {"batch": batch, "outputs_checked": 4}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timed", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_affine_mixup: needs a CUDA card", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, repo)
    import chip_smoke

    r = run_path(chip_smoke.write_file_list(), timed=args.timed)
    r["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
