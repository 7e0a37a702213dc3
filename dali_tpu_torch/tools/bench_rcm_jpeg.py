"""rn50_rcm_jpeg: scale-then-crop ImageNet training input with JPEG-quality
augmentation, and the other gpu operators of ROADMAP.md Queue 1 item 5g on
the card.

* rn50_rcm_jpeg: ``readers.file`` over the corpus with ``random_shuffle``;
  rn50_val's decode (``decoders.image(device="mixed",
  hybrid_device_decode=True, hybrid_scale=1, hybrid_wire="int8")``);
  ``fast_resize_crop_mirror`` with ``resize_shorter=256``, a random
  224x224 crop position and a coin-flip mirror (torchvision's
  ``Resize(256)`` + ``RandomCrop(224)`` + ``RandomHorizontalFlip`` as one
  resample); ``jpeg_compression_distortion`` at a quality drawn uniformly
  in [30, 95]; CMN to normalised float CHW; ``DALIClassificationIterator``.
* gpu_ops: each other operator of the item on the card against the CPU at a
  small batch, and its device ms on one batch at full size.

``chip_smoke.py`` runs both on the card. Alone, on the card:
``python dali_tpu_torch/tools/bench_rcm_jpeg.py [--timed N]`` (one JSON
line). ``rcm_jpeg_graph`` takes the ``fn``/``types`` modules of the package
to build in, so the tests build the same graph in ``dali_tpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

MEAN = [0.485 * 255, 0.456 * 255, 0.406 * 255]
STD = [0.229 * 255, 0.224 * 255, 0.225 * 255]
QUALITY = [30.0, 95.0]  # the distortion's quality is uniform in this range
OUTPUTS = ("data", "label")
EXTRAS = ("resized", "distorted", "quality", "crop_x", "crop_y", "mirror")
BLOCK_SHARE_MAX = 1e-3  # of the 8x8 blocks of a JPEG round trip that may differ
STAGES = {"h2d": "H2D", "wire": "wire", "_JpegIdctSplit": "IDCT tail",
          "_JpegIdct": "IDCT tail", "FastResizeCropMirror": "FastResizeCropMirror",
          "JpegCompressionDistortion": "JpegCompressionDistortion",
          "CropMirrorNormalize": "CMN"}


def rcm_jpeg_graph(fn, types, file_list, shorter=256, crop=224, extras=False):
    """The graph's outputs: normalised float CHW images and labels; with
    ``extras`` also the resized-cropped-mirrored and the distorted uint8
    images and the host draws (quality, crop position, mirror)."""
    jpegs, labels = fn.readers.file(file_list=file_list, random_shuffle=True, name="Reader")
    images = fn.decoders.image(jpegs, device="mixed", hybrid_device_decode=True, hybrid_scale=1,
                               hybrid_wire="int8")
    crop_x = fn.random.uniform(range=[0.0, 1.0])
    crop_y = fn.random.uniform(range=[0.0, 1.0])
    mirror = fn.random.coin_flip(probability=0.5)
    resized = fn.fast_resize_crop_mirror(images, resize_shorter=shorter, crop=(crop, crop),
                                         crop_pos_x=crop_x, crop_pos_y=crop_y, mirror=mirror)
    quality = fn.random.uniform(range=QUALITY)
    distorted = fn.jpeg_compression_distortion(resized, quality=quality)
    out = fn.crop_mirror_normalize(distorted, dtype=types.FLOAT, output_layout="CHW", mean=MEAN,
                                   std=STD)
    outs = (out, labels)
    if extras:
        outs += (resized, distorted, quality, crop_x, crop_y, mirror)
    return outs


def make_pipe(file_list, batch, device, shorter=256, crop=224, extras=False, seed=42,
              num_threads=None):
    from dali_tpu_torch import fn, pipeline_def, types

    @pipeline_def(batch_size=batch, num_threads=num_threads or os.cpu_count() or 1, seed=seed,
                  prefetch_queue_depth=2, device=device)
    def rn50_rcm_jpeg():
        return rcm_jpeg_graph(fn, types, file_list, shorter, crop, extras)

    pipe = rn50_rcm_jpeg()
    pipe.build()
    return pipe


def _check(b, batch, crop):
    d, lab = b[0]["data"], b[0]["label"]
    if not (d.is_cuda and d.dtype == torch.float32 and tuple(d.shape) == (batch, 3, crop, crop)):
        raise AssertionError(f"rn50_rcm_jpeg: images {tuple(d.shape)} {d.dtype} on {d.device}")
    if not bool(torch.isfinite(d).all()):
        raise AssertionError("rn50_rcm_jpeg: non-finite values in a batch")
    if tuple(lab.shape) != (batch, 1) or lab.is_floating_point():
        raise AssertionError(f"rn50_rcm_jpeg: labels {tuple(lab.shape)} {lab.dtype}")


def stage_ms(ex) -> dict:
    """Device ms by stage of the batch the executor recorded."""
    if ex.record_stage_events or not ex.stage_events:
        raise AssertionError("the instrumented batch did not run")
    stages = {}
    for name, a, b in ex.stage_events:
        k = STAGES.get(name, name)
        stages[k] = stages.get(k, 0.0) + a.elapsed_time(b)
    return stages


def run_path(file_list, batch=256, crop=224, warmup=3, timed=10):
    """The path on the card through ``DALIClassificationIterator``:
    ``warmup`` + ``timed`` batches, each checked; images/s, host ms/batch by
    schema, device wait, the CMN launches of the run (set to 0 just before
    it), then device ms by stage of one batch run alone and peak memory."""
    from dali_tpu_torch.kernels import cmn
    from dali_tpu_torch.plugin.pytorch import DALIClassificationIterator

    torch.cuda.reset_peak_memory_stats()
    pipe = make_pipe(file_list, batch, "cuda:0", crop=crop)
    ex = pipe.executor
    cmn.COUNTER.launches = 0
    it = DALIClassificationIterator(pipe)
    for _ in range(warmup):
        _check(next(it), batch, crop)
    torch.cuda.synchronize()
    st0, by0 = dict(ex.stats), dict(ex.host_seconds_by_schema)
    t0 = time.perf_counter()
    for _ in range(timed):
        _check(next(it), batch, crop)
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
        raise AssertionError(f"rn50_rcm_jpeg: CMN kernel launched {launches} times for {ran} "
                             "batches")
    ex.record_stage_events = True
    pipe.run()
    torch.cuda.synchronize()
    stages = stage_ms(ex)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_dev, n_host = len(ex.device_ops), len(ex.host_ops)
    pipe.shutdown()
    return {"images_per_s": timed * batch / dt, "timed": timed, "cmn_launches": launches,
            "host_ms_per_batch": 1e3 * st["host_phase_seconds"] / st["host_batches"],
            "device_wait_ms_per_batch": 1e3 * st["device_wait_seconds"] / timed,
            "host_ms_by_schema": dict(sorted(by.items(), key=lambda kv: -kv[1])),
            "stage_ms": stages, "device_ms": sum(v for k, v in stages.items() if k != "H2D"),
            "peak_gib": peak, "device_ops": n_dev, "host_ops": n_host}


def block_diff(pairs, block=8):
    """Over (got, want) pairs of HWC images: the share of their 8x8 blocks
    that differ anywhere, and the largest difference."""
    differing = total = worst = 0
    for g, w in pairs:
        d = np.abs(np.asarray(g, np.int32) - np.asarray(w, np.int32)).max(-1)
        worst = max(worst, int(d.max()))
        hb, wb = -(-d.shape[0] // block), -(-d.shape[1] // block)
        pad = np.zeros((hb * block, wb * block), d.dtype)
        pad[:d.shape[0], :d.shape[1]] = d
        blocks = pad.reshape(hb, block, wb, block).max((1, 3))
        differing += int((blocks > 0).sum())
        total += blocks.size
    return differing / max(total, 1), worst


def step_diff(got, want):
    """(max abs difference, share of values that differ) of two tensors."""
    d = (got.to(torch.float64) - want.to(torch.float64)).abs()
    return float(d.max()) if d.numel() else 0.0, float((d > 0).to(torch.float64).mean())


def check_against_cpu(file_list, batch=16, crop=224, iterations=2):
    """The path at ``batch`` on the card and on the CPU: labels and host
    draws (quality, crop position, mirror) equal; the resized images within
    one uint8 step on at most 1e-3 of values; the distorted images differ
    in at most ``BLOCK_SHARE_MAX`` of their 8x8 blocks; the normalised
    images within one step / std where their distorted pixels agree."""
    runs = {}
    for device in ("cuda:0", "cpu"):
        pipe = make_pipe(file_list, batch, device, crop=crop, extras=True)
        runs[device] = [[o.as_tensor().cpu() for o in pipe.run()] for _ in range(iterations)]
        pipe.shutdown()
    names = OUTPUTS + EXTRAS
    worst = frac = share = jpeg_worst = norm_err = 0.0
    lsb = 1.0 / min(STD) + 1e-4
    for g, c in zip(runs["cuda:0"], runs["cpu"]):
        g, c = dict(zip(names, g)), dict(zip(names, c))
        for k in ("label", "quality", "crop_x", "crop_y", "mirror"):
            if not torch.equal(g[k], c[k]):
                raise AssertionError(f"rn50_rcm_jpeg: {k} differs card vs CPU")
        w, f = step_diff(g["resized"], c["resized"])
        worst, frac = max(worst, w), max(frac, f)
        s, jw = block_diff(zip(g["distorted"].numpy(), c["distorted"].numpy()))
        share, jpeg_worst = max(share, s), max(jpeg_worst, jw)
        same = (g["distorted"] == c["distorted"]).all(-1)[:, None]  # [N, 1, H, W]
        d = (g["data"] - c["data"]).abs().masked_fill(~same, 0.0)
        norm_err = max(norm_err, float(d.max()))
    if not (worst <= 1 and frac <= 1e-3):
        raise AssertionError(f"rn50_rcm_jpeg: resized images card vs CPU max diff {worst}, "
                             f"{frac:.2e} of values differ")
    if not share <= BLOCK_SHARE_MAX:
        raise AssertionError(f"rn50_rcm_jpeg: {share:.2e} of the distorted 8x8 blocks differ "
                             f"card vs CPU (max diff {jpeg_worst})")
    if not norm_err <= lsb:
        raise AssertionError(f"rn50_rcm_jpeg: normalised images card vs CPU {norm_err} apart")
    return {"batch": batch, "iterations": iterations, "resized_max_diff": worst,
            "resized_frac_differing": frac, "jpeg_block_share": share,
            "jpeg_max_diff": jpeg_worst, "normalized_max_err": norm_err}


# -- gpu_ops -----------------------------------------------------------------------------------


def _homographies(rng, batch, hw):
    h = np.tile(np.eye(3, dtype=np.float32), (batch, 1, 1))
    h[:, :2, :2] += rng.uniform(-0.08, 0.08, (batch, 2, 2)).astype(np.float32)
    h[:, :2, 2] = rng.uniform(-0.05, 0.05, (batch, 2)).astype(np.float32) * np.array(hw[::-1])
    h[:, 2, :2] = rng.uniform(-4e-4, 4e-4, (batch, 2)).astype(np.float32)
    return h


def _maps(rng, batch, hw):
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float32)
    mx = xx[None] * 0.97 + rng.uniform(-1.5, 1.5, (batch, *hw)).astype(np.float32)
    my = yy[None] * 1.02 + rng.uniform(-1.5, 1.5, (batch, *hw)).astype(np.float32)
    return mx, my


def image_op_cases(rng, batch, hw, ragged):
    """{name: (graph(fn, types, *sources), [(input, layout), ...], tolerance)}:
    ``sources`` are external sources of the inputs, copied to the device; an
    input is a stacked array, or a list of ragged uint8 images (``ragged``,
    the check size). Tolerances: "equal", or "step" (one step on at most
    1e-3 of values)."""
    n = batch
    if ragged:
        img = [rng.integers(0, 256, (hw[0] - 8 * (i % 3), hw[1] - 4 * (i % 2), 3), np.uint8)
               for i in range(n)]
    else:
        img = rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8)
    imgs = [(img, "HWC")]
    kernels = rng.uniform(-0.1, 0.2, (n, 5, 5)).astype(np.float32)
    homog = _homographies(rng, n, hw)
    mx, my = _maps(rng, n, hw)
    bayer = rng.integers(0, 256, (n, *hw), dtype=np.uint8)
    mosaic_ids = np.stack([(np.arange(n) + k) % n for k in range(4)], 1).astype(np.int32)
    anchors = np.tile(np.array([0, 0, 0, hw[1], hw[0], 0, hw[0], hw[1]], np.int32), (n, 1))
    seqs = [(rng.integers(0, 256, (4 if ragged else 16, 8, *hw, 3), dtype=np.uint8), "FHWC")]
    order = [7, 0, 6, 1, 5, 2, 4, 3]
    return {
        "experimental.dilate": (lambda fn, t, x: fn.experimental.dilate(x), imgs, "equal"),
        "experimental.erode": (lambda fn, t, x: fn.experimental.erode(x), imgs, "equal"),
        "experimental.median_blur_3": (lambda fn, t, x: fn.experimental.median_blur(
            x, window_size=[3]), imgs, "equal"),
        "experimental.median_blur_5": (lambda fn, t, x: fn.experimental.median_blur(
            x, window_size=[5]), imgs, "equal"),
        "experimental.clahe": (lambda fn, t, x: fn.experimental.clahe(x, tiles_x=8, tiles_y=8),
                               imgs, "step"),
        "experimental.debayer": (lambda fn, t, x: fn.experimental.debayer(
            x, blue_position=[0, 1]), [(bayer, "HW")], "equal"),
        "experimental.filter_5x5": (lambda fn, t, x, k: fn.experimental.filter(x, k),
                                    imgs + [(kernels, "")], "step"),
        "experimental.remap": (lambda fn, t, x, a, b: fn.experimental.remap(x, a, b),
                               imgs + [(mx, ""), (my, "")], "step"),
        "experimental.warp_perspective_nn": (
            lambda fn, t, x, m: fn.experimental.warp_perspective(x, m, interp_type=t.INTERP_NN),
            imgs + [(homog, "")], "equal"),
        "experimental.warp_perspective_linear": (
            lambda fn, t, x, m: fn.experimental.warp_perspective(x, m), imgs + [(homog, "")],
            "step"),
        "multi_paste_2x2": (
            lambda fn, t, x: fn.multi_paste(
                x, in_ids=fn.external_source(source=lambda: mosaic_ids, batch=True),
                out_anchors=fn.external_source(source=lambda: anchors, batch=True),
                output_size=[2 * hw[0], 2 * hw[1]]), imgs, "equal"),
        "element_extract": (lambda fn, t, s: fn.element_extract(s, element_map=[0, 7]), seqs,
                            "equal"),
        "sequence_rearrange": (lambda fn, t, s: fn.sequence_rearrange(s, new_order=order), seqs,
                               "equal"),
        "per_frame": (lambda fn, t, s: fn.per_frame(s), seqs, "equal"),
        # rounding ties of the colour matrices, summed in XLA-CPU's order
        "color_twist_brightness_0.9": (lambda fn, t, x: fn.color_twist(x, brightness=0.9), imgs,
                                       "equal"),
        "hsv_value_0.9": (lambda fn, t, x: fn.hsv(x, value=0.9), imgs, "equal"),
    }


def _run_op(graph, inputs, device, reps=1, stages=False):
    """One pipeline of ``graph`` over external sources of ``inputs`` (copied
    to the device), run ``reps`` times: the outputs of the last run as CPU
    tensors per sample, or with ``stages`` the device ms of that run by
    stage (H2D aside)."""
    from dali_tpu_torch import fn, pipeline_def, types

    @pipeline_def(batch_size=len(inputs[0][0]), num_threads=1, seed=5, device=device,
                  prefetch_queue_depth=1)
    def one_op():
        srcs = [fn.external_source(source=lambda a=a: a, batch=True, layout=lay).gpu()
                for a, lay in inputs]
        out = graph(fn, types, *srcs)
        return out if isinstance(out, tuple) else (out,)

    pipe = one_op()
    pipe.build()
    try:
        for r in range(reps):
            pipe.executor.record_stage_events = stages and r == reps - 1
            outs = pipe.run()
        if stages:
            torch.cuda.synchronize()
            return {k: v for k, v in stage_ms(pipe.executor).items() if k != "H2D"}
        return [[torch.as_tensor(np.asarray(o.as_cpu().at(i))) for i in range(len(o))]
                for o in outs]
    finally:
        pipe.shutdown()


def _compare(card, cpu, tol, what):
    pairs = [(g, c) for go, co in zip(card, cpu) for g, c in zip(go, co)]
    for g, c in pairs:
        if g.shape != c.shape or g.dtype != c.dtype:
            raise AssertionError(f"{what}: card {tuple(g.shape)} {g.dtype}, CPU "
                                 f"{tuple(c.shape)} {c.dtype}")
    diffs = [step_diff(g, c) for g, c in pairs]
    worst = max(d[0] for d in diffs)
    n = [g.numel() for g, _ in pairs]
    frac = sum(d[1] * k for d, k in zip(diffs, n)) / max(sum(n), 1)
    limit = (0, 0.0) if tol == "equal" else (1, 1e-3)
    if not (worst <= limit[0] and frac <= limit[1]):
        raise AssertionError(f"{what}: card vs CPU max diff {worst} on {frac:.2e} of values "
                             f"(limits {limit[0]}, {limit[1]:g})")
    return {"max_diff": worst, "frac_differing": frac}


def gpu_ops(check_batch=16, batch=256, hw=(224, 224), seed=11, audio_root=None):
    """Every other operator of item 5g on the card: at ``check_batch`` (4
    sequences) against the CPU with the tolerances of the CPU tests, and its
    device ms on one batch at full size (the second of two runs). Returns
    {op: {"check", "ms", "shape"}} and the peak device memory in GiB."""
    rng = np.random.default_rng(seed)
    small = image_op_cases(rng, check_batch, (96, 128), ragged=True)
    big = image_op_cases(rng, batch, hw, ragged=False)
    res = {}
    torch.cuda.reset_peak_memory_stats()
    for name, (graph, inputs, tol) in small.items():
        check = _compare(_run_op(graph, inputs, "cuda:0"), _run_op(graph, inputs, "cpu"), tol,
                         name)
        g, full_inputs, _ = big[name]
        ms = _run_op(g, full_inputs, "cuda:0", reps=2, stages=True)
        res[name] = {"check": check, "ms": sum(ms.values()),
                     "shape": list(np.asarray(full_inputs[0][0]).shape)}
    res.update(_volume_op(rng))
    res.update(_audio_ops(audio_root))
    return res, torch.cuda.max_memory_allocated() / 2 ** 30


def _volume_op(rng):
    """TensorResize at scale 0.5 of numpy_volumes' batch (2 float32 volumes of
    [4, 155, 240, 240], CDHW) and card vs CPU on two smaller volumes."""
    graph = lambda fn, t, v: fn.tensor_resize(v, scales=[0.5, 0.5, 0.5],  # noqa: E731
                                              axes=[1, 2, 3])
    small = [(rng.uniform(0, 1000, (2, 4, 23, 30, 24)).astype(np.float32), "CDHW")]
    check = _compare(_run_op(graph, small, "cuda:0"), _run_op(graph, small, "cpu"), "step",
                     "tensor_resize")
    vols = rng.uniform(0, 1000, (2, 4, 155, 240, 240)).astype(np.float32)
    ms = _run_op(graph, [(vols, "CDHW")], "cuda:0", reps=2, stages=True)
    return {"tensor_resize_volumes": {"check": check, "ms": sum(ms.values()),
                                      "shape": list(vols.shape)}}


def make_audio_pipe(root, batch, device):
    """asr_frontend's reader and decode of the WAV corpus, then
    NonsilentRegion at -40 dB and PowerSpectrum with a 131,072-point FFT of
    each clip on the device."""
    from dali_tpu_torch import fn, pipeline_def, types

    @pipeline_def(batch_size=batch, num_threads=2, seed=7, device=device, prefetch_queue_depth=1)
    def audio_ops():
        enc, _ = fn.readers.file(file_root=root, file_filters=["*.wav"], name="R")
        audio, _rate = fn.decoders.audio(enc, dtype=types.FLOAT, downmix=True, device="mixed")
        begin, length = fn.nonsilent_region(audio, cutoff_db=-40.0)
        return fn.power_spectrum(audio, nfft=512 * 256), begin, length

    pipe = audio_ops()
    pipe.build()
    return pipe


def _audio_ops(root=None, batch=32, check_batch=8, window=2048):
    """PowerSpectrum and NonsilentRegion on asr_frontend's clips: card vs CPU
    at ``check_batch`` (spectra within 1e-5 of each clip's peak; begin and
    end within one window, with the share of clips that differ at all), and
    device ms at ``batch``."""
    from dali_tpu_torch.testdata.make_audio_corpus import ensure_corpus

    root = root or ensure_corpus()
    outs = {}
    for device in ("cuda:0", "cpu"):
        p = make_audio_pipe(root, check_batch, device)
        outs[device] = [o.as_tensor().cpu() for o in p.run()]
        p.shutdown()
    (g_spec, g_b, g_l), (c_spec, c_b, c_l) = outs["cuda:0"], outs["cpu"]
    peak = c_spec.abs().amax(dim=tuple(range(1, c_spec.dim())), keepdim=True)
    rel = float(((g_spec - c_spec).abs() / (peak + 1e-30)).max())
    if not rel <= 1e-5:
        raise AssertionError(f"power_spectrum: card vs CPU {rel:.2e} of the peak apart")
    off = torch.maximum((g_b - c_b).abs(), ((g_b + g_l) - (c_b + c_l)).abs())
    if not bool((off <= window).all()):
        raise AssertionError("nonsilent_region: card vs CPU more than one window apart")
    share = float((off > 0).to(torch.float64).mean())
    p = make_audio_pipe(root, batch, "cuda:0")
    p.run()
    p.executor.record_stage_events = True
    p.run()
    torch.cuda.synchronize()
    ms = stage_ms(p.executor)
    p.shutdown()
    return {"power_spectrum": {"check": {"max_rel_to_peak": rel}, "ms": ms["PowerSpectrum"],
                               "shape": [batch, "clips"]},
            "nonsilent_region": {"check": {"clips_differing": share, "window": window},
                                 "ms": ms["NonsilentRegion"], "shape": [batch, "clips"]}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timed", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_rcm_jpeg: needs a CUDA card", file=sys.stderr)
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
