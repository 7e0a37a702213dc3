"""asr_resample, rn50_dali_cpu, host_geometry, rn50_host_augment and
host_filters: the paths of the AudioResample, cpu CropMirrorNormalize and
host image operators, on the card and its host.

* asr_resample: asr_frontend's graph over 16-bit WAV clips at 48 kHz (VCTK's
  rate): ``readers.file``, the mixed ``decoders.audio``, then
  ``experimental.audio_resample`` 48 kHz -> 16 kHz on the card (quality 50,
  32 taps), preemphasis, spectrogram, 80 mels, dB, normalize.
* rn50_dali_cpu: DeepLearningExamples' ResNet-50 ``--dali-cpu`` recipe:
  ``readers.file``, ``decoders.image(device="cpu")``,
  ``random_resized_crop(device="cpu", size=224, random_area=[0.08, 1],
  num_attempts=100)`` on the host, ``.gpu()``, CMN with a coin-flip mirror
  to float CHW on the card (the kernel ``csrc/cmn.cu``). With ``cmn_cpu``
  the CMN runs on the host before ``.gpu()``: the check's second opinion.
* host_geometry: docs/examples/serialization.py, transforms_3d.py and
  audio_processing.py run whole through the port, and each host geometry
  and colour operator timed on one batch of [256, 224, 224, 3] uint8, on one
  thread and on the pipeline's pool.
* rn50_host_augment: rn50_dali_cpu with the robustness recipes' host
  augmentations after the crop: ``jpeg_compression_distortion`` at a
  quality drawn from [30, 95], ``gaussian_blur`` at a sigma drawn from
  [0.1, 2.0] and ``experimental.equalize``, all on the host; the card runs
  only CMN.
* host_filters: docs/examples/augmentation_gallery.py run whole through the
  port; each host image filter and the rest of the host image ops timed as
  host_geometry times its ops (Debayer on [256, 224, 224] mosaics); and each
  op that has both placements run on the host and on the card, the outputs
  held within ``PLACEMENT_BOUNDS``.

``chip_smoke.py`` runs all five on the card. Alone, on the card:
``python dali_tpu_torch/tools/bench_dali_cpu.py --form
asr_resample|rn50_dali_cpu|host_geometry|rn50_host_augment|host_filters``
(one JSON line). The graph
functions take the ``fn``/``types`` modules of the package to build in, so
the tests build the same graphs in ``dali_tpu``.
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
IN_RATE, OUT_RATE = 48000.0, 16000.0
HOP, NMEL = 160, 80
SEEDS = {"reader": 1234, "crop": 77, "mirror": 5, "quality": 21, "sigma": 22}
CMN_ATOL = 1e-5  # the CMN kernel against its plain version, and card CMN vs host CMN
RESAMPLE_RTOL = 1e-5  # of each clip's peak, card vs CPU
DB_ATOL = 1e-3
GEOMETRY_EXAMPLES = ("serialization.py", "transforms_3d.py", "audio_processing.py")
EXAMPLES = GEOMETRY_EXAMPLES + ("augmentation_gallery.py",)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _stage_ms(ex) -> dict:
    if ex.record_stage_events or not ex.stage_events:
        raise AssertionError("the instrumented batch did not run")
    stages = {}
    for name, a, b in ex.stage_events:
        stages[name] = stages.get(name, 0.0) + a.elapsed_time(b)
    return stages


# -- asr_resample ------------------------------------------------------------------------------


def asr_resample_graph(fn, types, root, in_rate=IN_RATE, out_rate=OUT_RATE, mixed=True,
                       ext="wav"):
    """(resampled audio, dB mel, normalized dB mel) of asr_frontend's graph
    with the 48 kHz -> 16 kHz resample after the decode, over ``root``'s
    ``*.ext`` clips. ``mixed=False`` decodes on the host and copies with
    ``.gpu()``: the same values, the form dali_tpu runs it in (its mixed
    decode gives the device resample no host shapes)."""
    enc, _ = fn.readers.file(file_root=root, file_filters=[f"*.{ext}"], random_shuffle=True,
                             name="R", seed=SEEDS["reader"])
    if mixed:
        audio, _rate = fn.decoders.audio(enc, dtype=types.FLOAT, downmix=True, device="mixed")
    else:
        audio, _rate = fn.decoders.audio(enc, dtype=types.FLOAT, downmix=True)
        audio = audio.gpu()
    resampled = fn.experimental.audio_resample(audio, in_rate=in_rate, out_rate=out_rate)
    pre = fn.preemphasis_filter(resampled, preemph_coeff=0.97)
    spec = fn.spectrogram(pre, nfft=512, window_length=320, window_step=HOP)
    mel = fn.mel_filter_bank(spec, sample_rate=out_rate, nfilter=NMEL)
    db = fn.to_decibels(mel, multiplier=10.0, cutoff_db=-80.0)
    return resampled, db, fn.normalize(db, axes=[1])


def make_asr_resample_pipe(root, batch, device, ext="wav"):
    from dali_tpu_torch import fn, pipeline_def, types

    @pipeline_def(batch_size=batch, seed=7, prefetch_queue_depth=2, device=device)
    def asr_resample():
        return asr_resample_graph(fn, types, root, ext=ext)

    pipe = asr_resample()
    pipe.build()
    return pipe


def _check_asr(outs, batch):
    resampled, _, norm = outs
    data = norm.as_tensor()
    frames = [s[0] // HOP + 1 for s in resampled.shape()]
    if not (data.is_cuda and data.dtype == torch.float32 and data.shape[0] == batch
            and data.shape[1] == NMEL):
        raise AssertionError(f"asr_resample: output {tuple(data.shape)} {data.dtype} on "
                             f"{data.device}")
    if norm.shape() != [(NMEL, f) for f in frames]:
        raise AssertionError("asr_resample: per-sample shapes differ from len // 160 + 1")
    valid = torch.arange(data.shape[2], device=data.device)[None, :] < torch.tensor(
        frames, device=data.device)[:, None]
    if not bool((torch.isfinite(data) | ~valid[:, None, :]).all()):
        raise AssertionError("asr_resample: non-finite values in the valid region")


def run_asr_resample(root, batch=32, warmup=3, timed=10, ext="wav"):
    """The path on the card, each batch taken and the next scheduled as an
    iterator does: clips/s, host ms/batch, device wait; then one batch run
    alone with its device ms by stage, and the peak device memory."""
    torch.cuda.reset_peak_memory_stats()
    pipe = make_asr_resample_pipe(root, batch, "cuda:0", ext)
    ex = pipe.executor

    def step():
        _check_asr(pipe.outputs(), batch)
        pipe.schedule_run()

    pipe._prefetch()
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    st0 = dict(ex.stats)
    t0 = time.perf_counter()
    for _ in range(timed):
        step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = {k: v - st0[k] for k, v in ex.stats.items()}
    for _ in range(pipe.prefetch_queue_depth):
        pipe.outputs()
    ex.record_stage_events = True
    _check_asr(pipe.run(), batch)
    torch.cuda.synchronize()
    stages = _stage_ms(ex)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    pipe.shutdown()
    return {"clips_per_s": timed * batch / dt, "timed": timed, "batch": batch,
            "host_ms_per_batch": 1e3 * st["host_phase_seconds"] / st["host_batches"],
            "device_wait_ms_per_batch": 1e3 * st["device_wait_seconds"] / timed,
            "stage_ms": stages, "resample_ms": stages["experimental.AudioResample"],
            "peak_gib": peak}


def check_asr_resample(root, batch=4, iterations=2, ext="wav"):
    """The path at ``batch`` on the card and on the CPU: each clip's
    resampled signal within ``RESAMPLE_RTOL`` of its peak, its dB mel within
    ``DB_ATOL`` on the valid frames."""
    runs = {}
    for device in ("cuda:0", "cpu"):
        pipe = make_asr_resample_pipe(root, batch, device, ext)
        runs[device] = [[(o.as_tensor().cpu(), o.shape()) for o in pipe.run()[:2]]
                        for _ in range(iterations)]
        pipe.shutdown()
    rel = db = 0.0
    for (g_res, g_db), (c_res, c_db) in zip(runs["cuda:0"], runs["cpu"]):
        if g_res[1] != c_res[1] or g_db[1] != c_db[1]:
            raise AssertionError("asr_resample: card and CPU shapes differ")
        for i, ((n,), (_, frames)) in enumerate(zip(c_res[1], c_db[1])):
            want = c_res[0][i, :n]
            rel = max(rel, float((g_res[0][i, :n] - want).abs().max() / want.abs().max()))
            db = max(db, float((g_db[0][i, :, :frames] - c_db[0][i, :, :frames]).abs().max()))
    if not (rel <= RESAMPLE_RTOL and db <= DB_ATOL):
        raise AssertionError(f"asr_resample: card vs CPU resampled {rel:.2e} of the peak "
                             f"apart, dB {db:.2e} apart")
    return {"batch": batch, "iterations": iterations, "resampled_rel_to_peak": rel,
            "db_max_diff": db}


# -- rn50_dali_cpu -----------------------------------------------------------------------------


def host_augment(fn, images):
    """The host augmentations of rn50_host_augment: a JPEG round trip at a
    quality drawn from [30, 95], a Gaussian blur of a sigma drawn from
    [0.1, 2.0], histogram equalization."""
    quality = fn.random.uniform(range=[30.0, 95.0], seed=SEEDS["quality"])
    images = fn.jpeg_compression_distortion(images, quality=quality)
    images = fn.gaussian_blur(images, sigma=fn.random.uniform(range=[0.1, 2.0],
                                                              seed=SEEDS["sigma"]))
    return fn.experimental.equalize(images)


def rn50_dali_cpu_graph(fn, types, file_list, size=224, cmn_cpu=False, augment=False):
    """(images, labels): the decode and RandomResizedCrop on the host (with
    ``augment``, then ``host_augment``), CMN on the card (or, with
    ``cmn_cpu``, on the host before ``.gpu()``). The random ops take explicit
    seeds, so both forms draw alike."""
    jpegs, labels = fn.readers.file(file_list=file_list, random_shuffle=True, name="Reader",
                                    seed=SEEDS["reader"])
    images = fn.decoders.image(jpegs, device="cpu")
    images = fn.random_resized_crop(images, device="cpu", size=[size, size],
                                    random_area=[0.08, 1.0], random_aspect_ratio=[0.75, 4 / 3],
                                    num_attempts=100, seed=SEEDS["crop"])
    if augment:
        images = host_augment(fn, images)
    mirror = fn.random.coin_flip(probability=0.5, seed=SEEDS["mirror"])
    kw = dict(mirror=mirror, dtype=types.FLOAT, output_layout="CHW", mean=MEAN, std=STD)
    if cmn_cpu:
        return fn.crop_mirror_normalize(images, device="cpu", **kw).gpu(), labels
    return fn.crop_mirror_normalize(images.gpu(), **kw), labels


def make_rn50_pipe(file_list, batch, device, cmn_cpu=False, num_threads=None, augment=False):
    from dali_tpu_torch import fn, pipeline_def, types

    @pipeline_def(batch_size=batch, num_threads=num_threads or os.cpu_count() or 1, seed=42,
                  prefetch_queue_depth=2, device=device)
    def rn50_dali_cpu():
        return rn50_dali_cpu_graph(fn, types, file_list, cmn_cpu=cmn_cpu, augment=augment)

    pipe = rn50_dali_cpu()
    pipe.build()
    return pipe


def _path(augment):
    return "rn50_host_augment" if augment else "rn50_dali_cpu"


def _check_rn50(b, batch, size=224, what="rn50_dali_cpu", classes=None):
    d, lab = b[0]["data"], b[0]["label"]
    if not (d.is_cuda and d.dtype == torch.float32 and tuple(d.shape) == (batch, 3, size, size)):
        raise AssertionError(f"{what}: images {tuple(d.shape)} {d.dtype} on {d.device}")
    if not bool(torch.isfinite(d).all()):
        raise AssertionError(f"{what}: non-finite values in a batch")
    if tuple(lab.shape) != (batch, 1) or lab.is_floating_point():
        raise AssertionError(f"{what}: labels {tuple(lab.shape)} {lab.dtype}")
    if classes is not None and not bool(((lab >= 0) & (lab < classes)).all()):
        raise AssertionError(f"{what}: a label outside [0, {classes})")


def _label_count(file_list):
    with open(file_list) as f:
        return 1 + max(int(line.split()[1]) for line in f if line.strip())


def run_rn50_dali_cpu(file_list, batch=256, warmup=3, timed=10, augment=False):
    """The path (rn50_dali_cpu, or with ``augment`` rn50_host_augment) on the
    card through ``DALIClassificationIterator``: images/s, host ms/batch by
    schema, device wait, the CMN launches of the run (set to 0 just before
    it: one per batch), device ms by stage of one batch run alone and peak
    memory. Each batch is checked: shapes, finite values, labels in the file
    list's range."""
    from dali_tpu_torch.kernels import cmn
    from dali_tpu_torch.plugin.pytorch import DALIClassificationIterator

    what, classes = _path(augment), _label_count(file_list)
    torch.cuda.reset_peak_memory_stats()
    pipe = make_rn50_pipe(file_list, batch, "cuda:0", augment=augment)
    ex = pipe.executor
    cmn.COUNTER.launches = 0
    it = DALIClassificationIterator(pipe)
    for _ in range(warmup):
        _check_rn50(next(it), batch, what=what, classes=classes)
    torch.cuda.synchronize()
    st0, by0 = dict(ex.stats), dict(ex.host_seconds_by_schema)
    t0 = time.perf_counter()
    for _ in range(timed):
        _check_rn50(next(it), batch, what=what, classes=classes)
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
        raise AssertionError(f"{what}: CMN kernel launched {launches} times for {ran} batches")
    ex.record_stage_events = True
    pipe.run()
    torch.cuda.synchronize()
    stages = _stage_ms(ex)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    pipe.shutdown()
    return {"images_per_s": timed * batch / dt, "timed": timed, "cmn_launches": launches,
            "host_ms_per_batch": 1e3 * st["host_phase_seconds"] / st["host_batches"],
            "device_wait_ms_per_batch": 1e3 * st["device_wait_seconds"] / timed,
            "host_ms_by_schema": dict(sorted(by.items(), key=lambda kv: -kv[1])),
            "stage_ms": stages, "peak_gib": peak}


def check_rn50_dali_cpu(file_list, batch=16, iterations=2, augment=False):
    """The path against itself with CMN on the host: labels equal, images
    within ``CMN_ATOL`` (the kernel's x * a + b against the host's
    scale * (x - mean) / std + shift)."""
    what = _path(augment)
    runs = []
    for cmn_cpu in (False, True):
        pipe = make_rn50_pipe(file_list, batch, "cuda:0", cmn_cpu=cmn_cpu, augment=augment)
        runs.append([[o.as_tensor().cpu() for o in pipe.run()] for _ in range(iterations)])
        pipe.shutdown()
    worst = 0.0
    for (g_img, g_lab), (c_img, c_lab) in zip(*runs):
        if not torch.equal(g_lab, c_lab):
            raise AssertionError(f"{what}: labels differ between the two CMN placements")
        worst = max(worst, float((g_img - c_img).abs().max()))
    if not worst <= CMN_ATOL:
        raise AssertionError(f"{what}: CMN on the card and on the host {worst} apart")
    return {"batch": batch, "iterations": iterations, "max_abs_diff": worst}


# -- host_geometry -----------------------------------------------------------------------------


def run_example(name):
    """docs/examples/<name> run whole with its imports pointing at
    dali_tpu_torch (its own assertions check it); returns its seconds."""
    path = os.path.join(REPO, "docs", "examples", name)
    with open(path) as f:
        src = f.read().replace("import dali_tpu.", "import dali_tpu_torch.").replace(
            "from dali_tpu import", "from dali_tpu_torch import")
    ns = {"__name__": "example", "__file__": path}
    t0 = time.perf_counter()
    exec(compile(src, path, "exec"), ns)
    ns["main"]()
    return time.perf_counter() - t0


def host_op_cases(hw):
    """{operator: graph(fn, types, x)} of the host geometry and colour ops."""
    h, w = hw
    m = [0.9, 0.2, 5.0, -0.15, 1.05, -3.0]
    return {
        "Resize": lambda fn, t, x: fn.resize(x, resize_shorter=256.0),
        "RandomResizedCrop": lambda fn, t, x: fn.random_resized_crop(x, size=[h, w], seed=3),
        "CropMirrorNormalize": lambda fn, t, x: fn.crop_mirror_normalize(
            x, crop=(h - 24, w - 24), mirror=1, mean=MEAN, std=STD),
        "Flip": lambda fn, t, x: fn.flip(x, horizontal=1, vertical=1),
        "WarpAffine": lambda fn, t, x: fn.warp_affine(x, matrix=m, fill_value=128.0),
        "Rotate": lambda fn, t, x: fn.rotate(x, angle=17.0, keep_size=True),
        "Transpose": lambda fn, t, x: fn.transpose(x, perm=[2, 0, 1]),
        "Pad": lambda fn, t, x: fn.pad(x, axes=[0, 1], shape=[h + 32, w + 32]),
        "Erase": lambda fn, t, x: fn.erase(x, anchor=[50.0, 60.0], shape=[80.0, 40.0]),
        "Paste": lambda fn, t, x: fn.paste(x, ratio=1.5, fill_value=[0.0, 0.0, 0.0]),
        "BrightnessContrast": lambda fn, t, x: fn.brightness_contrast(x, brightness=1.2,
                                                                       contrast=0.8),
        "Hue": lambda fn, t, x: fn.hue(x, hue=20.0),
        "Saturation": lambda fn, t, x: fn.saturation(x, saturation=1.3),
        "Hsv": lambda fn, t, x: fn.hsv(x, hue=10.0, saturation=0.9, value=1.1),
        "ColorTwist": lambda fn, t, x: fn.color_twist(x, hue=5.0, saturation=1.2,
                                                      brightness=0.9, contrast=1.1),
        "ColorSpaceConversion": lambda fn, t, x: fn.color_space_conversion(
            x, image_type=t.RGB, output_type=t.YCbCr),
    }


def time_host_ops(batch=256, hw=(224, 224), threads=None, reps=2, seed=0, cases=None,
                  device="cuda:0"):
    """Each host op on one [batch, *hw, 3] uint8 batch (a case labelled
    "experimental.Debayer..." on [batch, *hw] mosaics): host ms of the op's
    schema (the label's first word) per batch, after one warm-up run, on one
    thread and on ``threads`` (the host's cores). Returns {label: {threads:
    ms}}."""
    from dali_tpu_torch import fn, pipeline_def, types

    rng = np.random.default_rng(seed)
    data = list(rng.integers(0, 256, (batch, *hw, 3), dtype=np.uint8))
    mosaics = [d[..., 1] for d in data]
    res = {}
    for label, graph in (cases or host_op_cases(hw)).items():
        name = label.split()[0]
        src = mosaics if name == "experimental.Debayer" else data
        res[label] = {}
        for n_threads in sorted({1, threads or os.cpu_count() or 1}):
            @pipeline_def(batch_size=batch, num_threads=n_threads, seed=5,
                          prefetch_queue_depth=1, device=device)
            def one_op():
                return graph(fn, types, fn.external_source(
                    source=lambda: src, batch=True, layout="HW" if src is mosaics else "HWC"))

            pipe = one_op()
            pipe.build()
            try:
                pipe.run()
                ex = pipe.executor
                before = ex.host_seconds_by_schema.get(name, 0.0)
                for _ in range(reps):
                    pipe.run()
                res[label][n_threads] = 1e3 * (ex.host_seconds_by_schema[name] - before) / reps
            finally:
                pipe.shutdown()
    return res


def host_geometry(batch=256, hw=(224, 224)):
    """The three examples whole, then the host ops timed."""
    examples = {name: run_example(name) for name in GEOMETRY_EXAMPLES}
    return {"examples_s": examples, "host_ms": time_host_ops(batch, hw),
            "threads": os.cpu_count()}


# -- host_filters ------------------------------------------------------------------------------


def _per_sample(fn, batch, value):
    """One array, the same for every sample, as an argument input."""
    return fn.external_source(source=lambda: [value] * batch, batch=True)


def _remap_maps(h, w):
    """Maps of a gentle swirl, in source pixel coordinates ("center")."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    r = np.hypot(xs - w / 2, ys - h / 2) / max(h, w)
    return ((xs + 6 * np.sin(6.0 * r)).astype(np.float32),
            (ys + 6 * np.cos(6.0 * r)).astype(np.float32))


HOMOGRAPHY = [1.0, 0.1, -2.0, 0.05, 0.9, 3.0, 0.0008, -0.0006, 1.0]


def host_filter_cases(hw, batch):
    """{label: graph(fn, types, x)} of the ops ported with the host filters:
    each registration once (the experimental.TensorResize name is
    TensorResize's op)."""
    h, w = hw
    kern = np.array([[0, -1, 0], [-1, 5, -1], [0, -1, 0]], np.float32)
    mx, my = _remap_maps(h, w)
    ids = [np.array([i, (i + 1) % batch], np.int32) for i in range(batch)]
    quad = [0, 0, h // 2, w // 2]
    return {
        "GaussianBlur": lambda fn, t, x: fn.gaussian_blur(x, sigma=1.5),
        "Laplacian": lambda fn, t, x: fn.laplacian(x, window_size=5, dtype=t.UINT8),
        "experimental.Filter": lambda fn, t, x: fn.experimental.filter(
            x, _per_sample(fn, batch, kern)),
        "experimental.Equalize": lambda fn, t, x: fn.experimental.equalize(x),
        "Water": lambda fn, t, x: fn.water(x),
        "Sphere": lambda fn, t, x: fn.sphere(x),
        "Jitter": lambda fn, t, x: fn.jitter(x, nDegree=2, seed=4),
        "GridMask": lambda fn, t, x: fn.grid_mask(x, tile=16, ratio=0.4, angle=0.3),
        "experimental.MedianBlur": lambda fn, t, x: fn.experimental.median_blur(
            x, window_size=5),
        "experimental.Dilate": lambda fn, t, x: fn.experimental.dilate(x, mask_size=[3, 5]),
        "experimental.Erode": lambda fn, t, x: fn.experimental.erode(x),
        "experimental.Clahe": lambda fn, t, x: fn.experimental.clahe(x),
        "experimental.Debayer": lambda fn, t, x: fn.experimental.debayer(x),
        "experimental.Debayer edge_aware": lambda fn, t, x: fn.experimental.debayer(
            x, algorithm="edge_aware"),
        "MultiPaste": lambda fn, t, x: fn.multi_paste(
            x, in_ids=fn.external_source(source=lambda: ids, batch=True),
            in_anchors=_per_sample(fn, batch, np.array(quad[:2] * 2, np.int32)),
            shapes=_per_sample(fn, batch, np.array(quad[2:] * 2, np.int32)),
            out_anchors=_per_sample(fn, batch, np.array([0, 0, h // 2, w // 2], np.int32))),
        "DumpImage": lambda fn, t, x: fn.dump_image(x),
        "TensorResize": lambda fn, t, x: fn.tensor_resize(x, sizes=[h * 0.75, w * 0.75],
                                                          axes=[0, 1]),
        "ResizeCropMirror": lambda fn, t, x: fn.resize_crop_mirror(
            x, resize_shorter=256.0, crop=[h, w], mirror=1),
        "FastResizeCropMirror": lambda fn, t, x: fn.fast_resize_crop_mirror(
            x, resize_shorter=256.0, crop=[h, w]),
        "JpegCompressionDistortion": lambda fn, t, x: fn.jpeg_compression_distortion(
            x, quality=50.0),
        "experimental.Remap": lambda fn, t, x: fn.experimental.remap(
            x, _per_sample(fn, batch, mx), _per_sample(fn, batch, my)),
        "experimental.WarpPerspective": lambda fn, t, x: fn.experimental.warp_perspective(
            x, matrix=HOMOGRAPHY),
    }


# Host against card, (max abs diff, share of values differing) per op. The
# CPU tests hold each package's two placements within these on the CPU
# (tests/test_torch_host_filters.py); integer ops are exact there and on the
# card; ops with float arithmetic agree exactly or within one step of a
# rounding on the CPU, and on the card get one step on at most 1e-3 of the
# values (1e-2 for the resize-crop-mirrors, whose placements differ on
# 6.7e-3 of the values on the CPU, 3e-2 for TensorResize, scipy's zoom on
# the host, whose placements differ on 1.9e-2 in dali_tpu), as the repo's
# other card-vs-CPU checks do. Jitter draws from different generators on each placement, the
# JPEG round trips differ by design and DumpImage has no gpu placement.
PLACEMENT_BOUNDS = {
    "GaussianBlur": (1, 1e-3), "Laplacian": (1, 1e-3), "experimental.Filter": (1, 1e-3),
    "experimental.Equalize": (0, 0.0), "Water": (1, 1e-3), "Sphere": (1, 1e-3),
    "GridMask": (1, 1e-3), "experimental.MedianBlur": (0, 0.0),
    "experimental.Dilate": (0, 0.0), "experimental.Erode": (0, 0.0),
    "experimental.Clahe": (1, 1e-3), "experimental.Debayer": (0, 0.0),
    "MultiPaste": (0, 0.0), "TensorResize": (1, 3e-2), "ResizeCropMirror": (1, 1e-2),
    "FastResizeCropMirror": (1, 1e-2), "experimental.Remap": (1, 1e-3),
    "experimental.WarpPerspective": (1, 1e-3),
}


def placement_pairs(pkg, device, batch=8, hw=(64, 80), seed=0, names=None, ragged=True, **kw):
    """Each op of ``PLACEMENT_BOUNDS`` on the host and on ``x.gpu()`` in one
    pipeline of ``pkg`` on ``device`` (``None``: the package's default;
    ``kw``: more pipeline arguments), over a ragged batch (``ragged``) or
    one of [hw] samples: {op: (max abs diff, share differing)}. The gpu
    Remap reads its maps as pixel centers (``pixel_origin="center"``), as
    the host one does."""
    rng = np.random.default_rng(seed)
    h, w = hw
    data = [np.clip(np.cumsum(rng.normal(0, 8, (h - 2 * i * ragged, w - i * ragged, 3)), 1) % 256,
                    0, 255).astype(np.uint8) for i in range(batch)]
    mosaics = [d[..., 1].copy() for d in data]
    cases = host_filter_cases(hw, batch)
    out = {}
    for name in names or PLACEMENT_BOUNDS:
        def graph(fn, t, x, gpu):
            if name == "experimental.Remap":
                mx, my = _remap_maps(h, w)
                return fn.experimental.remap(
                    x, *(_per_sample(fn, batch, m) if not gpu else
                         _per_sample(fn, batch, m).gpu() for m in (mx, my)),
                    **({"pixel_origin": "center"} if gpu else {}))
            if name == "experimental.Filter" and gpu:
                return fn.experimental.filter(x, _per_sample(
                    fn, batch, np.array([[0, -1, 0], [-1, 5, -1], [0, -1, 0]], np.float32)).gpu())
            return cases[name](fn, t, x)

        src = mosaics if name == "experimental.Debayer" else data

        @pkg.pipeline_def(batch_size=batch, num_threads=2, seed=seed,
                          **({} if device is None else {"device": device}), **kw)
        def both():
            x = pkg.fn.external_source(source=lambda: src, batch=True,
                                       layout="HW" if src is mosaics else "HWC")
            return graph(pkg.fn, pkg.types, x, False), graph(pkg.fn, pkg.types, x.gpu(), True)

        pipe = both()
        pipe.build()
        try:
            host, card = pipe.run()
        finally:
            (pipe.shutdown if hasattr(pipe, "shutdown") else pipe._executor.shutdown)()
        card = card.as_cpu() if hasattr(card, "as_cpu") else card
        d = np.concatenate([np.abs(np.asarray(host.at(i), np.float64)
                                   - np.asarray(card.at(i), np.float64)).reshape(-1)
                            for i in range(batch)])
        out[name] = (float(d.max()), float((d > 0).mean()))
    return out


def check_placements(pairs):
    """Raise for an op whose two placements are farther apart than its bound."""
    for name, (worst, share) in pairs.items():
        lim, lim_share = PLACEMENT_BOUNDS[name]
        if not (worst <= lim and share <= lim_share):
            raise AssertionError(f"{name}: host and card {worst} apart on {share:.2e} of the "
                                 f"values (limits {lim}, {lim_share})")


def host_filters(batch=256, hw=(224, 224)):
    """augmentation_gallery.py whole, the host ops timed (DumpImage writes
    its PNGs in a scratch directory under build/, deleted after), and the
    ops' two placements held on the card."""
    import shutil
    import tempfile

    example = {"augmentation_gallery.py": run_example("augmentation_gallery.py")}
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="dump_image_", dir=os.path.join(REPO, "build"))
    cwd = os.getcwd()
    os.chdir(scratch)
    try:
        host_ms = time_host_ops(batch, hw, cases=host_filter_cases(hw, batch))
    finally:
        os.chdir(cwd)
        shutil.rmtree(scratch)
    pairs = placement_pairs(__import__("dali_tpu_torch"), "cuda:0", batch=16, hw=hw)
    check_placements(pairs)
    return {"examples_s": example, "host_ms": host_ms, "placements": pairs,
            "threads": os.cpu_count()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--form", choices=["asr_resample", "rn50_dali_cpu", "host_geometry",
                                       "rn50_host_augment", "host_filters"],
                    default="rn50_dali_cpu")
    ap.add_argument("--timed", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_dali_cpu: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if args.form == "asr_resample":
        from dali_tpu_torch.testdata.make_audio_corpus import ensure_corpus

        r = run_asr_resample(ensure_corpus(rate=int(IN_RATE)), timed=args.timed)
    elif args.form in ("rn50_dali_cpu", "rn50_host_augment"):
        import chip_smoke

        r = run_rn50_dali_cpu(chip_smoke.write_file_list(), timed=args.timed,
                              augment=args.form == "rn50_host_augment")
    elif args.form == "host_geometry":
        r = host_geometry()
    else:
        r = host_filters()
    r["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
