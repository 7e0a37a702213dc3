"""asr_resample, rn50_dali_cpu and host_geometry: the paths of the
AudioResample, cpu CropMirrorNormalize and host geometry and colour
operators, on the card and its host.

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

``chip_smoke.py`` runs all three on the card. Alone, on the card:
``python dali_tpu_torch/tools/bench_dali_cpu.py --form
asr_resample|rn50_dali_cpu|host_geometry`` (one JSON line). The graph
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
SEEDS = {"reader": 1234, "crop": 77, "mirror": 5}
CMN_ATOL = 1e-5  # the CMN kernel against its plain version, and card CMN vs host CMN
RESAMPLE_RTOL = 1e-5  # of each clip's peak, card vs CPU
DB_ATOL = 1e-3
EXAMPLES = ("serialization.py", "transforms_3d.py", "audio_processing.py")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _stage_ms(ex) -> dict:
    if ex.record_stage_events or not ex.stage_events:
        raise AssertionError("the instrumented batch did not run")
    stages = {}
    for name, a, b in ex.stage_events:
        stages[name] = stages.get(name, 0.0) + a.elapsed_time(b)
    return stages


# -- asr_resample ------------------------------------------------------------------------------


def asr_resample_graph(fn, types, root, in_rate=IN_RATE, out_rate=OUT_RATE, mixed=True):
    """(resampled audio, dB mel, normalized dB mel) of asr_frontend's graph
    with the 48 kHz -> 16 kHz resample after the decode. ``mixed=False``
    decodes on the host and copies with ``.gpu()``: the same values, the
    form dali_tpu runs it in (its mixed decode gives the device resample no
    host shapes)."""
    enc, _ = fn.readers.file(file_root=root, file_filters=["*.wav"], random_shuffle=True,
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


def make_asr_resample_pipe(root, batch, device):
    from dali_tpu_torch import fn, pipeline_def, types

    @pipeline_def(batch_size=batch, seed=7, prefetch_queue_depth=2, device=device)
    def asr_resample():
        return asr_resample_graph(fn, types, root)

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


def run_asr_resample(root, batch=32, warmup=3, timed=10):
    """The path on the card, each batch taken and the next scheduled as an
    iterator does: clips/s, host ms/batch, device wait; then one batch run
    alone with its device ms by stage, and the peak device memory."""
    torch.cuda.reset_peak_memory_stats()
    pipe = make_asr_resample_pipe(root, batch, "cuda:0")
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


def check_asr_resample(root, batch=4, iterations=2):
    """The path at ``batch`` on the card and on the CPU: each clip's
    resampled signal within ``RESAMPLE_RTOL`` of its peak, its dB mel within
    ``DB_ATOL`` on the valid frames."""
    runs = {}
    for device in ("cuda:0", "cpu"):
        pipe = make_asr_resample_pipe(root, batch, device)
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


def rn50_dali_cpu_graph(fn, types, file_list, size=224, cmn_cpu=False):
    """(images, labels): the decode and RandomResizedCrop on the host, CMN
    on the card (or, with ``cmn_cpu``, on the host before ``.gpu()``). The
    random ops take explicit seeds, so both forms draw alike."""
    jpegs, labels = fn.readers.file(file_list=file_list, random_shuffle=True, name="Reader",
                                    seed=SEEDS["reader"])
    images = fn.decoders.image(jpegs, device="cpu")
    images = fn.random_resized_crop(images, device="cpu", size=[size, size],
                                    random_area=[0.08, 1.0], random_aspect_ratio=[0.75, 4 / 3],
                                    num_attempts=100, seed=SEEDS["crop"])
    mirror = fn.random.coin_flip(probability=0.5, seed=SEEDS["mirror"])
    kw = dict(mirror=mirror, dtype=types.FLOAT, output_layout="CHW", mean=MEAN, std=STD)
    if cmn_cpu:
        return fn.crop_mirror_normalize(images, device="cpu", **kw).gpu(), labels
    return fn.crop_mirror_normalize(images.gpu(), **kw), labels


def make_rn50_pipe(file_list, batch, device, cmn_cpu=False, num_threads=None):
    from dali_tpu_torch import fn, pipeline_def, types

    @pipeline_def(batch_size=batch, num_threads=num_threads or os.cpu_count() or 1, seed=42,
                  prefetch_queue_depth=2, device=device)
    def rn50_dali_cpu():
        return rn50_dali_cpu_graph(fn, types, file_list, cmn_cpu=cmn_cpu)

    pipe = rn50_dali_cpu()
    pipe.build()
    return pipe


def _check_rn50(b, batch, size=224):
    d, lab = b[0]["data"], b[0]["label"]
    if not (d.is_cuda and d.dtype == torch.float32 and tuple(d.shape) == (batch, 3, size, size)):
        raise AssertionError(f"rn50_dali_cpu: images {tuple(d.shape)} {d.dtype} on {d.device}")
    if not bool(torch.isfinite(d).all()):
        raise AssertionError("rn50_dali_cpu: non-finite values in a batch")
    if tuple(lab.shape) != (batch, 1) or lab.is_floating_point():
        raise AssertionError(f"rn50_dali_cpu: labels {tuple(lab.shape)} {lab.dtype}")


def run_rn50_dali_cpu(file_list, batch=256, warmup=3, timed=10):
    """The path on the card through ``DALIClassificationIterator``: images/s,
    host ms/batch by schema, device wait, the CMN launches of the run (set
    to 0 just before it: one per batch), device ms by stage of one batch
    run alone and peak memory."""
    from dali_tpu_torch.kernels import cmn
    from dali_tpu_torch.plugin.pytorch import DALIClassificationIterator

    torch.cuda.reset_peak_memory_stats()
    pipe = make_rn50_pipe(file_list, batch, "cuda:0")
    ex = pipe.executor
    cmn.COUNTER.launches = 0
    it = DALIClassificationIterator(pipe)
    for _ in range(warmup):
        _check_rn50(next(it), batch)
    torch.cuda.synchronize()
    st0, by0 = dict(ex.stats), dict(ex.host_seconds_by_schema)
    t0 = time.perf_counter()
    for _ in range(timed):
        _check_rn50(next(it), batch)
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
        raise AssertionError(f"rn50_dali_cpu: CMN kernel launched {launches} times for {ran} "
                             "batches")
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


def check_rn50_dali_cpu(file_list, batch=16, iterations=2):
    """The path against itself with CMN on the host: labels equal, images
    within ``CMN_ATOL`` (the kernel's x * a + b against the host's
    scale * (x - mean) / std + shift)."""
    runs = []
    for cmn_cpu in (False, True):
        pipe = make_rn50_pipe(file_list, batch, "cuda:0", cmn_cpu=cmn_cpu)
        runs.append([[o.as_tensor().cpu() for o in pipe.run()] for _ in range(iterations)])
        pipe.shutdown()
    worst = 0.0
    for (g_img, g_lab), (c_img, c_lab) in zip(*runs):
        if not torch.equal(g_lab, c_lab):
            raise AssertionError("rn50_dali_cpu: labels differ between the two CMN placements")
        worst = max(worst, float((g_img - c_img).abs().max()))
    if not worst <= CMN_ATOL:
        raise AssertionError(f"rn50_dali_cpu: CMN on the card and on the host {worst} apart")
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


def time_host_ops(batch=256, hw=(224, 224), threads=None, reps=2, seed=0):
    """Each host op on one [batch, *hw, 3] uint8 batch: host ms of the op's
    schema per batch (after one warm-up run), on one thread and on
    ``threads`` (the host's cores). Returns {op: {threads: ms}}."""
    from dali_tpu_torch import fn, pipeline_def, types

    rng = np.random.default_rng(seed)
    data = list(rng.integers(0, 256, (batch, *hw, 3), dtype=np.uint8))
    res = {}
    for name, graph in host_op_cases(hw).items():
        res[name] = {}
        for n_threads in sorted({1, threads or os.cpu_count() or 1}):
            @pipeline_def(batch_size=batch, num_threads=n_threads, seed=5,
                          prefetch_queue_depth=1)
            def one_op():
                return graph(fn, types, fn.external_source(source=lambda: data, batch=True,
                                                           layout="HWC"))

            pipe = one_op()
            pipe.build()
            try:
                pipe.run()
                ex = pipe.executor
                before = ex.host_seconds_by_schema.get(name, 0.0)
                for _ in range(reps):
                    pipe.run()
                res[name][n_threads] = 1e3 * (ex.host_seconds_by_schema[name] - before) / reps
            finally:
                pipe.shutdown()
    return res


def host_geometry(batch=256, hw=(224, 224)):
    """The three examples whole, then the host ops timed."""
    examples = {name: run_example(name) for name in EXAMPLES}
    return {"examples_s": examples, "host_ms": time_host_ops(batch, hw),
            "threads": os.cpu_count()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--form", choices=["asr_resample", "rn50_dali_cpu", "host_geometry"],
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
    elif args.form == "rn50_dali_cpu":
        import chip_smoke

        r = run_rn50_dali_cpu(chip_smoke.write_file_list(), timed=args.timed)
    else:
        r = host_geometry()
    r["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
