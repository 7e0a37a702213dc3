"""Sequences, volumes and FLAC on the card, at full width:

- ``sequence_augment``: ``readers.sequence`` over a corpus of 32 sequences
  (one per committed rn50 JPEG, decoded by the port's host decoder: 16
  frames of 224x224 panning across the image, written as 24-bit BMP under
  ``build/sequence_corpus`` at first use), 8 sequences of 16 frames a batch;
  on the card a per-sequence affine warp drawn by ``fn.transforms.*`` as
  rn50_affine_mixup draws it, ``gaussian_blur`` of sigma in [0.1, 2],
  ``experimental.equalize`` and ``crop_mirror_normalize`` to FLOAT FCHW
  (the CMN kernel's FCHW fold);
- ``volume_augment``: ``readers.numpy(device="gpu")`` over four BraTS-sized
  float32 volumes (``[4, 155, 240, 240]``, as numpy_volumes) through the
  centre 128^3 ROI at batch 2, transposed to DHWC, ``gaussian_blur`` with a
  per-sample sigma in [0.5, 1.5] on all three axes (as NVIDIA
  DeepLearningExamples' nnU-Net DALI loader blurs), then ``rotate`` about a
  per-sample random axis by an angle in [-15, 15] degrees, ``keep_size``;
- for ``chip_smoke.py``'s asr_flac phase (bench.py's asr_frontend over the
  128 clips written as 16-bit FLAC): ``host_decode_ms``, the host time of a
  batch's decode, FLAC or WAV.

Each form: 3 warm-up + timed batches through the PyTorch iterator, each
checked; the rate, host ms by schema and device ms by stage of one batch
alone; then the same graph at a small batch on the card against the CPU.

    python dali_tpu_torch/tools/bench_seq_volumes.py --form sequence_augment [--timed 10]

times one form on the card and prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD = os.path.join(REPO, "build")
MEAN = [0.485 * 255, 0.456 * 255, 0.406 * 255]
STD = [0.229 * 255, 0.224 * 255, 0.225 * 255]
LSB_OVER_STD = 1.0 / min(STD)
SEQ_BATCH, SEQ_FRAMES, SEQ_SIZE = 8, 16, 224
VOL_BATCH = 2
VOLUME = (4, 155, 240, 240)
ROI_START, ROI_SHAPE = [13, 56, 56], [128, 128, 128]  # the centre 128^3 of 155x240x240
VOLUME_ATOL = 1e-5  # card vs CPU, float32 volumes of unit scale
FORMS = ("sequence_augment", "volume_augment")
STAGES = {"h2d": "H2D", "WarpAffine": "warp", "GaussianBlur": "blur",
          "experimental.Equalize": "equalize", "CropMirrorNormalize": "CMN",
          "Transpose": "transpose", "Rotate": "rotate"}


# ------------------------------------------------------------------ sequence corpus


def bmp_bytes(rgb: np.ndarray) -> bytes:
    """A bottom-up 24-bit BMP of an RGB uint8 image."""
    h, w, _ = rgb.shape
    row = -(-w * 3 // 4) * 4
    px = np.zeros((h, row), np.uint8)
    px[:, :w * 3] = rgb[::-1, :, ::-1].reshape(h, w * 3)
    info = (40).to_bytes(4, "little") + w.to_bytes(4, "little") + h.to_bytes(4, "little")
    info += (1).to_bytes(2, "little") + (24).to_bytes(2, "little") + bytes(4)
    info += (h * row).to_bytes(4, "little") + (2835).to_bytes(4, "little") * 2 + bytes(8)
    size = 14 + 40 + h * row
    return b"BM" + size.to_bytes(4, "little") + bytes(4) + (54).to_bytes(4, "little") + info + \
        px.tobytes()


def ensure_sequence_corpus(root: str = os.path.join(BUILD, "sequence_corpus"),
                           frames: int = SEQ_FRAMES, size: int = SEQ_SIZE) -> str:
    """One sequence per committed rn50 JPEG: ``frames`` windows of
    ``size``^2 panning from the top-left corner to the bottom-right one,
    each a BMP ``root/sNN/fKK.bmp``. Written once; returns root."""
    from dali_tpu_torch import imgcodec

    marker = os.path.join(root, ".complete")
    if os.path.exists(marker):
        return root
    src = os.path.join(REPO, "dali_tpu_torch", "testdata", "rn50")
    files = sorted(os.path.join(r, f) for r, _, fs in os.walk(src) for f in fs
                   if f.endswith(".jpg"))
    for i, path in enumerate(files):
        with open(path, "rb") as f:
            img = imgcodec.decode(f.read())
        h, w = img.shape[:2]
        d = os.path.join(root, f"s{i:02d}")
        os.makedirs(d, exist_ok=True)
        for k in range(frames):
            y = round(k * (h - size) / (frames - 1))
            x = round(k * (w - size) / (frames - 1))
            with open(os.path.join(d, f"f{k:02d}.bmp"), "wb") as f:
                f.write(bmp_bytes(img[y:y + size, x:x + size]))
    with open(marker, "w") as f:
        f.write("ok")
    return root


def sequence_graph(fn, types, root, frames=SEQ_FRAMES, size=SEQ_SIZE, stages=False):
    """The sequence_augment graph; with ``stages`` also the warped, blurred
    and equalized uint8 sequences."""
    c = [size / 2.0, size / 2.0]
    seqs = fn.readers.sequence(file_root=root, sequence_length=frames, random_shuffle=True,
                               name="Reader")
    mt = fn.transforms.rotation(angle=fn.random.uniform(range=[-15.0, 15.0]), center=c)
    mt = fn.transforms.scale(mt, scale=fn.random.uniform(range=[0.9, 1.1], shape=[2]), center=c)
    mt = fn.transforms.shear(mt, angles=fn.random.normal(stddev=3.0, shape=[2]), center=c)
    mt = fn.transforms.combine(mt, fn.transforms.translation(
        offset=fn.random.uniform(range=[-8.0, 8.0], shape=[2])))
    warped = fn.warp_affine(seqs.gpu(), matrix=mt, fill_value=0.0, inverse_map=False)
    blurred = fn.gaussian_blur(warped, sigma=fn.random.uniform(range=[0.1, 2.0]))
    equalized = fn.experimental.equalize(blurred)
    out = fn.crop_mirror_normalize(equalized, dtype=types.FLOAT, output_layout="FCHW", mean=MEAN,
                                   std=STD)
    return (out, warped, blurred, equalized) if stages else out


def make_sequence_pipe(root, batch, device, stages=False, frames=SEQ_FRAMES, size=SEQ_SIZE):
    from dali_tpu_torch import fn, pipeline_def, types

    @pipeline_def(batch_size=batch, num_threads=os.cpu_count() or 1, seed=42,
                  prefetch_queue_depth=2, device=device)
    def sequence_augment():
        return sequence_graph(fn, types, root, frames, size, stages)

    pipe = sequence_augment()
    pipe.build()
    return pipe


# ------------------------------------------------------------------ volumes


def volume_graph(fn, vols):
    """The volume_augment graph on ``vols``, CDHW volumes on the device."""
    return augment_volumes(fn, fn.transpose(vols, perm=[1, 2, 3, 0], output_layout="DHWC"))


def augment_volumes(fn, dhwc):
    """Blur and rotate DHWC volumes on the device; the draws take explicit
    seeds, so a graph with or without the transpose draws the same."""
    blurred = fn.gaussian_blur(dhwc, sigma=fn.random.uniform(range=[0.5, 1.5], seed=11))
    return fn.rotate(blurred, angle=fn.random.uniform(range=[-15.0, 15.0], seed=12),
                     axis=fn.random.normal(shape=[3], seed=13), keep_size=True)


def make_volume_pipe(files, batch, device, roi_start=ROI_START, roi_shape=ROI_SHAPE):
    from dali_tpu_torch import fn, pipeline_def

    @pipeline_def(batch_size=batch, num_threads=1, seed=42, prefetch_queue_depth=2,
                  device=device)
    def volume_augment():
        return volume_graph(fn, fn.readers.numpy(
            files=files, device="gpu", random_shuffle=True, name="Reader", roi_start=roi_start,
            roi_shape=roi_shape, roi_axes=[1, 2, 3]))

    pipe = volume_augment()
    pipe.build()
    return pipe


# ------------------------------------------------------------------ measurement


def _drive(pipe, name, warmup, timed, check):
    """``bench_readers._drive`` with ``check`` on the one output ``name``."""
    from dali_tpu_torch.tools import bench_readers

    return bench_readers._drive(pipe, [name], warmup, timed, lambda b: check(b[0][name]))


def _stages_alone(pipe):
    """Device ms by stage of one batch alone (``bench_readers._stages_alone``),
    by the names of ``STAGES``."""
    from dali_tpu_torch.tools import bench_readers

    stages = {}
    for name, ms in bench_readers._stages_alone(pipe).items():
        k = STAGES.get(name, name)
        stages[k] = stages.get(k, 0.0) + ms
    return stages


def _rates(st, by, timed):
    return {"host_ms_per_batch": 1e3 * st["host_phase_seconds"] / st["host_batches"],
            "device_wait_ms_per_batch": 1e3 * st["device_wait_seconds"] / timed,
            "host_ms_by_schema": dict(sorted(by.items(), key=lambda kv: -kv[1]))}


def step_diff(a: torch.Tensor, b: torch.Tensor):
    """(max abs difference, share of values that differ)."""
    d = (a.to(torch.float64) - b.to(torch.float64)).abs()
    return float(d.max()), float((d > 0).to(torch.float64).mean())


def run_sequences(root, batch=SEQ_BATCH, warmup=3, timed=10):
    """sequence_augment on the card: frames/s, host ms by schema, the CMN
    launches of the run (set to 0 just before it, one per batch), device ms
    by stage of one batch alone, peak memory, and the CMN kernel held
    against its plain version on one more batch of the path and timed on
    it (``bench_ssd.hold_cmn``, ``time_cmn``)."""
    from dali_tpu_torch.kernels import cmn
    from dali_tpu_torch.tools import bench_ssd

    shape = (batch, SEQ_FRAMES, 3, SEQ_SIZE, SEQ_SIZE)

    def check(t):
        if not (t.is_cuda and t.dtype == torch.float32 and tuple(t.shape) == shape):
            raise AssertionError(f"sequence_augment: {tuple(t.shape)} {t.dtype} on {t.device}")
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("sequence_augment: non-finite values in a batch")

    torch.cuda.reset_peak_memory_stats()
    pipe = make_sequence_pipe(root, batch, "cuda:0")
    cmn.COUNTER.launches = 0
    dt, st, by, ran = _drive(pipe, "frames", warmup, timed, check)
    launches = cmn.COUNTER.launches
    if launches != ran:
        raise AssertionError(f"sequence_augment: CMN launched {launches} times for {ran} batches")
    stages = _stages_alone(pipe)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with bench_ssd.recording_cmn([]) as calls:
        pipe.run()
    pipe.shutdown()
    held = dict(bench_ssd.time_cmn(calls[0]), max_abs_err=bench_ssd.hold_cmn(calls[0]))
    return dict(_rates(st, by, timed), form="sequence_augment", batch=batch, timed=timed,
                frames_per_s=timed * batch * SEQ_FRAMES / dt, stage_ms=stages, peak_gib=peak,
                cmn_launches=launches, cmn=held)


def check_sequences(root, batch=2, iterations=2, frames=SEQ_FRAMES, size=SEQ_SIZE):
    """The graph at ``batch`` on the card and on the CPU: the warped,
    blurred and equalized uint8 sequences within one step on at most 1e-3
    of values, the FCHW output within one uint8 step / std."""
    runs = []
    for device in ("cuda:0", "cpu"):
        pipe = make_sequence_pipe(root, batch, device, stages=True, frames=frames, size=size)
        runs.append([[o.as_tensor().cpu() for o in pipe.run()] for _ in range(iterations)])
        pipe.shutdown()
    res = {}
    for name, k in (("warp", 1), ("blur", 2), ("equalize", 3), ("normalized", 0)):
        worst, frac = 0.0, 0.0
        for got, want in zip(*runs):
            if got[k].shape != want[k].shape:
                raise AssertionError(f"sequence_augment {name}: card {tuple(got[k].shape)}, "
                                     f"CPU {tuple(want[k].shape)}")
            w, f = step_diff(got[k], want[k])
            worst, frac = max(worst, w), max(frac, f)
        limit = LSB_OVER_STD + 1e-4 if name == "normalized" else 1.0
        if not (worst <= limit and frac <= 1e-3):
            raise AssertionError(f"sequence_augment {name}: card vs CPU max diff {worst} on "
                                 f"{frac:.2e} of values (limits {limit}, 1e-3)")
        res[name] = {"max_diff": worst, "frac_differing": frac}
    return dict(res, batch=batch, iterations=iterations)


def run_volumes(files, batch=VOL_BATCH, warmup=3, timed=10):
    """volume_augment on the card: GB/s of the 128^3 ROI delivered through
    blur and rotation, host ms by schema, device ms by stage of one batch
    alone, peak memory."""
    shape = (batch, *ROI_SHAPE, VOLUME[0])
    nbytes = int(np.prod(shape)) * 4

    def check(t):
        if not (t.is_cuda and t.dtype == torch.float32 and tuple(t.shape) == shape):
            raise AssertionError(f"volume_augment: {tuple(t.shape)} {t.dtype} on {t.device}")
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("volume_augment: non-finite values in a batch")

    torch.cuda.reset_peak_memory_stats()
    pipe = make_volume_pipe(files, batch, "cuda:0")
    dt, st, by, _ = _drive(pipe, "volumes", warmup, timed, check)
    stages = _stages_alone(pipe)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    pipe.shutdown()
    return dict(_rates(st, by, timed), form="volume_augment", batch=batch, timed=timed,
                bytes_per_batch=nbytes, gb_per_s=timed * nbytes / dt / 1e9, stage_ms=stages,
                peak_gib=peak)


def check_volumes(files, batch=VOL_BATCH, iterations=1, roi_shape=ROI_SHAPE, volume=VOLUME):
    """The graph on the card and on the CPU, the centre ``roi_shape`` of
    ``volume``-shaped files: float32 within ``VOLUME_ATOL``."""
    start = [(v - r) // 2 for v, r in zip(volume[1:], roi_shape)]
    runs = []
    for device in ("cuda:0", "cpu"):
        pipe = make_volume_pipe(files, batch, device, start, roi_shape)
        runs.append([pipe.run()[0].as_tensor().cpu() for _ in range(iterations)])
        pipe.shutdown()
    worst = 0.0
    for got, want in zip(*runs):
        if got.shape != want.shape:
            raise AssertionError(f"volume_augment: card {tuple(got.shape)}, CPU "
                                 f"{tuple(want.shape)}")
        worst = max(worst, step_diff(got, want)[0])
    if not worst <= VOLUME_ATOL:
        raise AssertionError(f"volume_augment: card vs CPU max abs diff {worst} (limit "
                             f"{VOLUME_ATOL})")
    return {"max_abs_diff": worst, "batch": batch, "roi": list(roi_shape)}


def volume_phase(root, n_files=4, seed=0, warmup=3, timed=10):
    """run_volumes and check_volumes (on a 64^3 ROI) over ``n_files``
    volumes written under ``root`` from ``seed`` as numpy_volumes writes
    them; the files are deleted at the end, also on failure."""
    from dali_tpu_torch.testdata.make_reader_datasets import write_npy_volumes

    t0 = time.perf_counter()
    try:
        files = write_npy_volumes(root, n_files, VOLUME, seed)
        written = time.perf_counter() - t0
        r = run_volumes(files, warmup=warmup, timed=timed)
        r["check"] = check_volumes(files, roi_shape=[64, 64, 64])
        return written, r
    finally:
        shutil.rmtree(root, ignore_errors=True)


def host_decode_ms(root, ext, batch=32, reps=3):
    """Host ms to decode ``batch`` clips of ``root`` (``*.ext``) in one
    ``decode_audio_batch`` on the host's cores (median of ``reps``)."""
    from dali_tpu_torch import native
    from dali_tpu_torch.backend.audio import decode_audio_batch

    clips = sorted(os.listdir(os.path.join(root, "clips")))
    datas = []
    for name in [c for c in clips if c.endswith("." + ext)][:batch]:
        with open(os.path.join(root, "clips", name), "rb") as f:
            datas.append(f.read())
    pool = native.shared_pool(os.cpu_count() or 1)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        decode_audio_batch(pool, datas)
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--form", choices=FORMS, default="sequence_augment")
    ap.add_argument("--timed", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_seq_volumes: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if args.form == "sequence_augment":
        root = ensure_sequence_corpus()
        r = run_sequences(root, timed=args.timed)
        r["check"] = check_sequences(root)
    else:
        written, r = volume_phase(os.path.join(BUILD, "volume_augment"), timed=args.timed)
        r["write_s"] = written
    r["card"] = card_line()
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
