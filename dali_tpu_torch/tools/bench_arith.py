"""rn50_arith_train: rn50_train's recipe over arithmetic-coded JPEGs, at full
width on the card.

The corpus is ``testdata/arith``: the committed 32-file rn50 corpus
re-coded losslessly with arithmetic coding (extended sequential SOF9 and
progressive SOF10 in turn, as ``jpegtran -arithmetic`` would write an
archive), in the same class folders. The recipe is rn50_train's unchanged:
``readers.file`` (shuffled), ``decoders.image_random_crop(device="mixed",
hybrid_device_decode=True, hybrid_scale=2)``, ``resize`` to 224x224 and CMN
to FLOAT CHW with a coin-flip mirror, batch 256. The hybrid reader's
Huffman fast paths decline these streams and the full read
(``csrc/host/jpeg_arith.cc``) entropy-decodes every coefficient, as the
reference falls back to libjpeg; the device half (wire unpack, IDCT tail,
resize, CMN) is rn50_train's.

``measure`` times a form (``rn50_arith_train``, or ``rn50_train`` over the
Huffman originals, in the same call); ``check_twins`` runs both corpora with
the same seeds and file order and holds each batch's uint8 crops, FLOAT CHW
images and labels bit for bit equal; ``read_ms`` times the host coefficient
read of each corpus on one thread. ``chip_smoke.py`` runs this as its phase
41;

    python dali_tpu_torch/tools/bench_arith.py [--timed 10] [--batch 256]

runs it alone on the card and prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
TESTDATA = os.path.join(ROOT, "dali_tpu_torch", "testdata")
CORPORA = {"rn50_arith_train": os.path.join(TESTDATA, "arith"),
           "rn50_train": os.path.join(TESTDATA, "rn50")}
OUT = 224
MEAN = [0.485 * 255, 0.456 * 255, 0.406 * 255]
STD = [0.229 * 255, 0.224 * 255, 0.225 * 255]


def write_file_list(form, batch=256) -> str:
    """``path label`` lines of the form's corpus, sorted as rn50_train's list,
    repeated to at least one batch."""
    root = CORPORA[form]
    files = sorted(os.path.join(c, f) for c in sorted(os.listdir(root))
                   for f in sorted(os.listdir(os.path.join(root, c))))
    if len(files) != 32:
        raise AssertionError(f"expected the 32-file corpus under {root}, found {len(files)}")
    entries = [f"{os.path.join(root, f)} {int(f.split(os.sep)[0][len('class'):])}" for f in files]
    lines = (entries * (-(-batch // len(entries))))[:max(batch, len(entries))]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    path = os.path.join(ROOT, "build", f"{form}_file_list.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def make_pipe(file_list, batch, device, crops=False):
    """rn50_train's recipe over ``file_list``; with ``crops`` the decoded
    uint8 crops are an output too."""
    from dali_tpu_torch import fn, pipeline_def, types

    @pipeline_def(batch_size=batch, num_threads=os.cpu_count() or 1, seed=42,
                  prefetch_queue_depth=2, device=device)
    def rn50_train():
        jpegs, labels = fn.readers.file(file_list=file_list, random_shuffle=True, name="Reader")
        decoded = fn.decoders.image_random_crop(jpegs, device="mixed", hybrid_device_decode=True,
                                                hybrid_scale=2)
        images = fn.resize(decoded, resize_x=OUT, resize_y=OUT)
        images = fn.crop_mirror_normalize(images, mirror=fn.random.coin_flip(probability=0.5),
                                          dtype=types.FLOAT, output_layout="CHW", mean=MEAN,
                                          std=STD)
        return (images, labels, decoded) if crops else (images, labels)

    pipe = rn50_train()
    pipe.build()
    return pipe


def check_batch(batch, n):
    img, label = batch[0]["data"], batch[0]["label"]
    if not (img.is_cuda and img.dtype == torch.float32 and tuple(img.shape) == (n, 3, OUT, OUT)):
        raise AssertionError(f"images {tuple(img.shape)} {img.dtype} on {img.device}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("non-finite image values")
    if tuple(label.shape) != (n, 1) or label.is_floating_point():
        raise AssertionError(f"labels {tuple(label.shape)} {label.dtype}")
    if not set(label.reshape(-1).tolist()) <= {0, 1}:
        raise AssertionError("labels outside the corpus's two classes")


def measure(form, batch=256, warmup=3, timed=10):
    """One form at full width through ``DALIClassificationIterator`` (the
    CMN launch count set to 0 just before and equal to the batches run),
    then one batch alone by stage, the peak device memory, and one more
    batch with its CMN call recorded: the kernel held against its plain
    version on that batch and timed on it."""
    from dali_tpu_torch.kernels import cmn
    from dali_tpu_torch.tools import bench_readers, bench_ssd

    torch.cuda.reset_peak_memory_stats()
    pipe = make_pipe(write_file_list(form, batch), batch, "cuda:0")
    cmn.COUNTER.launches = 0
    dt, st, by, ran = bench_readers._drive(pipe, ["data", "label"], warmup, timed,
                                           lambda b: check_batch(b, batch))
    launches = cmn.COUNTER.launches
    if launches != ran:
        raise AssertionError(f"{form}: CMN kernel launched {launches} times for {ran} batches")
    stages = bench_readers._stages_alone(pipe)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with bench_ssd.recording_cmn([]) as calls:
        pipe.run()
    pipe.shutdown()
    held = dict(bench_ssd.time_cmn(calls[0]), max_abs_err=bench_ssd.hold_cmn(calls[0]))
    return {"form": form, "batch": batch, "timed": timed, "images_per_s": timed * batch / dt,
            "host_ms_per_batch": 1e3 * st["host_phase_seconds"] / st["host_batches"],
            "device_wait_ms_per_batch": 1e3 * st["device_wait_seconds"] / timed,
            "host_ms_by_schema": dict(sorted(by.items(), key=lambda kv: -kv[1])),
            "stage_ms": stages, "peak_gib": peak, "cmn_launches": launches, "cmn": held}


def _canvas(t):
    """A device output's samples, each cropped to its host-known shape."""
    data = t.as_tensor()
    return [data[i][tuple(slice(0, int(e)) for e in s)] for i, s in enumerate(t.shape())]


def check_twins(batch=256, batches=2, device="cuda:0"):
    """rn50_train over the twins and over the Huffman originals, same seeds
    and file order: each batch's uint8 crops, FLOAT CHW images and labels
    equal bit for bit. Returns the numbers compared."""
    pipes = [make_pipe(write_file_list(form, batch), batch, device, crops=True)
             for form in ("rn50_arith_train", "rn50_train")]
    crops = values = 0
    try:
        for _ in range(batches):
            a, h = (p.run() for p in pipes)
            if not torch.equal(a[0].as_tensor(), h[0].as_tensor()):
                raise AssertionError("FLOAT CHW batches of the twins differ")
            if (a[1].as_array() != h[1].as_array()).any():
                raise AssertionError("labels of the twins differ")
            for u, v in zip(_canvas(a[2]), _canvas(h[2])):
                if u.dtype != torch.uint8 or not torch.equal(u, v):
                    raise AssertionError("uint8 crops of the twins differ")
                crops += 1
            values += a[0].as_tensor().numel()
    finally:
        for p in pipes:
            p.shutdown()
    return {"batches": batches, "batch": batch, "crops": crops, "float_values": values}


def read_ms(reps=3):
    """The host's full coefficient read (``native.jpeg_read_coeffs``, every
    coefficient of every component) of each corpus on one thread: ms per
    image, and the bytes of each corpus."""
    from dali_tpu_torch import native

    out = {}
    for form, root in CORPORA.items():
        datas = [open(os.path.join(r, f), "rb").read() for r, _, fs in sorted(os.walk(root))
                 for f in sorted(fs)]
        infos = [native.jpeg_coef_info(d) for d in datas]
        for d, info in zip(datas, infos):
            native.jpeg_read_coeffs(d, 8, 8, *info[2:6])
        t0 = time.perf_counter()
        for _ in range(reps):
            for d, info in zip(datas, infos):
                native.jpeg_read_coeffs(d, 8, 8, *info[2:6])
        out[form] = {"ms_per_image": 1e3 * (time.perf_counter() - t0) / (reps * len(datas)),
                     "images": len(datas), "bytes": sum(len(d) for d in datas)}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--timed", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_arith: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    res = {form: measure(form, args.batch, timed=args.timed) for form in CORPORA}
    res["twins"] = check_twins(args.batch)
    res["read_ms"] = read_ms()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
