"""The SSD300 detection input on the card: ``docs/examples/ssd_detection.py``'s
graph (COCO reader, IoU-constrained random crop, host decode of the window,
resize 300x300, coin-flip box flip and mirror, CMN FLOAT CHW, SSD anchor
matching) at SSD300's full width, in two forms:

- ``ssd_train``: the example as written: the window decoded on the host
  (``decoders.image_slice(device="cpu")``), ``.gpu()``, Resize and CMN on the
  card, ``bb_flip`` and ``box_encoder`` on the host;
- ``ssd_device_encode``: DALI's upstream SSD300 PyTorch recipe: the window
  decoded by the mixed decoder, ``hsv`` and ``brightness_contrast`` on the
  card, and ``bb_flip`` and ``box_encoder`` with ``device="gpu"`` on
  ``boxes.gpu()`` / ``labels.gpu()``.

The anchors are SSD300's 8,732 default boxes (``dboxes300_coco``). The data
is the committed 32-file corpus under an annotation file made from a seed
(``testdata/make_coco_annotations.py``). ``chip_smoke.py`` runs both forms as
its phase 14;

    python dali_tpu_torch/tools/bench_ssd.py [--form ssd_train] [--timed 20]

times one form on the card at batch 64 (annotation seed 0) and prints one
JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

MEAN = [0.485 * 255, 0.456 * 255, 0.406 * 255]
STD = [0.229 * 255, 0.224 * 255, 0.225 * 255]
SIZE = 300
FORMS = ("ssd_train", "ssd_device_encode")
BOX_ATOL, TIE = 1e-6, 1e-6
CMN_ATOL = 1e-5  # float32 output: the kernel's FMA against the plain multiply, then add
CORPUS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "testdata",
                      "rn50")


def dboxes300_coco() -> np.ndarray:
    """SSD300's default boxes as [8732, 4] ltrb float32 (Liu et al. 2016;
    NVIDIA DeepLearningExamples ``dboxes300_coco``): feature maps
    38/19/10/5/3/1, 4/6/6/6/4/4 boxes per cell, centres and sizes clipped
    to [0, 1] before the conversion to ltrb."""
    fig, feat = 300, [38, 19, 10, 5, 3, 1]
    steps, scales = [8, 16, 32, 64, 100, 300], [21, 45, 99, 153, 207, 261, 315]
    ratios = [[2], [2, 3], [2, 3], [2, 3], [2], [2]]
    boxes = []
    for k, f in enumerate(feat):
        fk = fig / steps[k]
        sk1, sk2 = scales[k] / fig, scales[k + 1] / fig
        sizes = [(sk1, sk1), (np.sqrt(sk1 * sk2),) * 2]
        for alpha in ratios[k]:
            w, h = sk1 * np.sqrt(alpha), sk1 / np.sqrt(alpha)
            sizes += [(w, h), (h, w)]
        for w, h in sizes:
            for i, j in itertools.product(range(f), repeat=2):
                boxes.append(((j + 0.5) / fk, (i + 0.5) / fk, w, h))
    xywh = np.clip(np.asarray(boxes, np.float64), 0, 1)
    ltrb = np.concatenate([xywh[:, :2] - xywh[:, 2:] / 2, xywh[:, :2] + xywh[:, 2:] / 2], 1)
    return ltrb.astype(np.float32)


def make_pipe(annotations, batch, device, form="ssd_train", size=SIZE, with_boxes=False,
              num_threads=None):
    """One form of the recipe (see the module docstring); outputs (images,
    encoded boxes, encoded labels), with ``with_boxes`` also the flipped
    boxes and the labels that went into the encoder."""
    from dali_tpu_torch import fn, pipeline_def, types

    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    anchors = dboxes300_coco()
    on_card = form == "ssd_device_encode"

    @pipeline_def(batch_size=batch, num_threads=num_threads or os.cpu_count() or 1, seed=42,
                  prefetch_queue_depth=2, device=device)
    def ssd():
        jpegs, bboxes, labels = fn.readers.coco(
            file_root=CORPUS, annotations_file=annotations, ltrb=True, ratio=True,
            random_shuffle=True, name="Reader")
        crop_begin, crop_size, bboxes, labels = fn.random_bbox_crop(
            bboxes, labels, aspect_ratio=[0.5, 2.0], thresholds=[0.0, 0.1, 0.3, 0.5, 0.7, 0.9],
            scaling=[0.3, 1.0], allow_no_crop=True, num_attempts=4)
        if on_card:
            images = fn.decoders.image_slice(jpegs, crop_begin, crop_size, device="mixed")
        else:
            images = fn.decoders.image_slice(jpegs, crop_begin, crop_size, device="cpu").gpu()
        images = fn.resize(images, resize_x=size, resize_y=size)
        if on_card:
            saturation = fn.random.uniform(range=[0.5, 1.5])
            contrast = fn.random.uniform(range=[0.5, 1.5])
            brightness = fn.random.uniform(range=[0.875, 1.125])
            hue = fn.random.uniform(range=[-0.5, 0.5])
            images = fn.hsv(images, dtype=types.FLOAT, hue=hue, saturation=saturation)
            images = fn.brightness_contrast(images, brightness=brightness, contrast_center=128,
                                            contrast=contrast)
            bboxes, labels = bboxes.gpu(), labels.gpu()
        flip = fn.random.coin_flip(probability=0.5)
        bboxes = fn.bb_flip(bboxes, horizontal=flip, ltrb=True)
        images = fn.crop_mirror_normalize(images, mirror=flip, dtype=types.FLOAT,
                                          output_layout="CHW", mean=MEAN, std=STD)
        enc_boxes, enc_labels = fn.box_encoder(bboxes, labels, anchors=anchors.reshape(-1),
                                               criteria=0.5)
        outs = (images, enc_boxes, enc_labels)
        return outs + (bboxes, labels) if with_boxes else outs

    return ssd()


def check_batch(batch, n, form):
    """One iterator batch: images [n, 3, size, size] float32 on the card and
    finite; encoded boxes [n, A, 4] float32 and labels [n, A] int32, on the
    card in the device-encode form, on the host otherwise."""
    out = batch[0]
    img, boxes, labels = out["images"], out["bboxes"], out["labels"]
    if not (img.is_cuda and img.dtype == torch.float32 and tuple(img.shape) == (n, 3, SIZE, SIZE)):
        raise AssertionError(f"{form}: images {tuple(img.shape)} {img.dtype} on {img.device}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{form}: non-finite image values")
    want_cuda = form == "ssd_device_encode"
    for t, shape, dtype in ((boxes, (n, 8732, 4), torch.float32),
                            (labels, (n, 8732), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dtype or t.is_cuda != want_cuda:
            raise AssertionError(f"{form}: encoder output {tuple(t.shape)} {t.dtype} on "
                                 f"{t.device}")
    if not bool(torch.isfinite(boxes).all()):
        raise AssertionError(f"{form}: non-finite encoded boxes")


def check_against_cpu_encoder(boxes, labels, got_boxes, got_labels, anchors, criteria=0.5):
    """Hold one sample of the device BoxEncoder against ``encode_boxes`` on
    the same boxes. Labels must be equal, or each mismatch must be a tie:
    its anchor's best IoU within ``TIE`` of the criterion or of the
    runner-up box, or a box's best anchor tied with its runner-up anchor
    there. Boxes of the equal labels agree within ``BOX_ATOL``. Returns the
    explained mismatches as (anchor, got label, cpu label, best IoU,
    runner-up IoU); raises on any other difference."""
    from dali_tpu_torch.backend.bbox import encode_boxes, iou_matrix

    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    want_b, want_l = encode_boxes(boxes, np.asarray(labels), anchors, criteria, False,
                                  [0.0] * 4, [1.0] * 4, 1.0)
    got_boxes, got_labels = np.asarray(got_boxes), np.asarray(got_labels)
    same = got_labels == want_l
    err = float(np.abs(got_boxes[same] - want_b[same]).max()) if same.any() else 0.0
    if err > BOX_ATOL:
        raise AssertionError(f"encoded boxes differ from the cpu encoder by {err} > {BOX_ATOL}")
    explained = []
    if same.all():
        return explained
    iou = iou_matrix(boxes, anchors)
    rows = np.sort(iou, axis=1)
    row_tied = (rows[:, -1] - rows[:, -2] <= TIE) if iou.shape[1] > 1 else np.zeros(len(iou), bool)
    for a in np.nonzero(~same)[0]:
        col = np.sort(iou[:, a])[::-1]
        best, second = float(col[0]), float(col[1]) if len(col) > 1 else -1.0
        claim = row_tied & (rows[:, -1] - iou[:, a] <= TIE)
        if not (abs(best - criteria) <= TIE or best - second <= TIE or claim.any()):
            raise AssertionError(
                f"anchor {a}: label {got_labels[a]} against the cpu encoder's {want_l[a]} "
                f"with best IoU {best} and runner-up {second}: not a tie")
        explained.append((int(a), int(got_labels[a]), int(want_l[a]), best, second))
    return explained


@contextlib.contextmanager
def recording_cmn(calls):
    """While open, the first call of the CMN wrapper (the operator calls it
    through the module) is recorded into ``calls``: its arguments and its
    output, copied on the card as the main path made them."""
    from dali_tpu_torch.kernels import cmn

    wrapper = cmn.crop_mirror_normalize
    copy = lambda v: v.clone() if torch.is_tensor(v) else v  # noqa: E731

    def recording(*args, **kw):
        out = wrapper(*args, **kw)
        if not calls:
            calls.append(([copy(v) for v in args], {k: copy(v) for k, v in kw.items()},
                          out.clone()))
        return out

    cmn.crop_mirror_normalize = recording
    try:
        yield calls
    finally:
        cmn.crop_mirror_normalize = wrapper


def hold_cmn(call) -> float:
    """The main path's own CMN output (``recording_cmn``) against
    ``crop_mirror_normalize_plain`` on the same arguments; the max abs
    difference, raising above ``CMN_ATOL``."""
    from dali_tpu_torch.kernels import cmn

    args, kw, got = call
    if args[11] != torch.float32:
        raise AssertionError(f"the SSD forms write float32, the CMN call wrote {args[11]}")
    want = cmn.crop_mirror_normalize_plain(*args, **kw)
    if tuple(got.shape) != tuple(want.shape):
        raise AssertionError(f"CMN output {tuple(got.shape)}, plain {tuple(want.shape)}")
    err = float((got - want).abs().max())
    if not err <= CMN_ATOL:
        raise AssertionError(f"CMN kernel on the main path's batch {tuple(args[0].shape)} "
                             f"{args[0].dtype}: max abs diff {err} from its plain version")
    return err


def time_cmn(call, reps=30):
    """On the arguments of a recorded CMN call: the C entry point alone with
    the L2 flushed (its output must equal the recorded one), the wrapper
    and the plain version, beside the HBM bound of the bytes the function
    must move (the windows read once, the output written once)."""
    from dali_tpu_torch.kernels import cmn
    from dali_tpu_torch.tools import bench_cmn

    args, kw, got = call
    data = args[0]
    out, cargs, keep = cmn.launch_args(*args, **kw)
    lib = cmn._kernel_lib()

    def alone(keep=keep):
        if lib.dali_tpu_torch_cmn(*cargs) != 0:
            raise RuntimeError("CMN kernel launch failed")

    alone()
    if not torch.equal(out, got):
        raise AssertionError("the CMN entry point and the main path's output disagree")
    nbytes = bench_cmn.form_bytes(data, args[4], args[5], args[11], bool(args[12]))
    ms = bench_cmn.time_ms(alone, reps, bench_cmn.l2_flush_buffer())
    bound = bench_cmn.bound_ms(nbytes)
    return {"shape_in": list(data.shape), "dtype_in": str(data.dtype).replace("torch.", ""),
            "shape_out": list(got.shape), "bytes": nbytes, "ms": ms,
            "wrapper_ms": bench_cmn.time_ms(lambda: cmn.crop_mirror_normalize(*args, **kw), reps),
            "plain_ms": bench_cmn.time_ms(lambda: cmn.crop_mirror_normalize_plain(*args, **kw),
                                          10),
            "bound_ms": bound, "bound_share": bound / ms}


def measure(form, annotations, batch=64, warmup=3, timed=20):
    """Build one form on the card and run it through ``DALIGenericIterator``:
    ``warmup`` + ``timed`` batches, each checked, then the prefetched ones
    collected. The CMN launch count is set to 0 just before and must equal
    the batches run; host ms/batch by operator schema over the timed
    batches. Then one instrumented batch run alone: device ms by stage
    (CUDA events) and the peak device memory of the phase. Last, one more
    batch with its CMN call recorded, and the kernel held against its plain
    version on the batch the path gave it, and timed on it (``hold_cmn``,
    ``time_cmn``; launches after the count was read)."""
    from dali_tpu_torch.kernels import cmn
    from dali_tpu_torch.plugin.pytorch import DALIGenericIterator

    torch.cuda.reset_peak_memory_stats()
    pipe = make_pipe(annotations, batch, "cuda:0", form)
    pipe.build()
    ex = pipe.executor
    cmn.COUNTER.launches = 0
    it = DALIGenericIterator(pipe, ["images", "bboxes", "labels"])
    for _ in range(warmup):
        check_batch(next(it), batch, form)
    torch.cuda.synchronize()
    st0, by0 = dict(ex.stats), dict(ex.host_seconds_by_schema)
    t0 = time.perf_counter()
    for _ in range(timed):
        check_batch(next(it), batch, form)
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
        raise AssertionError(f"{form}: CMN kernel launched {launches} times for {ran} batches")
    ex.record_stage_events = True
    pipe.run()
    torch.cuda.synchronize()
    if ex.record_stage_events or not ex.stage_events:
        raise AssertionError(f"{form}: the instrumented batch did not run")
    stages = {}
    for name, a, b in ex.stage_events:
        stages[name] = stages.get(name, 0.0) + a.elapsed_time(b)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with recording_cmn([]) as calls:
        pipe.run()
    pipe.shutdown()
    held = dict(time_cmn(calls[0]), max_abs_err=hold_cmn(calls[0]))
    return {"form": form, "batch": batch, "timed": timed, "images_per_s": timed * batch / dt,
            "host_ms_per_batch": 1e3 * st["host_phase_seconds"] / st["host_batches"],
            "device_wait_ms_per_batch": 1e3 * st["device_wait_seconds"] / timed,
            "host_ms_by_schema": dict(sorted(by.items(), key=lambda kv: -kv[1])),
            "stage_ms": stages, "peak_gib": peak, "cmn_launches": launches, "cmn": held}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--form", choices=FORMS, default="ssd_train")
    ap.add_argument("--timed", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_ssd: needs a CUDA card", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, repo)
    from dali_tpu_torch.testdata.make_coco_annotations import write_annotations

    ann = write_annotations(os.path.join(repo, "build", "coco_annotations.json"), 0)
    r = measure(args.form, ann, timed=args.timed)
    r["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
