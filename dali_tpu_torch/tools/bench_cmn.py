"""Time the CMN kernel (``csrc/cmn.cu``) alone and through its wrapper.

Run from the repository root on a machine with a CUDA card:

    python dali_tpu_torch/tools/bench_cmn.py [--package-root DIR] [--reps N] [--out PATH]

For each form at the main path's shape ([256, 224, 224, 3] uint8, mixed
mirror flags, every third sample's valid width trimmed by 37 columns) it
prints one line: the C entry point alone with the L2 cache flushed before
each launch (a 64 MiB buffer is written outside the timed window; the
38.5 MB input would otherwise stay in the 50 MB L2), the same with a warm L2,
the wrapper ``kernels.cmn.crop_mirror_normalize`` (Python and all), the plain
PyTorch version, the bytes the function must move (each input byte read once,
each output byte written once), the HBM bound at 3.35 TB/s, the kernel's
share of it and its agreement with the plain version (float32 within 1e-5,
float16 within one half-precision step). It also times one ``copy_`` of the
permuted input into a float32 CHW tensor, a single PyTorch call that moves
the bytes of the first form (a cast and transpose, no crop or normalise), as
a yardstick of the bandwidth one call reaches; the port never calls it.

``--package-root`` imports ``dali_tpu_torch`` from another checkout, for
example a parent commit unpacked with ``git archive``, so that two versions
of the kernel are timed in one call. A library that has only the first
kernel's entry point ``dali_tpu_torch_cmn_u8_chw`` is timed through it, in
the forms it supports. The last line is a JSON object with every reading.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet
BATCH, SIZE, TRIM = 256, 224, 37
MEAN = [0.485 * 255, 0.456 * 255, 0.406 * 255]
STD = [0.229 * 255, 0.224 * 255, 0.225 * 255]
# name, output dtype, output layout, pad_output
FORMS = (
    ("u8_f32_chw", torch.float32, "CHW", False),
    ("u8_f16_chw", torch.float16, "CHW", False),
    ("u8_f16_hwc_pad", torch.float16, "HWC", True),
)


def main_path_inputs(batch: int = BATCH, size: int = SIZE, seed: int = 0):
    """(data, crop origins, mirror flags, valid widths) on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    data = torch.randint(0, 256, (batch, size, size, 3), dtype=torch.uint8, device="cuda",
                         generator=g)
    origin = torch.zeros((batch,), dtype=torch.int32, device="cuda")
    mirror = (torch.arange(batch, device="cuda") % 2).to(torch.int32)
    ext_w = torch.full((batch,), size, dtype=torch.int32, device="cuda")
    ext_w[::3] = size - TRIM  # mirror reverses only these samples' valid columns
    return data, origin, mirror, ext_w


def form_bytes(data, crop_h: int, crop_w: int, out_dtype, pad_output: bool) -> int:
    """Bytes the function must move: the crop windows read once, the output
    written once."""
    n, _, _, c = data.shape
    cout = 4 if pad_output else c
    out_size = torch.empty((), dtype=out_dtype).element_size()
    return n * crop_h * crop_w * (c * data.element_size() + cout * out_size)


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def time_ms(fn, reps: int = 20, flush=None) -> float:
    """Median device milliseconds of ``fn()`` between CUDA events; with
    ``flush`` (a CUDA byte tensor larger than the L2) the buffer is written
    before each timed launch, outside the events."""
    for _ in range(3):
        fn()
    pairs = []
    for i in range(reps):
        if flush is not None:
            flush.fill_(i & 0xFF)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def within_f16_step(got, want) -> bool:
    """|got - want| at most one float16 step, 2**(floor(log2 |x|) - 10), at
    the larger magnitude (2**-24 below the normal range)."""
    g, w = got.float(), want.float()
    step = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs()).clamp(
        min=2.0 ** -14))) - 10)
    return bool(((g - w).abs() <= step).all())


def l2_flush_buffer(mib: int = 64):
    return torch.empty(mib << 20, dtype=torch.uint8, device="cuda")


def raw_launch(cmn, data, origin, mirror, ext_w, out_dtype, layout, pad_output):
    """(output, closure calling the C entry point alone with every argument
    prepared once), or (None, None) where the library has no entry point for
    the form."""
    lib = cmn._kernel_lib()
    if hasattr(lib, "dali_tpu_torch_cmn"):
        out, args, keep = cmn.launch_args(data, origin, origin, mirror, SIZE, SIZE, MEAN, STD,
                                          1.0, 0.0, layout, out_dtype, pad_output, ext_w=ext_w)
        entry = lib.dali_tpu_torch_cmn
    elif layout == "CHW" and not pad_output:  # the first kernel's ABI
        n, H, W, C = data.shape
        cy, cx, vw = cmn._window(data, origin, origin, SIZE, SIZE, ext_w)
        a, b = cmn.fold_constants(MEAN, STD, 1.0, 0.0, C)
        out = torch.empty((n, C, SIZE, SIZE), dtype=out_dtype, device=data.device)
        args = (data.data_ptr(), out.data_ptr(), cy.data_ptr(), cx.data_ptr(), mirror.data_ptr(),
                vw.data_ptr(), n, H, W, C, SIZE, SIZE, *[float(v) for v in a], 0.0,
                *[float(v) for v in b], 0.0, int(out_dtype == torch.float16),
                torch.cuda.current_stream().cuda_stream)
        entry = lib.dali_tpu_torch_cmn_u8_chw
        keep = (cy, cx, vw)
    else:
        return None, None

    def call(keep=keep):  # holds the tensors the arguments point into
        err = entry(*args)
        if err != 0:
            raise RuntimeError(f"CMN kernel launch failed: cudaError {err}")

    return out, call


def measure(cmn, reps: int = 50):
    """Readings of every form the library supports, and the copy yardstick."""
    data, origin, mirror, ext_w = main_path_inputs()
    flush = l2_flush_buffer()
    forms = []
    for name, out_dtype, layout, pad in FORMS:
        out, call = raw_launch(cmn, data, origin, mirror, ext_w, out_dtype, layout, pad)
        if call is None:
            continue
        args = (data, origin, origin, mirror, SIZE, SIZE, MEAN, STD, 1.0, 0.0, layout, out_dtype)
        kw = dict(ext_w=ext_w, **({"pad_output": True} if pad else {}))
        call()
        want = cmn.crop_mirror_normalize_plain(*args, **kw)
        wrapped = cmn.crop_mirror_normalize(*args, **kw)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        agrees = (err <= 1e-5 if out_dtype == torch.float32
                  else within_f16_step(out, want))
        if not torch.equal(out, wrapped):
            raise AssertionError(f"{name}: the entry point and the wrapper disagree")
        nbytes = form_bytes(data, SIZE, SIZE, out_dtype, pad)
        ms = time_ms(call, reps, flush)
        forms.append({
            "name": name, "shape_out": list(out.shape), "bytes": nbytes,
            "bound_ms": bound_ms(nbytes), "ms": ms, "bound_share": bound_ms(nbytes) / ms,
            "warm_ms": time_ms(call, reps),
            "wrapper_ms": time_ms(lambda: cmn.crop_mirror_normalize(*args, **kw), reps),
            "plain_ms": time_ms(lambda: cmn.crop_mirror_normalize_plain(*args, **kw), 10),
            "max_abs_err": err, "agrees": agrees})
    n, h, w, c = data.shape
    dst = torch.empty((n, c, h, w), dtype=torch.float32, device="cuda")
    copy_ms = time_ms(lambda: dst.copy_(data.permute(0, 3, 1, 2)), reps, flush)
    nbytes = form_bytes(data, h, w, torch.float32, False)
    copy = {"bytes": nbytes, "ms": copy_ms, "bound_share": bound_ms(nbytes) / copy_ms}
    return forms, copy


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default=None, help="also write the JSON readings here")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_cmn: needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(opts.package_root)
    sys.path.insert(0, root)
    from dali_tpu_torch.kernels import cmn

    card = card_line()
    forms, copy = measure(cmn, opts.reps)
    print(f"card: {card}; package: {root}")
    for f in forms:
        print(f"{f['name']} -> {f['shape_out']}: kernel alone {f['ms']:.4f} ms cold L2 "
              f"({f['warm_ms']:.4f} warm), wrapper {f['wrapper_ms']:.4f}, plain "
              f"{f['plain_ms']:.4f}; {f['bytes']} bytes, bound {f['bound_ms']:.4f} ms, "
              f"{100 * f['bound_share']:.1f}% of it; max abs diff {f['max_abs_err']:.3e}")
    print(f"yardstick copy_ of the permuted input to f32 CHW: {copy['ms']:.4f} ms cold L2, "
          f"{100 * copy['bound_share']:.1f}% of the bound")
    res = {"card": card, "package_root": root, "forms": forms, "copy": copy}
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
