"""ColorTwist, Hsv and Saturation gpu on the card, one checkout of
``dali_tpu_torch`` against another, at the batch shapes of the paths that run
them (gpu_ops' tie cases, rn50_affine_mixup's per-sample hue, the effnet
recipes' Saturation, ssd_device_encode's Hsv to float).

For each checkout given (``--roots``, default this one), in a process of its
own and in the order given (parent, change, change, parent to compare two):
the device ms of each op on one batch (the H2D copy aside; ``REPS`` timed
runs after two warm-ups, through that checkout's ``Executor`` stage events)
and the peak device memory of the run. Then, in this process and this
checkout: ``kernels/pointwise.py``'s ``_fma_sum`` on the card, a chain of
``torch.addcmul``, against one rounding per term emulated in float64
(values differing and ms of each: whether ``addcmul`` rounds once), and Hsv with a
per-sample hue other than 0 on the card against the CPU at batch 64 and 256.

    python -m dali_tpu_torch.tools.bench_color_twist [--roots DIR ...] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPS = 5
CASES = {  # name: (batch, height, width)
    "color_twist_brightness_0.9": (256, 224, 224),
    "hsv_value_0.9": (256, 224, 224),
    "color_twist_hue": (256, 224, 224),
    "saturation": (256, 224, 224),
    "hsv_float_ssd": (64, 300, 300),
}


def _graph(name, fn, types, x, a, b):
    if name == "color_twist_brightness_0.9":
        return fn.color_twist(x, brightness=0.9)
    if name == "hsv_value_0.9":
        return fn.hsv(x, value=0.9)
    if name == "color_twist_hue":
        return fn.color_twist(x, hue=a, saturation=0.8, brightness=1.1, contrast=1.2)
    if name == "saturation":
        return fn.saturation(x, saturation=b)
    return fn.hsv(x, dtype=types.FLOAT, hue=a, saturation=b)


def _pipe(name, imgs, hue, factor, device):
    from dali_tpu_torch import fn, pipeline_def, types

    @pipeline_def(batch_size=len(imgs), num_threads=1, seed=5, device=device,
                  prefetch_queue_depth=1)
    def one_op():
        x = fn.external_source(source=lambda: imgs, batch=True, layout="HWC").gpu()
        a = fn.external_source(source=lambda: list(hue), batch=True)
        b = fn.external_source(source=lambda: list(factor), batch=True)
        return _graph(name, fn, types, x, a, b)

    pipe = one_op()
    pipe.build()
    return pipe


def _inputs(rng, batch, h, w):
    imgs = rng.integers(0, 256, (batch, h, w, 3), np.uint8)
    return ([imgs[i] for i in range(batch)], rng.uniform(-30, 30, batch).astype(np.float32),
            rng.uniform(0.5, 1.5, batch).astype(np.float32))


def measure_root():
    """Device ms and peak memory of each case with the ``dali_tpu_torch``
    first on ``sys.path``."""
    import torch
    from dali_tpu_torch.tools.bench_rcm_jpeg import stage_ms

    rng = np.random.default_rng(3)
    res = {}
    for name, (batch, h, w) in CASES.items():
        imgs, hue, factor = _inputs(rng, batch, h, w)
        pipe = _pipe(name, imgs, hue, factor, "cuda:0")
        try:
            for _ in range(2):
                pipe.run()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms = []
            for _ in range(REPS):
                pipe.executor.record_stage_events = True
                pipe.run()
                torch.cuda.synchronize()
                ms.append(sum(v for k, v in stage_ms(pipe.executor).items() if k != "H2D"))
            res[name] = {"shape": [batch, h, w, 3], "ms": ms,
                         "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                         "peak_over_start_gib": (torch.cuda.max_memory_allocated() - base)
                         / 2 ** 30}
        finally:
            pipe.shutdown()
    return res


def _events_ms(f, reps=REPS):
    import torch

    f()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        f()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def addcmul_vs_emulation(shape=(64, 300, 300, 3)):
    """The per-pixel product of ``apply_color_matrices`` on the card two ways:
    ``_fma_sum``'s chain of ``torch.addcmul``, and one rounding per term
    emulated in float64."""
    import torch
    from dali_tpu_torch.kernels import pointwise as pw

    g = torch.Generator(device="cuda:0").manual_seed(7)
    x = torch.randint(0, 256, shape, generator=g, device="cuda:0").to(torch.float32)
    m = torch.randn((shape[0], 1, 1, 3, 3), generator=g, device="cuda:0")

    def emulated():
        x64, m64 = x.to(torch.float64), m.to(torch.float64)
        acc = (x64[..., 0, None] * m64[..., 0]).to(torch.float32)
        for c in (1, 2):
            acc = (acc.to(torch.float64) + x64[..., c, None] * m64[..., c]).to(torch.float32)
        return acc

    def chained():
        return pw._fma_sum((x[..., c, None], m[..., c]) for c in range(3))

    e, a = emulated(), chained()
    return {"shape": list(shape), "values": e.numel(), "differing": int((e != a).sum()),
            "emulated_ms": _events_ms(emulated), "addcmul_ms": _events_ms(chained)}


def hue_card_vs_cpu(batches=(64, 256), hw=(16, 16)):
    """Hsv with a per-sample hue other than 0, uint8 and float32 out: values
    differing between the card and the CPU."""
    rng = np.random.default_rng(5)
    out = {}
    for batch in batches:
        imgs, hue, factor = _inputs(rng, batch, *hw)
        for name in ("color_twist_hue", "hsv_float_ssd"):
            got = []
            for device in ("cuda:0", "cpu"):
                pipe = _pipe(name, imgs, hue, factor, device)
                try:
                    tl = pipe.run()[0]
                    got.append(np.stack([np.asarray(tl.as_cpu().at(i)) for i in range(batch)]))
                finally:
                    pipe.shutdown()
            out[f"{name}_batch_{batch}"] = {"values": int(got[0].size),
                                            "differing": int((got[0] != got[1]).sum()),
                                            "max_abs_diff": float(np.abs(got[0].astype(np.float64)
                                                                         - got[1]).max())}
    return out


def card_line():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not available"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", default=[HERE],
                    help="checkouts holding a dali_tpu_torch package, measured in this order")
    ap.add_argument("--out", help="write the results here as JSON")
    ap.add_argument("--one", help=argparse.SUPPRESS)  # measure this checkout, write JSON here
    args = ap.parse_args(argv)
    if args.one:
        import dali_tpu_torch

        print(f"measuring {os.path.dirname(os.path.dirname(dali_tpu_torch.__file__))}",
              flush=True)
        with open(args.one, "w") as f:
            json.dump(measure_root(), f)
        return 0
    card = card_line()
    print(f"card: {card}", flush=True)
    runs = []
    for root in args.roots:
        root = os.path.abspath(root)
        with tempfile.NamedTemporaryFile(suffix=".json") as tmp:
            env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
            subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tmp.name],
                           cwd=root, env=env, check=True)
            with open(tmp.name) as f:
                r = json.load(f)
        runs.append({"root": os.path.relpath(root, HERE), "cases": r})
        for name, v in r.items():
            ms = sorted(v["ms"])
            print(f"{os.path.relpath(root, HERE)} {name} {v['shape']}: device ms median "
                  f"{ms[len(ms) // 2]:.3f}, min {ms[0]:.3f} over {len(ms)}; peak device memory "
                  f"{v['peak_gib']:.3f} GiB ({v['peak_over_start_gib']:.3f} over the pipeline's "
                  f"start) ({card})", flush=True)
    sys.path.insert(0, HERE)
    fma = addcmul_vs_emulation()
    print(f"addcmul chain vs float64 emulation on {fma['shape']}: {fma['differing']} of "
          f"{fma['values']} values differ; ms median emulated "
          f"{sorted(fma['emulated_ms'])[REPS // 2]:.3f}, addcmul "
          f"{sorted(fma['addcmul_ms'])[REPS // 2]:.3f} ({card})", flush=True)
    hue = hue_card_vs_cpu()
    for k, v in hue.items():
        print(f"card vs CPU {k}: {v['differing']} of {v['values']} values differ, max abs diff "
              f"{v['max_abs_diff']:.3g}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": runs, "addcmul": fma, "hue_card_vs_cpu": hue}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
