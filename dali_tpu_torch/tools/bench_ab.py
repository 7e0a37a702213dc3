"""rn50_train of two checkouts in one call, in turns (A B B A ...).

Each turn runs ``chip_smoke.py``'s rn50_train (batch 256, 224x224, its
``drive``: 3 warm-up and ``--timed`` batches through the iterator) in a
fresh process from one checkout's root, which builds that checkout's
libraries on first use. On a card:

    python dali_tpu_torch/tools/bench_ab.py --roots build/parent . [--pairs 2]

prints one JSON line per turn (root, images/s, host ms/batch, device wait)
and, last, the card's name and power limit with each root's median.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

TURN = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
pipe = cs.make_pipe(cs.write_file_list(), cs.BATCH, cs.OUT, "cuda:0")
ips, st, _, _ = cs.drive(pipe, {timed}, "rn50_train")
pipe.shutdown()
print(json.dumps({{"images_per_s": ips,
                   "host_ms_per_batch": 1e3 * st["host_phase_seconds"] / st["host_batches"],
                   "device_wait_ms_per_batch": 1e3 * st["device_wait_seconds"] / {timed}}}))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs=2, required=True, help="checkout A and checkout B")
    ap.add_argument("--pairs", type=int, default=2, help="A B B A counts as two pairs")
    ap.add_argument("--timed", type=int, default=20)
    args = ap.parse_args()
    a, b = (os.path.abspath(r) for r in args.roots)
    order = [a, b, b, a] * (args.pairs // 2) + [a, b] * (args.pairs % 2)
    rates = {a: [], b: []}
    for root in order:
        out = subprocess.run([sys.executable, "-c", TURN.format(timed=args.timed)], cwd=root,
                             check=True, capture_output=True, text=True).stdout
        r = json.loads(out.strip().splitlines()[-1])
        rates[root].append(r["images_per_s"])
        print(json.dumps(dict(r, root=os.path.relpath(root))), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, "median_images_per_s": {
        os.path.relpath(r): statistics.median(v) for r, v in rates.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
