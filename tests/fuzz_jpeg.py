"""Damaged and out-of-range JPEG streams through dali_tpu_torch's host decoder
against dali_tpu's libjpeg-turbo route (``dali_tpu.native.decode_jpeg``).

Two probes, each printing one JSON line of counts:

* ``--damage arith|huffman|progressive``: each file of ``testdata/arith``
  (arithmetic coded), ``testdata/rn50`` (baseline Huffman) or ``testdata/rn50``
  re-coded as progressive Huffman by ``make_codec_corpus.Transcoder`` (needs
  ``cc`` and libjpeg's headers) in turn, 1-5 random bytes from its first
  scan on replaced and 30% of the streams then cut at 30-100% of their
  length, decoded at 1/2 scale: equal pixels, both failing, or one of the
  five ways they part;
* ``--idct``: small corpus images re-encoded by cv2 with every
  quantisation table rewritten as 16-bit values up to 300, 3,000 or
  65,535, so dequantised coefficients leave the 8-bit range, decoded at
  1/1-1/8 scale (grey without and RGB with fancy upsampling): the streams
  whose every decode equals libjpeg's.

Not collected by pytest (no ``test_`` prefix); it needs the reference's
``dali_tpu.native``. ``--root DIR`` imports ``dali_tpu_torch`` from another
checkout (a ``git archive`` of a parent commit) to compare commits:

    python tests/fuzz_jpeg.py --damage arith --seeds 1 2 3 --n 200
    python tests/fuzz_jpeg.py --damage huffman --seeds 1 2 --n 200
    python tests/fuzz_jpeg.py --damage progressive --seeds 1 2 --n 200
    python tests/fuzz_jpeg.py --idct --seeds 0 7 11 --n 100
"""

import argparse
import glob
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _damaged(data: bytes, rng) -> bytes:
    d = bytearray(data)
    sos = d.find(b"\xff\xda")
    for _ in range(int(rng.integers(1, 6))):
        d[int(rng.integers(sos + 14, len(d) - 2))] = int(rng.integers(0, 256))
    if rng.random() < 0.3:
        d = d[:int(len(d) * rng.uniform(0.3, 1.0))]
    return bytes(d)


def _corpus(corpus):
    """The undamaged streams of one corpus, in file order."""
    testdata = os.path.join(HERE, "..", "dali_tpu_torch", "testdata")
    files = sorted(glob.glob(os.path.join(testdata, "arith" if corpus == "arith" else "rn50",
                                          "*", "*.jpg")))
    streams = []
    for path in files:
        with open(path, "rb") as f:
            streams.append(f.read())
    if corpus == "progressive":
        import tempfile

        sys.path.insert(0, testdata)
        from make_codec_corpus import Transcoder

        with tempfile.TemporaryDirectory() as tmp:
            t = Transcoder(tmp)
            streams = [t(s, arith=False, progressive=True) for s in streams]
    return streams


def damage(ref, port, corpus, seed, n):
    import numpy as np

    streams = _corpus(corpus)
    rng = np.random.default_rng(seed)
    out = dict(equal=0, both_fail=0, differ=0, port_only_fails=0, ref_only_fails=0)
    for i in range(n):
        data = _damaged(streams[i % len(streams)], rng)
        want = ref.decode_jpeg(data, denom=2)
        try:
            got = port.decode_jpeg(data, 2)
        except (ValueError, NotImplementedError):
            got = None
        if want is None or got is None:
            key = ("both_fail" if want is None and got is None
                   else "ref_only_fails" if want is None else "port_only_fails")
        else:
            key = "equal" if want.shape == got.shape and np.array_equal(want, got) else "differ"
        out[key] += 1
    return out


def _with_16bit_tables(data: bytes, rng, top: int) -> bytes:
    out, i = bytearray(data[:2]), 2
    while i < len(data) and data[i] == 0xFF:
        m, length = data[i + 1], (data[i + 2] << 8) | data[i + 3]
        if m == 0xDB:
            seg, j, body = data[i + 4:i + 2 + length], 0, bytearray()
            while j < len(seg):
                body += bytes([0x10 | (seg[j] & 15)]) + b"".join(
                    int(v).to_bytes(2, "big") for v in rng.integers(1, top + 1, 64))
                j += 1 + (128 if seg[j] >> 4 else 64)
            out += b"\xff\xdb" + (len(body) + 2).to_bytes(2, "big") + body
        else:
            out += data[i:i + 2 + length]
        if m == 0xDA:
            return bytes(out + data[i + 2 + length:])
        i += 2 + length
    raise ValueError("no scan")


def idct(ref, port, seed, n):
    import cv2
    import numpy as np

    files = sorted(glob.glob(os.path.join(HERE, "..", "dali_tpu_torch", "testdata", "rn50",
                                          "*", "*.jpg")))
    sampling = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]
    rng = np.random.default_rng(seed)
    equal = 0
    for i in range(n):
        h, w = int(rng.integers(8, 40)), int(rng.integers(8, 40))
        img = cv2.resize(cv2.imread(files[i % 8]), (w, h))
        data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, int(rng.integers(5, 100)),
                                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling[i % 3]])[1]
        data = _with_16bit_tables(data.tobytes(), rng, int(rng.choice([300, 3000, 65535])))
        same = True
        for denom in (1, 2, 4, 8):
            for fancy, gray in ((False, True), (True, False)):
                want = ref.decode_jpeg(data, denom=denom, fancy_upsampling=fancy, gray=gray)
                got = port.decode_jpeg(data, denom, fancy, gray)
                same &= want is not None and want.shape == got.shape and np.array_equal(want, got)
        equal += bool(same)
    return dict(streams=n, equal=equal)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--damage", choices=["arith", "huffman", "progressive"])
    mode.add_argument("--idct", action="store_true")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--root", default=os.path.join(HERE, ".."))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    from dali_tpu import native as ref
    from dali_tpu_torch import native as port

    for seed in args.seeds:
        res = (idct(ref, port, seed, args.n) if args.idct
               else damage(ref, port, args.damage, seed, args.n))
        print(json.dumps(dict(seed=seed, **res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
