"""The Matroska archive training path on the card, at full width: ``mkv_archive_train``.

Matroska is the container of FFV1 archives (FFV1 version 3 in Matroska is
the IETF CELLAR form, RFC 9043, that film and video archives store) and of
the DivX/Xvid-era ``.mkv`` files. This is ``docs/examples/video_training.py``'s
recipe, as ``bench_video.py``'s ``video_clip_train`` runs it, over
``testdata/video/mkv_corpus``: 16 Xvid clips with B-frames at 600 kbit/s
(48 frames) and 16 FFV1 version 3 clips at 4:2:0 with the archival settings
(intra-only, slice CRCs, 16 slices; 12 frames), 320x240 at 25 fps, in two
class folders, so the EBML demuxer, the MPEG-4 Part 2 decoder's B-frames
numbered by pts and FFV1's range coder are on the path.
``readers.video(device="mixed", file_root=..., sequence_length=8,
stride=1, random_shuffle=True, pad_mode="edge")`` (both codecs are class 1:
the planar YUV wire, RGB on the card; stride 1 so that a 12-frame FFV1 clip
holds a sequence), ``resize`` to 112x112, ``rotate`` and ``gaussian_blur``
drawn once a sequence, ``crop_mirror_normalize`` to FLOAT FCHW with a
coin-flip mirror (the CMN kernel's FCHW fold on ``[32, 8, 112, 112, 3]``
uint8); batch 32.

``check_fixtures`` holds every committed Matroska file (the fixtures of
``testdata/video/mkv`` and the corpus), decoded on this machine by the
port's host decoder, against ``testdata/video/mkv_reference.npz``
(dali_tpu's FFmpeg 5.1 read and info, and its reads after seeks through
one handle), and the forms left to later parts of item 8b raising.
``run``, ``decode_rate`` (by codec) and ``check_mixed_vs_cpu`` are
``bench_video``'s over the corpus; ``open_cost`` times the open against the
file's length.

    python dali_tpu_torch/tools/bench_mkv.py [--timed 10]

runs all of it on the card and prints one JSON line.
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import json
import os
import struct
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VIDEO = os.path.join(REPO, "dali_tpu_torch", "testdata", "video")
MKV_CORPUS = os.path.join(VIDEO, "mkv_corpus")
FORM = "mkv_archive_train"
STRIDE = 1


def _yuv_shas(vf, start, count, stride=1):
    y, u, v, got = vf.read_yuv(start, count, stride, pad=False)
    return [hashlib.sha256(y[i].tobytes() + u[i].tobytes() + v[i].tobytes()).digest()
            for i in range(got)]


def check_fixtures(root=VIDEO):
    """Every file of mkv_reference.npz decoded here: its info (width,
    height, frames, fps, pixel-format class), each frame's RGB and YUV hash
    from frame 0, and the reference's reads after seeks through one handle;
    then the fixtures the reference file does not hold (the forms left to
    later parts of item 8b) raising NotImplementedError naming their item.
    Returns the files, frames and seeks compared."""
    from dali_tpu_torch import native

    ref = np.load(os.path.join(root, "mkv_reference.npz"))
    names = sorted({k.split(":")[0] for k in ref.files})
    frames = seeks = 0
    for name in names:
        path = os.path.join(root, name)
        vf = native.VideoFile(path)
        info = (vf.width, vf.height, vf.num_frames, vf.fps, vf.pixfmt_class)
        if info != tuple(ref[name + ":info"].tolist()):
            raise AssertionError(f"{name}: info {info}, reference {ref[name + ':info']}")
        n = vf.num_frames
        shas = [hashlib.sha256(f.tobytes()).digest() for f in vf.read(0, n, pad=False)]
        if shas != [bytes(r) for r in ref[name + ":rgb_sha"]]:
            raise AssertionError(f"{name}: RGB frames differ from mkv_reference.npz")
        yuv = name + ":yuv_sha"
        if yuv in ref.files and _yuv_shas(native.VideoFile(path), 0, n) != [
                bytes(r) for r in ref[yuv]]:
            raise AssertionError(f"{name}: YUV frames differ from mkv_reference.npz")
        if name + ":seeks" in ref.files:
            vf = native.VideoFile(path)
            got = [s for start, k in ref[name + ":seeks"] for s in
                   _yuv_shas(vf, int(start), int(k))]
            if got != [bytes(r) for r in ref[name + ":seek_sha"]]:
                raise AssertionError(f"{name}: reads after seeks differ from the reference's")
            seeks += len(ref[name + ":seeks"])
        frames += len(shas)
    unported = sorted({f"mkv/{f}" for f in os.listdir(os.path.join(root, "mkv"))} - set(names))
    for name in unported:
        try:
            native.VideoFile(os.path.join(root, name))
        except NotImplementedError as e:
            if "item 8b(" not in str(e):
                raise AssertionError(f"{name}: {e}") from None
        else:
            raise AssertionError(f"{name}: opened, but the reference file holds no decode of it")
    return {"files": len(names), "frames": frames, "seeks": seeks, "unported": len(unported)}


def run(warmup=3, timed=10):
    from dali_tpu_torch.tools import bench_video

    return bench_video.run(warmup=warmup, timed=timed, root=MKV_CORPUS, form=FORM, stride=STRIDE)


def _long_file(clips, n):
    """One Matroska file of ``n`` corpus clips in a row: the first clip's
    header, every clip's Clusters with their Timestamps moved on by the
    clips before, the Segment's Duration their sum (no Cues)."""
    from dali_tpu_torch.testdata import make_video_corpus as mvc

    parsed = [mvc.mkv_without_index(mvc.ebml_parse(c)) for c in clips]
    out = copy.deepcopy(parsed[0])
    seg = mvc.mkv_segment(out)
    seg[:] = [e for e in seg if e[0] != mvc.MKV_CLUSTER]
    def info(segment):
        return next(e for e in segment if e[0] == 0x1549A966)

    span = 0.0  # in TimestampScale units (1 ms)
    for i in range(n):
        src = mvc.mkv_segment(parsed[i % len(parsed)])
        for _, cl in (copy.deepcopy(e) for e in src if e[0] == mvc.MKV_CLUSTER):
            for item in cl:
                if item[0] == 0xE7:
                    item[1] = (int.from_bytes(item[1], "big") + int(span)).to_bytes(4, "big")
            seg.append([mvc.MKV_CLUSTER, cl])
        duration = next(b for e, b in mvc.ebml_parse(info(src)[1]) if e == 0x4489)
        span += struct.unpack(">d" if len(duration) == 8 else ">f", duration)[0]
    kids = [k for k in mvc.ebml_parse(info(seg)[1]) if k[0] != 0x4489]
    info(seg)[1] = mvc.ebml_write(kids + [[0x4489, struct.pack(">d", span)]])
    return mvc.ebml_write(out)


def open_cost(lengths=(1, 16, 64), reps=5, work=None):
    """The open's cost against the file's length: for each codec, the first
    corpus clip and ``n`` clips in one file (``_long_file``; the clips
    repeat past 16), written under ``work`` (a temporary directory by
    default). Each file is opened ``reps`` times from its path with the
    page cache warm; the least time is kept, with the handle's index bytes
    (``VideoFile.index_bytes``) and the frames a whole read gives."""
    import tempfile

    from dali_tpu_torch import native

    out = []
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        for kind in ("xvid", "ffv1"):
            names = sorted(os.listdir(os.path.join(MKV_CORPUS, kind)))
            clips = []
            for c in names:
                with open(os.path.join(MKV_CORPUS, kind, c), "rb") as f:
                    clips.append(f.read())
            for n in lengths:
                path = os.path.join(tmp, f"{kind}_{n}.mkv")
                with open(path, "wb") as f:
                    f.write(_long_file(clips, n))
                best = float("inf")
                for _ in range(reps):
                    t0 = time.perf_counter()
                    vf = native.VideoFile(path)
                    best = min(best, time.perf_counter() - t0)
                    index = vf.index_bytes()
                    vf.close()
                vf = native.VideoFile(path)
                pictures = vf.read_yuv(0, vf.num_frames + 64, 1, pad=False)[3]
                size = os.path.getsize(path)
                out.append({"codec": kind, "clips": n, "bytes": size, "pictures": pictures,
                            "open_ms": 1e3 * best, "ms_per_mib": 1e3 * best / (size / 2 ** 20),
                            "index_bytes": index, "index_bytes_per_picture": index / pictures})
    return out


def decode_rate(threads=None):
    """Frames/s of the host decode of the corpus as planar YUV, by codec, on
    one thread and on ``threads`` (``bench_video.decode_rate``)."""
    from dali_tpu_torch.tools import bench_video

    out = {}
    for kind in ("xvid", "ffv1"):
        d = os.path.join(MKV_CORPUS, kind)
        out[kind] = bench_video.decode_rate(
            threads=threads, files=[os.path.join(d, f) for f in sorted(os.listdir(d))])
    return out


def check_mixed_vs_cpu():
    from dali_tpu_torch.tools import bench_video

    return bench_video.check_mixed_vs_cpu(root=MKV_CORPUS, form=FORM, stride=STRIDE)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timed", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_mkv: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from dali_tpu_torch.tools import bench_video

    r = {"fixtures": check_fixtures(), "run": run(timed=args.timed), "open_cost": open_cost(),
         "decode": decode_rate(8), "mixed_vs_cpu": check_mixed_vs_cpu(),
         "card": bench_video.card_line()}
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
