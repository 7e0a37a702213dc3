"""Build the port's two native libraries from the sources in the checkout.

* ``build/libdali_tpu_torch_host.so`` — the host half of JPEG decode, all
  libjpeg-free C++ in ``csrc/host/``: the entropy decoders (``jpeg_huff.cc``,
  int8 and int16 coefficient stores; ``jpeg_arith.cc``, arithmetic coding), the wire packer (``sparse_pack.cc``),
  the task pool (``tasking.cc``), the pixel decoders (``jpeg_decode.cc``,
  ``png_decode.cc``, ``bmp_decode.cc``) and the batch entries
  ``coef_{pack,dense,full}_batch.cc``, the affine, perspective and remap
  warps (``warp_affine.cc``), the JPEG encoder's front half
  (``jpeg_encode.cc``), the FLAC, GIF, WebP, TIFF and PNM decoders (``flac_decode.cc``,
  ``gif_decode.cc``, ``webp_vp8.cc``, ``webp_vp8l.cc``, ``webp_decode.cc``,
  ``inflate.cc``, ``tiff_decode.cc``, ``pnm_decode.cc``, written from their
  specifications,
  with their batch entry ``image_decode_batch.cc``), the MP3, Vorbis and
  FLAC batch entry (``audio_decode_batch.cc``), the MP4 demuxer and the
  MPEG-4 Part 2 decoder with their frame-accurate reader (``mp4_demux.cc``,
  ``mpeg4_decode.cc``, ``video_decode.cc``), the AVI demuxer and the Motion
  JPEG, HuffYUV and FFV1 decoders (``avi_demux.cc``, ``mjpeg_decode.cc``,
  ``huffyuv_decode.cc``, ``ffv1_decode.cc``), the MPEG-1/2 decoder with
  the MPEG-PS and MPEG-TS demuxers (``mpeg12_decode.cc``,
  ``mpeg_ps_demux.cc``, ``mpeg_ts_demux.cc``), the rebuild of libswscale's
  RGB24 route (``sws_rgb.cc``), the Farneback optical flow
  (``optical_flow.cc``) and the image filters (``host_ops.cc``, compiled into
  an object of its own with floating-point contraction on, as ``dali_tpu``
  compiles its copy). g++ with ``-march=native``: compiled on the machine
  that runs it, never shipped; each source a translation unit, as many at
  once as the machine has cores, then one link.
* ``build/libdali_tpu_torch_kernels.so`` — the CUDA kernels (``csrc/*.cu``),
  nvcc for ``sm_90a``, a plain C interface loaded with ctypes. ``cmn.cu``
  compiles as five translation units started together (``KERNEL_UNITS``:
  one per input type, one for the entry point), then links.

Each library is built at first use. Concurrent builds (pytest-xdist
workers, several pipelines) serialize on a file lock, compile to a private
temporary name and publish with an atomic rename; a stamp file holding the
hash of the sources, the command line and (for ``-march=native``) the CPU's
feature flags makes a stale or foreign library rebuild.

Usage: ``python -m dali_tpu_torch.native.build [host|kernels]``.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import sys
from typing import List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
BUILD_DIR = os.path.join(_ROOT, "build")
_HOST_SRC = os.path.join(_PKG, "csrc", "host")

HOST_SOURCES = [os.path.join(_HOST_SRC, f) for f in (
    "jpeg_huff.cc", "jpeg_arith.cc", "sparse_pack.cc", "tasking.cc", "coef_pack_batch.cc",
    "coef_dense_batch.cc", "coef_full_batch.cc", "jpeg_decode.cc", "png_decode.cc",
    "bmp_decode.cc", "warp_affine.cc", "jpeg_encode.cc", "flac_decode.cc", "gif_decode.cc",
    "webp_vp8.cc", "webp_vp8l.cc", "webp_decode.cc", "inflate.cc", "tiff_decode.cc",
    "pnm_decode.cc", "image_decode_batch.cc", "mp3_decode.cc", "ogg.cc", "vorbis_decode.cc",
    "audio_decode_batch.cc", "mp4_demux.cc", "avi_demux.cc", "mpeg4_decode.cc",
    "mjpeg_decode.cc", "huffyuv_decode.cc", "ffv1_decode.cc", "sws_rgb.cc", "video_decode.cc",
    "optical_flow.cc", "mpeg12_decode.cc", "mpeg_ps_demux.cc", "mpeg_ts_demux.cc",
    "mkv_demux.cc")]
# compiled with dali_tpu's own flags (contraction on): its float filters sum
# into the fused multiply-adds of the reference's library
HOST_CONTRACT_SOURCES = [os.path.join(_HOST_SRC, "host_ops.cc")]
# headers the host sources include: hashed into the stamp, not compiled
HOST_HEADERS = [os.path.join(_HOST_SRC, f) for f in ("jpeg_full.h", "webp.h", "webp_tables.h",
                                                     "inflate.h", "audio_codecs.h",
                                                     "audio_tables.h", "video.h",
                                                     "mpeg4_tables.h", "huffyuv_tables.h",
                                                     "mpeg12_tables.h")]
KERNEL_SOURCES = [os.path.join(_PKG, "csrc", "cmn.cu")]
# (object name, defines, sources) of the kernel library's translation units, compiled
# at once; each holds one input type's template instances of cmn.cu
KERNEL_UNITS = [(f"cmn_in{k}.o", [f"-DCMN_INPUT={k}"], KERNEL_SOURCES) for k in range(4)] + [
    ("cmn_entry.o", ["-DCMN_ENTRY"], KERNEL_SOURCES)]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
                           "kernels of dali_tpu_torch cannot be built on this machine")
    return path


def _cpu_flags() -> str:
    """The CPU feature flags that ``-march=native`` compiles for."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("flags")), platform.machine())
    except OSError:
        return platform.machine()


def stamp(sources: List[str], cmd_prefix: List[str], cmd_suffix: List[str]) -> str:
    """Hash of the command line, the CPU flags under ``-march=native``, and
    each source's path (relative to the package) and bytes: adding, dropping,
    renaming or editing a source changes it."""
    h = hashlib.sha256(" ".join(cmd_prefix + cmd_suffix).encode())
    if "-march=native" in cmd_prefix:
        h.update(_cpu_flags().encode())
    for s in sources:
        h.update(os.path.relpath(s, _PKG).encode() + b"\0")
        with open(s, "rb") as f:
            data = f.read()
        h.update(len(data).to_bytes(8, "little") + data)
    return h.hexdigest()


def _run_all(cmds: List[List[str]], what: str):
    """Runs the commands, as many at once as the machine has cores; raises
    with the first failure's errors."""
    jobs = os.cpu_count() or 1
    for k in range(0, len(cmds), jobs):
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for c in cmds[k: k + jobs]]
        errs = [p.communicate()[1] for p in procs]
        for p, err in zip(procs, errs):
            if p.returncode != 0:
                raise RuntimeError(f"building {what} failed:\n{err}")


def _build(name: str, sources: List[str], cmd_prefix: List[str], cmd_suffix: List[str],
           headers: List[str] = (), build_dir: str = BUILD_DIR, units=None) -> str:
    """``units`` (object name, extra flags, sources): compile each unit with
    ``-c``, as many at once as there are cores, then link the objects (and
    any object in ``cmd_suffix``); without units, one command compiles and
    links."""
    out = os.path.join(build_dir, name)
    unit_flags = [f for unit, flags, _ in units or () for f in [unit] + flags]
    stamp_ = stamp(list(sources) + list(headers), cmd_prefix + unit_flags, cmd_suffix)

    def fresh():
        try:
            with open(out + ".stamp") as f:
                return f.read() == stamp_ and os.path.exists(out)
        except OSError:
            return False

    if fresh():
        return out
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if fresh():
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        if units:
            compile_ = [c for c in cmd_prefix if c != "-shared"]
            objs = [f"{tmp}.{unit}" for unit, _, _ in units]
            try:
                _run_all([compile_ + flags + ["-c", "-o", o] + srcs
                          for (_, flags, srcs), o in zip(units, objs)], name)
                _run_all([cmd_prefix + ["-o", tmp] + objs + cmd_suffix], name)
            finally:
                for o in objs:
                    if os.path.exists(o):
                        os.remove(o)
        else:
            _run_all([cmd_prefix + ["-o", tmp] + sources + cmd_suffix], name)
        os.replace(tmp, out)
        with open(out + ".stamp.tmp", "w") as f:
            f.write(stamp_)
        os.replace(out + ".stamp.tmp", out + ".stamp")
    return out


def host_library() -> str:
    filters = _build("host_ops.o", HOST_CONTRACT_SOURCES,
                     ["g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-c"], [])
    return _build(
        "libdali_tpu_torch_host.so", HOST_SOURCES + [filters],
        ["g++", "-O3", "-march=native", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
         "-Wl,--no-undefined"],
        [filters, "-lpthread"], HOST_HEADERS,
        units=[(os.path.basename(src)[:-3] + ".o", [], [src]) for src in HOST_SOURCES])


def kernel_library() -> str:
    return _build(
        "libdali_tpu_torch_kernels.so", KERNEL_SOURCES,
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"],
        [], units=KERNEL_UNITS)


if __name__ == "__main__":
    which = sys.argv[1:] or ["host", "kernels"]
    for w in which:
        print({"host": host_library, "kernels": kernel_library}[w]())
