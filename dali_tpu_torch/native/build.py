"""Build the port's two native libraries from the sources in the checkout.

* ``build/libdali_tpu_torch_host.so`` — the host half of JPEG decode, all
  libjpeg-free C++ in ``csrc/host/``: the entropy decoder (``jpeg_huff.cc``,
  int8 and int16 coefficient stores), the wire packer (``sparse_pack.cc``),
  the task pool (``tasking.cc``), the pixel decoders (``jpeg_decode.cc``,
  ``png_decode.cc``, ``bmp_decode.cc``) and the batch entries
  ``coef_{pack,dense,full}_batch.cc``. g++ with
  ``-march=native``: compiled on the machine that runs it, never shipped.
* ``build/libdali_tpu_torch_kernels.so`` — the CUDA kernels (``csrc/*.cu``),
  nvcc for ``sm_90a``, a plain C interface loaded with ctypes.

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
    "jpeg_huff.cc", "sparse_pack.cc", "tasking.cc", "coef_pack_batch.cc",
    "coef_dense_batch.cc", "coef_full_batch.cc", "jpeg_decode.cc", "png_decode.cc",
    "bmp_decode.cc")]
# headers the host sources include: hashed into the stamp, not compiled
HOST_HEADERS = [os.path.join(_HOST_SRC, "jpeg_full.h")]
KERNEL_SOURCES = [os.path.join(_PKG, "csrc", "cmn.cu")]


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


def _build(name: str, sources: List[str], cmd_prefix: List[str], cmd_suffix: List[str],
           headers: List[str] = ()) -> str:
    out = os.path.join(BUILD_DIR, name)
    stamp_ = stamp(list(sources) + list(headers), cmd_prefix, cmd_suffix)

    def fresh():
        try:
            with open(out + ".stamp") as f:
                return f.read() == stamp_ and os.path.exists(out)
        except OSError:
            return False

    if fresh():
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if fresh():
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        try:
            subprocess.run(cmd_prefix + ["-o", tmp] + sources + cmd_suffix,
                           check=True, capture_output=True, text=True)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"building {name} failed:\n{e.stderr}") from None
        os.replace(tmp, out)
        with open(out + ".stamp.tmp", "w") as f:
            f.write(stamp_)
        os.replace(out + ".stamp.tmp", out + ".stamp")
    return out


def host_library() -> str:
    return _build(
        "libdali_tpu_torch_host.so", HOST_SOURCES,
        ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
         "-Wl,--no-undefined"],
        ["-lpthread"], HOST_HEADERS)


def kernel_library() -> str:
    return _build(
        "libdali_tpu_torch_kernels.so", KERNEL_SOURCES,
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"],
        [])


if __name__ == "__main__":
    which = sys.argv[1:] or ["host", "kernels"]
    for w in which:
        print({"host": host_library, "kernels": kernel_library}[w]())
