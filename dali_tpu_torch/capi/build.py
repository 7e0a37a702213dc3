"""Build the C API, ``libdali_tpu_torch_c.so``, from ``capi.cc``.

g++ against the running Python's headers (``sysconfig``'s include
directory) and its shared ``libpython`` (``LIBDIR``), into ``build/`` at the
root of the checkout unless another directory is given; at first use, with
the native libraries' lock and stamp (``native/build.py``). The library
starts, where it must start one, an interpreter from the executable that
built it, and puts this checkout first on its ``sys.path``.

Usage: ``python -m dali_tpu_torch.capi.build [build_dir]``; a C client
compiles with ``-I dali_tpu_torch/capi`` and links ``-ldali_tpu_torch_c``.
"""

from __future__ import annotations

import os
import sys
import sysconfig

from ..native import build as _native

HERE = os.path.dirname(os.path.abspath(__file__))
LIBRARY = "libdali_tpu_torch_c.so"


def python_paths():
    """(include directory, library directory, library version) of this
    Python; raises ``RuntimeError`` where ``Python.h`` or a shared libpython
    is missing."""
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION")
    lib = os.path.join(libdir or "", f"libpython{ver}.so")
    missing = [p for p in (os.path.join(inc, "Python.h"), lib) if not os.path.exists(p)]
    if missing:
        raise RuntimeError(f"the C API needs {' and '.join(missing)}, which this Python lacks")
    return inc, libdir, ver


def build(build_dir: str = _native.BUILD_DIR) -> str:
    """The path of the built library (rebuilt when a source, the command or
    the Python changes)."""
    inc, libdir, ver = python_paths()
    return _native._build(
        LIBRARY, [os.path.join(HERE, "capi.cc")],
        ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-Wl,--no-undefined", f"-I{inc}",
         f'-DDALI_TPU_TORCH_PYTHON="{sys.executable}"',
         f'-DDALI_TPU_TORCH_ROOT="{_native._ROOT}"'],
        [f"-L{libdir}", f"-lpython{ver}", f"-Wl,-rpath,{libdir}"],
        [os.path.join(HERE, "dali_tpu.h")], build_dir)


if __name__ == "__main__":
    print(build(*sys.argv[1:]))
