"""The C API of dali_tpu_torch: ``dali_tpu.h`` (the surface of dali_tpu's C
API), ``capi.cc`` (CPython embedded), ``build.py`` and the C client
``test_capi.c``. ``load`` binds the built library with ctypes, with every
function's argument and result types declared, for a Python process that
drives it in place (as a timing harness does)."""

from __future__ import annotations

import ctypes

# daliTpuResult
OK, ERROR, INVALID_HANDLE, BUFFER_TOO_SMALL = 0, 1, 2, 3


class TensorInfo(ctypes.Structure):
    """``daliTpuTensorInfo``."""

    _fields_ = [("ndim", ctypes.c_int64), ("shape", ctypes.c_int64 * 16),
                ("dtype", ctypes.c_int32), ("nbytes", ctypes.c_int64)]


def load(path: str) -> ctypes.CDLL:
    """The library at ``path`` (``build.build()``'s result), typed."""
    lib = ctypes.CDLL(path)
    vp, ci, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    ip, info_p = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(TensorInfo)
    sigs = {
        "daliTpuInit": [],
        "daliTpuCreatePipeline": [ctypes.POINTER(vp), ctypes.c_char_p, sz],
        "daliTpuRun": [vp],
        "daliTpuOutputCount": [vp, ip],
        "daliTpuBatchSize": [vp, ip],
        "daliTpuOutputInfo": [vp, ci, ci, info_p],
        "daliTpuCopyOutputSample": [vp, ci, ci, vp, sz],
        "daliTpuOutputSampleData": [vp, ci, ci, ctypes.POINTER(vp), info_p],
        "daliTpuFeedInput": [vp, ctypes.c_char_p, vp, info_p, ci, ctypes.c_char_p],
        "daliTpuCheckpoint": [vp, ctypes.c_char_p, sz, ctypes.POINTER(sz)],
        "daliTpuRestoreCheckpoint": [vp, ctypes.c_char_p, sz],
        "daliTpuReaderSize": [vp, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)],
        "daliTpuDestroyPipeline": [vp],
    }
    for name, args in sigs.items():
        f = getattr(lib, name)
        f.argtypes = args
        f.restype = ci
    lib.daliTpuGetLastError.argtypes = []
    lib.daliTpuGetLastError.restype = ctypes.c_char_p
    return lib
