"""Raw-input operators: decoders.Numpy (cpu and mixed), decoders.Inflate and
io.file.Read (counterparts of ``dali_tpu/backend/parity.py``'s
``decoders.Numpy``, ``misc2.py``'s ``decoders.Inflate`` and ``misc.py``'s
``io.file.Read``). The mixed ``decoders.Numpy`` parses on the host and its
batch crosses the host-device boundary like any mixed op's output."""

from __future__ import annotations

import io
import zlib

import numpy as np

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..types import DALIDataType, cast_host, contiguous_host, to_numpy_type
from .base import Operator

DALI_SCHEMA("decoders.Numpy").DocStr(
    "Parses serialized .npy buffers."
).NumInput(1).NumOutput(1).Devices("cpu", "mixed").AddOptionalArg(
    "dtype", ArgType.DATA_TYPE, "Cast the parsed array to this dtype.", None)


@register_operator("decoders.Numpy", "cpu")
@register_operator("decoders.Numpy", "mixed")
class NumpyDecoder(Operator):
    def run_sample(self, ctx, idx, buf):
        arr = np.lib.format.read_array(io.BytesIO(np.ascontiguousarray(buf).tobytes()),
                                       allow_pickle=False)
        dt = self.spec.GetArgument("dtype", None)
        if dt is not None:
            arr = cast_host(arr, dt)
        return contiguous_host(arr)


DALI_SCHEMA("decoders.Inflate").DocStr(
    "Decompresses chunks: zlib, gzip and raw deflate through the standard library, zstd "
    "through the ``zstandard`` package."
).NumInput(1).NumOutput(1).Devices("cpu").AddOptionalArg(
    "algorithm", ArgType.STRING, "'zlib', 'zstd', 'gzip' or 'raw_deflate'.", "zlib"
).AddOptionalArg(
    "dtype", ArgType.DATA_TYPE, "Output dtype.", DALIDataType.UINT8
).AddOptionalArg(
    "shape", ArgType.INT_VEC, "Output shape.", None, tensor_ok=True
)

_WBITS = {"zlib": 15, "gzip": 31, "raw_deflate": -15}


@register_operator("decoders.Inflate", "cpu")
class Inflate(Operator):
    def run_sample(self, ctx, idx, data):
        algo = self.spec.GetArgument("algorithm").lower()
        raw = np.ascontiguousarray(data).tobytes()
        if algo == "zstd":
            import zstandard  # an optional package: raises ImportError where it is missing

            out = zstandard.ZstdDecompressor().decompress(raw)
        elif algo in _WBITS:
            out = zlib.decompress(raw, _WBITS[algo])
        else:
            raise ValueError(f"Unsupported inflate algorithm {algo!r}")
        arr = np.frombuffer(out, to_numpy_type(self.spec.GetArgument("dtype"))).copy()
        shape = ctx.arg(self, "shape", idx, None)
        if shape is not None:
            arr = arr.reshape([int(v) for v in np.asarray(shape).reshape(-1)])
        return arr


DALI_SCHEMA("io.file.Read").DocStr(
    "Reads whole files named by the input (UTF-8 bytes of a path, NUL padding ignored)."
).NumInput(1).NumOutput(1).Devices("cpu").AddOptionalArg(
    "dont_use_mmap", ArgType.BOOL, "Plain reads instead of mmap.", False
)


@register_operator("io.file.Read", "cpu")
class IoFileRead(Operator):
    def run_sample(self, ctx, idx, fname):
        path = np.asarray(fname).tobytes().decode().rstrip("\x00")
        with open(path, "rb") as f:
            return np.frombuffer(f.read(), np.uint8).copy()
