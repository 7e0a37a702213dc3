"""Data, image and interpolation type enums of the PyTorch port.

Counterpart of ``dali_tpu/types.py``: the enum values are the same, so a
pipeline argument or a serialized checkpoint means the same thing in both
packages. ``to_torch_type`` replaces ``to_jnp_type``.

Host bfloat16: numpy has no bfloat16 (the reference borrows ``ml_dtypes``'
from jax), so a host sample of type ``BFLOAT16`` is a ``torch.bfloat16`` CPU
tensor, and ``to_numpy_type(BFLOAT16)`` is ``torch.bfloat16``. A numpy cast
to it raises ``TypeError``, so an operator that does not convert through
:func:`cast_host` fails loudly instead of computing on bit patterns.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch


class DALIDataType(enum.IntEnum):
    """DALI's data-type enum (values match ``dali_tpu.types.DALIDataType``)."""

    NO_TYPE = -1
    UINT8 = 0
    UINT16 = 1
    UINT32 = 2
    UINT64 = 3
    INT8 = 4
    INT16 = 5
    INT32 = 6
    INT64 = 7
    FLOAT16 = 8
    FLOAT = 9
    FLOAT64 = 10
    BOOL = 11
    STRING = 12
    BFLOAT16 = 13


_TO_NUMPY = {
    DALIDataType.UINT8: np.dtype(np.uint8),
    DALIDataType.UINT16: np.dtype(np.uint16),
    DALIDataType.UINT32: np.dtype(np.uint32),
    DALIDataType.UINT64: np.dtype(np.uint64),
    DALIDataType.INT8: np.dtype(np.int8),
    DALIDataType.INT16: np.dtype(np.int16),
    DALIDataType.INT32: np.dtype(np.int32),
    DALIDataType.INT64: np.dtype(np.int64),
    DALIDataType.FLOAT16: np.dtype(np.float16),
    DALIDataType.FLOAT: np.dtype(np.float32),
    DALIDataType.FLOAT64: np.dtype(np.float64),
    DALIDataType.BOOL: np.dtype(np.bool_),
}

_TO_TORCH = {
    DALIDataType.UINT8: torch.uint8,
    DALIDataType.INT8: torch.int8,
    DALIDataType.INT16: torch.int16,
    DALIDataType.INT32: torch.int32,
    DALIDataType.INT64: torch.int64,
    DALIDataType.FLOAT16: torch.float16,
    DALIDataType.FLOAT: torch.float32,
    DALIDataType.FLOAT64: torch.float64,
    DALIDataType.BOOL: torch.bool,
    DALIDataType.BFLOAT16: torch.bfloat16,
}

_FROM_NUMPY = {v: k for k, v in _TO_NUMPY.items()}

NO_TYPE = DALIDataType.NO_TYPE
UINT8 = DALIDataType.UINT8
UINT16 = DALIDataType.UINT16
UINT32 = DALIDataType.UINT32
UINT64 = DALIDataType.UINT64
INT8 = DALIDataType.INT8
INT16 = DALIDataType.INT16
INT32 = DALIDataType.INT32
INT64 = DALIDataType.INT64
FLOAT16 = DALIDataType.FLOAT16
FLOAT = DALIDataType.FLOAT
FLOAT64 = DALIDataType.FLOAT64
BOOL = DALIDataType.BOOL
STRING = DALIDataType.STRING
# torch.bfloat16 on the card and on the host (to_torch_type, to_numpy_type)
BFLOAT16 = DALIDataType.BFLOAT16

# bfloat16's quiet NaN, as XLA's convert and ml_dtypes write it (torch's own
# float -> bfloat16 writes 0x7FFF); the sign bit is kept: 0xFFC0 as int16
BF16_NAN_BITS, BF16_NEG_NAN_BITS = 0x7FC0, 0xFFC0 - 0x10000


def to_numpy_type(t):
    """The host type of ``t``: a numpy dtype, or ``torch.bfloat16`` for
    ``BFLOAT16`` (the module docstring says why)."""
    if isinstance(t, DALIDataType):
        if t == DALIDataType.BFLOAT16:
            return torch.bfloat16
        return _TO_NUMPY[t]
    if t is torch.bfloat16:
        return t
    return np.dtype(t)


def from_numpy_type(t) -> DALIDataType:
    if t is torch.bfloat16:
        return DALIDataType.BFLOAT16
    return _FROM_NUMPY[np.dtype(t)]


def is_bfloat16(x) -> bool:
    """True for a host or device sample of bfloat16."""
    return torch.is_tensor(x) and x.dtype == torch.bfloat16


def to_bfloat16(x) -> torch.Tensor:
    """Numbers (numpy or torch, on any device) -> ``torch.bfloat16``: through
    float32, rounded to nearest even, a NaN to ``BF16_NAN_BITS`` with its
    sign, so the bits equal XLA's ``astype`` and ml_dtypes'."""
    if not torch.is_tensor(x):
        x = np.asarray(x)  # (np.ascontiguousarray would make a 0-d array 1-d)
    t = x if torch.is_tensor(x) else torch.from_numpy(x if x.flags.c_contiguous else x.copy())
    if t.dtype == torch.bfloat16:
        return t
    f = t.to(torch.float32)
    out = f.to(torch.bfloat16)
    nan = torch.isnan(f)
    bits = torch.where(torch.signbit(f), BF16_NEG_NAN_BITS, BF16_NAN_BITS)
    return torch.where(nan, bits.to(torch.int16), out.view(torch.int16)).view(torch.bfloat16)


def contiguous_host(x):
    """``np.ascontiguousarray`` of a host sample of either kind."""
    return x.contiguous() if torch.is_tensor(x) else np.ascontiguousarray(x)


def cast_host(x, t):
    """A host sample cast to DALI type ``t`` as the reference's numpy
    ``astype`` casts it: a numpy array, or a ``torch.bfloat16`` tensor for
    ``BFLOAT16``. A bfloat16 input converts through float32."""
    want = to_numpy_type(DALIDataType(int(t)))
    if want is torch.bfloat16:
        return to_bfloat16(x)
    if is_bfloat16(x):
        x = x.to(torch.float32).numpy()
    return np.asarray(x).astype(want)


def to_torch_type(t: DALIDataType) -> torch.dtype:
    try:
        return _TO_TORCH[DALIDataType(t)]
    except KeyError:
        raise TypeError(f"No torch dtype for {t!r}") from None


class DALIImageType(enum.IntEnum):
    RGB = 0
    BGR = 1
    GRAY = 2
    YCbCr = 3
    ANY_DATA = 4


RGB = DALIImageType.RGB
BGR = DALIImageType.BGR
GRAY = DALIImageType.GRAY
YCbCr = DALIImageType.YCbCr
ANY_DATA = DALIImageType.ANY_DATA


class DALIInterpType(enum.IntEnum):
    INTERP_NN = 0
    INTERP_LINEAR = 1
    INTERP_CUBIC = 2
    INTERP_LANCZOS3 = 3
    INTERP_TRIANGULAR = 4
    INTERP_GAUSSIAN = 5


INTERP_NN = DALIInterpType.INTERP_NN
INTERP_LINEAR = DALIInterpType.INTERP_LINEAR
INTERP_CUBIC = DALIInterpType.INTERP_CUBIC
INTERP_LANCZOS3 = DALIInterpType.INTERP_LANCZOS3
INTERP_TRIANGULAR = DALIInterpType.INTERP_TRIANGULAR
INTERP_GAUSSIAN = DALIInterpType.INTERP_GAUSSIAN


class PipelineAPIType(enum.Enum):
    BASIC = 0
    ITERATOR = 1
    SCHEDULED = 2


def layout_find_dim(layout: str, dim_name: str) -> int:
    """The index of ``dim_name`` in ``layout``; raises ``ValueError`` when it
    is not there."""
    idx = layout.find(dim_name)
    if idx < 0:
        raise ValueError(f"Dimension '{dim_name}' not found in layout '{layout}'")
    return idx


@dataclass(frozen=True)
class ScalarConstant:
    """A typed scalar usable as an operator argument or in DataNode
    arithmetic (counterpart of ``dali_tpu.types.ScalarConstant``)."""

    value: object
    dtype: DALIDataType = None

    def __post_init__(self):
        if self.dtype is None:
            if isinstance(self.value, bool):
                object.__setattr__(self, "dtype", DALIDataType.BOOL)
            elif isinstance(self.value, int):
                object.__setattr__(self, "dtype", DALIDataType.INT32)
            elif isinstance(self.value, float):
                object.__setattr__(self, "dtype", DALIDataType.FLOAT)
            else:
                raise TypeError(f"Unsupported scalar constant {self.value!r}")


def Constant(value, dtype=None, shape=None, layout=None, device=None, **kwargs):
    """A ``ScalarConstant`` for a scalar without a device, else a ``Constant``
    operator node (counterpart of ``dali_tpu.types.Constant``)."""
    if shape is None and np.isscalar(value) and not isinstance(value, (bytes, str)):
        if dtype is not None and device is None:
            return ScalarConstant(value, dtype if isinstance(dtype, DALIDataType)
                                  else from_numpy_type(dtype))
        if device is None:
            return ScalarConstant(value)
    from . import fn

    arr = np.asarray(value)
    if dtype is not None:
        arr = arr.astype(to_numpy_type(dtype))
    if shape is not None:
        arr = np.broadcast_to(arr, shape).copy()
    flat = arr.reshape(-1)
    is_float = np.issubdtype(arr.dtype, np.floating)
    return fn.constant(
        fdata=[float(v) for v in flat] if is_float else None,
        idata=None if is_float else [int(v) for v in flat],
        shape=list(arr.shape),
        dtype=from_numpy_type(arr.dtype) if arr.dtype in _FROM_NUMPY else None,
        layout=layout or "",
        device=device or "cpu",
        **kwargs,
    )


class SampleInfo:
    """Passed to per-sample ``external_source`` callbacks that take one
    argument (counterpart of ``dali_tpu.types.SampleInfo``)."""

    __slots__ = ("idx_in_epoch", "idx_in_batch", "iteration", "epoch_idx")

    def __init__(self, idx_in_epoch, idx_in_batch, iteration, epoch_idx):
        self.idx_in_epoch = idx_in_epoch
        self.idx_in_batch = idx_in_batch
        self.iteration = iteration
        self.epoch_idx = epoch_idx

    def __repr__(self):
        return (f"SampleInfo(idx_in_epoch={self.idx_in_epoch}, idx_in_batch={self.idx_in_batch},"
                f" iteration={self.iteration}, epoch_idx={self.epoch_idx})")


class BatchInfo:
    """Passed to per-batch ``external_source`` callbacks that take one
    argument (counterpart of ``dali_tpu.types.BatchInfo``)."""

    __slots__ = ("iteration", "epoch_idx")

    def __init__(self, iteration, epoch_idx):
        self.iteration = iteration
        self.epoch_idx = epoch_idx

    def __repr__(self):
        return f"BatchInfo(iteration={self.iteration}, epoch_idx={self.epoch_idx})"
