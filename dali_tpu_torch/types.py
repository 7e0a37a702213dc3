"""Data, image and interpolation type enums of the PyTorch port.

Counterpart of ``dali_tpu/types.py``: the enum values are the same, so a
pipeline argument or a serialized checkpoint means the same thing in both
packages. ``to_torch_type`` replaces ``to_jnp_type``.
"""

from __future__ import annotations

import enum

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

UINT8 = DALIDataType.UINT8
INT16 = DALIDataType.INT16
INT32 = DALIDataType.INT32
INT64 = DALIDataType.INT64
FLOAT16 = DALIDataType.FLOAT16
FLOAT = DALIDataType.FLOAT
FLOAT64 = DALIDataType.FLOAT64
BOOL = DALIDataType.BOOL


def to_numpy_type(t) -> np.dtype:
    if isinstance(t, DALIDataType):
        return _TO_NUMPY[t]
    return np.dtype(t)


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
