"""The standard augmentations (counterpart of
``dali_tpu/auto_aug/augmentations.py``): shear, translate, rotate,
brightness, contrast, color, sharpness, posterize, solarize, solarize_add,
invert, equalize, auto_contrast and identity, with the same magnitude ranges
and PIL-compatible parameter mappings. Each builds the same graph nodes in the
same order as the reference, so implicit-seed random streams (keyed by op
id) draw the same values.

The translates relative to the image shape (``translate_x``/``translate_y``,
``shape=`` in the policies) read it with ``fn.shapes`` and a subscript; on
device data their matrix is built on the device, its constants included
(the reference builds the constants on the host, which a device ``cat``
cannot take)."""

from __future__ import annotations

import numpy as np

from .. import fn, math as dmath, types
from .core import augmentation


def _warp(data, matrix_node_or_list, fill_value=128):
    return fn.warp_affine(data, matrix=matrix_node_or_list, fill_value=fill_value, inverse_map=False)


def _stack_matrix(mxx, mxy, tx, myx, myy, ty):
    """A per-sample flat 2x3 matrix DataNode from scalar DataNodes and
    constants, on the device when any of them is there."""
    from ..data_node import DataNode

    values = (mxx, mxy, tx, myx, myy, ty)
    device = "gpu" if any(isinstance(v, DataNode) and v.device == "gpu" for v in values) else "cpu"
    nodes = []
    for v in values:
        if isinstance(v, DataNode):
            nodes.append(fn.reshape(fn.cast(v, dtype=types.FLOAT), shape=[1]))
        else:
            nodes.append(fn.full(fill_value=[float(v)], shape=[1], dtype=types.FLOAT,
                                 device=device))
    return fn.cat(*nodes, axis=0)


@augmentation(mag_range=(0, 0.3), randomly_negate=True)
def shear_x(data, shear, fill_value=128):
    m = _stack_matrix(1.0, shear, 0.0, 0.0, 1.0, 0.0)
    return _warp(data, m, fill_value)


@augmentation(mag_range=(0, 0.3), randomly_negate=True)
def shear_y(data, shear, fill_value=128):
    m = _stack_matrix(1.0, 0.0, 0.0, shear, 1.0, 0.0)
    return _warp(data, m, fill_value)


@augmentation(mag_range=(0.0, 1.0), randomly_negate=True, name="translate_x")
def translate_x(data, rel_offset, fill_value=128):
    shape = fn.cast(fn.shapes(data), dtype=types.FLOAT)
    m = _stack_matrix(1.0, 0.0, rel_offset * shape[1], 0.0, 1.0, 0.0)
    return _warp(data, m, fill_value)


@augmentation(mag_range=(0, 250), randomly_negate=True, name="translate_x_no_shape")
def translate_x_no_shape(data, offset, fill_value=128):
    m = _stack_matrix(1.0, 0.0, offset, 0.0, 1.0, 0.0)
    return _warp(data, m, fill_value)


@augmentation(mag_range=(0.0, 1.0), randomly_negate=True, name="translate_y")
def translate_y(data, rel_offset, fill_value=128):
    shape = fn.cast(fn.shapes(data), dtype=types.FLOAT)
    m = _stack_matrix(1.0, 0.0, 0.0, 0.0, 1.0, rel_offset * shape[0])
    return _warp(data, m, fill_value)


@augmentation(mag_range=(0, 250), randomly_negate=True, name="translate_y_no_shape")
def translate_y_no_shape(data, offset, fill_value=128):
    m = _stack_matrix(1.0, 0.0, 0.0, 0.0, 1.0, offset)
    return _warp(data, m, fill_value)


@augmentation(mag_range=(0, 30), randomly_negate=True)
def rotate(data, angle, fill_value=128):
    return fn.rotate(data, angle=angle, keep_size=True, fill_value=fill_value)


def _enhance_range(m):
    # PIL enhancement factor: magnitude m in [0, 0.9] -> factor 1 +/- m
    return 1.0 + m


@augmentation(mag_range=(0, 0.9), randomly_negate=True, mag_to_param=_enhance_range)
def brightness(data, factor):
    return fn.brightness(data, brightness=factor)


@augmentation(mag_range=(0, 0.9), randomly_negate=True, mag_to_param=_enhance_range)
def contrast(data, factor):
    """PIL contrast: blend against the image's mean luma."""
    gray = fn.color_space_conversion(data, image_type=types.RGB, output_type=types.GRAY)
    center = fn.reductions.mean(fn.cast(gray, dtype=types.FLOAT))
    return fn.contrast(data, contrast=factor, contrast_center=center)


@augmentation(mag_range=(0, 0.9), randomly_negate=True, mag_to_param=_enhance_range, name="color")
def color(data, factor):
    return fn.saturation(data, saturation=factor)


@augmentation(mag_range=(0, 0.9), randomly_negate=True, mag_to_param=_enhance_range)
def sharpness(data, factor):
    """PIL sharpness: blend(smoothed, img, factor)."""
    blurred = fn.gaussian_blur(data, window_size=[3], sigma=[0.85])
    f = factor
    out = fn.cast(data, dtype=types.FLOAT) * f + fn.cast(blurred, dtype=types.FLOAT) * (1.0 - f)
    return fn.cast(dmath.clamp(out, 0.0, 255.0), dtype=types.UINT8)


def _poster_mask(bits):
    """The uint8 mask keeping ``bits`` high bits (0 counts as 1, so no image
    goes blank)."""
    bits = int(np.round(bits))
    bits = max(1, min(8, bits))
    return 255 & ~((1 << (8 - bits)) - 1) if bits < 8 else 255


@augmentation(mag_range=(0, 4), mag_to_param=lambda m: float(_poster_mask(m)), name="posterize")
def posterize(data, mask):
    from ..data_node import DataNode

    if isinstance(mask, DataNode):
        m = fn.cast(mask, dtype=types.UINT8)
    else:
        m = types.ScalarConstant(int(mask), types.UINT8)
    return data & m


@augmentation(mag_range=(256, 0), name="solarize")
def solarize(data, threshold):
    x = fn.cast(data, dtype=types.FLOAT)
    keep = fn.cast(x < threshold, dtype=types.FLOAT)
    out = keep * x + (1.0 - keep) * (255.0 - x)
    return fn.cast(out, dtype=types.UINT8)


@augmentation(mag_range=(0, 110), name="solarize_add")
def solarize_add(data, addend):
    x = fn.cast(data, dtype=types.FLOAT)
    low = fn.cast(x < 128.0, dtype=types.FLOAT)
    out = dmath.clamp(x + low * addend, 0.0, 255.0)
    return fn.cast(out, dtype=types.UINT8)


@augmentation
def invert(data, _):
    return fn.cast(255.0 - fn.cast(data, dtype=types.FLOAT), dtype=types.UINT8)


@augmentation
def equalize(data, _):
    return fn.experimental.equalize(data)


@augmentation
def auto_contrast(data, _):
    """PIL autocontrast: per-channel min/max stretch."""
    x = fn.cast(data, dtype=types.FLOAT)
    lo = fn.reductions.min(x, axes=[0, 1], keep_dims=True)
    hi = fn.reductions.max(x, axes=[0, 1], keep_dims=True)
    scale = 255.0 / dmath.max(hi - lo, 1.0)
    out = dmath.clamp((x - lo) * scale, 0.0, 255.0)
    return fn.cast(out, dtype=types.UINT8)


@augmentation
def identity(data, _):
    return data
