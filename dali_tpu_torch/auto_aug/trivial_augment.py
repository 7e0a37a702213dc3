"""TrivialAugment Wide (counterpart of ``dali_tpu/auto_aug/trivial_augment.py``):
one uniformly chosen augmentation with a uniformly chosen magnitude bin per
sample."""

from __future__ import annotations

from .. import fn, types
from . import augmentations as a
from .core import select


def get_trivial_augment_suite(use_shape: bool = False):
    translate_x = (
        a.translate_x.augmentation(mag_range=(0, 1.0))
        if use_shape
        else a.translate_x_no_shape.augmentation(mag_range=(0, 32))
    )
    translate_y = (
        a.translate_y.augmentation(mag_range=(0, 1.0))
        if use_shape
        else a.translate_y_no_shape.augmentation(mag_range=(0, 32))
    )
    return [
        a.identity,
        a.auto_contrast,
        a.equalize,
        a.rotate.augmentation(mag_range=(0, 135)),
        a.posterize.augmentation(mag_range=(8, 2), mag_to_param=a.posterize.mag_to_param),
        a.solarize,
        a.color.augmentation(mag_range=(0, 0.99)),
        a.contrast.augmentation(mag_range=(0, 0.99)),
        a.brightness.augmentation(mag_range=(0, 0.99)),
        a.sharpness.augmentation(mag_range=(0, 0.99)),
        a.shear_x.augmentation(mag_range=(0, 0.99)),
        a.shear_y.augmentation(mag_range=(0, 0.99)),
        translate_x,
        translate_y,
    ]


def trivial_augment_wide(data, num_magnitude_bins: int = 31, shape=None, fill_value=128,
                         excluded=None, seed=None, **kwargs):
    augs = get_trivial_augment_suite(use_shape=shape is not None)
    if excluded:
        augs = [x for x in augs if x.name not in excluded]
    kwargs.setdefault("fill_value", fill_value)
    idx = fn.cast(
        fn.random.uniform(values=[float(i) for i in range(len(augs))],
                          seed=-1 if seed is None else seed),
        dtype=types.INT32,
    )
    mag_bin = fn.cast(
        fn.random.uniform(values=[float(i) for i in range(num_magnitude_bins)]), dtype=types.INT32
    )
    for k, aug in enumerate(augs):
        data = select(
            idx == k,
            lambda v, aug=aug: aug(v, magnitude_bin=mag_bin, num_magnitude_bins=num_magnitude_bins, **kwargs),
            data,
        )
    return data
