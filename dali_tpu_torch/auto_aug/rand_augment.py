"""RandAugment (counterpart of ``dali_tpu/auto_aug/rand_augment.py``): apply
``n`` uniformly chosen augmentations at magnitude ``m``."""

from __future__ import annotations

from .. import fn, types
from . import augmentations as a
from .core import select


def get_rand_augment_suite(use_shape: bool = False, max_translate_abs=None, max_translate_rel=None,
                           monotonic_mag: bool = True):
    """The standard 15-augmentation RandAugment suite. ``monotonic_mag=False``
    selects the paper's original non-monotonic ranges (posterize (8, 4),
    solarize (256, 0))."""
    translate_x = (
        a.translate_x.augmentation(mag_range=(0, max_translate_rel or 0.45))
        if use_shape
        else a.translate_x_no_shape.augmentation(mag_range=(0, max_translate_abs or 100))
    )
    translate_y = (
        a.translate_y.augmentation(mag_range=(0, max_translate_rel or 0.45))
        if use_shape
        else a.translate_y_no_shape.augmentation(mag_range=(0, max_translate_abs or 100))
    )
    return [
        a.auto_contrast,
        a.equalize,
        a.invert,
        a.rotate,
        a.posterize.augmentation(mag_range=(0, 4) if monotonic_mag else (8, 4),
                                 mag_to_param=a.posterize.mag_to_param),
        a.solarize if monotonic_mag else a.solarize.augmentation(mag_range=(256, 0)),
        a.solarize_add,
        a.color,
        a.contrast,
        a.brightness,
        a.sharpness,
        a.shear_x,
        a.shear_y,
        translate_x,
        translate_y,
    ]


def apply_rand_augment(augmentations, data, n: int, m: int, num_magnitude_bins: int = 31, seed=None, **kwargs):
    for _ in range(n):
        idx = fn.cast(
            fn.random.uniform(
                values=[float(i) for i in range(len(augmentations))],
                seed=-1 if seed is None else seed,
            ),
            dtype=types.INT32,
        )
        for k, aug in enumerate(augmentations):
            data = select(
                idx == k,
                lambda v, aug=aug: aug(v, magnitude_bin=m, num_magnitude_bins=num_magnitude_bins, **kwargs),
                data,
            )
    return data


def rand_augment(data, n: int, m: int, num_magnitude_bins: int = 31, shape=None, fill_value=128,
                 monotonic_mag: bool = True, excluded=None, seed=None, **kwargs):
    """RandAugment with the standard suite."""
    augs = get_rand_augment_suite(use_shape=shape is not None, monotonic_mag=monotonic_mag)
    if excluded:
        augs = [x for x in augs if x.name not in excluded]
    return apply_rand_augment(augs, data, n, m, num_magnitude_bins=num_magnitude_bins,
                              seed=seed, fill_value=fill_value, **kwargs)
