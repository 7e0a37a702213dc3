"""AutoAugment policies (counterpart of ``dali_tpu/auto_aug/auto_augment.py``).

The sub-policy branching lowers to predicated evaluation (``_conditionals``):
every augmentation runs on the whole batch and a per-sample merge selects the
active one.
"""

from __future__ import annotations

from .. import fn, types
from . import augmentations as a
from .core import select


class Policy:
    """A named set of sub-policies, each a list of (augmentation, probability,
    magnitude_bin)."""

    def __init__(self, name: str, num_magnitude_bins: int, sub_policies):
        self.name = name
        self.num_magnitude_bins = num_magnitude_bins
        self.sub_policies = [list(sp) for sp in sub_policies]

    @property
    def augmentations(self):
        out = {}
        for sp in self.sub_policies:
            for aug, _, _ in sp:
                out[aug.name] = aug
        return out

    def __repr__(self):
        return f"<Policy {self.name}: {len(self.sub_policies)} sub-policies>"


def get_image_net_policy(use_shape: bool = False, max_translate_abs=None, max_translate_rel=None) -> Policy:
    """The AutoAugment ImageNet policy."""
    translate_y = _translate_y(use_shape, max_translate_abs, max_translate_rel)
    shear_x = a.shear_x.augmentation(mag_range=(0, 0.3))
    shear_y = a.shear_y.augmentation(mag_range=(0, 0.3))
    sub_policies = [
        [(a.equalize, 0.8, 1), (shear_y, 0.8, 4)],
        [(a.color, 0.4, 9), (a.equalize, 0.6, 3)],
        [(a.color, 0.4, 1), (a.rotate, 0.6, 8)],
        [(a.solarize, 0.8, 3), (a.equalize, 0.4, 7)],
        [(a.solarize, 0.4, 2), (a.solarize, 0.6, 2)],
        [(a.color, 0.2, 0), (a.equalize, 0.8, 8)],
        [(a.equalize, 0.4, 8), (a.solarize_add, 0.8, 3)],
        [(shear_x, 0.2, 9), (a.rotate, 0.6, 8)],
        [(a.color, 0.6, 1), (a.equalize, 1.0, 2)],
        [(a.invert, 0.4, 9), (a.rotate, 0.6, 0)],
        [(a.equalize, 1.0, 9), (shear_y, 0.6, 3)],
        [(a.color, 0.4, 7), (a.equalize, 0.6, 0)],
        [(a.posterize, 0.4, 6), (a.auto_contrast, 0.4, 7)],
        [(a.solarize, 0.6, 8), (a.color, 0.6, 9)],
        [(a.solarize, 0.2, 4), (a.rotate, 0.8, 9)],
        [(a.rotate, 1.0, 7), (translate_y, 0.8, 9)],
        [(a.shear_x, 0.0, 0), (a.solarize, 0.8, 4)],
        [(shear_y, 0.8, 0), (a.color, 0.6, 4)],
        [(a.color, 1.0, 0), (a.rotate, 0.6, 2)],
        [(a.equalize, 0.8, 4), (a.equalize, 0.0, 8)],
        [(a.equalize, 1.0, 4), (a.auto_contrast, 0.6, 2)],
        [(shear_y, 0.4, 7), (a.solarize_add, 0.6, 7)],
        [(a.posterize, 0.8, 2), (a.solarize, 0.6, 10 - 1)],
        [(a.solarize, 0.6, 8), (a.equalize, 0.6, 1)],
        [(a.color, 0.8, 6), (a.rotate, 0.4, 5)],
    ]
    return Policy("ImageNetPolicy", 11, sub_policies)


def _translate_y(use_shape, max_abs, max_rel):
    if use_shape:
        return a.translate_y.augmentation(mag_range=(0, max_rel or 0.45))
    return a.translate_y_no_shape.augmentation(mag_range=(0, max_abs or 250))


def apply_auto_augment(policy: Policy, data, seed=None, **kwargs):
    """Applies a random sub-policy per sample."""
    n_sub = len(policy.sub_policies)
    idx = fn.cast(
        fn.random.uniform(
            values=[float(i) for i in range(n_sub)], seed=-1 if seed is None else seed
        ),
        dtype=types.INT32,
    )
    for k, sub in enumerate(policy.sub_policies):
        selected = idx == k

        def apply_sub(d, sub=sub):
            for aug, prob, bin_idx in sub:
                if prob >= 1.0:
                    d = aug(d, magnitude_bin=bin_idx, num_magnitude_bins=policy.num_magnitude_bins, **kwargs)
                elif prob > 0.0:
                    do = fn.random.coin_flip(probability=prob, dtype=types.BOOL)
                    d = select(
                        do,
                        lambda v, aug=aug, bin_idx=bin_idx: aug(
                            v, magnitude_bin=bin_idx, num_magnitude_bins=policy.num_magnitude_bins, **kwargs
                        ),
                        d,
                    )
            return d

        data = select(selected, apply_sub, data)
    return data


def get_reduced_cifar10_policy() -> Policy:
    """The reduced CIFAR-10 policy."""
    sub_policies = [
        [(a.invert, 0.1, 7), (a.contrast, 0.2, 6)],
        [(a.rotate, 0.7, 2), (a.translate_x_no_shape, 0.3, 9)],
        [(a.sharpness, 0.8, 1), (a.sharpness, 0.9, 3)],
        [(a.shear_y, 0.5, 8), (a.translate_y_no_shape, 0.7, 9)],
        [(a.auto_contrast, 0.5, 8), (a.equalize, 0.9, 2)],
        [(a.shear_y, 0.2, 7), (a.posterize, 0.3, 3)],
        [(a.color, 0.4, 3), (a.brightness, 0.6, 7)],
        [(a.sharpness, 0.3, 9), (a.brightness, 0.7, 9)],
        [(a.equalize, 0.6, 5), (a.equalize, 0.5, 1)],
        [(a.contrast, 0.6, 7), (a.sharpness, 0.6, 5)],
        [(a.color, 0.7, 7), (a.translate_x_no_shape, 0.5, 8)],
        [(a.equalize, 0.3, 7), (a.auto_contrast, 0.4, 8)],
        [(a.translate_y_no_shape, 0.4, 3), (a.sharpness, 0.2, 6)],
        [(a.brightness, 0.9, 6), (a.color, 0.2, 8)],
        [(a.solarize, 0.5, 2), (a.invert, 0.0, 3)],
        [(a.equalize, 0.2, 0), (a.auto_contrast, 0.6, 0)],
        [(a.equalize, 0.2, 8), (a.equalize, 0.6, 4)],
        [(a.color, 0.9, 9), (a.equalize, 0.6, 6)],
        [(a.auto_contrast, 0.8, 4), (a.solarize, 0.2, 8)],
        [(a.brightness, 0.1, 3), (a.color, 0.7, 0)],
        [(a.solarize, 0.4, 5), (a.auto_contrast, 0.9, 3)],
        [(a.translate_y_no_shape, 0.9, 9), (a.translate_y_no_shape, 0.7, 9)],
        [(a.auto_contrast, 0.9, 2), (a.solarize, 0.8, 3)],
        [(a.equalize, 0.8, 8), (a.invert, 0.1, 3)],
        [(a.translate_y_no_shape, 0.7, 9), (a.auto_contrast, 0.9, 1)],
    ]
    return Policy("ReducedCifar10Policy", 11, sub_policies)


def get_svhn_policy() -> Policy:
    """The SVHN policy."""
    sub_policies = [
        [(a.shear_x, 0.9, 4), (a.invert, 0.2, 3)],
        [(a.shear_y, 0.9, 8), (a.invert, 0.7, 5)],
        [(a.equalize, 0.6, 5), (a.solarize, 0.6, 6)],
        [(a.invert, 0.9, 3), (a.equalize, 0.6, 3)],
        [(a.equalize, 0.6, 1), (a.rotate, 0.9, 3)],
        [(a.shear_x, 0.9, 4), (a.auto_contrast, 0.8, 3)],
        [(a.shear_y, 0.9, 8), (a.invert, 0.4, 5)],
        [(a.shear_y, 0.9, 5), (a.solarize, 0.2, 6)],
        [(a.invert, 0.9, 6), (a.auto_contrast, 0.8, 1)],
        [(a.equalize, 0.6, 3), (a.rotate, 0.9, 3)],
        [(a.shear_x, 0.9, 4), (a.solarize, 0.3, 3)],
        [(a.shear_y, 0.8, 8), (a.invert, 0.7, 4)],
        [(a.equalize, 0.9, 5), (a.translate_y_no_shape, 0.6, 6)],
        [(a.invert, 0.9, 4), (a.equalize, 0.6, 7)],
        [(a.contrast, 0.3, 3), (a.rotate, 0.8, 4)],
        [(a.invert, 0.8, 5), (a.translate_y_no_shape, 0.0, 2)],
        [(a.shear_y, 0.7, 6), (a.solarize, 0.4, 8)],
        [(a.invert, 0.6, 4), (a.rotate, 0.8, 4)],
        [(a.shear_y, 0.3, 7), (a.translate_x_no_shape, 0.9, 3)],
        [(a.shear_x, 0.1, 6), (a.invert, 0.6, 5)],
        [(a.solarize, 0.7, 2), (a.translate_y_no_shape, 0.6, 7)],
        [(a.shear_y, 0.8, 4), (a.invert, 0.8, 8)],
        [(a.shear_x, 0.7, 9), (a.translate_y_no_shape, 0.8, 3)],
        [(a.shear_y, 0.8, 5), (a.auto_contrast, 0.7, 3)],
        [(a.shear_x, 0.7, 2), (a.invert, 0.1, 5)],
    ]
    return Policy("SVHNPolicy", 11, sub_policies)


def auto_augment(data, policy_name: str = "image_net", shape=None, fill_value=128, seed=None, **kwargs):
    """One-call AutoAugment."""
    if shape is not None:
        raise a._use_shape_not_ported()
    if policy_name in ("image_net", "image_net_policy"):
        policy = get_image_net_policy(use_shape=False)
    elif policy_name in ("reduced_cifar10", "cifar10"):
        policy = get_reduced_cifar10_policy()
    elif policy_name == "svhn":
        policy = get_svhn_policy()
    else:
        raise ValueError(f"Unknown policy '{policy_name}'")
    return apply_auto_augment(policy, data, seed=seed, fill_value=fill_value, **kwargs)


def auto_augment_image_net(data, **kwargs):
    return auto_augment(data, "image_net", **kwargs)
