"""AutoAugment, RandAugment and TrivialAugment Wide (counterpart of
``dali_tpu/auto_aug``), built on per-sample predicated conditionals."""

from . import augmentations  # noqa: F401
from .auto_augment import apply_auto_augment, auto_augment, auto_augment_image_net, get_image_net_policy, Policy  # noqa: F401
from .core import Augmentation, augmentation  # noqa: F401
from .rand_augment import rand_augment, apply_rand_augment, get_rand_augment_suite  # noqa: F401
from .trivial_augment import trivial_augment_wide, get_trivial_augment_suite  # noqa: F401
