"""Operator implementations of the port; importing registers them."""

from . import base  # noqa: F401
from . import builtin  # noqa: F401
from . import readers  # noqa: F401
from . import readers2  # noqa: F401
from . import random  # noqa: F401
from . import decoders  # noqa: F401
from . import image  # noqa: F401
from . import color  # noqa: F401
from . import warp  # noqa: F401
from . import generic  # noqa: F401
from . import generic2  # noqa: F401
from . import generic_gpu  # noqa: F401
from . import reductions  # noqa: F401
from . import convolution  # noqa: F401
from . import enhance  # noqa: F401
from . import arithm  # noqa: F401
from . import audio  # noqa: F401
from . import bbox  # noqa: F401
from . import bbox_extra  # noqa: F401
from . import tail  # noqa: F401
from . import segmentation  # noqa: F401
