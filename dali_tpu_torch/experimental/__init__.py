"""Experimental APIs of the port (counterpart of ``dali_tpu.experimental``)."""

from . import dynamic  # noqa: F401
