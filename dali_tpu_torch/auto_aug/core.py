"""Augmentation core (counterpart of ``dali_tpu/auto_aug/core.py``): the
``@augmentation`` decorator and ``select``. An augmentation wraps
``op(data, parameter, **kwargs)`` with a magnitude -> parameter mapping over a
discrete scale of magnitude bins, an optional random sign and a name.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from ..data_node import DataNode


class Augmentation:
    def __init__(
        self,
        op: Callable,
        *,
        mag_range: Optional[Tuple[float, float]] = None,
        randomly_negate: bool = False,
        mag_to_param: Optional[Callable] = None,
        param_device: str = "cpu",
        name: Optional[str] = None,
    ):
        self.op = op
        self.mag_range = mag_range
        self.randomly_negate = randomly_negate
        self.mag_to_param = mag_to_param or (lambda m: m)
        self.param_device = param_device
        self.name = name or op.__name__

    def augmentation(self, mag_range=None, randomly_negate=None, mag_to_param=None, name=None):
        """A copy with some settings replaced."""
        return Augmentation(
            self.op,
            mag_range=mag_range if mag_range is not None else self.mag_range,
            randomly_negate=self.randomly_negate if randomly_negate is None else randomly_negate,
            mag_to_param=mag_to_param or self.mag_to_param,
            name=name or self.name,
        )

    def _magnitudes(self, num_bins: int) -> np.ndarray:
        if self.mag_range is None:
            return np.zeros(num_bins, np.float64)
        lo, hi = self.mag_range
        return np.linspace(lo, hi, num_bins, dtype=np.float64)

    def _param_values(self, num_bins: int) -> np.ndarray:
        mags = self._magnitudes(num_bins)
        return np.array([float(self.mag_to_param(m)) for m in mags], np.float64)

    def _param(self, magnitude_bin, num_magnitude_bins: int):
        """Parameter for this application: python float or per-sample DataNode."""
        from .. import fn
        from ..types import INT32

        values = self._param_values(num_magnitude_bins)
        if isinstance(magnitude_bin, DataNode):
            table = values
            if self.randomly_negate:
                # bins [0..n) positive, [n..2n) negated magnitudes
                neg = np.array(
                    [float(self.mag_to_param(-m)) for m in self._magnitudes(num_magnitude_bins)]
                )
                table = np.concatenate([values, neg])
                sign = fn.random.coin_flip(probability=0.5, dtype=INT32)
                magnitude_bin = magnitude_bin + sign * num_magnitude_bins
            return fn.lookup_table(
                fn.cast(magnitude_bin, dtype=INT32),
                keys=list(range(len(table))),
                values=[float(v) for v in table],
            )
        v = float(values[int(magnitude_bin)])
        if self.randomly_negate:
            neg = float(self.mag_to_param(-self._magnitudes(num_magnitude_bins)[int(magnitude_bin)]))
            return fn.random.uniform(values=[v, neg])
        return v

    def __call__(self, data, *, magnitude_bin=None, num_magnitude_bins=31, **kwargs):
        # drop kwargs the wrapped op does not take (fill_value for the
        # pointwise augmentations)
        import inspect

        sig = inspect.signature(self.op)
        if not any(p.kind == inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()):
            kwargs = {k: v for k, v in kwargs.items() if k in sig.parameters}
        if self.mag_range is None:
            return self.op(data, None, **kwargs)
        if magnitude_bin is None:
            magnitude_bin = num_magnitude_bins - 1
        param = self._param(magnitude_bin, num_magnitude_bins)
        return self.op(data, param, **kwargs)

    def __repr__(self):
        return f"<Augmentation {self.name} range={self.mag_range}>"


def augmentation(
    function=None,
    *,
    mag_range=None,
    randomly_negate=False,
    mag_to_param=None,
    param_device="cpu",
    name=None,
):
    """Decorator creating an :class:`Augmentation`."""

    def deco(fn):
        return Augmentation(
            fn,
            mag_range=mag_range,
            randomly_negate=randomly_negate,
            mag_to_param=mag_to_param,
            param_device=param_device,
            name=name,
        )

    if function is not None:
        return deco(function)
    return deco


def select(pred, fn_true, value):
    """``fn_true(value)`` where the per-sample ``pred`` holds, else ``value``:
    the functional form of ``if pred:`` under enable_conditionals."""
    from .._conditionals import if_stmt

    (out,) = if_stmt(pred, lambda v: (fn_true(v),), lambda v: (v,), (value,))
    return out
