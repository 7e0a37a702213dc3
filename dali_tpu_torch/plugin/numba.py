"""Numba operators (counterpart of ``dali_tpu/plugin/numba.py``):
``numba_function`` is ``fn.numba_function`` behind a check that numba
imports; without numba it raises ``ImportError``, as the reference's does,
while ``fn.numba_function`` itself runs ``run_fn`` as plain Python."""

from __future__ import annotations

from .. import fn as _fn


def numba_function(*inputs, run_fn, out_types, in_types, outs_ndim=None, ins_ndim=None,
                   setup_fn=None, batch_processing: bool = False, device: str = "cpu", **kwargs):
    """``run_fn(out0, .., in0, ..)`` fills preallocated outputs;
    ``setup_fn(out_shapes, in_shapes)`` (optional) computes the output
    shapes, which otherwise copy the first input's."""
    try:
        import numba  # noqa: F401
    except ImportError as e:
        raise ImportError("dali_tpu_torch.plugin.numba requires numba (pip install numba)") from e
    if not isinstance(out_types, (list, tuple)):
        out_types = [out_types]
    if not isinstance(in_types, (list, tuple)):
        in_types = [in_types]
    return _fn.numba_function(
        *inputs, run_fn=run_fn, setup_fn=setup_fn, out_types=[int(t) for t in out_types],
        in_types=[int(t) for t in in_types], outs_ndim=outs_ndim, ins_ndim=ins_ndim,
        batch_processing=batch_processing, **kwargs)
