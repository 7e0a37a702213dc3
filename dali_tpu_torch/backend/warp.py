"""WarpAffine and Rotate on the device, 2-D HWC (counterpart of the gpu ops of
``dali_tpu/backend/warp.py``).

The matrices are built on the host (``host_params``): a per-sample
``matrix`` argument, inverted there when ``inverse_map=False``, and Rotate's
rotation about the sample center. WarpAffine takes the reference's route for
each batch: the separable route when every matrix is axis-aligned, the gather
route otherwise (``device_statics``). Rotate keeps the input size
(``keep_size``) or grows the canvas to the rotated extent, rounded up to 32
and latched. Sequences and volumes raise ``NotImplementedError``. The
host CoordFlip of the same reference file is here too.
"""

from __future__ import annotations

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch
from ..kernels import warp as warp_kernel
from ..types import DALIInterpType, to_torch_type
from .base import Operator


def _not_ported(what):
    return NotImplementedError(f"{what} is not ported to dali_tpu_torch yet; see ROADMAP.md "
                               "(Queue 1)")


DALI_SCHEMA("WarpAffine").DocStr(
    """Affine warp. ``matrix`` maps destination to source coordinates
    (``inverse_map=True``, the default) as a row-major 2x3 (x, y) matrix."""
).NumInput(1, 2).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "matrix", ArgType.FLOAT_VEC, "Row-major 2x3 transform.", None, tensor_ok=True
).AddOptionalArg(
    "size", ArgType.FLOAT_VEC, "Output size (H, W); default input size.", None
).AddOptionalArg(
    "interp_type", ArgType.INTERP_TYPE, "NN or linear.", DALIInterpType.INTERP_LINEAR
).AddOptionalArg(
    "fill_value", ArgType.FLOAT, "Border fill value.", 0.0
).AddOptionalArg(
    "inverse_map", ArgType.BOOL, "Matrix maps dst->src (True, default) or src->dst.", True
).AddOptionalArg("dtype", ArgType.DATA_TYPE, "Output dtype.", None)


def _invert_affine(m):
    a, t = m[:, :2], m[:, 2]
    ai = np.linalg.inv(a)
    return np.concatenate([ai, (-ai @ t)[:, None]], axis=1).astype(np.float32)


def _require_2d(shapes):
    if shapes is not None and np.asarray(shapes).shape[1] != 3:
        raise _not_ported("warps of sequences and volumes")


@register_operator("WarpAffine", "gpu")
class WarpAffineGPU(Operator):
    def _matrix_for(self, ctx, idx):
        m = ctx.arg(self, "matrix", idx, None)
        m = np.array([[1, 0, 0], [0, 1, 0]], np.float32) if m is None else np.asarray(m, np.float32)
        if m.size != 6:
            raise _not_ported(f"WarpAffine with a {m.size}-value matrix (volumes)")
        m = m.reshape(2, 3)
        return m if self.spec.GetArgument("inverse_map", True) else _invert_affine(m)

    def _out_size(self, h, w):
        size = self.spec.GetArgument("size", None)
        return (int(round(size[0])), int(round(size[1]))) if size else (h, w)

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        sh = input_shapes[0] if input_shapes else None
        if sh is None:
            return None
        _require_2d(sh)
        out = np.asarray(sh).copy()
        size = self.spec.GetArgument("size", None)
        if size:
            out[:, 0], out[:, 1] = int(round(size[0])), int(round(size[1]))
        return [out]

    def host_params(self, ctx, input_shapes):
        _require_2d(input_shapes[0])
        if len(input_shapes) > 1:  # the matrices arrive as a device input
            return {}
        self._mats = np.stack([self._matrix_for(ctx, i) for i in range(ctx.batch_size)])
        return {"matrices": self._mats}

    def device_statics(self, ctx, input_shapes, input_batches):
        # axis-aligned batches (scale + translate) take the separable route
        if len(input_shapes) > 1:
            return "gather"
        sep = not self._mats[:, 0, 1].any() and not self._mats[:, 1, 0].any()
        return "separable" if sep else "gather"

    def lower(self, dctx, inp: DeviceBatch, *matrix_input):
        if inp.data.dim() != 4:
            raise _not_ported("warps of sequences and volumes")
        n, H, W, C = inp.data.shape
        out_h, out_w = self._out_size(H, W)
        if matrix_input:
            if not self.spec.GetArgument("inverse_map", True):
                raise NotImplementedError("inverse_map=False with tensor matrices on device")
            mats = matrix_input[0].data.to(torch.float32).reshape(n, 2, 3)
        else:
            mats = dctx.param(self, "matrices")
        dt = self.spec.GetArgument("dtype", None)
        kern = (warp_kernel.warp_affine_separable_batch if dctx.static(self) == "separable"
                else warp_kernel.warp_affine_batch)
        out = kern(inp.data, mats, out_h, out_w, inp.shapes,
                   DALIInterpType(self.spec.GetArgument("interp_type")),
                   float(self.spec.GetArgument("fill_value")),
                   inp.data.dtype if dt is None else to_torch_type(dt))
        return [DeviceBatch(out, None, inp.layout or "HWC")]


DALI_SCHEMA("Rotate").DocStr(
    "Rotation about the image center, counter-clockwise in degrees; the canvas "
    "grows to the rotated extent unless `keep_size` or `size`."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddArg(
    "angle", ArgType.FLOAT, "Rotation angle (degrees, counter-clockwise).", tensor_ok=True
).AddOptionalArg(
    "axis", ArgType.FLOAT_VEC, "Rotation axis of volumes (not ported).", [0.0, 0.0, 1.0],
    tensor_ok=True
).AddOptionalArg(
    "keep_size", ArgType.BOOL, "Keep the input size instead of growing the canvas.", False
).AddOptionalArg(
    "interp_type", ArgType.INTERP_TYPE, "Interpolation.", DALIInterpType.INTERP_LINEAR
).AddOptionalArg(
    "fill_value", ArgType.FLOAT, "Border fill.", 0.0
).AddOptionalArg("size", ArgType.FLOAT_VEC, "Fixed output size.", None).AddOptionalArg(
    "dtype", ArgType.DATA_TYPE, "Output dtype.", None
)

_GROW_ALIGN = 32


@register_operator("Rotate", "gpu")
class RotateGPU(Operator):
    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._grow = [0, 0]

    def _out_size_for(self, h, w, angle):
        size = self.spec.GetArgument("size", None)
        if size:
            return int(size[0]), int(size[1])
        if self.spec.GetArgument("keep_size", False):
            return h, w
        return warp_kernel.rotated_canvas_size(h, w, angle)

    def host_params(self, ctx, input_shapes):
        shapes = input_shapes[0]
        if shapes is None:
            raise RuntimeError("Rotate(gpu) needs host-known input shapes (its canvas math "
                               "runs on the host); the producing op must implement "
                               "host_output_shapes")
        _require_2d(shapes)
        n = ctx.batch_size
        mats = np.zeros((n, 2, 3), np.float32)
        sizes = np.zeros((n, 2), np.int32)
        for i in range(n):
            h, w = int(shapes[i][0]), int(shapes[i][1])
            angle = float(np.asarray(ctx.arg(self, "angle", i, 0.0)))
            oh, ow = self._out_size_for(h, w, angle)
            sizes[i] = (oh, ow)
            mats[i] = warp_kernel.rotation_matrix(
                angle, ((w - 1) * 0.5, (h - 1) * 0.5), ((ow - 1) * 0.5, (oh - 1) * 0.5))
        for d in (0, 1):
            self._grow[d] = max(self._grow[d],
                                int(-(-sizes[:, d].max() // _GROW_ALIGN) * _GROW_ALIGN))
        self._sizes = sizes
        self._channels = shapes[:, 2].astype(np.int64)
        return {"matrices": mats, "out_sizes": sizes}

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        return [np.concatenate([self._sizes.astype(np.int64), self._channels[:, None]], axis=1)]

    def device_statics(self, ctx, input_shapes, input_batches):
        # a batch of one output size runs at that size; a mixed batch on the
        # grown canvas, with per-sample extents
        if (self._sizes == self._sizes[0]).all():
            return ("u", int(self._sizes[0, 0]), int(self._sizes[0, 1]))
        return ("r", self._grow[0], self._grow[1])

    def lower(self, dctx, inp: DeviceBatch):
        if inp.data.dim() != 4:
            raise _not_ported("Rotate(gpu) of sequences and volumes")
        kind, out_h, out_w = dctx.static(self)
        dt = self.spec.GetArgument("dtype", None)
        out = warp_kernel.warp_affine_batch(
            inp.data, dctx.param(self, "matrices"), out_h, out_w, inp.shapes,
            DALIInterpType(self.spec.GetArgument("interp_type")),
            float(self.spec.GetArgument("fill_value")),
            inp.data.dtype if dt is None else to_torch_type(dt))
        if kind == "u":
            return [DeviceBatch(out, None, inp.layout or "HWC")]
        sizes = dctx.param(self, "out_sizes")
        channels = torch.full((sizes.shape[0], 1), inp.data.shape[3], dtype=torch.int32,
                              device=sizes.device)
        return [DeviceBatch(out, torch.cat([sizes, channels], dim=1), inp.layout or "HWC")]


# ======================================== CoordFlip ==================================================

DALI_SCHEMA("CoordFlip").DocStr(
    "Flips coordinates in [0,1] about a center per axis."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "flip_x", ArgType.INT, "Flip x.", 1, tensor_ok=True
).AddOptionalArg(
    "flip_y", ArgType.INT, "Flip y.", 0, tensor_ok=True
).AddOptionalArg(
    "flip_z", ArgType.INT, "Flip z.", 0, tensor_ok=True
).AddOptionalArg(
    "layout", ArgType.TENSOR_LAYOUT, "Coordinate layout ('x', 'xy', 'xyz').", "xy"
).AddOptionalArg("center_x", ArgType.FLOAT, "Flip center x.", 0.5).AddOptionalArg(
    "center_y", ArgType.FLOAT, "Flip center y.", 0.5).AddOptionalArg(
    "center_z", ArgType.FLOAT, "Flip center z.", 0.5)


@register_operator("CoordFlip", "cpu")
class CoordFlip(Operator):
    """The host CoordFlip (``dali_tpu/backend/warp.py`` ``CoordFlip``); the
    device one is in ``generic_gpu.py``."""

    def run_sample(self, ctx, idx, coords):
        out = coords.astype(np.float32).copy()
        layout = self.spec.GetArgument("layout")
        for axis, default in (("x", 1), ("y", 0), ("z", 0)):
            i = layout.find(axis)
            if int(np.asarray(ctx.arg(self, f"flip_{axis}", idx, default))) and i >= 0:
                out[..., i] = 2 * self.spec.GetArgument(f"center_{axis}") - out[..., i]
        return out
