"""WarpAffine and Rotate on the device (counterpart of the gpu ops of
``dali_tpu/backend/warp.py``): HWC images, FHWC sequences (each frame
warped with its sequence's matrix) and DHWC volumes.

The matrices are built on the host (``host_params``): a per-sample
``matrix`` argument, inverted there when ``inverse_map=False``, and Rotate's
rotation about the sample center (about ``axis`` through the center of a
volume). WarpAffine takes the reference's route for each batch of images or
frames: the separable route when every matrix is axis-aligned, the gather
route otherwise (``device_statics``); volumes take the trilinear gather.
Rotate keeps the input size (``keep_size``) or grows the canvas to the
rotated extent, rounded up to 32 and latched; a volume keeps its size. The
host CoordFlip, the ``transforms.*`` matrix generators (numpy on the host, in
float32, composed as the reference composes them) and CoordTransform (cpu
and gpu) of the same reference file are here too.
"""

from __future__ import annotations

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch
from ..kernels import warp as warp_kernel
from ..types import DALIDataType, DALIInterpType, cast_host, to_torch_type
from .base import BF16_WIDEN, Operator


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


def invert_affine(m):
    """The inverse of a [2, 3] (images) or [3, 4] (volumes) affine map."""
    nd = m.shape[0]
    inv = np.linalg.inv(m[:, :nd])
    return np.concatenate([inv, (-inv @ m[:, nd])[:, None]], axis=1).astype(np.float32)


def _is_sequence(ctx, op, shapes) -> bool:
    lay = (ctx.in_layouts(op) or [""])[0]
    return shapes is not None and np.asarray(shapes).shape[1] >= 4 and lay.startswith("F")


def _is_volume(ctx, op, shapes) -> bool:
    return (shapes is not None and np.asarray(shapes).shape[1] >= 4
            and not _is_sequence(ctx, op, shapes))


def _per_frame(t: torch.Tensor, frames: int) -> torch.Tensor:
    return torch.repeat_interleave(t, frames, dim=0)


@register_operator("WarpAffine", "gpu")
class WarpAffineGPU(Operator):
    """HWC images, FHWC sequences (a 2-D warp of each frame, one matrix per
    sequence) and DHWC volumes (a 3x4 matrix, 12 values)."""

    def _matrix_for(self, ctx, idx, vol):
        m = ctx.arg(self, "matrix", idx, None)
        if m is None:
            m = np.eye(3, 4, dtype=np.float32) if vol else np.eye(2, 3, dtype=np.float32)
        m = np.asarray(m, np.float32)
        if m.size not in (6, 12):
            raise ValueError(f"warp matrix must have 6 (2x3) or 12 (3x4) values, got {m.size}")
        m = m.reshape((2, 3) if m.size == 6 else (3, 4))
        return m if self.spec.GetArgument("inverse_map", True) else invert_affine(m)

    def _out_size(self, canvas):
        size = self.spec.GetArgument("size", None)
        return tuple(int(round(v)) for v in size) if size else tuple(canvas)

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        sh = input_shapes[0] if input_shapes else None
        if sh is None:
            return None
        out = np.asarray(sh).copy()
        size = self.spec.GetArgument("size", None)
        if size:  # a sequence's spatial columns start after F
            off = 1 if _is_sequence(ctx, self, sh) and out.shape[1] == len(size) + 2 else 0
            for k, v in enumerate(size):
                out[:, off + k] = int(round(v))
        return [out]

    def host_params(self, ctx, input_shapes):
        if len(input_shapes) > 1:  # the matrices arrive as a device input
            return {}
        vol = _is_volume(ctx, self, input_shapes[0])
        self._mats = np.stack([self._matrix_for(ctx, i, vol) for i in range(ctx.batch_size)])
        return {"matrices": self._mats}

    def device_statics(self, ctx, input_shapes, input_batches):
        # axis-aligned 2-D batches (scale + translate) take the separable route
        if len(input_shapes) > 1 or self._mats.shape[1:] != (2, 3):
            return "gather"
        sep = not self._mats[:, 0, 1].any() and not self._mats[:, 1, 0].any()
        return "separable" if sep else "gather"

    def lower(self, dctx, inp: DeviceBatch, *matrix_input):
        data = inp.data
        n = data.shape[0]
        if matrix_input:
            if not self.spec.GetArgument("inverse_map", True):
                raise NotImplementedError("inverse_map=False with tensor matrices on device")
            mats = matrix_input[0].data.to(torch.float32).reshape(n, -1)
        else:
            mats = dctx.param(self, "matrices").reshape(n, -1)
        dt = self.spec.GetArgument("dtype", None)
        out_dtype = data.dtype if dt is None else to_torch_type(dt)
        interp = DALIInterpType(self.spec.GetArgument("interp_type"))
        fill = float(self.spec.GetArgument("fill_value"))
        if data.dim() == 5 and inp.layout.startswith("F"):
            from .image import _fold_frames

            folded, unfold = _fold_frames(inp)
            mats = _per_frame(mats, data.shape[1])
            data, inp = folded.data, folded
        else:
            unfold = None
        if data.dim() == 5:
            if mats.shape[1] != 12:
                raise ValueError("WarpAffine(gpu): a DHWC volume takes a 3x4 matrix "
                                 f"(12 values), got {mats.shape[1]}")
            od, oh, ow = self._out_size(data.shape[1:4])
            out = warp_kernel.warp_affine_volumetric_batch(
                data, mats.reshape(n, 3, 4), od, oh, ow, inp.shapes, interp, fill, out_dtype)
            return [DeviceBatch(out, None, inp.layout or "DHWC")]
        if mats.shape[1] != 6:
            raise ValueError("WarpAffine(gpu): an image or a sequence's frame takes a 2x3 "
                             f"matrix (6 values), got {mats.shape[1]}")
        out_h, out_w = self._out_size(data.shape[1:3])
        kern = (warp_kernel.warp_affine_separable_batch if dctx.static(self) == "separable"
                else warp_kernel.warp_affine_batch)
        out = DeviceBatch(kern(data, mats.reshape(-1, 2, 3), out_h, out_w, inp.shapes, interp,
                               fill, out_dtype), None, inp.layout or "HWC")
        return [out if unfold is None else unfold(out)]


DALI_SCHEMA("Rotate").DocStr(
    "Rotation about the image center, counter-clockwise in degrees; the canvas "
    "grows to the rotated extent unless `keep_size` or `size`. Sequences rotate "
    "each frame; DHWC volumes rotate about `axis` through their center and keep "
    "their size unless `size` has 3 values."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddArg(
    "angle", ArgType.FLOAT, "Rotation angle (degrees, counter-clockwise).", tensor_ok=True
).AddOptionalArg(
    "axis", ArgType.FLOAT_VEC, "Rotation axis (x, y, z) of volumes.", [0.0, 0.0, 1.0],
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

    def _volume_params(self, ctx, shapes):
        n = ctx.batch_size
        size = self.spec.GetArgument("size", None)
        fixed = tuple(int(v) for v in size) if size and len(size) == 3 else None
        mats = np.zeros((n, 3, 4), np.float32)
        out = shapes.astype(np.int64).copy()
        for i in range(n):
            d, h, w = (int(v) for v in shapes[i][:3])
            od, oh, ow = fixed or (d, h, w)
            out[i, :3] = (od, oh, ow)
            angle = float(np.asarray(ctx.arg(self, "angle", i, 0.0)))
            axis = np.asarray(ctx.arg(self, "axis", i, [0.0, 0.0, 1.0]), np.float64).reshape(-1)
            mats[i] = warp_kernel.rotation_matrix_3d(
                angle, axis, ((w - 1) * 0.5, (h - 1) * 0.5, (d - 1) * 0.5),
                ((ow - 1) * 0.5, (oh - 1) * 0.5, (od - 1) * 0.5))
        self._vol_size = fixed
        self._out_shapes = out
        return {"matrices": mats}

    def host_params(self, ctx, input_shapes):
        shapes = input_shapes[0]
        if shapes is None:
            raise RuntimeError("Rotate(gpu) needs host-known input shapes (its canvas math "
                               "runs on the host); the producing op must implement "
                               "host_output_shapes")
        shapes = np.asarray(shapes)
        self._volume = _is_volume(ctx, self, shapes)
        if self._volume:
            return self._volume_params(ctx, shapes)
        hw0 = 1 if _is_sequence(ctx, self, shapes) else 0  # FHWC shapes: (F, H, W, C)
        n = ctx.batch_size
        mats = np.zeros((n, 2, 3), np.float32)
        sizes = np.zeros((n, 2), np.int32)
        for i in range(n):
            h, w = int(shapes[i][hw0]), int(shapes[i][hw0 + 1])
            angle = float(np.asarray(ctx.arg(self, "angle", i, 0.0)))
            oh, ow = self._out_size_for(h, w, angle)
            sizes[i] = (oh, ow)
            mats[i] = warp_kernel.rotation_matrix(
                angle, ((w - 1) * 0.5, (h - 1) * 0.5), ((ow - 1) * 0.5, (oh - 1) * 0.5))
        for d in (0, 1):
            self._grow[d] = max(self._grow[d],
                                int(-(-sizes[:, d].max() // _GROW_ALIGN) * _GROW_ALIGN))
        self._sizes = sizes
        out = shapes.astype(np.int64).copy()
        out[:, hw0:hw0 + 2] = sizes
        self._out_shapes = out
        return {"matrices": mats, "out_sizes": sizes}

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        return [self._out_shapes]

    def device_statics(self, ctx, input_shapes, input_batches):
        # a volume keeps its canvas (or takes `size`); a batch of one 2-D
        # output size runs at that size; a mixed batch on the grown canvas,
        # with per-sample extents
        if self._volume:
            return ("v",) + (self._vol_size or ())
        if (self._sizes == self._sizes[0]).all():
            return ("u", int(self._sizes[0, 0]), int(self._sizes[0, 1]))
        return ("r", self._grow[0], self._grow[1])

    def lower(self, dctx, inp: DeviceBatch):
        st = dctx.static(self)
        dt = self.spec.GetArgument("dtype", None)
        out_dtype = inp.data.dtype if dt is None else to_torch_type(dt)
        interp = DALIInterpType(self.spec.GetArgument("interp_type"))
        fill = float(self.spec.GetArgument("fill_value"))
        mats = dctx.param(self, "matrices")
        if st[0] == "v":
            od, oh, ow = st[1:] or inp.data.shape[1:4]
            out = warp_kernel.warp_affine_volumetric_batch(
                inp.data, mats, od, oh, ow, inp.shapes, interp, fill, out_dtype)
            return [DeviceBatch(out, None, inp.layout or "DHWC")]
        unfold = None
        if inp.data.dim() == 5:  # a sequence: each frame on its own
            from .image import _fold_frames

            frames = inp.data.shape[1]
            inp, unfold = _fold_frames(inp)
            mats = _per_frame(mats, frames)
        kind, out_h, out_w = st
        out = warp_kernel.warp_affine_batch(inp.data, mats, out_h, out_w, inp.shapes, interp,
                                            fill, out_dtype)
        shapes = None
        if kind == "r":
            sizes = dctx.param(self, "out_sizes")
            if unfold is not None:
                sizes = _per_frame(sizes, frames)
            channels = torch.full((sizes.shape[0], 1), inp.data.shape[-1], dtype=torch.int32,
                                  device=sizes.device)
            shapes = torch.cat([sizes, channels], dim=1)
        out = DeviceBatch(out, shapes, inp.layout or "HWC")
        return [out if unfold is None else unfold(out)]


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
    reads_bfloat16 = BF16_WIDEN

    def run_sample(self, ctx, idx, coords):
        out = coords.astype(np.float32).copy()
        layout = self.spec.GetArgument("layout")
        for axis, default in (("x", 1), ("y", 0), ("z", 0)):
            i = layout.find(axis)
            if int(np.asarray(ctx.arg(self, f"flip_{axis}", idx, default))) and i >= 0:
                out[..., i] = 2 * self.spec.GetArgument(f"center_{axis}") - out[..., i]
        return out


# =============================== transforms.* (matrix generators) ===================================


def _transform_schema(name, doc):
    return (DALI_SCHEMA(name).DocStr(doc).NumInput(0, 1).NumOutput(1).Devices("cpu")
            .AddOptionalArg(
                "reverse_order", ArgType.BOOL,
                "With an input transform T: False (default) applies this transform after T "
                "(out = M @ T); True applies it before (out = T @ M).", False))


_transform_schema("transforms.Rotation", "Rotation matrix generator.").AddOptionalArg(
    "angle", ArgType.FLOAT, "Angle (degrees).", 0.0, tensor_ok=True, per_sample=True
).AddOptionalArg("center", ArgType.FLOAT_VEC, "Rotation center (x, y).", None)

_transform_schema("transforms.Scale", "Scaling matrix generator.").AddOptionalArg(
    "scale", ArgType.FLOAT_VEC, "Scale factors.", None, tensor_ok=True, per_sample=True
).AddOptionalArg("center", ArgType.FLOAT_VEC, "Scaling center.", None).AddOptionalArg(
    "ndim", ArgType.INT, "Number of dims when a scalar `scale` should expand.", None)

_transform_schema("transforms.Translation", "Translation matrix generator.").AddOptionalArg(
    "offset", ArgType.FLOAT_VEC, "Translation offset.", None, tensor_ok=True, per_sample=True)

_transform_schema("transforms.Shear", "Shear matrix generator.").AddOptionalArg(
    "shear", ArgType.FLOAT_VEC, "Shear factors (xy, yx).", None, tensor_ok=True,
    per_sample=True
).AddOptionalArg(
    "angles", ArgType.FLOAT_VEC, "Shear angles (degrees).", None, tensor_ok=True,
    per_sample=True
).AddOptionalArg("center", ArgType.FLOAT_VEC, "Shear center.", None)

_transform_schema("transforms.Crop", "Crop-window transform generator.").AddOptionalArg(
    "from_start", ArgType.FLOAT_VEC, "Source window start.", None, tensor_ok=True,
    per_sample=True
).AddOptionalArg(
    "from_end", ArgType.FLOAT_VEC, "Source window end.", None, tensor_ok=True, per_sample=True
).AddOptionalArg(
    "to_start", ArgType.FLOAT_VEC, "Destination window start.", None
).AddOptionalArg("to_end", ArgType.FLOAT_VEC, "Destination window end.", None).AddOptionalArg(
    "absolute", ArgType.BOOL, "Treat coords as absolute.", False)

DALI_SCHEMA("transforms.Combine").DocStr(
    "Combines transform matrices, the first applied first."
).NumInput(1, 8).NumOutput(1).Devices("cpu").AddOptionalArg(
    "reverse_order", ArgType.BOOL, "Apply inputs right-to-left.", False)


class _TransformBase(Operator):
    """One [2, 3] (x, y) affine matrix per sample, in float32, composed with
    an input transform as the reference composes them."""

    def _compose(self, m_new, m_in):
        """``m_new`` applied after ``m_in``."""
        if m_in is None:
            return m_new
        a = m_new[:, :2] @ m_in[:, :2]
        t = m_new[:, :2] @ m_in[:, 2] + m_new[:, 2]
        return np.concatenate([a, t[:, None]], axis=1).astype(np.float32)

    def run_sample(self, ctx, idx, *inputs):
        m_in = np.asarray(inputs[0], np.float32) if inputs else None
        m = self._matrix(ctx, idx)
        if self.spec.GetArgument("reverse_order", False) and m_in is not None:
            return self._compose(m_in, m)
        return self._compose(m, m_in)

    def output_layout(self, output_idx, inputs):
        return ""

    def _center(self):
        return np.asarray(self.spec.GetArgument("center", None) or [0.0, 0.0], np.float32)


def _about(m, center):
    """The linear part ``m`` about ``center``: [m | center - m @ center]."""
    t = center - m @ center
    return np.concatenate([m, t[:, None]], axis=1).astype(np.float32)


def _vec(ctx, op, name, idx, default):
    return np.asarray(ctx.arg(op, name, idx, default), np.float32).reshape(-1)


@register_operator("transforms.Rotation", "cpu")
class TRotation(_TransformBase):
    def _matrix(self, ctx, idx):
        a = np.deg2rad(float(np.asarray(ctx.arg(self, "angle", idx, 0.0))))
        c, s = np.cos(a), np.sin(a)
        return _about(np.array([[c, -s], [s, c]], np.float32), self._center())


@register_operator("transforms.Scale", "cpu")
class TScale(_TransformBase):
    def _matrix(self, ctx, idx):
        scale = _vec(ctx, self, "scale", idx, [1.0, 1.0])
        ndim = self.spec.GetArgument("ndim", None)
        if ndim and scale.size == 1:
            scale = np.repeat(scale, int(ndim))
        return _about(np.diag(scale[:2]).astype(np.float32), self._center())


@register_operator("transforms.Translation", "cpu")
class TTranslation(_TransformBase):
    def _matrix(self, ctx, idx):
        off = _vec(ctx, self, "offset", idx, [0.0, 0.0])
        return np.array([[1, 0, off[0]], [0, 1, off[1]]], np.float32)


@register_operator("transforms.Shear", "cpu")
class TShear(_TransformBase):
    def _matrix(self, ctx, idx):
        angles = ctx.arg(self, "angles", idx, None)
        if angles is not None:
            shear = np.tan(np.deg2rad(np.asarray(angles, np.float32).reshape(-1)))
        else:
            shear = _vec(ctx, self, "shear", idx, [0.0, 0.0])
        m = np.array([[1, shear[0]], [shear[1] if shear.size > 1 else 0.0, 1]], np.float32)
        return _about(m, self._center())


@register_operator("transforms.Crop", "cpu")
class TCrop(_TransformBase):
    def _matrix(self, ctx, idx):
        fs = _vec(ctx, self, "from_start", idx, [0.0, 0.0])
        fe = _vec(ctx, self, "from_end", idx, [1.0, 1.0])
        ts = np.asarray(self.spec.GetArgument("to_start", None) or [0.0, 0.0], np.float32)
        te = np.asarray(self.spec.GetArgument("to_end", None) or [1.0, 1.0], np.float32)
        if self.spec.GetArgument("absolute", False):
            # start and end swap where start > end
            fs, fe = np.minimum(fs, fe), np.maximum(fs, fe)
            ts, te = np.minimum(ts, te), np.maximum(ts, te)
        m = np.diag(((te - ts) / np.where(fe - fs == 0, 1, fe - fs))[:2]).astype(np.float32)
        t = ts[:2] - m @ fs[:2]
        return np.concatenate([m, t[:, None]], axis=1).astype(np.float32)


@register_operator("transforms.Combine", "cpu")
class TCombine(_TransformBase):
    reads_bfloat16 = BF16_WIDEN

    def run_sample(self, ctx, idx, *inputs):
        mats = [np.asarray(m, np.float32) for m in inputs]
        if self.spec.GetArgument("reverse_order", False):
            mats = mats[::-1]
        out = None
        for m in mats:
            out = self._compose(m, out)
        return out


# ====================================== CoordTransform ================================================

DALI_SCHEMA("CoordTransform").DocStr(
    "Applies an affine transform to point coordinates: out = M @ p + T over the last axis."
).NumInput(1, 2).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "M", ArgType.FLOAT_VEC, "Row-major matrix.", None, tensor_ok=True, per_sample=True
).AddOptionalArg(
    "T", ArgType.FLOAT_VEC, "Translation.", None, tensor_ok=True, per_sample=True
).AddOptionalArg("dtype", ArgType.DATA_TYPE, "Output dtype.", DALIDataType.FLOAT)


@register_operator("CoordTransform", "cpu")
class CoordTransform(Operator):
    """A positional matrix input of D + 1 columns carries T as its last
    column; ``M`` has D columns (its rows are the output's dims)."""
    reads_bfloat16 = BF16_WIDEN

    def run_sample(self, ctx, idx, coords, *mt):
        pts = coords.astype(np.float32)
        d = pts.shape[-1]
        if mt:
            m = np.asarray(mt[0], np.float32)
            if m.shape[-1] == d + 1:
                mat, t = m[:, :d], m[:, d]
            else:
                mat, t = m.reshape(d, d), np.zeros(d, np.float32)
        else:
            M = ctx.arg(self, "M", idx, None)
            mat = (np.asarray(M, np.float32).reshape(-1, d) if M is not None
                   else np.eye(d, dtype=np.float32))
            if mat.shape[-1] == d + 1:
                mat, t0 = mat[:, :d], mat[:, d]
            else:
                t0 = np.zeros(mat.shape[0], np.float32)
            T = ctx.arg(self, "T", idx, None)
            t = np.asarray(T, np.float32).reshape(-1) if T is not None else t0
        out = pts @ mat.T + t
        return cast_host(out, self.spec.GetArgument("dtype", DALIDataType.FLOAT))


@register_operator("CoordTransform", "gpu")
class CoordTransformGPU(Operator):
    """Points [N, ..., D] on the padded canvas, out = pts @ M^T + T as one
    batched product; the matrix comes from the ``M``/``T`` arguments
    (constants or per-sample tensors), a positional matrix input is
    cpu-only."""

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        sh = input_shapes[0] if input_shapes else None
        if sh is None:
            return None
        sh = np.asarray(sh)
        if "M" in self.spec.arg_inputs:
            # a per-sample M may change the coordinate dim: the device
            # shapes carry it
            return None
        M = self.spec.GetArgument("M", None)
        if M is None:
            return [sh]
        out = sh.copy()
        out[:, -1] = len(np.asarray(M).reshape(-1)) // int(sh[0, -1])
        return [out]

    def lower(self, dctx, coords: DeviceBatch, *mt):
        if mt:
            raise ValueError("CoordTransform(gpu): pass the matrix via the M/T keyword arguments "
                             "(a positional matrix input is cpu-only)")
        pts = coords.data.to(torch.float32)
        n, d, mid = pts.shape[0], pts.shape[-1], pts.shape[1:-1]
        dev = pts.device

        def arg(name):
            v = dctx.arg(self, name, None)
            if v is None:
                return None
            if dctx.has_tensor_arg(self, name):
                return v.to(device=dev, dtype=torch.float32).reshape(n, -1)
            return torch.tensor(v, dtype=torch.float32, device=dev).reshape(1, -1)

        m, t = arg("M"), arg("T")
        if m is not None:
            out_dim = m.shape[1] // d
            mat = m.reshape(-1, out_dim, d)
        else:
            out_dim = d
            mat = torch.eye(d, dtype=torch.float32, device=dev)[None]
        if t is None:
            t = torch.zeros((1, out_dim), dtype=torch.float32, device=dev)
        out = torch.einsum("npd,nkd->npk", pts.reshape(n, -1, d), mat.expand(n, -1, -1))
        out = (out + t.expand(n, -1)[:, None, :]).reshape(n, *mid, out_dim)
        shapes = coords.shapes
        if shapes is not None and out_dim != d:  # a dim-raising or -lowering M
            shapes = torch.cat([shapes[:, :-1], torch.full_like(shapes[:, :1], out_dim)], dim=1)
        dt = to_torch_type(self.spec.GetArgument("dtype", DALIDataType.FLOAT))
        return [DeviceBatch(out.to(dt), shapes, coords.layout)]
