"""Host (cpu) placements of the geometry and colour operators (counterparts
of the cpu ops of ``dali_tpu/backend/image.py``, ``warp.py``,
``generic.py``, ``generic2.py``, ``distortion.py`` and ``color.py``): Flip,
WarpAffine, Rotate, Transpose, Pad, Erase, Paste, Brightness, Contrast,
BrightnessContrast, Hue, Saturation, Hsv, ColorTwist and
ColorSpaceConversion.

Each runs per sample in numpy, in the reference's order of operations, so
its output is bit-equal to the reference's. The 2-D warps, where the
reference calls ``cv2.warpAffine``, call the port's own C++
(``native.warp_affine``, ``csrc/host/warp_affine.cc``), equal to cv2 5.0;
DHWC volumes take the numpy trilinear warp (``kernels/warp.py``) and FHWC
sequences warp frame by frame with one matrix per sequence. The warps run
on the pipeline's threads (``SamplePool``). Arguments the reference's cpu
placement never reads raise (``raise_unserved``, ROADMAP.md Queue 3).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import native
from .._schema import register_operator
from ..batch import HostBatch
from ..kernels import warp as warp_kernel
from ..kernels.host_resample import saturate
from ..kernels.pointwise import _rgb_to_yiq, _Y_WEIGHTS, color_space_matrix
from ..types import DALIInterpType, to_numpy_type
from .base import BF16_BITS, BF16_ROUND, Operator, SamplePool, raise_unserved
from .color import _CS_NAMES
from .generic import _transpose_layout
from .warp import invert_affine

# =========================================== geometry ===========================================


@register_operator("Flip", "cpu")
class FlipCPU(Operator):
    """HWC images; 4-D samples (DHWC volumes, FHWC sequences) flip W and H
    of each slice, ``depthwise`` the first axis."""
    reads_bfloat16 = BF16_BITS

    def run_sample(self, ctx, idx, img):
        h = int(np.asarray(ctx.arg(self, "horizontal", idx, 1)))
        v = int(np.asarray(ctx.arg(self, "vertical", idx, 0)))
        d = int(np.asarray(ctx.arg(self, "depthwise", idx, 0)))
        vol = img.ndim >= 4
        out = img
        if h:
            out = out[..., :, ::-1, :] if vol else out[:, ::-1]
        if v:
            out = out[..., ::-1, :, :] if vol else out[::-1]
        if d:
            if not vol:
                raise ValueError("Flip depthwise=1 requires volumetric (DHWC) input")
            out = out[::-1]
        return np.ascontiguousarray(out)


def _warp_2d(img, m, out_h, out_w, interp, fill):
    """One HW(C) image through cv2.warpAffine's arithmetic (host C++)."""
    src = img if img.ndim == 3 else img[:, :, None]
    return native.warp_affine(src, m, out_h, out_w, interp == DALIInterpType.INTERP_NN, fill)


def _warp_volume(img, m, od, oh, ow, interp, fill):
    return saturate(warp_kernel.warp_affine_volumetric_np(img, m, od, oh, ow, interp, fill),
                    img.dtype)


class _HostWarp(SamplePool, Operator):
    """The input's layout tells a sequence (FHWC: per frame) from a volume."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        raise_unserved(spec, ("dtype",))  # the reference's cpu warps keep the input's dtype
        self._in_layout = ""

    def run_batch(self, ctx, *inputs):
        self._in_layout = inputs[0].layout if inputs else ""
        return super().run_batch(ctx, *inputs)

    def _params(self):
        return (DALIInterpType(self.spec.GetArgument("interp_type")),
                float(self.spec.GetArgument("fill_value")))


@register_operator("WarpAffine", "cpu")
class WarpAffineCPU(_HostWarp):
    def _matrix_for(self, ctx, idx, matrix_input, vol=False):
        if matrix_input:
            m = np.asarray(matrix_input[0], np.float32)
        else:
            m = ctx.arg(self, "matrix", idx, None)
            m = (np.eye(3, 4, dtype=np.float32) if vol else np.eye(2, 3, dtype=np.float32)) \
                if m is None else np.asarray(m, np.float32)
        if m.size not in (6, 12):
            raise ValueError(f"warp matrix must have 6 (2x3) or 12 (3x4) values, got {m.size}")
        m = m.reshape(2, 3) if m.size == 6 else m.reshape(3, 4)
        return m if self.spec.GetArgument("inverse_map") else invert_affine(m)

    def run_sample(self, ctx, idx, img, *matrix_input):
        if img.ndim == 4 and self._in_layout.startswith("F"):
            return np.stack([self.run_sample(ctx, idx, fr, *matrix_input) for fr in img])
        size = self.spec.GetArgument("size", None)
        interp, fill = self._params()
        if img.ndim == 4:
            m = self._matrix_for(ctx, idx, matrix_input, vol=True)
            D, H, W = img.shape[:3]
            od, oh, ow = ((int(round(size[0])), int(round(size[1])), int(round(size[2])))
                          if size else (D, H, W))
            return _warp_volume(img, m, od, oh, ow, interp, fill)
        m = self._matrix_for(ctx, idx, matrix_input)
        out_h, out_w = ((int(round(size[0])), int(round(size[1]))) if size
                        else (img.shape[0], img.shape[1]))
        return _warp_2d(img, m, out_h, out_w, interp, fill)


@register_operator("Rotate", "cpu")
class RotateCPU(_HostWarp):
    """About the sample's center; the canvas grows to the rotated extent
    unless ``keep_size`` or ``size``. Volumes rotate about ``axis``."""

    def run_sample(self, ctx, idx, img):
        angle = float(np.asarray(ctx.arg(self, "angle", idx, 0.0)))
        size = self.spec.GetArgument("size", None)
        if img.ndim == 4 and self._in_layout.startswith("F"):
            return np.stack([self.run_sample(ctx, idx, fr) for fr in img])
        interp, fill = self._params()
        if img.ndim == 4:
            d, h, w = img.shape[:3]
            od, oh, ow = ((int(size[0]), int(size[1]), int(size[2])) if size and len(size) == 3
                          else (d, h, w))
            axis = np.asarray(ctx.arg(self, "axis", idx, [0.0, 0.0, 1.0]), np.float64).reshape(-1)
            m = warp_kernel.rotation_matrix_3d(
                angle, axis, ((w - 1) * 0.5, (h - 1) * 0.5, (d - 1) * 0.5),
                ((ow - 1) * 0.5, (oh - 1) * 0.5, (od - 1) * 0.5))
            return _warp_volume(img, m, od, oh, ow, interp, fill)
        h, w = img.shape[:2]
        if size:
            oh, ow = int(size[0]), int(size[1])
        elif self.spec.GetArgument("keep_size"):
            oh, ow = h, w
        else:
            oh, ow = warp_kernel.rotated_canvas_size(h, w, angle)
        m = warp_kernel.rotation_matrix(angle, ((w - 1) * 0.5, (h - 1) * 0.5),
                                        ((ow - 1) * 0.5, (oh - 1) * 0.5))
        return _warp_2d(img, m, oh, ow, interp, fill)


@register_operator("Transpose", "cpu")
class TransposeCPU(Operator):
    def run_sample(self, ctx, idx, x):
        return np.ascontiguousarray(np.transpose(x, self.spec.GetArgument("perm")))

    def output_layout(self, output_idx, inputs):
        return _transpose_layout(self.spec, inputs[0].layout if inputs else "")


@register_operator("Pad", "cpu")
class PadCPU(Operator):
    """Every sample padded at the end of each padded axis to the batch's
    largest extent, raised to ``shape`` and rounded up to ``align``."""
    reads_bfloat16 = BF16_ROUND

    def run_batch(self, ctx, inp: HostBatch):
        spec = self.spec
        shapes = inp.shapes()
        ndim = shapes.shape[1]
        names = spec.GetArgument("axis_names", None)
        if names:
            if not inp.layout:
                raise ValueError("Pad: axis_names requires a layout on the input")
            axes = [inp.layout.index(ch) for ch in names]
        else:
            axes = spec.GetArgument("axes", None)
            axes = list(range(ndim)) if not axes else [a % ndim for a in axes]
        align = spec.GetArgument("align", None)
        req_shape = spec.GetArgument("shape", None)
        target = shapes.max(axis=0)
        if req_shape:
            for k, a in enumerate(axes):
                if k < len(req_shape) and req_shape[k] > 0:
                    target[a] = max(target[a], req_shape[k])
        if align:
            for i, d in enumerate(axes):
                a = align[i] if i < len(align) else align[-1]
                target[d] = ((target[d] + a - 1) // a) * a
        fill = spec.GetArgument("fill_value")
        out = [np.pad(s, [(0, int(target[d]) - s.shape[d] if d in axes else 0)
                          for d in range(ndim)], constant_values=fill).astype(s.dtype)
               for s in inp.samples]
        return [HostBatch(out, layout=inp.layout)]


@register_operator("Erase", "cpu")
class EraseCPU(Operator):
    """Regions (anchor, shape) over ``axes`` (default the first two) take
    ``fill_value``; bounds round half to even and clip to the sample."""
    reads_bfloat16 = BF16_ROUND

    def run_batch(self, ctx, *inputs):
        self._in_layout = inputs[0].layout if inputs else ""
        return super().run_batch(ctx, *inputs)

    def run_sample(self, ctx, idx, img):
        spec = self.spec
        layout = getattr(self, "_in_layout", "")
        axes = spec.GetArgument("axes", None)
        names = spec.GetArgument("axis_names", None)
        if names and not axes:
            if not layout:
                raise ValueError(f"Erase: axis_names={names!r} requires a layout on the input; "
                                 "pass `axes` (by index) instead")
            missing = [c for c in names if c not in layout]
            if missing:
                raise ValueError(f"Erase: axis name(s) {missing} not in input layout {layout!r}")
            axes = [layout.index(c) for c in names]
        if not axes:
            axes = list(range(min(2, img.ndim)))
        nd = len(axes)
        anchor = ctx.arg(self, "anchor", idx, None)
        shape = ctx.arg(self, "shape", idx, None)
        if anchor is None or shape is None:
            return img.copy()
        anchor = np.asarray(anchor, np.float64).reshape(-1, nd)
        shape = np.asarray(shape, np.float64).reshape(-1, nd)
        normalized = spec.GetArgument("normalized")
        dims = np.array([img.shape[a] for a in axes], np.float64)
        if normalized or spec.GetArgument("normalized_anchor"):
            anchor = anchor * dims
        if normalized or spec.GetArgument("normalized_shape"):
            shape = shape * dims
        if spec.GetArgument("centered_anchor"):
            anchor = anchor - shape / 2
        fv = np.asarray(spec.GetArgument("fill_value"), img.dtype)
        out = img.copy()
        for r in range(anchor.shape[0]):
            sl = [slice(None)] * img.ndim
            for k, a in enumerate(axes):
                lo = int(round(anchor[r, k]))
                hi = lo + int(round(shape[r, k]))
                sl[a] = slice(max(lo, 0), max(min(hi, img.shape[a]), 0))
            region = out[tuple(sl)]
            if fv.size == 1:
                region[...] = fv.reshape(-1)[0]
            else:
                region[...] = fv.reshape((1,) * (region.ndim - 1) + (-1,))
        return out


@register_operator("Paste", "cpu")
class PasteCPU(Operator):
    """The HWC sample at (paste_y, paste_x) in a canvas ``ratio`` times its
    size (at least ``min_canvas_size``), ``fill_value`` elsewhere."""

    def run_sample(self, ctx, idx, img):
        r = float(np.asarray(ctx.arg(self, "ratio", idx, 1.0)))
        px = float(np.asarray(ctx.arg(self, "paste_x", idx, 0.5)))
        py = float(np.asarray(ctx.arg(self, "paste_y", idx, 0.5)))
        h, w, c = img.shape
        mins = int(self.spec.GetArgument("min_canvas_size"))
        ch, cw = max(int(round(h * r)), mins, h), max(int(round(w * r)), mins, w)
        nc = int(self.spec.GetArgument("n_channels", None) or c)
        if nc < c:
            raise ValueError(f"Paste n_channels={nc} < input channels {c}")
        canvas = np.empty((ch, cw, nc), img.dtype)
        canvas[...] = np.asarray(self.spec.GetArgument("fill_value"), img.dtype).reshape(1, 1, -1)
        y, x = int(round(py * (ch - h))), int(round(px * (cw - w)))
        canvas[y:y + h, x:x + w, :c] = img
        return canvas


# =========================================== colour =============================================


def _range(dtype) -> float:
    if dtype is torch.bfloat16:
        return 1.0
    return float(np.iinfo(dtype).max) if np.issubdtype(dtype, np.integer) else 1.0


def _apply_matrix(img, mat, offset=None):
    out = np.matmul(img, np.asarray(mat.T, dtype=img.dtype))
    return out if offset is None else out + np.asarray(offset, dtype=img.dtype)


def color_twist_matrix(hue_deg: float, saturation: float, value: float = 1.0) -> np.ndarray:
    """3x3 RGB matrix of a hue rotation, saturation and value scaling, composed
    in YIQ space."""
    h = math.radians(hue_deg)
    c, s = math.cos(h), math.sin(h)
    hue_mat = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    sat_mat = np.diag([value, value * saturation, value * saturation]).astype(np.float32)
    from_yiq = np.linalg.inv(_rgb_to_yiq()).astype(np.float32)
    return (from_yiq @ sat_mat @ hue_mat @ _rgb_to_yiq()).astype(np.float32)


def _out_dtype(spec, in_dtype):
    dt = spec.GetArgument("dtype", None)
    return in_dtype if dt is None else to_numpy_type(dt)


class BrightnessContrastCPU(Operator):
    """out = brightness_shift * R + brightness * (center + contrast * (in -
    center)), R the output type's range, center half the input's."""
    reads_bfloat16 = BF16_ROUND

    def run_sample(self, ctx, idx, img):
        def get(nm, d):
            v = ctx.arg(self, nm, idx, d)
            return d if v is None else float(np.asarray(v).reshape(-1)[0])

        cc = ctx.arg(self, "contrast_center", idx, None)
        cc = 0.5 * _range(img.dtype) if cc is None else float(np.asarray(cc))
        out_dt = _out_dtype(self.spec, img.dtype)
        x = img.astype(np.float32)
        out = get("brightness_shift", 0.0) * _range(out_dt) + get("brightness", 1.0) * (
            cc + get("contrast", 1.0) * (x - cc))
        return saturate(out, out_dt)


for _name in ("BrightnessContrast", "Brightness", "Contrast"):
    register_operator(_name, "cpu")(type(_name + "CPU", (BrightnessContrastCPU,), {}))


class HsvCPU(Operator):
    """Hue rotation, saturation and value through one YIQ matrix."""
    reads_bfloat16 = BF16_ROUND

    def run_sample(self, ctx, idx, img):
        args = self.spec.schema.args
        h, s, v = (float(np.asarray(ctx.arg(self, nm, idx, d))) if nm in args else d
                   for nm, d in (("hue", 0.0), ("saturation", 1.0), ("value", 1.0)))
        out = _apply_matrix(img.astype(np.float32), color_twist_matrix(h, s, v))
        return saturate(out, _out_dtype(self.spec, img.dtype))


for _name in ("Hsv", "Hue", "Saturation"):
    register_operator(_name, "cpu")(type(_name + "CPU", (HsvCPU,), {}))


@register_operator("ColorTwist", "cpu")
class ColorTwistCPU(Operator):
    """The hue/saturation matrix, then brightness * (center + contrast *
    (x - center)) about half the output type's range."""
    reads_bfloat16 = BF16_ROUND

    def run_sample(self, ctx, idx, img):
        def g(nm, d):
            return float(np.asarray(ctx.arg(self, nm, idx, d)))

        out_dt = _out_dtype(self.spec, img.dtype)
        out = _apply_matrix(img.astype(np.float32),
                            color_twist_matrix(g("hue", 0.0), g("saturation", 1.0), 1.0))
        center = 0.5 * _range(out_dt)
        out = g("brightness", 1.0) * (center + g("contrast", 1.0) * (out - center))
        return saturate(out, out_dt)


@register_operator("ColorSpaceConversion", "cpu")
class ColorSpaceConversionCPU(Operator):
    """RGB, BGR, YCbCr (BT.601 studio swing) and GRAY, in the input's dtype."""

    def run_sample(self, ctx, idx, img):
        src = _CS_NAMES[int(self.spec.GetArgument("image_type"))]
        dst = _CS_NAMES[int(self.spec.GetArgument("output_type"))]
        dt = img.dtype
        if dst == "GRAY":
            if src == "BGR":
                img = img[..., ::-1]
            elif src == "YCbCr":  # studio-swing Y -> full-range gray
                return saturate((img[..., 0:1].astype(np.float32) - 16.0) * (255.0 / 219.0), dt)
            return saturate(np.sum(img.astype(np.float32) * _Y_WEIGHTS, axis=-1, keepdims=True),
                             dt)
        if src == "GRAY":
            rep = np.concatenate([img.astype(np.float32)] * 3, axis=-1)
            if dst == "YCbCr":
                return saturate(_apply_matrix(rep, *color_space_matrix("RGB", "YCbCr")), dt)
            return saturate(rep, dt)
        return saturate(_apply_matrix(img.astype(np.float32), *color_space_matrix(src, dst)), dt)
