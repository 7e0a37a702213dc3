"""Legacy and experimental operator names, where the names not ported yet
stand in ROADMAP.md, experimental.WarpPerspective (cpu and gpu) and
TensorResize's schema and cpu placement (counterpart of
``dali_tpu/backend/parity.py`` ``_LEGACY``, ``register_aliases`` and those
operators). The cpu WarpPerspective, where the reference calls
cv2.warpPerspective, runs the port's C++ (``native.warp_perspective``, equal
to cv2 5.0); the cpu TensorResize zooms with scipy.ndimage, as the
reference does.

An alias shares its target's schema and is registered on each device the
port implements the target on (``CoinFlip`` on the cpu, not on the gpu); a
target implementation registered later is found through
``_schema._alias_targets``.
"""

from __future__ import annotations

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, _alias_targets, _impl_registry, _registry, \
    register_operator
from ..batch import DeviceBatch
from ..kernels import warp as warp_kernel
from .. import native
from ..kernels.host_resample import saturate
from ..types import DALIInterpType, to_numpy_type
from .base import Operator, SamplePool, raise_unserved
from .generic2 import _crop_round

_LEGACY = {
    "Clahe": "experimental.Clahe",
    "Equalize": "experimental.Equalize",
    "Filter": "experimental.Filter",
    "Debayer": "experimental.Debayer",
    "FileReader": "readers.File",
    "COCOReader": "readers.COCO",
    "CaffeReader": "readers.Caffe",
    "Caffe2Reader": "readers.Caffe2",
    "MXNetReader": "readers.MXNet",
    "TFRecordReader": "readers.TFRecord",
    "NumpyReader": "readers.Numpy",
    "SequenceReader": "readers.Sequence",
    "NemoAsrReader": "readers.NemoAsr",
    "VideoReader": "readers.Video",
    "ImageDecoder": "decoders.Image",
    "ImageDecoderCrop": "decoders.ImageCrop",
    "ImageDecoderRandomCrop": "decoders.ImageRandomCrop",
    "ImageDecoderSlice": "decoders.ImageSlice",
    "AudioDecoder": "decoders.Audio",
    "Uniform": "random.Uniform",
    "CoinFlip": "random.CoinFlip",
    "NormalDistribution": "random.Normal",
    "AudioResample": "experimental.AudioResample",
    "experimental.decoders.Image": "decoders.Image",
    "experimental.decoders.ImageCrop": "decoders.ImageCrop",
    "experimental.decoders.ImageRandomCrop": "decoders.ImageRandomCrop",
    "experimental.decoders.ImageSlice": "decoders.ImageSlice",
    "experimental.Inflate": "decoders.Inflate",
    "experimental.readers.Fits": "readers.Fits",
    "experimental.readers.Video": "readers.Video",
    "experimental.PeekImageShape": "PeekImageShape",
    "reductions.RMS": "reductions.RootMeanSquare",
}

# The ROADMAP.md Queue 1 item of each dali_tpu operator the port lacks.
_VIDEO = ("decoders.Video", "experimental.decoders.Video", "experimental.inputs.Video",
          "readers.Video", "readers.VideoResize", "VideoReaderResize", "OpticalFlow")
QUEUE_ITEMS = {n: "item 8" for n in _VIDEO}
QUEUE_ITEMS.update({a: QUEUE_ITEMS[t] for a, t in _LEGACY.items() if t in QUEUE_ITEMS})


# The one deliberate renaming: the reference's gpu _JaxFunction traces a JAX
# function into its device program; the port runs a torch function there
# (fn.torch_function).
RENAMED = {"_JaxFunction": "_TorchFunction"}

# a deprecated name and the experimental names the reference registers
# beside its legacy table (``alias_schema``)
_DEPRECATED = {"TransformTranslation": "transforms.Translation",
               "experimental.TensorResize": "TensorResize", "experimental.Resize": "Resize"}


# ====================================== WarpPerspective ===========================================

DALI_SCHEMA("experimental.WarpPerspective").DocStr(
    """Perspective (homography) warp: a per-pixel homography divide and a
    bilinear or nearest gather. ``matrix`` is the 3x3 destination -> source
    mapping (``inverse_map=False`` inverts it)."""
).NumInput(1, 2).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "matrix", ArgType.FLOAT_VEC, "3x3 homography (row-major).", None, tensor_ok=True,
    per_sample=True
).AddOptionalArg("size", ArgType.FLOAT_VEC, "Output size (H, W).", None).AddOptionalArg(
    "fill_value", ArgType.FLOAT, "Out-of-bounds fill.", 0.0
).AddOptionalArg(
    "interp_type", ArgType.INTERP_TYPE, "NN or linear.", DALIInterpType.INTERP_LINEAR
).AddOptionalArg("inverse_map", ArgType.BOOL, "Matrix maps dst->src (True).", True).AddOptionalArg(
    "border_mode", ArgType.STRING,
    '"constant" (fill_value outside) or "replicate" (clamp to edge).', "constant"
).AddOptionalArg(
    "pixel_origin", ArgType.STRING,
    '"corner" (default; (0,0) = top-left corner of the top-left pixel) or "center" '
    "(OpenCV-style).", "corner")


def _origin_adjust(m: torch.Tensor) -> torch.Tensor:
    """The destination -> source map [N, 3, 3] between pixel corners,
    conjugated to index coordinates: C @ m @ C^-1 with C the shift by -0.5,
    each product summed in ascending order."""
    t = m.clone()
    for j in range(3):  # rows 0 and 1 of C @ m: m[i, j] - 0.5 * m[2, j]
        t[:, 0, j] = m[:, 0, j] + -0.5 * m[:, 2, j]
        t[:, 1, j] = m[:, 1, j] + -0.5 * m[:, 2, j]
    out = t.clone()
    for i in range(3):  # column 2 of (C @ m) @ C^-1: 0.5 t[i, 0] + 0.5 t[i, 1] + t[i, 2]
        out[:, i, 2] = t[:, i, 0] * 0.5 + t[:, i, 1] * 0.5 + t[:, i, 2]
    return out


@register_operator("experimental.WarpPerspective", "gpu")
class WarpPerspectiveGPU(Operator):
    """``kernels/warp.py`` ``warp_perspective_batch`` with each sample's
    matrix (the second input, or the ``matrix`` argument), inverted on the
    device with ``inverse_map=False``. A given ``size`` sets the output; else
    it keeps the input's canvas and per-sample shapes."""

    def lower(self, dctx, inp: DeviceBatch, *mtx_in):
        x = inp.data
        n = x.shape[0]
        if mtx_in:
            m = mtx_in[0].data.reshape(n, 3, 3).to(torch.float32)
        else:
            raw = dctx.arg(self, "matrix")
            if raw is None:
                raise ValueError("experimental.WarpPerspective needs `matrix` or a matrix input")
            m = torch.as_tensor(np.asarray(raw) if not torch.is_tensor(raw) else raw,
                                dtype=torch.float32, device=x.device).reshape(-1, 3, 3)
            m = m.expand(n, 3, 3) if m.shape[0] == 1 else m
        m = m.to(x.device)
        if not self.spec.GetArgument("inverse_map"):
            m = torch.linalg.inv(m)
        if self.spec.GetArgument("pixel_origin") == "corner":
            m = _origin_adjust(m)
        size = self.spec.GetArgument("size", None)
        out_h, out_w = (int(size[0]), int(size[1])) if size else tuple(x.shape[1:3])
        out = warp_kernel.warp_perspective_batch(
            x, m, out_h, out_w, inp.shapes, self.spec.GetArgument("interp_type"),
            float(self.spec.GetArgument("fill_value")), x.dtype,
            replicate=self.spec.GetArgument("border_mode") == "replicate")
        shapes = inp.shapes if inp.shapes is not None and size is None else None
        return [DeviceBatch(out, shapes, inp.layout or "HWC")]


@register_operator("experimental.WarpPerspective", "cpu")
class WarpPerspectiveCPU(SamplePool, Operator):
    """Each HW(C) sample through its matrix (the second input, or the
    ``matrix`` argument; inverted in float32 with ``inverse_map=False``,
    conjugated by the half-pixel shift with ``pixel_origin="corner"``)."""

    def run_sample(self, ctx, idx, img, *mtx_in):
        spec = self.spec
        m = np.asarray(mtx_in[0] if mtx_in else ctx.arg(self, "matrix", idx), np.float32)
        m = m.reshape(3, 3)
        if not spec.GetArgument("inverse_map"):
            m = np.linalg.inv(m).astype(np.float32)
        if spec.GetArgument("pixel_origin") == "corner":
            to_corner = np.asarray([[1, 0, 0.5], [0, 1, 0.5], [0, 0, 1]], m.dtype)
            to_center = np.asarray([[1, 0, -0.5], [0, 1, -0.5], [0, 0, 1]], m.dtype)
            m = to_center @ m @ to_corner
        size = spec.GetArgument("size", None)
        out_h, out_w = (int(size[0]), int(size[1])) if size else img.shape[:2]
        src = img if img.ndim == 3 else img[:, :, None]
        out = native.warp_perspective(
            src, m, out_h, out_w, spec.GetArgument("interp_type") == DALIInterpType.INTERP_NN,
            spec.GetArgument("border_mode") == "replicate", spec.GetArgument("fill_value"))
        return out if img.ndim == 3 else out[:, :, 0]


# ====================================== TensorResize ==============================================

# the gpu placement is in straggler_gpu.py, as in the reference
DALI_SCHEMA("TensorResize").DocStr(
    "Resizes arbitrary-dimensional tensors."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "sizes", ArgType.FLOAT_VEC, "Output sizes per resized axis.", None, tensor_ok=True,
    per_sample=True
).AddOptionalArg(
    "scales", ArgType.FLOAT_VEC, "Scale factors per resized axis.", None, tensor_ok=True,
    per_sample=True
).AddOptionalArg("axes", ArgType.INT_VEC, "Axes the sizes/scales refer to.", None).AddOptionalArg(
    "alignment", ArgType.FLOAT, "ROI alignment for rounded extents (0..1); accepted for "
    "compatibility.", 0.5
).AddOptionalArg(
    "interp_type", ArgType.INTERP_TYPE, "Interpolation.", DALIInterpType.INTERP_LINEAR
).AddOptionalArg("antialias", ArgType.BOOL, "Antialias on downscale.", True).AddOptionalArg(
    "dtype", ArgType.DATA_TYPE, "Output dtype.", None
).AddOptionalArg(
    "axis_names", ArgType.TENSOR_LAYOUT, "Axes to resize named by layout letters.", None
).AddOptionalArg(
    "mode", ArgType.STRING, '"default", "stretch", "not_larger", "not_smaller".', "default"
).AddOptionalArg(
    "roi_start", ArgType.FLOAT_VEC, "Input ROI origin (per resized axis).", None,
    tensor_ok=True, per_sample=True
).AddOptionalArg(
    "roi_end", ArgType.FLOAT_VEC, "Input ROI end (per resized axis).", None, tensor_ok=True,
    per_sample=True
).AddOptionalArg("roi_relative", ArgType.BOOL, "ROI in relative [0,1] coords.", False).AddOptionalArg(
    "size_rounding", ArgType.STRING,
    'Fractional output extent rounding: "round", "truncate", "ceil".', "round"
).AddOptionalArg(
    "subpixel_scale", ArgType.BOOL, "Adjust scale for fractional sizes.", True
).AddOptionalArg("mag_filter", ArgType.INTERP_TYPE, "Filter for upscaling.", None).AddOptionalArg(
    "min_filter", ArgType.INTERP_TYPE, "Filter for downscaling.", None
).AddOptionalArg(
    "minibatch_size", ArgType.INT, "Batching hint; accepted for compatibility.", 32
).AddOptionalArg(
    "temp_buffer_hint", ArgType.INT, "Scratch-size hint; accepted for compatibility.", 0)


_SIZE_ROUNDING = {"round": lambda v: _crop_round(v, "round"), "truncate": int,
                  "ceil": lambda v: int(-(-v // 1))}


@register_operator("TensorResize", "cpu")
class TensorResizeCPU(SamplePool, Operator):
    """``scipy.ndimage.zoom`` of each sample in float32 (order 0 nearest,
    else 1; ``grid_mode=True``, the edge replicated) over the axes given by
    ``axes`` or ``axis_names`` (default all), to ``sizes`` (rounded by
    ``size_rounding``, fitted by ``mode``) or by ``scales``, optionally of
    the ROI first; integer inputs round half to even and saturate unless
    ``dtype`` (a plain cast) is given."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        # the reference's cpu op never reads them
        raise_unserved(spec, ("antialias", "subpixel_scale", "mag_filter", "min_filter"))

    def run_batch(self, ctx, inp):
        self._in_layout = inp.layout or ""
        return super().run_batch(ctx, inp)

    def run_sample(self, ctx, idx, x):
        from scipy import ndimage

        spec = self.spec
        axes = spec.GetArgument("axes", None)
        nd = x.ndim
        names = spec.GetArgument("axis_names", None)
        if names and not axes:
            if not self._in_layout:
                raise ValueError("TensorResize axis_names requires a layout on the input")
            axes = [self._in_layout.index(ch) for ch in names]
        if not axes:
            axes = list(range(nd))
        rs, re_ = ctx.arg(self, "roi_start", idx, None), ctx.arg(self, "roi_end", idx, None)
        if rs is not None or re_ is not None:
            rel = spec.GetArgument("roi_relative")
            exts = [x.shape[a] for a in axes]
            s0 = np.asarray(rs if rs is not None else [0.0] * len(axes), np.float64).reshape(-1)
            e0 = np.asarray(re_ if re_ is not None else ([1.0] * len(axes) if rel else exts),
                            np.float64).reshape(-1)
            if rel:
                s0, e0 = s0 * exts, e0 * exts
            sl = [slice(None)] * nd
            for k, a in enumerate(axes):
                sl[a] = slice(int(round(s0[k])), max(int(round(e0[k])), int(round(s0[k])) + 1))
            x = x[tuple(sl)]
        rounding = _SIZE_ROUNDING[spec.GetArgument("size_rounding")]
        sizes, scales = ctx.arg(self, "sizes", idx, None), ctx.arg(self, "scales", idx, None)
        zoom = [1.0] * nd
        for nm, v in (("sizes", sizes), ("scales", scales)):
            if v is not None and np.asarray(v).reshape(-1).size != len(axes):
                raise ValueError(
                    f"TensorResize: `{nm}` has {np.asarray(v).reshape(-1).size} entries but "
                    f"{len(axes)} axes are being resized (pass `axes`/`axis_names`, or one "
                    "entry per input dim)")
        if sizes is not None:
            sizes = np.asarray(sizes, np.float64).reshape(-1)
            mode = spec.GetArgument("mode")
            if mode in ("not_larger", "not_smaller") and sizes.size:
                ratios = [float(sizes[k]) / x.shape[a] for k, a in enumerate(axes)]
                r = min(ratios) if mode == "not_larger" else max(ratios)
                sizes = np.asarray([rounding(x.shape[a] * r) for a in axes], np.float64)
            for k, a in enumerate(axes):
                zoom[a] = float(rounding(sizes[k])) / x.shape[a]
        elif scales is not None:
            for k, a in enumerate(axes):
                zoom[a] = float(np.asarray(scales, np.float64).reshape(-1)[k])
        else:
            raise ValueError("TensorResize requires `sizes` or `scales`")
        order = 0 if spec.GetArgument("interp_type") == DALIInterpType.INTERP_NN else 1
        out = ndimage.zoom(x.astype(np.float32), zoom, order=order, grid_mode=True,
                           mode="nearest")
        dt = spec.GetArgument("dtype", None)
        if dt is not None:
            out = out.astype(to_numpy_type(dt))
        elif np.issubdtype(x.dtype, np.integer):
            out = saturate(out, x.dtype)
        return np.ascontiguousarray(out)


def register_aliases():
    """Register every legacy name whose target the port has; return the
    names of the legacy table left out."""
    missing = []
    for alias, target in {**_LEGACY, **_DEPRECATED}.items():
        if target in _registry:
            _registry.setdefault(alias, _registry[target])
            _alias_targets[alias] = target
            for (name, dev), impl in list(_impl_registry.items()):
                if name == target:
                    _impl_registry[(alias, dev)] = impl
        elif alias in _LEGACY:
            missing.append(alias)
    return missing


_ALIAS_MISS = register_aliases()
