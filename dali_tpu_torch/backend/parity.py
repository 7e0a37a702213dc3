"""Legacy and experimental operator names, experimental.WarpPerspective
(cpu and gpu), TensorResize's schema and cpu placement, decoders.Video with
its alias experimental.decoders.Video, and readers.VideoResize (cpu and
mixed) with its alias VideoReaderResize (counterpart of
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
from ..types import DALIInterpType, cast_host, contiguous_host
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

# The ROADMAP.md Queue 1 item of each dali_tpu operator the port lacks: none
# since item 8b's registry part.
QUEUE_ITEMS = {}


# The one deliberate renaming: the reference's gpu _JaxFunction traces a JAX
# function into its device program; the port runs a torch function there
# (fn.torch_function).
RENAMED = {"_JaxFunction": "_TorchFunction"}

# a deprecated name and the experimental names the reference registers
# beside its legacy table (``alias_schema``)
_DEPRECATED = {"TransformTranslation": "transforms.Translation",
               "experimental.TensorResize": "TensorResize", "experimental.Resize": "Resize",
               "experimental.decoders.Video": "decoders.Video",
               "VideoReaderResize": "readers.VideoResize"}


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
            out = cast_host(out, dt)
        elif np.issubdtype(x.dtype, np.integer):
            out = saturate(out, x.dtype)
        return contiguous_host(out)


# ====================================== decoders.Video ============================================

DALI_SCHEMA("decoders.Video").DocStr(
    """Decodes a whole encoded video buffer to [F, H, W, C] uint8 (reference
    decoders__Video / experimental__decoders__Video; the port's host MP4 /
    MPEG-4 Part 2 decode)."""
).NumInput(1).NumOutput(1).Devices("cpu", "mixed").AddOptionalArg(
    "start_frame", ArgType.INT, "First frame.", 0, tensor_ok=True, per_sample=True
).AddOptionalArg(
    "sequence_length", ArgType.INT, "Frames to decode (0 = all).", 0, tensor_ok=True,
    per_sample=True
).AddOptionalArg(
    "stride", ArgType.INT, "Frame stride.", 1
).AddOptionalArg(
    "end_frame", ArgType.INT,
    "Decode frames [start_frame, end_frame) — alternative to sequence_length (reference "
    "video_decoder_cpu.cc).", 0, tensor_ok=True, per_sample=True
).AddOptionalArg(
    "pad_mode", ArgType.STRING,
    'Sequence padding when the video runs short: "none", "constant" (pad_value), '
    '"edge"/"repeat", "reflect_1001"/"symmetric", "reflect_101"/"reflect" (reference '
    'video_decoder_cpu.cc).', "constant"
).AddOptionalArg(
    "pad_value", ArgType.FLOAT, "Constant pad value.", 0.0
).AddOptionalArg(
    "fill_value", ArgType.FLOAT, "Alias of pad_value.", None
).AddOptionalArg(
    "build_index", ArgType.BOOL,
    "Build a frame index for faster seeking (hint; the host decoder seeks by its sample "
    "table).", True)


class _YUVPlanShort(Exception):
    """The planar-YUV wire plan (sized from the container's frame count)
    filled completely and more real frames exist past it: the batch re-runs
    on the dense path, which reads to the end."""


@register_operator("decoders.Video", "cpu")
@register_operator("decoders.Video", "mixed")
class VideoDecoder(Operator):
    """The whole buffer through ``native.VideoFile``; the mixed placement
    ships 4:2:0 frames as the planar YUV wire (as ``readers.Video``), with
    zero constant padding as YUV black and the other modes by repeating
    frames; a nonzero fill, or a plan the frame count undercounts, takes the
    dense RGB path."""

    def _plan(self, ctx, idx, vf):
        stride = self.spec.GetArgument("stride", 1)
        start = int(np.asarray(ctx.arg(self, "start_frame", idx, 0)))
        length = int(np.asarray(ctx.arg(self, "sequence_length", idx, 0)))
        end = int(np.asarray(ctx.arg(self, "end_frame", idx, 0)))
        if length <= 0 and end > 0:
            length = max((end - start + stride - 1) // stride, 1)
        requested = length
        if length <= 0:
            length = max((vf.num_frames - start + stride - 1) // stride, 1)
            requested = 0  # "all available": never pad
        return start, length, requested

    def _fill(self):
        fv = self.spec.GetArgument("fill_value", None)
        return self.spec.GetArgument("pad_value", 0.0) if fv is None else fv

    def run_sample(self, ctx, idx, buf):
        from .video import pad_frames

        vf = native.VideoFile(np.ascontiguousarray(buf).tobytes())
        try:
            start, length, requested = self._plan(ctx, idx, vf)
            frames = vf.read(start, length, self.spec.GetArgument("stride", 1), pad=False)
        finally:
            vf.close()
        if requested and frames.shape[0] < requested:
            frames = pad_frames(frames, requested, self.spec.GetArgument("pad_mode", "constant"),
                                self._fill())
        return frames

    def stage_batch_multi(self, ctx, ins):
        from .video import pad_indices, stage_yuv_batch

        spec = self.spec
        pad_mode = spec.GetArgument("pad_mode", "constant")
        if pad_mode == "constant" and float(np.asarray(self._fill()).reshape(-1)[0]) != 0.0:
            return None
        inp = ins[0]
        n = len(inp.samples)
        stride = spec.GetArgument("stride", 1)
        vfs, plans = [], []
        try:
            classes = set()
            for idx in range(n):
                vf = native.VideoFile(np.ascontiguousarray(inp.samples[idx]).tobytes())
                vfs.append(vf)
                classes.add(vf.pixfmt_class)
                if len(classes) != 1 or 0 in classes:
                    # both ranges, or a stream that is not 4:2:0, in one
                    # batch: the dense RGB path
                    return None
                start, length, requested = self._plan(ctx, idx, vf)
                # a shrinking sample ('all' / pad_mode none) caps its planned
                # wire at the header's count + 2; the frames it emits come
                # back from the read
                shrink = not requested or pad_mode == "none"
                if shrink:
                    avail = max((vf.num_frames - start + stride - 1) // stride, 1)
                    length = min(length, avail + 2)
                probe = shrink and (requested == 0 or length < requested)
                plans.append((start, length, shrink, probe))
            full_range = classes.pop() == 2

            def decode_into(i, ys, us, vs, emit):
                start, length, shrink, probe = plans[i]
                fy = ys.shape[0] // emit
                fc = us.shape[0] // emit
                _, _, _, got = vfs[i].read_yuv(start, length, stride, pad=False,
                                               out=(ys[: length * fy], us[: length * fc],
                                                    vs[: length * fc]))
                if shrink:
                    if probe and got == length:
                        # a plan filled completely: if a frame exists past
                        # it, the dense path reads to the end instead
                        try:
                            _, _, _, extra = vfs[i].read_yuv(start + length * stride, 1,
                                                             stride, pad=False)
                        except ValueError:
                            extra = 0
                        if extra > 0:
                            raise _YUVPlanShort()
                    return got
                if emit > got:
                    if pad_mode == "constant":
                        ys[got * fy: emit * fy] = 0 if full_range else 16
                        us[got * fc: emit * fc] = 128
                        vs[got * fc: emit * fc] = 128
                    else:  # frame replication commutes with the conversion
                        src = pad_indices(got, emit, pad_mode)
                        for plane, f in ((ys, fy), (us, fc), (vs, fc)):
                            p = plane.reshape(emit, f)
                            p[got:] = p[src]
                return emit

            dims = [(plans[i][1], vfs[i].height, vfs[i].width) for i in range(n)]
            try:
                return [stage_yuv_batch(dims, full_range, decode_into)]
            except (_YUVPlanShort, native.VideoPixfmtChanged):
                # an undercounting plan, or a change of frame size mid-stream:
                # the dense RGB path reads to the end, or stops at the change
                return None
        finally:
            for vf in vfs:
                vf.close()

    def output_layout(self, j, inputs):
        return "FHWC"


# ====================================== readers.VideoResize =======================================

from .video import _VideoReaderImpl  # noqa: E402


def _video_resize_schema():
    """readers.Video's arguments and outputs, and the resize arguments."""
    s = DALI_SCHEMA("readers.VideoResize")
    base = _registry["readers.Video"]
    s.DocStr("readers.Video fused with per-frame resize (reference readers__VideoResize).")
    s.args = dict(base.args)
    s.min_inputs, s.max_inputs = base.min_inputs, base.max_inputs
    s.output_fn = base.output_fn
    s.num_outputs = base.num_outputs
    s.devices = ("cpu", "mixed")
    s.is_reader = True
    s.is_stateless = False
    s.AddOptionalArg("resize_x", ArgType.FLOAT, "Output width.", 0.0)
    s.AddOptionalArg("resize_y", ArgType.FLOAT, "Output height.", 0.0)
    s.AddOptionalArg("resize_shorter", ArgType.FLOAT, "Resize shorter edge.", 0.0)
    s.AddOptionalArg("resize_longer", ArgType.FLOAT, "Resize longer edge.", 0.0)
    s.AddOptionalArg("size", ArgType.FLOAT_VEC, "Output size (H, W).", None)
    s.AddOptionalArg("mode", ArgType.STRING,
                     '"default", "stretch", "not_larger", "not_smaller".', "default")
    s.AddOptionalArg("interp_type", ArgType.INTERP_TYPE, "Interpolation.",
                     DALIInterpType.INTERP_LINEAR)
    s.AddOptionalArg("antialias", ArgType.BOOL, "Antialias on downscale.", True)
    s.AddOptionalArg("mag_filter", ArgType.INTERP_TYPE, "Filter for upscaling.", None)
    s.AddOptionalArg("min_filter", ArgType.INTERP_TYPE, "Filter for downscaling.", None)
    s.AddOptionalArg("roi_relative", ArgType.BOOL, "ROI in relative coords.", False)
    s.AddOptionalArg("roi_start", ArgType.FLOAT_VEC, "Input ROI origin.", None)
    s.AddOptionalArg("roi_end", ArgType.FLOAT_VEC, "Input ROI end.", None)
    s.AddOptionalArg("subpixel_scale", ArgType.BOOL,
                     "Adjust scale for fractional sizes.", True)
    s.AddOptionalArg("resize_z", ArgType.FLOAT,
                     "Volumetric depth (n/a for video frames).", 0.0)
    s.AddOptionalArg("minibatch_size", ArgType.INT,
                     "Reference GPU kernel batching hint (compat).", 32)
    s.AddOptionalArg("temp_buffer_hint", ArgType.INT,
                     "Reference GPU scratch hint (compat).", 0)
    return s


_video_resize_schema()


@register_operator("readers.VideoResize", "cpu")
@register_operator("readers.VideoResize", "mixed")
class VideoResizeReader(_VideoReaderImpl):
    """readers.Video's sequences, each frame cropped to the ROI and resized
    with the Resize arguments (``host_resample``, the cpu Resize's
    resampler); a batch's sequences are read and resized on the pipeline's
    threads. Like the reference's, the mixed placement is the plain
    reader's: its frames cross to the device as dense RGB, never as the
    planar YUV wire of readers.Video's mixed placement."""

    def _read_payload(self, index: int):
        from ..kernels.host_resample import host_resample
        from .image import _pick_filter, compute_resize_size

        out = super()._read_payload(index)
        frames = out[0] if isinstance(out, tuple) else out
        spec = self.spec
        h, w = frames.shape[1:3]
        rs0 = spec.GetArgument("roi_start", None)
        re0 = spec.GetArgument("roi_end", None)
        if rs0 is not None or re0 is not None:
            # the reference crops by the ROI's rounded integer bounds
            rel = spec.GetArgument("roi_relative", False)
            s0 = np.asarray(rs0 if rs0 is not None else [0.0, 0.0], np.float64)
            e0 = np.asarray(re0 if re0 is not None else ([1.0, 1.0] if rel else [h, w]),
                            np.float64)
            if rel:
                s0, e0 = s0 * [h, w], e0 * [h, w]
            y0, x0 = int(round(s0[0])), int(round(s0[1]))
            y1, x1 = int(round(e0[0])), int(round(e0[1]))
            frames = frames[:, max(y0, 0):max(y1, y0 + 1), max(x0, 0):max(x1, x0 + 1)]
            h, w = frames.shape[1:3]
        try:
            oh, ow = compute_resize_size(h, w, spec, lambda n, d=None: spec.GetArgument(n, d))
        except ValueError:  # no resize extents: frames pass through
            oh, ow = h, w
        if (oh, ow) != (h, w):
            interp = _pick_filter(spec, oh < h or ow < w)
            antialias = spec.GetArgument("antialias", True)
            if isinstance(frames, torch.Tensor):  # bfloat16: resampled in float32, rounded once
                from ..types import DALIDataType

                f32 = frames.float().numpy()
                frames = cast_host(np.stack([host_resample(f, oh, ow, interp, antialias)
                                             for f in f32]), DALIDataType.BFLOAT16)
            else:
                frames = np.stack([host_resample(f, oh, ow, interp, antialias) for f in frames])
        return (frames,) + tuple(out[1:]) if isinstance(out, tuple) else frames


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
