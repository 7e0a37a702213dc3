"""Slice, Crop, Normalize, Cat, Stack, PermuteBatch, LookupTable, the Full
family and GetProperty (counterpart of ``dali_tpu/backend/generic2.py``).

out = scale * (in - mean) / stddev + shift, with mean and stddev taken over
``axes`` unless given, or over the whole batch with ``batch=True``. On the
device the moments of a ragged batch run over each sample's valid region only.

As in the reference, the cpu op computes in float64 and honours ``ddof``; the
device op computes in float32 and ignores ``ddof`` (the reference's device
lowering does the same, ``dali_tpu/backend/generic2.py:563-619``).
"""

from __future__ import annotations

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch, HostBatch
from ..types import (DALIDataType, DALIImageType, cast_host, contiguous_host, to_bfloat16,
                     to_numpy_type, to_torch_type)
from .base import BF16_BITS, BF16_ROUND, BF16_WIDEN, Operator

# -- Slice (cpu; the gpu op is in generic_gpu.py) -----------------------------------------

DALI_SCHEMA("Slice").DocStr(
    """Extracts a subtensor per sample: anchor and shape as arguments (absolute
    or relative) or as two positional inputs."""
).NumInput(1, 3).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "start", ArgType.FLOAT_VEC, "Absolute anchor.", None, tensor_ok=True
).AddOptionalArg(
    "rel_start", ArgType.FLOAT_VEC, "Relative anchor.", None, tensor_ok=True
).AddOptionalArg(
    "end", ArgType.FLOAT_VEC, "Absolute end.", None, tensor_ok=True
).AddOptionalArg(
    "rel_end", ArgType.FLOAT_VEC, "Relative end.", None, tensor_ok=True
).AddOptionalArg(
    "shape", ArgType.FLOAT_VEC, "Absolute shape.", None, tensor_ok=True
).AddOptionalArg(
    "rel_shape", ArgType.FLOAT_VEC, "Relative shape.", None, tensor_ok=True
).AddOptionalArg(
    "axes", ArgType.INT_VEC, "Axes the anchor/shape refer to.", None
).AddOptionalArg(
    "axis_names", ArgType.TENSOR_LAYOUT, "Axes by layout name.", None
).AddOptionalArg(
    "normalized_anchor", ArgType.BOOL, "Positional anchor input is relative.", True
).AddOptionalArg(
    "normalized_shape", ArgType.BOOL, "Positional shape input is relative.", True
).AddOptionalArg(
    "out_of_bounds_policy", ArgType.STRING, '"error", "pad", "trim_to_shape".', "error"
).AddOptionalArg("fill_values", ArgType.FLOAT_VEC, "Padding values for policy 'pad'.",
                 [0.0]).AddOptionalArg("dtype", ArgType.DATA_TYPE, "Output dtype.", None)


def _slice_axes(spec, layout, ndim):
    """The sliced axes: ``axis_names`` against the layout, else ``axes``,
    else DALI's default: W and H by name, else [1, 0] (1-D inputs: [0])."""
    names = spec.GetArgument("axis_names", None)
    if names:
        if not layout:
            raise ValueError(f"{spec.schema.name}: axis_names={names!r} requires a layout "
                             "on the input; pass `axes` (by index) instead")
        missing = [c for c in names if c not in layout]
        if missing:
            raise ValueError(f"{spec.schema.name}: axis name(s) {missing} not in input "
                             f"layout {layout!r}")
        return [layout.index(c) for c in names]
    axes = spec.GetArgument("axes", None)
    if axes is not None and len(axes):
        return [a % ndim for a in axes]
    if layout and "W" in layout and "H" in layout:
        return [layout.index("W"), layout.index("H")]
    return [1, 0] if ndim >= 2 else [0]


@register_operator("Slice", "cpu")
class SliceCPU(Operator):
    reads_bfloat16 = BF16_ROUND

    def run_batch(self, ctx, *inputs):
        self._in_layout = inputs[0].layout if inputs else ""
        return super().run_batch(ctx, *inputs)

    def run_sample(self, ctx, idx, data, *pos):
        spec = self.spec
        axes = _slice_axes(spec, self._in_layout, data.ndim)
        dims = np.array([data.shape[a] for a in axes])

        def geta(name):
            v = ctx.arg(self, name, idx, None)
            return None if v is None else np.asarray(v, np.float64).reshape(-1)

        if pos:
            anchor = np.asarray(pos[0], np.float64).reshape(-1)
            shape = np.asarray(pos[1], np.float64).reshape(-1) if len(pos) > 1 else None
            if spec.GetArgument("normalized_anchor"):
                anchor = anchor * dims
            if shape is not None and spec.GetArgument("normalized_shape"):
                shape = shape * dims
        else:
            anchor = geta("start")
            if anchor is None:
                ra = geta("rel_start")
                anchor = ra * dims if ra is not None else np.zeros(len(axes))
            shape = geta("shape")
            if shape is None:
                rs = geta("rel_shape")
                if rs is not None:
                    shape = rs * dims
            if shape is None:
                end = geta("end")
                if end is None:
                    re = geta("rel_end")
                    end = re * dims if re is not None else None
                if end is not None:
                    shape = end - anchor
            if shape is None:
                shape = dims - anchor
        anchor = np.round(anchor).astype(np.int64)
        shape = np.round(shape).astype(np.int64)
        policy = spec.GetArgument("out_of_bounds_policy")
        slices = [slice(None)] * data.ndim
        pads = [(0, 0)] * data.ndim
        for k, a in enumerate(axes):
            lo = int(anchor[k])
            hi = lo + int(shape[k])
            if lo < 0 or hi > data.shape[a]:
                if policy == "error":
                    raise ValueError(f"Slice [{lo}, {hi}) out of bounds for dim {a} "
                                     f"(size {data.shape[a]})")
                if policy == "pad":
                    pads[a] = (max(-lo, 0), max(hi - data.shape[a], 0))
                lo, hi = max(lo, 0), min(hi, data.shape[a])
            slices[a] = slice(lo, hi)
        out = data[tuple(slices)]
        if any(p != (0, 0) for p in pads):
            out = np.pad(out, pads, constant_values=spec.GetArgument("fill_values")[0])
        dt = spec.GetArgument("dtype", None)
        if dt is not None:
            out = cast_host(out, dt)
        return contiguous_host(out)


# -- Crop (cpu, gpu) ------------------------------------------------------------------------

DALI_SCHEMA("Crop").DocStr("Fixed-size window crop.").NumInput(1).NumOutput(1).Devices(
    "cpu", "gpu").AddOptionalArg(
    "crop", ArgType.FLOAT_VEC, "Crop size (H, W).", None
).AddOptionalArg(
    "crop_h", ArgType.FLOAT, "Crop height.", 0.0, tensor_ok=True
).AddOptionalArg(
    "crop_w", ArgType.FLOAT, "Crop width.", 0.0, tensor_ok=True
).AddOptionalArg(
    "crop_pos_x", ArgType.FLOAT, "Window x in [0,1].", 0.5, tensor_ok=True
).AddOptionalArg(
    "crop_pos_y", ArgType.FLOAT, "Window y in [0,1].", 0.5, tensor_ok=True
).AddOptionalArg(
    "out_of_bounds_policy", ArgType.STRING, '"error"|"pad"|"trim_to_shape".', "error"
).AddOptionalArg("fill_values", ArgType.FLOAT_VEC, "Pad fill.", [0.0]).AddOptionalArg(
    "dtype", ArgType.DATA_TYPE, "Output dtype.", None
).AddOptionalArg(
    "image_type", ArgType.IMAGE_TYPE, "Deprecated; ignored.", DALIImageType.RGB
).AddOptionalArg(
    "crop_d", ArgType.FLOAT, "Volumetric crop depth (DHWC inputs).", 0.0, tensor_ok=True
).AddOptionalArg(
    "crop_pos_z", ArgType.FLOAT, "Volumetric window z in [0,1].", 0.5, tensor_ok=True
).AddOptionalArg(
    "rounding", ArgType.STRING,
    'Window start to integer: "round" (half away from zero) or "truncate".', "round")


def _crop_round(v, mode):
    """std::round (half away from zero), or truncation toward zero."""
    v = float(v)
    if mode == "truncate":
        return int(v)
    return int(np.floor(v + 0.5)) if v >= 0 else int(np.ceil(v - 0.5))


def _crop_round_torch(v, mode):
    if mode == "truncate":
        return torch.trunc(v)
    return torch.trunc(v + torch.copysign(torch.full_like(v, 0.5), v))


class _CropCommon(Operator):
    def _size(self):
        crop = self.spec.GetArgument("crop", None)
        if crop:
            return int(crop[0]), int(crop[1])
        ch = int(self.spec.GetArgument("crop_h") or 0)
        cw = int(self.spec.GetArgument("crop_w") or 0)
        if ch and cw:
            return ch, cw
        raise ValueError("Crop requires `crop` or crop_h/crop_w")

    def _size_sample(self, ctx, idx):
        """The window of sample ``idx``: crop_h/crop_w may be tensor args."""
        crop = self.spec.GetArgument("crop", None)
        if crop:
            return int(crop[0]), int(crop[1])
        ch = int(np.asarray(ctx.arg(self, "crop_h", idx, 0.0)) or 0)
        cw = int(np.asarray(ctx.arg(self, "crop_w", idx, 0.0)) or 0)
        if ch and cw:
            return ch, cw
        raise ValueError("Crop requires `crop` or crop_h/crop_w")


@register_operator("Crop", "cpu")
class CropCPU(_CropCommon):
    def run_sample(self, ctx, idx, img):
        ch, cw = self._size_sample(ctx, idx)
        rnd = self.spec.GetArgument("rounding")
        if img.ndim == 4:  # DHWC: the depth first, then the 2-D window
            d = img.shape[0]
            cd = int(np.asarray(ctx.arg(self, "crop_d", idx, 0.0)) or 0) or d
            pz = float(np.asarray(ctx.arg(self, "crop_pos_z", idx, 0.5)))
            z = max(_crop_round(pz * (d - cd), rnd), 0)
            img = img[z:z + cd]
        h, w = img.shape[-3:-1]
        y = _crop_round(float(np.asarray(ctx.arg(self, "crop_pos_y", idx, 0.5))) * (h - ch), rnd)
        x = _crop_round(float(np.asarray(ctx.arg(self, "crop_pos_x", idx, 0.5))) * (w - cw), rnd)
        if (y < 0 or x < 0 or y + ch > h or x + cw > w) and \
                self.spec.GetArgument("out_of_bounds_policy") == "error":
            raise ValueError(f"Crop window {ch}x{cw} out of bounds for {h}x{w}")
        out = img[..., max(y, 0):y + ch, max(x, 0):x + cw, :]
        if out.shape[-3] != ch or out.shape[-2] != cw:
            pad = ([(0, 0)] * (img.ndim - 3)
                   + [(0, ch - out.shape[-3]), (0, cw - out.shape[-2]), (0, 0)])
            out = np.pad(out, pad, constant_values=self.spec.GetArgument("fill_values")[0])
        dt = self.spec.GetArgument("dtype", None)
        if dt is not None:
            out = cast_host(out, dt)
        return contiguous_host(out)


def _take_windows(data, starts, sizes):
    """``data`` [N, *canvas] cut per sample to the window of ``sizes`` at
    ``starts`` (int64 [N] each), one per leading dim; indices past the
    canvas clamp to its edge."""
    out = data
    for d, (st, sz) in enumerate(zip(starts, sizes)):
        idx = (st[:, None] + torch.arange(sz, device=data.device)).clamp(0, data.shape[1 + d] - 1)
        idx = idx.reshape((idx.shape[0],) + (1,) * d + (sz,) + (1,) * (out.dim() - 2 - d))
        out = torch.gather(out, 1 + d, idx.expand(*out.shape[:1 + d], sz, *out.shape[2 + d:]))
    return out


@register_operator("Crop", "gpu")
class CropGPU(_CropCommon):
    """A constant window: one window per sample at ``crop_pos_*`` of its
    extents, its start clamped so the window stays inside the canvas (the
    reference's ``dynamic_slice``); DHWC volumes crop the depth too. Tensor
    ``crop_h``/``crop_w`` (cpu tensors): each sample's window lands at the
    top left of a grow-only canvas, its extents in the output shapes."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._latch = (0, 0)
        self._ps_sizes = None

    def _has_tensor_size(self):
        return "crop_h" in self.spec.arg_inputs or "crop_w" in self.spec.arg_inputs

    def host_params(self, ctx, input_shapes):
        self._ps_sizes = None
        if not self._has_tensor_size():
            return {}
        batches = ctx._arg_batches.get(self.op_id, {})
        n = next((len(batches[k].samples) for k in ("crop_h", "crop_w") if k in batches), None)
        if n is None:
            raise ValueError("Crop(gpu): tensor crop_h/crop_w must be cpu tensors (the window "
                             "sizes drive host-side canvas math)")
        sizes = np.array([self._size_sample(ctx, i) for i in range(n)], np.int32)
        self._latch = (max(self._latch[0], int(sizes[:, 0].max())),
                       max(self._latch[1], int(sizes[:, 1].max())))
        self._ps_sizes = sizes
        return {"crop_sizes": sizes}

    def device_statics(self, ctx, input_shapes, input_batches):
        return None if self._ps_sizes is None else ("ps",) + self._latch

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        sh = input_shapes[0] if input_shapes else None
        if sh is None:
            return None
        sh = np.asarray(sh).astype(np.int64)
        if self._ps_sizes is not None:
            if sh.shape[1] != 3:
                return None
            out = sh.copy()
            out[:, :2] = self._ps_sizes
            return [out]
        ch, cw = self._size()
        lays = ctx.in_layouts(self)
        out = sh.copy()
        if sh.shape[1] == 4 and not (lays[0] if lays else "").startswith("D"):
            return None  # lower() refuses a sequence
        if sh.shape[1] == 4:
            cd = int(self.spec.GetArgument("crop_d") or 0)
            if not cd:  # the window takes the canvas's depth
                return None
            out[:, 0:3] = (cd, ch, cw)
        else:
            out[:, 0:2] = (ch, cw)
        return [out]

    def _arg(self, dctx, name, n, device):
        v = dctx.arg(self, name)
        if dctx.has_tensor_arg(self, name):
            return v.to(torch.float32).reshape(-1)
        return torch.full((n,), float(v), dtype=torch.float32, device=device)

    def lower(self, dctx, inp: DeviceBatch):
        st = dctx.static(self)
        data = inp.data
        n, dev = data.shape[0], data.device
        rnd = self.spec.GetArgument("rounding")
        py = self._arg(dctx, "crop_pos_y", n, dev)
        px = self._arg(dctx, "crop_pos_x", n, dev)
        if isinstance(st, tuple) and st and st[0] == "ps":
            if data.dim() != 4:
                raise NotImplementedError("Crop(gpu): per-sample crop_h/crop_w tensor args "
                                          "support HWC inputs only")
            sizes = dctx.param(self, "crop_sizes")
            y = _crop_round_torch(py * (inp.extent(0) - sizes[:, 0]).to(torch.float32), rnd)
            x = _crop_round_torch(px * (inp.extent(1) - sizes[:, 1]).to(torch.float32), rnd)
            out = _take_windows(data, [y.clamp(min=0).long(), x.clamp(min=0).long()],
                                [st[1], st[2]])
            shapes = torch.stack([sizes[:, 0], sizes[:, 1],
                                  torch.full_like(sizes[:, 0], data.shape[-1])], dim=1)
        else:
            ch, cw = self._size()
            windows = [(py, ch, 0), (px, cw, 1)]
            if data.dim() == 5 and not inp.layout.startswith("D"):
                raise ValueError(
                    f"Crop(gpu): a 5-D batch of layout {inp.layout or '(none)'!r} is not a "
                    "DHWC volume, and the gpu placement crops only HWC images and DHWC "
                    "volumes (as dali_tpu's does); crop a sequence with fn.crop(..., "
                    "device='cpu'), which crops H and W of every frame")
            if data.dim() == 5:
                cd = int(self.spec.GetArgument("crop_d") or 0) or data.shape[1]
                windows = [(self._arg(dctx, "crop_pos_z", n, dev), cd, 0), (py, ch, 1),
                           (px, cw, 2)]
            starts = []
            for pos, size, d in windows:
                v = _crop_round_torch(pos * (inp.extent(d) - size).to(torch.float32), rnd)
                starts.append(v.clamp(min=0).long().clamp(max=data.shape[1 + d] - size))
            out = _take_windows(data, starts, [w[1] for w in windows])
            shapes = None
        dt = self.spec.GetArgument("dtype", None)
        if dt is not None:
            out = out.to(to_torch_type(dt))
        return [DeviceBatch(out, shapes, inp.layout)]

DALI_SCHEMA("Normalize").DocStr(
    """Mean/stddev normalization: out = scale * (in - mean) / stddev + shift;
    mean/stddev computed over ``axes`` unless given; ``batch=True`` normalizes
    across the whole batch."""
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "axes", ArgType.INT_VEC, "Reduction axes.", None
).AddOptionalArg(
    "axis_names", ArgType.TENSOR_LAYOUT, "Reduction axes by name.", None
).AddOptionalArg(
    "mean", ArgType.FLOAT, "Fixed mean.", None, tensor_ok=True
).AddOptionalArg(
    "stddev", ArgType.FLOAT, "Fixed stddev.", None, tensor_ok=True
).AddOptionalArg("batch", ArgType.BOOL, "Normalize across the whole batch.", False).AddOptionalArg(
    "scale", ArgType.FLOAT, "Output scale.", 1.0
).AddOptionalArg("shift", ArgType.FLOAT, "Output shift.", 0.0).AddOptionalArg(
    "epsilon", ArgType.FLOAT, "Added to variance.", 0.0
).AddOptionalArg("ddof", ArgType.INT, "Delta degrees of freedom.", 0).AddOptionalArg(
    "dtype", ArgType.DATA_TYPE, "Output dtype.", DALIDataType.FLOAT
)


def _norm_axes(spec, ndim, layout=""):
    names = spec.GetArgument("axis_names", None)
    if names and layout:
        return tuple(layout.index(c) for c in names)
    axes = spec.GetArgument("axes", None)
    if axes:
        return tuple(a % ndim for a in axes)
    return tuple(range(ndim))


@register_operator("Normalize", "cpu")
class NormalizeCPU(Operator):
    reads_bfloat16 = BF16_WIDEN

    def run_batch(self, ctx, inp: HostBatch):
        spec = self.spec
        dt = spec.GetArgument("dtype")
        scale, shift = spec.GetArgument("scale"), spec.GetArgument("shift")
        eps, ddof = spec.GetArgument("epsilon"), spec.GetArgument("ddof")
        outs = []
        if spec.GetArgument("batch"):
            flat = np.concatenate([s.astype(np.float64).reshape(-1) for s in inp.samples])
            mean = flat.mean()
            std = np.sqrt(flat.var(ddof=ddof) + eps)
            for s in inp.samples:
                outs.append(cast_host(scale * (s.astype(np.float64) - mean) / max(std, 1e-12)
                                      + shift, dt))
            return [HostBatch(outs, layout=inp.layout)]
        for i, s in enumerate(inp.samples):
            axes = _norm_axes(spec, s.ndim, inp.layout)
            mean = ctx.arg(self, "mean", i, None)
            std = ctx.arg(self, "stddev", i, None)
            x = s.astype(np.float64)
            m = x.mean(axis=axes, keepdims=True) if mean is None else np.asarray(mean, np.float64)
            if std is None:
                var = ((x - m) ** 2).mean(axis=axes, keepdims=True)
                if ddof:
                    nred = np.prod([s.shape[a] for a in axes])
                    var = var * nred / max(nred - ddof, 1)
                sd = np.sqrt(var + eps)
            else:
                sd = np.asarray(std, np.float64)
            sd = np.where(sd == 0, 1.0, sd)
            outs.append(cast_host(scale * (x - m) / sd + shift, dt))
        return [HostBatch(outs, layout=inp.layout)]


@register_operator("Normalize", "gpu")
class NormalizeGPU(Operator):
    def lower(self, dctx, inp: DeviceBatch):
        spec = self.spec
        x = inp.data.to(torch.float32)
        axes = tuple(a + 1 for a in _norm_axes(spec, x.dim() - 1, inp.layout))
        if spec.GetArgument("batch"):
            axes = (0,) + axes
        eps = spec.GetArgument("epsilon")

        def fixed(name):
            """A fixed mean/stddev: a constant broadcasts as a scalar; a
            per-sample [N, ...] tensor argument broadcasts right-aligned over
            each sample's dims."""
            v = dctx.arg(self, name, None)
            if v is None:
                return None
            v = torch.as_tensor(v, dtype=torch.float32, device=x.device)
            if not dctx.has_tensor_arg(self, name):
                return v
            return v.reshape(v.shape[0], *([1] * (x.dim() - v.dim())), *v.shape[1:])

        m, sd = fixed("mean"), fixed("stddev")
        mask = inp.valid_mask()
        if mask is None:
            if m is None:
                m = x.mean(dim=axes, keepdim=True)
            if sd is None:
                sd = torch.sqrt(((x - m) ** 2).mean(dim=axes, keepdim=True) + eps)
        else:  # masked moments over each sample's valid region
            w = mask.to(torch.float32)
            count = torch.clamp(w.sum(dim=axes, keepdim=True), min=1.0)
            if m is None:
                m = (x * w).sum(dim=axes, keepdim=True) / count
            if sd is None:
                sd = torch.sqrt((((x - m) * w) ** 2).sum(dim=axes, keepdim=True) / count + eps)
        sd = torch.where(sd == 0, torch.ones_like(sd), sd)
        out = spec.GetArgument("scale") * (x - m) / sd + spec.GetArgument("shift")
        return [inp.with_data(out.to(to_torch_type(spec.GetArgument("dtype"))))]


# -- Cat (cpu) ---------------------------------------------------------------------------

DALI_SCHEMA("Cat").DocStr("Concatenates samples along an axis.").NumInput(1, 16).NumOutput(
    1).Devices("cpu", "gpu").AddOptionalArg("axis", ArgType.INT, "Join axis.", 0).AddOptionalArg(
    "axis_name", ArgType.TENSOR_LAYOUT, "Join axis by name.", None)


@register_operator("Cat", "cpu")
class CatCPU(Operator):
    reads_bfloat16 = BF16_BITS

    def run_batch(self, ctx, *inputs):
        # axis_name resolves against the first input's layout
        self._in_layout = inputs[0].layout if inputs else ""
        return super().run_batch(ctx, *inputs)

    def run_sample(self, ctx, idx, *inputs):
        axis = self.spec.GetArgument("axis", 0)
        name = self.spec.GetArgument("axis_name", None)
        if name:
            axis = self._in_layout.find(name)
            if axis < 0:
                raise ValueError(f"Cat: axis_name={name!r} not found in input layout "
                                 f"{self._in_layout!r}")
        return np.concatenate(inputs, axis=axis)


class _JoinAxis:
    def _join_axis(self, ctx, ndim):
        axis = self.spec.GetArgument("axis")
        name = self.spec.GetArgument("axis_name", None)
        if name:
            il = (ctx.in_layouts(self) or [""])[0]
            axis = il.find(name)
            if axis < 0:
                raise ValueError(f"{self.spec.schema.name}: axis_name={name!r} not found in "
                                 f"input layout {il!r}")
        if axis < 0:
            if ndim is None:
                raise RuntimeError("Cat(gpu): negative axis / axis_name need host-known input "
                                   "shapes; the producing op must propagate them")
            axis += ndim
        return axis


@register_operator("Cat", "gpu")
class CatGPU(_JoinAxis, Operator):
    """With host-known input shapes each input's valid rows start where the
    previous input's valid rows end (per sample), written over the earlier
    inputs' canvas padding; without them the canvases are concatenated."""

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        if not input_shapes or any(s is None for s in input_shapes):
            return None
        shs = [np.asarray(s).astype(np.int64) for s in input_shapes]
        axis = self._join_axis(ctx, shs[0].shape[1])
        out = shs[0].copy()
        out[:, axis] = np.sum([s[:, axis] for s in shs], axis=0)
        return [out]

    def host_params(self, ctx, input_shapes):
        if any(s is None for s in input_shapes):
            self._mode = ("concat", self._join_axis(ctx, None))
            return {}
        shs = [np.asarray(s) for s in input_shapes]
        axis = self._join_axis(ctx, shs[0].shape[1])
        self._mode = ("place", axis)
        # each input's per-sample start along the join axis
        ext = np.stack([s[:, axis] for s in shs], axis=1).astype(np.int64)
        return {"cat_offsets": (np.cumsum(ext, axis=1) - ext).astype(np.int32)}

    def device_statics(self, ctx, input_shapes, input_batches):
        return self._mode

    def lower(self, dctx, *inputs: DeviceBatch):
        mode, axis0 = dctx.static(self)
        axis = axis0 + 1
        if len(inputs) == 1:
            return [inputs[0]]
        if mode == "concat":
            return [DeviceBatch(torch.cat([i.data for i in inputs], dim=axis), None,
                                inputs[0].layout)]
        offsets = dctx.param(self, "cat_offsets").to(torch.int64)  # [n, k]
        first = inputs[0].data
        out_shape = list(first.shape)
        out_shape[axis] = sum(i.data.shape[axis] for i in inputs)
        for d in range(1, first.dim()):
            if d != axis:
                out_shape[d] = max(i.data.shape[d] for i in inputs)
        out = torch.zeros(out_shape, dtype=first.dtype, device=first.device)
        for k, inp in enumerate(inputs):
            src = inp.data
            size = src.shape[axis]
            # a start past the end clamps so the whole canvas fits, as the
            # reference's dynamic_update_slice clamps
            start = offsets[:, k].clamp(0, out_shape[axis] - size)
            pos = start[:, None] + torch.arange(size, device=src.device)
            pos = pos.reshape((src.shape[0],) + (1,) * (axis - 1) + (size,)
                              + (1,) * (src.dim() - axis - 1)).expand(src.shape)
            region = out[tuple(slice(0, src.shape[d]) if d not in (0, axis) else slice(None)
                               for d in range(src.dim()))]
            region.scatter_(axis, pos, src)
        return [DeviceBatch(out, None, inputs[0].layout)]


DALI_SCHEMA("Stack").DocStr("Stacks samples along a new axis.").NumInput(1, 16).NumOutput(
    1).Devices("cpu", "gpu").AddOptionalArg("axis", ArgType.INT, "New axis position.",
                                            0).AddOptionalArg(
    "axis_name", ArgType.TENSOR_LAYOUT, "New axis name.", None)


def _stack_layout(spec, in_layout):
    """``axis_name`` names the new axis, inserted into the input layout at
    ``axis`` (empty when unset)."""
    name = spec.GetArgument("axis_name", None)
    if not name or not in_layout:
        return ""
    axis = spec.GetArgument("axis")
    if axis < 0:
        axis += len(in_layout) + 1
    return in_layout[:axis] + name + in_layout[axis:]


@register_operator("Stack", "cpu")
class StackCPU(Operator):
    reads_bfloat16 = BF16_BITS

    def run_sample(self, ctx, idx, *inputs):
        return np.stack(inputs, axis=self.spec.GetArgument("axis"))

    def output_layout(self, output_idx, inputs):
        return _stack_layout(self.spec, inputs[0].layout if inputs else "")


@register_operator("Stack", "gpu")
class StackGPU(Operator):
    def _stack_axis(self, ndim_in):
        axis = self.spec.GetArgument("axis")
        return axis + ndim_in + 1 if axis < 0 else axis

    def host_output_layouts(self, in_layouts):
        return [_stack_layout(self.spec, in_layouts[0] if in_layouts else "")]

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        if not input_shapes or input_shapes[0] is None:
            return None
        sh = np.asarray(input_shapes[0]).astype(np.int64)
        axis = self._stack_axis(sh.shape[1])
        return [np.insert(sh, axis, len(input_shapes), axis=1)]

    def lower(self, dctx, *inputs: DeviceBatch):
        axis = self._stack_axis(inputs[0].data.dim() - 1) + 1
        return [DeviceBatch(torch.stack([i.data for i in inputs], dim=axis), None,
                            _stack_layout(self.spec, inputs[0].layout))]


# -- PermuteBatch (cpu, gpu) -----------------------------------------------------------------

DALI_SCHEMA("PermuteBatch").DocStr("Reorders the samples of the batch by index.").NumInput(
    1).NumOutput(1).Devices("cpu", "gpu").AddArg(
    "indices", ArgType.INT_VEC, "Source index for each output sample.", tensor_ok=True)


def _batch_indices(ctx, op):
    """The source indices, or None where they are a device tensor."""
    if "indices" not in op.spec.arg_inputs:
        return [int(i) for i in op.spec.GetArgument("indices")]
    v = ctx._arg_batches.get(op.op_id, {}).get("indices")
    return None if v is None else [int(np.asarray(s).reshape(-1)[0]) for s in v.samples]


@register_operator("PermuteBatch", "cpu")
class PermuteBatchCPU(Operator):
    def run_batch(self, ctx, inp: HostBatch):
        return [HostBatch([inp.samples[i] for i in _batch_indices(ctx, self)],
                          layout=inp.layout)]


@register_operator("PermuteBatch", "gpu")
class PermuteBatchGPU(Operator):
    def host_output_shapes(self, ctx, input_shapes, input_batches):
        sh = input_shapes[0] if input_shapes else None
        idx = _batch_indices(ctx, self)
        return None if sh is None or idx is None else [np.asarray(sh)[idx]]

    def lower(self, dctx, inp: DeviceBatch):
        idx = dctx.arg(self, "indices")
        idx = (idx.reshape(-1) if isinstance(idx, torch.Tensor)
               else torch.tensor(idx, device=inp.data.device)).to(torch.int64)
        shapes = inp.shapes[idx] if inp.shapes is not None else None
        return [DeviceBatch(inp.data[idx], shapes, inp.layout)]


# -- LookupTable (cpu, gpu) ---------------------------------------------------------------

DALI_SCHEMA("LookupTable").DocStr(
    "Maps integer values through a table of `keys` -> `values`."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "keys", ArgType.INT_VEC, "Keys.", None
).AddOptionalArg(
    "values", ArgType.FLOAT_VEC, "Values for the keys.", None
).AddOptionalArg(
    "default_value", ArgType.FLOAT, "Value for unmapped keys.", 0.0
).AddOptionalArg("dtype", ArgType.DATA_TYPE, "Output dtype.", DALIDataType.FLOAT)


class _LUTCommon(Operator):
    """The 65,536-entry float32 table, built once per operator: it depends
    only on the operator's arguments (the reference rebuilds it per sample)."""

    _lut = None

    def _table(self) -> np.ndarray:
        if self._lut is None:
            keys = self.spec.GetArgument("keys", None) or []
            values = self.spec.GetArgument("values", None) or []
            lut = np.full(0x10000, self.spec.GetArgument("default_value", 0.0), np.float32)
            for k, v in zip(keys, values):
                lut[int(k)] = v
            self._lut = lut
        return self._lut


@register_operator("LookupTable", "cpu")
class LookupTableCPU(_LUTCommon):
    reads_bfloat16 = BF16_WIDEN
    elementwise = True

    def run_sample(self, ctx, idx, x):
        return cast_host(self._table()[x.astype(np.int64)],
                         self.spec.GetArgument("dtype", DALIDataType.FLOAT))


@register_operator("LookupTable", "gpu")
class LookupTableGPU(_LUTCommon):
    def lower(self, dctx, inp: DeviceBatch):
        if getattr(self, "_lut_dev", None) is None or self._lut_dev.device != inp.data.device:
            self._lut_dev = torch.from_numpy(self._table()).to(inp.data.device)
        dt = to_torch_type(self.spec.GetArgument("dtype", DALIDataType.FLOAT))
        # indexed as the reference's device program indexes: negative keys
        # wrap from the end, keys past it clamp
        idx = inp.data.to(torch.int32).to(torch.int64)
        idx = torch.where(idx < 0, idx + 0x10000, idx).clamp(0, 0xFFFF)
        return [inp.with_data(self._lut_dev[idx].to(dt))]


# -- Full / Zeros / Ones and their *Like variants (cpu) ------------------------------------

def _value_schema(name, doc):
    return (DALI_SCHEMA(name).DocStr(doc).NumInput(0, 1).NumOutput(1).Devices("cpu", "gpu")
            .AddOptionalArg("shape", ArgType.INT_VEC, "Output shape.", None, tensor_ok=True)
            .AddOptionalArg("dtype", ArgType.DATA_TYPE, "Output dtype.", None)
            .AddOptionalArg("layout", ArgType.STRING, "Layout of the output.", None))


_value_schema("Zeros", "Batch of zero tensors.")
_value_schema("Ones", "Batch of one tensors.")
_value_schema("Full", "Batch filled with `fill_value`.").AddArg(
    "fill_value", ArgType.FLOAT_VEC, "Fill value(s).", tensor_ok=True)
_value_schema("ZerosLike", "Zeros with the input's shape.")
_value_schema("OnesLike", "Ones with the input's shape.")
_value_schema("FullLike", "`fill_value` with the input's shape.").AddArg(
    "fill_value", ArgType.FLOAT_VEC, "Fill value(s).", tensor_ok=True)


class _ValueOpCPU(Operator):
    fill = 0.0
    like = False

    def output_layout(self, output_idx, inputs):
        explicit = self.spec.GetArgument("layout", None)
        if explicit:
            return explicit
        return inputs[0].layout if (self.like and inputs) else ""

    def run_sample(self, ctx, idx, *inputs):
        if self.like:
            shape, base_dt = inputs[0].shape, inputs[0].dtype
        else:
            shp = ctx.arg(self, "shape", idx, None)
            shape = tuple(int(v) for v in np.asarray(shp).reshape(-1)) if shp is not None else ()
            base_dt = np.dtype(np.int32)
        dt_arg = self.spec.GetArgument("dtype", None)
        dt = to_numpy_type(dt_arg) if dt_arg is not None else base_dt
        bf16 = dt is torch.bfloat16  # built in float32, then rounded
        if bf16:
            dt = np.dtype(np.float32)
        fv = self.fill
        if fv is None:  # Full / FullLike
            fv = np.asarray(ctx.arg(self, "fill_value", idx, 0.0))
            if fv.size > 1:
                out = np.broadcast_to(fv.astype(dt), shape if shape else fv.shape).copy()
                return to_bfloat16(out) if bf16 else out
            if dt_arg is None and not self.like:
                dt = fv.dtype
            fv = fv.reshape(-1)[0]
        out = np.full(shape, fv, dtype=dt)
        return to_bfloat16(out) if bf16 else out


for _nm, _fill, _like in (("Zeros", 0.0, False), ("Ones", 1.0, False), ("Full", None, False),
                          ("ZerosLike", 0.0, True), ("OnesLike", 1.0, True),
                          ("FullLike", None, True)):
    # a bfloat16 input: Zeros/Ones read nothing of it, the Like forms its shape
    # and type (dali_tpu refuses it to Full and FullLike)
    register_operator(_nm, "cpu")(type(_nm + "CPU", (_ValueOpCPU,), {
        "fill": _fill, "like": _like, "reads_bfloat16": BF16_ROUND if _fill is not None else False}))


# -- GetProperty (cpu) -------------------------------------------------------------------------

DALI_SCHEMA("GetProperty").DocStr("Extracts a metadata property of the input.").NumInput(
    1).NumOutput(1).Devices("cpu").AddArg("key", ArgType.STRING, "'source_info' or 'layout'.")


@register_operator("GetProperty", "cpu")
class GetProperty(Operator):
    def run_batch(self, ctx, inp: HostBatch):
        key = self.spec.GetArgument("key")
        if key == "layout":
            payload = np.frombuffer(inp.layout.encode(), dtype=np.uint8)
            return [HostBatch([payload.copy() for _ in inp.samples])]
        if key == "source_info":
            infos = inp.source_info or [""] * len(inp.samples)
            return [HostBatch([np.frombuffer(str(s).encode(), dtype=np.uint8).copy()
                               for s in infos])]
        raise ValueError(f"Unknown property '{key}'")
