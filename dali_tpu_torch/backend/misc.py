"""PowerSpectrum (cpu and gpu), MultiPaste on the host with its schema and
region resolution, and DumpImage (counterpart of those parts of
``dali_tpu/backend/misc.py``; MultiPaste's gpu placement is in
``straggler_gpu.py``, as in the reference).

DumpImage writes each HWC (or CHW) sample of 1 or 3 channels as
``dump_{iteration}_{i}[_{suffix}].png`` in the working directory, through
the port's own PNG writer (``write_png``, the standard library's zlib; the
reference calls cv2.imwrite), and passes its input through."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch, HostBatch
from ..kernels.host_resample import saturate
from .base import BF16_WIDEN, Operator, raise_unserved

# ====================================== PowerSpectrum ==============================================

DALI_SCHEMA("PowerSpectrum").DocStr("Power spectrum of a 1-D signal.").NumInput(1).NumOutput(
    1).Devices("cpu", "gpu").AddOptionalArg(
    "nfft", ArgType.INT, "FFT size (default: signal length).", None
).AddOptionalArg("axis", ArgType.INT, "Transform axis.", -1).AddOptionalArg(
    "power", ArgType.INT, "2 = power, 1 = magnitude.", 2)


@register_operator("PowerSpectrum", "cpu")
class PowerSpectrumCPU(Operator):
    reads_bfloat16 = BF16_WIDEN

    def run_sample(self, ctx, idx, x):
        axis = self.spec.GetArgument("axis")
        nfft = self.spec.GetArgument("nfft") or x.shape[axis]
        spec = np.abs(np.fft.rfft(x.astype(np.float32), n=nfft, axis=axis))
        if self.spec.GetArgument("power") == 2:
            spec = spec * spec
        return spec.astype(np.float32)


@register_operator("PowerSpectrum", "gpu")
class PowerSpectrumGPU(Operator):
    """|rfft|, squared for ``power=2``, over the padded canvas (a ragged
    batch transforms each signal with its zero padding, as the reference's
    lowering does); the output carries no per-sample shapes."""

    def lower(self, dctx, inp: DeviceBatch):
        axis = self.spec.GetArgument("axis")
        if axis >= 0:
            axis += 1
        nfft = self.spec.GetArgument("nfft") or inp.data.shape[axis]
        spec = torch.abs(torch.fft.rfft(inp.data.to(torch.float32), n=nfft, dim=axis))
        if self.spec.GetArgument("power") == 2:
            spec = spec * spec
        return [DeviceBatch(spec, None, inp.layout)]


# ====================================== MultiPaste =================================================

DALI_SCHEMA("MultiPaste").DocStr(
    """Pastes regions of (possibly several) input samples onto an output canvas
    (the Mosaic-augmentation primitive). Regions are selected by ``in_ids`` +
    ``in_anchors``/``shapes`` and placed at ``out_anchors``."""
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddArg(
    "in_ids", ArgType.INT_VEC, "Source sample index per pasted region.", tensor_ok=True,
    per_sample=True
).AddOptionalArg(
    "in_anchors", ArgType.INT_VEC, "Flattened [k, 2] source anchors.", None, tensor_ok=True,
    per_sample=True
).AddOptionalArg(
    "shapes", ArgType.INT_VEC, "Flattened [k, 2] region shapes.", None, tensor_ok=True,
    per_sample=True
).AddOptionalArg(
    "out_anchors", ArgType.INT_VEC, "Flattened [k, 2] destination anchors.", None,
    tensor_ok=True, per_sample=True
).AddOptionalArg(
    "output_size", ArgType.INT_VEC, "Output canvas (H, W).", None, tensor_ok=True,
    per_sample=True
).AddOptionalArg("dtype", ArgType.DATA_TYPE, "Output dtype.", None).AddOptionalArg(
    "in_anchors_rel", ArgType.FLOAT_VEC,
    "Flattened [k, 2] source anchors relative to each source sample's extent.", None,
    tensor_ok=True, per_sample=True
).AddOptionalArg(
    "shapes_rel", ArgType.FLOAT_VEC,
    "Flattened [k, 2] region shapes relative to each source sample's extent.", None,
    tensor_ok=True, per_sample=True
).AddOptionalArg(
    "out_anchors_rel", ArgType.FLOAT_VEC,
    "Flattened [k, 2] destination anchors relative to the output canvas.", None,
    tensor_ok=True, per_sample=True)


def resolve_mp_regions(op, ctx, i, ids, src_hw, out_hw):
    """MultiPaste anchors and shapes of output sample ``i`` from the absolute
    or the ``*_rel`` arguments: (in_anchors [k, 2], out_anchors [k, 2],
    shapes [k, 2] or None), integers. Relative values scale by the source
    samples' extents (in_anchors, shapes) or the output canvas
    (out_anchors)."""
    k = len(ids)

    def get(name, scale):
        v = ctx.arg(op, name, i, None)
        if v is not None:
            return np.asarray(v, np.float64).reshape(k, 2).round().astype(np.int64)
        rv = ctx.arg(op, name + "_rel", i, None)
        if rv is not None:
            rv = np.asarray(rv, np.float64).reshape(k, 2) * scale
            return rv.round().astype(np.int64)
        return None

    src_hw = np.asarray(src_hw, np.float64).reshape(k, 2)
    ia = get("in_anchors", src_hw)
    oa = get("out_anchors", np.asarray(out_hw, np.float64)[None].repeat(k, 0))
    sh = get("shapes", src_hw)
    z = np.zeros((k, 2), np.int64)
    return (ia if ia is not None else z), (oa if oa is not None else z), sh


@register_operator("MultiPaste", "cpu")
class MultiPasteCPU(Operator):
    """Each output sample a zero canvas of ``output_size`` (default its own
    input's extent) in the input's type, with its regions pasted in order,
    each clipped to its source and to the canvas."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        raise_unserved(spec, ("dtype",))  # the reference's cpu op keeps the input's type

    def run_batch(self, ctx, inp: HostBatch):
        out = []
        for i in range(len(inp)):
            ids = np.asarray(ctx.arg(self, "in_ids", i), np.int64).reshape(-1)
            osz = ctx.arg(self, "output_size", i, None)
            ref = inp.samples[i]
            oh, ow = (int(osz[0]), int(osz[1])) if osz is not None else ref.shape[:2]
            canvas = np.zeros((oh, ow, ref.shape[2]), ref.dtype)
            src_hw = [inp.samples[int(s)].shape[:2] for s in ids]
            in_anchors, out_anchors, shapes = resolve_mp_regions(self, ctx, i, ids, src_hw,
                                                                 (oh, ow))
            for j, sid in enumerate(ids):
                src = inp.samples[int(sid)]
                rh, rw = shapes[j] if shapes is not None else src.shape[:2]
                iy, ix = in_anchors[j]
                oy, ox = out_anchors[j]
                rh = int(min(rh, src.shape[0] - iy, oh - oy))
                rw = int(min(rw, src.shape[1] - ix, ow - ox))
                if rh > 0 and rw > 0:
                    canvas[oy:oy + rh, ox:ox + rw] = src[iy:iy + rh, ix:ix + rw]
            out.append(canvas)
        return [HostBatch(out, layout=inp.layout or "HWC")]


# ====================================== DumpImage ==================================================

DALI_SCHEMA("DumpImage").DocStr(
    "Writes images to disk for debugging; passes its input through."
).NumInput(1).NumOutput(1).Devices("cpu").AddOptionalArg(
    "suffix", ArgType.STRING, "Filename suffix.", ""
).AddOptionalArg("input_layout", ArgType.TENSOR_LAYOUT, "Layout of the input.", "HWC")


def write_png(path: str, img: np.ndarray):
    """A PNG of ``img`` [H, W, 1] (grey) or [H, W, 3] (RGB): 16 bits a sample
    for uint16, else 8 (other types saturate to uint8, as cv2.imwrite does);
    every row unfiltered, zlib-compressed."""
    if img.dtype != np.uint16:
        img = saturate(img, np.uint8)
    h, w, c = img.shape
    rows = np.ascontiguousarray(img).astype(img.dtype.newbyteorder(">")).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows.view(np.uint8)], 1).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    hdr = struct.pack(">IIBBBBB", w, h, img.dtype.itemsize * 8, 0 if c == 1 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", hdr)
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


@register_operator("DumpImage", "cpu")
class DumpImageCPU(Operator):
    def run_batch(self, ctx, inp: HostBatch):
        suffix = self.spec.GetArgument("suffix")
        layout = inp.layout or self.spec.GetArgument("input_layout")
        for i, s in enumerate(inp.samples):
            if layout == "CHW" and s.ndim == 3:
                s = np.transpose(s, (1, 2, 0))
            if s.ndim == 3 and s.shape[-1] in (1, 3):
                write_png(f"dump_{ctx.iteration}_{i}{('_' + suffix) if suffix else ''}.png", s)
        return [inp]
