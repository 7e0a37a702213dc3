"""The device placements of ``dali_tpu/backend/straggler_gpu.py``: noise.Shot,
Dilate/Erode, MedianBlur, NonsilentRegion, TensorResize, MultiPaste,
JpegCompressionDistortion, Clahe and Debayer (the reference's CoordFlip gpu
is in ``bbox.py``). Each is plain PyTorch over the padded batch canvas, as
each reference op is one XLA program over it: per-sample extents become
masks and clamped gathers, not per-sample launches.

Where parity with the reference matters on the card, a division divides by
a tensor (a ``tensor / python_number`` on CUDA multiplies by the rounded
reciprocal, and ``number / tensor`` is ``reciprocal(tensor) * number`` on
every device), and no product that feeds a rounding goes through a matmul
or convolution library (TF32, and an order of summation of its own).
"""

from __future__ import annotations

import numpy as np
import torch

from .._schema import register_operator
from ..batch import DeviceBatch
from ..kernels.jpeg import idct_matrix, upsample2x, ycbcr_to_rgb
from ..types import DALIInterpType, to_torch_type
from .base import Operator, raise_unserved
from .misc import resolve_mp_regions
from .random import per_sample, saturate


def _f32(v, device) -> torch.Tensor:
    """A float32 scalar on ``device``, to divide by as a tensor."""
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def _valid_hw(inp: DeviceBatch):
    """Boolean [N, H, W] mask of each sample's valid rows and columns, or
    None for a uniform batch."""
    if inp.shapes is None:
        return None
    dev = inp.data.device
    h = torch.arange(inp.data.shape[1], device=dev)[None, :] < inp.shapes[:, 0, None]
    w = torch.arange(inp.data.shape[2], device=dev)[None, :] < inp.shapes[:, 1, None]
    return h[:, :, None] & w[:, None, :]


@register_operator("noise.Shot", "gpu")
class ShotNoiseGPU(Operator):
    def lower(self, dctx, inp: DeviceBatch):
        x = inp.data
        f = per_sample(dctx, self, "factor", 20.0, x.shape[0], x.dim(), x.device)
        safe_f = torch.where(f <= 0, 1.0, f)
        # a negative value has no Poisson rate: it draws 0, as a rate of 0 does
        lam = (x.to(torch.float32) / safe_f).clamp_(min=0)
        noisy = torch.poisson(lam, generator=dctx.generator(self)) * safe_f
        out = torch.where(f <= 0, x.to(torch.float32), noisy)
        if not x.dtype.is_floating_point:
            info = torch.iinfo(x.dtype)
            out = out.clamp(info.min, info.max)
        return [inp.with_data(out.to(x.dtype))]


# ====================================== Erode / Dilate =============================================


def _window_reduce(x: torch.Tensor, dim: int, k: int, red) -> torch.Tensor:
    """out[i] = red(x[i], ..., x[i + k - 1]) along ``dim`` (a VALID window)."""
    n = x.shape[dim] - k + 1
    out = x.narrow(dim, 0, n)
    for d in range(1, k):
        out = red(out, x.narrow(dim, d, n))
    return out


def _pad_const(x: torch.Tensor, dim: int, lo: int, hi: int, value) -> torch.Tensor:
    def block(m):
        shape = list(x.shape)
        shape[dim] = m
        return torch.full(shape, value, dtype=x.dtype, device=x.device)

    return torch.cat([block(lo), x, block(hi)], dim)


def _pad_edge(x: torch.Tensor, dim: int, p: int) -> torch.Tensor:
    idx = torch.arange(-p, x.shape[dim] + p, device=x.device).clamp(0, x.shape[dim] - 1)
    return x.index_select(dim, idx)


class _MorphGPU(Operator):
    """A rectangular min/max window as two separable passes (exact).
    Cells outside a sample's extent take the reduction's identity before the
    reduction and 0 after it; the ``constant`` border pads as
    ``lax.reduce_window(..., "SAME")`` does ((k - 1) // 2 cells before the
    data, k // 2 after), ``replicate`` pads k // 2 edge cells each side."""

    is_dilate = True

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        raise_unserved(spec, ("anchor",))

    def lower(self, dctx, inp: DeviceBatch):
        ms = self.spec.GetArgument("mask_size")
        mh, mw = int(ms[0]), int(ms[-1])
        x = inp.data
        if x.dtype.is_floating_point:
            ident = -float("inf") if self.is_dilate else float("inf")
        else:
            info = torch.iinfo(x.dtype)
            ident = info.min if self.is_dilate else info.max
        red = torch.maximum if self.is_dilate else torch.minimum
        valid = _valid_hw(inp)
        if valid is not None:
            valid = valid.reshape(valid.shape + (1,) * (x.dim() - 3))
            x = torch.where(valid, x, torch.full((), ident, dtype=x.dtype, device=x.device))

        def same(v):
            v = _pad_const(v, 1, (mh - 1) // 2, mh // 2, ident)
            v = _window_reduce(v, 1, mh, red)
            v = _pad_const(v, 2, (mw - 1) // 2, mw // 2, ident)
            return _window_reduce(v, 2, mw, red)

        if self.spec.GetArgument("border_mode") == "replicate":
            out = _window_reduce(_pad_edge(x, 1, mh // 2), 1, mh, red)
            out = _window_reduce(_pad_edge(out, 2, mw // 2), 2, mw, red)
        else:
            out = same(x)
        for _ in range(int(self.spec.GetArgument("iterations")) - 1):
            out = same(out)
        if valid is not None:
            out = torch.where(valid, out, torch.zeros((), dtype=x.dtype, device=x.device))
        return [inp.with_data(out)]


@register_operator("experimental.Dilate", "gpu")
class DilateGPU(_MorphGPU):
    is_dilate = True


@register_operator("experimental.Erode", "gpu")
class ErodeGPU(_MorphGPU):
    is_dilate = False


# ====================================== MedianBlur =================================================

# bytes of the stacked taps of one chunk of samples
MEDIAN_CHUNK_BYTES = 256 << 20


@register_operator("experimental.MedianBlur", "gpu")
class MedianBlurGPU(Operator):
    """The median of the k x k taps, each clamped to the sample's valid
    extent (a replicate border within the extent). The taps of a chunk of
    samples stack into [k*k, ...] at most ``MEDIAN_CHUNK_BYTES``; k*k is odd,
    so ``median`` (the lower median) is the median."""

    def lower(self, dctx, inp: DeviceBatch):
        k = int(self.spec.GetArgument("window_size")[0])
        r = k // 2
        x = inp.data
        n, H, W = x.shape[:3]
        dev = x.device
        eh, ew = inp.extent(0).to(torch.int64), inp.extent(1).to(torch.int64)
        per_sample_bytes = k * k * x[0].numel() * x.element_size()
        chunk = max(1, MEDIAN_CHUNK_BYTES // max(per_sample_bytes, 1))
        rows, cols = torch.arange(H, device=dev), torch.arange(W, device=dev)
        outs = []
        for s in range(0, n, chunk):
            xs = x[s:s + chunk]
            c = xs.shape[0]
            hmax, wmax = eh[s:s + chunk, None] - 1, ew[s:s + chunk, None] - 1
            nidx = torch.arange(c, device=dev)[:, None, None]
            taps = []
            for dy in range(-r, r + 1):
                iy = torch.minimum((rows[None] + dy).clamp(min=0), hmax)[:, :, None]
                for dx in range(-r, r + 1):
                    ix = torch.minimum((cols[None] + dx).clamp(min=0), wmax)[:, None, :]
                    taps.append(xs[nidx, iy, ix])
            outs.append(torch.stack(taps, 0).median(dim=0).values)
        return [inp.with_data(torch.cat(outs, 0))]


# ====================================== NonsilentRegion ============================================


@register_operator("NonsilentRegion", "gpu")
class NonsilentRegionGPU(Operator):
    """The moving mean square of each clip from a cumulative sum over the
    canvas, the threshold against its maximum (or ``reference_power``), and
    the first and last window above it; windows run past no clip's end."""

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        if input_shapes[0] is None:
            return None
        n = input_shapes[0].shape[0]
        return [np.zeros((n, 0), np.int32), np.zeros((n, 0), np.int32)]

    def host_output_layouts(self, in_layouts):
        return ["", ""]

    def lower(self, dctx, inp: DeviceBatch):
        n = inp.data.shape[0]
        L = int(np.prod(inp.data.shape[1:]))
        dev = inp.data.device
        x = inp.data.reshape(n, L).to(torch.float32)
        n_valid = (inp.shapes[:, 0].to(torch.int64) if inp.shapes is not None
                   else torch.full((n,), L, dtype=torch.int64, device=dev))
        win = n_valid.clamp(min=1).clamp(max=int(self.spec.GetArgument("window_length")))
        idx = torch.arange(L, device=dev)
        x = torch.where(idx[None] < n_valid[:, None], x, 0.0)
        cs = torch.cat([torch.zeros((n, 1), dtype=torch.float32, device=dev),
                        torch.cumsum(x * x, dim=1)], 1)
        hi = (idx[None] + win[:, None]).clamp(0, L)
        mms = (torch.gather(cs, 1, hi) - cs[:, :L]) / win[:, None].to(torch.float32)
        ok = idx[None] < (n_valid - win + 1).clamp(min=1)[:, None]
        mms = torch.where(ok, mms, -1.0)
        ref_cfg = float(self.spec.GetArgument("reference_power"))
        ref = (mms.max(dim=1).values if ref_cfg == 0.0
               else torch.full((n,), ref_cfg, dtype=torch.float32, device=dev))
        cutoff = float(self.spec.GetArgument("cutoff_db"))
        thresh = torch.clamp(ref * (10.0 ** (cutoff / 10.0)), min=1e-20)
        above = (mms >= thresh[:, None]) & ok
        any_above = above.any(dim=1)
        begin = torch.where(above, idx[None], L).min(dim=1).values
        last = torch.where(above, idx[None], -1).max(dim=1).values
        end = torch.minimum(last + win, n_valid)
        begin = torch.where(any_above, begin, 0).to(torch.int32)
        length = torch.where(any_above, end - begin, 0).to(torch.int32)
        return [DeviceBatch(begin, None, ""), DeviceBatch(length, None, "")]


# ====================================== TensorResize ===============================================


def _take(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """Per-sample gather along ``dim`` of [N, ...]: idx [N, t]."""
    shape = [1] * x.dim()
    shape[0], shape[dim] = x.shape[0], idx.shape[1]
    size = list(x.shape)
    size[dim] = idx.shape[1]
    return torch.gather(x, dim, idx.reshape(shape).expand(size))


@register_operator("TensorResize", "gpu")
class TensorResizeGPU(Operator):
    """Per-axis linear or nearest resampling with per-sample sizes at
    src = (j + 0.5) * in / out - 0.5, edge-clamped, onto a canvas rounded up
    to 8 on the resized axes, with per-sample output extents (zeros past
    them). As the reference's lowering, it does not antialias; the arguments
    it ignores raise here (ROADMAP.md Queue 3)."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        raise_unserved(spec, ("roi_start", "roi_end", "roi_relative", "mode", "size_rounding",
                              "mag_filter", "min_filter"))
        interp = spec.GetArgument("interp_type")
        if interp not in (DALIInterpType.INTERP_NN, DALIInterpType.INTERP_LINEAR):
            raise NotImplementedError(f"TensorResize(gpu): interp_type {interp!r} is not served "
                                      "on the device; see ROADMAP.md (Queue 3)")

    def _out_shapes(self, ctx, in_shapes):
        shapes = np.asarray(in_shapes[0])
        n, nd = shapes.shape
        axes = self.spec.GetArgument("axes", None)
        if not axes:
            names = self.spec.GetArgument("axis_names", None)
            if names:
                layout = (ctx.in_layouts(self) or [""])[0]
                if not layout:
                    raise ValueError("TensorResize(gpu): axis_names requires an input with a "
                                     "known layout; pass `axes` instead")
                axes = [layout.index(ch) for ch in names]
        axes = list(range(nd)) if not axes else [a % nd for a in axes]
        out = shapes.astype(np.float64).copy()
        for i in range(n):
            sizes = ctx.arg(self, "sizes", i, None)
            scales = ctx.arg(self, "scales", i, None)
            if sizes is not None:
                sz = np.asarray(sizes, np.float64).reshape(-1)
                for k, a in enumerate(axes):
                    out[i, a] = sz[k]
            elif scales is not None:
                sc = np.asarray(scales, np.float64).reshape(-1)
                for k, a in enumerate(axes):
                    out[i, a] = shapes[i, a] * sc[k]
            else:
                raise ValueError("TensorResize requires `sizes` or `scales`")
        return axes, np.maximum(np.round(out), 1).astype(np.int32)

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        if input_shapes[0] is None:
            return None
        return [self._out_shapes(ctx, input_shapes)[1]]

    def host_params(self, ctx, input_shapes):
        if input_shapes[0] is None:
            raise RuntimeError("TensorResize(gpu) requires its input's shapes to be known on "
                               "the host")
        return {"out_ext": self._out_shapes(ctx, input_shapes)[1]}

    def device_statics(self, ctx, input_shapes, input_batches):
        axes, out = self._out_shapes(ctx, input_shapes)
        return tuple(axes), tuple(int(-(-int(c) // 8) * 8) for c in out.max(axis=0))

    def lower(self, dctx, inp: DeviceBatch):
        axes, canvas = dctx.static(self)
        out_ext = dctx.param(self, "out_ext")
        nn = self.spec.GetArgument("interp_type") == DALIInterpType.INTERP_NN
        x = inp.data
        n, dev = x.shape[0], x.device
        in_ext = (inp.shapes if inp.shapes is not None else torch.tensor(
            [list(x.shape[1:])], dtype=torch.int32, device=dev).expand(n, -1))
        x = x.to(torch.float32)
        for a in axes:
            dim, tgt = a + 1, canvas[a]
            ie, oe = in_ext[:, a:a + 1], out_ext[:, a:a + 1]
            scale = ie.to(torch.float32) / oe.to(torch.float32)
            j = torch.arange(tgt, dtype=torch.float32, device=dev)[None]
            src = (j + 0.5) * scale - 0.5                                   # [N, tgt]
            shp = [1] * x.dim()
            shp[0], shp[dim] = n, tgt
            if nn:
                i0 = torch.minimum(torch.round(src).to(torch.int64).clamp(min=0), ie - 1)
                x = _take(x, i0, dim)
            else:
                f0 = torch.floor(src)
                w = (src - f0).reshape(shp)
                i0 = torch.minimum(f0.to(torch.int64).clamp(min=0), ie - 1)
                i1 = torch.minimum((f0.to(torch.int64) + 1).clamp(min=0), ie - 1)
                x = _take(x, i0, dim) * (1 - w) + _take(x, i1, dim) * w
            x = x * (j < oe).reshape(shp)
        dt = self.spec.GetArgument("dtype", None)
        out = saturate(x, to_torch_type(dt) if dt is not None else inp.data.dtype)
        return [DeviceBatch(out, out_ext, inp.layout)]


# ====================================== MultiPaste =================================================


@register_operator("MultiPaste", "gpu")
class MultiPasteGPU(Operator):
    """Each output sample composes its regions in order: region j gathers
    rows and columns of source sample ``in_ids[j]`` (clamped to the canvas)
    and overwrites the cells of its destination rectangle. The host resolves
    anchors and shapes and clips each region to its source and its output;
    the canvas rounds up to 8, with per-sample output extents. The output
    takes ``dtype`` (the reference's lowering keeps the input's, ROADMAP.md
    Queue 3). The per-sample arguments are read on the host only, so their
    samples may differ in length (the reference's executor stacks them and
    fails on ragged ``in_ids``)."""

    host_args = ("in_ids", "in_anchors", "shapes", "out_anchors", "output_size",
                 "in_anchors_rel", "shapes_rel", "out_anchors_rel")

    def _meta(self, ctx, in_shapes):
        shapes = np.asarray(in_shapes[0])
        n = shapes.shape[0]
        kmax = 0
        outs = np.zeros((n, 3), np.int32)
        for i in range(n):
            ids = np.asarray(ctx.arg(self, "in_ids", i), np.int64).reshape(-1)
            kmax = max(kmax, len(ids))
            osz = ctx.arg(self, "output_size", i, None)
            outs[i] = (int(osz[0]), int(osz[1]), shapes[i, 2]) if osz is not None else shapes[i]
        return kmax, outs

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        if input_shapes[0] is None:
            return None
        return [self._meta(ctx, input_shapes)[1]]

    def host_output_layouts(self, in_layouts):
        return [(in_layouts[0] if in_layouts else "") or "HWC"]

    def host_params(self, ctx, input_shapes):
        if input_shapes[0] is None:
            raise RuntimeError("MultiPaste(gpu) requires its input's shapes to be known on the "
                               "host")
        shapes = np.asarray(input_shapes[0])
        n = shapes.shape[0]
        kmax, outs = self._meta(ctx, input_shapes)
        ids = np.zeros((n, kmax), np.int64)
        ia, oa, rs = (np.zeros((n, kmax, 2), np.int64) for _ in range(3))
        for i in range(n):
            v = np.asarray(ctx.arg(self, "in_ids", i), np.int64).reshape(-1)
            ids[i, :len(v)] = v
            src_hw = [(shapes[int(s), 0], shapes[int(s), 1]) for s in v]
            ia_i, oa_i, sh_arg = resolve_mp_regions(self, ctx, i, v, src_hw,
                                                    (outs[i, 0], outs[i, 1]))
            for j, sid in enumerate(int(s) for s in v):
                rh, rw = sh_arg[j] if sh_arg is not None else shapes[sid, :2]
                rh = int(min(rh, shapes[sid, 0] - ia_i[j, 0], outs[i, 0] - oa_i[j, 0]))
                rw = int(min(rw, shapes[sid, 1] - ia_i[j, 1], outs[i, 1] - oa_i[j, 1]))
                ia[i, j], oa[i, j], rs[i, j] = ia_i[j], oa_i[j], (max(rh, 0), max(rw, 0))
        return {"mp_ids": ids, "mp_ia": ia, "mp_oa": oa, "mp_rs": rs, "mp_out": outs}

    def device_statics(self, ctx, input_shapes, input_batches):
        kmax, outs = self._meta(ctx, input_shapes)
        return (kmax, int(-(-int(outs[:, 0].max()) // 8) * 8),
                int(-(-int(outs[:, 1].max()) // 8) * 8))

    def lower(self, dctx, inp: DeviceBatch):
        kmax, OH, OW = dctx.static(self)
        ids, ia, oa, rs = (dctx.param(self, k) for k in ("mp_ids", "mp_ia", "mp_oa", "mp_rs"))
        data = inp.data
        n, H, W, C = data.shape
        dev = data.device
        oy = torch.arange(OH, device=dev)[None, :]
        ox = torch.arange(OW, device=dev)[None, :]
        canvas = torch.zeros((n, OH, OW, C), dtype=torch.float32, device=dev)
        for j in range(kmax):
            sy = (oy - oa[:, j, 0:1] + ia[:, j, 0:1]).clamp(0, H - 1)         # [N, OH]
            sx = (ox - oa[:, j, 1:2] + ia[:, j, 1:2]).clamp(0, W - 1)         # [N, OW]
            gathered = data[ids[:, j, None, None], sy[:, :, None], sx[:, None, :]]
            rows = (oy >= oa[:, j, 0:1]) & (oy < oa[:, j, 0:1] + rs[:, j, 0:1])
            cols = (ox >= oa[:, j, 1:2]) & (ox < oa[:, j, 1:2] + rs[:, j, 1:2])
            valid = rows[:, :, None, None] & cols[:, None, :, None]
            canvas = torch.where(valid, gathered.to(torch.float32), canvas)
        dt = self.spec.GetArgument("dtype", None)
        out = saturate(canvas, to_torch_type(dt) if dt is not None else data.dtype)
        return [DeviceBatch(out, dctx.param(self, "mp_out"), inp.layout or "HWC")]


# ============================= JpegCompressionDistortion ============================================

# ITU-T T.81 Annex K quantization tables
_K1_LUMA = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], np.float32)
_K2_CHROMA = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
] + [[99] * 8] * 4, np.float32)


def _ijg_scale(tbl: np.ndarray, quality: torch.Tensor) -> torch.Tensor:
    """IJG quality scaling of an Annex K table: quality [N] -> [N, 8, 8]."""
    dev = quality.device
    q = torch.clamp(quality.to(torch.float32), 1.0, 100.0)[:, None, None]
    scale = torch.where(q < 50.0, torch.full_like(q, 5000.0) / q, 200.0 - 2.0 * q)
    t = torch.floor((torch.from_numpy(tbl).to(dev) * scale + 50.0) / _f32(100.0, dev))
    return torch.clamp(t, 1.0, 255.0)


def _int_sample(p: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(p), 0.0, 255.0)


def _dot8(terms):
    """The sum of 8 float32 products, each given exactly as float64, in the
    order of XLA's CPU dot: four accumulators (term j into j % 4), each a
    chain of fused multiply-adds (one rounding per term, emulated in float64),
    then (acc0 + acc1) + (acc2 + acc3) in float32. A coefficient next to a
    rounding boundary of round(coef / q) then falls on the reference's side."""
    accs = [None] * 4
    for j, p in enumerate(terms):
        a = j % 4
        accs[a] = p.to(torch.float32) if accs[a] is None else (accs[a].to(torch.float64)
                                                                + p).to(torch.float32)
    return (accs[0] + accs[1]) + (accs[2] + accs[3])


def _block_transform(left: torch.Tensor, x: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """left @ x @ right over the trailing [8, 8] blocks of x, left product
    first, each contraction summed as ``_dot8``."""
    lf, rt = left.to(torch.float64), right.to(torch.float64)
    x64 = x.to(torch.float64)
    t = _dot8(lf[:, j][:, None] * x64[..., j, None, :] for j in range(8))
    t64 = t.to(torch.float64)
    return _dot8(t64[..., :, k, None] * rt[k, :] for k in range(8))


@register_operator("JpegCompressionDistortion", "gpu")
class JpegDistortionGPU(Operator):
    """A baseline JPEG round trip in the DCT domain: edge-pad to 16; JPEG
    full-range RGB -> YCbCr rounded to integer samples (as libjpeg's encoder
    quantises before the DCT); 4:2:0 chroma as a rounded 2x2 mean; the 8x8
    DCT; quantise and dequantise with the IJG-scaled Annex K tables at each
    sample's ``quality``; the IDCT; fancy 2x chroma upsampling and
    YCbCr -> RGB, rounded and clipped."""

    def lower(self, dctx, inp: DeviceBatch):
        x = inp.data.to(torch.float32)  # [N, H, W, 3]
        n, H, W = x.shape[:3]
        dev = x.device
        quality = dctx.arg(self, "quality", 50.0)
        quality = (quality.to(device=dev, dtype=torch.float32).reshape(-1).expand(n)
                   if torch.is_tensor(quality)
                   else torch.full((n,), float(quality), dtype=torch.float32, device=dev))
        H16, W16 = -(-H // 16) * 16, -(-W // 16) * 16
        x = _pad_edge_to(x, H16, W16)
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = -0.16873589 * r - 0.33126411 * g + 0.5 * b + 128.0
        cr = 0.5 * r - 0.41868759 * g - 0.08131241 * b + 128.0
        y, cb, cr = _int_sample(y), _int_sample(cb), _int_sample(cr)

        def down2(c):
            return (c[:, 0::2, 0::2] + c[:, 1::2, 0::2] + c[:, 0::2, 1::2]
                    + c[:, 1::2, 1::2]) * 0.25

        cbd, crd = _int_sample(down2(cb)), _int_sample(down2(cr))
        T = torch.from_numpy(idct_matrix(8)).to(dev)  # orthonormal IDCT-II basis; T.T = DCT
        luma_q, chroma_q = _ijg_scale(_K1_LUMA, quality), _ijg_scale(_K2_CHROMA, quality)

        def roundtrip(plane, tbl):
            m, h, w = plane.shape
            blocks = plane.reshape(m, h // 8, 8, w // 8, 8).transpose(2, 3) - 128.0
            coef = _block_transform(T.T, blocks, T)
            tbl = tbl[:, None, None]
            qc = torch.round(coef / tbl) * tbl
            rec = _block_transform(T, qc, T.T) + 128.0
            return rec.transpose(2, 3).reshape(m, h, w)

        y2 = roundtrip(y, luma_q)
        cb2 = upsample2x(roundtrip(cbd, chroma_q))
        cr2 = upsample2x(roundtrip(crd, chroma_q))
        out = ycbcr_to_rgb(y2, cb2, cr2)[:, :H, :W]
        return [inp.with_data(saturate(out.to(torch.float32), inp.data.dtype))]


def _pad_edge_to(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Replicate the last row and column of the canvas [N, h, w, C] out to
    [N, H, W, C]."""
    rows = torch.arange(H, device=x.device).clamp(max=x.shape[1] - 1)
    cols = torch.arange(W, device=x.device).clamp(max=x.shape[2] - 1)
    return x.index_select(1, rows).index_select(2, cols)


# ====================================== CLAHE =======================================================


def _clahe_planes(p, h, w, tiles_x: int, tiles_y: int, clip: float, bins: int):
    """CLAHE of float planes p [N, H, W] in [0, 255] with valid extents h, w
    [N]: per-tile histograms (a scatter-add of ones, exact in float32), the
    clip limit scaled by the tile area with the excess spread evenly, CDF
    LUTs, and a bilinear blend of the four neighbouring tiles' LUTs. Cells
    outside the extent pass through."""
    n, H, W = p.shape
    dev = p.device
    T = tiles_y * tiles_x
    v = torch.clamp(torch.round(p * ((bins - 1) / 255.0)), 0, bins - 1).to(torch.int64)
    th = h.to(torch.float32)[:, None, None] / _f32(tiles_y, dev)        # [N, 1, 1]
    tw = w.to(torch.float32)[:, None, None] / _f32(tiles_x, dev)
    yy = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    ty = torch.clamp((yy / th).to(torch.int64), 0, tiles_y - 1)          # [N, H, 1]
    tx = torch.clamp((xx / tw).to(torch.int64), 0, tiles_x - 1)          # [N, 1, W]
    valid = (yy < h[:, None, None]) & (xx < w[:, None, None])
    base = torch.arange(n, device=dev)[:, None, None] * T
    ids = ((base + ty * tiles_x + tx) * bins + v).reshape(-1)
    hist = torch.zeros(n * T * bins, dtype=torch.float32, device=dev)
    hist.index_add_(0, ids, valid.reshape(-1).to(torch.float32))
    hist = hist.reshape(n, T, bins)
    area = th * tw                                                        # [N, 1, 1]
    lim = torch.clamp(clip * area / _f32(bins, dev), min=1.0)
    excess = torch.sum(torch.clamp(hist - lim, min=0.0), dim=2, keepdim=True)
    hist = torch.minimum(hist, lim) + excess / _f32(bins, dev)
    cdf = torch.cumsum(hist, dim=2)
    scale = _f32(255.0, dev) / torch.clamp(area, min=1.0)
    luts = torch.clamp(torch.round((cdf - cdf[:, :, :1]) * scale), 0, 255).reshape(-1)
    fy = torch.clamp(yy / th - 0.5, 0.0, tiles_y - 1.0)
    fx = torch.clamp(xx / tw - 0.5, 0.0, tiles_x - 1.0)
    y0, x0 = torch.floor(fy).to(torch.int64), torch.floor(fx).to(torch.int64)
    wy, wx = fy - y0, fx - x0
    y1, x1 = torch.clamp(y0 + 1, max=tiles_y - 1), torch.clamp(x0 + 1, max=tiles_x - 1)

    def lut_at(tyi, txi):
        return luts[(base + tyi * tiles_x + txi) * bins + v]

    out = ((1 - wy) * (1 - wx) * lut_at(y0, x0) + (1 - wy) * wx * lut_at(y0, x1)
           + wy * (1 - wx) * lut_at(y1, x0) + wy * wx * lut_at(y1, x1))
    return torch.where(valid, out, p)


@register_operator("experimental.Clahe", "gpu")
class ClaheGPU(Operator):
    """CLAHE of each plane, or of the BT.601 luma of an RGB image with the
    colour scaled by (eq + 1) / (luma + 1) (``luma_only``)."""

    def lower(self, dctx, inp: DeviceBatch):
        spec = self.spec
        bins = int(spec.GetArgument("bins"))
        if bins < 2 or bins & (bins - 1):
            raise ValueError(f"Clahe bins must be a power of 2, got {bins}")
        args = (int(spec.GetArgument("tiles_x")), int(spec.GetArgument("tiles_y")),
                float(spec.GetArgument("clip_limit")), bins)
        x = inp.data
        h, w = inp.extent(0), inp.extent(1)
        f = x.to(torch.float32)
        if x.dim() == 4 and x.shape[3] == 3:
            if not spec.GetArgument("luma_only"):
                out = torch.stack([_clahe_planes(f[..., c], h, w, *args) for c in range(3)], -1)
            else:
                luma = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
                eq = _clahe_planes(luma, h, w, *args)
                out = f * ((eq + 1.0) / (luma + 1.0))[..., None]
        elif x.dim() == 4:
            out = _clahe_planes(f[..., 0], h, w, *args)[..., None]
        else:
            out = _clahe_planes(f, h, w, *args)
        return [inp.with_data(saturate(out, x.dtype))]


# ====================================== Debayer =====================================================


def _tent3x3(v: torch.Tensor) -> torch.Tensor:
    """[N, H, W] correlated with [[1, 2, 1], [2, 4, 2], [1, 2, 1]] over a
    zero border, as shifted multiply-adds (exact on integer-valued input, so
    no convolution library and no TF32 reaches it)."""
    H, W = v.shape[1:]
    p = torch.nn.functional.pad(v, (1, 1, 1, 1))
    acc = None
    for i, wi in enumerate((1.0, 2.0, 1.0)):
        for j, wj in enumerate((1.0, 2.0, 1.0)):
            term = p[:, i:i + H, j:j + W] * (wi * wj)
            acc = term if acc is None else acc + term
    return acc


@register_operator("experimental.Debayer", "gpu")
class DebayerGPU(Operator):
    """Bilinear demosaic: each colour's samples, isolated by their 2x2-phase
    mask, interpolate with the 3x3 tent normalised by the mask's own
    response. The mask covers each sample's valid extent only, so a ragged
    sample's border reads no canvas padding (the reference's lowering counts
    the padding as samples, ROADMAP.md Queue 3)."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        raise_unserved(spec, ("algorithm",))

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        if input_shapes[0] is None:
            return None
        out = np.asarray(input_shapes[0])[:, :2]
        return [np.concatenate([out, np.full((out.shape[0], 1), 3, out.dtype)], 1)]

    def host_output_layouts(self, in_layouts):
        return ["HWC"]

    def lower(self, dctx, inp: DeviceBatch):
        by, bx = (int(v) for v in self.spec.GetArgument("blue_position"))
        x = inp.data[..., 0] if inp.data.dim() == 4 else inp.data
        f = x.to(torch.float32)
        n, H, W = f.shape
        dev = f.device
        iy = torch.arange(H, device=dev)[:, None] % 2
        ix = torch.arange(W, device=dev)[None, :] % 2
        blue = (iy == by) & (ix == bx)
        red = (iy == 1 - by) & (ix == 1 - bx)
        valid = _valid_hw(inp)

        def interp(mask):
            m = mask[None].expand(n, H, W)
            m = (m & valid if valid is not None else m).to(torch.float32)
            return _tent3x3(f * m) / torch.clamp(_tent3x3(m), min=1e-6)

        rgb = torch.stack([interp(red), interp(~(blue | red)), interp(blue)], -1)
        shapes = None
        if inp.shapes is not None:
            shapes = torch.cat([inp.shapes[:, :2], torch.full_like(inp.shapes[:, :1], 3)], 1)
        return [DeviceBatch(saturate(rgb, inp.data.dtype), shapes, "HWC")]
