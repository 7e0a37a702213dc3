"""Coefficient-wire decode on the device (plain PyTorch).

Counterpart of ``dali_tpu/executor.py`` ``_decode_nib_stream``,
``_decode_esc16_stream``, ``_unflatten_boundary``, ``_zz_sel_perm`` and
``_unsparse_boundary``: the hybrid-JPEG host half ships escape-packed int8 DC
planes and a sparse AC wire (per-block nonzero bitmaps + nibble-packed
values); these functions rebuild the dense padded DCT canvases. Positions are
self-describing (prefix sums of escape markers and of bitmap popcounts), so
the host ships no offsets beyond one per sample. PyTorch has no popcount, so
it is a 65536-entry lookup table. No Pallas kernel exists for this stage; its
hand kernel is queued in ROADMAP.md (B1).

``yuv420_boundary`` is the counterpart of ``_yuv420_boundary``: the video
readers' planar 4:2:0 wire rebuilt into padded RGB frames on the device,
with the host decoder's integer BT.601 arithmetic. The reference computes
this stage in ``jnp`` too, with no Pallas kernel.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _popcount_lut(device: torch.device) -> torch.Tensor:
    v = np.arange(1 << 16, dtype=np.uint32)
    cnt = np.zeros_like(v)
    for b in range(16):
        cnt += (v >> b) & 1
    return torch.from_numpy(cnt.astype(np.int32)).to(device)


def popcount16(x: torch.Tensor) -> torch.Tensor:
    """Bit count of the low 16 bits of an int32 tensor."""
    return _popcount_lut(x.device)[(x & 0xFFFF).long()]


def _gather_clipped(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if src.numel() == 0:
        return torch.zeros(idx.shape, dtype=src.dtype, device=src.device)
    return src[idx.clamp(0, src.numel() - 1).long()]


def decode_nib_stream(nibs: torch.Tensor, esc: torch.Tensor) -> torch.Tensor:
    """uint8 nibble pairs (little nibble first) -> int8 values; the code -8
    pulls the next byte of ``esc`` (sparse_pack.cc nib_pack_i8)."""
    n32 = nibs.to(torch.int32)
    nib = torch.stack([n32 & 0xF, (n32 >> 4) & 0xF], dim=1).reshape(-1)
    v = (nib ^ 8) - 8
    is_esc = v == -8
    ecnt = is_esc.to(torch.int32)
    prefix = torch.cumsum(ecnt, 0) - ecnt
    ev = _gather_clipped(esc, prefix).to(torch.int32)
    return torch.where(is_esc, ev, v).to(torch.int8)


def decode_esc16_stream(dc8: torch.Tensor, esc: torch.Tensor) -> torch.Tensor:
    """int8 stream -> int16; the marker -128 pulls the next int16 of ``esc``
    (sparse_pack.cc esc_pack_i16)."""
    v = dc8.to(torch.int32)
    is_esc = v == -128
    ecnt = is_esc.to(torch.int32)
    prefix = torch.cumsum(ecnt, 0) - ecnt
    ev = _gather_clipped(esc, prefix).to(torch.int32)
    return torch.where(is_esc, ev, v).to(torch.int16)


def _flat_index(offsets, shapes, canvas):
    """Row-major per-sample flat index and validity over [N, *canvas]."""
    n = shapes.shape[0]
    nd = len(canvas)
    bshape = (n,) + (1,) * nd
    shapes = shapes.to(torch.int64)
    idx = offsets.to(torch.int64).reshape(bshape)
    valid = torch.ones((n,) + tuple(canvas), dtype=torch.bool, device=shapes.device)
    stride = torch.ones((n,), dtype=torch.int64, device=shapes.device)
    for d in range(nd - 1, -1, -1):
        view = [1] * (nd + 1)
        view[d + 1] = canvas[d]
        coord = torch.arange(canvas[d], device=shapes.device).reshape(view)
        idx = idx + coord * stride.reshape(bshape)
        valid = valid & (coord < shapes[:, d].reshape(bshape))
        stride = stride * shapes[:, d]
    return idx, valid


def unflatten_boundary(flat, offsets, shapes, canvas: Sequence[int]) -> torch.Tensor:
    """Scatter a flat-packed wire (each sample dense at its offset) onto the
    padded canvas [N, *canvas]; padding is zero."""
    idx, valid = _flat_index(offsets, shapes, tuple(int(c) for c in canvas))
    out = _gather_clipped(flat, idx)
    return torch.where(valid, out, torch.zeros((), dtype=flat.dtype, device=flat.device))


def zz_sel_perm(nac: int):
    """Mask bit b -> slot (r*k + c - 1) of the k*k-1 zigzag-ordered
    selection (the wire convention of the pack-emit decoder)."""
    k = 1
    while k * k - 1 < nac:
        k += 1
    perm, r, c = [], 0, 0
    for z in range(64):
        if z > 0 and r < k and c < k:
            perm.append(r * k + c - 1)
        if (r + c) % 2 == 0:
            if c == 7:
                r += 1
            elif r == 0:
                c += 1
            else:
                r, c = r - 1, c + 1
        else:
            if r == 7:
                c += 1
            elif c == 0:
                r += 1
            else:
                r, c = r + 1, c - 1
    return perm


def unsparse_boundary(mask, vals, offsets, shapes, canvas: Sequence[int]) -> torch.Tensor:
    """Dense AC canvas [N, *block_canvas, nac] int8 from the sparse wire.

    mask: per-block bitmaps (int32 holding uint16, flat in the DC plane's
    block order); vals: int8 nonzeros in that order; offsets [N] per-sample
    block offsets; shapes [N, nd] per-sample dense dims (last = nac). Value p
    of block b sits at exclusive_cumsum(popcount(mask))[b] + p."""
    canvas = tuple(int(c) for c in canvas)
    nac = canvas[-1]
    bidx, valid = _flat_index(offsets, shapes[:, :-1], canvas[:-1])
    bidx = bidx.clamp(0, mask.numel() - 1)
    mask = mask.to(torch.int32) & 0xFFFF
    nnz = popcount16(mask)
    starts = torch.cumsum(nnz, 0) - nnz
    m_c = mask[bidx].unsqueeze(-1)
    s_c = starts[bidx].unsqueeze(-1)
    j = torch.arange(nac, dtype=torch.int32, device=mask.device)
    has = (m_c >> j) & 1
    prefix = popcount16(m_c & ((1 << j) - 1))
    v = _gather_clipped(vals, s_c + prefix)
    keep = (has == 1) & valid.unsqueeze(-1)
    out_zz = torch.where(keep, v, torch.zeros((), dtype=vals.dtype, device=vals.device))
    b_of_slot = torch.from_numpy(np.argsort(np.asarray(zz_sel_perm(nac)))).to(mask.device)
    return out_zz.index_select(-1, b_of_slot)


def yuv420_boundary(y, u, v, offsets, shapes, canvas: Sequence[int],
                    full_range: bool) -> torch.Tensor:
    """Padded RGB frames [N, F, H, W, 3] uint8 from the planar 4:2:0 wire.

    y/u/v: flat uint8 planes, each sample dense at its offset; offsets
    [2, N] (luma, chroma element offsets); shapes [N, 4] logical (F, h, w,
    3), chroma (F, ceil(h/2), ceil(w/2)); canvas (F, H, W, 3). Chroma is
    repeated to the nearest sample (pixel x reads chroma x // 2) and the
    BT.601 matrix is the host's integer arithmetic (``video_decode.cc``
    ``picture_to_rgb``): limited range R = (298 (Y - 16) + 409 (V - 128) +
    128) >> 8 and its G and B, full range R = (256 Y + 359 (V - 128) + 128)
    >> 8 and its G and B, clipped to [0, 255]. The padding is zero."""
    f_, h_, w_ = (int(c) for c in canvas[:3])
    ch, cw = (h_ + 1) // 2, (w_ + 1) // 2
    yshapes = shapes[:, :3].to(torch.int64)
    yp = unflatten_boundary(y, offsets[0], yshapes, (f_, h_, w_))
    cshapes = torch.stack([yshapes[:, 0], (yshapes[:, 1] + 1) // 2, (yshapes[:, 2] + 1) // 2],
                          dim=1)
    up = unflatten_boundary(u, offsets[1], cshapes, (f_, ch, cw))
    vp = unflatten_boundary(v, offsets[1], cshapes, (f_, ch, cw))
    rows = torch.arange(h_, device=y.device) // 2
    cols = torch.arange(w_, device=y.device) // 2
    d = up.index_select(2, rows).index_select(3, cols).to(torch.int32) - 128
    e = vp.index_select(2, rows).index_select(3, cols).to(torch.int32) - 128
    if full_range:
        c = 256 * yp.to(torch.int32)
        r = (c + 359 * e + 128) >> 8
        g = (c - 88 * d - 183 * e + 128) >> 8
        b = (c + 454 * d + 128) >> 8
    else:
        c = 298 * (yp.to(torch.int32) - 16)
        r = (c + 409 * e + 128) >> 8
        g = (c - 100 * d - 208 * e + 128) >> 8
        b = (c + 516 * d + 128) >> 8
    rgb = torch.stack([r, g, b], dim=-1).clamp_(0, 255).to(torch.uint8)
    _, valid = _flat_index(offsets[0], yshapes, (f_, h_, w_))
    return torch.where(valid.unsqueeze(-1), rgb, torch.zeros((), dtype=torch.uint8,
                                                               device=rgb.device))
