"""experimental.Equalize on the device and the host (counterpart of
``dali_tpu/backend/enhance.py``): the PIL-compatible equalization LUT built
from a histogram per sample and channel, over each sample's valid region on
the device, over the whole sample (a sequence's frames together) on the
host."""

from __future__ import annotations

import numpy as np
import torch

from .._schema import DALI_SCHEMA, register_operator
from ..batch import DeviceBatch
from .base import Operator, SamplePool

DALI_SCHEMA("experimental.Equalize").DocStr(
    "Per-channel histogram equalization (PIL-compatible LUT)."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu")


def equalize(x: torch.Tensor, valid) -> torch.Tensor:
    """uint8 [N, ..., C] -> equalized uint8, one histogram per sample and
    channel over all of the sample (a sequence's frames or a volume's slices
    together). ``valid`` [N, ...] bool (or None) masks canvas padding out of
    the histograms.

    Per (sample, channel): step = (count - hist[255]) // 255; the LUT maps v
    to (step // 2 + cumsum(hist)[v - 1]) // step, clipped to 255; a channel
    with step 0 is left as it is."""
    n, C = x.shape[0], x.shape[-1]
    xi = x.to(torch.int64).reshape(n, -1, C)
    P = xi.shape[1]
    planes = xi.permute(0, 2, 1).reshape(n * C, P)
    base = torch.arange(n * C, device=x.device)[:, None] * 256
    weight = (torch.ones_like(planes) if valid is None else
              valid.reshape(n, 1, P).expand(n, C, P).reshape(n * C, P).to(torch.int64))
    hist = torch.zeros(n * C * 256, dtype=torch.int64, device=x.device)
    hist.index_add_(0, (planes + base).reshape(-1), weight.reshape(-1))
    hist = hist.reshape(n * C, 256)
    csum = torch.cumsum(hist, dim=1)
    step = (csum[:, -1] - hist[:, 255]) // 255
    shifted = torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]], dim=1) + (step // 2)[:, None]
    lut = torch.clamp(torch.div(shifted, torch.clamp(step, min=1)[:, None],
                                rounding_mode="floor"), 0, 255)
    mapped = torch.gather(lut, 1, planes)
    out = torch.where((step == 0)[:, None], planes, mapped)
    return out.reshape(n, C, P).permute(0, 2, 1).reshape(x.shape).to(torch.uint8).contiguous()


@register_operator("experimental.Equalize", "gpu")
class EqualizeGPU(Operator):
    """HWC images, ragged or not, and uniform FHWC sequences and DHWC volumes.
    A ragged batch of sequences or volumes raises: dali_tpu's gpu op fails on
    it (its padding mask is built from the extents of the first two axes,
    ROADMAP.md Queue 3), so there is no reference to hold the port against."""

    def lower(self, dctx, inp: DeviceBatch):
        valid = None
        if inp.shapes is not None:
            if inp.data.dim() != 4:
                raise NotImplementedError(
                    "experimental.Equalize(gpu) on a ragged batch of sequences or volumes: "
                    "dali_tpu's gpu op fails there (a broadcast ValueError: its padding "
                    "mask spans the first two axes only; ROADMAP.md Queue 3); use a uniform "
                    "batch or device='cpu'")
            H, W = inp.data.shape[1:3]
            rows = torch.arange(H, device=inp.data.device)[None, :, None]
            cols = torch.arange(W, device=inp.data.device)[None, None, :]
            valid = ((rows < inp.extent(0)[:, None, None])
                     & (cols < inp.extent(1)[:, None, None]))
        return [inp.with_data(equalize(inp.data, valid))]


def equalize_lut_np(channel: np.ndarray) -> np.ndarray:
    """The LUT of one channel: step = (count - hist[255]) // 255, entry v =
    (step // 2 + cumsum(hist)[v - 1]) // step clipped to 255; the identity
    where step is 0."""
    hist = np.bincount(channel.reshape(-1), minlength=256)
    step = (hist.sum() - hist[255]) // 255
    if step == 0:
        return np.arange(256, dtype=np.uint8)
    lut = (np.concatenate([[0], np.cumsum(hist)[:-1]]) + step // 2) // step
    return np.clip(lut, 0, 255).astype(np.uint8)


@register_operator("experimental.Equalize", "cpu")
class EqualizeCPU(SamplePool, Operator):
    def run_sample(self, ctx, idx, img):
        out = np.empty_like(img)
        for c in range(img.shape[-1]):
            out[..., c] = equalize_lut_np(img[..., c])[img[..., c]]
        return out
