"""experimental.Equalize on the device (counterpart of the gpu op of
``dali_tpu/backend/enhance.py``): the PIL-compatible equalization LUT built
from a histogram per sample and channel, over each sample's valid region."""

from __future__ import annotations

import torch

from .._schema import DALI_SCHEMA, register_operator
from ..batch import DeviceBatch
from .base import Operator

DALI_SCHEMA("experimental.Equalize").DocStr(
    "Per-channel histogram equalization (PIL-compatible LUT)."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu")


def equalize(x: torch.Tensor, valid) -> torch.Tensor:
    """uint8 [N, H, W, C] -> equalized uint8. ``valid`` [N, H, W] bool (or
    None) masks canvas padding out of the histograms.

    Per (sample, channel): step = (count - hist[255]) // 255; the LUT maps v
    to (step // 2 + cumsum(hist)[v - 1]) // step, clipped to 255; a channel
    with step 0 is left as it is."""
    n, H, W, C = x.shape
    xi = x.to(torch.int64)
    planes = xi.permute(0, 3, 1, 2).reshape(n * C, H * W)
    base = torch.arange(n * C, device=x.device)[:, None] * 256
    weight = (torch.ones_like(planes) if valid is None else
              valid.reshape(n, 1, H * W).expand(n, C, H * W).reshape(n * C, H * W).to(torch.int64))
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
    return out.reshape(n, C, H, W).permute(0, 2, 3, 1).to(torch.uint8).contiguous()


@register_operator("experimental.Equalize", "gpu")
class EqualizeGPU(Operator):
    def lower(self, dctx, inp: DeviceBatch):
        if inp.data.dim() != 4:
            raise NotImplementedError("experimental.Equalize(gpu) on sequences is not ported "
                                      "to dali_tpu_torch yet; see ROADMAP.md (Queue 1)")
        valid = None
        if inp.shapes is not None:
            H, W = inp.data.shape[1:3]
            rows = torch.arange(H, device=inp.data.device)[None, :, None]
            cols = torch.arange(W, device=inp.data.device)[None, None, :]
            valid = ((rows < inp.extent(0)[:, None, None])
                     & (cols < inp.extent(1)[:, None, None]))
        return [inp.with_data(equalize(inp.data, valid))]
