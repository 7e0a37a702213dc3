"""experimental.Remap on the device and the host (counterpart of that operator
of ``dali_tpu/backend/misc2.py``). The host placement, where the reference
calls cv2.remap (a constant border of 0, the maps taken as "center"
coordinates), runs the port's C++ (``native.remap``, equal to cv2 5.0).

out(x, y) = in(mapx(x, y), mapy(x, y)), bilinear or nearest, over the padded
canvas with a fill of 0 outside it. ``pixel_origin="corner"`` (the default)
addresses pixel (i, j) at (j + 0.5, i + 0.5), so the maps shift by half a
pixel before the gather; ``"center"`` addresses it at (j, i). The reference's
lowering gathers every map as ``"center"`` (ROADMAP.md Queue 3).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch
from ..types import DALIInterpType
from .base import Operator, SamplePool, raise_unserved
from .distortion import bilinear_gather
from .random import saturate

DALI_SCHEMA("experimental.Remap").DocStr(
    "Generic coordinate remap: out(x, y) = in(mapx(x, y), mapy(x, y))."
).NumInput(3).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "interp", ArgType.INTERP_TYPE, "Interpolation.", None
).AddOptionalArg("pixel_origin", ArgType.STRING, "'corner' or 'center'.", "corner")


@register_operator("experimental.Remap", "gpu")
class RemapGPU(Operator):
    def lower(self, dctx, img_b: DeviceBatch, mapx_b: DeviceBatch, mapy_b: DeviceBatch):
        img = img_b.data
        mx, my = mapx_b.data.to(torch.float32), mapy_b.data.to(torch.float32)
        if mx.dim() == 4 and mx.shape[-1] == 1:
            mx, my = mx[..., 0], my[..., 0]
        origin = self.spec.GetArgument("pixel_origin")
        if origin not in ("corner", "center"):
            raise ValueError(f"experimental.Remap: pixel_origin must be 'corner' or 'center', "
                             f"got {origin!r}")
        if origin == "corner":
            mx, my = mx - 0.5, my - 0.5
        if self.spec.GetArgument("interp") == DALIInterpType.INTERP_NN:
            mx, my = torch.round(mx), torch.round(my)
        n, H, W = img.shape[:3]
        eh = torch.full((n,), H, dtype=torch.int32, device=img.device)
        ew = torch.full((n,), W, dtype=torch.int32, device=img.device)
        out = bilinear_gather(img, mx, my, 0.0, eh, ew)
        return [DeviceBatch(saturate(out, img.dtype), None, img_b.layout)]


@register_operator("experimental.Remap", "cpu")
class RemapCPU(SamplePool, Operator):
    """As cv2.remap returns it: one channel comes out [H, W]."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        raise_unserved(spec, ("pixel_origin",))  # the reference's cpu op reads none

    def run_sample(self, ctx, idx, img, mapx, mapy):
        mx, my = (np.asarray(m, np.float32) for m in (mapx, mapy))
        mx, my = (m[..., 0] if m.ndim == 3 and m.shape[-1] == 1 else m for m in (mx, my))
        out = native.remap(img if img.ndim == 3 else img[:, :, None], mx, my,
                           self.spec.GetArgument("interp") == DALIInterpType.INTERP_NN)
        return out[:, :, 0] if out.shape[2] == 1 else out
