"""experimental.Clahe and experimental.Debayer on the host, and their
schemas (counterpart of ``dali_tpu/backend/enhance2.py``). Their gpu
placements are in ``straggler_gpu.py``, as in the reference; OpticalFlow is
ROADMAP.md Queue 1 item 8.

Clahe runs the port's copy of the reference's C++ (``native.clahe_f32``) on
the float plane: the luma (0.299 R + 0.587 G + 0.114 B) of an RGB image,
whose equalized ratio then scales every channel, or with ``luma_only=False``
each channel; integer types round half to even and saturate. Debayer's
bilinear algorithm is the reference's C++ (uint8, uint16), its edge-aware one
a copy of OpenCV's ``Bayer2RGB_EdgeAware_T``, which the reference calls
through cv2 (``native.debayer_edge_aware``).
"""

from __future__ import annotations

import numpy as np

from .. import native
from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..kernels.host_resample import saturate
from .base import Operator, SamplePool

DALI_SCHEMA("experimental.Clahe").DocStr(
    "Contrast-limited adaptive histogram equalization on the luma channel."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "clip_limit", ArgType.FLOAT, "Contrast clip limit.", 4.0
).AddOptionalArg("tiles_x", ArgType.INT, "Grid tiles (x).", 8).AddOptionalArg(
    "tiles_y", ArgType.INT, "Grid tiles (y).", 8
).AddOptionalArg(
    "bins", ArgType.INT, "Histogram bins (a power of 2).", 256
).AddOptionalArg(
    "luma_only", ArgType.BOOL,
    "RGB inputs: equalize the luminance channel and scale chroma (True, default) or "
    "equalize each channel independently (False).", True)

DALI_SCHEMA("experimental.Debayer").DocStr(
    "Bayer -> RGB demosaicing (bilinear)."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "blue_position", ArgType.INT_VEC, "Position of the blue sample in the 2x2 tile (y, x).",
    [0, 0]
).AddOptionalArg("algorithm", ArgType.STRING, "'bilinear_npp' (compat) / 'edge_aware'.",
                 "bilinear_npp")


@register_operator("experimental.Clahe", "cpu")
class ClaheCPU(SamplePool, Operator):
    def run_sample(self, ctx, idx, img):
        g = self.spec.GetArgument
        f = img.astype(np.float32)

        def plane(p):
            return native.clahe_f32(p, float(g("clip_limit")), int(g("tiles_x")),
                                    int(g("tiles_y")), int(g("bins")))

        if img.ndim == 3 and img.shape[-1] == 3:
            if not g("luma_only"):
                out = np.stack([plane(f[..., c]) for c in range(3)], -1)
            else:
                luma = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
                ratio = (plane(luma) + 1.0) / (luma + 1.0)
                out = f * ratio[..., None]
        else:
            eq = plane(f[..., 0] if f.ndim == 3 else f)
            out = eq[..., None] if f.ndim == 3 else eq
        return saturate(out, img.dtype)


# blue at (y, x) of each 2x2 tile -> OpenCV's (start_with_green, blue) of the
# pattern the reference names through cv2's Bayer*2RGB_EA codes
_EA_PATTERN = {(0, 0): (0, 1), (0, 1): (1, 1), (1, 0): (1, 0), (1, 1): (0, 0)}


@register_operator("experimental.Debayer", "cpu")
class DebayerCPU(SamplePool, Operator):
    """uint8 and uint16 mosaics [H, W] or [H, W, 1] to RGB [H, W, 3]."""

    def run_sample(self, ctx, idx, raw):
        bp = tuple(int(v) for v in self.spec.GetArgument("blue_position"))
        x = raw[..., 0] if raw.ndim == 3 else raw
        if x.dtype not in (np.uint8, np.uint16) or bp not in _EA_PATTERN:
            raise ValueError(f"experimental.Debayer: a {x.dtype} mosaic with blue at {bp} is not "
                             "supported (uint8 or uint16, blue_position in {0, 1}^2)")
        if self.spec.GetArgument("algorithm") == "edge_aware":
            return native.debayer_edge_aware(x, *_EA_PATTERN[bp])
        return native.debayer_bilinear(x, bp[0], bp[1])

    def output_layout(self, j, inputs):
        return "HWC"
