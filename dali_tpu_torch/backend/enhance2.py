"""The schemas of experimental.Clahe and experimental.Debayer (counterpart
of those of ``dali_tpu/backend/enhance2.py``). Their gpu placements are in
``straggler_gpu.py``, as in the reference; their cpu placements are ROADMAP.md
Queue 1 item 5h, and OpticalFlow item 8."""

from __future__ import annotations

from .._schema import DALI_SCHEMA, ArgType

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
