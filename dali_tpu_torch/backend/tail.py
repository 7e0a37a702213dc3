"""SSDRandomCrop on the host (counterpart of ``dali_tpu/backend/tail.py``
``SSDRandomCrop``; the reference's other operators of that file are not
ported yet)."""

from __future__ import annotations

import numpy as np

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import HostBatch
from .base import Operator
from .bbox import _iou

DALI_SCHEMA("SSDRandomCrop").DocStr(
    "Legacy fused SSD crop: an IoU-constrained window applied to the image, boxes and labels "
    "together."
).NumInput(3).NumOutput(3).Devices("cpu").AddRandomSeedArg().AddOptionalArg(
    "num_attempts", ArgType.INT, "Sampling attempts.", 1)

# the legacy operator's fixed menu; None keeps the whole image
SSD_THRESHOLDS = [None, 0.1, 0.3, 0.5, 0.7, 0.9]


@register_operator("SSDRandomCrop", "cpu")
class SSDRandomCrop(Operator):
    def run_batch(self, ctx, imgs: HostBatch, boxes: HostBatch, labels: HostBatch):
        rng = ctx.rng(self)
        attempts = max(self.spec.GetArgument("num_attempts"), 1)
        outs = [self._one(rng, attempts, imgs.samples[i],
                          boxes.samples[i].reshape(-1, 4).astype(np.float32),
                          labels.samples[i].reshape(-1)) for i in range(len(imgs))]
        return [HostBatch([o[0] for o in outs], layout=imgs.layout),
                HostBatch([o[1] for o in outs]), HostBatch([o[2] for o in outs])]

    @staticmethod
    def _one(rng, attempts, img, bxs, lbl):
        h, w = img.shape[:2]
        while True:
            thr = SSD_THRESHOLDS[int(rng.integers(0, len(SSD_THRESHOLDS)))]
            if thr is None:
                return img, bxs, lbl.astype(np.int32)
            for _ in range(attempts):
                cw = rng.uniform(0.3, 1.0)
                chh = rng.uniform(0.3, 1.0)
                if not (0.5 <= cw / chh <= 2.0):
                    continue
                x0 = rng.uniform(0, 1 - cw)
                y0 = rng.uniform(0, 1 - chh)
                win = np.array([x0, y0, x0 + cw, y0 + chh], np.float32)
                if bxs.shape[0]:
                    centers = (bxs[:, :2] + bxs[:, 2:]) / 2
                    inside = ((centers[:, 0] >= win[0]) & (centers[:, 0] <= win[2])
                              & (centers[:, 1] >= win[1]) & (centers[:, 1] <= win[3]))
                    if not inside.any() or (_iou(bxs, win)[inside] < thr).any():
                        continue
                    kept = bxs[inside].copy()
                    kept[:, [0, 2]] = (np.clip(kept[:, [0, 2]], win[0], win[2]) - win[0]) / cw
                    kept[:, [1, 3]] = (np.clip(kept[:, [1, 3]], win[1], win[3]) - win[1]) / chh
                    new_lbl = lbl[inside].astype(np.int32)
                else:
                    kept = bxs
                    new_lbl = lbl.astype(np.int32)
                ix0, iy0 = int(x0 * w), int(y0 * h)
                iw, ih = max(int(cw * w), 1), max(int(chh * h), 1)
                return np.ascontiguousarray(img[iy0:iy0 + ih, ix0:ix0 + iw]), kept, new_lbl
