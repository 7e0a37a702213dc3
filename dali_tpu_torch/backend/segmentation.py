"""segmentation.RandomMaskPixel, RandomObjectBBox and SelectMasks on the host
(counterpart of ``dali_tpu/backend/segmentation.py``): numpy and scipy's
``ndimage``, draw for draw with the reference (one ``ctx.rng(self, i)``
stream per sample)."""

from __future__ import annotations

import numpy as np

from .._schema import DALI_SCHEMA, ArgType, register_operator
from .base import BF16_WIDEN, Operator

DALI_SCHEMA("segmentation.RandomMaskPixel").DocStr(
    "Picks a random pixel coordinate, optionally from the foreground."
).NumInput(1).NumOutput(1).Devices("cpu").AddRandomSeedArg().AddOptionalArg(
    "foreground", ArgType.INT, "Sample only from pixels > threshold/value.", 0, tensor_ok=True
).AddOptionalArg(
    "value", ArgType.INT, "Exact foreground value to sample.", None, tensor_ok=True
).AddOptionalArg("threshold", ArgType.FLOAT, "Foreground threshold.", 0.0, tensor_ok=True)


@register_operator("segmentation.RandomMaskPixel", "cpu")
class RandomMaskPixel(Operator):
    reads_bfloat16 = BF16_WIDEN

    def run_sample(self, ctx, idx, mask):
        rng = ctx.rng(self, idx)
        fg = int(np.asarray(ctx.arg(self, "foreground", idx, 0)))
        if fg:
            value = ctx.arg(self, "value", idx, None)
            if value is not None:
                cand = np.argwhere(mask == int(np.asarray(value)))
            else:
                thr = float(np.asarray(ctx.arg(self, "threshold", idx, 0.0)))
                cand = np.argwhere(mask > thr)
            if len(cand):
                return cand[int(rng.integers(0, len(cand)))].astype(np.int64)
        coords = [int(rng.integers(0, d)) for d in mask.shape]
        return np.asarray(coords, np.int64)

    def output_layout(self, j, inputs):
        return ""


DALI_SCHEMA("segmentation.RandomObjectBBox").DocStr(
    "Bounding box of a randomly selected connected component / labeled object."
).NumInput(1).OutputFn(
    lambda spec: {"anchor_shape": 2, "start_end": 2, "box": 1}.get(spec.GetArgument("format", "anchor_shape"), 2)
    + (1 if spec.GetArgument("output_class", False) else 0)
).Devices("cpu").AddRandomSeedArg().AddOptionalArg(
    "format", ArgType.STRING, "'anchor_shape', 'start_end', or 'box'.", "anchor_shape"
).AddOptionalArg(
    "background", ArgType.INT, "Background label.", 0, tensor_ok=True
).AddOptionalArg(
    "classes", ArgType.INT_VEC, "Labels eligible for selection.", None
).AddOptionalArg(
    "foreground_prob", ArgType.FLOAT, "Probability of picking foreground.", 1.0, tensor_ok=True
).AddOptionalArg(
    "by_instance", ArgType.BOOL, "Treat connected components as instances.", False
).AddOptionalArg(
    "output_class", ArgType.BOOL, "Also output the selected class label.", False
).AddOptionalArg(
    "ignore_class", ArgType.BOOL,
    "Pick among ALL foreground blobs with equal probability instead of "
    "class-first (incompatible with classes/output_class).", False
).AddOptionalArg(
    "k_largest", ArgType.INT,
    "Consider only the k largest boxes (by volume) — of all blobs with "
    "ignore_class, else of the selected class.", None
).AddOptionalArg(
    "cache_objects", ArgType.BOOL,
    "Cache blob boxes keyed by a content hash of the input mask.", False)


@register_operator("segmentation.RandomObjectBBox", "cpu")
class RandomObjectBBox(Operator):
    reads_bfloat16 = BF16_WIDEN
    _box_cache = None  # content-hash -> blob boxes (cache_objects)

    def _blob_boxes(self, mask, bg, ignore_class):
        """All blob (start, end) boxes — per connected component across the
        whole foreground (ignore_class) or keyed by class label. Cached by a
        content hash when cache_objects=True."""
        from scipy import ndimage

        use_cache = self.spec.GetArgument("cache_objects", False)
        key = None
        if use_cache:
            import hashlib

            if self._box_cache is None:
                self._box_cache = {}
            key = (hashlib.sha256(np.ascontiguousarray(mask).tobytes()).digest(),
                   bg, ignore_class, bool(self.spec.GetArgument("by_instance", False)))
            hit = self._box_cache.get(key)
            if hit is not None:
                return hit
        result = {}
        if ignore_class:
            comp, n = ndimage.label(mask != bg)
            sl = ndimage.find_objects(comp)
            result[None] = [
                (np.array([s.start for s in box], np.int32),
                 np.array([s.stop for s in box], np.int32))
                for box in sl if box is not None]
        else:
            labels = np.unique(mask)
            for cls in labels[labels != bg]:
                bin_mask = mask == cls
                if self.spec.GetArgument("by_instance", False):
                    comp, n = ndimage.label(bin_mask)
                    sl = ndimage.find_objects(comp)
                    result[int(cls)] = [
                        (np.array([s.start for s in box], np.int32),
                         np.array([s.stop for s in box], np.int32))
                        for box in sl if box is not None]
                else:
                    idxs = np.argwhere(bin_mask)
                    result[int(cls)] = [(idxs.min(axis=0).astype(np.int32),
                                         (idxs.max(axis=0) + 1).astype(np.int32))]
        if use_cache:
            self._box_cache[key] = result
        return result

    @staticmethod
    def _k_largest(boxes, k):
        if k is None or len(boxes) <= k:
            return boxes
        vols = [float(np.prod((e - s).astype(np.int64))) for s, e in boxes]
        order = np.argsort(vols)[::-1][:k]
        return [boxes[j] for j in sorted(order)]

    def run_sample(self, ctx, idx, mask):
        rng = ctx.rng(self, idx)
        spec = self.spec
        bg = int(np.asarray(ctx.arg(self, "background", idx, 0)))
        fg_prob = float(np.asarray(ctx.arg(self, "foreground_prob", idx, 1.0)))
        fmt = spec.GetArgument("format", "anchor_shape")
        out_class = spec.GetArgument("output_class", False)
        ignore_class = spec.GetArgument("ignore_class", False)
        if ignore_class and (spec.GetArgument("classes", None) or out_class):
            raise ValueError(
                "segmentation.RandomObjectBBox: ignore_class is incompatible "
                "with classes/output_class")
        k_largest = spec.GetArgument("k_largest", None)
        nd = mask.ndim

        def full_box():
            start = np.zeros(nd, np.int32)
            end = np.asarray(mask.shape, np.int32)
            return start, end, bg

        if rng.random() > fg_prob:
            start, end, cls = full_box()
        elif ignore_class:
            boxes = self._k_largest(self._blob_boxes(mask, bg, True)[None], k_largest)
            if not boxes:
                start, end, cls = full_box()
            else:
                start, end = boxes[int(rng.integers(0, len(boxes)))]
                cls = bg
        else:
            classes = spec.GetArgument("classes", None)
            labels = np.unique(mask)
            labels = labels[labels != bg]
            if classes:
                labels = np.array([l for l in labels if l in set(classes)])
            if len(labels) == 0:
                start, end, cls = full_box()
            else:
                cls = int(labels[int(rng.integers(0, len(labels)))])
                needs_boxes = (self.spec.GetArgument("by_instance", False)
                               or k_largest is not None
                               or spec.GetArgument("cache_objects", False))
                if needs_boxes:
                    boxes = self._k_largest(
                        self._blob_boxes(mask, bg, False).get(cls, []), k_largest)
                    if not boxes:
                        start, end, cls = full_box()
                    elif self.spec.GetArgument("by_instance", False):
                        # keep the historical draw: integers(1, n+1)
                        pick = int(rng.integers(1, len(boxes) + 1)) - 1
                        start, end = boxes[pick]
                    else:
                        start, end = boxes[0]
                else:
                    idxs = np.argwhere(mask == cls)
                    start = idxs.min(axis=0).astype(np.int32)
                    end = (idxs.max(axis=0) + 1).astype(np.int32)
        outs = []
        if fmt == "anchor_shape":
            outs = [start, (end - start).astype(np.int32)]
        elif fmt == "start_end":
            outs = [start, end]
        else:
            outs = [np.concatenate([start, end]).astype(np.int32)]
        if out_class:
            outs.append(np.int32(cls))
        return tuple(outs)

    def output_layout(self, j, inputs):
        return ""


DALI_SCHEMA("segmentation.SelectMasks").DocStr(
    "Selects polygon masks by mask ids. Inputs: "
    "(mask_ids, polygons [n,3], vertices [m,2]); outputs filtered (polygons, vertices)."
).NumInput(3).NumOutput(2).Devices("cpu").AddOptionalArg(
    "reindex_masks", ArgType.BOOL, "Renumber selected masks densely.", False
)


@register_operator("segmentation.SelectMasks", "cpu")
class SelectMasks(Operator):
    def run_sample(self, ctx, idx, mask_ids, polygons, vertices):
        ids = np.asarray(mask_ids, np.int64).reshape(-1)
        polys = polygons.reshape(-1, 3)
        keep = np.isin(polys[:, 0], ids)
        sel = polys[keep].copy()
        out_v = []
        new_polys = []
        cursor = 0
        reindex = self.spec.GetArgument("reindex_masks", False)
        id_map = {int(v): i for i, v in enumerate(ids)} if reindex else None
        for p in sel:
            mid, v0, v1 = int(p[0]), int(p[1]), int(p[2])
            n = v1 - v0
            out_v.append(vertices[v0:v1])
            new_polys.append([id_map[mid] if reindex else mid, cursor, cursor + n])
            cursor += n
        if out_v:
            return np.asarray(new_polys, polys.dtype), np.concatenate(out_v, axis=0)
        return np.zeros((0, 3), polys.dtype), np.zeros((0,) + vertices.shape[1:], vertices.dtype)

    def output_layout(self, j, inputs):
        return ""
