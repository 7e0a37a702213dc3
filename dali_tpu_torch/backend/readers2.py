"""readers.COCO (counterpart of ``dali_tpu/backend/readers2.py``; the
reference's other readers of that file are not ported yet).

The annotation index is the reference's: category remapping, the size
threshold on ``[x, y, w, h]`` before any conversion, ``include_iscrowd``,
``skip_empty``, images in id order, and the preprocessed-annotation file (the
same pickled index, so either package loads the other's). Sharding,
shuffling and checkpoints come from ``BaseReader``, so a ``dali_tpu``
checkpoint of this reader resumes here at the same sample.
``pixelwise_masks`` raises: the reference rasterises polygons with
``cv2.fillPoly``, and the port has no cv2.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict

import numpy as np

from .._schema import DALI_SCHEMA, ArgType, register_operator
from .readers import BaseReader

PIXELWISE_NOT_PORTED = (
    "readers.COCO(pixelwise_masks=True) is not ported to dali_tpu_torch: it needs a cv2-free "
    "polygon fill bit-equal to cv2.fillPoly; see ROADMAP.md, Queue 1 item 0")


def _coco_outputs(spec):
    n = 3
    if spec.GetArgument("polygon_masks", False) or spec.GetArgument("masks", False):
        n += 2  # polygons [m, 3], vertices [v, 2]
    if spec.GetArgument("pixelwise_masks", False):
        n += 1  # mask [H, W, 1]
    if spec.GetArgument("image_ids", False):
        n += 1
    return n


DALI_SCHEMA("readers.COCO").DocStr(
    """Reads images + bboxes + labels from a COCO-format annotation file.
    Outputs (images, bboxes [n,4], labels [n] [, polygons [m,3],
    vertices [v,2]] [, pixelwise mask [H,W,1]] [, image_ids])."""
).NumInput(0).OutputFn(_coco_outputs).Devices("cpu").MakeReader().AddOptionalArg(
    "polygon_masks", ArgType.BOOL,
    "Also output segmentation polygons: rows of (mask_idx, start_vertex, end_vertex) + a "
    "shared [v, 2] vertex table.", False
).AddOptionalArg(
    "pixelwise_masks", ArgType.BOOL,
    "Also output a rasterized [H, W, 1] int32 mask of annotation indices (not ported).", False
).AddOptionalArg(
    "file_root", ArgType.STRING, "Directory with the images.", None
).AddOptionalArg(
    "annotations_file", ArgType.STRING, "COCO JSON annotations.", None
).AddOptionalArg(
    "ltrb", ArgType.BOOL, "Boxes as [l,t,r,b] instead of [x,y,w,h].", False
).AddOptionalArg(
    "ratio", ArgType.BOOL, "Boxes relative to image size.", False
).AddOptionalArg(
    "size_threshold", ArgType.FLOAT, "Drop boxes smaller than this.", 0.1
).AddOptionalArg(
    "skip_empty", ArgType.BOOL, "Skip images with no boxes.", False
).AddOptionalArg(
    "image_ids", ArgType.BOOL, "Also output image ids.", False
).AddOptionalArg(
    "avoid_class_remapping", ArgType.BOOL, "Keep original category ids.", False
).AddOptionalArg(
    "include_iscrowd", ArgType.BOOL, "Include annotations marked iscrowd=1.", True
).AddOptionalArg(
    "masks", ArgType.BOOL,
    "Deprecated alias of polygon_masks with the legacy polygon row format (mask_idx, "
    "start_coord, end_coord) = 2x the vertex indices.", False
).AddOptionalArg(
    "preprocessed_annotations", ArgType.STRING,
    "Directory with annotations pre-parsed by save_preprocessed_annotations.", None
).AddOptionalArg(
    "save_preprocessed_annotations", ArgType.BOOL,
    "Save the parsed annotation index for fast reloads.", False
).AddOptionalArg(
    "save_preprocessed_annotations_dir", ArgType.STRING,
    "Target directory for save_preprocessed_annotations.", None)


@register_operator("readers.COCO", "cpu")
class CocoReader(BaseReader):
    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        if spec.GetArgument("pixelwise_masks"):
            raise NotImplementedError(PIXELWISE_NOT_PORTED)
        self._index = None

    def _build_index(self):
        if self._index is not None:
            return
        spec = self.spec
        pre = spec.GetArgument("preprocessed_annotations", None)
        if pre:
            with open(os.path.join(pre, "annotations.pkl"), "rb") as f:
                self._index = pickle.load(f)
            return
        with open(spec.GetArgument("annotations_file")) as f:
            doc = json.load(f)
        root = spec.GetArgument("file_root") or ""
        images = {im["id"]: im for im in doc.get("images", [])}
        cats = sorted(c["id"] for c in doc.get("categories", []))
        if spec.GetArgument("avoid_class_remapping"):
            cat_map = {c: c for c in cats}
        else:
            cat_map = {c: i + 1 for i, c in enumerate(cats)}  # contiguous, 1-based
        anns_by_img: Dict[int, list] = {}
        thresh = spec.GetArgument("size_threshold")
        want_polys = spec.GetArgument("polygon_masks") or spec.GetArgument("masks")
        include_iscrowd = spec.GetArgument("include_iscrowd")
        for a in doc.get("annotations", []):
            if a.get("iscrowd", 0) and not include_iscrowd:
                continue
            x, y, w, h = a["bbox"]
            if w < thresh or h < thresh:
                continue
            seg = a.get("segmentation") if want_polys else None
            polys = [np.asarray(p, np.float32).reshape(-1, 2)
                     for p in (seg or []) if isinstance(p, list) and len(p) >= 6]
            anns_by_img.setdefault(a["image_id"], []).append(
                (x, y, w, h, cat_map[a["category_id"]], polys))
        self._index = []
        skip_empty = spec.GetArgument("skip_empty")
        for img_id in sorted(images):
            boxes = anns_by_img.get(img_id, [])
            if skip_empty and not boxes:
                continue
            im = images[img_id]
            self._index.append(
                (os.path.join(root, im["file_name"]), boxes, im["width"], im["height"], img_id))
        if spec.GetArgument("save_preprocessed_annotations"):
            out_dir = spec.GetArgument("save_preprocessed_annotations_dir", None)
            if not out_dir:
                raise ValueError(
                    "save_preprocessed_annotations requires save_preprocessed_annotations_dir")
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "annotations.pkl"), "wb") as f:
                pickle.dump(self._index, f)

    def _num_samples(self):
        return len(self._index)

    def _read_payload(self, index: int):
        spec = self.spec
        path, boxes, w, h, img_id = self._index[index]
        with open(path, "rb") as f:
            data = np.frombuffer(f.read(), np.uint8)
        if boxes:
            bb = np.array([b[:4] for b in boxes], np.float32)
            labels = np.array([b[4] for b in boxes], np.int32)
        else:
            bb = np.zeros((0, 4), np.float32)
            labels = np.zeros((0,), np.int32)
        if spec.GetArgument("ltrb"):
            bb = np.stack([bb[:, 0], bb[:, 1], bb[:, 0] + bb[:, 2], bb[:, 1] + bb[:, 3]], axis=1)
        ratio = spec.GetArgument("ratio")
        if ratio:
            bb = bb / np.array([w, h, w, h], np.float32)
        out = [data, bb, labels]
        legacy_masks = spec.GetArgument("masks")
        if spec.GetArgument("polygon_masks") or legacy_masks:
            # legacy `masks` rows count scalar coordinates (2x the vertex index)
            mult = 2 if legacy_masks else 1
            rows, verts = [], []
            for mi, b in enumerate(boxes):
                for poly in b[5]:
                    start = len(verts)
                    verts.extend(poly)
                    rows.append((mi, mult * start, mult * (start + len(poly))))
            polygons = (np.asarray(rows, np.int32).reshape(-1, 3)
                        if rows else np.zeros((0, 3), np.int32))
            vertices = (np.stack(verts).astype(np.float32)
                        if verts else np.zeros((0, 2), np.float32))
            if ratio and len(vertices):
                vertices = vertices / np.array([w, h], np.float32)
            out += [polygons, vertices]
        if spec.GetArgument("image_ids"):
            out.append(np.array([img_id], np.int32))
        return tuple(out)
