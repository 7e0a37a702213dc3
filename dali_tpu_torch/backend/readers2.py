"""readers.TFRecord, Webdataset, Numpy, COCO and Sequence (counterpart of
``dali_tpu/backend/readers2.py``).

Each index is the reference's, entry for entry: TFRecord records from the
``tfrecord2idx`` files or a scan, Webdataset samples grouped by basename in
tar order (``wds2idx`` files or a scan, the ``ext`` alternatives and
``missing_component_behavior``), Numpy files by ``files``/``file_list``/
``file_root`` and ``file_filter``, COCO's annotation index (category
remapping, the size threshold on ``[x, y, w, h]`` before any conversion,
``include_iscrowd``, ``skip_empty``, images in id order, the
preprocessed-annotation file, the same pickled index, so either package
loads the other's), Sequence windows over sorted frame directories.
Sharding, shuffling and checkpoints come from ``BaseReader``, so a
``dali_tpu`` checkpoint of any of them resumes here at the same sample.
``s3://`` paths go through the port's SigV4 client (``_s3.py``). The mixed
Numpy reader (``device="gpu"``) reads on the host and its batch crosses the
host-device boundary like any mixed op's output. COCO's ``pixelwise_masks``
fill each polygon with ``polyfill.fill_poly``, bit-equal to the
reference's ``cv2.fillPoly``.
"""

from __future__ import annotations

import fnmatch
import io
import json
import mmap
import os
import pickle
import tarfile
from typing import Dict, List

import numpy as np

from .. import tfrecord as tfrec
from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..polyfill import fill_poly
from .readers import BaseReader


def _open_maybe_s3(path):
    """A binary reader of a local path or an s3:// URI (the object read
    whole)."""
    if isinstance(path, str) and path.startswith("s3://"):
        from .. import _s3

        return io.BytesIO(_s3.read_bytes(path))
    return open(path, "rb")


class RecordFiles:
    """A reader's files, opened at first read and kept until ``close``: each
    mapped once, a read being a slice of its map, or, with
    ``dont_use_mmap``, read with ``pread`` (one system call per read; an
    empty or unmappable file is read so too)."""

    def __init__(self, paths: List[str], use_mmap: bool):
        self.paths = paths
        self.use_mmap = use_mmap
        self._open: Dict[int, object] = {}  # file index -> mmap or descriptor

    def read(self, fi: int, size: int, offset: int) -> bytes:
        src = self._open.get(fi)
        if src is None:
            fd = os.open(self.paths[fi], os.O_RDONLY)
            src = fd
            if self.use_mmap:
                try:
                    src = mmap.mmap(fd, 0, access=mmap.ACCESS_READ)
                    os.close(fd)
                except (ValueError, OSError):
                    pass
            self._open[fi] = src
        if isinstance(src, mmap.mmap):
            return src[offset:offset + size]
        return os.pread(src, size, offset)

    def close(self):
        for src in self._open.values():
            if isinstance(src, mmap.mmap):
                src.close()
            else:
                os.close(src)
        self._open = {}


# ====================================== readers.TFRecord ==========================================

DALI_SCHEMA("readers.TFRecord").DocStr(
    """Reads tf.Example records. ``features`` maps names to
    ``dali_tpu_torch.tfrecord.FixedLenFeature/VarLenFeature``; one output per
    feature, ordered by the dict (``fn.readers.tfrecord`` returns them as a
    dict)."""
).NumInput(0).OutputFn(lambda spec: len(spec._extra.get("_features", {}))).Devices(
    "cpu"
).MakeReader().AddOptionalArg(
    "path", ArgType.STRING_VEC, "TFRecord file path(s).", None
).AddOptionalArg(
    "index_path", ArgType.STRING_VEC, "Index file path(s) (tfrecord2idx).", None
).AddOptionalArg("features", ArgType.PYTHON_OBJECT, "Feature schema dict.", None)


@register_operator("readers.TFRecord", "cpu")
class TFRecordReader(BaseReader):
    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._features: Dict[str, tfrec.Feature] = (spec._extra.get("_features")
                                                    or spec.GetArgument("features", None))
        if not self._features:
            raise ValueError("readers.tfrecord requires `features`")
        self._entries = None  # [(file index, offset, size)]
        self._files = None

    def _build_index(self):
        if self._entries is not None:
            return
        paths = self.spec.GetArgument("path")
        index_paths = self.spec.GetArgument("index_path", None)
        self._files = RecordFiles(paths, not self.spec.GetArgument("dont_use_mmap"))
        self._entries = []
        for fi, p in enumerate(paths):
            if index_paths and fi < len(index_paths) and os.path.exists(index_paths[fi]):
                with open(index_paths[fi]) as f:
                    for line in f:
                        off, size = line.split()
                        self._entries.append((fi, int(off), int(size)))
            else:
                self._entries.extend((fi, off, size) for off, size in tfrec.build_index(p))

    def _num_samples(self):
        return len(self._entries)

    def _read_payload(self, index: int):
        fi, off, _ = self._entries[index]
        length = int.from_bytes(self._files.read(fi, 8, off), "little")
        parsed = tfrec.parse_example(self._files.read(fi, length, off + 12))
        outs = []
        for name, feat in self._features.items():
            v = parsed.get(name)
            if v is None:
                v = feat.default_value if feat.default_value is not None else b""
            if feat.dtype == tfrec.string:
                raw = v[0] if isinstance(v, list) else v
                if isinstance(raw, (bytes, bytearray)):
                    outs.append(np.frombuffer(raw, np.uint8).copy())
                else:
                    outs.append(np.asarray(raw))
            else:
                arr = np.asarray(v, np.int64 if feat.dtype == tfrec.int64 else np.float32)
                if feat.shape is not None and len(feat.shape) and -1 not in feat.shape:
                    arr = arr.reshape(feat.shape)
                elif feat.shape == ():
                    arr = arr.reshape(()) if arr.size == 1 else arr
                outs.append(arr)
        return tuple(outs)

    def close(self):
        if self._files is not None:
            self._files.close()


# ====================================== readers.Webdataset ========================================

DALI_SCHEMA("readers.Webdataset").DocStr(
    """Reads webdataset tar archives: components grouped by basename, one
    output per extension in ``ext``."""
).NumInput(0).OutputFn(
    lambda spec: len(spec.GetArgument("ext")) if isinstance(spec.GetArgument("ext"), list) else 1
).Devices("cpu").MakeReader().AddArg(
    "paths", ArgType.STRING_VEC, "Tar archive path(s)."
).AddOptionalArg(
    "index_paths", ArgType.STRING_VEC, "Index files (wds2idx).", None
).AddOptionalArg(
    "ext", ArgType.STRING_VEC,
    "Component extensions, one output each; an entry may be a ';'-delimited set of "
    "acceptable alternatives (e.g. 'jpg;jpeg'), resolved to the first matching component "
    "in tar order.", ["jpg"]
).AddOptionalArg(
    "missing_component_behavior", ArgType.STRING, "'error'|'skip'|'empty'.", "empty"
).AddOptionalArg(
    "dtypes", ArgType.PYTHON_OBJECT,
    "Output dtype per ext entry (DALIDataType or numpy dtype); component bytes are "
    "reinterpreted as that type, default UINT8.", None
).AddOptionalArg(
    "case_sensitive_extensions", ArgType.BOOL,
    "Match component extensions case-sensitively (False matches JPG/jpg alike).", True)


def _resolve_wds_ext(comp, entry):
    """The component an ``ext`` entry names: the first, in tar order, of its
    ';'-delimited alternatives; None if the sample has none of them."""
    alts = set(entry.split(";"))
    for k in comp:
        if k in alts:
            return k
    return None


@register_operator("readers.Webdataset", "cpu")
class WebdatasetReader(BaseReader):
    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._samples = None  # [(file index, {ext: (offset, size)})]
        self._paths = None
        self._files = None

    def _exts(self):
        exts = self.spec.GetArgument("ext")
        if not self.spec.GetArgument("case_sensitive_extensions"):
            exts = [e.lower() for e in exts]
        return exts

    def _build_index(self):
        if self._samples is not None:
            return
        paths = self.spec.GetArgument("paths")
        self._paths = list(paths)
        self._files = RecordFiles(self._paths, not self.spec.GetArgument("dont_use_mmap"))
        exts = self._exts()
        behavior = self.spec.GetArgument("missing_component_behavior")
        index_paths = self.spec.GetArgument("index_paths", None)
        self._samples = []
        for fi, p in enumerate(paths):
            groups: Dict[str, Dict[str, tuple]] = {}
            if index_paths and fi < len(index_paths):
                # wds2idx lines, 'ext offset size basename' (the basename may
                # hold spaces); an s3:// shard is then never downloaded whole
                with open(index_paths[fi]) as f:
                    for lineno, line in enumerate(f, 1):
                        if not line.strip():
                            continue
                        parts = line.rstrip("\n").split(" ", 3)
                        if len(parts) != 4:
                            raise ValueError(
                                f"{index_paths[fi]}:{lineno}: malformed wds2idx "
                                f"line (expected 'ext offset size basename')")
                        ext, off, size, base = parts
                        groups.setdefault(base, {})[ext] = (int(off), int(size))
            else:
                with _open_maybe_s3(p) as fobj, tarfile.open(fileobj=fobj, mode="r") as tar:
                    for m in tar:
                        if m.isfile():
                            base, _, ext = m.name.partition(".")
                            groups.setdefault(base, {})[ext] = (m.offset_data, m.size)
            if not self.spec.GetArgument("case_sensitive_extensions"):
                # the first component in tar order wins where case folding
                # merges two
                folded = {}
                for base, comp in groups.items():
                    fcomp = folded[base] = {}
                    for e, v in comp.items():
                        fcomp.setdefault(e.lower(), v)
                groups = folded
            for base, comp in groups.items():
                missing = any(_resolve_wds_ext(comp, e) is None for e in exts)
                if behavior == "skip" and missing:
                    continue
                if behavior == "error" and missing:
                    raise ValueError(f"Sample '{base}' missing components in {p}")
                self._samples.append((fi, comp))

    def _num_samples(self):
        return len(self._samples)

    def _out_dtypes(self, n_out):
        dts = self.spec.GetArgument("dtypes", None)
        if not dts:
            return [np.uint8] * n_out
        from ..types import DALIDataType, to_numpy_type

        out = [to_numpy_type(DALIDataType(d)) if isinstance(d, (DALIDataType, int))
               else np.dtype(d).type for d in dts]
        if len(out) != n_out:
            raise ValueError("readers.Webdataset: len(dtypes) must match len(ext)")
        return out

    @staticmethod
    def _as_dtype(blob, dt):
        if dt is np.uint8:
            return blob
        if blob.nbytes % np.dtype(dt).itemsize:
            raise ValueError(
                f"readers.Webdataset: component size {blob.nbytes} not divisible by itemsize "
                f"of {np.dtype(dt)}")
        return blob.view(dt)

    def _read_payload(self, index: int):
        fi, comp = self._samples[index]
        exts = self._exts()
        path = self._paths[fi]
        if path.startswith("s3://"):
            from .. import _s3

            bucket, key = _s3.parse_uri(path)
            client = _s3.client()
            read = lambda off, size: client.get_object(  # noqa: E731  (one ranged GET each)
                bucket, key, byte_range=(off, off + size))
        else:
            read = lambda off, size: self._files.read(fi, size, off)  # noqa: E731
        outs = []
        for e, dt in zip(exts, self._out_dtypes(len(exts))):
            k = _resolve_wds_ext(comp, e)
            if k is None:
                outs.append(np.zeros((0,), dt))
            else:
                off, size = comp[k]
                outs.append(self._as_dtype(np.frombuffer(read(off, size), np.uint8).copy(), dt))
        return tuple(outs)

    def close(self):
        if self._files is not None:
            self._files.close()


# ====================================== readers.Numpy ==============================================

DALI_SCHEMA("readers.Numpy").DocStr(
    "Reads .npy files. ``device='gpu'`` (run as 'mixed') reads on the host and returns "
    "the batch on the device."
).NumInput(0).NumOutput(1).Devices("cpu", "mixed").MakeReader().AddOptionalArg(
    "file_root", ArgType.STRING, "Directory with .npy files.", None
).AddOptionalArg(
    "files", ArgType.STRING_VEC, "Explicit file list.", None
).AddOptionalArg(
    "file_list", ArgType.STRING, "Path to a list file.", None
).AddOptionalArg(
    "file_filter", ArgType.STRING, "Glob filter.", "*.npy"
).AddOptionalArg(
    "register_buffers", ArgType.BOOL, "Compatibility no-op (GPUDirect Storage).", True
).AddOptionalArg(
    "cache_header_information", ArgType.BOOL, "Cache npy headers.", False
).AddOptionalArg(
    "roi_start", ArgType.FLOAT_VEC, "Region-of-interest origin.", None
).AddOptionalArg(
    "rel_roi_start", ArgType.FLOAT_VEC, "Relative ROI origin.", None
).AddOptionalArg(
    "roi_end", ArgType.FLOAT_VEC, "ROI end.", None
).AddOptionalArg(
    "rel_roi_end", ArgType.FLOAT_VEC, "Relative ROI end.", None
).AddOptionalArg(
    "roi_shape", ArgType.FLOAT_VEC, "ROI shape.", None
).AddOptionalArg(
    "rel_roi_shape", ArgType.FLOAT_VEC, "Relative ROI shape.", None
).AddOptionalArg(
    "roi_axes", ArgType.INT_VEC, "Axes the ROI args refer to (default: leading).", None
).AddOptionalArg(
    "out_of_bounds_policy", ArgType.STRING, '"error"|"pad"|"trim_to_shape".', "error"
).AddOptionalArg(
    "fill_value", ArgType.FLOAT, "Pad value for out-of-bounds ROI reads.", 0.0
)

_ROI_ARGS = ("roi_start", "rel_roi_start", "roi_end", "rel_roi_end", "roi_shape", "rel_roi_shape")


def list_files(spec, what: str, default_filter: str) -> List[str]:
    """The files of a Numpy or Fits reader: ``files`` (joined to
    ``file_root`` when relative), a ``file_list`` (one path per line), or
    the sorted entries of ``file_root`` matching ``file_filter``."""
    files = spec.GetArgument("files", None)
    root = spec.GetArgument("file_root", None)
    if files:
        out = [os.path.join(root, f) if root and not os.path.isabs(f) else f for f in files]
    elif spec.GetArgument("file_list", None):
        with open(spec.GetArgument("file_list")) as f:
            out = [os.path.join(root or "", line.strip()) for line in f if line.strip()]
    elif root:
        pat = spec.GetArgument("file_filter", default_filter)
        if root.startswith("s3://"):
            from .. import _s3

            out = [u for u in sorted(_s3.list_uris(root))
                   if fnmatch.fnmatch(u.rsplit("/", 1)[-1], pat)]
        else:
            out = [os.path.join(root, f) for f in sorted(os.listdir(root))
                   if fnmatch.fnmatch(f, pat)]
    else:
        raise ValueError(f"readers.{what} requires file_root, files, or file_list")
    if not out:
        raise ValueError(f"readers.{what} found no files")
    return out


@register_operator("readers.Numpy", "cpu")
@register_operator("readers.Numpy", "mixed")
class NumpyReader(BaseReader):
    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._files = None
        self._hdr_cache = {}
        self._has_roi = any(spec.GetArgument(a, None) is not None for a in _ROI_ARGS)

    def _build_index(self):
        if self._files is None:
            self._files = list_files(self.spec, "numpy", "*.npy")

    def _num_samples(self):
        return len(self._files)

    def _header(self, path):
        """(shape, fortran order, dtype, data offset) of a .npy file, parsed
        once per path."""
        hdr = self._hdr_cache.get(path)
        if hdr is None:
            with open(path, "rb") as f:
                version = np.lib.format.read_magic(f)
                read_hdr = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                            else np.lib.format.read_array_header_2_0)
                shape, fortran, dtype = read_hdr(f)
                hdr = self._hdr_cache[path] = (shape, fortran, dtype, f.tell())
        return hdr

    def _read_payload(self, index: int):
        path = self._files[index]
        if path.startswith("s3://"):
            from .. import _s3

            return self._apply_roi(np.load(io.BytesIO(_s3.read_bytes(path)), allow_pickle=False))
        hdr = self._header(path) if self.spec.GetArgument("cache_header_information") else None
        if hdr is not None and not hdr[1]:
            shape, _, dtype, off = hdr
            if self._has_roi:
                arr = np.memmap(path, dtype=dtype, mode="r", offset=off, shape=shape)
            else:
                count = int(np.prod(shape)) if shape else 1
                arr = np.fromfile(path, dtype=dtype, offset=off, count=count).reshape(shape)
        else:
            # an ROI read maps the file and touches only the region's pages
            arr = np.load(path, allow_pickle=False, mmap_mode="r" if self._has_roi else None)
        return self._apply_roi(arr)

    def _apply_roi(self, arr):
        """The ROI of ``arr`` over ``roi_axes`` (start/end/shape, absolute or
        relative), under ``out_of_bounds_policy``."""
        if not self._has_roi:
            return np.ascontiguousarray(arr)
        spec = self.spec
        axes = spec.GetArgument("roi_axes", None) or list(range(arr.ndim))
        exts = np.asarray([arr.shape[a] for a in axes], np.float64)

        def getv(name, rel_name):
            v = spec.GetArgument(name, None)
            if v is not None:
                return np.asarray(v, np.float64).reshape(-1)
            rv = spec.GetArgument(rel_name, None)
            if rv is not None:
                return np.asarray(rv, np.float64).reshape(-1) * exts
            return None

        start = getv("roi_start", "rel_roi_start")
        end = getv("roi_end", "rel_roi_end")
        shape = getv("roi_shape", "rel_roi_shape")
        if start is None:
            start = np.zeros(len(axes))
        if end is None:
            end = start + shape if shape is not None else exts
        policy = spec.GetArgument("out_of_bounds_policy")
        s = np.round(start).astype(np.int64)
        e = np.round(end).astype(np.int64)
        oob = (s < 0).any() or (e > exts.astype(np.int64)).any()
        if oob and policy == "error":
            raise ValueError(
                f"readers.Numpy: ROI [{s}, {e}) out of bounds for extents "
                f"{exts.astype(int)} (out_of_bounds_policy='error')")
        sl = [slice(None)] * arr.ndim
        for k, a in enumerate(axes):
            lo = max(int(s[k]), 0)
            sl[a] = slice(lo, max(min(int(e[k]), arr.shape[a]), lo))
        out = np.ascontiguousarray(arr[tuple(sl)])
        if oob and policy == "pad":
            pads = [(0, 0)] * arr.ndim
            for k, a in enumerate(axes):
                pads[a] = (max(-int(s[k]), 0), max(int(e[k]) - arr.shape[a], 0))
            out = np.pad(out, pads, constant_values=spec.GetArgument("fill_value"))
        return out


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
    "Also output a rasterized [H, W, 1] int32 mask of annotation indices (1-based; later "
    "annotations overwrite earlier ones).", False
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
        want_polys = (spec.GetArgument("polygon_masks") or spec.GetArgument("masks")
                      or spec.GetArgument("pixelwise_masks"))
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
        if spec.GetArgument("pixelwise_masks"):
            # each polygon filled alone, in order: a later annotation
            # overwrites an earlier one
            mask = np.zeros((h, w, 1), np.int32)
            for mi, b in enumerate(boxes):
                for poly in b[5]:
                    fill_poly(mask, np.round(poly).astype(np.int32), mi + 1)
            out.append(mask)
        if spec.GetArgument("image_ids"):
            out.append(np.array([img_id], np.int32))
        return tuple(out)


# ====================================== readers.Sequence ===========================================

DALI_SCHEMA("readers.Sequence").DocStr(
    "Reads frame sequences from per-sequence directories of images."
).NumInput(0).NumOutput(1).Devices("cpu").MakeReader().AddArg(
    "file_root", ArgType.STRING, "Directory with one subdirectory per sequence."
).AddArg("sequence_length", ArgType.INT, "Frames per returned sequence.").AddOptionalArg(
    "step", ArgType.INT, "Distance between first frames of sequences.", 1
).AddOptionalArg("stride", ArgType.INT, "Distance between consecutive frames.", 1).AddOptionalArg(
    "image_type", ArgType.IMAGE_TYPE, "Decoded color space.", None
)


@register_operator("readers.Sequence", "cpu")
class SequenceReader(BaseReader):
    """[F, H, W, C] uint8 sequences: every window of ``sequence_length``
    frames ``stride`` apart, starting ``step`` apart, in each sorted
    subdirectory; frames decode as RGB through ``imgcodec.decode`` (the
    reference reads ``image_type`` and decodes RGB all the same)."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._seqs = None

    def _build_index(self):
        if self._seqs is not None:
            return
        spec = self.spec
        root = spec.GetArgument("file_root")
        length, step, stride = (spec.GetArgument(a) for a in ("sequence_length", "step", "stride"))
        span = (length - 1) * stride + 1
        self._seqs = []
        for d in sorted(os.listdir(root)):
            dpath = os.path.join(root, d)
            if not os.path.isdir(dpath):
                continue
            frames = [os.path.join(dpath, f) for f in sorted(os.listdir(dpath))]
            for start in range(0, len(frames) - span + 1, step):
                self._seqs.append([frames[start + i * stride] for i in range(length)])
        if not self._seqs:
            raise ValueError("readers.sequence found no sequences")

    def _num_samples(self):
        return len(self._seqs)

    def _read_payload(self, index: int):
        from .. import imgcodec

        frames = []
        for p in self._seqs[index]:
            with open(p, "rb") as f:
                frames.append(imgcodec.decode(f.read()))
        return np.stack(frames, axis=0)

    def _payload_layouts(self):
        return ["FHWC"]
