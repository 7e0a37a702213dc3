"""readers.MXNet, Caffe, Caffe2, NemoAsr and Fits (counterparts of
``dali_tpu/backend/readers3.py``, ``readers4.py``, ``tail.py``'s NemoAsr and
``misc2.py``'s Fits).

Each index and each sample is the reference's: RecordIO records from the
``.idx`` files or a scan, LMDB keys in B+tree order (``_lmdb.py``, the
port's copy of the pure-Python reader) with Caffe's ``Datum`` and Caffe2's
``TensorProtos`` decoded by a protobuf wire scanner, NeMo manifests filtered
by duration, FITS HDUs with their big-endian data and BSCALE/BZERO. Sharding,
shuffling and checkpoints come from ``BaseReader``.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

from .._lmdb import LmdbFile
from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..types import DALIDataType, to_numpy_type
from .readers import BaseReader
from .readers2 import RecordFiles, list_files

# ====================================== readers.MXNet ==============================================

_RECORDIO_MAGIC = 0xCED7230A


def build_recordio_index(path: str):
    """(offset, payload length) of each RecordIO record, as the reference's
    ``.idx`` files would give them."""
    entries = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        while pos + 8 <= size:
            f.seek(pos)
            magic, lrec = struct.unpack("<II", f.read(8))
            if magic != _RECORDIO_MAGIC:
                break
            length = lrec & ((1 << 29) - 1)
            entries.append((pos, length))
            pos += 8 + ((length + 3) & ~3)  # records are 4-byte aligned
    return entries


def parse_irheader(payload: bytes):
    """MXNet's ImageRecord header: flag u32, label f32, id u64, id2 u64 (24
    bytes); a positive flag is the count of float labels that follow."""
    flag, label = struct.unpack("<If", payload[:8])
    offset = 24
    if flag > 0:
        labels = np.frombuffer(payload, np.float32, count=flag, offset=offset)
        offset += 4 * flag
    else:
        labels = np.array([label], np.float32)
    return labels, payload[offset:]


DALI_SCHEMA("readers.MXNet").DocStr(
    "Reads MXNet RecordIO (ImageRecord) files. Outputs (encoded image, label)."
).NumInput(0).NumOutput(2).Devices("cpu").MakeReader().AddArg(
    "path", ArgType.STRING_VEC, "RecordIO file path(s)."
).AddOptionalArg("index_path", ArgType.STRING_VEC, "Index file path(s) (.idx).", None)


@register_operator("readers.MXNet", "cpu")
class MXNetReader(BaseReader):
    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._entries = None  # [(file index, offset, size)]
        self._files = None

    def _build_index(self):
        if self._entries is not None:
            return
        paths = self.spec.GetArgument("path")
        idx_paths = self.spec.GetArgument("index_path", None)
        self._files = RecordFiles(paths, not self.spec.GetArgument("dont_use_mmap"))
        self._entries = []
        for fi, p in enumerate(paths):
            if idx_paths and fi < len(idx_paths) and os.path.exists(idx_paths[fi]):
                # '<key>\t<offset>' lines; a record runs to the next offset
                offs = []
                with open(idx_paths[fi]) as f:
                    for line in f:
                        parts = line.split()
                        if len(parts) >= 2:
                            offs.append(int(parts[1]))
                offs.sort()
                ends = offs[1:] + [os.path.getsize(p)]
                self._entries.extend((fi, off, end - off) for off, end in zip(offs, ends))
            else:
                self._entries.extend((fi, off, length + 8)
                                     for off, length in build_recordio_index(p))

    def _num_samples(self):
        return len(self._entries)

    def _read_payload(self, index: int):
        fi, off, _ = self._entries[index]
        _, lrec = struct.unpack("<II", self._files.read(fi, 8, off))
        payload = self._files.read(fi, lrec & ((1 << 29) - 1), off + 8)
        labels, data = parse_irheader(payload)
        return np.frombuffer(data, np.uint8).copy(), labels.astype(np.float32)

    def close(self):
        if self._files is not None:
            self._files.close()


# ====================================== readers.Caffe / Caffe2 =====================================


def scan_proto(buf: memoryview):
    """(field number, wire type, value) of each field of a protobuf message:
    an int for a varint, bytes for the other wire types."""
    i, n = 0, len(buf)

    def varint():
        nonlocal i
        v, shift = 0, 0
        while True:
            b = buf[i]
            i += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7

    while i < n:
        tag = varint()
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            yield field, wt, varint()
        elif wt in (1, 5):
            size = 8 if wt == 1 else 4
            yield field, wt, bytes(buf[i:i + size])
            i += size
        elif wt == 2:
            ln = varint()
            yield field, wt, bytes(buf[i:i + ln])
            i += ln
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")


def parse_datum(buf: bytes) -> dict:
    """caffe.proto Datum: 1 channels, 2 height, 3 width, 4 data, 5 label,
    6 float_data (repeated), 7 encoded."""
    d = {"channels": 0, "height": 0, "width": 0, "data": b"", "label": 0,
         "float_data": [], "encoded": False}
    names = {1: "channels", 2: "height", 3: "width", 4: "data", 5: "label"}
    for field, wt, v in scan_proto(memoryview(buf)):
        if field in names:
            d[names[field]] = v
        elif field == 6:
            if wt == 2:  # packed
                d["float_data"].extend(np.frombuffer(v, "<f4").tolist())
            else:
                d["float_data"].append(np.frombuffer(v, "<f4")[0])
        elif field == 7:
            d["encoded"] = bool(v)
    return d


_C2_FLOAT, _C2_INT32, _C2_BYTE, _C2_STRING, _C2_UINT8, _C2_INT64 = 1, 2, 3, 4, 8, 10


def _unpack_varints(b: bytes):
    out, v, shift = [], 0, 0
    for byte in b:
        v |= (byte & 0x7F) << shift
        if byte & 0x80:
            shift += 7
        else:
            out.append(v)
            v, shift = 0, 0
    return out


def parse_tensor_proto(buf: bytes) -> np.ndarray:
    """caffe2.proto TensorProto: 1 dims, 2 data_type, 3 float_data,
    4 int32_data, 5 byte_data, 6 string_data, 10 int64_data. A STRING tensor
    is its first string's bytes (an encoded image; dims ignored)."""
    dims, dtype = [], _C2_FLOAT
    floats, int32s, int64s = [], [], []
    byte_data, strings = b"", []
    for field, wt, v in scan_proto(memoryview(buf)):
        if field == 1:
            dims.append(v) if wt == 0 else dims.extend(_unpack_varints(v))
        elif field == 2:
            dtype = v
        elif field == 3:
            if wt == 2:
                floats.extend(np.frombuffer(v, "<f4").tolist())
            else:
                floats.append(np.frombuffer(v, "<f4")[0])
        elif field == 4:
            int32s.append(v) if wt == 0 else int32s.extend(_unpack_varints(v))
        elif field == 5:
            byte_data = v
        elif field == 6:
            strings.append(v)
        elif field == 10:
            int64s.append(v) if wt == 0 else int64s.extend(_unpack_varints(v))
    shape = tuple(int(x) for x in dims)
    if dtype == _C2_FLOAT:
        arr = np.asarray(floats, np.float32)
    elif dtype == _C2_INT32:
        arr = np.asarray(int32s, np.int32)
    elif dtype == _C2_INT64:
        arr = np.asarray(int64s, np.int64)
    elif dtype in (_C2_BYTE, _C2_UINT8):
        arr = np.frombuffer(byte_data, np.uint8)
    elif dtype == _C2_STRING:
        return np.frombuffer(strings[0], np.uint8) if strings else np.zeros(0, np.uint8)
    else:
        raise ValueError(f"TensorProto data_type {dtype} not supported")
    return arr.reshape(shape) if shape and arr.size == int(np.prod(shape)) else arr


def parse_tensor_protos(buf: bytes):
    """TensorProtos: field 1 = repeated TensorProto."""
    return [parse_tensor_proto(v) for f, _, v in scan_proto(memoryview(buf)) if f == 1]


def _lmdb_schema(name, doc):
    return (DALI_SCHEMA(name).DocStr(doc).NumInput(0).NumOutput(2).Devices("cpu").MakeReader()
            .AddArg("path", ArgType.STRING_VEC, "LMDB directory (or data.mdb file) path(s)."))


_lmdb_schema(
    "readers.Caffe",
    "Reads (image, label) from a Caffe LMDB. Encoded datums yield the undecoded image "
    "bytes: pair with fn.decoders.image.",
).OutputFn(
    lambda spec: (int(spec.GetArgument("image_available", True))
                  + int(spec.GetArgument("label_available", True)))
).AddOptionalArg(
    "image_available", ArgType.BOOL, "The LMDB datums contain image data.", True
).AddOptionalArg(
    "label_available", ArgType.BOOL, "The LMDB datums contain labels.", True
)


def _caffe2_output_fn(spec):
    """Image, label (the sparse label types add the raw indices),
    ``additional_inputs`` and the bbox."""
    lt = spec.GetArgument("label_type", 0)
    n = int(spec.GetArgument("image_available", True))
    n += (0 if lt == 4 else 1) + (1 if lt in (1, 3) else 0)
    n += int(spec.GetArgument("additional_inputs", 0))
    n += int(spec.GetArgument("bbox", False))
    return n


_lmdb_schema(
    "readers.Caffe2", "Reads (image, label) from a Caffe2 LMDB of TensorProtos."
).OutputFn(_caffe2_output_fn).AddOptionalArg(
    "image_available", ArgType.BOOL, "The first TensorProto of each sample is image data.", True
).AddOptionalArg(
    "label_type", ArgType.INT,
    "0 = SINGLE_LABEL, 1 = MULTI_LABEL_SPARSE (dense one-hot of num_labels + raw indices "
    "output), 2 = MULTI_LABEL_DENSE, 3 = MULTI_LABEL_WEIGHTED_SPARSE (dense weights of "
    "num_labels + raw indices output), 4 = NO_LABEL.", 0
).AddOptionalArg(
    "num_labels", ArgType.INT, "Number of classes (required for the sparse label types).", 1
).AddOptionalArg(
    "additional_inputs", ArgType.INT,
    "Number of auxiliary TensorProtos per sample emitted as extra outputs.", 0
).AddOptionalArg(
    "bbox", ArgType.BOOL,
    "The final TensorProto is a 4-element int32 bounding box (extra output).", False
)


class _LMDBReaderBase(BaseReader):
    def _build_index(self):
        self._dbs = [LmdbFile(p) for p in self.spec.GetArgument("path")]
        self._index = [(di, k) for di, db in enumerate(self._dbs) for k in db.keys()]

    def _num_samples(self):
        return len(self._index)

    def _raw_value(self, index: int) -> bytes:
        di, key = self._index[index]
        return self._dbs[di].get(key)

    def close(self):
        for db in getattr(self, "_dbs", []):
            db.close()


@register_operator("readers.Caffe", "cpu")
class CaffeReader(_LMDBReaderBase):
    def _read_payload(self, index: int):
        d = parse_datum(self._raw_value(index))
        chw = (d["channels"], d["height"], d["width"])
        outs = []
        if self.spec.GetArgument("image_available"):
            if d["float_data"]:
                data = np.asarray(d["float_data"], np.float32)
                if all(chw):
                    data = data.reshape(chw)
            else:
                data = np.frombuffer(d["data"], np.uint8)
                if not d["encoded"] and all(chw):
                    data = data.reshape(chw)
            outs.append(data)
        if self.spec.GetArgument("label_available"):
            outs.append(np.int32(d["label"]))
        return tuple(outs) if len(outs) != 1 else outs[0]


@register_operator("readers.Caffe2", "cpu")
class Caffe2Reader(_LMDBReaderBase):
    def _read_payload(self, index: int):
        """Protos in order: [image][label indices][weights (weighted
        sparse)][additional...][bbox]."""
        spec = self.spec
        protos = parse_tensor_protos(self._raw_value(index))
        outs = []
        k = 0
        if spec.GetArgument("image_available"):
            outs.append(protos[k] if k < len(protos) else np.zeros(0, np.uint8))
            k += 1
        lt = spec.GetArgument("label_type")
        num_labels = spec.GetArgument("num_labels")
        if lt != 4:
            lab = np.asarray(protos[k]) if k < len(protos) else np.zeros((), np.int32)
            if lt == 0:  # SINGLE_LABEL
                outs.append(lab.reshape(()) if lab.ndim and lab.size == 1 else lab)
                k += 1
            elif lt in (1, 3):  # sparse: a dense vector over num_labels + the raw indices
                idx = lab.reshape(-1).astype(np.int64)
                if idx.size and (idx.min() < 0 or idx.max() >= num_labels):
                    raise ValueError(
                        f"readers.Caffe2: label index out of bounds (num_labels={num_labels})")
                if lt == 1:
                    dense = np.zeros((num_labels,),
                                     lab.dtype if lab.dtype.kind == "f" else np.int32)
                    dense[idx] = 1
                    k += 1
                else:
                    wts = (np.asarray(protos[k + 1], np.float32).reshape(-1)
                           if k + 1 < len(protos) else np.zeros_like(idx, np.float32))
                    dense = np.zeros((num_labels,), np.float32)
                    dense[idx] = wts[:idx.size]
                    k += 2
                outs += [dense, idx.astype(np.int32)]
            elif lt == 2:  # MULTI_LABEL_DENSE
                outs.append(lab.reshape(-1))
                k += 1
            else:
                raise ValueError(f"readers.Caffe2: unsupported label_type {lt}")
        for _ in range(spec.GetArgument("additional_inputs")):
            outs.append(np.asarray(protos[k]) if k < len(protos) else np.zeros(0, np.float32))
            k += 1
        if spec.GetArgument("bbox"):
            bb = (np.asarray(protos[k], np.int32).reshape(-1) if k < len(protos)
                  else np.zeros((4,), np.int32))
            if bb.size != 4:
                raise ValueError("readers.Caffe2: bbox proto must have 4 int32 values")
            outs.append(bb)
        return tuple(outs) if len(outs) != 1 else outs[0]


# ====================================== readers.NemoAsr ============================================

DALI_SCHEMA("readers.NemoAsr").DocStr(
    "Reads NeMo ASR manifests: JSON lines with audio_filepath/duration/text. Outputs "
    "(audio, sample_rate, transcript bytes, manifest index), the last three by their toggles."
).NumInput(0).OutputFn(
    lambda spec: (1 + (1 if spec.GetArgument("read_sample_rate", True) else 0)
                  + (1 if spec.GetArgument("read_text", True) else 0)
                  + (1 if spec.GetArgument("read_idxs", False) else 0))
).Devices("cpu").MakeReader().AddArg(
    "manifest_filepaths", ArgType.STRING_VEC, "Manifest JSON-lines files."
).AddOptionalArg(
    "sample_rate", ArgType.FLOAT, "Resample target (0 = keep).", 0.0
).AddOptionalArg(
    "read_sample_rate", ArgType.BOOL, "Output the sample rate as a separate output.", True
).AddOptionalArg(
    "read_text", ArgType.BOOL, "Also output transcripts.", True
).AddOptionalArg(
    "read_idxs", ArgType.BOOL, "Output each sample's manifest index as a separate output.", False
).AddOptionalArg(
    "downmix", ArgType.BOOL, "Downmix to mono.", True
).AddOptionalArg(
    "min_duration", ArgType.FLOAT, "Skip shorter clips.", 0.0
).AddOptionalArg(
    "max_duration", ArgType.FLOAT, "Skip longer clips (0 = inf).", 0.0
).AddOptionalArg(
    "quality", ArgType.FLOAT, "Resampling quality (0..100; hint).", 50.0
).AddOptionalArg(
    "dtype", ArgType.DATA_TYPE, "Audio output dtype: FLOAT (default) or INT16.",
    DALIDataType.FLOAT)


@register_operator("readers.NemoAsr", "cpu")
class NemoAsrReader(BaseReader):
    """WAV, FLAC, MP3 and Ogg Vorbis clips decode through
    ``audio.decode_audio``, as ``decoders.audio`` decodes them; the forms it
    does not decode raise as there."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._entries = None

    def _build_index(self):
        if self._entries is not None:
            return
        spec = self.spec
        lo, hi = spec.GetArgument("min_duration"), spec.GetArgument("max_duration")
        self._entries = []
        for mp in spec.GetArgument("manifest_filepaths"):
            base = os.path.dirname(os.path.abspath(mp))
            with open(mp) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    e = json.loads(line)
                    dur = float(e.get("duration", 0.0))
                    if dur < lo or (hi > 0 and dur > hi):
                        continue
                    self._entries.append((os.path.join(base, e["audio_filepath"]),
                                          e.get("text", "")))
        if not self._entries:
            raise ValueError("readers.nemo_asr found no usable manifest entries")

    def _num_samples(self):
        return len(self._entries)

    def _read_payload(self, index: int):
        from .audio import _resample_audio, decode_audio

        spec = self.spec
        path, text = self._entries[index]
        with open(path, "rb") as f:
            audio, rate = decode_audio(f.read())
        if spec.GetArgument("downmix") and audio.ndim == 2:
            audio = audio.mean(axis=1)
        target = spec.GetArgument("sample_rate")
        if target and target > 0:
            audio = _resample_audio(audio, rate, target)
            rate = target
        dt = spec.GetArgument("dtype")
        if dt == DALIDataType.INT16:
            outs = (np.clip(np.round(np.asarray(audio, np.float32) * 32767.0),
                            -32768, 32767).astype(np.int16),)
        else:
            outs = (audio.astype(to_numpy_type(dt)),)
        if spec.GetArgument("read_sample_rate"):
            outs += (np.float32(rate),)
        if spec.GetArgument("read_text"):
            outs += (np.frombuffer(text.encode(), np.uint8).copy(),)
        if spec.GetArgument("read_idxs"):
            outs += (np.array([index], np.int64),)
        return outs


# ====================================== readers.Fits ===============================================

_FITS_DTYPES = {8: np.uint8, 16: ">i2", 32: ">i4", 64: ">i8", -32: ">f4", -64: ">f8"}


def _read_fits_header(f):
    """One HDU header as a dict of cards, or None at the end of the file."""
    cards = {}
    first = True
    while True:
        block = f.read(2880)
        if not block and first:
            return None
        if len(block) < 2880:
            raise ValueError("Truncated FITS header")
        first = False
        for i in range(0, 2880, 80):
            card = block[i:i + 80].decode("ascii", "replace")
            key = card[:8].strip()
            if key == "END":
                return cards
            if "=" in card:
                cards[key] = card[card.index("=") + 1:].split("/")[0].strip()


def _fits_data(cards, f, skip: bool):
    """The HDU's data (native byte order, BSCALE/BZERO applied), or None
    with ``skip``; the file is left at the next HDU either way."""
    naxis = int(cards["NAXIS"])
    shape = [int(cards[f"NAXIS{i}"]) for i in range(naxis, 0, -1)]
    count = int(np.prod(shape)) if shape else 0
    dt = np.dtype(_FITS_DTYPES[int(cards["BITPIX"])])
    # data size: |BITPIX|/8 * GCOUNT * (PCOUNT + prod(NAXIS)), padded to blocks
    gcount = int(cards.get("GCOUNT", "1") or 1)
    pcount = int(cards.get("PCOUNT", "0") or 0)
    nbytes = dt.itemsize * gcount * (pcount + count)
    padded = -(-nbytes // 2880) * 2880 if nbytes else 0
    if skip:
        f.seek(padded, 1)
        return None
    xt = cards.get("XTENSION", "'IMAGE'").strip().strip("'").strip()
    if xt not in ("IMAGE", ""):
        raise ValueError(
            f"FITS HDU is a {xt} extension, not an image; pick an image HDU via hdu_indices")
    data = np.frombuffer(f.read(count * dt.itemsize), dt, count=count)
    f.seek(padded - count * dt.itemsize, 1)
    arr = data.reshape(shape)
    bscale = float(cards.get("BSCALE", "1.0"))
    bzero = float(cards.get("BZERO", "0.0"))
    if bscale != 1.0 or bzero != 0.0:
        arr = arr * bscale + bzero
    return np.ascontiguousarray(arr.astype(arr.dtype.newbyteorder("=")))


def read_fits_hdus(path: str, indices) -> list:
    """The image HDUs of ``path`` at 1-based ``indices``. Asking for HDU 2
    (the default) of a file with only a primary HDU gives the primary in
    every requested slot."""
    want = {int(i) for i in indices}
    out = {}
    max_hdu = 0
    with open(path, "rb") as f:
        hdu = 0
        while len(out) < len(want):
            hdu += 1
            cards = _read_fits_header(f)
            if cards is None:
                break
            max_hdu = hdu
            arr = _fits_data(cards, f, skip=hdu not in want)
            if hdu in want:
                out[hdu] = arr
    missing = sorted(want - set(out))
    if missing == [2] and max_hdu == 1 and 1 not in want:
        primary = read_fits_hdus(path, [1])[0]
        return [primary for _ in indices]
    if missing:
        raise ValueError(f"{path}: FITS HDU(s) {missing} not present")
    return [out[int(i)] for i in indices]


DALI_SCHEMA("readers.Fits").DocStr(
    "Reads FITS image files; one output per entry of ``hdu_indices``."
).NumInput(0).OutputFn(
    lambda spec: len(spec.GetArgument("hdu_indices") or [2])
).Devices("cpu").MakeReader().AddOptionalArg(
    "file_root", ArgType.STRING, "Directory with FITS files.", None
).AddOptionalArg(
    "files", ArgType.STRING_VEC, "Explicit file list.", None
).AddOptionalArg("file_filter", ArgType.STRING, "Glob filter.", "*.fits").AddOptionalArg(
    "hdu_indices", ArgType.INT_VEC,
    "1-based HDU indices to read, one output each (default [2], the first extension; "
    "extension-less files fall back to the primary).", [2]
).AddOptionalArg(
    "file_list", ArgType.STRING, "Path to a file with one FITS path per line.", None
).AddOptionalArg(
    "dtypes", ArgType.INT_VEC,
    "Expected output dtypes per HDU (DALIDataType values); data is cast when it differs.",
    None)


@register_operator("readers.Fits", "cpu")
class FitsReader(BaseReader):
    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._files = None

    def _build_index(self):
        if self._files is None:
            self._files = list_files(self.spec, "fits", "*.fits")

    def _num_samples(self):
        return len(self._files)

    def _read_payload(self, index: int):
        arrs = read_fits_hdus(self._files[index], self.spec.GetArgument("hdu_indices") or [2])
        dtypes = self.spec.GetArgument("dtypes", None)
        if dtypes:
            if len(dtypes) != len(arrs):
                raise ValueError("readers.Fits: len(dtypes) must match len(hdu_indices)")
            arrs = [a.astype(to_numpy_type(DALIDataType(int(dt)))) for a, dt in zip(arrs, dtypes)]
        return tuple(arrs) if len(arrs) > 1 else arrs[0]
