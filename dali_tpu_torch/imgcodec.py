"""Image codec layer: header peeks and decode (counterpart of
``dali_tpu/imgcodec.py``).

JPEG decodes through the port's libjpeg-free C++ decoder
(``native.decode_jpeg``, ``csrc/host/jpeg_decode.cc``), uint8-equal to
libjpeg-turbo's ``JDCT_ISLOW`` output, which is what the reference decodes
with. The reference falls back to cv2 and PIL for every other format; the
port has neither, so a non-JPEG input raises ``NotImplementedError``. The
header peeks (JPEG SOF, PNG IHDR, BMP, GIF, WebP) are pure Python, as in the
reference.
"""

from __future__ import annotations

import struct

import numpy as np

from . import native
from .types import DALIDataType, DALIImageType, to_numpy_type

NOT_JPEG = ("only JPEG decodes in dali_tpu_torch; PNG, BMP, GIF, WebP, TIFF and the other "
            "formats the reference decodes through cv2/PIL are not ported (see ROADMAP.md, "
            "Queue 1 item 1d)")


def exif_orientation(data) -> int:
    """EXIF orientation (1-8; 1 = upright) from a JPEG's APP1 segment, or 1.
    ``data``: bytes, a memoryview or a uint8 array."""
    if isinstance(data, np.ndarray):
        data = memoryview(np.ascontiguousarray(data).reshape(-1).view(np.uint8))
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        return 1
    pos = 2
    n = len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            return 1
        marker = data[pos + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker in (0xDA, 0xD9):  # SOS/EOI: no APP1 seen
            return 1
        seg_len = (data[pos + 2] << 8) | data[pos + 3]
        if marker == 0xE1 and data[pos + 4:pos + 10] == b"Exif\x00\x00":
            tiff = pos + 10
            if tiff + 8 > n:
                return 1
            order = {b"II": "little", b"MM": "big"}.get(bytes(data[tiff:tiff + 2]))
            if order is None:
                return 1

            def u16(o):
                return int.from_bytes(data[o:o + 2], order)

            ifd = tiff + int.from_bytes(data[tiff + 4:tiff + 8], order)
            if ifd + 2 > n:
                return 1
            for i in range(u16(ifd)):
                e = ifd + 2 + 12 * i
                if e + 12 > n:
                    return 1
                if u16(e) == 0x0112:
                    v = u16(e + 8)
                    return v if 1 <= v <= 8 else 1
            return 1
        pos += 2 + seg_len
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """Apply an EXIF orientation so the result is upright (HWC)."""
    if orientation == 2:
        return img[:, ::-1]
    if orientation == 3:
        return img[::-1, ::-1]
    if orientation == 4:
        return img[::-1]
    if orientation == 5:
        return np.swapaxes(img, 0, 1)
    if orientation == 6:
        return np.swapaxes(img, 0, 1)[:, ::-1]
    if orientation == 7:
        return np.swapaxes(img, 0, 1)[::-1, ::-1]
    if orientation == 8:
        return np.swapaxes(img, 0, 1)[::-1]
    return img


def is_jpeg2000(data: bytes) -> bool:
    """JP2 container signature or raw JPEG 2000 codestream (SOC marker)."""
    return data[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n" or data[:4] == b"\xff\x4f\xff\x51"


def _convert_dtype(img: np.ndarray, dtype) -> np.ndarray:
    """Dynamic-range conversion to the requested output dtype: integer
    targets scale source max to target max (uint8 -> uint16 multiplies by
    257), float targets land in [0, 1]."""
    if dtype is None:
        dtype = DALIDataType.UINT8
    np_t = to_numpy_type(dtype)
    if img.dtype == np_t:
        return img
    src_max = 1.0 if np.issubdtype(img.dtype, np.floating) else float(np.iinfo(img.dtype).max)
    if np.issubdtype(np_t, np.floating):
        return (img.astype(np.float64) / src_max).astype(np_t)
    info = np.iinfo(np_t)
    scaled = np.round(img.astype(np.float64) * (float(info.max) / src_max))
    return np.clip(scaled, info.min, info.max).astype(np_t)


def decode(data: bytes, output_type=DALIImageType.RGB, denom: int = 1,
           adjust_orientation: bool = True, fancy_upsampling: bool = True,
           dtype=None) -> np.ndarray:
    """Decode an encoded JPEG to HWC in the requested colour space and dtype.

    ``denom`` decodes at 1/denom DCT scale; ``adjust_orientation`` applies
    the EXIF orientation tag; ``fancy_upsampling`` is libjpeg's triangular
    chroma upsampling (False: box replication); ``dtype`` scales the dynamic
    range (float: [0, 1]). Raises ``NotImplementedError`` for other formats
    and for JPEG forms the decoder does not read, ``ValueError`` for a stream
    libjpeg rejects."""
    if is_jpeg2000(data):
        raise NotImplementedError(
            "JPEG 2000 decode is not supported (the reference delegates to the proprietary "
            "nvJPEG2000)")
    if not is_jpeg(data):
        raise NotImplementedError(NOT_JPEG)
    if adjust_orientation:
        o = exif_orientation(data)
        if o != 1:
            img = decode(data, output_type, denom, adjust_orientation=False,
                         fancy_upsampling=fancy_upsampling, dtype=dtype)
            return np.ascontiguousarray(apply_orientation(img, o))
    if output_type == DALIImageType.GRAY:
        return _convert_dtype(native.decode_jpeg(data, denom, fancy_upsampling, gray=True), dtype)
    img = native.decode_jpeg(data, denom, fancy_upsampling)
    return _convert_dtype(_convert_from_rgb(img, output_type), dtype)


def _convert_from_rgb(rgb: np.ndarray, output_type) -> np.ndarray:
    if output_type in (DALIImageType.RGB, DALIImageType.ANY_DATA):
        return rgb
    if output_type == DALIImageType.BGR:
        return rgb[:, :, ::-1].copy()
    if output_type == DALIImageType.GRAY:
        g = np.round(rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114)
        return g.astype(np.uint8)[:, :, None]
    if output_type == DALIImageType.YCbCr:
        return _rgb_to_ycbcr(rgb)
    raise ValueError(f"Unsupported output_type {output_type}")


def _rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """ITU-R BT.601 full-range (JPEG) YCbCr."""
    r = rgb[..., 0].astype(np.float32)
    g = rgb[..., 1].astype(np.float32)
    b = rgb[..., 2].astype(np.float32)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
    return np.clip(np.stack([y, cb, cr], axis=-1).round(), 0, 255).astype(np.uint8)


# -- container sniffing --------------------------------------------------------------------
def is_jpeg(data: bytes) -> bool:
    return len(data) > 3 and data[0] == 0xFF and data[1] == 0xD8


def peek_shape(data: bytes):
    """(h, w, c) from the header without a full decode."""
    if is_jpeg(data):
        return _peek_jpeg(data)
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        w, h = struct.unpack(">II", data[16:24])
        c = {0: 1, 2: 3, 3: 3, 4: 2, 6: 4}.get(data[25], 3)
        return h, w, c
    if data[:2] == b"BM":
        w, h = struct.unpack("<ii", data[18:26])
        return abs(h), w, 3
    if data[:6] in (b"GIF87a", b"GIF89a"):
        w, h = struct.unpack("<HH", data[6:10])
        return h, w, 3
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        if data[12:16] == b"VP8 ":
            w, h = struct.unpack("<HH", data[26:30])
            return h & 0x3FFF, w & 0x3FFF, 3
        if data[12:16] == b"VP8L":
            bits = struct.unpack("<I", data[21:25])[0]
            return ((bits >> 14) & 0x3FFF) + 1, (bits & 0x3FFF) + 1, 3
        if data[12:16] == b"VP8X":
            w = int.from_bytes(data[24:27], "little") + 1
            h = int.from_bytes(data[27:30], "little") + 1
            return h, w, 3
    # the reference falls back to a full decode here
    return decode(data).shape


def _peek_jpeg(data: bytes):
    i = 2
    n = len(data)
    while i + 9 < n:
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        length = struct.unpack(">H", data[i + 2:i + 4])[0]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):  # SOFn
            h, w = struct.unpack(">HH", data[i + 5:i + 9])
            return h, w, int(data[i + 9])
        i += 2 + length
    raise ValueError("No SOF marker found in JPEG")
