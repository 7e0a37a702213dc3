"""Image codec layer: header peeks and decode (counterpart of
``dali_tpu/imgcodec.py``).

The reference decodes each sample along one of two routes, and the port
gives each route's output without either library:

* libjpeg-turbo (``dali_tpu.native``) for the JPEGs it gives as RGB or grey:
  the port's libjpeg-free C++ decoder (``native.decode_jpeg_routed``,
  ``csrc/host/jpeg_decode.cc``), uint8-equal to its ``JDCT_ISLOW`` output;
* ``cv2.imdecode`` for everything else it reads: CMYK and YCCK JPEGs (the
  same C++ decoder reports this route and gives OpenCV's CMYK conversion),
  PNG (chunks and zlib inflate here, pixels in ``csrc/host/png_decode.cc``),
  BMP (``csrc/host/bmp_decode.cc``), GIF (``csrc/host/gif_decode.cc``: the
  first image on the logical screen), WebP (``csrc/host/webp_*.cc``: lossy,
  lossless and VP8X), TIFF (``csrc/host/tiff_decode.cc``, Deflate strips
  through ``inflate.cc``) and PNM (``csrc/host/pnm_decode.cc``). On this
  route GRAY is cv2's ``IMREAD_GRAYSCALE``, 16-bit PNG, TIFF and PNM samples
  and float TIFF samples keep their depth until the dtype conversion,
  ``denom`` applies to JPEG only, and the orientation that cv2 applies
  itself (JPEG APP1, PNG eXIf, WebP EXIF, the TIFF Orientation tag) is
  applied.

JPEG 2000 raises ``NotImplementedError`` as in the reference; so do the
other formats cv2 reads (PAM, PFM, Radiance HDR, Sun raster, AVIF: ROADMAP
item 1g) and the TIFF and WebP forms the decoders do not read (items 1h,
1i). The header peeks (JPEG SOF, PNG IHDR, BMP, GIF, WebP) are pure Python,
as in the reference; TIFF's and PNM's read the IFD and the header natively.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import native
from .types import DALIDataType, DALIImageType, to_numpy_type

NOT_JPEG = ("JPEG, PNG, BMP, GIF, WebP, TIFF and PNM decode in dali_tpu_torch; the other "
            "formats the reference decodes through cv2 (PAM, PFM, Radiance HDR, Sun raster, "
            "AVIF, ...) are not ported (see ROADMAP.md, Queue 1 item 1g)")
TIFF_NOT_READ = ("this TIFF form is not read by dali_tpu_torch's decoder: JPEG or CCITT "
                 "compression, CMYK/YCbCr/CIE L*a*b* photometrics, integer or 64-bit samples, "
                 "10-14 bits per sample, FillOrder 2, pre-5.0 LZW or 16-bit/float planes stored "
                 "separately (see ROADMAP.md, Queue 1 item 1h)")
WEBP_NOT_READ = ("this animated WebP is not read by dali_tpu_torch's decoder: only a first frame "
                 "that covers the canvas opaquely is (see ROADMAP.md, Queue 1 item 1i)")
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


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
            return _tiff_orientation(data, pos + 10)
        pos += 2 + seg_len
    return 1


def _tiff_orientation(data, tiff) -> int:
    """The orientation tag of the TIFF structure at ``tiff`` (EXIF), or 1."""
    n = len(data)
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
    gray = output_type == DALIImageType.GRAY
    if is_png(data):
        return cv2_route_output(*decode_png(data, gray), output_type, dtype)
    if is_bmp(data):
        _check_size(*native.bmp_shape(data))
        return cv2_route_output(native.decode_bmp(data, gray), 1, output_type, dtype)
    if is_gif(data):
        _check_size(*native.gif_shape(data))
        return cv2_route_output(native.decode_gif(data, gray), 1, output_type, dtype)
    kind = native_kind(data)
    if kind is not None:
        out, orient = prepare_native(data, kind, gray)
        raise_native_rc(native.decode_images_batch(None, [data], [kind], [out], gray)[0], kind)
        return cv2_route_output(out, orient, output_type, dtype)
    if not is_jpeg(data):
        raise NotImplementedError(NOT_JPEG)
    if adjust_orientation:
        o = exif_orientation(data)
        if o != 1:
            img = decode(data, output_type, denom, adjust_orientation=False,
                         fancy_upsampling=fancy_upsampling, dtype=dtype)
            return np.ascontiguousarray(apply_orientation(img, o))
    img, route = native.decode_jpeg_routed(data, denom, fancy_upsampling, gray)
    if route == native.ROUTE_CV2:
        return cv2_route_output(img, exif_orientation(data), output_type, dtype)
    if gray:
        return _convert_dtype(img, dtype)
    return _convert_dtype(_convert_from_rgb(img, output_type), dtype)


def cv2_route_output(img, orientation, output_type, dtype):
    """The reference's output for a sample decoded by cv2.imdecode: ``img``
    is what cv2 decoded (RGB, or one channel for GRAY) before the EXIF
    orientation cv2 applies itself."""
    img = apply_orientation(img, orientation)
    if output_type == DALIImageType.GRAY:
        return np.ascontiguousarray(_convert_dtype(img, dtype))
    if output_type == DALIImageType.BGR:
        return np.ascontiguousarray(_convert_dtype(img[:, :, ::-1], dtype))
    if output_type == DALIImageType.YCbCr:
        # YCbCr is defined on the 8-bit range: narrow first, then widen
        return _convert_dtype(_rgb_to_ycbcr(_convert_dtype(img, None)), dtype)
    return np.ascontiguousarray(_convert_dtype(img, dtype))


_KIND_NAMES = {native.KIND_WEBP: "WebP", native.KIND_TIFF: "TIFF", native.KIND_PNM: "PNM"}


def native_kind(data):
    """``native.KIND_*`` of a WebP, TIFF or PNM stream, else None."""
    if is_webp(data):
        return native.KIND_WEBP
    if is_tiff(data):
        return native.KIND_TIFF
    if is_pnm(data):
        return native.KIND_PNM
    return None


def raise_native_rc(rc, kind):
    """Raise for a failed ``native.decode_images_batch`` code."""
    if rc == 1:
        raise NotImplementedError(TIFF_NOT_READ if kind == native.KIND_TIFF else WEBP_NOT_READ)
    if rc != 0:
        raise ValueError(f"{_KIND_NAMES[kind]} decode failed: corrupt or truncated stream")


def native_header(data, kind):
    """(h, w, orientation, dtype) of a WebP, TIFF or PNM as cv2 reads its
    header. Raises ``ValueError`` where cv2 fails and
    ``NotImplementedError`` for a form the decoders do not read."""
    if kind == native.KIND_WEBP:
        info = native.webp_info(data)
        info = info if isinstance(info, int) else info + (np.dtype(np.uint8),)
    elif kind == native.KIND_TIFF:
        info = native.tiff_info(data)
        info = info if isinstance(info, int) else info[:4]
    else:
        info = native.pnm_info(data)
        info = info if isinstance(info, int) else (info[0], info[1], 1, info[2])
    if isinstance(info, int):
        raise_native_rc(info, kind)
    _check_size(info[0], info[1])
    return info


def prepare_native(data, kind, gray):
    """(output buffer, orientation) for one sample of
    ``native.decode_images_batch``."""
    h, w, orient, dt = native_header(data, kind)
    return np.empty((h, w, 1 if gray else 3), dt), orient


def decode_png(data, gray=False):
    """(pixels, EXIF orientation) of a PNG as cv2.imdecode reads it with
    IMREAD_ANYDEPTH: HWC RGB or one grey channel, uint16 for 16-bit images.
    The chunk walk follows libpng: a bad CRC fails a critical chunk and
    drops an ancillary one; the stream must reach IEND."""
    d = memoryview(data)
    pos, hdr, plte, idat, gamma, srgb, orient, sbit = 8, None, b"", [], 0, False, 1, b""
    while True:
        if pos + 12 > len(d):
            raise ValueError("PNG decode failed: the stream ends before IEND")
        n = int.from_bytes(d[pos:pos + 4], "big")
        kind = bytes(d[pos + 4:pos + 8])
        body = d[pos + 8:pos + 8 + n]
        if pos + 12 + n > len(d):
            raise ValueError("PNG decode failed: the stream ends before IEND")
        crc = int.from_bytes(d[pos + 8 + n:pos + 12 + n], "big")
        pos += 12 + n
        if zlib.crc32(kind + body) != crc:
            if kind[0] & 0x20:  # ancillary: libpng warns and drops it
                continue
            raise ValueError(f"PNG decode failed: CRC error in {kind.decode('latin-1')}")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            plte = bytes(body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"gAMA" and n == 4:
            g = int.from_bytes(body, "big")
            gamma = g if 16 <= g <= 625000000 else gamma
        elif kind == b"sRGB":
            srgb = True
        elif kind == b"sBIT":
            sbit = bytes(body)
        elif kind == b"eXIf":
            orient = _tiff_orientation(bytes(body), 0)
        elif kind == b"IEND":
            break
    if hdr is None or not idat:
        raise ValueError("PNG decode failed: no IHDR or no IDAT")
    w, h, bit_depth, color_type, _, _, interlace = hdr
    _check_size(h, w)
    if (bit_depth, color_type) not in _PNG_FORMS or interlace > 1 or (color_type == 3
                                                                       and not plte):
        raise ValueError("PNG decode failed: invalid IHDR")
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG decode failed: {e}") from None
    # libpng's 16-bit gamma tables keep the precision sBIT gives the colour
    sig_bit = max(sbit[:3]) if color_type in (2, 6) and len(sbit) >= 3 else 0
    return native.png_decode(raw, w, h, bit_depth, color_type, interlace, plte,
                             45455 if srgb else gamma, sig_bit, gray), orient


def _check_size(h, w):
    """OpenCV's limits on a decoded image (validateInputImageSize)."""
    if not (0 < w <= 1 << 20 and 0 < h <= 1 << 20 and w * h <= 1 << 30):
        raise ValueError(f"image size {h}x{w} exceeds cv2.imdecode's limits")


_PNG_FORMS = {(b, 0) for b in (1, 2, 4, 8, 16)} | {(8, 2), (16, 2), (8, 4), (16, 4), (8, 6),
                                                    (16, 6)} | {(b, 3) for b in (1, 2, 4, 8)}


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


def is_png(data: bytes) -> bool:
    return bytes(data[:8]) == PNG_SIGNATURE


def is_bmp(data: bytes) -> bool:
    return bytes(data[:2]) == b"BM"


def is_gif(data: bytes) -> bool:
    return bytes(data[:6]) in (b"GIF87a", b"GIF89a")


def is_webp(data: bytes) -> bool:
    """A RIFF file: cv2 reads WebP only, and fails the rest."""
    return bytes(data[:4]) == b"RIFF"


def is_tiff(data: bytes) -> bool:
    return bytes(data[:4]) in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")


def is_pnm(data: bytes) -> bool:
    """P1-P6 followed by whitespace (OpenCV's signature check)."""
    return (len(data) >= 3 and data[0] == 0x50 and 0x31 <= data[1] <= 0x36
            and data[2] in b" \t\n\v\f\r")


def peek_shape(data: bytes):
    """(h, w, c) from the header without a full decode."""
    if is_jpeg(data):
        return _peek_jpeg(data)
    if is_png(data):
        w, h = struct.unpack(">II", data[16:24])
        c = {0: 1, 2: 3, 3: 3, 4: 2, 6: 4}.get(data[25], 3)
        return h, w, c
    if data[:2] == b"BM":
        w, h = struct.unpack("<ii", data[18:26])
        return abs(h), w, 3
    if is_gif(data):
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
    if is_tiff(data) or is_pnm(data):
        # the reference decodes in full: cv2 turns a TIFF by its Orientation tag
        h, w, orient, _ = native_header(data, native_kind(data))
        return (w, h, 3) if orient >= 5 else (h, w, 3)
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
