"""Host-half bindings of the hybrid JPEG path (counterpart of
``dali_tpu/native/__init__.py`` for what the main path calls).

* ``jpeg_coef_info`` / ``jpeg_coef_info_batch`` — the header scan, a numpy
  marker parser of SOF0/SOF1/SOF2 streams (the reference asks libjpeg).
* ``TaskPool``, ``coef_pack_batch``, ``pack_wire2``, ``coef_dense_batch``,
  ``pack_wire`` — ctypes bindings of ``build/libdali_tpu_torch_host.so`` (see
  ``build.py``), built from source at first use.
* ``coef_full_batch`` / ``jpeg_read_coeffs`` — the int16 coefficient read
  (counterpart of ``dali_tpu.native.jpeg_read_coeffs``), and
  ``jpeg_scaled_dims`` / ``decode_jpeg`` / ``decode_jpeg_batch`` — the
  libjpeg-free pixel decode (``csrc/host/jpeg_decode.cc``), uint8 equal to
  libjpeg-turbo's ``JDCT_ISLOW`` output, or for CMYK/YCCK streams to the
  reference's cv2 route.
* ``png_decode`` and ``bmp_shape`` / ``decode_bmp`` — the PNG and BMP pixel
  stages (``csrc/host/png_decode.cc``, ``bmp_decode.cc``), uint8/uint16
  equal to ``cv2.imdecode``.
* ``warp_affine``, ``warp_perspective`` and ``remap`` — one HWC image
  through an inverse affine map, a homography or two coordinate maps
  (``csrc/host/warp_affine.cc``), equal to ``cv2.warpAffine``,
  ``cv2.warpPerspective`` and ``cv2.remap``.
* ``median_blur_u8``, ``morph_u8``, ``clahe_f32``, ``sep_conv_f32``,
  ``filter2d_f32``, ``debayer_bilinear`` and ``debayer_edge_aware`` — the
  image filters of ``csrc/host/host_ops.cc``.
* ``jpeg_encode_coefs`` / ``jpeg_roundtrip`` — the JPEG encoder's front half
  (``csrc/host/jpeg_encode.cc``) and the round trip through the decoder.
* ``webp_info``, ``tiff_info`` / ``tiff_chunks``, ``pnm_info`` and
  ``decode_images_batch`` — the WebP, TIFF and PNM decoders
  (``csrc/host/webp_*.cc``, ``tiff_decode.cc`` with ``inflate.cc`` for
  Deflate, ``pnm_decode.cc``), a batch in one call on the task pool, equal
  to ``cv2.imdecode``; ``inflate_zlib`` and ``webp_alpha`` expose the
  inflate and the ``ALPH`` decode alone.
* ``VideoFile``, ``VideoPixfmtChanged``, ``has_video`` and
  ``video_read_batch`` — frame-accurate reads of MP4, AVI, MPEG-PS,
  MPEG-TS and MPEG-1/2 elementary stream video: MPEG-4 Part 2 (XviD/DivX
  B-VOPs and packed bitstreams included), MPEG-1/2, Motion JPEG and raw
  4:2:0 (``csrc/host/mp4_demux.cc``, ``avi_demux.cc``,
  ``mpeg_ps_demux.cc``, ``mpeg_ts_demux.cc``, ``mpeg4_decode.cc``,
  ``mpeg12_decode.cc``, ``mjpeg_decode.cc``, ``video_decode.cc``), with the
  signatures and errors of ``dali_tpu.native``'s FFmpeg-backed ones and its
  frames bit for bit (frames in display order after a seek, where the
  reference misplaces those of AVI streams with B-VOPs or MPEG-1/2, and of
  MPEG-PS and TS streams after a backward seek).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_LIB = None
_LIB_LOCK = threading.Lock()


def host_lib():
    """The host library, built and loaded once per process."""
    global _LIB
    from . import build

    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build.host_library())
            vp, ll = ctypes.c_void_p, ctypes.c_longlong
            ip, lp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long)
            llp = ctypes.POINTER(ctypes.c_longlong)
            lib.dali_tpu_pool_create.restype = vp
            lib.dali_tpu_pool_create.argtypes = [ctypes.c_int]
            lib.dali_tpu_pool_destroy.restype = None
            lib.dali_tpu_pool_destroy.argtypes = [vp]
            lib.dali_tpu_torch_coef_pack_batch.restype = ctypes.c_int
            lib.dali_tpu_torch_coef_pack_batch.argtypes = (
                [vp, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
                 ctypes.c_int, ctypes.c_int, ctypes.c_int]
                + [ip] * 8 + [lp] * 4 + [vp] * 7 + [ip, llp, llp,
                                                    ctypes.POINTER(ctypes.c_void_p), llp])
            lib.dali_tpu_pack_wire2.restype = None
            lib.dali_tpu_pack_wire2.argtypes = [vp, vp, ll, vp, ll, vp, vp, ll, ll, ll, ll,
                                                vp, vp, vp, vp, vp, vp, llp]
            lib.dali_tpu_torch_coef_dense_batch.restype = ctypes.c_int
            lib.dali_tpu_torch_coef_dense_batch.argtypes = (
                [vp, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
                 ctypes.c_int, ctypes.c_int, ctypes.c_int]
                + [ip] * 8 + [lp] * 4 + [vp] * 5 + [ip])
            ci = ctypes.c_int
            sp = ctypes.POINTER(ctypes.c_void_p)
            lib.dali_tpu_torch_coef_full_batch.restype = ci
            lib.dali_tpu_torch_coef_full_batch.argtypes = (
                [vp, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t), ci, ci, ci,
                 sp, ctypes.c_long, sp, sp, ctypes.c_long] + [ip] * 4 + [vp, ip])
            lib.dali_tpu_torch_jpeg_scaled_dims.restype = ci
            lib.dali_tpu_torch_jpeg_scaled_dims.argtypes = [vp, ctypes.c_size_t, ci, ip, ip, ip]
            lib.dali_tpu_torch_decode_jpeg_batch.restype = ci
            lib.dali_tpu_torch_decode_jpeg_batch.argtypes = [
                vp, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t), ip, sp,
                lp, ip, ip, ci, ci, ci, ip]
            u8p, sz = ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t
            lib.dali_tpu_torch_png_decode.restype = ci
            lib.dali_tpu_torch_png_decode.argtypes = [u8p, sz, ci, ci, ci, ci, ci, u8p, ci, ci,
                                                      ci, ci, vp]
            lib.dali_tpu_torch_bmp_info.restype = ci
            lib.dali_tpu_torch_bmp_info.argtypes = [u8p, sz, ip, ip]
            lib.dali_tpu_torch_bmp_decode.restype = ci
            lib.dali_tpu_torch_bmp_decode.argtypes = [u8p, sz, ci, vp]
            lib.dali_tpu_pack_wire.restype = None
            lib.dali_tpu_pack_wire.argtypes = [vp, vp, ll, ci, vp, ll, ci, vp, vp, ll, ll,
                                               vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, llp]
            lib.dali_tpu_torch_warp_affine.restype = ci
            lib.dali_tpu_torch_warp_affine.argtypes = [vp, ci, ci, ci, ci, vp, ci, ci, vp, ci,
                                                       ctypes.c_double]
            for name in ("dali_tpu_torch_warp_perspective", "dali_tpu_torch_remap"):
                f = getattr(lib, name)
                f.restype = ci
                f.argtypes = [vp, ci, ci, ci, ci, vp, ci, ci] + [vp] * (
                    2 if name.endswith("remap") else 1) + [ci, ci, ctypes.c_double]
            lib.dali_tpu_torch_gif_info.restype = ci
            lib.dali_tpu_torch_gif_info.argtypes = [u8p, sz, ip, ip]
            lib.dali_tpu_torch_gif_decode.restype = ci
            lib.dali_tpu_torch_gif_decode.argtypes = [u8p, sz, ci, vp]
            lib.dali_tpu_torch_audio_decode_batch.restype = ci
            lib.dali_tpu_torch_audio_decode_batch.argtypes = [
                vp, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t), ip, ci,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)), llp, ip,
                ctypes.POINTER(ctypes.c_double), ip]
            for name in ("webp", "tiff", "pnm"):
                f = getattr(lib, f"dali_tpu_torch_{name}_info")
                f.restype = ci
                f.argtypes = [u8p, sz] + [ip] * {"webp": 3, "tiff": 5, "pnm": 3}[name]
            u64p = ctypes.POINTER(ctypes.c_uint64)
            lib.dali_tpu_torch_tiff_chunks.restype = ci
            lib.dali_tpu_torch_tiff_chunks.argtypes = [u8p, sz, ci, u64p, u64p, u64p]
            lib.dali_tpu_torch_image_decode_batch.restype = ci
            lib.dali_tpu_torch_image_decode_batch.argtypes = [
                vp, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t), ci, ip, ci,
                sp, ip]
            lib.dali_tpu_torch_webp_alpha.restype = ci
            lib.dali_tpu_torch_webp_alpha.argtypes = [vp, ctypes.c_size_t, vp]
            lib.dali_tpu_torch_inflate_zlib.restype = ci
            lib.dali_tpu_torch_inflate_zlib.argtypes = [vp, ctypes.c_size_t, vp, ctypes.c_size_t,
                                                        ctypes.POINTER(ctypes.c_size_t)]
            lib.dali_tpu_torch_video_open.restype = vp
            lib.dali_tpu_torch_video_open.argtypes = [ctypes.c_char_p, vp, sz, ctypes.c_char_p,
                                                      ci, ip]
            lib.dali_tpu_torch_video_info.restype = ci
            lib.dali_tpu_torch_video_info.argtypes = [vp, ip, ip, lp,
                                                      ctypes.POINTER(ctypes.c_double)]
            lib.dali_tpu_torch_video_pixfmt_class.restype = ci
            lib.dali_tpu_torch_video_pixfmt_class.argtypes = [vp]
            lib.dali_tpu_torch_video_error.restype = ctypes.c_char_p
            lib.dali_tpu_torch_video_error.argtypes = [vp]
            lib.dali_tpu_torch_video_codec.restype = ctypes.c_char_p
            lib.dali_tpu_torch_video_codec.argtypes = [vp]
            lib.dali_tpu_torch_video_read_frames.restype = ci
            lib.dali_tpu_torch_video_read_frames.argtypes = [vp, ctypes.c_long, ci, ci, vp]
            lib.dali_tpu_torch_video_read_frames_yuv.restype = ci
            lib.dali_tpu_torch_video_read_frames_yuv.argtypes = [vp, ctypes.c_long, ci, ci, vp,
                                                                 vp, vp]
            lib.dali_tpu_torch_video_read_batch.restype = None
            lib.dali_tpu_torch_video_read_batch.argtypes = [vp, sp, lp, ip, ip, sp, sp, sp, ci,
                                                            ci, ip]
            lib.dali_tpu_torch_video_close.restype = None
            lib.dali_tpu_torch_video_close.argtypes = [vp]
            lib.dali_tpu_torch_video_index_bytes.restype = ctypes.c_long
            lib.dali_tpu_torch_video_index_bytes.argtypes = [vp]
            lib.dali_tpu_torch_sws_rgb.restype = ci
            lib.dali_tpu_torch_sws_rgb.argtypes = [ci, ci, ci, ci, sp, ip, vp]
            lib.dali_tpu_torch_sws_clock.restype = None
            lib.dali_tpu_torch_sws_clock.argtypes = [ci, ctypes.POINTER(ctypes.c_double), lp]
            _LIB = lib
    return _LIB


class TaskPool:
    """Native worker pool (``tasking.cc``) owned by one decoder operator."""

    def __init__(self, num_threads: int):
        self._lib = host_lib()
        self.handle = self._lib.dali_tpu_pool_create(int(num_threads))

    def close(self):
        if self.handle:
            self._lib.dali_tpu_pool_destroy(self.handle)
            self.handle = None


_SHARED_POOLS = {}
_POOLS_LOCK = threading.Lock()


def shared_pool(num_threads: int) -> TaskPool:
    """A process-wide pool of ``num_threads`` workers (the reference's
    ``native.shared_pool``): per-call operators, as eager mode makes them,
    share it instead of each starting threads. Never destroyed."""
    n = max(int(num_threads), 1)
    with _POOLS_LOCK:
        if n not in _SHARED_POOLS:
            _SHARED_POOLS[n] = TaskPool(n)
        return _SHARED_POOLS[n]


# ------------------------------------------------------------------ header scan
_SOF_SUPPORTED = (0xC0, 0xC1, 0xC2, 0xC9, 0xCA)
_SOF_ANY = tuple(m for m in range(0xC0, 0xD0) if m not in (0xC4, 0xC8, 0xCC))


def jpeg_coef_info(data) -> np.ndarray:
    """[7] int32 (h, w, y_bh, y_bw, c_bh, c_bw, mode) of one JPEG stream.

    mode 0 = 4:2:0, 1 = 4:4:4 (or grayscale), 2 = 4:2:2, -1 = anything the
    hybrid wire cannot carry (not a baseline/extended/progressive 8-bit
    stream, RGB colour space, other sampling, distinct Cb/Cr quant tables).
    Block extents are MCU-padded, as the interleaved scan codes them."""
    out = np.zeros(7, np.int32)
    out[6] = -1
    b = memoryview(np.ascontiguousarray(data).view(np.uint8).reshape(-1)) \
        if not isinstance(data, (bytes, bytearray)) else memoryview(data)
    n = len(b)
    if n < 4 or b[0] != 0xFF or b[1] != 0xD8:
        return out
    pos, jfif, adobe = 2, False, None
    while pos + 4 <= n:
        if b[pos] != 0xFF:
            return out
        m = b[pos + 1]
        if m == 0xFF:
            pos += 1
            continue
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            pos += 2
            continue
        if m in (0xD9, 0xDA):
            return out
        seg_len = (b[pos + 2] << 8) | b[pos + 3]
        seg = b[pos + 4:pos + 2 + seg_len]
        if m == 0xE0 and bytes(seg[:5]) == b"JFIF\x00":
            jfif = True
        elif m == 0xEE and bytes(seg[:5]) == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif m in _SOF_ANY:
            if m not in _SOF_SUPPORTED or len(seg) < 6:
                return out
            prec, h, w, nc = seg[0], (seg[1] << 8) | seg[2], (seg[3] << 8) | seg[4], seg[5]
            if prec != 8 or h == 0 or w == 0 or len(seg) < 6 + 3 * nc:
                return out
            comps = [(seg[6 + 3 * i], seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 15, seg[8 + 3 * i])
                     for i in range(nc)]
            if nc == 1:
                yb, xb = (h + 7) // 8, (w + 7) // 8
                out[:] = (h, w, yb, xb, yb, xb, 1)
                return out
            if nc != 3:
                return out
            ids = tuple(c[0] for c in comps)
            rgb = (not jfif) and (adobe == 0 if adobe is not None else ids == (82, 71, 66))
            samp = tuple((c[1], c[2]) for c in comps)
            if rgb or comps[1][3] != comps[2][3]:
                return out
            if samp == ((2, 2), (1, 1), (1, 1)):
                out[:] = (h, w, (h + 15) // 16 * 2, (w + 15) // 16 * 2,
                          (h + 15) // 16, (w + 15) // 16, 0)
            elif samp == ((2, 1), (1, 1), (1, 1)):
                yb = (h + 7) // 8
                out[:] = (h, w, yb, (w + 15) // 16 * 2, yb, (w + 15) // 16, 2)
            elif samp == ((1, 1), (1, 1), (1, 1)):
                yb, xb = (h + 7) // 8, (w + 7) // 8
                out[:] = (h, w, yb, xb, yb, xb, 1)
            return out
        pos += 2 + seg_len
    return out


def jpeg_coef_info_batch(datas) -> np.ndarray:
    """[n, 7] int32 header scan of a batch (rows as in ``jpeg_coef_info``)."""
    return np.stack([jpeg_coef_info(d) for d in datas]) if len(datas) else np.zeros((0, 7), np.int32)


def decode_idx_blob_bytes(mcus_x: int, mcus_y: int) -> int:
    """Size of a per-file ROI decode-index blob (jpeg_huff.cc IdxHeader +
    one IdxEntry per MCU + 1)."""
    return 16 + (int(mcus_x) * int(mcus_y) + 1) * 24


# ------------------------------------------------------------------ batch decode
def _ptr(a: np.ndarray, ctype=ctypes.c_void_p):
    return a.ctypes.data_as(ctype) if ctype is not ctypes.c_void_p else ctypes.c_void_p(a.ctypes.data)


def _batch_args(datas, blocks, brc0, c_brc0, ky, kc):
    """The per-sample arguments both batch entries share: file byte arrays,
    the eight int32 block columns and the four plane offset arrays."""
    arrs = [np.ascontiguousarray(d).view(np.uint8).reshape(-1) for d in datas]
    cols = [np.ascontiguousarray(a[:, j], np.int32)
            for a, k in ((blocks, 4), (brc0, 2), (c_brc0, 2)) for j in range(k)]
    y_n = cols[0].astype(np.int64) * cols[1]
    c_n = cols[2].astype(np.int64) * cols[3]

    def excl(v):
        return np.concatenate([[0], np.cumsum(v)[:-1]]).astype(np.int64)

    offs = {"y_dc": excl(y_n), "y_ac": excl(y_n * (ky * ky - 1)),
            "c_dc": excl(2 * c_n), "c_ac": excl(2 * c_n * (kc * kc - 1))}
    n = len(arrs)
    ip, lp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long)
    args = [ctypes.cast((ctypes.c_void_p * n)(*[a.ctypes.data for a in arrs]),
                        ctypes.POINTER(ctypes.c_char_p)),
            (ctypes.c_size_t * n)(*[a.nbytes for a in arrs]), n, ky, kc,
            *[_ptr(c, ip) for c in cols],
            *[_ptr(offs[k], lp) for k in ("y_dc", "y_ac", "c_dc", "c_ac")]]
    # the arrays stay referenced through the call
    return args, offs, (arrs, cols), (y_n, c_n)


def _raise_bad(oks, n):
    bad = [i for i in range(n) if not oks[i]]
    if bad:
        raise ValueError(
            f"hybrid JPEG decode failed for sample(s) {bad}: neither the baseline nor "
            "the progressive entropy decoder reads them (dali_tpu_torch has no libjpeg "
            "fallback)")


def coef_pack_batch(pool: TaskPool, datas, ky, kc, blocks, brc0, c_brc0, flat_lens,
                    idx_blobs=None):
    """File bytes -> sparse coefficient wire for the block windows of a batch.

    blocks [n, 4] = window (ybh, ybw, cbh, cbw); brc0 / c_brc0 [n, 2] = luma
    and chroma block origins; flat_lens = ratcheted plane capacities.
    Returns (y_dc, y_mask, y_vals, y_total, c_dc, c_mask, c_vals, c_total,
    q [n, ky²+kc²] int32, offs). Raises ValueError if a sample does not
    decode."""
    lib = host_lib()
    n = len(datas)
    args, offs, _keep, _ = _batch_args(datas, blocks, brc0, c_brc0, ky, kc)
    y_dc = np.empty((flat_lens[0],), np.int16)
    y_mask = np.empty((flat_lens[0],), np.uint16)
    y_vals = np.empty((flat_lens[1] + 16,), np.int8)
    c_dc = np.empty((flat_lens[2],), np.int16)
    c_mask = np.empty((flat_lens[2],), np.uint16)
    c_vals = np.empty((flat_lens[3] + 16,), np.int8)
    q = np.empty((n, ky * ky + kc * kc), np.uint16)
    oks = (ctypes.c_int * n)()
    y_total, c_total = ctypes.c_longlong(0), ctypes.c_longlong(0)
    if idx_blobs is not None:
        idx_ptrs = (ctypes.c_void_p * n)(*[b.ctypes.data if b is not None else None for b in idx_blobs])
        idx_caps = (ctypes.c_longlong * n)(*[b.nbytes if b is not None else 0 for b in idx_blobs])
    else:
        idx_ptrs = ctypes.cast(None, ctypes.POINTER(ctypes.c_void_p))
        idx_caps = ctypes.cast(None, ctypes.POINTER(ctypes.c_longlong))
    lib.dali_tpu_torch_coef_pack_batch(
        pool.handle, *args,
        _ptr(y_dc), _ptr(y_mask), _ptr(y_vals), _ptr(c_dc), _ptr(c_mask), _ptr(c_vals), _ptr(q),
        oks, ctypes.byref(y_total), ctypes.byref(c_total), idx_ptrs, idx_caps)
    _raise_bad(oks, n)
    return (y_dc, y_mask, y_vals, int(y_total.value), c_dc, c_mask, c_vals,
            int(c_total.value), q.astype(np.int32), offs)


def coef_dense_batch(pool: TaskPool, datas, ky, kc, blocks, brc0, c_brc0, flat_lens=(0, 0, 0, 0)):
    """File bytes -> dense coefficient planes of the block windows of a
    batch (``coef_dense_batch.cc``), each sample's planes packed at ``offs``
    with no padding: y_dc int16 [ybh*ybw], y_ac int8 [ybh*ybw*(ky²-1)], c_dc
    int16 [2*cbh*cbw] (Cb then Cr), c_ac int8 [2*cbh*cbw*(kc²-1)]. Zero
    origins and the image's block extents read whole images. The buffers
    hold at least ``flat_lens`` elements (ratcheted plane capacities).
    Returns (y_dc, y_ac, c_dc, c_ac, q [n, ky²+kc²] int32, offs). Raises
    ValueError if a sample does not decode."""
    n = len(datas)
    args, offs, _keep, (y_n, c_n) = _batch_args(datas, blocks, brc0, c_brc0, ky, kc)
    need = (y_n.sum(), (y_n * (ky * ky - 1)).sum(), 2 * c_n.sum(),
            (2 * c_n * (kc * kc - 1)).sum())
    y_dc, y_ac, c_dc, c_ac = (np.empty((max(int(m), int(f)),), dt) for m, f, dt in zip(
        need, flat_lens, (np.int16, np.int8, np.int16, np.int8)))
    q = np.empty((n, ky * ky + kc * kc), np.uint16)
    oks = (ctypes.c_int * n)()
    host_lib().dali_tpu_torch_coef_dense_batch(
        pool.handle, *args, _ptr(y_dc), _ptr(y_ac), _ptr(c_dc), _ptr(c_ac), _ptr(q), oks)
    _raise_bad(oks, n)
    return y_dc, y_ac, c_dc, c_ac, q.astype(np.int32), offs


def pack_wire(pool: TaskPool, y_ac, ny_blocks, nac_y, c_ac, nc_blocks, nac_c, y_dc, c_dc,
              y_dc_len, c_dc_len, y_mask, y_nibs, y_vals, c_mask, c_nibs, c_vals,
              y_dc8, y_esc16, c_dc8, c_esc16):
    """Dense planes -> the sparse wire in one call (``sparse_pack.cc``
    ``dali_tpu_pack_wire``): both AC planes to bitmaps + nibble-packed
    values (escapes in place at the front of the vals buffers), both DC
    planes escape-packed to int8. Returns (y_nnz, y_val_esc, c_nnz,
    c_val_esc, y_dc_esc, c_dc_esc)."""
    if not (y_ac.dtype == c_ac.dtype == np.int8 and y_dc.dtype == c_dc.dtype == np.int16):
        raise ValueError("pack_wire takes int8 AC and int16 DC planes")
    if not (y_vals.shape[0] >= ny_blocks * nac_y + 16 and c_vals.shape[0] >= nc_blocks * nac_c + 16
            and y_nibs.shape[0] >= (ny_blocks * nac_y + 1) // 2
            and c_nibs.shape[0] >= (nc_blocks * nac_c + 1) // 2
            and y_mask.shape[0] >= ny_blocks and c_mask.shape[0] >= nc_blocks
            and y_dc8.shape[0] >= y_dc_len and c_dc8.shape[0] >= c_dc_len
            and y_dc.shape[0] >= ny_blocks and c_dc.shape[0] >= nc_blocks
            and y_ac.shape[0] >= ny_blocks * nac_y and c_ac.shape[0] >= nc_blocks * nac_c
            and y_esc16.shape[0] >= ny_blocks and c_esc16.shape[0] >= nc_blocks):
        raise ValueError("wire buffers undersized")
    counts = (ctypes.c_longlong * 6)()
    host_lib().dali_tpu_pack_wire(
        pool.handle, _ptr(y_ac), int(ny_blocks), int(nac_y), _ptr(c_ac), int(nc_blocks),
        int(nac_c), _ptr(y_dc), _ptr(c_dc), int(y_dc_len), int(c_dc_len), _ptr(y_mask),
        _ptr(y_nibs), _ptr(y_vals), _ptr(c_mask), _ptr(c_nibs), _ptr(c_vals), _ptr(y_dc8),
        _ptr(y_esc16), _ptr(c_dc8), _ptr(c_esc16), counts)
    return tuple(int(c) for c in counts)


def pack_wire2(pool: TaskPool, y_vals, y_nnz, c_vals, c_nnz, y_dc, c_dc, ny_blocks,
               nc_blocks, y_dc_len, c_dc_len, y_nibs, c_nibs, y_dc8, y_esc16, c_dc8, c_esc16):
    """Nibble-pack both AC value streams (escapes in place at the front of
    the vals buffers) and escape-pack both DC planes. Returns the escape
    counts (y_val_esc, c_val_esc, y_dc_esc, c_dc_esc)."""
    if not (y_nibs.shape[0] >= (y_nnz + 1) // 2 and c_nibs.shape[0] >= (c_nnz + 1) // 2
            and y_dc8.shape[0] >= y_dc_len and c_dc8.shape[0] >= c_dc_len
            and y_esc16.shape[0] >= ny_blocks and c_esc16.shape[0] >= nc_blocks):
        raise ValueError("wire buffers undersized")
    counts = (ctypes.c_longlong * 4)()
    host_lib().dali_tpu_pack_wire2(
        pool.handle, _ptr(y_vals), int(y_nnz), _ptr(c_vals), int(c_nnz), _ptr(y_dc), _ptr(c_dc),
        int(ny_blocks), int(nc_blocks), int(y_dc_len), int(c_dc_len),
        _ptr(y_nibs), _ptr(c_nibs), _ptr(y_dc8), _ptr(y_esc16), _ptr(c_dc8), _ptr(c_esc16),
        counts)
    return tuple(int(c) for c in counts)


# ------------------------------------------------------------------ int16 read and pixel decode
UNSUPPORTED_JPEG = (
    "this JPEG is not read by dali_tpu_torch's libjpeg-free decoder: 12-bit precision or "
    "lossless coding (ROADMAP.md, Queue 1 item 1b)")

# Codes of a decoded sample from ``decode_jpeg_batch``: the route the
# reference takes for it. libjpeg decodes the stream, or (CMYK and YCCK, which
# libjpeg will not give as RGB or grey) it falls back to cv2.imdecode; the
# port's output is that route's.
ROUTE_LIBJPEG = 0
ROUTE_CV2 = 2


def _raise_rc(rcs, what):
    """Raise for the first sample whose return code is not a decoded one: 1
    (a stream the reader does not take) raises NotImplementedError, anything
    else (corrupt) ValueError, as libjpeg's error exit makes the reference
    fail."""
    bad = [i for i, rc in enumerate(rcs) if rc not in (ROUTE_LIBJPEG, ROUTE_CV2)]
    if not bad:
        return
    if any(rcs[i] == 1 for i in bad):
        raise NotImplementedError(
            f"{what}: sample(s) {[i for i in bad if rcs[i] == 1]}: {UNSUPPORTED_JPEG}")
    raise ValueError(f"{what} failed for sample(s) {bad}: corrupt JPEG stream")


def _byte_arrays(datas):
    arrs = [np.ascontiguousarray(np.frombuffer(d, np.uint8) if isinstance(d, (bytes, bytearray))
                                 else d).view(np.uint8).reshape(-1) for d in datas]
    n = len(arrs)
    ptrs = ctypes.cast((ctypes.c_void_p * n)(*[a.ctypes.data for a in arrs]),
                       ctypes.POINTER(ctypes.c_char_p))
    return arrs, ptrs, (ctypes.c_size_t * n)(*[a.nbytes for a in arrs])


def _pool_handle(pool):
    return None if pool is None else pool.handle


def coef_full_batch(pool, datas, ky, kc, blocks, y_canvas, c_canvas):
    """The int16 coefficient wire of a batch, written into padded canvases:
    sample i's k x k corners (luma ky, chroma kc, natural order) over its
    ``blocks[i]`` = (ybh, ybw, cbh, cbw) extent, at the top left of
    ``y_canvas[i]`` [YH, YW, ky²] and ``c_canvas[i]`` [2, CH, CW, kc²] (int16,
    C-contiguous). Blocks past a component's real extent are zero; grayscale
    streams get zero chroma and a chroma table of ones. Returns the tables
    [n, ky²+kc²] int32; raises for a sample that does not read."""
    n = len(datas)
    arrs, ptrs, lens = _byte_arrays(datas)
    if not (y_canvas.dtype == c_canvas.dtype == np.int16 and y_canvas.flags.c_contiguous
            and c_canvas.flags.c_contiguous and y_canvas.shape[0] >= n
            and c_canvas.shape[0] >= n and y_canvas.shape[3] == ky * ky
            and c_canvas.shape[4] == kc * kc):
        raise ValueError("coef_full_batch: canvases must be C-contiguous int16 "
                         "[n, YH, YW, ky²] and [n, 2, CH, CW, kc²]")
    blocks = np.asarray(blocks, np.int32)
    if n and ((blocks[:, 0] > y_canvas.shape[1]).any() or (blocks[:, 1] > y_canvas.shape[2]).any()
              or (blocks[:, 2] > c_canvas.shape[2]).any()
              or (blocks[:, 3] > c_canvas.shape[3]).any()):
        raise ValueError("coef_full_batch: block extents exceed the canvases")
    cols = [np.ascontiguousarray(blocks[:, j]) for j in range(4)]
    vpp = ctypes.c_void_p * n
    y_ptrs = vpp(*[y_canvas[i].ctypes.data for i in range(n)])
    cb_ptrs = vpp(*[c_canvas[i, 0].ctypes.data for i in range(n)])
    cr_ptrs = vpp(*[c_canvas[i, 1].ctypes.data for i in range(n)])
    q = np.empty((n, ky * ky + kc * kc), np.uint16)
    rcs = (ctypes.c_int * n)()
    ip = ctypes.POINTER(ctypes.c_int)
    host_lib().dali_tpu_torch_coef_full_batch(
        _pool_handle(pool), ptrs, lens, n, int(ky), int(kc), y_ptrs, int(y_canvas.shape[2]),
        cb_ptrs, cr_ptrs, int(c_canvas.shape[3]), *[_ptr(c, ip) for c in cols], _ptr(q), rcs)
    _raise_rc(list(rcs), "JPEG coefficient read")
    del arrs
    return q.astype(np.int32)


def jpeg_read_coeffs(data, ky: int, kc: int, y_bh: int, y_bw: int, c_bh: int, c_bw: int):
    """One stream's int16 coefficient planes: (y [y_bh, y_bw, ky²] int16,
    c [2, c_bh, c_bw, kc²] int16, q [ky²+kc²] uint16), the layout of
    ``dali_tpu.native.jpeg_read_coeffs``. Raises where that returns None."""
    y = np.zeros((1, y_bh, y_bw, ky * ky), np.int16)
    c = np.zeros((1, 2, c_bh, c_bw, kc * kc), np.int16)
    q = coef_full_batch(None, [data], ky, kc, [[y_bh, y_bw, c_bh, c_bw]], y, c)
    return y[0], c[0], q[0].astype(np.uint16)


def jpeg_scaled_dims(data, denom: int = 1):
    """(h, w, components) of a JPEG decoded at 1/denom scale (rounded up, as
    libjpeg does). Raises for a stream the decoder does not take."""
    arrs, ptrs, lens = _byte_arrays([data])
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = host_lib().dali_tpu_torch_jpeg_scaled_dims(
        arrs[0].ctypes.data, lens[0], int(denom), ctypes.byref(h),
        ctypes.byref(w), ctypes.byref(c))
    if rc == -3:
        raise ValueError(f"JPEG scale denominator must be 1, 2, 4 or 8 (got {denom})")
    _raise_rc([rc], "JPEG header read")
    return h.value, w.value, c.value


def decode_jpeg_batch(pool, datas, dsts, denoms, heights, widths, fancy=True, gray=False):
    """Decode a batch of JPEGs with one native call, each into the top left
    of its destination view ``dsts[i]`` (uint8 [>=h, >=w, 3] or, with
    ``gray``, [>=h, >=w, 1]; rows may be strided, pixels contiguous).
    Returns each sample's code: ``ROUTE_LIBJPEG`` or ``ROUTE_CV2`` when it
    decoded, 1 for a form the decoder does not read, -1 for a corrupt
    stream; the caller decides what a failed sample raises."""
    n = len(datas)
    if any(int(d) not in (1, 2, 4, 8) for d in denoms):
        raise ValueError(f"JPEG scale denominators must be 1, 2, 4 or 8 (got {list(denoms)})")
    arrs, ptrs, lens = _byte_arrays(datas)
    ch = 1 if gray else 3
    for i, d in enumerate(dsts):
        if (d.dtype != np.uint8 or d.shape[0] < heights[i] or d.shape[1] < widths[i]
                or d.shape[2] != ch or d.strides[1] != ch or d.strides[2] != 1):
            raise ValueError("decode_jpeg_batch: destination too small or not pixel-contiguous")
    ci = ctypes.c_int * n
    rcs = ci()
    host_lib().dali_tpu_torch_decode_jpeg_batch(
        _pool_handle(pool), ptrs, lens, ci(*[int(v) for v in denoms]),
        (ctypes.c_void_p * n)(*[d.ctypes.data for d in dsts]),
        (ctypes.c_long * n)(*[d.strides[0] for d in dsts]), ci(*[int(v) for v in heights]),
        ci(*[int(v) for v in widths]), 1 if fancy else 0, 1 if gray else 0, n, rcs)
    if any(rc == -2 for rc in rcs):
        raise ValueError("decode_jpeg_batch: decoded size differs from the expected size")
    del arrs
    return list(rcs)


def decode_jpeg_routed(data, denom: int = 1, fancy_upsampling: bool = True, gray: bool = False):
    """(image, code): one JPEG to HWC uint8, RGB or (``gray``) one channel,
    at 1/denom scale, with the route it took (``ROUTE_LIBJPEG`` or
    ``ROUTE_CV2``). Raises for a stream that does not decode."""
    h, w, _ = jpeg_scaled_dims(data, denom)
    out = np.empty((h, w, 1 if gray else 3), np.uint8)
    rcs = decode_jpeg_batch(None, [data], [out], [denom], [h], [w], fancy_upsampling, gray)
    _raise_rc(rcs, "JPEG decode")
    return out, rcs[0]


def decode_jpeg(data, denom: int = 1, fancy_upsampling: bool = True, gray: bool = False):
    """One JPEG to HWC uint8, RGB or (``gray``) one channel, at 1/denom scale
    (counterpart of ``dali_tpu.native.decode_jpeg``, which returns None where
    this raises, and None for CMYK/YCCK streams, which this decodes as the
    reference's cv2 route does)."""
    return decode_jpeg_routed(data, denom, fancy_upsampling, gray)[0]


# ------------------------------------------------------------------ FLAC, MP3 and Ogg Vorbis
AUDIO_CODECS = {"mp3": 1, "vorbis": 2, "flac": 3}
AUDIO_MALFORMED, AUDIO_UNSUPPORTED, _AUDIO_NO_MEMORY = -1, -2, -3


class _Malloced:
    """A float32 buffer the host library malloc'd, seen by numpy without a
    copy and freed with the last array over it."""

    def __init__(self, ptr, n, free):
        self._ptr, self._free = ptr, free
        self.__array_interface__ = {"shape": (n,), "typestr": "<f4", "version": 3,
                                    "data": (ctypes.cast(ptr, ctypes.c_void_p).value, False)}

    def __del__(self):
        self._free(self._ptr)


def decode_audio_codec_batch(pool, datas, codecs):
    """Decode a batch of FLAC (``flac_decode.cc``), MP3 (``mp3_decode.cc``)
    and Ogg Vorbis (``vorbis_decode.cc``) streams with one native call
    (``audio_decode_batch.cc``), each on a worker of ``pool`` (inline
    without one); ``codecs[i]`` is "flac", "mp3" or "vorbis". Returns, per
    stream, (float32 [n] or [n, channels], sample rate), or the failure
    code: AUDIO_MALFORMED where the reference's decoder fails or yields
    nothing (a FLAC frame failing its CRC too), AUDIO_UNSUPPORTED for a form
    not decoded (MPEG Layers I and II, free-format MP3, Vorbis floor 0,
    chained Ogg files). Raises MemoryError where a decode runs out of
    memory."""
    n = len(datas)
    arrs, ptrs, lens = _byte_arrays(datas)
    fp = ctypes.POINTER(ctypes.c_float)
    outs = (fp * n)()
    frames = (ctypes.c_longlong * n)()
    chans = (ctypes.c_int * n)()
    rates = (ctypes.c_double * n)()
    rcs = (ctypes.c_int * n)()
    kinds = (ctypes.c_int * n)(*[AUDIO_CODECS[c] for c in codecs])
    lib = host_lib()
    lib.dali_tpu_torch_audio_decode_batch(_pool_handle(pool), ptrs, lens, kinds, n, outs, frames,
                                          chans, rates, rcs)
    del arrs
    res = []
    for i in range(n):
        if rcs[i] != 0:
            res.append(rcs[i])
            continue
        x = np.asarray(_Malloced(outs[i], frames[i] * chans[i], lib.dali_tpu_torch_audio_free))
        res.append((x.reshape(frames[i], chans[i]) if chans[i] > 1 else x, float(rates[i])))
    if _AUDIO_NO_MEMORY in rcs:
        raise MemoryError(f"out of memory decoding audio stream "
                          f"{list(rcs).index(_AUDIO_NO_MEMORY)} of the batch")
    return res


# ------------------------------------------------------------------ PNG and BMP pixels
def _u8(a):
    a = np.ascontiguousarray(np.frombuffer(a, np.uint8) if isinstance(a, (bytes, bytearray))
                             else a).view(np.uint8).reshape(-1)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def png_decode(raw, w, h, bit_depth, color_type, interlace, plte=b"", gamma=0, sig_bit=0,
               gray=False):
    """The pixels of a PNG from its inflated IDAT stream (``png_decode.cc``):
    HWC RGB or (``gray``) one channel, uint16 for a 16-bit image, else uint8,
    as cv2.imdecode gives them (channel order aside). ``plte``: the PLTE
    bytes; ``gamma``: the file gamma in 1/100000 (gAMA, or sRGB's), 0 if none;
    ``sig_bit``: the largest colour sBIT value, 0 if none. Raises ValueError
    where libpng fails."""
    raw, rawp = _u8(raw)
    pal, palp = _u8(plte or b"\0")
    out = np.empty((h, w, 1 if gray else 3), np.uint16 if bit_depth == 16 else np.uint8)
    rc = host_lib().dali_tpu_torch_png_decode(
        rawp, raw.nbytes, int(w), int(h), int(bit_depth), int(color_type), int(interlace), palp,
        len(plte) // 3, int(gamma), int(sig_bit), 1 if gray else 0, out.ctypes.data)
    if rc != 0:
        raise ValueError("PNG decode failed: not enough image data or a bad filter type")
    return out


def bmp_shape(data):
    """(h, w) of a BMP as OpenCV reads it; ValueError for a header it rejects."""
    arr, p = _u8(data)
    h, w = ctypes.c_int(), ctypes.c_int()
    if host_lib().dali_tpu_torch_bmp_info(p, arr.nbytes, ctypes.byref(h), ctypes.byref(w)) != 0:
        raise ValueError("BMP decode failed: unsupported or corrupt header")
    return h.value, w.value


def decode_bmp(data, gray=False):
    """One BMP to HWC uint8, RGB or (``gray``) one channel, as cv2.imdecode
    gives it (channel order aside; ``bmp_decode.cc``). Raises ValueError where
    OpenCV's reader fails."""
    h, w = bmp_shape(data)
    arr, p = _u8(data)
    out = np.empty((h, w, 1 if gray else 3), np.uint8)
    if host_lib().dali_tpu_torch_bmp_decode(p, arr.nbytes, 1 if gray else 0, out.ctypes.data) != 0:
        raise ValueError("BMP decode failed: corrupt or truncated pixel data")
    return out


def gif_shape(data):
    """(h, w) of a GIF's logical screen; ValueError for a header it rejects."""
    arr, p = _u8(data)
    h, w = ctypes.c_int(), ctypes.c_int()
    if host_lib().dali_tpu_torch_gif_info(p, arr.nbytes, ctypes.byref(h), ctypes.byref(w)) != 0:
        raise ValueError("GIF decode failed: not a GIF or a corrupt header")
    return h.value, w.value


def decode_gif(data, gray=False):
    """The first image of a GIF on its logical screen, HWC uint8 RGB or
    (``gray``) one channel, as cv2.imdecode gives it (channel order aside;
    ``gif_decode.cc``). Raises ValueError for a malformed stream."""
    h, w = gif_shape(data)
    arr, p = _u8(data)
    out = np.empty((h, w, 1 if gray else 3), np.uint8)
    if host_lib().dali_tpu_torch_gif_decode(p, arr.nbytes, 1 if gray else 0,
                                            out.ctypes.data) != 0:
        raise ValueError("GIF decode failed: corrupt or truncated image data")
    return out


# ------------------------------------------------------------------ WebP, TIFF and PNM
# kinds of ``decode_images_batch``; depth codes of the info calls
KIND_WEBP, KIND_TIFF, KIND_PNM = 0, 1, 2
_DEPTHS = (np.dtype(np.uint8), np.dtype(np.uint16), np.dtype(np.float32))


def webp_info(data):
    """(h, w, EXIF orientation) of a WebP, or the return code (-1 for a file
    cv2 rejects, 1 for an animation ``webp_decode.cc`` does not read)."""
    arr, p = _u8(data)
    h, w, o = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = host_lib().dali_tpu_torch_webp_info(p, arr.nbytes, ctypes.byref(h), ctypes.byref(w),
                                             ctypes.byref(o))
    return rc if rc else (h.value, w.value, o.value)


def webp_alpha(data):
    """The alpha plane [h, w] uint8 of a still lossy WebP's ``ALPH`` chunk as
    ``webp_decode.cc`` decodes it (the colour decode drops it, but fails
    where it fails), or the return code: -1 where libwebp fails the chunk
    or the file, 1 for a file without one."""
    info = webp_info(data)
    if isinstance(info, int):
        return info
    arr, p = _u8(data)
    out = np.zeros(info[:2], np.uint8)
    rc = host_lib().dali_tpu_torch_webp_alpha(p, arr.nbytes, out.ctypes.data)
    return rc if rc else out


def tiff_info(data):
    """(h, w, Orientation, output dtype, number of strips or tiles) of a TIFF,
    or the return code (-1 for a file cv2 rejects, 1 for a form
    ``tiff_decode.cc`` does not read)."""
    arr, p = _u8(data)
    v = [ctypes.c_int() for _ in range(5)]
    rc = host_lib().dali_tpu_torch_tiff_info(p, arr.nbytes, *[ctypes.byref(x) for x in v])
    if rc:
        return rc
    h, w, o, depth, n_chunks = (x.value for x in v)
    return h, w, o, _DEPTHS[depth], n_chunks


def tiff_chunks(data, n):
    """Offsets, byte counts and decoded sizes (uint64 [n] each) of a TIFF's
    first ``n`` strips or tiles."""
    arr, p = _u8(data)
    out = [np.zeros(n, np.uint64) for _ in range(3)]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    if host_lib().dali_tpu_torch_tiff_chunks(p, arr.nbytes, int(n),
                                             *[_ptr(a, u64p) for a in out]) != 0:
        raise ValueError("TIFF decode failed: corrupt strip or tile tables")
    return out


def pnm_info(data):
    """(h, w, output dtype) of a PNM, or -1 for a header cv2 rejects."""
    arr, p = _u8(data)
    h, w, depth = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = host_lib().dali_tpu_torch_pnm_info(p, arr.nbytes, ctypes.byref(h), ctypes.byref(w),
                                            ctypes.byref(depth))
    return rc if rc else (h.value, w.value, _DEPTHS[depth.value])


def decode_images_batch(pool, datas, kinds, dsts, gray=False):
    """Decode WebP, TIFF and PNM samples with one native call
    (``image_decode_batch.cc``), each on a worker of ``pool`` (inline without
    one) into ``dsts[i]`` (C-contiguous [h, w, 3], or [h, w, 1] with
    ``gray``, in the dtype the info call gave). Returns each sample's code:
    0, -1 (corrupt) or 1 (a form not read); the caller decides what a failed
    sample raises."""
    n = len(datas)
    arrs, ptrs, lens = _byte_arrays(datas)
    for d in dsts:
        if not d.flags.c_contiguous or d.shape[2] != (1 if gray else 3):
            raise ValueError("decode_images_batch: destinations must be C-contiguous HWC")
    ci = ctypes.c_int * n
    rcs = ci()
    host_lib().dali_tpu_torch_image_decode_batch(
        _pool_handle(pool), ptrs, lens, n, ci(*[int(k) for k in kinds]), 1 if gray else 0,
        (ctypes.c_void_p * n)(*[d.ctypes.data for d in dsts]), rcs)
    del arrs
    return list(rcs)


# results of ``inflate_zlib`` (``csrc/host/inflate.h``)
INFLATE_END, INFLATE_FULL, INFLATE_INPUT, INFLATE_ERROR = 0, 1, 2, -1


def inflate_zlib(data, cap):
    """(status, bytes) of the zlib stream ``data`` inflated into a buffer of
    ``cap`` bytes by ``csrc/host/inflate.cc``, which TIFF's Deflate strips
    go through: ``bytes`` is what was written, kept when the stream fails;
    the status is one of ``INFLATE_*``."""
    arr, p = _u8(data)
    out = np.zeros(max(int(cap), 1), np.uint8)
    written = ctypes.c_size_t()
    rc = host_lib().dali_tpu_torch_inflate_zlib(p, arr.nbytes, out.ctypes.data, int(cap),
                                                ctypes.byref(written))
    return rc, out[:written.value].tobytes()


# ------------------------------------------------------------------ affine warp
_WARP_DTYPES = {np.dtype(np.uint8): 0, np.dtype(np.uint16): 1, np.dtype(np.int16): 2,
                np.dtype(np.float32): 3, np.dtype(np.float64): 4, np.dtype(np.int8): 5,
                np.dtype(np.int32): 6}


def warp_affine(img: np.ndarray, matrix, out_h: int, out_w: int, nearest: bool,
                fill: float) -> np.ndarray:
    """``img`` [H, W, C] through the 2x3 destination -> source ``matrix`` to
    [out_h, out_w, C]: ``cv2.warpAffine(img, matrix, (out_w, out_h),
    flags=INTER_NEAREST or INTER_LINEAR | WARP_INVERSE_MAP,
    borderMode=BORDER_CONSTANT, borderValue=(fill,) * 4)`` (``warp_affine.cc``).
    Raises ValueError for a dtype or interpolation cv2 refuses."""
    code = _WARP_DTYPES.get(img.dtype)
    src = np.ascontiguousarray(img)
    m = np.ascontiguousarray(np.asarray(matrix, np.float64).reshape(2, 3))
    h, w, c = src.shape
    out = np.empty((int(out_h), int(out_w), c), src.dtype)
    if code is None or host_lib().dali_tpu_torch_warp_affine(
            src.ctypes.data, h, w, c, code, out.ctypes.data, out.shape[0], out.shape[1],
            m.ctypes.data, int(bool(nearest)), float(fill)) != 0:
        raise ValueError(f"warp_affine: {'nearest' if nearest else 'linear'} interpolation of "
                         f"{img.dtype} images is not supported (as in cv2.warpAffine)")
    return out


def _warp_call(name, img, out_h, out_w, extra, nearest, replicate, fill):
    code = _WARP_DTYPES.get(img.dtype)
    src = np.ascontiguousarray(img)
    h, w, c = src.shape
    out = np.empty((int(out_h), int(out_w), c), src.dtype)
    if code is None or getattr(host_lib(), name)(
            src.ctypes.data, h, w, c, code, out.ctypes.data, out.shape[0], out.shape[1],
            *[a.ctypes.data for a in extra], int(bool(nearest)), int(bool(replicate)),
            float(fill)) != 0:
        raise ValueError(f"{name[15:]}: {'nearest' if nearest else 'linear'} interpolation of "
                         f"{img.dtype} images is not supported (as in OpenCV)")
    return out


def warp_perspective(img: np.ndarray, matrix, out_h: int, out_w: int, nearest: bool,
                     replicate: bool, fill: float) -> np.ndarray:
    """``img`` [H, W, C] through the 3x3 destination -> source ``matrix`` to
    [out_h, out_w, C]: ``cv2.warpPerspective(img, matrix, (out_w, out_h),
    flags=INTER_NEAREST or INTER_LINEAR | WARP_INVERSE_MAP,
    borderMode=BORDER_REPLICATE or BORDER_CONSTANT, borderValue=(fill,) * 4)``
    (``warp_affine.cc``)."""
    m = np.ascontiguousarray(np.asarray(matrix, np.float64).reshape(3, 3))
    return _warp_call("dali_tpu_torch_warp_perspective", img, out_h, out_w, [m], nearest,
                      replicate, fill)


def remap(img: np.ndarray, mapx: np.ndarray, mapy: np.ndarray, nearest: bool,
          replicate: bool = False, fill: float = 0.0) -> np.ndarray:
    """``img`` [H, W, C] sampled at (``mapx``, ``mapy``) [oh, ow] (float32
    source coordinates): ``cv2.remap(img, mapx, mapy, INTER_NEAREST or
    INTER_LINEAR)`` with a constant (or replicate) border (``warp_affine.cc``)."""
    mx = np.ascontiguousarray(mapx, np.float32)
    my = np.ascontiguousarray(mapy, np.float32)
    if mx.ndim != 2 or mx.shape != my.shape:
        raise ValueError(f"remap: maps must be two [H, W] arrays of one shape, got "
                         f"{mx.shape} and {my.shape}")
    return _warp_call("dali_tpu_torch_remap", img, mx.shape[0], mx.shape[1], [mx, my], nearest,
                      replicate, fill)


# ------------------------------------------------------------------ image filters
def _fn(name, argtypes):
    """A host library entry with its argument types (set once)."""
    f = getattr(host_lib(), name)
    if f.argtypes is None:
        f.restype = ctypes.c_int
        f.argtypes = argtypes
    return f


_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _hwc(img, dtype):
    """(contiguous array, h, w, c) of an HW or HWC image."""
    img = np.ascontiguousarray(img, dtype)
    return img, img.shape[0], img.shape[1], img.shape[2] if img.ndim == 3 else 1


def median_blur_u8(img: np.ndarray, k: int) -> np.ndarray:
    """Median of the k x k window, replicate border (``host_ops.cc``, Huang's
    sliding histogram; ``cv2.medianBlur`` for uint8)."""
    img, h, w, c = _hwc(img, np.uint8)
    out = np.empty_like(img)
    if _fn("dali_tpu_torch_median_blur_u8", [_vp, _ci, _ci, _ci, _ci, _vp])(
            img.ctypes.data, h, w, c, int(k), out.ctypes.data) != 0:
        raise ValueError(f"median_blur_u8: bad window {k}")
    return out


def morph_u8(img: np.ndarray, mh: int, mw: int, anchor_y: int, anchor_x: int,
             iterations: int, dilate: bool, replicate: bool) -> np.ndarray:
    """Erode or dilate with a full-ones mh x mw element, ``iterations`` times
    (``host_ops.cc``, separable min/max)."""
    img, h, w, c = _hwc(img, np.uint8)
    out = np.empty_like(img)
    if _fn("dali_tpu_torch_morph_u8", [_vp] + [_ci] * 10 + [_vp])(
            img.ctypes.data, h, w, c, int(mh), int(mw), int(anchor_y), int(anchor_x),
            int(iterations), int(bool(dilate)), int(bool(replicate)), out.ctypes.data) != 0:
        raise ValueError("morph_u8: bad parameters")
    return out


def clahe_f32(plane: np.ndarray, clip: float, tiles_x: int, tiles_y: int,
              bins: int) -> np.ndarray:
    """CLAHE of one float32 plane in [0, 255] (``host_ops.cc``)."""
    plane = np.ascontiguousarray(plane, np.float32)
    out = np.empty_like(plane)
    if _fn("dali_tpu_torch_clahe_f32", [_vp, _ci, _ci, _cf, _ci, _ci, _ci, _vp])(
            plane.ctypes.data, plane.shape[0], plane.shape[1], float(clip), int(tiles_x),
            int(tiles_y), int(bins), out.ctypes.data) != 0:
        raise ValueError("clahe_f32: bins must be a power of 2")
    return out


def farneback(prev: np.ndarray, nxt: np.ndarray) -> np.ndarray:
    """Dense optical flow [H, W, 2] float32 (x, y) from grey frame ``prev``
    to grey frame ``nxt`` (float32 [H, W]): ``cv2.calcOpticalFlowFarneback(
    prev, nxt, None, 0.5, 3, 15, 3, 5, 1.2, 0)`` (``optical_flow.cc``)."""
    a = np.ascontiguousarray(prev, np.float32)
    b = np.ascontiguousarray(nxt, np.float32)
    if a.ndim != 2 or a.shape != b.shape:
        raise ValueError(f"farneback: frames must be two [H, W] planes of one shape, got "
                         f"{a.shape} and {b.shape}")
    out = np.empty(a.shape + (2,), np.float32)
    _fn("dali_tpu_torch_farneback", [_vp, _vp, _ci, _ci, _vp])(
        a.ctypes.data, b.ctypes.data, a.shape[0], a.shape[1], out.ctypes.data)
    return out


def rgb_to_gray_f32(rgb: np.ndarray) -> np.ndarray:
    """float32 [..., 3] RGB to grey [...]: ``cv2.cvtColor(rgb,
    COLOR_RGB2GRAY)`` (``optical_flow.cc``)."""
    rgb = np.ascontiguousarray(rgb, np.float32)
    out = np.empty(rgb.shape[:-1], np.float32)
    _fn("dali_tpu_torch_rgb_to_gray_f32", [_vp, ctypes.c_longlong, _vp])(
        rgb.ctypes.data, out.size, out.ctypes.data)
    return out


def flow_gaussian_blur(plane: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """The flow pyramid's blur of a float32 plane: ``cv2.GaussianBlur(plane,
    (ksize, ksize), sigma, sigma)`` (``optical_flow.cc``)."""
    plane = np.ascontiguousarray(plane, np.float32)
    out = np.empty_like(plane)
    _fn("dali_tpu_torch_of_gaussian_blur", [_vp, _ci, _ci, _ci, ctypes.c_double, _vp])(
        plane.ctypes.data, plane.shape[0], plane.shape[1], int(ksize), float(sigma),
        out.ctypes.data)
    return out


def flow_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """The flow pyramid's resize of a float32 [H, W] or [H, W, C] image:
    ``cv2.resize(img, (out_w, out_h), interpolation=INTER_LINEAR)``
    (``optical_flow.cc``)."""
    img = np.ascontiguousarray(img, np.float32)
    cn = 1 if img.ndim == 2 else img.shape[2]
    out = np.empty((out_h, out_w) + img.shape[2:], np.float32)
    _fn("dali_tpu_torch_of_resize", [_vp, _ci, _ci, _ci, _vp, _ci, _ci])(
        img.ctypes.data, img.shape[0], img.shape[1], cn, out.ctypes.data, out_h, out_w)
    return out


BORDER_CODES = {"reflect_101": 0, "reflect": 1, "replicate": 2, "wrap": 3, "constant": 4}


def sep_conv_f32(img: np.ndarray, ky: np.ndarray, kx: np.ndarray, border: str = "reflect_101",
                 fill: float = 0.0, anchor_y: int = -1, anchor_x: int = -1) -> np.ndarray:
    """Separable correlation of an HW(C) image, window ``ky`` down the rows
    and then ``kx`` along them, float32 (``host_ops.cc``)."""
    img, h, w, c = _hwc(img, np.float32)
    ky = np.ascontiguousarray(ky, np.float32).reshape(-1)
    kx = np.ascontiguousarray(kx, np.float32).reshape(-1)
    out = np.empty_like(img)
    if _fn("dali_tpu_torch_sep_conv_f32",
           [_vp, _ci, _ci, _ci, _vp, _ci, _vp, _ci, _ci, _ci, _ci, _cf, _vp])(
            img.ctypes.data, h, w, c, ky.ctypes.data, ky.size, kx.ctypes.data, kx.size,
            int(anchor_y), int(anchor_x), BORDER_CODES[border], float(fill),
            out.ctypes.data) != 0:
        raise ValueError("sep_conv_f32: bad window or anchor")
    return out


def filter2d_f32(img: np.ndarray, kernel: np.ndarray, border: str = "reflect_101",
                 fill: float = 0.0, anchor_y: int = -1, anchor_x: int = -1) -> np.ndarray:
    """2-D correlation of an HW(C) image with ``kernel`` [kh, kw]
    (``cv2.filter2D``'s convention), float32 (``host_ops.cc``)."""
    img, h, w, c = _hwc(img, np.float32)
    kernel = np.ascontiguousarray(kernel, np.float32)
    if kernel.ndim != 2:
        raise ValueError("filter2d_f32: kernel must be 2-D")
    out = np.empty_like(img)
    if _fn("dali_tpu_torch_filter2d_f32",
           [_vp, _ci, _ci, _ci, _vp, _ci, _ci, _ci, _ci, _ci, _cf, _vp])(
            img.ctypes.data, h, w, c, kernel.ctypes.data, kernel.shape[0], kernel.shape[1],
            int(anchor_y), int(anchor_x), BORDER_CODES[border], float(fill),
            out.ctypes.data) != 0:
        raise ValueError("filter2d_f32: bad kernel or anchor")
    return out


def debayer_bilinear(raw: np.ndarray, by: int, bx: int) -> np.ndarray:
    """Bilinear Bayer -> RGB of a uint8 or uint16 [H, W] mosaic with blue at
    (by, bx) of each 2x2 tile (``host_ops.cc``)."""
    names = {np.dtype(np.uint8): "dali_tpu_torch_debayer_bilinear_u8",
             np.dtype(np.uint16): "dali_tpu_torch_debayer_bilinear_u16"}
    if raw.dtype not in names:
        raise TypeError(f"debayer_bilinear: unsupported dtype {raw.dtype}")
    raw = np.ascontiguousarray(raw)
    h, w = raw.shape[:2]
    out = np.empty((h, w, 3), raw.dtype)
    if _fn(names[raw.dtype], [_vp, _ci, _ci, _ci, _ci, _vp])(
            raw.ctypes.data, h, w, int(by), int(bx), out.ctypes.data) != 0:
        raise ValueError("debayer_bilinear: bad size or blue_position")
    return out


# ------------------------------------------------------------------ JPEG round trip
def jpeg_encode_coefs(img: np.ndarray, quality: int):
    """The quantised coefficients of a uint8 HWC image (1 grey or 3 RGB
    channels) at ``quality``, as ``cv2.imencode(".jpg")`` writes them
    (``jpeg_encode.cc``): (planes, tables), one int16 [bh, bw, 64] plane
    (natural order) and one uint16 [64] table per component; luma blocks
    ceil(h / 8) x ceil(w / 8), chroma ceil(h / 16) x ceil(w / 16)."""
    img, h, w, c = _hwc(img, np.uint8)
    dims = [(-(-h // 8), -(-w // 8))] + [(-(-h // 16), -(-w // 16))] * (2 if c == 3 else 0)
    planes = [np.zeros((bh, bw, 64), np.int16) for bh, bw in dims]
    tables = [np.zeros(64, np.uint16) for _ in dims]
    if _fn("dali_tpu_torch_jpeg_encode_coefs", [_vp, _ci, _ci, _ci, _ci, _vp, _vp])(
            img.ctypes.data, h, w, c, int(quality),
            (ctypes.c_void_p * 3)(*[p.ctypes.data for p in planes]),
            (ctypes.c_void_p * 3)(*[t.ctypes.data for t in tables])) != 0:
        raise ValueError(f"jpeg_encode_coefs: {c} channels (1 or 3 are encoded)")
    return planes, tables


def jpeg_roundtrip(img: np.ndarray, quality: int) -> np.ndarray:
    """A uint8 HWC image (1 grey or 3 RGB channels) encoded as a baseline
    4:2:0 JPEG at ``quality`` and decoded to RGB uint8 [h, w, 3]: the pixels
    of ``cv2.imdecode(cv2.imencode(".jpg", ...))`` (``jpeg_encode.cc``, then
    the decoder of ``jpeg_decode.cc``)."""
    img, h, w, c = _hwc(img, np.uint8)
    out = np.empty((h, w, 3), np.uint8)
    if _fn("dali_tpu_torch_jpeg_roundtrip", [_vp, _ci, _ci, _ci, _ci, _vp])(
            img.ctypes.data, h, w, c, int(quality), out.ctypes.data) != 0:
        raise ValueError(f"jpeg_roundtrip: {c} channels (1 or 3 are encoded)")
    return out


def debayer_edge_aware(raw: np.ndarray, start_with_green: int, blue: int) -> np.ndarray:
    """Edge-aware Bayer demosaic of a uint8 or uint16 [H, W] mosaic
    (``host_ops.cc``, OpenCV's ``Bayer2RGB_EdgeAware_T``): [H, W, 3] in
    OpenCV's channel order for the pattern that starts each odd row with
    green (``start_with_green``) and has ``blue`` in the second column of it."""
    names = {np.dtype(np.uint8): "dali_tpu_torch_debayer_ea_u8",
             np.dtype(np.uint16): "dali_tpu_torch_debayer_ea_u16"}
    if raw.dtype not in names:
        raise TypeError(f"debayer_edge_aware: unsupported dtype {raw.dtype}")
    raw = np.ascontiguousarray(raw)
    h, w = raw.shape[:2]
    out = np.empty((h, w, 3), raw.dtype)
    if _fn(names[raw.dtype], [_vp, _ci, _ci, _ci, _ci, _vp])(
            raw.ctypes.data, h, w, int(start_with_green), int(blue), out.ctypes.data) != 0:
        raise ValueError("debayer_edge_aware: bad size")
    return out


# --------------------------------------------------------------------------- video
# read results of csrc/host/video_decode.cc below 0 (INT_MIN and INT_MIN + 1);
# a planar read stopped by a change of frame size returns -2 - got
_VIDEO_EOF, _VIDEO_DAMAGED, _VIDEO_UNSUPPORTED = -1, -(2**31), -(2**31) + 1


def _text(msg: bytes) -> str:
    """A native message (it may quote bytes of a damaged file)."""
    return msg.decode(errors="replace")


class VideoPixfmtChanged(RuntimeError):
    """The stream's pixel format or frame size changed mid-read: the planar
    YUV wire cannot carry such a file (``dali_tpu.native.VideoPixfmtChanged``).
    MPEG-4 Part 2 streams are 4:2:0 throughout; an in-band VOL header that
    changes the frame size raises it. The video operators catch it and take
    the dense RGB path, which stops at the change, as the reference's do."""

    def __init__(self, path, got):
        super().__init__(
            f"pixel format changed mid-stream in {path!r} after {got} "
            "frames; planar YUV read aborted")
        self.got = got


def has_video() -> bool:
    """The port decodes MP4, AVI, Matroska, MPEG-PS, MPEG-TS and MPEG-1/2
    elementary stream video itself: always available."""
    return True


class VideoFile:
    """Frame-accurate sequence reads of an MP4, AVI, Matroska (``.mkv``),
    MPEG-PS (``.mpg``, ``.vob``), MPEG-TS or MPEG-1/2 elementary stream
    (``.m1v``, ``.m2v``) file, a PS or TS cut mid-stream too, to RGB24 or
    planar YUV 4:2:0 (counterpart of ``dali_tpu.native.VideoFile``: its
    signatures, its errors and its frames). ``path`` may instead be the
    encoded bytes of the file. Raises ``ValueError`` where the reference
    fails to open a file, ``NotImplementedError`` for a container or codec
    that FFmpeg reads and the port does not yet (ROADMAP.md Queue 1 item
    8b: WebM's VP8/VP9 name 8b(f), H.264 8b(e)), and ``ValueError`` naming
    the damage when a stream that the reference would conceal is
    damaged."""

    def __init__(self, path):
        lib = host_lib()
        self._lib = lib
        self._h = None
        err = ctypes.create_string_buffer(512)
        kind = ctypes.c_int(0)
        if isinstance(path, (bytes, bytearray, memoryview, np.ndarray)):
            data = np.frombuffer(bytes(path), np.uint8)
            self._h = lib.dali_tpu_torch_video_open(None, data.ctypes.data, data.size, err,
                                                    len(err), ctypes.byref(kind))
            self.path = "<memory>"
        else:
            self._h = lib.dali_tpu_torch_video_open(str(path).encode(), None, 0, err, len(err),
                                                    ctypes.byref(kind))
            self.path = str(path)
        if not self._h:
            if kind.value == 2:
                raise NotImplementedError(f"video {self.path!r}: {_text(err.value)}")
            raise ValueError(f"Failed to open video {self.path!r}")
        w, hh = ctypes.c_int(), ctypes.c_int()
        nf, fps = ctypes.c_long(), ctypes.c_double()
        lib.dali_tpu_torch_video_info(self._h, ctypes.byref(w), ctypes.byref(hh),
                                      ctypes.byref(nf), ctypes.byref(fps))
        self.width = w.value
        self.height = hh.value
        self.num_frames = nf.value
        self.fps = fps.value
        # 0 = not 4:2:0 (4:2:2, 4:4:4, grey or packed RGB: the RGB read only,
        # converted as libswscale's RGB24 route does); 1 = 4:2:0 limited
        # range; 2 = 4:2:0 full range
        self.pixfmt_class = int(lib.dali_tpu_torch_video_pixfmt_class(self._h))

    def index_bytes(self) -> int:
        """The heap bytes of this handle's index of the file (sample table,
        MPEG-PS/TS pieces, frame numbering, seek points and their decoder
        states): the part of its memory that grows with the file's length."""
        return int(self._lib.dali_tpu_torch_video_index_bytes(self._h))

    def _error(self) -> str:
        return _text(self._lib.dali_tpu_torch_video_error(self._h))

    def _check(self, got, start, count):
        if _VIDEO_UNSUPPORTED < got <= -2:
            raise VideoPixfmtChanged(self.path, -2 - got)
        if got == _VIDEO_DAMAGED:
            codec = _text(self._lib.dali_tpu_torch_video_codec(self._h))
            raise ValueError(f"damaged {codec} stream in {self.path!r} ({self._error()})")
        if got == _VIDEO_UNSUPPORTED:
            raise NotImplementedError(
                f"video {self.path!r}: {self._error()}")
        if got <= 0:
            raise ValueError(f"Failed to read frames [{start}, +{count})")

    def read(self, start: int, count: int, stride: int = 1, pad: bool = True) -> np.ndarray:
        """Read ``count`` frames; ``pad=False`` returns only the frames that
        exist (short at EOF) so callers can apply their own pad_mode."""
        out = np.empty((count, self.height, self.width, 3), np.uint8)
        got = self._lib.dali_tpu_torch_video_read_frames(self._h, start, count, stride,
                                                         out.ctypes.data)
        if got < count:
            self._check(got, start, count)
            if not pad:
                return np.ascontiguousarray(out[:got])
            out[got:] = out[got - 1]  # pad with the last frame at EOF
        return out

    def read_yuv(self, start: int, count: int, stride: int = 1, pad: bool = True, out=None):
        """Read ``count`` frames as planar YUV 4:2:0, the host half of the
        planar video wire. ``out`` may carry C-contiguous uint8 ``(y, u, v)``
        buffers of at least ``count*h*w`` / ``count*ceil(h/2)*ceil(w/2)``
        elements (slices of a flat wire buffer). Returns ``(y, u, v, got)``
        with the planes shaped [count, ...] (flat when ``out`` was given)
        and ``got`` the number of real (non-padded) frames. Requires
        ``pixfmt_class != 0``."""
        if self.pixfmt_class == 0:
            raise RuntimeError("read_yuv requires a 4:2:0 source")
        h_, w_ = self.height, self.width
        ch, cw = (h_ + 1) // 2, (w_ + 1) // 2
        if out is None:
            y = np.empty((count, h_, w_), np.uint8)
            u = np.empty((count, ch, cw), np.uint8)
            v = np.empty((count, ch, cw), np.uint8)
        else:
            y, u, v = out
            for nm, a, need in (("y", y, count * h_ * w_), ("u", u, count * ch * cw),
                                ("v", v, count * ch * cw)):
                if not (isinstance(a, np.ndarray) and a.dtype == np.uint8
                        and a.flags["C_CONTIGUOUS"]):
                    raise ValueError(f"read_yuv out[{nm}] must be C-contiguous uint8")
                if a.size < need:
                    raise ValueError(f"read_yuv out[{nm}] too small: {a.size} < {need}")
        got = self._lib.dali_tpu_torch_video_read_frames_yuv(
            self._h, start, count, stride, y.ctypes.data, u.ctypes.data, v.ctypes.data)
        if got < count:
            self._check(got, start, count)
            if pad:  # repeat the last decoded frame at EOF
                fy, fc = h_ * w_, ch * cw
                for plane, f in ((y, fy), (u, fc), (v, fc)):
                    pf = plane.reshape(-1)[: count * f].reshape(count, f)
                    pf[got:] = pf[got - 1]
        return y, u, v, got

    def close(self):
        if self._h:
            self._lib.dali_tpu_torch_video_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# libswscale's pixel formats that the rebuild of its RGB24 route takes, by
# FFmpeg's names (sws_rgb.cc); "yuvj" selects full range
SWS_FORMATS = {"yuv422p": (1, 0), "yuvj422p": (1, 1), "yuv444p": (2, 0), "yuvj444p": (2, 1),
               "gray": (3, 0), "bgr0": (4, 0), "bgra": (5, 0), "bgr24": (6, 0), "0rgb": (7, 0)}


def sws_rgb(fmt: str, planes, width: int, height: int) -> np.ndarray:
    """One picture through the port's rebuild of libswscale 6.7's
    ``sws_scale`` to RGB24 at 1:1 size with ``SWS_BILINEAR``: ``planes`` are
    2-D uint8 arrays (Y, U, V; or one packed or grey plane), rows of any
    stride. Returns ``[height, width, 3]`` uint8."""
    code, full = SWS_FORMATS[fmt]
    arrs = [np.asarray(p, np.uint8) for p in planes]
    arrs = [a if a.strides[1] == 1 else np.ascontiguousarray(a) for a in arrs]
    ptrs = (ctypes.c_void_p * 3)(*[a.ctypes.data for a in arrs] + [None] * (3 - len(arrs)))
    strides = (ctypes.c_int * 3)(*[a.strides[0] for a in arrs] + [0] * (3 - len(arrs)))
    out = np.empty((height, width, 3), np.uint8)
    if host_lib().dali_tpu_torch_sws_rgb(code, full, width, height, ptrs, strides,
                                         out.ctypes.data) != 0:
        raise ValueError(f"sws_rgb: {fmt} at {width}x{height}")
    return out


def sws_clock(reset: bool = False):
    """``(seconds, frames)``: the time the video reads spent in the swscale
    rebuild, summed over the threads that read, and the frames it
    converted, since the last reset; ``reset`` zeroes both after reading."""
    sec, frames = ctypes.c_double(), ctypes.c_long()
    host_lib().dali_tpu_torch_sws_clock(int(reset), ctypes.byref(sec), ctypes.byref(frames))
    return sec.value, frames.value


def video_read_batch(pool, files, starts, counts, strides, outs, yuv: bool):
    """Reads of several ``VideoFile``s at once on the task pool, one task per
    distinct file (its reads in order): ``outs[i]`` is the RGB array, or the
    ``(y, u, v)`` planes when ``yuv``, of read i. Returns each read's count
    of frames; raises as ``VideoFile.read`` for a read that failed."""
    lib = host_lib()
    n = len(files)
    vp_arr = ctypes.c_void_p * n
    handles = vp_arr(*[f._h for f in files])
    st = np.ascontiguousarray(starts, np.int64).astype(np.dtype("l"))
    co = np.ascontiguousarray(counts, np.int32)
    sr = np.ascontiguousarray(strides, np.int32)
    planes = [o if yuv else (o, o, o) for o in outs]
    ys = vp_arr(*[p[0].ctypes.data for p in planes])
    us = vp_arr(*[p[1].ctypes.data for p in planes])
    vs = vp_arr(*[p[2].ctypes.data for p in planes])
    res = np.zeros(n, np.int32)
    lib.dali_tpu_torch_video_read_batch(
        _pool_handle(pool), handles, st.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        co.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        sr.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), ys, us, vs, n, int(bool(yuv)),
        res.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    for i, got in enumerate(res):
        if got < counts[i]:
            files[i]._check(int(got), starts[i], counts[i])
    return res
