"""Hybrid JPEG decode: host entropy decode, device IDCT (counterpart of
``dali_tpu/backend/decoders.py`` ``_JpegCoeffsSplit`` / ``_JpegIdctSplit``,
the whole-image int8 wire, and ``_JpegCoeffsSplitRRC`` /
``_JpegIdctSplitRRC``, the decode fused with RandomResizedCrop's window).

Host half (``mixed``): header scan, the checks of the reference (EXIF
orientation, sampling modes), then the blocks to decode: the whole image, or
the RRC window (same Philox draws as the reference) snapped to the MCU grid
with the exact chroma halo. One native call entropy-decodes those blocks
straight into the sparse wire, and the wire pack follows (escape-packed int8
DC, nibble-packed AC values). A coefficient selection wider than the sparse
wire's 16-bit bitmaps (``hybrid_scale=1``, or ``chroma_full``) ships dense
flat planes instead. With ``cache_size`` the host half keeps the
entropy-decoded planes of whole images, keyed by content, and builds the
wire from them. Device half (``gpu``): dequantise + scaled IDCT + chroma upsample
+ colour convert (``kernels/jpeg.py``), then, for RRC, the residual window
shift.
"""

from __future__ import annotations

import numpy as np
import torch

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch, Esc16Staged, FlatStaged, HostBatch, SparseStaged, Staged
from .. import native
from ..kernels import jpeg as jk
from .base import Operator

_DECODE_IDX_CAP = 256 << 20  # bytes of ROI decode-index blobs kept per op
_INFO_CACHE_MAX = 1_000_000


def _content_key(k, d):
    """source_info plus a cheap content fingerprint (length, first/last 8 bytes)."""
    if not k:
        return None
    return (k, len(d), bytes(d[:8]), bytes(d[-8:]))


def exif_orientation(data) -> int:
    """EXIF orientation (1-8, 1 = upright) from a JPEG's APP1 segment, or 1."""
    data = bytes(data[:65536])
    n = len(data)
    if n < 4 or data[0] != 0xFF or data[1] != 0xD8:
        return 1
    pos = 2
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            return 1
        marker = data[pos + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker in (0xDA, 0xD9):
            return 1
        seg_len = (data[pos + 2] << 8) | data[pos + 3]
        if marker == 0xE1 and data[pos + 4:pos + 10] == b"Exif\x00\x00":
            tiff = pos + 10
            if tiff + 8 > n:
                return 1
            order = {b"II": "little", b"MM": "big"}.get(data[tiff:tiff + 2])
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


def sample_rrc_window(rng, h, w, random_area, random_aspect_ratio, num_attempts):
    """One RandomResizedCrop window (y, x, ch, cw): the reference function of
    this name, draw for draw (RandomCropAttr / torchvision semantics)."""
    area = h * w
    for _ in range(num_attempts):
        target_area = rng.uniform(random_area[0], random_area[1]) * area
        log_lo, log_hi = np.log(random_aspect_ratio[0]), np.log(random_aspect_ratio[1])
        ar = np.exp(rng.uniform(log_lo, log_hi))
        cw = int(round(np.sqrt(target_area * ar)))
        ch = int(round(np.sqrt(target_area / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            y = int(rng.integers(0, h - ch + 1))
            x = int(rng.integers(0, w - cw + 1))
            return y, x, ch, cw
    # fallback: centre crop with the aspect clamped into range
    in_ar = w / h
    if in_ar < random_aspect_ratio[0]:
        cw, ch = w, min(h, int(round(w / random_aspect_ratio[0])))
    elif in_ar > random_aspect_ratio[1]:
        ch, cw = h, min(w, int(round(h * random_aspect_ratio[1])))
    else:
        ch, cw = h, w
    return (h - ch) // 2, (w - cw) // 2, ch, cw


def sample_rrc_windows_batch(rng, hw, random_area, random_aspect_ratio, num_attempts):
    """Vectorised RandomResizedCrop windows for a batch: [n, 4] (y, x, ch, cw).
    Same draws and rejection rule as the reference function of this name."""
    hw = np.asarray(hw, np.int64)
    n = hw.shape[0]
    h, w = hw[:, 0], hw[:, 1]
    area = (h * w).astype(np.float64)
    ta = rng.uniform(random_area[0], random_area[1], (num_attempts, n)) * area
    log_lo, log_hi = np.log(random_aspect_ratio[0]), np.log(random_aspect_ratio[1])
    ar = np.exp(rng.uniform(log_lo, log_hi, (num_attempts, n)))
    cw = np.round(np.sqrt(ta * ar)).astype(np.int64)
    ch = np.round(np.sqrt(ta / ar)).astype(np.int64)
    ok = (cw > 0) & (cw <= w) & (ch > 0) & (ch <= h)
    u_y = rng.random((num_attempts, n))
    u_x = rng.random((num_attempts, n))
    y = np.floor(u_y * np.maximum(h - ch + 1, 1)).astype(np.int64)
    x = np.floor(u_x * np.maximum(w - cw + 1, 1)).astype(np.int64)
    first = np.argmax(ok, axis=0)
    any_ok = ok.any(axis=0)
    idx = (first, np.arange(n))
    out = np.stack([y[idx], x[idx], ch[idx], cw[idx]], axis=1)
    if not any_ok.all():
        # fallback: centre crop with the aspect clamped into range
        in_ar = w / np.maximum(h, 1)
        lo, hi = random_aspect_ratio
        f_cw = np.where(in_ar > hi, np.minimum(w, np.round(h * hi)), w).astype(np.int64)
        f_ch = np.where(in_ar < lo, np.minimum(h, np.round(w / lo)), h).astype(np.int64)
        fb = np.stack([(h - f_ch) // 2, (w - f_cw) // 2, f_ch, f_cw], axis=1)
        out = np.where(any_ok[:, None], out, fb)
    return out


def _ratchet(sizes: dict, name: str, need: int) -> int:
    """Monotonic wire-length grow policy of the reference (256K-element
    chunks, 16K for escape streams, 1.1x headroom on first growth)."""
    chunk = 1 << 14 if name.endswith("_esc") else 1 << 18
    prev = sizes.get(name, 0)
    want = max(need, 1) if prev else int(max(need, 1) * 1.1)
    sizes[name] = max(prev, -(-want // chunk) * chunk)
    return sizes[name]


def _esc_cap(sizes: dict, name: str, worst: int) -> int:
    chunk = 1 << 14 if name.endswith("_esc") else 1 << 18
    first_growth = -(-(int(max(worst, 1) * 1.1) + 16) // chunk) * chunk
    return max(first_growth, sizes.get(name, 0))


def _chroma_origin(mode: int, r0, c0):
    """Chroma block origin of a luma block origin, per sampling mode."""
    return (r0 // 2 if mode == 0 else r0), (c0 if mode == 1 else c0 // 2)


def _pack_flat(windows, blocks, ky, kc):
    """Per-sample window planes packed densely into flat buffers, as the
    native batch read writes them (reference ``JpegCoeffs._pack_flat``)."""
    n = len(windows)
    y_n = blocks[:, 0].astype(np.int64) * blocks[:, 1]
    c_n = blocks[:, 2].astype(np.int64) * blocks[:, 3]

    def excl(v):
        return np.concatenate([[0], np.cumsum(v)[:-1]]).astype(np.int64)

    offs = {"y_dc": excl(y_n), "y_ac": excl(y_n * (ky * ky - 1)),
            "c_dc": excl(2 * c_n), "c_ac": excl(2 * c_n * (kc * kc - 1))}
    flat = [np.empty((int(y_n.sum()),), np.int16),
            np.empty((int((y_n * (ky * ky - 1)).sum()),), np.int8),
            np.empty((int(2 * c_n.sum()),), np.int16),
            np.empty((int((2 * c_n * (kc * kc - 1)).sum()),), np.int8)]
    qs = np.empty((n, windows[0][4].shape[0]), windows[0][4].dtype)
    for i, win in enumerate(windows):
        for buf, key, a in zip(flat, ("y_dc", "y_ac", "c_dc", "c_ac"), win[:4]):
            buf[offs[key][i]:offs[key][i] + a.size] = a.ravel()
        qs[i] = win[4]
    return (*flat, qs, offs)


_HYBRID_ARGS = (
    ("cache_size", ArgType.INT, "Coefficient cache budget in MB (0 = off).", 0),
    ("adjust_orientation", ArgType.BOOL,
     "EXIF-rotated JPEGs cannot ride the coefficient wire: orientation tags != 1 raise unless "
     "this is False.", True),
    ("hybrid_scale", ArgType.INT, "Decode scale denominator (1, 2, or 4).", 1),
    ("chroma_full", ArgType.BOOL, "Full-spectrum chroma.", False),
)

_split = DALI_SCHEMA("_JpegCoeffsSplit").DocStr(
    """Host half of the hybrid JPEG decoder, whole image, split-precision
    wire (DC int16, AC saturated to int8). Outputs: y_dc, y_ac, c_dc, c_ac
    wires, quant tables, dims (image height, width, mode)."""
).NumInput(1).NumOutput(6).Devices("mixed").MakeInternal()
_rrc = DALI_SCHEMA("_JpegCoeffsSplitRRC").DocStr(
    """Host half of the hybrid JPEG decoder fused with RandomResizedCrop's
    window sampling: only the window's DCT blocks are entropy-decoded and
    shipped. Outputs: y_dc, y_ac, c_dc, c_ac wires, quant tables, dims
    (decoded-region size, mode) and roi (residual window in the region)."""
).NumInput(1).NumOutput(7).Devices("mixed").MakeInternal().AddRandomSeedArg()
for _args in _HYBRID_ARGS:
    _split.AddOptionalArg(*_args)
    _rrc.AddOptionalArg(*_args)
_rrc.AddOptionalArg(
    "random_area", ArgType.FLOAT_VEC, "Crop area range.", [0.08, 1.0]
).AddOptionalArg(
    "random_aspect_ratio", ArgType.FLOAT_VEC, "Aspect-ratio range.", [3 / 4, 4 / 3]
).AddOptionalArg("num_attempts", ArgType.INT, "Window sampling attempts.", 10)

DALI_SCHEMA("_JpegIdctSplit").DocStr(
    "Device half of the hybrid JPEG decoder: the whole image at 1/hybrid_scale."
).NumInput(6).NumOutput(1).Devices("gpu").MakeInternal().AddOptionalArg(
    "hybrid_scale", ArgType.INT, "Decode scale denominator.", 1
).AddOptionalArg("chroma_full", ArgType.BOOL, "Full-spectrum chroma.", False)

DALI_SCHEMA("_JpegIdctSplitRRC").DocStr(
    "Device half of the hybrid JPEG decoder + residual window shift: output "
    "extents are exactly the sampled crop (quantized to the decode scale)."
).NumInput(7).NumOutput(1).Devices("gpu").MakeInternal().AddOptionalArg(
    "hybrid_scale", ArgType.INT, "Decode scale denominator.", 1
).AddOptionalArg("chroma_full", ArgType.BOOL, "Full-spectrum chroma.", False)
del _args


def _ks(spec):
    ky = {1: 8, 2: 4, 4: 2}[int(spec.GetArgument("hybrid_scale"))]
    return ky, jk.chroma_k(ky, True, bool(spec.GetArgument("chroma_full")))


class _HybridCoeffs(Operator):
    """State and steps shared by both host halves: the task pool, the EXIF,
    header-info and mode checks, the grow-only canvases and wire lengths, the
    coefficient cache and the wire pack."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._pool = None
        self._info_cache = {}
        self._exif_ok = set()
        self._flat_lens = [0, 0, 0, 0]
        self._sparse_lens = {}
        self._canvas = None  # (mode, [BH, BW], [CBH, CBW])
        mb = int(spec.GetArgument("cache_size"))
        # the reference's decoder cache applied to the wire: whole-image
        # planes keyed by content, so repeat epochs skip the entropy decode
        self._ccache = ({"cap": mb << 20, "used": 0, "map": {}, "hits": 0, "misses": 0}
                        if mb else None)

    def close(self):
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def _task_pool(self):
        if self._pool is None:
            self._pool = native.TaskPool(self.pipeline.num_threads)
        return self._pool

    def _check_exif(self, datas, keys):
        if not self.spec.GetArgument("adjust_orientation"):
            return
        for i, d in enumerate(datas):
            k = _content_key(keys[i], d) if keys else None
            if k and k in self._exif_ok:
                continue
            if exif_orientation(d) != 1:
                raise ValueError(
                    "hybrid_device_decode: sample carries an EXIF orientation tag; the "
                    "coefficient wire cannot rotate. Pass adjust_orientation=False to "
                    "decode ignoring the tag.")
            if k:
                self._exif_ok.add(k)

    def _infos(self, datas, keys):
        ikeys = [_content_key(k, d) for k, d in zip(keys or [], datas)]
        cache = self._info_cache
        if ikeys and all(k and k in cache for k in ikeys):
            return np.stack([cache[k] for k in ikeys])
        infos = native.jpeg_coef_info_batch(datas)
        if len(cache) > _INFO_CACHE_MAX:
            for k in list(cache)[:len(cache) // 2]:
                del cache[k]
        for k, row in zip(ikeys, infos):
            if k:
                cache[k] = row.copy()
        return infos

    def _headers(self, inp):
        """(datas, keys, infos, mode) of a batch, after the reference's checks."""
        datas = [np.ascontiguousarray(e) for e in inp.samples]
        keys = inp.source_info
        self._check_exif(datas, keys)
        infos = self._infos(datas, keys)
        modes = infos[:, 6]
        if (modes < 0).any() or (modes > 2).any():
            raise ValueError("hybrid_device_decode requires grayscale or 3-component YCbCr "
                             "4:2:0/4:2:2/4:4:4 JPEGs")
        if (modes != modes[0]).any():
            raise ValueError(
                "hybrid_device_decode: mixed chroma samplings in one batch "
                f"({sorted(set(int(m) for m in modes))}); bucket the dataset by sampling")
        if modes[0] != 0 and self.spec.GetArgument("chroma_full"):
            raise ValueError("chroma_full=True is only meaningful for 4:2:0")
        return datas, keys, infos, int(modes[0])

    def _idx_blobs(self, keys, datas, infos, mode):
        return None

    # -- the coefficient cache (reference JpegCoeffs._planes_for / _stage_via_cache) -----------
    def _planes_for(self, datas, keys, infos, ky, kc):
        """Whole-image planes (y_dc, y_ac, c_dc, c_ac, q) per sample, from the
        cache or one native batch read of the misses, inserted while the
        budget allows."""
        cache = self._ccache
        out = [cache["map"].get(k) if k else None for k in keys]
        miss = [i for i, ent in enumerate(out) if ent is None]
        if miss:
            blocks = infos[np.asarray(miss), 2:6].astype(np.int32)
            zero = np.zeros((len(miss), 2), np.int32)
            y_dc, y_ac, c_dc, c_ac, q, offs = native.coef_dense_batch(
                self._task_pool(), [datas[i] for i in miss], ky, kc, blocks, zero, zero)
            for j, i in enumerate(miss):
                ybh, ybw, cbh, cbw = (int(v) for v in blocks[j])
                ent = (y_dc[offs["y_dc"][j]:][:ybh * ybw].reshape(ybh, ybw).copy(),
                       y_ac[offs["y_ac"][j]:][:ybh * ybw * (ky * ky - 1)]
                       .reshape(ybh, ybw, ky * ky - 1).copy(),
                       c_dc[offs["c_dc"][j]:][:2 * cbh * cbw].reshape(2, cbh, cbw).copy(),
                       c_ac[offs["c_ac"][j]:][:2 * cbh * cbw * (kc * kc - 1)]
                       .reshape(2, cbh, cbw, kc * kc - 1).copy(),
                       q[j].copy())
                out[i] = ent
                # keyless samples never cache; a key seen twice in one batch
                # is inserted (and counted) once
                if keys[i] and keys[i] not in cache["map"]:
                    nbytes = sum(a.nbytes for a in ent)
                    if cache["used"] + nbytes <= cache["cap"]:
                        cache["map"][keys[i]] = ent
                        cache["used"] += nbytes
        return out

    def _stage_via_cache(self, datas, keys, infos, blocks, brc0, mode, ky, kc):
        """Dense window planes: from the cache, from a batch read of the
        misses (inserted while the budget allows), or, for keyless samples
        and once the budget is spent, a read of the window's blocks only."""
        cache = self._ccache
        n = len(datas)
        for k in keys:
            cache["hits" if k and k in cache["map"] else "misses"] += 1
        to_fill = [i for i in range(n) if keys[i] and keys[i] not in cache["map"]
                   and cache["used"] < cache["cap"]]
        fill = dict(zip(to_fill, self._planes_for(
            [datas[i] for i in to_fill], [keys[i] for i in to_fill],
            infos[np.asarray(to_fill, np.int64)], ky, kc))) if to_fill else {}
        windows, crop = [None] * n, []
        for i in range(n):
            bh, bw, cbh, cbw = (int(v) for v in blocks[i])
            r0, c0 = (int(v) for v in brc0[i])
            cr0, cc0 = _chroma_origin(mode, r0, c0)
            ent = (cache["map"].get(keys[i]) if keys[i] else None) or fill.get(i)
            if ent is None:
                crop.append(i)
                continue
            pyd, pya, pcd, pca, q = ent
            windows[i] = (pyd[r0:r0 + bh, c0:c0 + bw], pya[r0:r0 + bh, c0:c0 + bw],
                          pcd[:, cr0:cr0 + cbh, cc0:cc0 + cbw],
                          pca[:, cr0:cr0 + cbh, cc0:cc0 + cbw], q)
        if crop:
            idx = np.asarray(crop)
            c_brc0 = np.stack(_chroma_origin(mode, brc0[idx, 0], brc0[idx, 1]), 1)
            y_dc, y_ac, c_dc, c_ac, q, offs = native.coef_dense_batch(
                self._task_pool(), [datas[i] for i in crop], ky, kc, blocks[idx], brc0[idx],
                c_brc0)
            for j, i in enumerate(crop):
                y_n = int(blocks[i, 0]) * int(blocks[i, 1])
                c_n = 2 * int(blocks[i, 2]) * int(blocks[i, 3])
                windows[i] = (y_dc[offs["y_dc"][j]:][:y_n],
                              y_ac[offs["y_ac"][j]:][:y_n * (ky * ky - 1)],
                              c_dc[offs["c_dc"][j]:][:c_n],
                              c_ac[offs["c_ac"][j]:][:c_n * (kc * kc - 1)], q[j])
        return _pack_flat(windows, blocks, ky, kc)

    # -- the wire ----------------------------------------------------------------------------
    def _stage_wire(self, datas, keys, infos, blocks, brc0, mode, ky, kc):
        """The first five outputs: the four coefficient wires and the quant
        tables of the given blocks (``blocks`` [n, 4] luma and chroma block
        extents, ``brc0`` [n, 2] luma block origins)."""
        n = len(datas)

        def grow(cur, want, align):
            return max(int(-(-int(want) // align) * align), cur)

        if self._canvas is None or self._canvas[0] != mode:
            self._canvas = (mode, [0, 0], [0, 0])
        yc, cc = self._canvas[1], self._canvas[2]
        yc[:] = grow(yc[0], blocks[:, 0].max(), 8), grow(yc[1], blocks[:, 1].max(), 8)
        cc[:] = (grow(cc[0], blocks[:, 2].max(), {0: 4, 1: 8, 2: 8}[mode]),
                 grow(cc[1], blocks[:, 3].max(), {0: 4, 1: 8, 2: 4}[mode]))
        y_n = blocks[:, 0].astype(np.int64) * blocks[:, 1]
        c_n = blocks[:, 2].astype(np.int64) * blocks[:, 3]
        need = (int(y_n.sum()), int((y_n * (ky * ky - 1)).sum()),
                int(2 * c_n.sum()), int((2 * c_n * (kc * kc - 1)).sum()))
        lens, sizes = self._flat_lens, self._sparse_lens
        for j in range(4):
            want = need[j] if lens[j] else int(need[j] * 1.1)
            lens[j] = max(lens[j], -(-want // (1 << 18)) * (1 << 18))

        pool = self._task_pool()
        two = np.full((n, 1), 2, np.int32)
        yb, cb = blocks[:, :2], blocks[:, 2:]
        y_shapes = np.concatenate([yb, np.full((n, 1), ky * ky - 1, np.int32)], 1)
        c_dc_shapes = np.concatenate([two, cb], 1)
        c_shapes = np.concatenate([c_dc_shapes, np.full((n, 1), kc * kc - 1, np.int32)], 1)
        canvases = ((*yc,), (*yc, ky * ky - 1), (2, *cc), (2, *cc, kc * kc - 1))
        # the sparse wire's per-block bitmaps hold 16 coefficients: a larger
        # selection (hybrid_scale=1, or chroma_full) ships dense flat planes
        sparse = ky * ky - 1 <= 16 and kc * kc - 1 <= 16
        ckeys = ([_content_key(k, d) for k, d in zip(keys, datas)]
                 if self._ccache is not None and keys else None)
        c_brc0 = np.stack(_chroma_origin(mode, brc0[:, 0], brc0[:, 1]), 1)
        if ckeys:
            y_dc, y_ac, c_dc, c_ac, q, offs = self._stage_via_cache(
                datas, ckeys, infos, blocks, brc0, mode, ky, kc)
        elif not sparse:
            y_dc, y_ac, c_dc, c_ac, q, offs = native.coef_dense_batch(
                pool, datas, ky, kc, blocks, brc0, c_brc0, flat_lens=lens)
        if not sparse:
            return [FlatStaged(a, offs[k], sh, cv) for a, k, sh, cv in zip(
                (y_dc, y_ac, c_dc, c_ac), ("y_dc", "y_ac", "c_dc", "c_ac"),
                (yb.copy(), y_shapes, c_dc_shapes, c_shapes), canvases)] + [
                Staged(q, np.full((n, 1), q.shape[1], np.int32))]

        ny, nc = need[0], need[2]
        y_nibs = np.empty(((lens[1] + 1) // 2 + 8,), np.uint8)
        c_nibs = np.empty(((lens[3] + 1) // 2 + 8,), np.uint8)
        y_dc8 = np.empty((lens[0],), np.int8)
        c_dc8 = np.empty((lens[2],), np.int8)
        y_esc16 = np.empty((_esc_cap(sizes, "y_dc_esc", ny),), np.int16)
        c_esc16 = np.empty((_esc_cap(sizes, "c_dc_esc", nc),), np.int16)
        if ckeys:
            # dense planes from the cache: the dense-plane wire pack
            y_mask = np.empty((lens[0],), np.uint16)
            c_mask = np.empty((lens[2],), np.uint16)
            y_vals = np.empty((lens[1] + 16,), np.int8)
            c_vals = np.empty((lens[3] + 16,), np.int8)
            y_tot, y_ve, c_tot, c_ve, y_de, c_de = native.pack_wire(
                pool, y_ac, ny, ky * ky - 1, c_ac, nc, kc * kc - 1, y_dc, c_dc, lens[0], lens[2],
                y_mask, y_nibs, y_vals, c_mask, c_nibs, c_vals, y_dc8, y_esc16, c_dc8, c_esc16)
        else:
            # one native call: file bytes -> masks and value streams
            (y_dc, y_mask, y_vals, y_tot, c_dc, c_mask, c_vals, c_tot, q,
             offs) = native.coef_pack_batch(pool, datas, ky, kc, blocks, brc0, c_brc0, lens,
                                            idx_blobs=self._idx_blobs(keys, datas, infos, mode))
            y_ve, c_ve, y_de, c_de = native.pack_wire2(
                pool, y_vals, y_tot, c_vals, c_tot, y_dc, c_dc, ny, nc, lens[0], lens[2],
                y_nibs, c_nibs, y_dc8, y_esc16, c_dc8, c_esc16)
        y_nib_len = _ratchet(sizes, "y_ac_nibs", (y_tot + 1) // 2)
        c_nib_len = _ratchet(sizes, "c_ac_nibs", (c_tot + 1) // 2)
        y_ve_w = min(_ratchet(sizes, "y_ac_esc", y_ve), y_vals.shape[0])
        c_ve_w = min(_ratchet(sizes, "c_ac_esc", c_ve), c_vals.shape[0])
        y_de_w = min(_ratchet(sizes, "y_dc_esc", y_de), y_esc16.shape[0])
        c_de_w = min(_ratchet(sizes, "c_dc_esc", c_de), c_esc16.shape[0])
        return [
            Esc16Staged(y_dc8, y_esc16[:y_de_w], offs["y_dc"], yb.copy(), canvases[0]),
            SparseStaged(y_mask, y_nibs[:y_nib_len], y_vals[:y_ve_w], offs["y_dc"], y_shapes,
                         canvases[1]),
            Esc16Staged(c_dc8, c_esc16[:c_de_w], offs["c_dc"], c_dc_shapes, canvases[2]),
            SparseStaged(c_mask, c_nibs[:c_nib_len], c_vals[:c_ve_w], offs["c_dc"], c_shapes,
                         canvases[3]),
            Staged(q, np.full((n, 1), q.shape[1], np.int32)),
        ]


@register_operator("_JpegCoeffsSplit", "mixed")
class JpegCoeffsSplit(_HybridCoeffs):
    """The whole image: every block from the origin, no decode index."""

    def stage_batch_multi(self, ctx, inputs):
        ky, kc = _ks(self.spec)
        datas, keys, infos, mode = self._headers(inputs[0])
        n = len(datas)
        blocks = infos[:, 2:6].astype(np.int32)
        wires = self._stage_wire(datas, keys, infos, blocks, np.zeros((n, 2), np.int32), mode,
                                 ky, kc)
        return wires + [HostBatch([infos[i, [0, 1, 6]].astype(np.int32) for i in range(n)])]


@register_operator("_JpegCoeffsSplitRRC", "mixed")
class JpegCoeffsSplitRRC(_HybridCoeffs):
    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._idx_cache = {"map": {}, "used": 0}

    def _idx_blobs(self, keys, datas, infos, mode):
        """Per-file ROI decode-index blobs: the decoder records the bit-reader
        state before every MCU on a file's first decode and seeks straight to
        the window on later ones (same cache policy as the reference)."""
        if not keys:
            return None
        cache = self._idx_cache
        vdiv = 2 if mode == 0 else 1
        hdiv = 1 if mode == 1 else 2
        blobs, seen = [None] * len(datas), set()
        for i, k in enumerate(keys):
            if not k or k in seen:
                continue
            seen.add(k)
            fp = _content_key(k, datas[i])
            entry = cache["map"].get(k)
            if entry is not None and entry[0] != fp:
                cache["used"] -= entry[1].nbytes
                del cache["map"][k]
                entry = None
            if entry is None:
                nb = native.decode_idx_blob_bytes(-(-int(infos[i, 3]) // hdiv),
                                                  -(-int(infos[i, 2]) // vdiv))
                if cache["used"] + nb > _DECODE_IDX_CAP:
                    continue
                entry = cache["map"][k] = (fp, np.zeros(nb, np.uint8))
                cache["used"] += nb
            blobs[i] = entry[1]
        return blobs

    def stage_batch_multi(self, ctx, inputs):
        ky, kc = _ks(self.spec)
        datas, keys, infos, mode = self._headers(inputs[0])
        n = len(datas)
        mcu_h, mcu_w = {0: (16, 16), 2: (8, 16), 1: (8, 8)}[mode]
        wins = sample_rrc_windows_batch(
            ctx.rng(self), infos[:, :2], self.spec.GetArgument("random_area"),
            self.spec.GetArgument("random_aspect_ratio"), self.spec.GetArgument("num_attempts"))
        y, x = wins[:, 0].astype(np.int64), wins[:, 1].astype(np.int64)
        ch, cw = wins[:, 2].astype(np.int64), wins[:, 3].astype(np.int64)
        # decoded region: window + the chroma upsample's reach (one chroma
        # pixel = 2*scale luma pixels) snapped to the MCU grid
        m = 2 * int(self.spec.GetArgument("hybrid_scale"))
        y0 = (np.maximum(y - m, 0) // mcu_h) * mcu_h
        x0 = (np.maximum(x - m, 0) // mcu_w) * mcu_w
        y1 = np.minimum(-(-(y + ch + m) // mcu_h) * mcu_h, infos[:, 2].astype(np.int64) * 8)
        x1 = np.minimum(-(-(x + cw + m) // mcu_w) * mcu_w, infos[:, 3].astype(np.int64) * 8)
        y1 += (-(y1 - y0)) % mcu_h
        x1 += (-(x1 - x0)) % mcu_w
        cbh = (y1 - y0) // (8 if mode != 0 else 16)
        cbw = (x1 - x0) // (8 if mode == 1 else 16)
        blocks = np.stack([(y1 - y0) // 8, (x1 - x0) // 8, cbh, cbw], 1).astype(np.int32)
        brc0 = np.stack([y0 // 8, x0 // 8], 1).astype(np.int32)
        dims = np.stack([y1 - y0, x1 - x0, np.full(n, mode)], 1).astype(np.int32)
        roi = np.stack([y - y0, x - x0, ch, cw], 1).astype(np.int32)
        wires = self._stage_wire(datas, keys, infos, blocks, brc0, mode, ky, kc)
        return wires + [HostBatch([dims[i].copy() for i in range(n)]),
                        HostBatch([roi[i].copy() for i in range(n)])]


@register_operator("_JpegIdctSplit", "gpu")
class JpegIdctSplit(Operator):
    def host_output_layouts(self, in_layouts):
        return ["HWC"]

    def device_statics(self, ctx, in_shapes, in_batches):
        # the sampling mode (column 2 of dims) is batch-homogeneous
        dims = in_batches[5]
        return (int(np.asarray(dims.samples[0])[2]),) if dims is not None else (0,)

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        dims_hb = input_batches[5]
        if dims_hb is None:
            return None
        d = int(self.spec.GetArgument("hybrid_scale"))
        dims = np.stack(dims_hb.samples).astype(np.int64)
        return [np.stack([-(-dims[:, 0] // d), -(-dims[:, 1] // d), np.full(len(dims), 3)],
                         1).astype(np.int32)]

    def _rgb(self, dctx, ydc_b, yac_b, cdc_b, cac_b, q_b):
        """[N, BH*k, BW*k, 3] uint8: the device tail over the whole canvas."""
        ky = {1: 8, 2: 4, 4: 2}[int(self.spec.GetArgument("hybrid_scale"))]
        (mode,) = dctx.static(self) or (0,)
        y = torch.cat([ydc_b.data[..., None].to(torch.int32), yac_b.data.to(torch.int32)], -1)
        c = torch.cat([cdc_b.data[..., None].to(torch.int32), cac_b.data.to(torch.int32)], -1)
        return jk.jpeg_device_tail(y, c, q_b.data, ky, mode,
                                   bool(self.spec.GetArgument("chroma_full")))

    def lower(self, dctx, ydc_b, yac_b, cdc_b, cac_b, q_b, dims_b):
        d = int(self.spec.GetArgument("hybrid_scale"))
        rgb = self._rgb(dctx, ydc_b, yac_b, cdc_b, cac_b, q_b)
        dims = dims_b.data.to(torch.int32)
        shapes = torch.stack([(dims[:, 0] + d - 1) // d, (dims[:, 1] + d - 1) // d,
                              torch.full_like(dims[:, 0], 3)], 1)
        return [DeviceBatch(rgb, shapes, "HWC")]


@register_operator("_JpegIdctSplitRRC", "gpu")
class JpegIdctSplitRRC(JpegIdctSplit):
    def host_output_shapes(self, ctx, input_shapes, input_batches):
        roi_hb = input_batches[6]
        if roi_hb is None:
            return None
        d = int(self.spec.GetArgument("hybrid_scale"))
        roi = np.stack(roi_hb.samples).astype(np.int64)
        n = roi.shape[0]
        return [np.stack([-(-roi[:, 2] // d), -(-roi[:, 3] // d), np.full(n, 3)], 1).astype(np.int32)]

    def lower(self, dctx, ydc_b, yac_b, cdc_b, cac_b, q_b, dims_b, roi_b):
        denom = int(self.spec.GetArgument("hybrid_scale"))
        rgb = self._rgb(dctx, ydc_b, yac_b, cdc_b, cac_b, q_b)
        roi = roi_b.data.to(torch.int32)
        out = jk.shift_window(rgb, roi[:, 0] // denom, roi[:, 1] // denom)
        shapes = torch.stack([(roi[:, 2] + denom - 1) // denom, (roi[:, 3] + denom - 1) // denom,
                              torch.full_like(roi[:, 2], 3)], 1)
        return [DeviceBatch(out, shapes, "HWC")]
