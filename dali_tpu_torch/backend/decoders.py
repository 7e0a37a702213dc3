"""Image decoders (counterpart of ``dali_tpu/backend/decoders.py``).

* Host decode: ``decoders.Image``, ``ImageRandomCrop``, ``ImageCrop`` (cpu
  and mixed), ``decoders.ImageSlice`` (``dali_tpu/backend/misc2.py``) and
  ``PeekImageShape``. JPEG decodes through the libjpeg-free C++ decoder
  (``imgcodec``, ``csrc/host/jpeg_decode.cc``); the mixed ``decoders.Image``
  decodes a batch straight into its padded boundary canvas.
* Hybrid decode, host entropy decode and device IDCT: the int16 wire
  (``_JpegCoeffs`` / ``_JpegIdct``, whole images, full-precision planes), the
  split int8 wire (``_JpegCoeffsSplit`` / ``_JpegIdctSplit``) and the decode
  fused with RandomResizedCrop's window (``_JpegCoeffsSplitRRC`` /
  ``_JpegIdctSplitRRC``).

Host half of the split wire (``mixed``): header scan, the checks of the reference (EXIF
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
from .. import imgcodec, native
from ..imgcodec import exif_orientation
from ..kernels import jpeg as jk
from ..types import DALIDataType, DALIImageType, to_numpy_type
from .base import Operator

_DECODE_IDX_CAP = 256 << 20  # bytes of ROI decode-index blobs kept per op
_INFO_CACHE_MAX = 1_000_000


def _content_key(k, d):
    """source_info plus a cheap content fingerprint (length, first/last 8 bytes)."""
    if not k:
        return None
    return (k, len(d), bytes(d[:8]), bytes(d[-8:]))


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
        if (modes < 0).any():
            for d in (d for d, m in zip(datas, modes) if m < 0):
                # a JPEG form no decoder of this package reads raises
                # NotImplementedError; the rest raise as the reference does
                try:
                    native.jpeg_scaled_dims(d)
                except ValueError:
                    pass
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


# ================================ host-decoded images (decoders.Image and kin) ====================
# Counterpart of dali_tpu/backend/decoders.py:25-523, misc2.py:271-345 and
# decoders.py:1400-1440. Each sample takes the reference's route (imgcodec):
# JPEGs in one native batch call per batch, which reports per sample the
# route the reference takes (libjpeg, or cv2 for CMYK/YCCK); PNG and BMP per
# sample; GIF, TIFF and WebP raise (imgcodec.NOT_JPEG).

def _decoder_schema(name):
    return (
        DALI_SCHEMA(name)
        .NumInput(1)
        .NumOutput(1)
        .Devices("cpu", "mixed")
        .AddOptionalArg("output_type", ArgType.IMAGE_TYPE, "Output color space.", DALIImageType.RGB)
        .AddOptionalArg("dtype", ArgType.DATA_TYPE, "Output dtype (uint8).", None)
        .AddOptionalArg("hybrid_huffman_threshold", ArgType.INT, "Compatibility no-op.", 1000000)
        .AddOptionalArg("device_memory_padding", ArgType.INT, "Compatibility no-op.", 0)
        .AddOptionalArg("host_memory_padding", ArgType.INT, "Compatibility no-op.", 0)
        .AddOptionalArg("hw_decoder_load", ArgType.FLOAT, "Compatibility no-op.", 0.9)
        .AddOptionalArg("preallocate_width_hint", ArgType.INT, "Canvas width hint.", 0)
        .AddOptionalArg("preallocate_height_hint", ArgType.INT, "Canvas height hint.", 0)
        .AddOptionalArg("use_fast_idct", ArgType.BOOL, "Use fast IDCT path.", False)
        .AddOptionalArg("memory_stats", ArgType.BOOL, "Compatibility no-op.", False)
        .AddOptionalArg("adjust_orientation", ArgType.BOOL, "Apply EXIF orientation.", True)
        .AddOptionalArg("jpeg_fancy_upsampling", ArgType.BOOL,
                        "Triangular chroma upsampling for subsampled JPEGs (libjpeg's fancy "
                        "path). False = box replication.", True)
        .AddOptionalArg("device_memory_padding_jpeg2k", ArgType.INT,
                        "Compatibility no-op (nvJPEG2k buffer hint).", 0)
        .AddOptionalArg("host_memory_padding_jpeg2k", ArgType.INT,
                        "Compatibility no-op (nvJPEG2k buffer hint).", 0)
        .AddOptionalArg("cache_size", ArgType.INT,
                        "Decoded-image cache size in MB (0 = off), keyed by the reader's "
                        "source_info.", 0)
        .AddOptionalArg("cache_type", ArgType.STRING, "'threshold' or 'largest'.", "threshold")
        .AddOptionalArg("cache_threshold", ArgType.INT, "Only cache images <= this many bytes.", 0)
        .AddOptionalArg("cache_debug", ArgType.BOOL, "Log cache hits/misses.", False)
        .AddOptionalArg("cache_batch_copy", ArgType.BOOL, "Compatibility no-op.", True)
        .AddOptionalArg(
            "downscale_shorter_hint", ArgType.INT,
            "Decode JPEGs at the largest DCT scale (1/2, 1/4, 1/8) that keeps the shorter "
            "edge >= this hint. 0 = full resolution.", 0)
    )


_decoder_schema("decoders.Image").DocStr(
    """Decodes images to HWC uint8 (reference ``decoders__Image``). JPEG only in
    this package. device='mixed' decodes on the host straight into the padded
    boundary canvas; the executor's copy puts it on the device.""")


def _as_bytes(encoded):
    """A sample's encoded bytes as a zero-copy memoryview."""
    return memoryview(np.ascontiguousarray(encoded).reshape(-1).view(np.uint8))


def choose_denom(h: int, w: int, hint: int) -> int:
    """Largest DCT scale denominator in {1,2,4,8} keeping min(h,w)/denom >= hint."""
    if hint <= 0:
        return 1
    denom = 1
    for d in (2, 4, 8):
        if min(h, w) // d >= hint:
            denom = d
    return denom


class _DecoderCache:
    """Decoded-image cache (the reference's ``_DecoderCache``): bounded byte
    budget keyed by source_info. 'threshold' caches anything <= threshold
    while space remains; 'largest' evicts smaller entries for larger images."""

    def __init__(self, size_mb: int, policy: str, threshold: int, debug: bool = False):
        self.capacity = size_mb << 20
        self.policy = policy
        self.threshold = threshold
        self.debug = debug
        self.used = 0
        self.map = {}
        self.hits = 0
        self.misses = 0

    def get(self, key):
        v = self.map.get(key)
        if v is None:
            self.misses += 1
        else:
            self.hits += 1
        if self.debug:
            print(f"[dali_tpu_torch] decoder cache {'hit' if v is not None else 'miss'}: "
                  f"{key} ({self.hits} hits / {self.misses} misses)")
        return v

    def insert(self, key, img):
        if key in self.map:
            return
        nbytes = img.nbytes
        if self.threshold and nbytes > self.threshold:
            return
        if self.used + nbytes > self.capacity:
            if self.policy != "largest":
                return
            for k in sorted(self.map, key=lambda k: self.map[k].nbytes):
                if self.used + nbytes <= self.capacity or self.map[k].nbytes >= nbytes:
                    break
                self.used -= self.map[k].nbytes
                del self.map[k]
            if self.used + nbytes > self.capacity:
                return
        self.map[key] = np.ascontiguousarray(img)
        self.used += nbytes


class _ImageDecoderBase(Operator):
    def _task_pool(self):
        return native.shared_pool(self.pipeline.num_threads)

    def _decode(self, data, output_type=None) -> np.ndarray:
        """One sample, as the reference's ``_decode``: EXIF orientation,
        ``downscale_shorter_hint``, fancy upsampling and dtype."""
        out_type = (self.spec.GetArgument("output_type") if output_type is None
                    else output_type)
        hint = self.spec.GetArgument("downscale_shorter_hint")
        denom = 1
        if hint and imgcodec.is_jpeg(data):
            try:
                h, w, _ = imgcodec.peek_shape(data)
                denom = choose_denom(h, w, hint)
            except Exception:
                denom = 1
        return imgcodec.decode(
            data, output_type=out_type, denom=denom,
            adjust_orientation=self.spec.GetArgument("adjust_orientation"),
            fancy_upsampling=self.spec.GetArgument("jpeg_fancy_upsampling"),
            dtype=self.spec.GetArgument("dtype"))

    def _jpeg_batch(self, datas, idx, denoms, gray=False):
        """Decode ``datas[i]`` for i in ``idx`` at ``denoms`` in one native
        call: (images, codes), the code of each sample as
        ``native.decode_jpeg_batch`` gives it. A header the decoder cannot
        read gives no image and code -1: the per-sample path raises for it."""
        dims, keep = [], []
        for i, dn in zip(idx, denoms):
            try:
                dims.append(native.jpeg_scaled_dims(datas[i], dn)[:2])
                keep.append(True)
            except (ValueError, NotImplementedError):
                dims.append(None)
                keep.append(False)
        imgs = [np.empty((hw[0], hw[1], 1 if gray else 3), np.uint8) if hw else None
                for hw in dims]
        run = [j for j in range(len(idx)) if keep[j]]
        codes = [-1] * len(idx)
        if run:
            rcs = native.decode_jpeg_batch(
                self._task_pool(), [datas[idx[j]] for j in run], [imgs[j] for j in run],
                [denoms[j] for j in run], [dims[j][0] for j in run], [dims[j][1] for j in run],
                self.spec.GetArgument("jpeg_fancy_upsampling"), gray)
            for j, rc in zip(run, rcs):
                codes[j] = rc
        return imgs, codes

    def _decode_all(self, datas, output_type=None):
        """``_decode`` of every sample, the JPEGs of the batch (upright, or
        with ``adjust_orientation`` off) decoded by one native call on the
        operator's task pool (same output)."""
        spec = self.spec
        out_type = spec.GetArgument("output_type") if output_type is None else output_type
        hint = spec.GetArgument("downscale_shorter_hint")
        adjust = spec.GetArgument("adjust_orientation")
        gray = out_type == DALIImageType.GRAY
        fast, denoms = [], []
        for i, d in enumerate(datas):
            if imgcodec.is_jpeg(d) and not imgcodec.is_jpeg2000(d) and (
                    not adjust or imgcodec.exif_orientation(d) == 1):
                dn = 1
                if hint:
                    h, w, _ = imgcodec.peek_shape(d)
                    dn = choose_denom(h, w, hint)
                denoms.append(dn)
                fast.append(i)
        out = [None] * len(datas)
        imgs, codes = self._jpeg_batch(datas, fast, denoms, gray)
        dtype = spec.GetArgument("dtype")
        for i, img, rc in zip(fast, imgs, codes):
            if rc == native.ROUTE_LIBJPEG:
                out[i] = imgcodec._convert_dtype(
                    img if gray else imgcodec._convert_from_rgb(img, out_type), dtype)
            elif rc == native.ROUTE_CV2:
                out[i] = imgcodec.cv2_route_output(
                    img, imgcodec.exif_orientation(datas[i]), out_type, dtype)
        for i, d in enumerate(datas):
            if out[i] is None:
                out[i] = self._decode(d, out_type)
        return out

    def run_batch(self, ctx, inp):
        datas = [_as_bytes(e) for e in inp.samples]
        imgs = self._decode_all(datas)
        return [HostBatch([self._post(ctx, i, img) for i, img in enumerate(imgs)], layout="HWC")]

    def _post(self, ctx, idx, img):
        return img

    def output_layout(self, output_idx, inputs):
        return "HWC"


@register_operator("decoders.Image", "cpu")
class ImageDecoderCPU(_ImageDecoderBase):
    pass


@register_operator("decoders.Image", "mixed")
class ImageDecoderMixed(_ImageDecoderBase):
    """Host decode whose output lives on the device. ``stage_batch`` decodes
    the whole batch straight into its slots of the padded boundary canvas
    with one native call (cache hits by memcpy, misses decoded, then
    stored); other output types, dtypes, EXIF-rotated or non-JPEG samples
    take the per-sample path, as in the reference."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._img_cache = None
        self._exif_scan_cache = {}
        size = spec.GetArgument("cache_size")
        if size:
            self._img_cache = _DecoderCache(
                size, spec.GetArgument("cache_type"),
                spec.GetArgument("cache_threshold") or (size << 20),
                debug=spec.GetArgument("cache_debug"))

    def stage_batch(self, ctx, inputs, canvas):
        """(arr [N, ch, cw, 3] uint8, shapes [N, 3] int32, layout), or None
        for the per-sample path. Padding bytes are left uninitialised."""
        spec = self.spec
        if spec.GetArgument("output_type") != DALIImageType.RGB:
            return None
        if spec.GetArgument("dtype") not in (None, DALIDataType.UINT8):
            return None
        inp = inputs[0]
        n = len(inp.samples)
        cache = self._img_cache
        keys = inp.source_info if cache is not None else None
        hint = spec.GetArgument("downscale_shorter_hint")
        datas = [_as_bytes(e) for e in inp.samples]
        srcs = inp.source_info
        if spec.GetArgument("adjust_orientation"):
            # per-file orientation verdicts, keyed by content
            ecache = self._exif_scan_cache
            for i, d in enumerate(datas):
                ck = _content_key(srcs[i], d) if srcs and i < len(srcs) and srcs[i] else None
                orient = ecache.get(ck) if ck else None
                if orient is None:
                    orient = imgcodec.exif_orientation(d)
                    if ck:
                        if len(ecache) > (1 << 20):
                            ecache.clear()
                        ecache[ck] = orient
                if orient != 1:
                    return None
        dims, denoms = [], []
        for d in datas:
            if not imgcodec.is_jpeg(d):
                return None
            try:
                h, w, _ = imgcodec.peek_shape(d)
                dn = choose_denom(h, w, hint)
                sh, sw, _ = native.jpeg_scaled_dims(d, dn)
            except (ValueError, NotImplementedError):
                return None
            dims.append((sh, sw))
            denoms.append(dn)
        shapes = np.array([[h, w, 3] for h, w in dims], dtype=np.int32)
        from ..executor import PAD_ALIGN as align

        ch = max(int(-(-shapes[:, 0].max() // align) * align), canvas[0] if canvas else 0)
        cw = max(int(-(-shapes[:, 1].max() // align) * align), canvas[1] if canvas else 0)
        arr = np.empty((n, ch, cw, 3), dtype=np.uint8)
        hit = [False] * n
        if cache is not None and keys:
            for i in range(n):
                img = cache.get(keys[i]) if keys[i] else None
                if img is not None and img.shape[0] <= ch and img.shape[1] <= cw:
                    h, w = img.shape[:2]
                    arr[i, :h, :w] = img
                    shapes[i] = (h, w, 3)
                    hit[i] = True
        todo = [i for i in range(n) if not hit[i]]
        if todo:
            fancy = spec.GetArgument("jpeg_fancy_upsampling")
            rcs = native.decode_jpeg_batch(
                self._task_pool(), [datas[i] for i in todo], [arr[i] for i in todo],
                [denoms[i] for i in todo], [int(shapes[i, 0]) for i in todo],
                [int(shapes[i, 1]) for i in todo], fancy)
            for i, rc in zip(todo, rcs):
                if rc == native.ROUTE_LIBJPEG or (
                        rc == native.ROUTE_CV2 and imgcodec.exif_orientation(datas[i]) == 1):
                    continue
                # what libjpeg declines the reference decodes again through
                # imgcodec at the same scale, clipped into the slot
                img = imgcodec.decode(datas[i], output_type=DALIImageType.RGB,
                                      denom=denoms[i], fancy_upsampling=fancy)
                h, w = min(img.shape[0], ch), min(img.shape[1], cw)
                shapes[i] = (h, w, 3)
                arr[i, :h, :w] = img[:h, :w]
        if cache is not None and keys:
            for i in todo:
                if keys[i]:
                    cache.insert(keys[i], arr[i, :shapes[i, 0], :shapes[i, 1]])
        return arr, shapes, "HWC"


# -- decoders.ImageRandomCrop ----------------------------------------------------------------
_decoder_schema("decoders.ImageRandomCrop").DocStr(
    """Decode + random crop (reference ``decoders__ImageRandomCrop``): the
    area/aspect window is sampled from the header size (RandomResizedCrop's
    draws), the image decoded whole (at a DCT scale under
    ``downscale_shorter_hint``) and cropped."""
).AddOptionalArg(
    "random_area", ArgType.FLOAT_VEC, "Area range of the crop.", [0.08, 1.0]
).AddOptionalArg(
    "random_aspect_ratio", ArgType.FLOAT_VEC, "Aspect-ratio range.", [3 / 4, 4 / 3]
).AddOptionalArg(
    "num_attempts", ArgType.INT, "Sampling attempts before fallback.", 10
).AddRandomSeedArg()


class _ImageRandomCropBase(_ImageDecoderBase):
    """The reference's ``run_sample`` over a batch: per sample, its Philox
    stream and, for an upright RGB uint8 JPEG, the window from the header
    size and the scale from the window; those samples then decode in one
    native call. The others decode first and draw the window from the
    decoded size, and so do the JPEGs libjpeg declines (CMYK, YCCK): the
    reference draws for them twice, from the header and, after libjpeg fails,
    from the decoded size with the same generator."""

    def run_batch(self, ctx, inp):
        spec = self.spec
        area = spec.GetArgument("random_area")
        ar = spec.GetArgument("random_aspect_ratio")
        attempts = spec.GetArgument("num_attempts")
        hint = spec.GetArgument("downscale_shorter_hint")
        rgb_u8 = (spec.GetArgument("output_type") == DALIImageType.RGB
                  and spec.GetArgument("dtype") in (None, DALIDataType.UINT8))
        adjust = spec.GetArgument("adjust_orientation")
        datas = [_as_bytes(e) for e in inp.samples]
        n = len(datas)
        rngs = [ctx.rng(self, i) for i in range(n)]
        out = [None] * n
        fast, wins, denoms, redo = [], [], [], {}
        for i, d in enumerate(datas):
            if not (rgb_u8 and imgcodec.is_jpeg(d)
                    and (not adjust or imgcodec.exif_orientation(d) == 1)):
                continue
            try:
                h, w, _ = imgcodec.peek_shape(d)
            except Exception:
                continue
            win = sample_rrc_window(rngs[i], h, w, area, ar, attempts)
            fast.append(i)
            wins.append(win)
            denoms.append(choose_denom(win[2], win[3], hint) if hint else 1)
        imgs, codes = self._jpeg_batch(datas, fast, denoms)
        for i, img, (y, x, ch, cw), dn, rc in zip(fast, imgs, wins, denoms, codes):
            if rc != native.ROUTE_LIBJPEG:
                # libjpeg declines it: the reference decodes it again through
                # _decode, whose scale comes from the image, not the window
                h, w, _ = imgcodec.peek_shape(datas[i])
                same = (rc == native.ROUTE_CV2 and imgcodec.exif_orientation(datas[i]) == 1
                        and (choose_denom(h, w, hint) if hint else 1) == dn)
                redo[i] = img if same else None
                continue
            if dn > 1:
                # crop coordinates in scaled space
                y, x = y // dn, x // dn
                ch = max(1, min(ch // dn, img.shape[0] - y))
                cw = max(1, min(cw // dn, img.shape[1] - x))
            # a view: the boundary pad (or the consumer) copies it once
            out[i] = img[y:y + ch, x:x + cw]
        for i in range(n):
            if out[i] is None:
                img = redo.get(i)
                if img is None:
                    img = self._decode(datas[i])
                y, x, ch, cw = sample_rrc_window(rngs[i], img.shape[0], img.shape[1], area, ar,
                                                 attempts)
                out[i] = img[y:y + ch, x:x + cw]
        return [HostBatch(out, layout="HWC")]


@register_operator("decoders.ImageRandomCrop", "cpu")
class ImageRandomCropCPU(_ImageRandomCropBase):
    pass


@register_operator("decoders.ImageRandomCrop", "mixed")
class ImageRandomCropMixed(_ImageRandomCropBase):
    pass


# -- decoders.ImageCrop ------------------------------------------------------------------------
_decoder_schema("decoders.ImageCrop").DocStr(
    "Decode + static crop (reference decoders__ImageCrop)."
).AddOptionalArg("crop", ArgType.FLOAT_VEC, "Crop (H, W).", None).AddOptionalArg(
    "crop_pos_x", ArgType.FLOAT, "Horizontal window position [0,1].", 0.5, tensor_ok=True
).AddOptionalArg(
    "crop_pos_y", ArgType.FLOAT, "Vertical window position [0,1].", 0.5, tensor_ok=True
).AddOptionalArg(
    "crop_w", ArgType.FLOAT, "Crop width.", 0.0, tensor_ok=True
).AddOptionalArg(
    "crop_h", ArgType.FLOAT, "Crop height.", 0.0, tensor_ok=True
).AddOptionalArg(
    "crop_d", ArgType.FLOAT,
    "Volumetric crop depth (CropAttr compat; accepted, unused for 2-D images).", 0.0,
    tensor_ok=True
).AddOptionalArg(
    "crop_pos_z", ArgType.FLOAT, "Volumetric window z (CropAttr compat).", 0.5,
    tensor_ok=True
).AddOptionalArg(
    "rounding", ArgType.STRING,
    'Crop-start integer conversion: "round" or "truncate" (crop_attr.cc).', "round"
)


def crop_round(v, mode):
    """crop_attr.cc's round_fn_: half away from zero, or truncation toward zero
    (reference ``generic2._crop_round``)."""
    v = float(v)
    if mode == "truncate":
        return int(v)
    return int(np.floor(v + 0.5)) if v >= 0 else int(np.ceil(v - 0.5))


class _ImageCropBase(_ImageDecoderBase):
    def _post(self, ctx, idx, img):
        h, w = img.shape[:2]
        crop = self.spec.GetArgument("crop")
        ch = int(ctx.arg(self, "crop_h", idx, 0) or (crop[0] if crop else h))
        cw = int(ctx.arg(self, "crop_w", idx, 0) or (crop[1] if crop else w))
        py = float(ctx.arg(self, "crop_pos_y", idx, 0.5))
        px = float(ctx.arg(self, "crop_pos_x", idx, 0.5))
        ch, cw = min(ch, h), min(cw, w)
        rnd = self.spec.GetArgument("rounding")
        y = crop_round(py * (h - ch), rnd)
        x = crop_round(px * (w - cw), rnd)
        return np.ascontiguousarray(img[y:y + ch, x:x + cw])


@register_operator("decoders.ImageCrop", "cpu")
class ImageCropCPU(_ImageCropBase):
    pass


@register_operator("decoders.ImageCrop", "mixed")
class ImageCropMixed(_ImageCropBase):
    pass


# -- decoders.ImageSlice (reference misc2.py:271-345) ------------------------------------------
DALI_SCHEMA("decoders.ImageSlice").DocStr(
    "Decode + slice (reference ``decoders__ImageSlice``): anchor/shape given as "
    "positional inputs (relative by default)."
).NumInput(1, 3).NumOutput(1).Devices("cpu", "mixed").AddOptionalArg(
    "output_type", ArgType.IMAGE_TYPE, "Color space.", None
).AddOptionalArg(
    "normalized_anchor", ArgType.BOOL, "Anchor input is relative.", True
).AddOptionalArg(
    "normalized_shape", ArgType.BOOL, "Shape input is relative.", True
).AddOptionalArg(
    "axes", ArgType.INT_VEC, "Sliced axes.", [1, 0]
).AddOptionalArg(
    "axis_names", ArgType.TENSOR_LAYOUT,
    'Sliced axes by layout letter (takes precedence over `axes`).', None
).AddOptionalArg(
    "adjust_orientation", ArgType.BOOL, "Apply EXIF orientation.", True
).AddOptionalArg(
    "dtype", ArgType.DATA_TYPE, "Output dtype (uint8).", None
).AddOptionalArg(
    "jpeg_fancy_upsampling", ArgType.BOOL,
    "Triangular chroma upsampling for subsampled JPEGs.", True
).AddOptionalArg(
    "device_memory_padding_jpeg2k", ArgType.INT, "Compatibility no-op.", 0
).AddOptionalArg(
    "host_memory_padding_jpeg2k", ArgType.INT, "Compatibility no-op.", 0
)


class _ImageSliceBase(_ImageDecoderBase):
    def run_batch(self, ctx, inp, *pos):
        spec = self.spec
        out_type = spec.GetArgument("output_type") or DALIImageType.RGB
        datas = [_as_bytes(e) for e in inp.samples]
        imgs = []
        for d in datas:
            # the reference decodes full size and converts with astype
            imgs.append(imgcodec.decode(
                d, output_type=out_type, adjust_orientation=spec.GetArgument("adjust_orientation"),
                fancy_upsampling=spec.GetArgument("jpeg_fancy_upsampling")))
        dt = spec.GetArgument("dtype")
        out = []
        for i, img in enumerate(imgs):
            if dt is not None:
                img = img.astype(to_numpy_type(dt))
            out.append(self._slice(img, [p.samples[i] for p in pos]))
        return [HostBatch(out, layout="HWC")]

    def _slice(self, img, pos):
        if not pos:
            return img
        anchor = np.asarray(pos[0], np.float64).reshape(-1)
        shape = np.asarray(pos[1], np.float64).reshape(-1) if len(pos) > 1 else None
        axes = self.spec.GetArgument("axes")
        names = self.spec.GetArgument("axis_names")
        if names:  # letters refer to the decoded HWC layout
            axes = ["HWC".index(ch) for ch in names]
        dims = np.array([img.shape[a] for a in axes], np.float64)
        if self.spec.GetArgument("normalized_anchor"):
            anchor = anchor * dims
        if shape is not None and self.spec.GetArgument("normalized_shape"):
            shape = shape * dims
        sl = [slice(None)] * img.ndim
        for k, a in enumerate(axes):
            lo = int(round(anchor[k]))
            ln = int(round(shape[k])) if shape is not None else img.shape[a] - lo
            sl[a] = slice(max(lo, 0), max(lo, 0) + ln)
        return np.ascontiguousarray(img[tuple(sl)])


@register_operator("decoders.ImageSlice", "cpu")
class ImageSliceCPU(_ImageSliceBase):
    pass


@register_operator("decoders.ImageSlice", "mixed")
class ImageSliceMixed(_ImageSliceBase):
    pass


# -- PeekImageShape (reference decoders.py:1400-1440) ------------------------------------------
DALI_SCHEMA("PeekImageShape").DocStr(
    "Image shape from the encoded header without decoding (reference "
    "``imgcodec/peek_image_shape.cc``)."
).NumInput(1).NumOutput(1).Devices("cpu").AddOptionalArg(
    "dtype", ArgType.DATA_TYPE, "Output dtype.", None
).AddOptionalArg(
    "image_type", ArgType.IMAGE_TYPE,
    "Color space the decode would produce: GRAY reports 1 channel.", DALIImageType.RGB
).AddOptionalArg(
    "adjust_orientation", ArgType.BOOL,
    "Report the post-EXIF-rotation shape: orientations 5-8 swap height/width.", True
)


@register_operator("PeekImageShape", "cpu")
class PeekImageShape(Operator):
    def run_sample(self, ctx, idx, encoded):
        data = _as_bytes(encoded)
        h, w, c = imgcodec.peek_shape(data)
        if self.spec.GetArgument("adjust_orientation") and imgcodec.is_jpeg(data):
            if imgcodec.exif_orientation(data) >= 5:
                h, w = w, h
        if self.spec.GetArgument("image_type") == DALIImageType.GRAY:
            c = 1
        dtype = self.spec.GetArgument("dtype")
        return np.array([h, w, c], dtype=to_numpy_type(dtype) if dtype is not None else np.int64)

    def output_layout(self, output_idx, inputs):
        return ""


# ================================ the int16 wire: _JpegCoeffs / _JpegIdct ========================
# Counterpart of dali_tpu/backend/decoders.py:526-884: the host reads the
# k x k low-frequency corner of every block at full int16 precision, the
# device dequantises, IDCTs, upsamples chroma and converts colour.
DALI_SCHEMA("_JpegCoeffs").DocStr(
    """Host half of the hybrid JPEG decoder, int16 wire: entropy decode only,
    low-frequency DCT coefficient planes + quant tables. Outputs: (y_coeffs,
    chroma_coeffs, quant_tables, dims)."""
).NumInput(1).NumOutput(4).Devices("mixed").MakeInternal().AddOptionalArg(
    "cache_size", ArgType.INT, "Coefficient cache budget in MB (0 = off).", 0
).AddOptionalArg(
    "adjust_orientation", ArgType.BOOL,
    "EXIF-rotated JPEGs cannot ride the coefficient wire: orientation tags != 1 raise unless "
    "this is False.", True
).AddOptionalArg(
    "hybrid_scale", ArgType.INT, "Decode scale denominator (1, 2, or 4).", 1
).AddOptionalArg("chroma_full", ArgType.BOOL, "Full-spectrum chroma (2x traffic).", False)

DALI_SCHEMA("_JpegIdct").DocStr(
    """Device half of the hybrid JPEG decoder, int16 wire: dequantise + scaled
    IDCT + chroma upsample + BT.601 YCbCr->RGB."""
).NumInput(4).NumOutput(1).Devices("gpu").MakeInternal().AddOptionalArg(
    "hybrid_scale", ArgType.INT, "Decode scale denominator (1, 2, or 4).", 1
).AddOptionalArg("chroma_full", ArgType.BOOL, "Full-spectrum chroma (2x traffic).", False)

@register_operator("_JpegCoeffs", "mixed")
class JpegCoeffs(_HybridCoeffs):
    """The reference's ``JpegCoeffs`` (per-sample planes, per-sample cache
    entries), with the planes written by one native batch call straight into
    their slots of the two grow-only boundary canvases: exact for a batch of
    one shape, else aligned as the reference's ``boundary_align`` asks
    (luma [8, 8], chroma by mode)."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._canvases = [None, None]

    def _canvas_for(self, j, shapes, align):
        """Grow-only canvas of output j for per-sample ``shapes`` [n, ndim]."""
        uniform = bool((shapes == shapes[0]).all())
        a = [1] * shapes.shape[1] if uniform else align
        want = [-(-int(shapes[:, d].max()) // a[d]) * a[d] for d in range(shapes.shape[1])]
        prev = self._canvases[j]
        if prev is not None:
            want = [max(w, p) for w, p in zip(want, prev)]
        self._canvases[j] = want
        return want

    def stage_batch_multi(self, ctx, inputs):
        ky, kc = _ks(self.spec)
        datas, keys, infos, mode = self._headers(inputs[0])
        n = len(datas)
        blocks = infos[:, 2:6].astype(np.int32)
        y_shapes = np.concatenate([blocks[:, :2], np.full((n, 1), ky * ky, np.int32)], 1)
        c_shapes = np.concatenate([np.full((n, 1), 2, np.int32), blocks[:, 2:],
                                   np.full((n, 1), kc * kc, np.int32)], 1)
        yc = self._canvas_for(0, y_shapes, [8, 8, 1])
        cc = self._canvas_for(1, c_shapes, [1, {0: 4, 1: 8, 2: 8}[mode], {0: 4, 1: 8, 2: 4}[mode],
                                            1])
        y = np.zeros((n, *yc), np.int16)
        c = np.zeros((n, *cc), np.int16)
        q = np.empty((n, ky * ky + kc * kc), np.int32)
        cache = self._ccache
        ckeys = ([_content_key(k, d) for k, d in zip(keys, datas)]
                 if cache is not None and keys else [None] * n)
        # cache hits by memcpy, in sample order (the reference's order with one
        # thread); a key seen earlier in the batch hits once its planes are stored
        read, first = [], {}
        hit = [None] * n
        for i, k in enumerate(ckeys):
            if not k:
                read.append(i)
                continue
            ent = cache["map"].get(k)
            if ent is not None:
                hit[i] = ent
                cache["hits"] += 1
            elif k in first:
                hit[i] = first[k]  # resolved after the read
            else:
                first[k] = i
                read.append(i)
        if read:
            idx = np.asarray(read)
            whole = len(read) == n
            yr, cr = (y, c) if whole else (np.zeros((len(read), *yc), np.int16),
                                           np.zeros((len(read), *cc), np.int16))
            q[idx] = native.coef_full_batch(self._task_pool(), [datas[i] for i in read], ky, kc,
                                            blocks[idx], yr, cr)
            if not whole:
                y[idx], c[idx] = yr, cr
        for i, k in enumerate(ckeys):
            if k is None:
                continue
            ybh, ybw, cbh, cbw = (int(v) for v in blocks[i])
            if isinstance(hit[i], int):  # a repeat of sample hit[i] in this batch
                j = hit[i]
                y[i], c[i], q[i] = y[j], c[j], q[j]
                cache["hits" if k in cache["map"] else "misses"] += 1
                continue
            if hit[i] is not None:
                ey, ec, eq = hit[i]
                y[i, :ybh, :ybw] = ey
                c[i, :, :cbh, :cbw] = ec
                q[i] = eq
                continue
            cache["misses"] += 1
            ent = (y[i, :ybh, :ybw].copy(), c[i, :, :cbh, :cbw].copy(), q[i].copy())
            nbytes = sum(a.nbytes for a in ent)
            if cache["used"] + nbytes <= cache["cap"]:
                cache["map"][k] = ent
                cache["used"] += nbytes
        dims = [np.array([infos[i, 0], infos[i, 1], mode], np.int32) for i in range(n)]
        return [Staged(y, y_shapes), Staged(c, c_shapes), HostBatch(list(q)), HostBatch(dims)]


@register_operator("_JpegIdct", "gpu")
class JpegIdct(Operator):
    def host_output_layouts(self, in_layouts):
        return ["HWC"]

    def device_statics(self, ctx, in_shapes, in_batches):
        dims = in_batches[3]
        return (int(np.asarray(dims.samples[0])[2]),) if dims is not None else (0,)

    def host_output_shapes(self, ctx, input_shapes, input_batches):
        dims_hb = input_batches[3]
        if dims_hb is None:
            return None
        d = int(self.spec.GetArgument("hybrid_scale"))
        dims = np.stack(dims_hb.samples).astype(np.int64)
        return [np.stack([-(-dims[:, 0] // d), -(-dims[:, 1] // d), np.full(len(dims), 3)],
                         1).astype(np.int32)]

    def lower(self, dctx, y_b, c_b, q_b, dims_b):
        d = int(self.spec.GetArgument("hybrid_scale"))
        ky = {1: 8, 2: 4, 4: 2}[d]
        (mode,) = dctx.static(self) or (0,)
        rgb = jk.jpeg_device_tail(y_b.data, c_b.data, q_b.data, ky, mode,
                                  bool(self.spec.GetArgument("chroma_full")))
        dims = dims_b.data.to(torch.int32)
        shapes = torch.stack([(dims[:, 0] + d - 1) // d, (dims[:, 1] + d - 1) // d,
                              torch.full_like(dims[:, 0], 3)], 1)
        return [DeviceBatch(rgb, shapes, "HWC")]
