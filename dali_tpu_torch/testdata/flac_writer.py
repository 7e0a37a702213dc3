"""A FLAC encoder in numpy, for test data and the FLAC corpus of the ASR
path (RFC 9639). No FLAC encoder is needed on any machine.

By default it encodes as FFmpeg's FLAC encoder does at its defaults: blocks
of 4096 samples, LPC of an estimated order up to 8 with coefficients at
15-bit precision (CONSTANT and VERBATIM where those are cheaper), Rice
partitions of order up to 8, and for stereo the cheapest of independent,
left/side, right/side and mid/side.

Options force every other form a decoder must read, so that tests reach
each: the subframe type and predictor order, wasted bits, Rice2 and
escaped partitions, each channel assignment, block sizes of every header
code (explicit 8- and 16-bit ones included) and variable block sizes,
sample rates of every header code, 8- to 24-bit samples, the metadata
blocks a decoder skips and a leading ID3v2 tag.

Usage::

    from dali_tpu_torch.testdata.flac_writer import encode
    data = encode(pcm_int, rate=16000, bits=16)  # pcm_int: int [n] or [n, ch]
"""

from __future__ import annotations

import numpy as np

BLOCK = 4096
MAX_LPC_ORDER = 8
LPC_PRECISION = 15
MAX_PARTITION_ORDER = 8

_RATE_CODES = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6, 24000: 7,
               32000: 8, 44100: 9, 48000: 10, 96000: 11}
_BITS_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}


# ------------------------------------------------------------------ bits


class _Bits:
    """Fields of (value, width, significant low bits), packed at once."""

    def __init__(self):
        self.vals, self.widths, self.sig = [], [], []

    def put(self, value, width):
        v = np.atleast_1d(np.asarray(value, np.int64))
        w = np.broadcast_to(np.asarray(width, np.int64), v.shape)
        mask = np.where(w >= 63, -1, (np.int64(1) << np.minimum(w, 62)) - 1)
        self.vals.append(v & mask)
        self.widths.append(w.astype(np.int64))
        self.sig.append(np.minimum(w, 63).astype(np.int64))

    def rice(self, u, k):
        """Rice codes of unsigned ``u`` with parameter ``k``: u >> k zeros,
        a one, then the k low bits."""
        u = np.asarray(u, np.int64)
        k = np.broadcast_to(np.asarray(k, np.int64), u.shape)
        self.vals.append((np.int64(1) << k) | (u & ((np.int64(1) << k) - 1)))
        self.widths.append((u >> k) + 1 + k)
        self.sig.append(k + 1)

    def nbits(self):
        return int(sum(int(w.sum()) for w in self.widths))

    def tobytes(self) -> bytes:
        if not self.vals:
            return b""
        vals, widths, sig = (np.concatenate(a) for a in (self.vals, self.widths, self.sig))
        ends = np.cumsum(widths)
        total = int(ends[-1]) if len(ends) else 0
        bits = np.zeros(-(-total // 8) * 8, np.uint8)
        for j in range(int(sig.max()) if len(sig) else 0):
            m = j < sig
            bits[ends[m] - 1 - j] = (vals[m] >> j) & 1
        return np.packbits(bits).tobytes()


def _crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c ^= b
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
    return c


def _crc16_table16():
    t = np.arange(65536, dtype=np.uint32)
    for _ in range(16):
        t = np.where(t & 0x8000, (t << 1) ^ 0x8005, t << 1) & 0xFFFF
    return t.astype(np.uint16)


_T16 = None


def crc16(frames):
    """CRC-16 (polynomial 0x8005) of each byte string, processed together,
    two bytes a step."""
    global _T16
    if _T16 is None:
        _T16 = _crc16_table16()
    n = len(frames)
    lens = np.array([len(f) for f in frames])
    width = int(lens.max()) + (int(lens.max()) & 1)
    buf = np.zeros((n, width), np.uint8)
    for i, f in enumerate(frames):
        buf[i, :len(f)] = np.frombuffer(f, np.uint8)
    words = (buf[:, 0::2].astype(np.uint32) << 8) | buf[:, 1::2]
    crc = np.zeros(n, np.uint32)
    odd = lens & 1
    for j in range(words.shape[1]):
        live = 2 * j + 2 <= lens
        crc = np.where(live, _T16[(crc ^ words[:, j]) & 0xFFFF], crc)
    # an odd last byte: one more byte step
    last = np.where(odd == 1, buf[np.arange(n), np.maximum(lens - 1, 0)], 0).astype(np.uint32)
    for i in np.nonzero(odd)[0]:
        c = int(crc[i]) ^ (int(last[i]) << 8)
        for _ in range(8):
            c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 else (c << 1) & 0xFFFF
        crc[i] = c
    return [int(c) for c in crc]


# ------------------------------------------------------------------ prediction


def _fixed_residual(x, order):
    r = x.astype(np.int64)
    for _ in range(order):
        r = np.diff(r)
    return r


def _lpc_coefs(x, order):
    """Levinson-Durbin on the Welch-windowed autocorrelation: the
    coefficients of orders 1..order (float64) and the reflection
    coefficients."""
    n = len(x)
    w = 1.0 - ((np.arange(n) - (n - 1) / 2.0) / ((n + 1) / 2.0)) ** 2
    xw = x.astype(np.float64) * w
    ac = np.array([np.dot(xw[:n - k], xw[k:]) for k in range(order + 1)])
    ac[0] *= 1.0 + 1e-10
    ac[0] += 1e-9
    a = np.zeros(order)
    err = ac[0]
    out, reflection = [], []
    for i in range(order):
        k = (ac[i + 1] - np.dot(a[:i], ac[i:0:-1])) / err
        a[:i] = a[:i] - k * a[:i][::-1]
        a[i] = k
        err *= 1.0 - k * k
        out.append(a[:i + 1].copy())
        reflection.append(k)
    return out, reflection


def _quantize(coefs, precision):
    """Integer coefficients and shift, with error feedback, as FFmpeg's
    ``ff_lpc_quantize`` does."""
    cmax = np.abs(coefs).max()
    if cmax <= 0:
        return np.zeros(len(coefs), np.int64), 0
    qmax = (1 << (precision - 1)) - 1
    shift = 15
    while shift > 0 and cmax * (1 << shift) > qmax:
        shift -= 1
    q = np.zeros(len(coefs), np.int64)
    err = 0.0
    for i, c in enumerate(coefs):
        err += c * (1 << shift)
        q[i] = int(np.clip(np.floor(err + 0.5), -qmax - 1, qmax))
        err -= q[i]
    return q, shift


def _lpc_residual(x, q, shift):
    order = len(q)
    x = x.astype(np.int64)
    pred = np.zeros(len(x) - order, np.int64)
    for j in range(order):
        pred += q[j] * x[order - 1 - j:len(x) - 1 - j]
    return x[order:] - (pred >> shift)


# ------------------------------------------------------------------ residual coding


def _zigzag(r):
    return np.where(r >= 0, 2 * r, -2 * r - 1).astype(np.int64)


def _best_partitions(u, order, max_porder, rice2, escape):
    """(cost in bits, partition order, per-partition parameters, escape
    widths or None) of the cheapest Rice partitioning of residual ``u``
    (zigzagged; the first ``order`` samples of the block are warm-up). The
    finest partitioning is costed once and merged pairwise."""
    n = len(u) + order
    po = max_porder
    while po and (n % (1 << po) or n >> po <= order):
        po -= 1
    full = np.concatenate([np.zeros(order, np.int64), u]).reshape(1 << po, -1)
    kmax = 30 if rice2 else 14
    ks = np.arange(kmax + 1)
    qsum = np.stack([(full >> k).sum(axis=1) for k in ks], 1)  # [parts, k]
    counts = np.full(1 << po, n >> po)
    counts[0] -= order
    peak = full.max(axis=1) >> 1
    best = None
    while True:
        parts = len(counts)
        if escape:
            esc = np.array([int(m).bit_length() + 1 for m in peak])
            k = np.full(parts, 31 if rice2 else 15)
            cost = 5 + counts * esc
        else:
            esc = None
            cost_k = qsum + counts[:, None] * (ks + 1)
            k = cost_k.argmin(axis=1)
            cost = cost_k[np.arange(parts), k]
        total = int(cost.sum()) + parts * (5 if rice2 else 4) + 6
        if best is None or total < best[0]:
            best = (total, po, k, esc)
        if po == 0:
            return best
        po -= 1
        qsum = qsum.reshape(-1, 2, kmax + 1).sum(axis=1)
        counts = counts.reshape(-1, 2).sum(axis=1)
        peak = peak.reshape(-1, 2).max(axis=1)


def _write_residual(bw, r, order, po, ks, esc, rice2):
    bw.put(1 if rice2 else 0, 2)
    bw.put(po, 4)
    parts = 1 << po
    n = len(r) + order
    per = n // parts
    start = 0
    for p in range(parts):
        cnt = per - order if p == 0 else per
        seg = r[start:start + cnt]
        start += cnt
        if esc is not None:
            bw.put(31 if rice2 else 15, 5 if rice2 else 4)
            bw.put(int(esc[p]), 5)
            if esc[p]:
                bw.put(seg, int(esc[p]))
        else:
            bw.put(int(ks[p]), 5 if rice2 else 4)
            bw.rice(_zigzag(seg), int(ks[p]))


# ------------------------------------------------------------------ subframes


def _estimate_order(reflection, lo, hi):
    """The highest order whose reflection coefficient exceeds 0.10 in
    magnitude (FFmpeg's default order estimate), at least ``lo``."""
    big = [i + 1 for i, k in enumerate(reflection[:hi]) if abs(k) > 0.10]
    return max([lo] + big)


def _subframe_candidates(x, bps, opts):
    """Candidate encodings of one channel block: (cost, encoding) pairs.
    Unforced: CONSTANT where every sample is equal, VERBATIM, and LPC at the
    estimated order (FIXED where the block is too short for it)."""
    kind = opts.get("subframe")
    rice2, escape = opts.get("rice2", False), opts.get("escape", False)
    max_po = opts.get("max_partition_order", MAX_PARTITION_ORDER)
    max_lpc = min(opts.get("max_lpc_order", MAX_LPC_ORDER), len(x) - 1)
    cands = []
    if kind in (None, "constant") and (x == x[0]).all():
        cands.append((bps, ("constant",)))
    if kind in (None, "verbatim"):
        cands.append((bps * len(x), ("verbatim",)))
    fixed_orders = ()
    if kind == "fixed":
        fixed_orders = [opts["order"]] if opts.get("order") is not None else range(5)
    elif kind is None and max_lpc < 1:
        fixed_orders = range(min(5, len(x)))
    for order in fixed_orders:
        r = _fixed_residual(x, order)
        best = _best_partitions(_zigzag(r), order, max_po, rice2, escape)
        cands.append((order * bps + best[0], ("fixed", order, r, best)))
    if kind in (None, "lpc") and max_lpc >= 1:
        precision = opts.get("precision", LPC_PRECISION)
        if kind == "lpc" and opts.get("order") is not None:
            max_lpc = opts["order"]
        all_coefs, reflection = _lpc_coefs(x, max_lpc)
        order = (opts["order"] if kind == "lpc" and opts.get("order") is not None
                 else _estimate_order(reflection, 1, max_lpc))
        q, shift = _quantize(all_coefs[order - 1], precision)
        r = _lpc_residual(x, q, shift)
        best = _best_partitions(_zigzag(r), order, max_po, rice2, escape)
        cost = order * bps + 4 + 5 + order * precision + best[0]
        cands.append((cost, ("lpc", order, r, best, q, shift, precision)))
    return cands


def _write_subframe(bw, x, bps, opts):
    wasted = 0
    if opts.get("wasted", True) and (x != 0).any():
        tz = np.bitwise_and(x, -x)
        low = int(np.bitwise_or.reduce(tz[x != 0]))
        wasted = (low & -low).bit_length() - 1
        wasted = min(wasted, bps - 1)
    if wasted:
        x = x >> wasted
    sbps = bps - wasted
    cost, enc = min(_subframe_candidates(x, sbps, opts), key=lambda c: c[0])
    kind = enc[0]
    bw.put(0, 1)
    if kind == "constant":
        bw.put(0, 6)
    elif kind == "verbatim":
        bw.put(1, 6)
    elif kind == "fixed":
        bw.put(8 + enc[1], 6)
    else:
        bw.put(32 + enc[1] - 1, 6)
    if wasted:
        bw.put(1, 1)
        bw.put(1, wasted)  # wasted - 1 zeros, then a one
    else:
        bw.put(0, 1)
    if kind == "constant":
        bw.put(int(x[0]), sbps)
    elif kind == "verbatim":
        bw.put(x, sbps)
    elif kind == "fixed":
        order, r, (_, po, ks, esc) = enc[1], enc[2], enc[3]
        if order:
            bw.put(x[:order], sbps)
        _write_residual(bw, r, order, po, ks, esc, opts.get("rice2", False))
    else:
        order, r, (_, po, ks, esc), q, shift, precision = enc[1:]
        bw.put(x[:order], sbps)
        bw.put(precision - 1, 4)
        bw.put(shift, 5)
        bw.put(q, precision)
        _write_residual(bw, r, order, po, ks, esc, opts.get("rice2", False))
    return cost


# ------------------------------------------------------------------ frames


def _coded_number(v: int) -> bytes:
    if v < 0x80:
        return bytes([v])
    for extra, lead, width in ((1, 0xC0, 11), (2, 0xE0, 16), (3, 0xF0, 21), (4, 0xF8, 26),
                               (5, 0xFC, 31), (6, 0xFE, 36)):
        if v < 1 << width:
            break
    out = []
    for _ in range(extra):
        out.append(0x80 | (v & 0x3F))
        v >>= 6
    return bytes([lead | v] + out[::-1])


def _block_code(n: int, force=None):
    """(4-bit code, explicit bytes) of a block size."""
    table = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5}
    table.update({256 << k: 8 + k for k in range(8)})
    if force == 6 or (force is None and n not in table and n <= 256):
        return 6, bytes([n - 1])
    if force == 7 or (force is None and n not in table):
        return 7, (n - 1).to_bytes(2, "big")
    return table[n], b""


def _rate_code(rate: int, force=None):
    if force == 0:
        return 0, b""
    if force is None and rate in _RATE_CODES:
        return _RATE_CODES[rate], b""
    if force in (None, 12) and rate % 1000 == 0 and rate // 1000 < 256:
        return 12, bytes([rate // 1000])
    if force in (None, 13) and rate < 65536:
        return 13, rate.to_bytes(2, "big")
    if force in (None, 14) and rate % 10 == 0 and rate // 10 < 65536:
        return 14, (rate // 10).to_bytes(2, "big")
    return 0, b""


def _channel_options(block, mode):
    """(code, channel arrays, side index) candidates of a stereo block."""
    left, right = block[:, 0], block[:, 1]
    side = left - right
    cands = {"independent": (1, [left, right], None),
             "left_side": (8, [left, side], 1),
             "right_side": (9, [side, right], 0),
             "mid_side": (10, [(left + right) >> 1, side], 1)}
    if mode is not None:
        return [cands[mode]]
    return list(cands.values())


def _encode_frame(block, number, bits, rate, opts):
    n, nch = block.shape
    variable = opts.get("variable_blocks", False)
    bcode, bextra = _block_code(n, opts.get("block_code"))
    rcode, rextra = _rate_code(rate, opts.get("rate_code"))
    scode = 0 if opts.get("bits_from_streaminfo") else _BITS_CODES[bits]
    best = None
    options = (_channel_options(block, opts.get("channels")) if nch == 2
               else [(nch - 1, [block[:, c] for c in range(nch)], None)])
    for code, chans, side in options:
        bw = _Bits()
        for c, x in enumerate(chans):
            _write_subframe(bw, x, bits + (1 if c == side else 0), opts)
        size = bw.nbits()
        if best is None or size < best[0]:
            best = (size, code, bw)
    _, ccode, body = best
    header = bytes([0xFF, 0xF8 | int(variable), (bcode << 4) | rcode, (ccode << 4) | (scode << 1)])
    header += _coded_number(number) + bextra + rextra
    header += bytes([_crc8(header)])
    return header + body.tobytes()


# ------------------------------------------------------------------ stream


def _metadata(kind: str, last: bool) -> bytes:
    bodies = {"padding": (1, bytes(37)),
              "application": (2, b"tEsT" + b"\x01\x02\x03"),
              "seektable": (3, (0).to_bytes(8, "big") * 2 + bytes(2)),
              "vorbis_comment": (4, (6).to_bytes(4, "little") + b"numpy!" + (1).to_bytes(4, "little")
                                 + (9).to_bytes(4, "little") + b"TITLE=one"),
              "picture": (6, (3).to_bytes(4, "big") + (9).to_bytes(4, "big") + b"image/png"
                          + (0).to_bytes(4, "big") + bytes(16) + (4).to_bytes(4, "big")
                          + b"\x89PNG")}
    t, body = bodies[kind]
    return bytes([(0x80 if last else 0) | t]) + len(body).to_bytes(3, "big") + body


def encode(pcm, rate: int = 16000, bits: int = 16, block_size=BLOCK, metadata=(),
           id3=False, **opts) -> bytes:
    """A FLAC stream of integer PCM ``pcm`` ([n] or [n, channels], values
    within ``bits``). ``block_size``: an int, or a list of block sizes to
    cycle through (variable block sizes). ``metadata``: names of blocks
    written after STREAMINFO ("padding", "application", "seektable",
    "vorbis_comment", "picture"); ``id3``: a leading ID3v2 tag. Options:
    ``subframe`` ("constant", "verbatim", "fixed", "lpc") with ``order`` and
    ``precision``; ``channels`` ("independent", "left_side", "right_side",
    "mid_side"); ``rice2``; ``escape``; ``wasted`` (False: never);
    ``max_partition_order``; ``max_lpc_order``; ``block_code`` (6 or 7:
    explicit sizes); ``rate_code`` (0, 12, 13 or 14); ``bits_from_streaminfo``;
    ``variable_blocks`` (also set by a list ``block_size``)."""
    x = np.asarray(pcm).astype(np.int64)
    if x.ndim == 1:
        x = x[:, None]
    n, nch = x.shape
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    if x.min(initial=0) < lo or x.max(initial=0) > hi:
        raise ValueError(f"PCM outside {bits}-bit range")
    sizes = list(block_size) if isinstance(block_size, (list, tuple)) else [int(block_size)]
    if len(sizes) > 1:
        opts["variable_blocks"] = True
    blocks, pos, i = [], 0, 0
    while pos < n:
        b = min(sizes[i % len(sizes)], n - pos)
        blocks.append((pos, b))
        pos += b
        i += 1
    frames = [_encode_frame(x[p:p + b], (p if opts.get("variable_blocks") else k), bits, rate,
                            opts)
              for k, (p, b) in enumerate(blocks)]
    crcs = crc16(frames)
    frames = [f + c.to_bytes(2, "big") for f, c in zip(frames, crcs)]
    bmin = min(b for _, b in blocks) if blocks else 16
    bmax = max(b for _, b in blocks) if blocks else 16
    if len(blocks) > 1 and not opts.get("variable_blocks"):
        bmin = bmax
    fsz = [len(f) for f in frames]
    info = ((bmin << 16 | bmax).to_bytes(4, "big") + min(fsz).to_bytes(3, "big")
            + max(fsz).to_bytes(3, "big")
            + ((rate << 44) | ((nch - 1) << 41) | ((bits - 1) << 36) | n).to_bytes(8, "big")
            + bytes(16))
    meta = [bytes([0x80 if not metadata else 0]) + (34).to_bytes(3, "big") + info]
    meta += [_metadata(kind, i == len(metadata) - 1) for i, kind in enumerate(metadata)]
    head = b""
    if id3:
        tag = b"TIT2" + (5).to_bytes(4, "big") + b"\0\0" + b"\x03abc\0"
        size = len(tag) + 20
        head = b"ID3\x04\x00\x00" + bytes([(size >> 21) & 0x7F, (size >> 14) & 0x7F,
                                          (size >> 7) & 0x7F, size & 0x7F]) + tag + bytes(20)
    return head + b"fLaC" + b"".join(meta) + b"".join(frames)


def float_to_int16(x: np.ndarray) -> np.ndarray:
    """float32 -> int16 as FFmpeg's resampler converts: round(x * 32768),
    clipped."""
    return np.clip(np.round(x.astype(np.float64) * 32768.0), -32768, 32767).astype(np.int16)
