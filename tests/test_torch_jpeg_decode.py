"""The libjpeg-free JPEG host decode of dali_tpu_torch against libjpeg-turbo
(through ``dali_tpu.native``, which decodes with ``JDCT_ISLOW``):

* the int16 coefficient read (``native.jpeg_read_coeffs``) against
  ``dali_tpu.native.jpeg_read_coeffs`` (``jpeg_read_coefficients``);
* the pixel decode (``native.decode_jpeg``) against
  ``dali_tpu.native.decode_jpeg``, RGB and grayscale output, at 1/1, 1/2,
  1/4 and 1/8 scale, fancy upsampling on and off.

Tolerance: none, uint8 and int16 bit-equal, truncated progressive streams
included (libjpeg block-smooths their incomplete coefficients, and so does
the port). Test streams are the committed corpus re-encoded here with cv2
and PIL (4:4:0 and 4:1:1 through cv2's sampling flags), and a
non-interleaved baseline stream written by a small Huffman encoder below.
The other image forms are in ``test_torch_image_formats.py``."""

import os

import cv2
import numpy as np
import pytest

from dali_tpu import native as ref_native
from dali_tpu_torch import native as port_native
from dali_tpu_torch.native import build

CORPUS = os.path.join(os.path.dirname(__file__), "..", "dali_tpu_torch", "testdata", "rn50")
SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
SIZES = [(1, 1), (7, 9), (17, 33), (37, 50), (64, 48)]
KS = [(8, 8), (4, 4), (2, 2), (8, 4), (4, 2)]


def _corpus_files(k=None):
    files = sorted(os.path.join(r, f) for r, _, fs in os.walk(CORPUS) for f in fs
                   if f.endswith(".jpg"))
    return files[:k] if k else files


def _base(i=0):
    return cv2.imread(_corpus_files()[i])


def _encode(img, sampling="420", quality=90, progressive=False, rst=0):
    flags = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
             SAMPLING[sampling], cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
             cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    ok, buf = cv2.imencode(".jpg", img, flags)
    assert ok
    return buf.tobytes()


def _sized(img, hw):
    return img[:1, :1] if hw == (1, 1) else cv2.resize(img, hw[::-1])


def _assert_read_equal(data, ks=KS):
    info = ref_native.jpeg_coef_info(data)
    assert info is not None
    np.testing.assert_array_equal(port_native.jpeg_coef_info(data), info)
    _, _, ybh, ybw, cbh, cbw, _ = info
    for ky, kc in ks:
        want = ref_native.jpeg_read_coeffs(data, ky, kc, ybh, ybw, cbh, cbw)
        got = port_native.jpeg_read_coeffs(data, ky, kc, ybh, ybw, cbh, cbw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def _assert_decode_equal(data, denoms=(1, 2, 4, 8)):
    for denom in denoms:
        assert port_native.jpeg_scaled_dims(data, denom)[:2] == \
            ref_native.jpeg_scaled_dims(data, denom)[:2]
        for fancy in (True, False):
            for gray in (False, True):
                want = ref_native.decode_jpeg(data, denom=denom, fancy_upsampling=fancy, gray=gray)
                got = port_native.decode_jpeg(data, denom, fancy, gray)
                assert want is not None
                assert got.shape == want.shape, (denom, fancy, gray)
                np.testing.assert_array_equal(got, want, err_msg=f"{denom} {fancy} {gray}")


# -- the int16 coefficient read ----------------------------------------------------------------
@pytest.mark.parametrize("sampling", ["420", "422", "444"])
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("rst", [0, 3])
def test_int16_read_bit_equal(sampling, progressive, rst):
    img = _base(1)
    for hw in SIZES:
        _assert_read_equal(_encode(_sized(img, hw), sampling, progressive=progressive, rst=rst))


@pytest.mark.parametrize("progressive", [False, True])
def test_int16_read_keeps_large_coefficients(progressive):
    """Values past int8 (quality 100 noise) stay exact: the int8 wire's
    saturation is gone."""
    rng = np.random.default_rng(3)
    noise = (rng.random((40, 56, 3)) > 0.5).astype(np.uint8) * 255
    data = _encode(noise, "444", quality=100, progressive=progressive)
    _assert_read_equal(data)
    info = ref_native.jpeg_coef_info(data)
    y, _, _ = port_native.jpeg_read_coeffs(data, 8, 8, *info[2:6])
    assert np.abs(y[..., 1:]).max() > 127


def test_int16_read_corpus_and_grayscale():
    for f in _corpus_files(4):
        _assert_read_equal(open(f, "rb").read())
    gray = cv2.cvtColor(_base(), cv2.COLOR_BGR2GRAY)
    for prog in (0, 1):
        _assert_read_equal(cv2.imencode(".jpg", gray, [cv2.IMWRITE_JPEG_PROGRESSIVE, prog])[1]
                           .tobytes())


def test_int16_read_batch_into_canvas():
    """The batch entry writes each sample at the top left of its canvas slot
    and leaves the rest of the slot as it was (zero)."""
    datas = [open(f, "rb").read() for f in _corpus_files(3)]
    infos = ref_native.jpeg_coef_info_batch([np.frombuffer(d, np.uint8) for d in datas])
    blocks = infos[:, 2:6]
    y = np.zeros((3, blocks[:, 0].max() + 2, blocks[:, 1].max() + 3, 64), np.int16)
    c = np.zeros((3, 2, blocks[:, 2].max() + 1, blocks[:, 3].max() + 1, 64), np.int16)
    q = port_native.coef_full_batch(port_native.shared_pool(2), datas, 8, 8, blocks, y, c)
    for i, d in enumerate(datas):
        ybh, ybw, cbh, cbw = blocks[i]
        wy, wc, wq = ref_native.jpeg_read_coeffs(d, 8, 8, ybh, ybw, cbh, cbw)
        np.testing.assert_array_equal(y[i, :ybh, :ybw], wy)
        np.testing.assert_array_equal(c[i, :, :cbh, :cbw], wc)
        np.testing.assert_array_equal(q[i], wq)
        assert not y[i, ybh:].any() and not y[i, :, ybw:].any()


# -- the pixel decode --------------------------------------------------------------------------
@pytest.mark.parametrize("sampling", ["420", "422", "444", "440"])
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("rst", [0, 2])
def test_pixel_decode_bit_equal(sampling, progressive, rst):
    """Odd sizes (1x1, 7x9, 17x33, and sides not a multiple of 16) at every
    scale, fancy upsampling on and off, RGB and grayscale output."""
    img = _base(2)
    for hw in SIZES:
        _assert_decode_equal(_encode(_sized(img, hw), sampling, progressive=progressive, rst=rst))


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_pixel_decode_corpus_full_size(k):
    _assert_decode_equal(open(_corpus_files()[k * 8], "rb").read())


def test_pixel_decode_grayscale_streams():
    gray = cv2.cvtColor(_base(), cv2.COLOR_BGR2GRAY)
    for prog in (0, 1):
        for hw in ((37, 50), (375, 500)):
            _assert_decode_equal(cv2.imencode(".jpg", cv2.resize(gray, hw[::-1]),
                                              [cv2.IMWRITE_JPEG_PROGRESSIVE, prog])[1].tobytes())


def _with_distinct_cr_table(data):
    """A copy whose Cr component reads a third quantisation table (the
    chroma table doubled), so Cb and Cr tables differ."""
    b = bytearray(data)
    i, t1 = 2, None
    while True:
        m, n = b[i + 1], (b[i + 2] << 8) | b[i + 3]
        if m == 0xDB:
            seg, pos = bytes(b[i + 4:i + 2 + n]), 0
            while pos < len(seg):
                if seg[pos] & 15 == 1:
                    t1 = seg[pos + 1:pos + 65]
                pos += 65 if seg[pos] >> 4 == 0 else 129
        if m in (0xC0, 0xC2):
            new = bytes([2]) + bytes(min(255, 2 * v) for v in t1)
            dqt = b"\xff\xdb" + (len(new) + 2).to_bytes(2, "big") + new
            b[i:i] = dqt
            i += len(dqt)
            b[i + 4 + 6 + 3 * 2 + 2] = 2  # Cr's Tq in the SOF
            return bytes(b)
        i += 2 + n


@pytest.mark.parametrize("progressive", [False, True])
def test_pixel_decode_distinct_chroma_tables(progressive):
    data = _with_distinct_cr_table(_encode(_sized(_base(3), (45, 61)), "420",
                                           progressive=progressive))
    _assert_decode_equal(data)


def test_pixel_decode_extreme_coefficients():
    """Black/white noise at quality 100 drives the IDCT out of range, through
    libjpeg's wrapping range limit."""
    rng = np.random.default_rng(1)
    for q in (100, 60):
        for s in ("420", "444"):
            noise = (rng.random((61, 83, 3)) > 0.5).astype(np.uint8) * 255
            _assert_decode_equal(_encode(noise, s, quality=q))


@pytest.mark.parametrize("rst", [0, 2])
@pytest.mark.parametrize("frac", [0.3, 0.6, 0.95])
def test_truncated_baseline_stream_zero_fills(rst, frac):
    """A stream cut short decodes as libjpeg's does: the MCU where the data
    ends finishes on zero bits, the rest stays zero (grey)."""
    data = _encode(_base(4), "420", rst=rst)
    _assert_decode_equal(data[:int(len(data) * frac)])


@pytest.mark.parametrize("frac", [0.3, 0.6, 0.95])
def test_truncated_progressive_stream_bounded(frac):
    """Coefficients and pixels bit-equal: libjpeg block-smooths the
    coefficients an incomplete progressive stream left unknown, and so does
    the port, at every scale and in both upsampling modes."""
    data = _encode(_base(4), "420", progressive=True)
    cut = data[:int(len(data) * frac)]
    _assert_read_equal(cut, ks=[(8, 8)])
    _assert_decode_equal(cut)


# -- a non-interleaved (one scan per component) baseline stream --------------------------------
_ZZ = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
                41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22,
                15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55,
                62, 63])


def _segments(data):
    i, out = 2, []
    while True:
        m, n = data[i + 1], (data[i + 2] << 8) | data[i + 3]
        out.append((m, data[i:i + 2 + n]))
        if m == 0xDA:
            return out
        i += 2 + n


def _huff_codes(seg):
    """{(class, id): {symbol: (code, length)}} of a DHT segment."""
    tables, pos, body = {}, 0, seg[4:]
    while pos < len(body):
        tc, th = body[pos] >> 4, body[pos] & 15
        counts = body[pos + 1:pos + 17]
        vals = body[pos + 17:pos + 17 + sum(counts)]
        code, k, codes = 0, 0, {}
        for ln in range(1, 17):
            for _ in range(counts[ln - 1]):
                codes[vals[k]] = (code, ln)
                code += 1
                k += 1
            code <<= 1
        tables[(tc, th)] = codes
        pos += 17 + sum(counts)
    return tables


class _Bits:
    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, v, n):
        self.acc, self.n = (self.acc << n) | (v & ((1 << n) - 1)), self.n + n
        while self.n >= 8:
            b = (self.acc >> (self.n - 8)) & 255
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
            self.n -= 8

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _mag(v):
    s = int(abs(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _non_interleaved(data):
    """The same coefficients as ``data`` (a baseline 3-component stream),
    re-entropy-coded as three single-component scans with its own tables."""
    segs = _segments(data)
    tables = {}
    for m, s in segs:
        if m == 0xC4:
            tables.update(_huff_codes(s))
    sof = next(s for m, s in segs if m == 0xC0)
    h, w = (sof[5] << 8) | sof[6], (sof[7] << 8) | sof[8]
    comps = [(sof[10 + 3 * i], sof[11 + 3 * i] >> 4, sof[11 + 3 * i] & 15) for i in range(3)]
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    info = ref_native.jpeg_coef_info(data)
    y, c, _ = ref_native.jpeg_read_coeffs(data, 8, 8, *info[2:6])
    sos = next(s for m, s in segs if m == 0xDA)
    sel = {sos[5 + 2 * i]: sos[6 + 2 * i] for i in range(3)}
    out = bytearray(b"\xff\xd8")
    for m, s in segs[:-1]:
        out += s
    for ci, (cid, hs, vs) in enumerate(comps):
        plane = y if ci == 0 else c[ci - 1]
        bh, bw = -(-h * vs // (8 * vmax)), -(-w * hs // (8 * hmax))
        dct, act = tables[(0, sel[cid] >> 4)], tables[(1, sel[cid] & 15)]
        bits, pred = _Bits(), 0
        for r in range(bh):
            for col in range(bw):
                blk = plane[r, col][_ZZ]
                s_, v = _mag(int(blk[0]) - pred)
                pred = int(blk[0])
                bits.put(*dct[s_])
                bits.put(v, s_)
                run = 0
                for k in range(1, 64):
                    if blk[k] == 0:
                        run += 1
                        continue
                    while run > 15:
                        bits.put(*act[0xF0])
                        run -= 16
                    s_, v = _mag(int(blk[k]))
                    bits.put(*act[(run << 4) | s_])
                    bits.put(v, s_)
                    run = 0
                if run:
                    bits.put(*act[0x00])
        out += b"\xff\xda\x00\x08\x01" + bytes([cid, sel[cid]]) + b"\x00\x3f\x00" + bits.flush()
    return bytes(out + b"\xff\xd9")


@pytest.mark.parametrize("sampling", ["420", "444"])
def test_pixel_decode_non_interleaved_baseline(sampling):
    data = _non_interleaved(_encode(_sized(_base(5), (45, 61)), sampling))
    assert data.count(b"\xff\xda") == 3
    _assert_read_equal(data, ks=[(8, 8)])
    _assert_decode_equal(data)


# -- streams the decoder does not take, the batch entry, the build ------------------------------
def test_unsupported_streams_raise_not_implemented():
    """The forms still declined: arithmetic coding (SOF9), 12-bit precision
    and lossless coding (SOF3), each patched into a corpus stream's frame."""
    data = _encode(_base())
    sof = data.index(b"\xff\xc0")
    sof9 = data[:sof + 1] + b"\xc9" + data[sof + 2:]
    twelve = data[:sof + 4] + b"\x0c" + data[sof + 5:]
    sof3 = data[:sof + 1] + b"\xc3" + data[sof + 2:]
    for bad, item in ((sof9, "1a"), (twelve, "1b"), (sof3, "1b")):
        with pytest.raises(NotImplementedError, match=rf"Queue 1 item {item}|item {item}\)"):
            port_native.decode_jpeg(bad)
    with pytest.raises(ValueError, match="corrupt"):
        port_native.decode_jpeg(_encode(_base())[:60])


def test_decode_batch_into_strided_canvas():
    datas = [open(f, "rb").read() for f in _corpus_files(4)]
    dims = [ref_native.jpeg_scaled_dims(d, 2) for d in datas]
    canvas = np.full((4, 256, 320, 3), 7, np.uint8)
    port_native.decode_jpeg_batch(port_native.shared_pool(3), datas, list(canvas), [2] * 4,
                                  [h for h, _, _ in dims], [w for _, w, _ in dims])
    for i, d in enumerate(datas):
        h, w, _ = dims[i]
        np.testing.assert_array_equal(canvas[i, :h, :w], ref_native.decode_jpeg(d, denom=2))
        assert (canvas[i, h:] == 7).all() and (canvas[i, :, w:] == 7).all()


def test_build_compiles_only_port_sources():
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(build.__file__)))
    for path in (build.HOST_SOURCES + build.HOST_CONTRACT_SOURCES + build.HOST_HEADERS
                 + build.KERNEL_SOURCES):
        assert os.path.commonpath([pkg, os.path.abspath(path)]) == pkg, path
        assert os.path.exists(path), path


def test_stamp_changes_with_the_source_list():
    cmd = ["g++", "-O3"]
    base = build.stamp(build.HOST_SOURCES, cmd, [])
    assert build.stamp(build.HOST_SOURCES, cmd, []) == base
    assert build.stamp(build.HOST_SOURCES[:-1], cmd, []) != base
    assert build.stamp(build.HOST_SOURCES + build.HOST_HEADERS, cmd, []) != base
    assert build.stamp(list(reversed(build.HOST_SOURCES)), cmd, []) != base
    assert build.stamp(build.HOST_SOURCES, cmd + ["-g"], []) != base


def test_progressive_scan_without_its_table_fails():
    """A progressive scan that names a Huffman table no DHT defined: libjpeg
    fails (JERR_NO_HUFF_TABLE), and so does the port, reading no table
    memory that was never written."""
    data = _encode(_base(4), "420", progressive=True)
    dht = data.index(b"\xff\xc4")
    assert data[dht + 4] == 0x00  # the first table: DC, slot 0
    bad = data[:dht + 4] + b"\x03" + data[dht + 5:]  # now DC slot 3
    assert ref_native.decode_jpeg(bad) is None
    with pytest.raises(ValueError, match="corrupt"):
        port_native.decode_jpeg(bad)
