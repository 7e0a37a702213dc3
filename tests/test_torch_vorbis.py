"""Ogg Vorbis in dali_tpu_torch (ROADMAP.md Queue 1 item 4b): the native Ogg
reader and Vorbis decoder (``csrc/host/ogg.cc``, ``vorbis_decode.cc``)
against dali_tpu's FFmpeg route (``dali_tpu.native.audio_decode``: FFmpeg
5.1's ogg demuxer and vorbis decoder) on the CPU.

The fixtures are committed (``dali_tpu_torch/testdata/audio_codecs``,
written by ``testdata/make_audio_codecs.py`` through libvorbis, pages of
0.1 s): mono at 16 and 48 kHz, stereo at 44.1 kHz at low, middle and high
quality (different codebooks, floors and residues), 5.1, and a stream cut
inside a page; the tests cut and damage the card's Vorbis clips further.

Tolerance: the sample count, channel count (in FFmpeg's channel order) and
rate are equal; the float32 PCM meets the "full accuracy" bounds of
ISO/IEC 11172-4 against the reference's (RMS <= 8.8e-6, largest <= 6.1e-5
of full scale; worst seen ~1.3e-7 and ~2e-8). INT16 outputs are within one
step. With the decodes inside it, the ASR mel graph agrees within 5e-3 dB.
"""

import json
import os
import shutil
import struct

import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch
from dali_tpu import native as ref_native
from dali_tpu_torch import native as port_native
from dali_tpu_torch.backend import audio as port_audio
from dali_tpu_torch.tools.bench_audio_codecs import CODECS, MAX_BOUND, RMS_BOUND

pytestmark = pytest.mark.skipif(not ref_native.has_audio(),
                                reason="dali_tpu's native library was built without FFmpeg")

FIXTURES = sorted(f for f in os.listdir(CODECS) if f.startswith("vorbis_"))
REF = np.load(os.path.join(CODECS, "reference.npz"))
LONG = os.path.join("corpus_vorbis", "clips", "c0000.ogg")  # 48 kHz mono, ~1.6 s


def _read(name):
    with open(os.path.join(CODECS, name), "rb") as f:
        return f.read()


def _assert_within(got, want, what):
    (x, rate), (w, wrate) = got, want
    assert x.dtype == np.float32 and x.shape == w.shape and rate == wrate, (what, x.shape, w.shape)
    d = x.astype(np.float64) - w
    mx, rms = float(np.abs(d).max()), float(np.sqrt(np.mean(d * d)))
    assert mx <= MAX_BOUND and rms <= RMS_BOUND, f"{what}: max {mx:.3e}, rms {rms:.3e}"
    return mx, rms


def _same_outcome(data, what):
    want = ref_native.audio_decode(data)
    try:
        got = port_audio.decode_audio(data)
    except ValueError:
        assert want is None, f"{what}: the port raises ValueError, the reference decodes"
        return
    assert want is not None, f"{what}: the reference fails, the port decodes"
    _assert_within(got, want, what)


def _pages(data):
    """(offset, length) of each Ogg page."""
    out, pos = [], 0
    while pos + 27 <= len(data) and data[pos:pos + 4] == b"OggS":
        nseg = data[pos + 26]
        n = 27 + nseg + sum(data[pos + 27:pos + 27 + nseg])
        out.append((pos, n))
        pos += n
    return out


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_matches_dali_tpu(name):
    data = _read(name)
    want = ref_native.audio_decode(data)
    key = name[:-4]
    np.testing.assert_array_equal(REF[key], want[0])
    assert float(REF[key + ":rate"]) == want[1]
    mx, rms = _assert_within(port_audio.decode_audio(data), want, name)
    print(f"{name}: {want[0].shape} at {want[1]:.0f} Hz, max {mx:.2e}, rms {rms:.2e}")


@pytest.mark.parametrize("clip", range(8))
def test_card_clips_match_dali_tpu(clip):
    """The card's Vorbis batch (phase 37) clip by clip."""
    data = _read(os.path.join("corpus_vorbis", "clips", f"c{clip:04d}.ogg"))
    _assert_within(port_audio.decode_audio(data), ref_native.audio_decode(data), f"clip {clip}")


@pytest.mark.parametrize("where", ["header_pages", "first_audio_page", "page_boundary",
                                   "mid_page", "last_page_header", "last_page_body"])
def test_cut_stream_follows_the_reference(where):
    """A stream cut anywhere: a page cut short is dropped with the packet
    it leaves open; without the end-of-stream page nothing is trimmed; cut
    before any audio page the stream fails in both."""
    data = _read(LONG)
    pages = _pages(data)
    at = {"header_pages": pages[1][0] + 10, "first_audio_page": pages[2][0] + 100,
          "page_boundary": pages[len(pages) // 2][0],
          "mid_page": pages[len(pages) // 2][0] + pages[len(pages) // 2][1] // 2,
          "last_page_header": pages[-1][0] + 20, "last_page_body": len(data) - 50}[where]
    _same_outcome(data[:at], where)


@pytest.mark.parametrize("damage", ["body_byte", "crc_field", "capture_pattern", "junk_between",
                                    "junk_after_the_end"])
def test_damaged_pages_follow_the_reference(damage):
    """A page that fails its CRC is skipped and the reader resynchronises on
    the next capture pattern, as FFmpeg's demuxer does."""
    data = bytearray(_read(LONG))
    pages = _pages(bytes(data))
    p, n = pages[len(pages) // 2]
    if damage == "body_byte":
        data[p + n - 30] ^= 0x55
    elif damage == "crc_field":
        data[p + 22] ^= 1
    elif damage == "capture_pattern":
        data[p + 1] = ord("x")
    elif damage == "junk_between":
        data[p:p] = b"\x00garbage\x00"
    else:
        data += b"OggS" + bytes(40)
    _same_outcome(bytes(data), damage)


@pytest.mark.parametrize("second", ["another_clip", "another_rate", "the_last_page_again"])
def test_chained_files_raise(second):
    """Pinned departure (ROADMAP.md Queue 3): after the first logical
    stream's last page, a page that begins another stream or continues the
    first. FFmpeg decodes a chained file's streams one after another (and a
    repeated last page again); the port reads the first logical stream
    only, so it raises NotImplementedError naming item 4c rather than
    return part of the file."""
    data = _read(LONG)
    tail = {"another_clip": _read(os.path.join("corpus_vorbis", "clips", "c0001.ogg")),
            "another_rate": _read("vorbis_mono_16k.ogg"),
            "the_last_page_again": data[_pages(data)[-1][0]:]}[second]
    whole = ref_native.audio_decode(data + tail)
    assert whole is not None and len(whole[0]) > len(ref_native.audio_decode(data)[0])
    with pytest.raises(NotImplementedError, match=r"chained Ogg file.*item 4c"):
        port_audio.decode_audio(data + tail)


def _split_pages(data):
    """The stream with pages cut inside a packet: after the first lacing
    value of 255 of a page, where no packet ends before it or the page is a
    header page (granule 0), giving a page holding that packet's start
    (granule -1 without a packet end, else the page's) and the rest marked
    continued; sequence numbers and CRCs rewritten. FFmpeg's muxer never
    splits a packet across pages."""
    out, seq, split = [], 0, 0
    for pos, n in _pages(data):
        page = data[pos:pos + n]
        nseg = page[26]
        lacing = page[27:27 + nseg]
        body = page[27 + nseg:]
        flags, granule, serial = page[5], struct.unpack("<q", page[6:14])[0], page[14:18]
        parts = [(lacing, body, flags, granule)]
        cut = next((i for i in range(nseg - 1) if lacing[i] == 255), None)
        if cut is not None and not flags & 1:
            ends = any(v < 255 for v in lacing[:cut])
            if not ends or granule == 0:
                at = sum(lacing[:cut + 1])
                parts = [(lacing[:cut + 1], body[:at], flags & ~4, granule if ends else -1),
                         (lacing[cut + 1:], body[at:], (flags & ~2) | 1, granule)]
                split += 1
        for lac, bod, fl, gr in parts:
            head = bytearray(b"OggS\x00" + bytes([fl]) + struct.pack("<q", gr) + serial
                             + struct.pack("<II", seq, 0) + bytes([len(lac)]) + lac)
            out.append(_with_crc(bytes(head) + bod))
            seq += 1
    assert split > 0
    return b"".join(out)


def _with_crc(page):
    page = bytearray(page)
    page[22:26] = bytes(4)
    crc = 0
    for b in page:
        crc ^= b << 24
        for _ in range(8):
            crc = (crc << 1) ^ (0x04C11DB7 if crc & 0x80000000 else 0)
        crc &= 0xFFFFFFFF
    page[22:26] = struct.pack("<I", crc)
    return bytes(page)


@pytest.mark.parametrize("name", ["vorbis_stereo_44k_q_high.ogg", "vorbis_surround_51_22k.ogg",
                                  "vorbis_mono_16k.ogg"])
def test_packets_across_pages(name):
    """Packets continued from one page onto the next (lacing value 255 at a
    page's end, the continued flag on the next) join as FFmpeg joins them:
    the same output as the stream laid out whole."""
    data = _read(name)
    split = _split_pages(data)
    want = ref_native.audio_decode(data)
    _assert_within(ref_native.audio_decode(split), want, "the reference, re-paged")
    _assert_within(port_audio.decode_audio(split), want, name)


@pytest.mark.parametrize("first,second", [("vorbis_mono_16k.ogg", "vorbis_stereo_44k_q_mid.ogg"),
                                          ("vorbis_surround_51_22k.ogg", "vorbis_mono_48k.ogg")])
def test_multiplexed_streams_read_the_first(first, second):
    """Two logical streams interleaved page by page (both first pages
    leading): FFmpeg decodes the first, and so does the port; the second's
    pages after the first's end do not make it a chained file."""
    a, b = _read(first), _read(second)
    pa, pb = _pages(a), _pages(b)
    pages = [a[pa[0][0]:pa[0][0] + pa[0][1]], b[pb[0][0]:pb[0][0] + pb[0][1]]]
    rest_a = [a[p:p + n] for p, n in pa[1:]]
    rest_b = [b[p:p + n] for p, n in pb[1:]]
    for i in range(max(len(rest_a), len(rest_b))):
        pages += rest_a[i:i + 1] + rest_b[i:i + 1]
    data = b"".join(pages)
    want = ref_native.audio_decode(data)
    _assert_within(want, ref_native.audio_decode(a), "the reference reads the first stream")
    _assert_within(port_audio.decode_audio(data), want, f"{first} with {second}")


def test_pool_and_inline_decodes_are_equal():
    datas = [_read(n) for n in FIXTURES]
    inline = port_native.decode_audio_codec_batch(None, datas, ["vorbis"] * len(datas))
    pooled = port_native.decode_audio_codec_batch(port_native.shared_pool(4), datas,
                                                  ["vorbis"] * len(datas))
    for a, b in zip(inline, pooled):
        np.testing.assert_array_equal(a[0], b[0])


# ------------------------------------------------------------------ codebook headers

class _BitsIn:
    """LSB-first reader over a whole packet, as Vorbis packs its fields."""

    def __init__(self, data):
        self.v, self.pos = int.from_bytes(data, "little"), 0

    def get(self, k):
        x = (self.v >> self.pos) & ((1 << k) - 1)
        self.pos += k
        return x


class _BitsOut:
    def __init__(self):
        self.v, self.n = 0, 0

    def put(self, x, k):
        self.v |= (x & ((1 << k) - 1)) << self.n
        self.n += k


def _skip_codebook(b):
    """Read past one codebook of a setup header (Vorbis I section 3.2.1)."""
    assert b.get(24) == 0x564342
    dims, entries = b.get(16), b.get(24)
    if not b.get(1):
        sparse = b.get(1)
        for _ in range(entries):
            if not sparse or b.get(1):
                b.get(5)
    else:
        b.get(5)
        i = 0
        while i < entries:
            i += b.get((entries - i).bit_length())
    lookup = b.get(4)
    assert lookup in (0, 1)
    if lookup:
        b.get(64)
        value_bits = b.get(4) + 1
        b.get(1)
        r = int(round(entries ** (1 / dims)))
        while r ** dims > entries:
            r -= 1
        while (r + 1) ** dims <= entries:
            r += 1
        b.get(r * value_bits)


def _codebook(dims, entries, lengths=(), ordered=None, sparse=False, lookup=0, values=(),
              value_bits=4):
    """A codebook's bits: unordered ``lengths`` (0 for an unused entry of a
    ``sparse`` list), or ``ordered`` = (first length, run of each length);
    lookup 1 or 2 with minimum and delta 0 and the multiplicands
    ``values``. Lengths and values may be fewer than the book needs."""
    w = _BitsOut()
    w.put(0x564342, 24)
    w.put(dims, 16)
    w.put(entries, 24)
    if ordered:
        w.put(1, 1)
        w.put(ordered[0] - 1, 5)
        done = 0
        for run in ordered[1]:
            w.put(run, (entries - done).bit_length())
            done += run
    else:
        w.put(0, 1)
        w.put(int(sparse), 1)
        for n in lengths:
            if sparse:
                w.put(int(n > 0), 1)
            if n:
                w.put(n - 1, 5)
    w.put(lookup, 4)
    if lookup:
        w.put(0, 64)
        w.put(value_bits - 1, 4)
        w.put(0, 1)
        for x in values:
            w.put(x, value_bits)
    return w


def _with_codebook(data, book):
    """The stream with ``book`` after the setup header's last codebook (no
    floor or residue uses it), the header packets laid on one page and the
    later pages renumbered."""
    pages = _pages(data)
    heads = [i for i, (p, _) in enumerate(pages) if i and data[p + 6:p + 14] == bytes(8)]
    packets, cur = [], b""
    for i in heads:
        p, n = pages[i]
        nseg = data[p + 26]
        body, at = data[p + 27 + nseg:p + n], 0
        for v in data[p + 27:p + 27 + nseg]:
            cur, at = cur + body[at:at + v], at + v
            if v < 255:
                packets, cur = packets + [cur], b""
    comment, setup = packets
    b = _BitsIn(setup)
    b.get(56)
    count = b.get(8) + 1
    for _ in range(count):
        _skip_codebook(b)
    low, high = b.v & ((1 << b.pos) - 1), b.v >> b.pos
    v = low | (book.v << b.pos) | (high << (b.pos + book.n))
    v = (v & ~(0xFF << 56)) | (count << 56)
    setup = v.to_bytes((8 * len(setup) + book.n + 7) // 8, "little")
    lacing = b"".join(bytes([255] * (len(x) // 255) + [len(x) % 255]) for x in (comment, setup))
    p0 = pages[1][0]
    out = [data[:p0], _with_crc(b"OggS\x00\x00" + bytes(8) + data[p0 + 14:p0 + 18]
                                + struct.pack("<II", 1, 0) + bytes([len(lacing)]) + lacing
                                + comment + setup)]
    for p, n in pages[heads[-1] + 1:]:
        page = bytearray(data[p:p + n])
        page[18:22] = struct.pack("<I", struct.unpack("<I", page[18:22])[0] + 1 - len(heads))
        out.append(_with_crc(bytes(page)))
    return b"".join(out)


_BOOKS = {
    "one_codeword": lambda: _codebook(1, 1, [1]),
    "lengths_1_2_2": lambda: _codebook(1, 3, [1, 2, 2]),
    "16_dimensions": lambda: _codebook(16, 2, [1, 1], lookup=1, values=[1]),
    "lookup_1": lambda: _codebook(2, 4, [2, 2, 2, 2], lookup=1, values=[3, 5]),
    "a_free_leaf": lambda: _codebook(1, 2, [1, 2]),
    "25_bit_codewords": lambda: _codebook(1, 2, [25, 25]),
    "0_dimensions": lambda: _codebook(0, 2, [1, 1]),
    "17_dimensions": lambda: _codebook(17, 2, [1, 1]),
    "lookup_2": lambda: _codebook(3, 2, [1, 1], lookup=2, values=range(6)),
    "lookup_3": lambda: _codebook(1, 2, [1, 1], lookup=3),
    "ordered_34816": lambda: _codebook(1, 34816, ordered=(16, [34816])),
    "ordered_2^24-1": lambda: _codebook(16, (1 << 24) - 1, ordered=(24, [(1 << 24) - 1])),
    "sparse_2^24-1_cut": lambda: _codebook(1, (1 << 24) - 1, sparse=True),
    "sparse_one_used": lambda: _codebook(1, 3, [0, 1, 0], sparse=True),
    "lookup_1_cut": lambda: _codebook(1, 32768, ordered=(15, [32768]), lookup=1,
                                      value_bits=16),
}


@pytest.mark.parametrize("book", sorted(_BOOKS))
def test_codebook_headers_follow_the_reference(book):
    """A codebook of each form after the setup header's last: the port
    loads what FFmpeg 5.1 loads and refuses (ValueError) what it refuses: 0
    or more than 16 dimensions, lookup types 2 and 3, trees with a free leaf,
    books of more codewords than its VLC tables index, and length lists or
    lookup tables that reach past the packet's end (refused before anything
    is sized from them: a few bytes claim 2^24 entries of 16 dimensions)."""
    _same_outcome(_with_codebook(_read("vorbis_mono_16k.ogg"), _BOOKS[book]()), book)


@pytest.mark.parametrize("seed", range(2))
def test_mutated_codebook_headers_follow_the_reference(seed):
    """The dimensions and entry count of a setup header's first codebook
    overwritten (the page CRC rewritten): the port decodes where the
    reference decodes, within the bounds, and raises ValueError where it
    fails, sizing nothing from the fields before it has read past them."""
    rng = np.random.default_rng(seed)
    for _ in range(12):
        data = bytearray(_read(FIXTURES[rng.integers(len(FIXTURES))]))
        at = data.index(b"\x05vorbis") + 11
        page = max(p for p, _ in _pages(bytes(data)) if p < at)
        n = dict(_pages(bytes(data)))[page]
        dims = int(rng.choice([0, 1, 2, 16, 17, int(rng.integers(1 << 16))]))
        entries = int(rng.choice([1, int(rng.integers(1, 1 << 12)), int(rng.integers(1 << 24))]))
        data[at:at + 5] = dims.to_bytes(2, "little") + entries.to_bytes(3, "little")
        data[page:page + n] = _with_crc(bytes(data[page:page + n]))
        _same_outcome(bytes(data), f"dims {dims}, entries {entries}")


# ------------------------------------------------------------------ item 4c

def _ogg_page(packets, serial=7, seq=0, flags=2, granule=0):
    """One Ogg page holding whole ``packets``, its CRC set."""
    lacing = b""
    for p in packets:
        lacing += b"\xff" * (len(p) // 255) + bytes([len(p) % 255])
    head = (b"OggS\x00" + bytes([flags]) + struct.pack("<qIII", granule, serial, seq, 0)
            + bytes([len(lacing)]) + lacing)
    return _with_crc(head + b"".join(packets))


class _Bits:
    """LSB-first bit writer (Vorbis packing)."""

    def __init__(self):
        self.v, self.n = 0, 0

    def put(self, value, bits):
        self.v |= (value & ((1 << bits) - 1)) << self.n
        self.n += bits
        return self

    def bytes(self):
        return self.v.to_bytes((self.n + 7) // 8, "little")


def _floor0_stream():
    """Identification, comment and a setup header whose floor is of type 0
    (one two-entry codebook, one time-domain placeholder): libvorbis never
    writes floor 0."""
    ident = (b"\x01vorbis" + struct.pack("<IBIiii", 0, 1, 16000, 0, 0, 0) + bytes([0x86])
             + b"\x01")
    comment = b"\x03vorbis" + struct.pack("<I", 0) + struct.pack("<I", 0) + b"\x01"
    b = _Bits().put(0, 8)  # one codebook
    b.put(0x564342, 24).put(1, 16).put(2, 24).put(0, 1).put(0, 1).put(0, 5).put(0, 5).put(0, 4)
    b.put(0, 6).put(0, 16)  # one time-domain value, 0
    b.put(0, 6).put(0, 16)  # one floor, type 0
    setup = b"\x05vorbis" + b.bytes()
    return _ogg_page([ident]) + _ogg_page([comment, setup], seq=1, flags=0)


def test_item_4c_raises():
    """Ogg Opus and Ogg FLAC, which the reference decodes, and Speex raise
    NotImplementedError naming item 4c; so does a Vorbis floor 0. An Ogg
    stream whose first packet does not read, and a first packet of no codec,
    raise ValueError as the reference fails."""
    for name in ("fail_ogg_opus.ogg", "fail_ogg_flac.ogg"):
        data = _read(name)
        assert ref_native.audio_decode(data) is not None
        with pytest.raises(NotImplementedError, match=r"item 4c"):
            port_audio.decode_audio(data)
    with pytest.raises(NotImplementedError, match=r"Speex.*item 4c"):
        port_audio.decode_audio(_ogg_page([b"Speex   1.2" + bytes(69)]))
    with pytest.raises(NotImplementedError, match=r"Vorbis floor 0.*item 4c"):
        port_audio.decode_audio(_floor0_stream())
    for blob in (b"OggS" + bytes(60), _ogg_page([b"\x01unknown" + bytes(40)])):
        assert ref_native.audio_decode(blob) is None
        with pytest.raises(ValueError, match="malformed Ogg Vorbis"):
            port_audio.decode_audio(blob)


# ------------------------------------------------------------------ through the pipelines

PIPE_FILES = ["vorbis_mono_16k.ogg", "vorbis_stereo_44k_q_mid.ogg", "vorbis_surround_51_22k.ogg",
              "vorbis_mono_48k.ogg", "vorbis_stereo_44k_q_low.ogg", "vorbis_truncated.ogg"]


@pytest.fixture(scope="module")
def ogg_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("ogg_files")
    os.makedirs(root / "a")
    for name in PIPE_FILES:
        shutil.copy(os.path.join(CODECS, name), root / "a" / name)
    return str(root)


def _run(pkg, graph, batch, iters=1):
    kw = {"device": "cpu"} if pkg is dali_tpu_torch else {"debug": True}

    @pkg.pipeline_def(batch_size=batch, num_threads=2, seed=7, **kw)
    def p():
        return graph(pkg)

    pipe = p()
    pipe.build()
    try:
        out = []
        for _ in range(iters):
            outs = pipe.run()
            out.append([[np.asarray((o.as_cpu() if hasattr(o, "as_cpu") else o).at(i))
                         for i in range(batch)] for o in outs])
        return out
    finally:
        (pipe.shutdown if pkg is dali_tpu_torch else pipe._executor.shutdown)()


@pytest.mark.parametrize("downmix,dtype,rate", [(False, "FLOAT", 0.0), (True, "FLOAT", 0.0),
                                               (True, "INT16", 0.0), (False, "INT16", 0.0),
                                               (True, "FLOAT", 16000.0)])
def test_decoders_audio_matches_dali_tpu(ogg_dir, downmix, dtype, rate):
    """decoders.audio over a ragged batch of Vorbis forms (mono to 5.1) in
    both packages: float within the bounds (after scipy's resample too),
    INT16 within one step (the fraction that differs printed)."""
    def graph(pkg):
        enc, _ = pkg.fn.readers.file(file_root=ogg_dir, file_filters=["*.ogg"], name="R")
        return pkg.fn.decoders.audio(enc, downmix=downmix, dtype=getattr(pkg.types, dtype),
                                     sample_rate=rate)

    (ga, gr), = _run(dali_tpu_torch, graph, len(PIPE_FILES))
    (wa, wr), = _run(dali_tpu, graph, len(PIPE_FILES))
    differ = total = 0
    for g, w, r1, r2 in zip(ga, wa, gr, wr):
        assert g.dtype == w.dtype and g.shape == w.shape and r1 == r2
        if dtype == "INT16":
            d = np.abs(g.astype(np.int32) - w)
            assert d.max() <= 1
            differ += int(np.count_nonzero(d))
            total += d.size
        else:
            _assert_within((g, 0), (w, 0), "decoders.audio")
    if dtype == "INT16":
        print(f"INT16: {differ} of {total} samples ({differ / total:.2e}) one step apart")


def test_asr_mel_graph_with_the_decode(ogg_dir):
    """readers.file -> decoders.audio (downmix) -> the ASR mel graph over a
    ragged batch of Vorbis forms in both packages: dB within 5e-3 dB."""
    def graph(pkg):
        fn = pkg.fn
        enc, _ = fn.readers.file(file_root=ogg_dir, file_filters=["*.ogg"], name="R",
                                 random_shuffle=True, seed=3)
        audio, _ = fn.decoders.audio(enc, downmix=True, dtype=pkg.types.FLOAT)
        audio = fn.preemphasis_filter(audio, preemph_coeff=0.97)
        spec = fn.spectrogram(audio, nfft=512, window_length=320, window_step=160)
        mel = fn.mel_filter_bank(spec, sample_rate=16000.0, nfilter=80)
        return fn.to_decibels(mel, multiplier=10.0, cutoff_db=-80.0),

    got = _run(dali_tpu_torch, graph, 3, iters=2)
    want = _run(dali_tpu, graph, 3, iters=2)
    worst = 0.0
    for (g,), (w,) in zip(got, want):
        for a, b in zip(g, w):
            assert a.shape == b.shape
            worst = max(worst, float(np.abs(a - b).max()))
    print(f"asr mel graph with the Vorbis decode: dB max diff {worst:.2e}")
    assert worst <= 5e-3


def test_nemo_asr_reads_ogg(tmp_path):
    os.makedirs(tmp_path / "clips")
    with open(tmp_path / "manifest.json", "w") as f:
        for i, name in enumerate(PIPE_FILES[:4]):
            shutil.copy(os.path.join(CODECS, name), tmp_path / "clips" / name)
            f.write(json.dumps({"audio_filepath": f"clips/{name}", "text": f"clip {i}",
                                "duration": 0.1}) + "\n")

    def graph(pkg):
        return pkg.fn.readers.nemo_asr(manifest_filepaths=[str(tmp_path / "manifest.json")],
                                       read_sample_rate=True, read_text=True, downmix=True,
                                       name="Reader")

    got = _run(dali_tpu_torch, graph, 2, iters=2)
    want = _run(dali_tpu, graph, 2, iters=2)
    for (ga, gr, gt), (wa, wr, wt) in zip(got, want):
        for a, b, r1, r2, t1, t2 in zip(ga, wa, gr, wr, gt, wt):
            _assert_within((a, float(r1)), (b, float(r2)), "nemo_asr")
            np.testing.assert_array_equal(t1, t2)


@pytest.mark.parametrize("seed", range(4))
def test_mutated_packets_raise_only_value_errors(seed):
    """Packet bytes flipped under a rewritten (valid) page CRC, or the
    stream cut: the decoder returns float32 or raises ValueError, never
    anything else; incomplete codebooks are refused as FFmpeg refuses
    them, and reads past a packet's end give zeros."""
    rng = np.random.default_rng(seed)
    for _ in range(30):
        data = _read(FIXTURES[rng.integers(len(FIXTURES))])
        pages = _pages(data)
        pos, n = pages[rng.integers(1, len(pages))]
        page = bytearray(data[pos:pos + n])
        body = 27 + page[26]
        if len(page) > body:  # the cut fixture's last page is short
            for _ in range(rng.integers(1, 4)):
                page[rng.integers(body, len(page))] ^= 1 << int(rng.integers(8))
        data = data[:pos] + _with_crc(bytes(page)) + data[pos + n:]
        try:
            x, _ = port_audio.decode_audio(data)
        except ValueError:
            continue
        assert x.dtype == np.float32 and x.size > 0
