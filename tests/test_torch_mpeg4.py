"""The port's MP4 demuxer and MPEG-4 Part 2 decoder (``csrc/host/
mp4_demux.cc``, ``mpeg4_decode.cc``, ``video_decode.cc`` through
``dali_tpu_torch.native.VideoFile``) against dali_tpu's FFmpeg 5.1 route
(``dali_tpu.native.VideoFile``): bit-equal frames in RGB and planar YUV,
equal ``info()``, by every seek route; the committed fixtures against
``reference.npz``; streams of FFmpeg's own mpeg4 encoder with the tools
cv2's writer leaves off (4MV, AC prediction, adaptive quantisation, the
MPEG quantiser, resync markers, extreme quantisers); a full-range VO
header; an edit list that hides the last sample; the forms the port leaves
to item 8b; and damaged files, where the port either fails as the
reference does, gives its frames, or departs by name."""

import hashlib
import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from dali_tpu import native as ref_native  # noqa: E402

from dali_tpu_torch import native  # noqa: E402

from .write_video_reference import (FIXTURES, WHOLE, FFmpegTools, clip_names,  # noqa: E402
                                    samples, stream_headers, with_full_range, with_samples)


@pytest.fixture(scope="module")
def tools():
    try:
        return FFmpegTools()
    except Exception as e:  # no compiler or FFmpeg headers
        pytest.skip(f"FFmpeg helper unavailable: {e}")


def _texture_clip(path, n, w, h, seed, cut=None, fps=25):
    """Smooth texture under a sub-pixel pan and a slow zoom, light noise,
    an optional scene cut; written by cv2's mp4v writer."""
    rng = np.random.default_rng(seed)
    big = cv2.resize(rng.integers(0, 256, (h // 8 + 4, w // 8 + 8, 3), np.uint8),
                     (w + 64, h + 48), interpolation=cv2.INTER_CUBIC)
    other = 255 - big
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for i in range(n):
        s = 1.0 + 0.003 * i
        m = np.float32([[s, 0, -(3 + 1.3 * i)], [0, s, -(2 + 0.45 * i)]])
        src = other if cut is not None and i >= cut else big
        f = cv2.warpAffine(src, m, (w, h), borderMode=cv2.BORDER_REFLECT)
        wr.write(np.clip(f + rng.normal(0, 2, f.shape), 0, 255).astype(np.uint8))
    wr.release()
    return str(path)


def _open_both(path):
    return native.VideoFile(path), ref_native.VideoFile(path)


def _assert_info(a, b):
    assert (a.width, a.height, a.num_frames, a.fps, a.pixfmt_class) == (
        b.width, b.height, b.num_frames, b.fps, b.pixfmt_class)


SIZES = [(48, 32), (160, 120), (170, 98), (320, 240)]


@pytest.mark.parametrize("w,h", SIZES)
def test_every_frame_bit_equal_rgb_and_yuv(tmp_path, w, h):
    path = _texture_clip(tmp_path / "v.mp4", 30, w, h, seed=w, cut=17)
    mine, ref = _open_both(path)
    _assert_info(mine, ref)
    n = ref.num_frames
    np.testing.assert_array_equal(mine.read(0, n, pad=False), ref.read(0, n, pad=False))
    mine, ref = _open_both(path)
    for a, b in zip(mine.read_yuv(0, n, pad=False), ref.read_yuv(0, n, pad=False)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fps", [10, 30, 12.5])
def test_info_at_other_rates(tmp_path, fps):
    path = _texture_clip(tmp_path / "v.mp4", 14, 64, 48, seed=3, fps=fps)
    mine, ref = _open_both(path)
    _assert_info(mine, ref)
    np.testing.assert_array_equal(mine.read(0, 14, pad=False), ref.read(0, 14, pad=False))


def test_seek_routes_bit_equal(tmp_path):
    """Reads that seek backward, reads 64 and more frames ahead, and reads
    that decode forward, on one handle each side in the same order; and
    each frame reached by seeking equals the same frame decoded forward."""
    path = _texture_clip(tmp_path / "v.mp4", 150, 96, 64, seed=9, cut=70)
    mine, ref = _open_both(path)
    whole = ref.read(0, 150, pad=False)
    plan = [(0, 5, 1), (3, 4, 2), (100, 6, 3), (40, 10, 1), (50, 4, 1), (115, 5, 1),
            (10, 3, 5), (149, 3, 1), (130, 4, 1), (64, 8, 4), (2, 2, 1)]
    for start, count, stride in plan:
        a = mine.read(start, count, stride)
        b = ref.read(start, count, stride)
        np.testing.assert_array_equal(a, b, err_msg=str((start, count, stride)))
        real = whole[start: start + count * stride: stride]
        np.testing.assert_array_equal(a[: len(real)], real)
    for start, count, stride in plan:
        ya = mine.read_yuv(start, count, stride)
        yb = ref.read_yuv(start, count, stride)
        for a, b in zip(ya, yb):
            np.testing.assert_array_equal(a, b)


def test_end_of_stream_state_matches(tmp_path):
    """After the last frame the reader stays at the end until a read seeks:
    a read just past it fails in both, a read that seeks back succeeds."""
    path = _texture_clip(tmp_path / "v.mp4", 12, 64, 48, seed=4)
    mine, ref = _open_both(path)
    for vf in (mine, ref):
        assert vf.read(8, 10, pad=False).shape[0] == 4
        with pytest.raises(ValueError, match="Failed to read frames"):
            vf.read(12, 2)
    np.testing.assert_array_equal(mine.read(1, 3), ref.read(1, 3))


@pytest.mark.parametrize("name", [n for n in clip_names() if "/" not in n]
                         + [n for n in clip_names() if "/" in n][::8])
def test_fixture_equals_reference_npz_and_dali_tpu(name):
    """The committed fixture against its reference.npz rows (hashes, and
    whole frames for the small clips) and against the live reference."""
    ref_npz = np.load(os.path.join(FIXTURES, "reference.npz"))
    path = os.path.join(FIXTURES, name + ".mp4")
    vf = native.VideoFile(path)
    w, h, n, fps = ref_npz[name + ":info"]
    assert (vf.width, vf.height, vf.num_frames, vf.fps) == (w, h, n, fps)
    rgb = vf.read(0, int(n), pad=False)
    y, u, v, got = native.VideoFile(path).read_yuv(0, int(n), pad=False)
    shas = [hashlib.sha256(f.tobytes()).digest() for f in rgb]
    assert shas == [bytes(r) for r in ref_npz[name + ":rgb_sha"]]
    yshas = [hashlib.sha256(y[i].tobytes() + u[i].tobytes() + v[i].tobytes()).digest()
             for i in range(got)]
    assert yshas == [bytes(r) for r in ref_npz[name + ":yuv_sha"]]
    if name in WHOLE:
        np.testing.assert_array_equal(rgb, ref_npz[name + ":rgb"])
    np.testing.assert_array_equal(rgb, ref_native.VideoFile(path).read(0, int(n), pad=False))


def _yuv_frames(n, w, h, seed):
    """Planar 4:2:0 frames of a panning texture with a scene cut."""
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(rng.integers(0, 256, (h + 80, w + 200, 3), np.uint8), (9, 9), 3)
    out = []
    for i in range(n):
        x, y = int(i * 2.5), int(i * 0.75)
        fr = base[y: y + h, x: x + w].astype(np.int32)
        if i == n // 2:
            fr = 255 - fr
        out.append(np.concatenate([fr[..., 0].reshape(-1), fr[::2, ::2, 1].reshape(-1),
                                   fr[::2, ::2, 2].reshape(-1)]).astype(np.uint8))
    return np.stack(out)


def _stripe_frames(n, w, h, seed):
    """Planar 4:2:0 frames of moving vertical and horizontal bars in a
    checkerboard of 32-pixel cells: edges along the block grid, where the
    encoder chooses AC prediction."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h + 64, 0:w + 128]
    out = []
    for i in range(n):
        per = 6 + (i % 5)
        vert = 128 + 90 * np.sign(np.sin(2 * np.pi * (xx + 1.5 * i) / per))
        horz = 128 + 90 * np.sign(np.sin(2 * np.pi * (yy + 0.5 * i) / (per + 3)))
        img = np.where((xx // 32 + yy // 32) % 2 == 0, vert, horz) + rng.normal(0, 3, xx.shape)
        img = np.clip(img, 0, 255).astype(np.uint8)[i % 7: i % 7 + h, i: i + w]
        u = np.clip(128 + (img[::2, ::2].astype(int) - 128) // 3, 0, 255).astype(np.uint8)
        out.append(np.concatenate([img.reshape(-1), u.reshape(-1), (255 - u).reshape(-1)]))
    return np.stack(out)


# (encoder options, width, height, content): cv2's writer sets none of
# these; "aic" turns AC prediction on (cv2's clips have none), the masks
# make adaptive quantisation (DQUANT, AC predictors rescaled across
# quantisers), "ps" writes resync markers
ENCODER_FORMS = {
    "mv4": ("flags=+mv4", 96, 64, "texture"),
    "mpeg_quant": ("mpeg_quant=1", 96, 64, "texture"),
    "resync_markers": ("ps=200", 96, 64, "texture"),
    "mv4_mpeg_quant_resync_odd": ("flags=+mv4:mpeg_quant=1:ps=300", 170, 98, "texture"),
    "low_quantiser": ("qmin=1:qmax=3:flags=+mv4", 96, 64, "texture"),
    "high_quantiser": ("qmin=25:qmax=31", 96, 64, "texture"),
    "long_vectors": ("me_range=64:flags=+mv4", 96, 64, "texture"),
    "dc_threshold_rounding": ("flags=+mv4:mpeg_quant=1:qmin=10:qmax=20", 128, 80, "texture"),
    "ac_prediction": ("flags=+aic", 96, 64, "stripes"),
    "ac_prediction_adaptive_quant_4mv": ("flags=+aic+mv4:lumi_mask=0.5:scplx_mask=0.3", 96, 64,
                                         "stripes"),
    "ac_prediction_every_tool_odd": (
        "flags=+aic+mv4:mpeg_quant=1:lumi_mask=0.5:scplx_mask=0.3:ps=250", 170, 98, "stripes"),
}


@pytest.mark.parametrize("form", sorted(ENCODER_FORMS))
def test_mpeg4_encoder_forms_bit_equal(tmp_path, tools, form):
    """FFmpeg's mpeg4 encoder with a tool cv2 leaves off, in MP4."""
    opts, w, h, content = ENCODER_FORMS[form]
    make = _stripe_frames if content == "stripes" else _yuv_frames
    path = tools.encode(tmp_path / "v.mp4", make(30, w, h, seed=len(form)), w, h, opts=opts)
    mine, ref = _open_both(path)
    _assert_info(mine, ref)
    a, b = mine.read(0, 40, pad=False), ref.read(0, 40, pad=False)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    got, _, _ = tools.decode(path)
    y, u, v, n = native.VideoFile(path).read_yuv(0, 40, pad=False)
    flat = np.concatenate([y[:n].reshape(n, -1), u[:n].reshape(n, -1), v[:n].reshape(n, -1)], 1)
    np.testing.assert_array_equal(flat, got)


@pytest.mark.parametrize("form,opts,fmt,what", [
    ("b_vops", "bf=2", "mp4", "B-VOPs"),
    ("quarter_sample", "flags=+qpel", "mp4", "quarter-sample"),
    ("data_partitioning", "data_partitioning=1", "mp4", "data partitioning"),
    ("interlaced", "flags=+ildct+ilme", "mp4", "interlaced"),
    ("mpeg2_ts", "", "mpegts", "MPEG-2 TS"),
    ("avi", "", "avi", "AVI"),
    ("raw_m4v", "", "m4v", "raw MPEG-4"),
])
def test_forms_left_to_item_8b_raise(tmp_path, tools, form, opts, fmt, what):
    """Streams FFmpeg decodes and the port does not yet: NotImplementedError
    naming the form and item 8b, at open or at the read. AVI and MPEG-TS,
    once among them, read since the AVI part and part (a) of item 8b:
    bit-equal instead."""
    path = tools.encode(tmp_path / f"v.{fmt}", _yuv_frames(14, 64, 48, seed=1), 64, 48,
                        opts=opts, fmt=fmt)
    ref = ref_native.VideoFile(path)
    assert ref.read(0, 4).shape == (4, 48, 64, 3)
    if fmt in ("avi", "mpegts"):
        mine, ref = _open_both(path)
        _assert_info(mine, ref)
        np.testing.assert_array_equal(mine.read(0, 14, pad=False), ref.read(0, 14, pad=False))
        return
    with pytest.raises(NotImplementedError, match=f"{what}.*item 8b"):
        native.VideoFile(path).read(0, 4)


def test_full_range_vo_header(tmp_path):
    """A VO header that says video_range 1: both open the stream as full
    range (pixel-format class 2) and convert with the full-range BT.601."""
    path = tmp_path / "full.mp4"
    path.write_bytes(with_full_range(open(os.path.join(FIXTURES, "recipe_160x120.mp4"),
                                          "rb").read()))
    mine, ref = _open_both(str(path))
    _assert_info(mine, ref)
    assert mine.pixfmt_class == 2
    np.testing.assert_array_equal(mine.read(0, 40, pad=False), ref.read(0, 40, pad=False))


def test_edit_list_end_hides_the_last_sample(tmp_path, tools):
    """A file whose last sample lies at the edit list's end (FFmpeg's muxer
    writes one when the packets carry no duration): both decode it, as the
    next picture's reference, and show 29 of the 30 frames stts counts."""
    path = tools.encode(tmp_path / "v.mp4", _yuv_frames(30, 64, 48, seed=2), 64, 48,
                        durations=False)
    mine, ref = _open_both(path)
    _assert_info(mine, ref)
    a, b = mine.read(0, 40, pad=False), ref.read(0, 40, pad=False)
    assert a.shape[0] == b.shape[0] == 29 and mine.num_frames == 30
    np.testing.assert_array_equal(a, b)


def test_unreadable_files_raise_value_error(tmp_path):
    junk = tmp_path / "junk.mp4"
    junk.write_bytes(bytes(range(256)) * 8)
    for mod in (native, ref_native):
        with pytest.raises(ValueError, match="Failed to open video"):
            mod.VideoFile(str(junk))
    with pytest.raises(ValueError, match="Failed to open video"):
        native.VideoFile(str(tmp_path / "missing.mp4"))


def _moov_first(data):
    """The file rewritten with ``moov`` before ``mdat`` (chunk offsets
    moved), so that cutting the end of the file cuts samples."""
    import struct

    boxes, pos = [], 0
    while pos + 8 <= len(data):
        size, typ = struct.unpack(">I4s", data[pos: pos + 8])
        boxes.append((typ, data[pos: pos + size]))
        pos += size
    moov = bytearray(dict(boxes)[b"moov"])
    shift = len(moov)
    i = moov.find(b"stco")
    n = struct.unpack(">I", moov[i + 8: i + 12])[0]
    for k in range(n):
        o = i + 12 + 4 * k
        moov[o: o + 4] = struct.pack(">I", struct.unpack(">I", moov[o: o + 4])[0] + shift)
    out = b"".join(b if t != b"mdat" else bytes(moov) + b for t, b in boxes if t != b"moov")
    return out


def test_truncated_mdat(tmp_path):
    """A file cut inside its samples: the reference decodes the whole
    samples and conceals the cut one; the port decodes the whole samples
    and ends the stream before the cut one (pinned departure: one frame
    fewer, the frames before it equal)."""
    src = _texture_clip(tmp_path / "v.mp4", 30, 96, 64, seed=5)
    data = _moov_first(open(src, "rb").read())
    cut = tmp_path / "cut.mp4"
    cut.write_bytes(data[: len(data) - 900])
    mine, ref = _open_both(str(cut))
    _assert_info(mine, ref)
    a = mine.read(0, 30, pad=False)
    b = ref.read(0, 30, pad=False)
    assert len(a) == len(b) - 1
    np.testing.assert_array_equal(a, b[: len(a)])


def test_flipped_bits_in_a_p_vop(tmp_path):
    """Bits flipped inside one P-VOP's macroblock data: frames before it
    are equal; where the reference's error concealment takes over, the port
    raises ValueError naming the damage (pinned departure); where neither
    decoder detects the damage, the frames stay equal."""
    src = _texture_clip(tmp_path / "v.mp4", 24, 96, 64, seed=6)
    data = bytearray(open(src, "rb").read())
    mine = native.VideoFile(src)
    # the sample of frame 5 (a P-VOP): from the port's own sample table
    import struct

    i = data.find(b"stsz")
    sizes = struct.unpack(">%dI" % 24, bytes(data[i + 16: i + 16 + 96]))
    j = data.find(b"stco")
    first = struct.unpack(">I", bytes(data[j + 12: j + 16]))[0]
    off = first + sum(sizes[:5])
    outcomes = []
    for k, bit in enumerate((7, 3, 5)):
        bad = bytearray(data)
        pos = off + sizes[5] // 2 + 5 * k
        bad[pos] ^= 1 << bit
        path = tmp_path / f"bad{k}.mp4"
        path.write_bytes(bytes(bad))
        ref = ref_native.VideoFile(str(path)).read(0, 24, pad=False)
        np.testing.assert_array_equal(ref[:5], mine.read(0, 5))
        try:
            got = native.VideoFile(str(path)).read(0, 24, pad=False)
        except ValueError as e:
            assert "damaged MPEG-4 Part 2 stream" in str(e)
            outcomes.append("raises")
            continue
        np.testing.assert_array_equal(got, ref)
        outcomes.append("equal")
    assert "raises" in outcomes, outcomes


@pytest.mark.parametrize("form,size", [
    ("splice_smaller", (48, 32)),
    ("splice_same_macroblock_grid", (90, 60)),
    ("vol_in_a_p_vop", (48, 32)),
])
def test_in_band_vol_that_changes_the_size(tmp_path, form, size):
    """A VOL header inside a sample that gives another frame size than the
    one at open: a smaller clip spliced in after frame 5 (its headers before
    its first I-VOP), or a smaller VOL put before one P-VOP. Every read
    stays inside the pictures it copies. On a splice both stop where the
    size changes: the RGB read returns the frames before it, the planar
    read raises VideoPixfmtChanged after as many, a read past it fails.
    Before the P-VOP the reference conceals the damage and stops at its
    smaller picture; the port raises ValueError naming the damage (pinned
    departure, as for flipped bits)."""
    w, h = size
    big = open(_texture_clip(tmp_path / "big.mp4", 24, 96, 64, seed=7), "rb").read()
    small = open(_texture_clip(tmp_path / "small.mp4", 24, w, h, seed=8), "rb").read()
    sb, ss = samples(big), samples(small)
    assert with_samples(big, sb) == big
    if form == "vol_in_a_p_vop":
        payloads = sb[:5] + [stream_headers(small) + sb[5]] + sb[6:]
    else:
        payloads = sb[:6] + [stream_headers(small) + ss[0]] + ss[1:18]
    path = tmp_path / f"{form}.mp4"
    path.write_bytes(with_samples(big, payloads))
    mine, ref = _open_both(str(path))
    _assert_info(mine, ref)
    b = ref.read(0, 24, pad=False)
    np.testing.assert_array_equal(native.VideoFile(str(path)).read(2, 3),
                                  ref_native.VideoFile(str(path)).read(2, 3))
    with pytest.raises(ref_native.VideoPixfmtChanged) as want:
        ref_native.VideoFile(str(path)).read_yuv(0, 24)
    if form == "vol_in_a_p_vop":
        assert len(b) == 5
        for read in (lambda v: v.read(0, 24), lambda v: v.read_yuv(0, 24)):
            with pytest.raises(ValueError, match="damaged MPEG-4 Part 2 stream"):
                read(native.VideoFile(str(path)))
        return
    assert len(b) == 6
    np.testing.assert_array_equal(mine.read(0, 24, pad=False), b)
    with pytest.raises(native.VideoPixfmtChanged) as got:
        native.VideoFile(str(path)).read_yuv(0, 24)
    assert got.value.got == want.value.got == 6
    for mod in (native, ref_native):
        with pytest.raises(ValueError, match="Failed to read frames"):
            mod.VideoFile(str(path)).read(8, 4)
        # a seek back keeps the spliced clip's headers: the read fails
        v = mod.VideoFile(str(path))
        v.read(0, 24)
        with pytest.raises(ValueError):
            v.read(0, 4)


def test_open_reads_the_headers_only(tmp_path):
    """A handle opened from a path reads the box headers and ``moov``, and
    each sample when it decodes it: a file that ends in a 1 GiB ``free``
    box (sparse on disk) opens and reads without the process growing by
    the file's size."""
    import struct
    import subprocess
    import sys

    path = tmp_path / "padded.mp4"
    with open(path, "wb") as f:
        f.write(open(_texture_clip(tmp_path / "v.mp4", 12, 96, 64, seed=9), "rb").read())
        f.write(struct.pack(">I4s", 1 << 30, b"free"))
        f.truncate(f.tell() - 8 + (1 << 30))
    code = (
        "import resource, sys\n"
        "from dali_tpu_torch import native\n"
        "native.host_lib()\n"
        "before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss\n"
        "v = native.VideoFile(sys.argv[1])\n"
        "frames = v.read(0, 12, pad=False)\n"
        "grew = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before\n"
        "print(len(frames), v.num_frames, grew)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code, str(path)], capture_output=True,
                         text=True, timeout=120, cwd=root, check=True).stdout.split()
    n, frames, grew_kib = map(int, out)
    assert (n, frames) == (12, 12)
    assert grew_kib < 64 * 1024, grew_kib
