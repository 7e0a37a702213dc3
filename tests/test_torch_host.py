"""Host half of the hybrid JPEG path: dali_tpu_torch's header scan and staged
coefficient wire against dali_tpu's (libjpeg header scan; _host_phase of the
JAX executor) for the same pipeline, seed and iteration."""

import os

import cv2
import numpy as np
import pytest

from dali_tpu import native as ref_native
from dali_tpu_torch import native as port_native
from dali_tpu_torch.batch import Esc16Staged, SparseStaged

CORPUS = os.path.join(os.path.dirname(__file__), "..", "dali_tpu_torch", "testdata", "rn50")


def _corpus_files():
    return sorted(os.path.join(r, f) for r, _, fs in os.walk(CORPUS) for f in fs if f.endswith(".jpg"))


def _encode(img, **params):
    flags = []
    for k, v in params.items():
        flags += [getattr(cv2, k), v]
    ok, buf = cv2.imencode(".jpg", img, flags)
    assert ok
    return buf.tobytes()


def _variants():
    rng = np.random.default_rng(0)
    img = cv2.resize(rng.integers(0, 256, (9, 13, 3), np.uint8), (101, 75))
    base = _encode(img, IMWRITE_JPEG_QUALITY=85)
    ok, png = cv2.imencode(".png", img)
    return {
        "420": base,
        "444": _encode(img, IMWRITE_JPEG_SAMPLING_FACTOR=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
        "422": _encode(img, IMWRITE_JPEG_SAMPLING_FACTOR=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
        "411": _encode(img, IMWRITE_JPEG_SAMPLING_FACTOR=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
        "progressive": _encode(img, IMWRITE_JPEG_PROGRESSIVE=1),
        "gray": _encode(img[:, :, 0]),
        "png": png.tobytes(),
        "truncated_header": base[:40],
        "odd_size": _encode(cv2.resize(img, (33, 17))),
    }


@pytest.mark.parametrize("name", ["corpus", "420", "444", "422", "411", "progressive", "gray",
                                  "png", "truncated_header", "odd_size"])
def test_header_scan_matches_libjpeg(name):
    if name == "corpus":
        datas = [np.fromfile(f, np.uint8) for f in _corpus_files()]
    else:
        datas = [np.frombuffer(_variants()[name], np.uint8)]
    want = ref_native.jpeg_coef_info_batch(datas)
    got = port_native.jpeg_coef_info_batch(datas)
    np.testing.assert_array_equal(got, want)


def _strip_segments(data: bytes, marker: int) -> bytes:
    out, pos = bytearray(data[:2]), 2
    while pos + 4 <= len(data) and data[pos + 1] != 0xDA:
        seg = data[pos:pos + 2 + ((data[pos + 2] << 8) | data[pos + 3])]
        if data[pos + 1] != marker:
            out += seg
        pos += len(seg)
    return bytes(out + data[pos:])


def test_undecodable_sample_raises():
    """No libjpeg fallback: a stream neither entropy decoder reads raises."""
    good = np.fromfile(_corpus_files()[0], np.uint8)
    bad = np.frombuffer(_strip_segments(good.tobytes(), 0xC4), np.uint8)  # no Huffman tables
    infos = port_native.jpeg_coef_info_batch([good, bad])
    assert (infos[:, 6] == 0).all()
    blocks = np.tile(np.array([[4, 4, 2, 2]], np.int32), (2, 1))
    zeros = np.zeros((2, 2), np.int32)
    pool = port_native.TaskPool(1)
    try:
        with pytest.raises(ValueError, match=r"sample\(s\) \[1\]"):
            port_native.coef_pack_batch(pool, [good, bad], 4, 4, blocks, zeros, zeros,
                                        [1 << 18] * 4)
    finally:
        pool.close()


def _rn50(pkg, batch, **kw):
    fn, types = pkg.fn, pkg.types

    @pkg.pipeline_def(batch_size=batch, num_threads=2, seed=42, **kw)
    def p():
        jpegs, labels = fn.readers.file(file_root=CORPUS, random_shuffle=True, name="Reader")
        img = fn.decoders.image_random_crop(jpegs, device="mixed", hybrid_device_decode=True,
                                            hybrid_scale=2)
        img = fn.resize(img, resize_x=64, resize_y=64)
        img = fn.crop_mirror_normalize(img, mirror=fn.random.coin_flip(probability=0.5),
                                       dtype=types.FLOAT, output_layout="CHW",
                                       mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375])
        return img, labels

    pipe = p()
    pipe.build()
    return pipe


def _popcount(mask):
    return sum(bin(int(m)).count("1") for m in mask)


@pytest.mark.parametrize("iteration", [0, 3])
def test_staged_wire_matches_dali_tpu_host_phase(iteration):
    import dali_tpu
    import dali_tpu_torch

    ref_pipe = _rn50(dali_tpu, 8)
    port_pipe = _rn50(dali_tpu_torch, 8, device="cpu")
    try:
        want = ref_pipe._executor._host_phase(iteration)
        got = port_pipe.executor._host_phase(iteration)
    finally:
        ref_pipe._executor.shutdown()
        port_pipe.shutdown()
    assert len(got["boundary"]) == len(want["padded"]) == 7
    for i, item in enumerate(got["boundary"]):
        w_bufs, w_shapes = want["padded"][i], want["shapes"][i]
        np.testing.assert_array_equal(item.shapes, w_shapes)
        if isinstance(item, Esc16Staged):
            w_dc8, w_esc = w_bufs
            assert want["flat_meta"][i] == ("esc16",) + item.canvas
            n = int(np.prod(item.shapes, axis=1).sum())
            assert len(item.dc8) == len(w_dc8) and len(item.esc) == len(w_esc)
            np.testing.assert_array_equal(item.dc8[:n], w_dc8[:n])
            e = int((item.dc8[:n] == -128).sum())
            np.testing.assert_array_equal(item.esc[:e], w_esc[:e])
        elif isinstance(item, SparseStaged):
            w_mask, w_nibs, w_esc = w_bufs
            assert want["flat_meta"][i] == ("sparse4",) + item.canvas
            n = int(np.prod(item.shapes[:, :-1], axis=1).sum())
            assert (len(item.mask), len(item.nibs), len(item.esc)) == (
                len(w_mask), len(w_nibs), len(w_esc))
            np.testing.assert_array_equal(item.mask[:n], w_mask[:n])
            nnz = _popcount(item.mask[:n])
            np.testing.assert_array_equal(item.nibs[:nnz // 2], w_nibs[:nnz // 2])
            codes = np.stack([item.nibs & 15, item.nibs >> 4], 1).reshape(-1)[:nnz]
            if nnz % 2:
                assert codes[-1] == w_nibs[nnz // 2] & 15
            e = int((codes == 8).sum())  # 4-bit -8 is the escape code
            np.testing.assert_array_equal(item.esc[:e], w_esc[:e])
        else:
            np.testing.assert_array_equal(item.array, w_bufs)
    np.testing.assert_array_equal(np.concatenate(got["args"]), np.concatenate(want["args"]))
    np.testing.assert_array_equal(got["boundary"][1].offsets, want["flat_offsets"][1])
