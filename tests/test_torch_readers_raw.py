"""Record-format readers and raw-input operators of dali_tpu_torch against
dali_tpu on the CPU: readers.MXNet, Caffe, Caffe2, NemoAsr and Fits,
decoders.Numpy (cpu and mixed), decoders.Inflate and io.file.Read; and the
port's polygon fill (``polyfill.fill_poly``) against ``cv2.fillPoly``, alone
and as readers.COCO's ``pixelwise_masks`` through both packages.

Outputs are equal bit for bit (dtype and shape included), NemoAsr's
resampled float audio too (both packages resample with the same scipy
call). Every dataset is written small into pytest's tmp dir from a numpy
seed.
"""

import gzip
import json
import os
import struct
import wave
import zlib

import cv2
import numpy as np
import pytest

from dali_tpu_torch import types
from dali_tpu_torch._lmdb import write_lmdb
from dali_tpu_torch.polyfill import fill_poly
from dali_tpu_torch.testdata.make_coco_annotations import CORPUS, corpus_files

from .test_lmdb import encode_datum, encode_tensor_protos
from .test_torch_readers import _assert_equal, _both_raise, _run_both


def _source(pkg, data, **kw):
    return pkg.fn.external_source(source=lambda: data, batch=True, **kw)


# ---------------------------------------------------------------- polygon fill

def _star(n, cx, cy, r, inner, rng):
    a = np.sort(rng.uniform(0, 2 * np.pi, n))
    rr = r * np.where(np.arange(n) % 2, inner, 1.0)
    return np.stack([cx + rr * np.cos(a), cy + rr * np.sin(a)], 1)


def _polygon_set():
    """COCO-like polygons, named: convex, concave, self-touching (a figure
    eight through one vertex, a spike back along an edge), collinear and
    duplicate vertices, vertices off the canvas on every side, and the
    degenerate one- and two-point forms."""
    rng = np.random.default_rng(8)
    t = np.linspace(0, 2 * np.pi, 17)[:-1]
    polys = {
        "convex_ellipse": np.stack([40 + 25 * np.cos(t), 30 + 12 * np.sin(t)], 1),
        "concave_star": _star(14, 35, 25, 22, 0.4, rng),
        "concave_l": [[5, 5], [40, 5], [40, 15], [15, 15], [15, 50], [5, 50]],
        "figure_eight": [[30, 25], [50, 10], [50, 40], [30, 25], [10, 10], [10, 40]],
        "spike": [[10, 10], [60, 10], [60, 40], [35, 40], [35, 12], [35, 40], [10, 40]],
        "collinear": [[5, 5], [20, 5], [35, 5], [50, 5], [50, 30], [50, 45], [5, 45], [5, 25]],
        "duplicates": [[8, 8], [8, 8], [55, 12], [55, 12], [55, 12], [30, 50], [8, 8]],
        "off_left_top": [[-20, -15], [30, 5], [25, 35], [-5, 40]],
        "off_right_bottom": [[40, 20], [90, 30], [85, 70], [45, 66]],
        "off_all_sides": [[-10, 30], [35, -12], [80, 30], [35, 70]],
        "outside": [[70, 60], [95, 60], [80, 90]],
        "thin_slanted": [[3, 2], [60, 47], [61, 47], [4, 2]],
        "horizontal_edges": [[5, 10], [50, 10], [50, 10], [30, 30], [60, 30], [5, 30]],
        "one_point": [[20, 20]],
        "two_points": [[5, 7], [48, 39]],
        "two_points_off": [[50, 20], [90, 70]],
    }
    return {k: np.round(np.asarray(v, np.float64)).astype(np.int32) for k, v in polys.items()}


POLYGONS = _polygon_set()


@pytest.mark.parametrize("name", sorted(POLYGONS))
def test_fill_poly_matches_cv2(name):
    pts = POLYGONS[name]
    for shape in ((48, 64), (60, 60, 1), (1, 70), (45, 1)):
        want = np.full(shape, 3, np.int32)
        got = want.copy()
        cv2.fillPoly(want, [pts], 9)
        fill_poly(got, pts, 9)
        np.testing.assert_array_equal(got, want)


def test_fill_poly_matches_cv2_on_random_polygons():
    """600 random polygons of 1-40 vertices (random walks, stars and
    scattered points) on canvases of 1-90 pixels a side."""
    rng = np.random.default_rng(9)
    for k in range(600):
        h, w = (int(v) for v in rng.integers(1, 91, 2))
        n = int(rng.integers(1, 41))
        if k % 3 == 0:
            pts = rng.integers(-30, 120, (n, 2))
        elif k % 3 == 1:
            pts = _star(n, *rng.uniform(-10, 100, 2), rng.uniform(1, 60), rng.uniform(0.1, 1), rng)
        else:
            pts = np.cumsum(rng.integers(-9, 10, (n, 2)), 0) + rng.integers(0, 90, 2)
        pts = np.round(pts).astype(np.int32)
        want = np.zeros((h, w, 1), np.int32)
        got = want.copy()
        cv2.fillPoly(want, [pts], k + 1)
        fill_poly(got, pts, k + 1)
        np.testing.assert_array_equal(got, want, err_msg=f"{pts.tolist()} on {h}x{w}")


def test_coco_pixelwise_masks_on_the_polygon_set(tmp_path):
    """readers.COCO(pixelwise_masks=True) in both packages over annotations
    whose polygons are the set above, several per image, overlapping (the
    later annotation wins), at COCO's coordinates scaled onto each image."""
    files = corpus_files()[:4]
    polys = [p for p in POLYGONS.values() if len(p) >= 3]
    images, anns = [], []
    for i, (rel, w, h) in enumerate(files):
        images.append({"id": 10 + i, "file_name": rel, "width": w, "height": h})
        for j in range(5):
            p = polys[(5 * i + j) % len(polys)] * np.float32([w / 64.0, h / 48.0])
            x0, y0 = p.min(0)
            x1, y1 = p.max(0)
            anns.append({"id": len(anns) + 1, "image_id": 10 + i, "category_id": 1 + j,
                         "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                         "iscrowd": 0, "segmentation": [[round(float(v), 2)
                                                         for v in p.reshape(-1)]]})
    path = tmp_path / "annotations.json"
    path.write_text(json.dumps({"images": images, "annotations": anns,
                                "categories": [{"id": c} for c in range(1, 6)]}))

    def graph(pkg):
        return tuple(pkg.fn.readers.coco(file_root=CORPUS, annotations_file=str(path),
                                         pixelwise_masks=True, ratio=True, name="Reader"))

    port, ref = _run_both(graph, iters=1, batch=4)
    _assert_equal(port, ref)
    assert all(len(np.unique(m)) >= 3 for m in port[0][3])


# ---------------------------------------------------------------- readers.MXNet

def _recordio(path, payloads):
    offsets = []
    with open(path, "wb") as f:
        for p in payloads:
            offsets.append(f.tell())
            f.write(struct.pack("<II", 0xCED7230A, len(p)) + p + b"\0" * ((-len(p)) % 4))
    return offsets


@pytest.mark.parametrize("dont_use_mmap", [False, True], ids=["mmap", "pread"])
@pytest.mark.parametrize("indexed", [True, False], ids=["idx", "scan"])
def test_mxnet_reader(tmp_path, indexed, dont_use_mmap):
    rng = np.random.default_rng(10)
    paths, idx = [], []
    for k in range(2):
        payloads = []
        for i in range(5 + k):
            n_labels = int(rng.integers(0, 3))
            body = rng.bytes(int(rng.integers(3, 40)))
            if n_labels:
                hdr = struct.pack("<IfQQ", n_labels, 0.0, i, 0) + rng.uniform(
                    0, 9, n_labels).astype(np.float32).tobytes()
            else:
                hdr = struct.pack("<IfQQ", 0, float(i), i, 0)
            payloads.append(hdr + body)
        path = str(tmp_path / f"part{k}.rec")
        offsets = _recordio(path, payloads)
        (tmp_path / f"part{k}.idx").write_text(
            "".join(f"{i}\t{o}\n" for i, o in reversed(list(enumerate(offsets)))))
        paths.append(path)
        idx.append(str(tmp_path / f"part{k}.idx"))

    def graph(pkg):
        return tuple(pkg.fn.readers.mxnet(path=paths, index_path=idx if indexed else None,
                                          random_shuffle=True, initial_fill=4,
                                          dont_use_mmap=dont_use_mmap, name="Reader"))

    _assert_equal(*_run_both(graph, iters=4, batch=3))


# ---------------------------------------------------------------- readers.Caffe / Caffe2

@pytest.fixture(scope="module")
def caffe_db(tmp_path_factory):
    """A Caffe LMDB: raw CHW datums, encoded JPEG datums and float datums."""
    rng = np.random.default_rng(11)
    jpeg = open(os.path.join(CORPUS, corpus_files()[0][0]), "rb").read()
    items = []
    for i in range(9):
        if i % 3 == 0:
            d = encode_datum(3, 4, 5, rng.bytes(60), i)
        elif i % 3 == 1:
            d = encode_datum(0, 0, 0, jpeg, i, encoded=True)
        else:
            floats = rng.standard_normal(12).astype("<f4")
            d = (encode_datum(3, 2, 2, b"", i)
                 + bytes([0x32, len(floats.tobytes())]) + floats.tobytes())
        items.append((f"{i:08d}".encode(), d))
    root = tmp_path_factory.mktemp("caffe")
    write_lmdb(str(root), items)
    return str(root)


@pytest.mark.parametrize("kw", [{}, dict(label_available=False), dict(image_available=False)],
                         ids=["both", "image_only", "label_only"])
def test_caffe_reader(caffe_db, kw):
    def graph(pkg):
        out = pkg.fn.readers.caffe(path=caffe_db, random_shuffle=True, initial_fill=4,
                                   name="Reader", **kw)
        return out if isinstance(out, tuple) else (out,)

    _assert_equal(*_run_both(graph, iters=4, batch=3))


@pytest.fixture(scope="module")
def caffe2_db(tmp_path_factory):
    """Caffe2 LMDBs of TensorProtos: image, label indices (int32), weights,
    two additional tensors and a bbox per sample."""
    rng = np.random.default_rng(12)
    items = []
    for i in range(7):
        img = rng.integers(0, 256, (2, 3, 3), np.uint8)
        labels = rng.choice(10, int(rng.integers(1, 4)), replace=False).astype(np.int32)
        weights = rng.uniform(0, 1, len(labels)).astype(np.float32)
        extra = [rng.standard_normal(4).astype(np.float32), np.arange(i + 1, dtype=np.int32)]
        bbox = rng.integers(0, 50, 4).astype(np.int32)
        items.append((f"{i:04d}".encode(),
                      encode_tensor_protos([img, labels, weights] + extra + [bbox])))
    root = tmp_path_factory.mktemp("caffe2")
    write_lmdb(str(root), items)
    return str(root)


CAFFE2_CASES = {
    "single": dict(label_type=0),
    "sparse": dict(label_type=1, num_labels=10),
    "dense": dict(label_type=2),
    "weighted_sparse": dict(label_type=3, num_labels=10, additional_inputs=2, bbox=True),
    "no_label": dict(label_type=4),
}


@pytest.mark.parametrize("case", sorted(CAFFE2_CASES))
def test_caffe2_reader(caffe2_db, case):
    def graph(pkg):
        out = pkg.fn.readers.caffe2(path=caffe2_db, name="Reader", **CAFFE2_CASES[case])
        return out if isinstance(out, tuple) else (out,)

    _assert_equal(*_run_both(graph, iters=3, batch=3))


def test_caffe2_label_out_of_bounds(caffe2_db):
    def graph(pkg):
        return tuple(pkg.fn.readers.caffe2(path=caffe2_db, label_type=1, num_labels=2))

    _both_raise(graph, ValueError, "label index out of bounds")


# ---------------------------------------------------------------- readers.NemoAsr

@pytest.fixture(scope="module")
def nemo_manifest(tmp_path_factory):
    """Six 16-bit WAV clips (mono and stereo, 16 kHz and 22.05 kHz, 0.1-0.4
    s) and a manifest with durations and transcripts (one clip outside the
    duration window used below)."""
    root = tmp_path_factory.mktemp("nemo")
    rng = np.random.default_rng(13)
    lines = []
    for i in range(6):
        rate = (16000, 22050)[i % 2]
        channels = 2 if i in (1, 4) else 1
        n = int(rate * (0.1 + 0.06 * i))
        pcm = (rng.standard_normal((n, channels)) * 3000).clip(-32768, 32767).astype("<i2")
        name = f"clip{i}.wav"
        with wave.open(str(root / name), "wb") as w:
            w.setnchannels(channels)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes(pcm.tobytes())
        lines.append(json.dumps({"audio_filepath": name, "duration": n / rate,
                                 "text": f"utterance number {i}"}))
    path = root / "manifest.json"
    path.write_text("\n".join(lines) + "\n\n")
    return str(path)


NEMO_CASES = {
    "defaults": dict(),
    "resample_16k": dict(sample_rate=16000.0),
    "toggles": dict(read_sample_rate=False, read_text=False, read_idxs=True, downmix=False),
    "int16_window": dict(dtype="INT16", min_duration=0.15, max_duration=0.35, read_idxs=True),
}


@pytest.mark.parametrize("case", sorted(NEMO_CASES))
def test_nemo_asr_reader(nemo_manifest, case):
    def graph(pkg):
        kw = {k: getattr(pkg.types, v) if k == "dtype" else v for k, v in NEMO_CASES[case].items()}
        out = pkg.fn.readers.nemo_asr(manifest_filepaths=[nemo_manifest], random_shuffle=True,
                                      initial_fill=3, name="Reader", **kw)
        return out if isinstance(out, tuple) else (out,)

    port, ref = _run_both(graph, iters=3, batch=2)
    _assert_equal(port, ref)
    if case == "int16_window":
        assert port[0][0][0].dtype == np.int16
        assert {int(s[0]) for it in port for s in it[-1]} <= {0, 1, 2, 3}  # clips 1-4 of 6


# ---------------------------------------------------------------- readers.Fits

def _hdu(cards, data: bytes):
    hdr = b"".join(c.ljust(80) for c in cards + [b"END"]).ljust(2880)
    return hdr + data + b"\0" * ((-len(data)) % 2880)


def _card(key, value):
    return f"{key:<8}= {value:>20}".encode()


def _image_hdu(arr, first=False, extra=()):
    bitpix = {np.dtype(">i2"): 16, np.dtype(">i4"): 32, np.dtype(">i8"): 64,
              np.dtype(">f4"): -32, np.dtype(">f8"): -64, np.dtype("u1"): 8}[arr.dtype]
    cards = [_card("SIMPLE", "T") if first else b"XTENSION= 'IMAGE   '",
             _card("BITPIX", bitpix), _card("NAXIS", arr.ndim)]
    cards += [_card(f"NAXIS{k + 1}", n) for k, n in enumerate(arr.shape[::-1])]
    return _hdu(cards + list(extra), arr.tobytes())


@pytest.fixture(scope="module")
def fits_dir(tmp_path_factory):
    """Four FITS files: a primary and three image extensions each (int16
    with BSCALE/BZERO, float32, float64 / int32 / uint8 / int64 in turn), a
    BINTABLE with a heap before the last image, and a primary-only file
    apart; a file list."""
    root = tmp_path_factory.mktemp("fits")
    rng = np.random.default_rng(14)
    for i in range(4):
        third = [rng.standard_normal((2, 3)).astype(">f8"),
                 rng.integers(-9, 9, (4,)).astype(">i4"),
                 rng.integers(0, 255, (3, 3)).astype("u1"),
                 rng.integers(-2 ** 40, 2 ** 40, (2, 2)).astype(">i8")][i]
        table = _hdu([b"XTENSION= 'BINTABLE'", _card("BITPIX", 8), _card("NAXIS", 2),
                      _card("NAXIS1", 4), _card("NAXIS2", 2), _card("PCOUNT", 37),
                      _card("GCOUNT", 1)], b"\x01" * 45)
        blob = (_image_hdu(np.zeros((0,), ">i2"), first=True)
                + _image_hdu(rng.integers(-300, 300, (3 + i, 4)).astype(">i2"),
                             extra=[_card("BSCALE", "0.5"), _card("BZERO", "10.0")])
                + _image_hdu(rng.standard_normal((2, 2 + i, 3)).astype(">f4"))
                + table + _image_hdu(third))
        (root / f"obs{i}.fits").write_bytes(blob)
    (root / "primary_only.fit").write_bytes(
        _image_hdu(rng.integers(0, 100, (5, 6)).astype(">i2"), first=True))
    (root / "list.txt").write_text("obs2.fits\nobs0.fits\n")
    return str(root)


FITS_CASES = {
    "default_hdu": dict(),
    "multi_hdu": dict(hdu_indices=[2, 3, 5]),
    "dtypes": dict(hdu_indices=[2, 3], dtypes=[int(types.FLOAT), int(types.FLOAT16)]),
    "file_list": dict(hdu_indices=[3], file_list="list.txt"),
    "primary_fallback": dict(file_filter="*.fit"),
}


@pytest.mark.parametrize("case", sorted(FITS_CASES))
def test_fits_reader(fits_dir, case):
    kw = dict(FITS_CASES[case])
    if "file_list" in kw:
        kw["file_list"] = os.path.join(fits_dir, kw["file_list"])

    def graph(pkg):
        out = pkg.fn.readers.fits(file_root=fits_dir, random_shuffle=True, initial_fill=3,
                                  name="Reader", **kw)
        return out if isinstance(out, tuple) else (out,)

    _assert_equal(*_run_both(graph, iters=3, batch=2))


def test_fits_missing_hdu(fits_dir):
    def graph(pkg):
        return pkg.fn.readers.fits(file_root=fits_dir, hdu_indices=[7])

    _both_raise(graph, ValueError, r"HDU\(s\) \[7\] not present")


# ---------------------------------------------------------------- decoders.Numpy

def _npy_bytes(arr):
    import io

    buf = io.BytesIO()
    np.save(buf, arr)
    return np.frombuffer(buf.getvalue(), np.uint8)


@pytest.mark.parametrize("device", ["cpu", "mixed"])
@pytest.mark.parametrize("dtype", [None, "FLOAT"], ids=["keep", "to_float"])
def test_numpy_decoder(device, dtype):
    rng = np.random.default_rng(15)
    arrs = [rng.integers(-100, 100, (3, 4, 2)).astype(np.int16),
            np.asfortranarray(rng.integers(-100, 100, (3, 4, 2)).astype(np.int16)),
            rng.integers(-100, 100, (3, 4, 2)).astype(">i2")]
    data = [_npy_bytes(a) for a in arrs]

    def graph(pkg):
        kw = {} if dtype is None else {"dtype": getattr(pkg.types, dtype)}
        return pkg.fn.decoders.numpy(_source(pkg, data), device=device, **kw)

    port, ref = _run_both(graph, iters=1, batch=3)
    _assert_equal(port, ref)
    for got, a in zip(port[0][0], arrs):
        np.testing.assert_array_equal(got, a)


# ---------------------------------------------------------------- decoders.Inflate

def _compress(algo, raw):
    if algo == "zlib":
        return zlib.compress(raw)
    if algo == "gzip":
        return gzip.compress(raw)
    if algo == "raw_deflate":
        c = zlib.compressobj(6, zlib.DEFLATED, -15)
        return c.compress(raw) + c.flush()
    import zstandard

    return zstandard.ZstdCompressor().compress(raw)


@pytest.mark.parametrize("algo", ["zlib", "gzip", "raw_deflate", "zstd"])
def test_inflate(algo):
    rng = np.random.default_rng(16)
    raws = [rng.integers(0, 50, (6, 4)).astype(np.float32) for _ in range(3)]
    chunks = [np.frombuffer(_compress(algo, r.tobytes()), np.uint8) for r in raws]
    shapes = [np.array([4, 6], np.int32), np.array([24], np.int32), np.array([2, 12], np.int32)]

    def graph(pkg):
        enc = _source(pkg, chunks)
        return (pkg.fn.decoders.inflate(enc, algorithm=algo),
                pkg.fn.decoders.inflate(enc, algorithm=algo.upper(), dtype=pkg.types.FLOAT,
                                        shape=[6, 4]),
                pkg.fn.decoders.inflate(enc, algorithm=algo, dtype=pkg.types.FLOAT,
                                        shape=_source(pkg, shapes)))

    port, ref = _run_both(graph, iters=1, batch=3)
    _assert_equal(port, ref)
    for got, want in zip(port[0][1], raws):
        np.testing.assert_array_equal(got, want)


def test_inflate_unknown_algorithm():
    def graph(pkg):
        return pkg.fn.decoders.inflate(_source(pkg, [np.zeros(4, np.uint8)]), algorithm="lz4")

    _both_raise(graph, ValueError, "Unsupported inflate algorithm 'lz4'", batch=1)


# ---------------------------------------------------------------- io.file.Read

def test_io_file_read(tmp_path):
    rng = np.random.default_rng(17)
    names = []
    for i in range(3):
        p = tmp_path / f"blob {i}.bin"
        p.write_bytes(rng.bytes(10 + 7 * i))
        # a NUL-padded path, as a fixed-width string tensor holds it
        names.append(np.frombuffer(str(p).encode() + b"\0" * i, np.uint8))

    def graph(pkg):
        return pkg.fn.io.file.read(_source(pkg, names))

    port, ref = _run_both(graph, iters=1, batch=3)
    _assert_equal(port, ref)
    assert [len(s) for s in port[0][0]] == [10, 17, 24]
