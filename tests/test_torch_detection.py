"""The detection lane of dali_tpu_torch against dali_tpu on the CPU:
readers.COCO, the bbox operators (BbFlip, BBoxPaste, RandomBBoxCrop,
BoxEncoder, SSDRandomCrop, CoordFlip, BBoxRotate, ROIRandomCrop,
RandomCropGenerator) and segmentation.* through pipelines of both packages
built node for node, so that implicit seeds key on the same op ids.

Host outputs are equal bit for bit (``np.array_equal``). The gpu BbFlip,
CoordFlip and BoxEncoder run here as plain PyTorch on the CPU and are held
against dali_tpu's gpu lowerings with ``debug=True``: labels equal, boxes
within 1e-6 (the offset form, through a log, within 1e-5). The SSD recipe of
docs/examples/ssd_detection.py at batch 8 and a reduced output size: encoded
labels equal, encoded boxes within 1e-6, images within one uint8 step / std
on at most 1e-3 of values (the resize's rounding ties, as in
test_torch_ndd.py).
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

import dali_tpu
import dali_tpu_torch
from dali_tpu_torch.backend import generic_gpu
from dali_tpu_torch.backend.bbox import encode_boxes
from dali_tpu_torch.plugin.pytorch import DALIGenericIterator
from dali_tpu_torch.testdata.make_coco_annotations import CORPUS, make_annotations
from dali_tpu_torch.tools import bench_ssd

SEED = 17
MEAN = [0.485 * 255, 0.456 * 255, 0.406 * 255]
STD = [0.229 * 255, 0.224 * 255, 0.225 * 255]
LSB = 1.0 / min(STD) + 1e-4
MAX_FLIP_FRACTION = 1e-3
BOX_ATOL, OFFSET_ATOL = 1e-6, 1e-5


# ---------------------------------------------------------------- helpers

def _build(pkg, graph, batch=4, seed=SEED, **kw):
    if pkg is dali_tpu_torch:
        kw.setdefault("device", "cpu")
    else:
        kw.setdefault("debug", True)

    @pkg.pipeline_def(batch_size=batch, num_threads=1, seed=seed, **kw)
    def pipe():
        return graph(pkg.fn, pkg.types)

    p = pipe()
    p.build()
    return p


def _close(pipe):
    if isinstance(pipe, dali_tpu_torch.Pipeline):
        pipe.shutdown()
    else:
        pipe._executor.shutdown()


def _samples(outs):
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    return [[np.asarray(o.at(i)) for i in range(len(o))] for o in outs]


def _run_both(graph, iters=2, batch=4, **kw):
    """[iteration][output][sample] numpy of the port and of dali_tpu."""
    got = []
    for pkg in (dali_tpu_torch, dali_tpu):
        pipe = _build(pkg, graph, batch=batch, **kw)
        try:
            got.append([_samples(pipe.run()) for _ in range(iters)])
        finally:
            _close(pipe)
    return got


def _assert_equal(port, ref):
    assert len(port) == len(ref)
    for it_p, it_r in zip(port, ref):
        assert len(it_p) == len(it_r)
        for out_p, out_r in zip(it_p, it_r):
            for a, b in zip(out_p, out_r):
                assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, a.shape, b.dtype, b.shape)
                np.testing.assert_array_equal(a, b)


def _boxes(n=4, seed=0, empty=(), dims=4):
    rng = np.random.default_rng(seed)
    boxes, labels = [], []
    for i in range(n):
        k = 0 if i in empty else int(rng.integers(1, 9))
        lt = rng.uniform(0, 0.6, (k, 2))
        wh = rng.uniform(0.05, 0.39, (k, 2))
        boxes.append(np.concatenate([lt, lt + wh], 1).astype(np.float32))
        labels.append(rng.integers(1, 80, k).astype(np.int32))
    return boxes, labels


def _source(fn, data, **kw):
    return fn.external_source(source=lambda: data, batch=True, **kw)


# ---------------------------------------------------------------- host bbox operators

@pytest.mark.parametrize("ltrb", [True, False])
def test_bb_flip_cpu(ltrb):
    boxes, _ = _boxes(6, seed=1, empty=(2,))

    def graph(fn, types):
        b = _source(fn, boxes)
        return (fn.bb_flip(b, ltrb=ltrb, horizontal=fn.random.coin_flip(probability=0.5),
                           vertical=fn.random.coin_flip(probability=0.5)),
                fn.bb_flip(b, ltrb=ltrb))

    _assert_equal(*_run_both(graph, batch=6))


@pytest.mark.parametrize("ltrb", [True, False])
def test_bbox_paste(ltrb):
    boxes, _ = _boxes(5, seed=2, empty=(1,))

    def graph(fn, types):
        b = _source(fn, boxes)
        ratio = fn.random.uniform(range=[1.0, 3.0])
        px = fn.random.uniform(range=[0.0, 1.0])
        return (fn.bbox_paste(b, ratio=ratio, paste_x=px, ltrb=ltrb),
                fn.bbox_paste(b, ratio=2.0, paste_y=0.25, ltrb=ltrb))

    _assert_equal(*_run_both(graph, batch=5))


RBC_CASES = {
    "ssd": dict(aspect_ratio=[0.5, 2.0], thresholds=[0.0, 0.1, 0.3, 0.5, 0.7, 0.9],
                scaling=[0.3, 1.0], num_attempts=4),
    "indices": dict(thresholds=[0.1, 0.5], scaling=[0.3, 1.0], output_bbox_indices=True),
    "no_crop_off": dict(thresholds=[0.1], scaling=[0.5, 1.0], allow_no_crop=False,
                        num_attempts=8, total_num_attempts=40, quiet=True, seed=3),
    "any_box": dict(thresholds=[0.3, 0.6], scaling=[0.3, 1.0], all_boxes_above_threshold=False,
                    output_bbox_indices=True),
    "prune": dict(thresholds=[0.1], scaling=[0.4, 0.9], bbox_prune_threshold=0.5),
    "prune_any": dict(thresholds=[0.1], scaling=[0.4, 0.9], bbox_prune_threshold=0.0),
    "layout_xyXY": dict(thresholds=[0.1, 0.3], bbox_layout="xyXY", ltrb=True),
}


@pytest.mark.parametrize("case", sorted(RBC_CASES))
def test_random_bbox_crop(case):
    boxes, labels = _boxes(8, seed=4, empty=(3,))
    args = RBC_CASES[case]

    def graph(fn, types):
        outs = fn.random_bbox_crop(_source(fn, boxes), _source(fn, labels), **args)
        return tuple(outs)

    _assert_equal(*_run_both(graph, iters=3, batch=8))


def test_random_bbox_crop_without_labels():
    boxes, _ = _boxes(4, seed=5)

    def graph(fn, types):
        return tuple(fn.random_bbox_crop(_source(fn, boxes), thresholds=[0.3], scaling=[0.3, 1.0],
                                         output_bbox_indices=True))

    _assert_equal(*_run_both(graph))


@pytest.mark.parametrize("layout", [None, "HW"])
def test_random_bbox_crop_crop_shape(layout):
    boxes, labels = _boxes(4, seed=6, empty=(0,))
    shapes = [np.array([640, 480], np.int32), np.array([300, 200], np.int32),
              np.array([500, 500], np.int32), np.array([256, 320], np.int32)]
    extra = {} if layout is None else {"shape_layout": layout}

    def graph(fn, types):
        return tuple(fn.random_bbox_crop(
            _source(fn, boxes), _source(fn, labels), crop_shape=[200, 150],
            input_shape=_source(fn, shapes), thresholds=[0.0, 0.2], allow_no_crop=True,
            output_bbox_indices=True, **extra))

    _assert_equal(*_run_both(graph, iters=3))


@pytest.mark.parametrize("quiet", [False, True])
def test_random_bbox_crop_attempt_budget(quiet):
    """An unreachable threshold: total_num_attempts ends the search and the
    best candidate is used, with the warning unless quiet."""
    boxes, labels = _boxes(4, seed=7, empty=(2,))

    def graph(fn, types):
        return tuple(fn.random_bbox_crop(
            _source(fn, boxes), _source(fn, labels), thresholds=[0.99], scaling=[0.1, 0.3],
            allow_no_crop=False, num_attempts=3, total_num_attempts=7, quiet=quiet,
            output_bbox_indices=True))

    got = []
    for pkg in (dali_tpu_torch, dali_tpu):
        pipe = _build(pkg, graph)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                got.append([_samples(pipe.run())])
        finally:
            _close(pipe)
        msgs = [str(w.message) for w in caught if "RandomBBoxCrop" in str(w.message)]
        assert (len(msgs) == 0) if quiet else (len(msgs) == 3), msgs  # the 3 samples with boxes
    _assert_equal(*got)


@pytest.mark.parametrize("offset", [False, True])
def test_box_encoder_cpu(offset):
    boxes, labels = _boxes(5, seed=8, empty=(4,))
    anchors = bench_ssd.dboxes300_coco()[::7]
    extra = dict(offset=True, means=[0.1, -0.1, 0.0, 0.05], stds=[0.1, 0.1, 0.2, 0.2],
                 scale=1.5) if offset else dict(scale=2.0)

    def graph(fn, types):
        return tuple(fn.box_encoder(_source(fn, boxes), _source(fn, labels),
                                    anchors=anchors.reshape(-1).tolist(), criteria=0.4, **extra))

    _assert_equal(*_run_both(graph, iters=1, batch=5))


def test_ssd_random_crop():
    rng = np.random.default_rng(9)
    images = [rng.integers(0, 256, (int(rng.integers(40, 90)), int(rng.integers(40, 90)), 3),
                           np.uint8) for _ in range(5)]
    boxes, labels = _boxes(5, seed=9, empty=(1,))

    def graph(fn, types):
        return tuple(fn.ssd_random_crop(_source(fn, images, layout="HWC"), _source(fn, boxes),
                                        _source(fn, labels), num_attempts=3))

    _assert_equal(*_run_both(graph, iters=3, batch=5))


@pytest.mark.parametrize("layout", ["xy", "xyz", "x", "yx"])
def test_coord_flip_cpu(layout):
    rng = np.random.default_rng(10)
    pts = [rng.uniform(0, 1, (int(rng.integers(0, 7)), len(layout))).astype(np.float32)
           for _ in range(6)]

    def graph(fn, types):
        p = _source(fn, pts)
        return (fn.coord_flip(p, layout=layout, flip_x=fn.random.coin_flip(probability=0.5),
                              flip_y=fn.random.coin_flip(probability=0.5), flip_z=1,
                              center_x=0.25, center_y=0.6),
                fn.coord_flip(p, layout=layout))

    _assert_equal(*_run_both(graph, batch=6))


@pytest.mark.parametrize("mode,keep_size,layout,size", [
    ("expand", False, "xyXY", None), ("fixed", True, "xyXY", None),
    ("halfway", False, "xyWH", None), ("expand", False, "xyXY", [120.0, 90.0])])
def test_bbox_rotate(mode, keep_size, layout, size):
    boxes, labels = _boxes(4, seed=11, empty=(2,))
    if layout == "xyWH":
        boxes = [np.concatenate([b[:, :2], b[:, 2:] - b[:, :2]], 1) for b in boxes]
    shapes = [np.array([100, 80], np.int32), np.array([64, 128], np.int32),
              np.array([90, 90], np.int32), np.array([50, 70], np.int32)]
    extra = {} if size is None else {"size": size}

    def graph(fn, types):
        angle = fn.random.uniform(range=[-60.0, 60.0])
        return tuple(fn.bbox_rotate(_source(fn, boxes), _source(fn, labels), angle=angle,
                                    input_shape=_source(fn, shapes), mode=mode,
                                    keep_size=keep_size, bbox_layout=layout,
                                    remove_threshold=0.3, **extra))

    _assert_equal(*_run_both(graph, iters=2))


def test_bbox_rotate_absolute_without_labels():
    boxes = [b * 100 for b in _boxes(3, seed=12)[0]]

    def graph(fn, types):
        return fn.bbox_rotate(_source(fn, boxes), angle=30.0, input_shape=[100, 100],
                              bbox_normalized=False, remove_threshold=0.0)

    _assert_equal(*_run_both(graph, iters=1, batch=3))


@pytest.mark.parametrize("form", ["in_shape", "roi_shape", "input"])
def test_roi_random_crop(form):
    shapes = [np.array([100, 80, 3], np.int64), np.array([64, 64, 3], np.int64),
              np.array([50, 120, 3], np.int64), np.array([90, 90, 3], np.int64)]
    starts = [np.array([10, 20, 0], np.int64), np.array([0, 30, 0], np.int64),
              np.array([25, 5, 0], np.int64), np.array([60, 60, 0], np.int64)]

    def graph(fn, types):
        kw = dict(crop_shape=[40, 50, 3], roi_start=_source(fn, starts))
        if form == "in_shape":
            return fn.roi_random_crop(roi_end=[70, 70, 3], in_shape=_source(fn, shapes), **kw)
        if form == "roi_shape":
            return fn.roi_random_crop(roi_shape=[20, 10, 3], **kw)
        return fn.roi_random_crop(_source(fn, shapes), roi_shape=[30, 30, 3], **kw)

    _assert_equal(*_run_both(graph, iters=2))


def test_random_crop_generator():
    shapes = [np.array([100, 80], np.int64), np.array([64, 300], np.int64),
              np.array([480, 640], np.int64), np.array([2, 2], np.int64)]

    def graph(fn, types):
        s = _source(fn, shapes)
        return (tuple(fn.random_crop_generator(s)) + tuple(fn.random_crop_generator(
            s, random_area=[0.5, 0.9], random_aspect_ratio=[0.5, 2.0], num_attempts=3)))

    _assert_equal(*_run_both(graph, iters=2))


# ---------------------------------------------------------------- segmentation

def _masks(n=4, seed=13, shape=(24, 32)):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        m = np.zeros(shape, np.int32)
        for _ in range(int(rng.integers(0 if i == 1 else 1, 5))):
            y, x = rng.integers(0, shape[0] - 4), rng.integers(0, shape[1] - 4)
            m[y:y + int(rng.integers(2, 8)), x:x + int(rng.integers(2, 8))] = rng.integers(1, 4)
        out.append(m)
    return out


@pytest.mark.parametrize("kw", [{}, {"foreground": 1}, {"foreground": 1, "value": 2},
                                {"foreground": 1, "threshold": 1.5}], ids=str)
def test_random_mask_pixel(kw):
    masks = _masks()

    def graph(fn, types):
        return fn.segmentation.random_mask_pixel(_source(fn, masks), **kw)

    _assert_equal(*_run_both(graph, iters=3))


@pytest.mark.parametrize("kw", [
    {}, {"format": "start_end"}, {"format": "box", "output_class": True},
    {"by_instance": True}, {"classes": [2, 3], "output_class": True},
    {"k_largest": 1, "by_instance": True}, {"ignore_class": True, "k_largest": 2},
    {"foreground_prob": 0.5, "cache_objects": True}], ids=str)
def test_random_object_bbox(kw):
    masks = _masks(seed=14)

    def graph(fn, types):
        return fn.segmentation.random_object_bbox(_source(fn, masks), **kw)

    _assert_equal(*_run_both(graph, iters=3))


@pytest.mark.parametrize("reindex", [False, True])
def test_select_masks(reindex):
    rng = np.random.default_rng(15)
    polys, verts, ids = [], [], []
    for i in range(4):
        counts = rng.integers(3, 6, 5)
        ends = np.cumsum(counts)
        polys.append(np.stack([np.arange(5), ends - counts, ends], 1).astype(np.int32))
        verts.append(rng.uniform(0, 1, (int(ends[-1]), 2)).astype(np.float32))
        ids.append(np.array([] if i == 2 else [4, 1] if i else [0, 3, 2], np.int32))

    def graph(fn, types):
        return tuple(fn.segmentation.select_masks(_source(fn, ids), _source(fn, polys),
                                                  _source(fn, verts), reindex_masks=reindex))

    _assert_equal(*_run_both(graph, iters=1))


# ---------------------------------------------------------------- readers.COCO

@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """A 64-entry annotation file over the corpus (seed 5)."""
    path = tmp_path_factory.mktemp("coco") / "annotations.json"
    path.write_text(json.dumps(make_annotations(5, n_images=64)))
    return str(path)


COCO_MODES = {
    "plain": {},
    "ltrb_ratio": dict(ltrb=True, ratio=True),
    "polygons": dict(polygon_masks=True, ratio=True, image_ids=True),
    "legacy_masks": dict(masks=True),
    "skip_empty": dict(skip_empty=True, image_ids=True),
    "class_ids": dict(avoid_class_remapping=True, include_iscrowd=False),
    "threshold": dict(size_threshold=20.0, ltrb=True),
    "shuffled": dict(random_shuffle=True, initial_fill=16, image_ids=True),
}


@pytest.mark.parametrize("mode", sorted(COCO_MODES))
def test_coco_reader(coco, mode):
    def graph(fn, types):
        return tuple(fn.readers.coco(file_root=CORPUS, annotations_file=coco, name="Reader",
                                     **COCO_MODES[mode]))

    _assert_equal(*_run_both(graph, iters=3, batch=8))


def test_coco_reader_skip_empty_and_class_remapping(coco, tmp_path):
    """skip_empty drops the entries without boxes (here three emptied ones
    and those whose boxes are all under size_threshold); labels are 1-based
    contiguous by default and the COCO ids with avoid_class_remapping."""
    doc = json.load(open(coco))
    emptied = {im["id"] for im in doc["images"][:3]}
    doc["annotations"] = [a for a in doc["annotations"] if a["image_id"] not in emptied]
    coco = str(tmp_path / "annotations.json")
    with open(coco, "w") as f:
        json.dump(doc, f)
    cats = sorted(c["id"] for c in doc["categories"])
    kept = {a["image_id"] for a in doc["annotations"] if min(a["bbox"][2:]) >= 0.1}
    assert len(kept) <= len(doc["images"]) - 3

    def graph(fn, types):
        _, _, a = fn.readers.coco(file_root=CORPUS, annotations_file=coco, skip_empty=True,
                                  name="Reader")
        _, _, b = fn.readers.coco(file_root=CORPUS, annotations_file=coco, skip_empty=True,
                                  avoid_class_remapping=True)
        return a, b

    pipe = _build(dali_tpu_torch, graph, batch=len(kept))
    try:
        assert pipe.reader_meta("Reader")["epoch_size"] == len(kept)
        remapped, original = pipe.run()
        for i in range(len(kept)):
            assert remapped.at(i).size > 0
            np.testing.assert_array_equal(
                remapped.at(i), [cats.index(c) + 1 for c in original.at(i)])
    finally:
        pipe.shutdown()


@pytest.mark.parametrize("pad_last_batch", [False, True])
def test_coco_reader_shards_cover_the_dataset(coco, pad_last_batch):
    n = len(json.load(open(coco))["images"])
    seen, shards = [], 3
    for shard in range(shards):
        def graph(fn, types, shard=shard):
            return fn.readers.coco(file_root=CORPUS, annotations_file=coco, image_ids=True,
                                   shard_id=shard, num_shards=shards, stick_to_shard=True,
                                   pad_last_batch=pad_last_batch, name="Reader")[3]

        for pkg in (dali_tpu_torch, dali_tpu):
            pipe = _build(pkg, graph, batch=5)
            try:
                ids = [int(s[0]) for _ in range(5) for s in _samples(pipe.run())[0]]
            finally:
                _close(pipe)
            if pkg is dali_tpu_torch:
                port_ids = ids
            else:
                assert ids == port_ids
        lo, hi = shard * n // shards, (shard + 1) * n // shards
        seen += port_ids[:hi - lo]
    assert sorted(seen) == sorted(im["id"] for im in json.load(open(coco))["images"])


def test_coco_preprocessed_annotations_round_trip(coco, tmp_path):
    """The port saves the index, then reads it instead of the JSON; the
    reference reads the port's file and the port reads the reference's."""
    kw = dict(file_root=CORPUS, ltrb=True, ratio=True, polygon_masks=True, image_ids=True)

    def saving(fn, types, where):
        return tuple(fn.readers.coco(annotations_file=coco, save_preprocessed_annotations=True,
                                     save_preprocessed_annotations_dir=where, **kw))

    def loading(fn, types, where):
        return tuple(fn.readers.coco(preprocessed_annotations=where, **kw))

    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    want = None
    for pkg, where in ((dali_tpu_torch, port_dir), (dali_tpu, ref_dir)):
        pipe = _build(pkg, lambda fn, t: saving(fn, t, where))
        try:
            got = [_samples(pipe.run())]
        finally:
            _close(pipe)
        if want is None:
            want = got
        _assert_equal(got, want)
    for where in (port_dir, ref_dir):
        for pkg in (dali_tpu_torch, dali_tpu):
            pipe = _build(pkg, lambda fn, t: loading(fn, t, where))
            try:
                _assert_equal([_samples(pipe.run())], want)
            finally:
                _close(pipe)


def test_coco_checkpoint_from_dali_tpu_resumes_in_port(coco):
    def graph(fn, types):
        return tuple(fn.readers.coco(file_root=CORPUS, annotations_file=coco, ltrb=True,
                                     ratio=True, random_shuffle=True, image_ids=True,
                                     name="Reader"))

    ref = _build(dali_tpu, graph, batch=8, enable_checkpointing=True)
    try:
        ref.run()
        ckpt = ref.checkpoint()
        want = [_samples(ref.run()) for _ in range(2)]
    finally:
        _close(ref)
    port = _build(dali_tpu_torch, graph, batch=8, checkpoint=ckpt)
    try:
        _assert_equal([_samples(port.run()) for _ in range(2)], want)
    finally:
        port.shutdown()


# ---------------------------------------------------------------- not ported: raise

@pytest.mark.parametrize("kw,item", [
    (dict(ltrb=False), "Queue 3"), (dict(bbox_layout="xyWH"), "Queue 3"),
    (dict(threshold_type="overlap"), "Queue 3")], ids=["ltrb", "bbox_layout", "threshold_type"])
def test_random_bbox_crop_ignored_arguments_raise(kw, item):
    boxes, labels = _boxes(2)

    def graph(fn, types):
        return tuple(fn.random_bbox_crop(_source(fn, boxes), _source(fn, labels), **kw))

    with pytest.raises(NotImplementedError, match=f"ROADMAP.md, {item}"):
        _build(dali_tpu_torch, graph, batch=2)


def test_coco_pixelwise_masks_raise(coco):
    def graph(fn, types):
        return tuple(fn.readers.coco(file_root=CORPUS, annotations_file=coco,
                                     pixelwise_masks=True))

    with pytest.raises(NotImplementedError, match=r"cv2.fillPoly; see ROADMAP.md, Queue 1 item 0"):
        _build(dali_tpu_torch, graph, batch=2)


# ---------------------------------------------------------------- gpu operators (torch CPU)

def _close_gpu(port, ref, atol):
    for it_p, it_r in zip(port, ref):
        for out_p, out_r in zip(it_p, it_r):
            for a, b in zip(out_p, out_r):
                assert a.shape == b.shape and a.dtype == b.dtype
                if np.issubdtype(a.dtype, np.integer):
                    np.testing.assert_array_equal(a, b)
                else:
                    np.testing.assert_allclose(a, b, rtol=0, atol=atol)


@pytest.mark.parametrize("ltrb", [True, False])
def test_bb_flip_gpu(ltrb):
    boxes, _ = _boxes(6, seed=16, empty=(1,))

    def graph(fn, types):
        b = _source(fn, boxes).gpu()
        return (fn.bb_flip(b, ltrb=ltrb, horizontal=fn.random.coin_flip(probability=0.5),
                           vertical=fn.random.coin_flip(probability=0.5)),
                fn.bb_flip(b, ltrb=ltrb, vertical=1))

    _close_gpu(*_run_both(graph, batch=6), BOX_ATOL)


@pytest.mark.parametrize("layout", ["xy", "xyz"])
def test_coord_flip_gpu(layout):
    rng = np.random.default_rng(18)
    pts = [rng.uniform(0, 1, (int(rng.integers(1, 7)), len(layout))).astype(np.float32)
           for _ in range(5)]

    def graph(fn, types):
        return fn.coord_flip(_source(fn, pts).gpu(), layout=layout,
                             flip_y=fn.random.coin_flip(probability=0.5), center_x=0.3)

    _close_gpu(*_run_both(graph, batch=5), BOX_ATOL)


@pytest.mark.parametrize("offset", [False, True])
def test_box_encoder_gpu(offset):
    """Ragged boxes (counts 0-8) cross .gpu() onto a padded canvas; the
    padded rows stay out of the match."""
    boxes, labels = _boxes(6, seed=19, empty=(2,))
    anchors = bench_ssd.dboxes300_coco()[::5]
    extra = dict(offset=True, means=[0.0, 0.0, 0.0, 0.0], stds=[0.1, 0.1, 0.2, 0.2],
                 scale=1.0) if offset else {}

    def graph(fn, types):
        return tuple(fn.box_encoder(_source(fn, boxes).gpu(), _source(fn, labels).gpu(),
                                    anchors=anchors.reshape(-1).tolist(), criteria=0.5, **extra))

    port, ref = _run_both(graph, iters=1, batch=6)
    _close_gpu(port, ref, OFFSET_ATOL if offset else BOX_ATOL)
    assert sum(int((s > 0).sum()) for s in port[0][1]) > 6  # the batch matched boxes


def test_box_encoder_gpu_matches_cpu_over_chunks(monkeypatch):
    """The port's gpu encoder in chunks of one sample (forced by a small
    chunk budget) against encode_boxes per sample, with boxes that tie on
    their best anchor; and a batch in which no sample has a box."""
    anchors = bench_ssd.dboxes300_coco()
    boxes, labels = _boxes(5, seed=20, empty=(0,))
    boxes[3] = np.concatenate([boxes[3], boxes[3][:2]])  # duplicates claim the same anchor
    labels[3] = np.concatenate([labels[3], labels[3][:2] + 100])
    monkeypatch.setattr(generic_gpu, "IOU_CHUNK_BYTES", 1)
    empty = ([b[:0] for b in boxes], [lb[:0] for lb in labels])
    for data, labs in ((boxes, labels), empty):
        def graph(fn, types):
            return tuple(fn.box_encoder(_source(fn, data).gpu(), _source(fn, labs).gpu(),
                                        anchors=anchors.reshape(-1).tolist(), criteria=0.5))

        pipe = _build(dali_tpu_torch, graph, batch=5)
        try:
            eb, el = pipe.run()
        finally:
            pipe.shutdown()
        for i in range(5):
            want_b, want_l = encode_boxes(data[i], labs[i], anchors, 0.5, False, [0] * 4, [1] * 4,
                                          1.0)
            np.testing.assert_array_equal(el.at(i), want_l)
            np.testing.assert_array_equal(eb.at(i), want_b)


# ---------------------------------------------------------------- the SSD recipe

SSD_SIZE, SSD_BATCH = 96, 8


def _ssd_ref(coco, anchors):
    """docs/examples/ssd_detection.py's graph in dali_tpu, at SSD_SIZE."""
    def graph(fn, types):
        jpegs, bboxes, labels = fn.readers.coco(
            file_root=CORPUS, annotations_file=coco, ltrb=True, ratio=True, random_shuffle=True,
            name="Reader")
        crop_begin, crop_size, bboxes, labels = fn.random_bbox_crop(
            bboxes, labels, aspect_ratio=[0.5, 2.0], thresholds=[0.0, 0.1, 0.3, 0.5, 0.7, 0.9],
            scaling=[0.3, 1.0], allow_no_crop=True, num_attempts=4)
        images = fn.decoders.image_slice(jpegs, crop_begin, crop_size, device="cpu")
        images = fn.resize(images.gpu(), resize_x=SSD_SIZE, resize_y=SSD_SIZE)
        flip = fn.random.coin_flip(probability=0.5)
        bboxes = fn.bb_flip(bboxes, horizontal=flip, ltrb=True)
        images = fn.crop_mirror_normalize(images, mirror=flip, dtype=types.FLOAT,
                                          output_layout="CHW", mean=MEAN, std=STD)
        enc_boxes, enc_labels = fn.box_encoder(bboxes, labels, anchors=anchors.reshape(-1),
                                               criteria=0.5)
        return images, enc_boxes, enc_labels, bboxes, labels

    return _build(dali_tpu, graph, batch=SSD_BATCH, seed=42)


def test_ssd_recipe_matches_dali_tpu(coco):
    anchors = bench_ssd.dboxes300_coco()
    ref = _ssd_ref(coco, anchors)
    port = bench_ssd.make_pipe(coco, SSD_BATCH, "cpu", "ssd_train", size=SSD_SIZE,
                               with_boxes=True, num_threads=1)
    port.build()
    try:
        for _ in range(2):
            got, want = port.run(), ref.run()
            img_g = got[0].as_tensor().numpy()
            img_w = np.asarray(want[0].as_tensor())
            assert img_g.shape == img_w.shape == (SSD_BATCH, 3, SSD_SIZE, SSD_SIZE)
            diff = np.abs(img_g - img_w)
            assert diff.max() <= LSB and (diff > 1e-4).mean() <= MAX_FLIP_FRACTION
            g, w = _samples(got[1:]), _samples(want[1:])
            _assert_equal([g[1:]], [w[1:]])  # encoded labels, flipped boxes, labels
            for a, b in zip(g[0], w[0]):
                np.testing.assert_allclose(a, b, rtol=0, atol=BOX_ATOL)
    finally:
        port.shutdown()
        _close(ref)


def test_ssd_device_encode_matches_cpu_encoder(coco):
    """The device-encode form's gpu BbFlip and BoxEncoder (plain PyTorch
    here) against encode_boxes on the boxes they received."""
    anchors = bench_ssd.dboxes300_coco()
    pipe = bench_ssd.make_pipe(coco, SSD_BATCH, "cpu", "ssd_device_encode", size=SSD_SIZE,
                               with_boxes=True, num_threads=1)
    pipe.build()
    try:
        for _ in range(2):
            images, eb, el, boxes, labels = pipe.run()
            assert bool(torch.isfinite(images.as_tensor()).all())
            for i in range(SSD_BATCH):
                want_b, want_l = encode_boxes(boxes.at(i), labels.at(i), anchors, 0.5, False,
                                              [0] * 4, [1] * 4, 1.0)
                np.testing.assert_array_equal(el.at(i), want_l)
                np.testing.assert_array_equal(eb.at(i), want_b)
    finally:
        pipe.shutdown()


def test_iterator_yields_dense_encoder_outputs(coco):
    """DALIGenericIterator: the images on the pipeline's device, the host
    encoder's outputs as CPU tensors [N, 8732, 4] float32 / [N, 8732] int32;
    the device encoder's as dense device tensors of the same shapes."""
    for form in bench_ssd.FORMS:
        pipe = bench_ssd.make_pipe(coco, 4, "cpu", form, size=64, num_threads=1)
        pipe.build()
        try:
            batch = next(DALIGenericIterator(pipe, ["images", "bboxes", "labels"]))
            out = batch[0]
            assert tuple(out["images"].shape) == (4, 3, 64, 64)
            assert tuple(out["bboxes"].shape) == (4, 8732, 4)
            assert out["bboxes"].dtype == torch.float32
            assert tuple(out["labels"].shape) == (4, 8732) and out["labels"].dtype == torch.int32
        finally:
            pipe.shutdown()


def test_annotation_file_shape():
    """The generated annotation file follows COCO train2017's shape."""
    doc = make_annotations(0)
    counts = {}
    for a in doc["annotations"]:
        counts[a["image_id"]] = counts.get(a["image_id"], 0) + 1
    per_image = [counts.get(im["id"], 0) for im in doc["images"]]
    assert len(doc["images"]) == 256 == len({im["id"] for im in doc["images"]})
    assert 5.5 <= np.mean(per_image) <= 9 and max(per_image) <= 50
    assert 0 < per_image.count(0) <= 16
    assert any(a["iscrowd"] for a in doc["annotations"])
    assert any(a["bbox"][2] < 0.1 for a in doc["annotations"])
    assert len(bench_ssd.dboxes300_coco()) == 8732
    assert os.path.isdir(CORPUS)
