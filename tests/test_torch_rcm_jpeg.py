"""The rn50_rcm_jpeg path of dali_tpu_torch on the CPU against dali_tpu.

``tools/bench_rcm_jpeg.py`` builds the graph node for node in either
package: rn50_val's hybrid decode at scale 1, FastResizeCropMirror with a
random crop position and a coin-flip mirror, JpegCompressionDistortion at a
random quality in [30, 95], and CMN to normalised float CHW. Here at batch 4
and a narrow width (resize_shorter 80, crop 64), against dali_tpu with
``debug=True``: labels and host draws equal; the resized images within one
uint8 step on at most 1e-3 of values; the distorted images differ in at most
1e-3 of their 8x8 blocks; the normalised images within one step / std where
the distorted pixels agree.
"""

import numpy as np
import torch

import chip_smoke
import dali_tpu
import dali_tpu_torch
from dali_tpu_torch.tools import bench_rcm_jpeg

NAMES = bench_rcm_jpeg.OUTPUTS + bench_rcm_jpeg.EXTRAS


def _run(pkg, file_list, batch=4, iterations=2, **kw):
    if pkg is dali_tpu_torch:
        kw.setdefault("device", "cpu")
    else:
        kw.setdefault("debug", True)

    @pkg.pipeline_def(batch_size=batch, num_threads=2, seed=42, **kw)
    def rn50_rcm_jpeg():
        return bench_rcm_jpeg.rcm_jpeg_graph(pkg.fn, pkg.types, file_list, shorter=80, crop=64,
                                             extras=True)

    pipe = rn50_rcm_jpeg()
    pipe.build()
    try:
        res = []
        for _ in range(iterations):
            outs = []
            for tl in pipe.run():
                tl = tl.as_cpu() if hasattr(tl, "as_cpu") else tl
                outs.append(np.stack([np.asarray(tl.at(i)) for i in range(len(tl))]))
            res.append(dict(zip(NAMES, outs)))
        return res
    finally:
        if pkg is dali_tpu_torch:
            pipe.shutdown()
        else:
            pipe._executor.shutdown()


def test_rn50_rcm_jpeg_matches_dali_tpu():
    file_list = chip_smoke.write_file_list()
    lsb = 1.0 / min(bench_rcm_jpeg.STD) + 1e-4
    got, want = _run(dali_tpu_torch, file_list), _run(dali_tpu, file_list)
    for g, w in zip(got, want):
        for k in ("label", "quality", "crop_x", "crop_y", "mirror"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
        assert g["resized"].shape == (4, 64, 64, 3) and g["resized"].dtype == np.uint8
        d = np.abs(g["resized"].astype(np.int32) - w["resized"].astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3
        share, worst = bench_rcm_jpeg.block_diff(zip(g["distorted"], w["distorted"]))
        assert share <= bench_rcm_jpeg.BLOCK_SHARE_MAX, (share, worst)
        same = (g["distorted"] == w["distorted"]).all(-1)[:, None]
        assert g["data"].shape == (4, 3, 64, 64) and g["data"].dtype == np.float32
        assert (np.abs(g["data"] - w["data"]) * same).max() <= lsb
        assert ((g["quality"] >= 30) & (g["quality"] < 95)).all()


def test_rn50_rcm_jpeg_on_the_cpu_is_deterministic():
    """On the CPU at batch 8: the distortion changes every image, and the
    same seed through ``make_pipe`` gives bit-identical outputs."""
    file_list = chip_smoke.write_file_list()
    run = _run(dali_tpu_torch, file_list, batch=8, iterations=1)[0]
    for r, d in zip(run["resized"], run["distorted"]):
        assert np.abs(r.astype(np.int32) - d.astype(np.int32)).mean() > 0
    assert set(np.unique(run["mirror"])) <= {0, 1}
    pipe = bench_rcm_jpeg.make_pipe(file_list, 8, "cpu", shorter=80, crop=64, extras=True,
                                    num_threads=2)
    try:
        again = dict(zip(NAMES, [o.as_tensor() for o in pipe.run()]))
    finally:
        pipe.shutdown()
    for k in NAMES:
        assert torch.equal(again[k], torch.as_tensor(run[k])), k
