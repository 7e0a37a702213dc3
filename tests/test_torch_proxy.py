"""The DataLoader proxy (``dali_tpu_torch.plugin.proxy``) against
``dali_tpu.plugin.proxy`` on the CPU: the cases of
``tests/test_pytorch_proxy.py`` (workers 0 and 2, name discovery, an
oversized batch), outputs equal to the reference's for the same dataset and
seed with a partial last batch, dict and namedtuple samples, workers forked
after the pipeline has run and workers started by ``spawn``.

Contract: the same batches in the same order; host draws (the coin flip)
bit-equal; the CMN on the device placement (the port's plain version, the
reference's JAX lowering) within 1e-6."""

import collections

import numpy as np
import pytest
import torch

import dali_tpu
import dali_tpu_torch
from dali_tpu.plugin import proxy as ref_proxy
from dali_tpu_torch.plugin import proxy as port_proxy

Sample = collections.namedtuple("Sample", ["image", "label"])


class _DS(torch.utils.data.Dataset):
    """Sample ``i``: an [8, 6, 3] image of value ``i + x`` at column ``x``
    through the proxy, and ``i``; as a tuple, a dict or a namedtuple."""

    def __init__(self, transform, n=10, form="tuple"):
        self.t = transform
        self.n = n
        self.form = form

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        img = (np.full((8, 6, 3), i) + np.arange(6)[None, :, None]).astype(np.uint8)
        if self.form == "dict":
            return {"image": self.t(img), "label": i}
        if self.form == "namedtuple":
            return Sample(self.t(img), i)
        return self.t(img), i


def _pipe(pkg, bs, device_stage=True):
    fn, types = pkg.fn, pkg.types
    kw = {"device": "cpu"} if pkg is dali_tpu_torch else {}

    @pkg.pipeline_def(batch_size=bs, num_threads=1, seed=3, **kw)
    def p():
        images = fn.external_source(name="images", layout="HWC")
        if device_stage:
            images = images.gpu()
        return fn.crop_mirror_normalize(
            images, dtype=types.FLOAT, output_layout="CHW", mean=[1.0, 2.0, 3.0],
            std=[1.0, 2.0, 4.0], mirror=fn.random.coin_flip(seed=5))

    return p()


def _epoch(proxy_mod, pkg, bs=4, n=10, form="tuple", epochs=1, **loader_kw):
    """The batches of ``epochs`` passes over ``_DS`` as numpy arrays."""
    out = []
    with proxy_mod.DALIServer(_pipe(pkg, bs)) as server:
        ds = _DS(server.proxy, n=n, form=form)
        loader = proxy_mod.DataLoader(server, ds, batch_size=bs, **loader_kw)
        for _ in range(epochs):
            for batch in loader:
                if form == "dict":
                    data, labels = batch["image"], batch["label"]
                else:
                    data, labels = batch
                    if form == "namedtuple" and proxy_mod is port_proxy:
                        assert isinstance(batch, Sample)
                assert isinstance(data, torch.Tensor) and data.device.type == "cpu"
                out.append((data.numpy().copy(), labels.numpy().copy()))
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gd, gl), (wd, wl) in zip(got, want):
        np.testing.assert_array_equal(gl, wl)
        assert gd.shape == wd.shape and gd.dtype == wd.dtype
        np.testing.assert_allclose(gd, wd, rtol=0, atol=1e-6)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_dali_proxy_dataloader(num_workers):
    """The reference test's loop: every sample once, the partial last batch
    trimmed, each image's value its label; equal to dali_tpu's batches."""
    got = _epoch(port_proxy, dali_tpu_torch, num_workers=num_workers)
    seen = 0
    for data, labels in got:
        n = labels.shape[0]
        assert data.shape == (n, 3, 8, 6)
        for j in range(n):  # channel 0: (i + x - 1) / 1, mirrored or not
            assert data[j, 0].mean() == float(labels[j]) + 2.5 - 1.0
        seen += n
    assert seen == 10 and [len(lb) for _, lb in got] == [4, 4, 2]
    _assert_same(got, _epoch(ref_proxy, dali_tpu, num_workers=num_workers))


def test_dali_proxy_discovers_input_names():
    server = port_proxy.DALIServer(_pipe(dali_tpu_torch, 2))
    assert server.proxy._input_names == ["images"]


def test_dali_proxy_discovery_skips_sourced_inputs():
    fn = dali_tpu_torch.fn

    @dali_tpu_torch.pipeline_def(batch_size=2, num_threads=1, device="cpu")
    def p():
        a = fn.external_source(name="fed")
        b = fn.external_source(source=lambda: [np.zeros(2, np.uint8)] * 2, batch=True,
                               name="sourced")
        return a, b

    assert port_proxy.DALIServer(p()).proxy._input_names == ["fed"]
    with pytest.raises(ValueError, match="proxy expects 1 inputs"):
        port_proxy.DALIServer(p()).proxy(1, 2)


def test_dali_proxy_rejects_oversized_batch():
    with port_proxy.DALIServer(_pipe(dali_tpu_torch, 2)) as server:
        loader = port_proxy.DataLoader(server, _DS(server.proxy, n=6), batch_size=4)
        with pytest.raises(ValueError, match="exceeds pipeline batch size"):
            next(iter(loader))


@pytest.mark.parametrize("form", ["dict", "namedtuple"])
def test_dict_and_namedtuple_samples(form):
    """Samples as dicts and namedtuples collate per field; the proxy field
    becomes the pipeline's output (a namedtuple stays one)."""
    got = _epoch(port_proxy, dali_tpu_torch, n=7, form=form)
    assert [len(lb) for _, lb in got] == [4, 3]
    _assert_same(got, _epoch(ref_proxy, dali_tpu, n=7, form=form))


def test_fork_after_the_pipeline_ran():
    """Two epochs with forked workers: the second epoch's workers fork while
    the pipeline's executor threads are running; both epochs run."""
    got = _epoch(port_proxy, dali_tpu_torch, n=9, epochs=2, num_workers=2)
    assert [len(lb) for _, lb in got] == [4, 4, 1, 4, 4, 1]
    np.testing.assert_array_equal(np.concatenate([lb for _, lb in got]),
                                  np.concatenate([np.arange(9)] * 2))


def test_spawn_workers():
    """Workers started by ``spawn`` unpickle the dataset, the proxy and the
    collate function."""
    got = _epoch(port_proxy, dali_tpu_torch, n=6, num_workers=1,
                 multiprocessing_context="spawn")
    _assert_same(got, _epoch(port_proxy, dali_tpu_torch, n=6))


def test_ragged_outputs_trim_per_sample():
    """Samples of different sizes: a list of per-sample tensors cropped to
    their shapes, the padded tail trimmed."""
    fn = dali_tpu_torch.fn

    @dali_tpu_torch.pipeline_def(batch_size=4, num_threads=1, device="cpu")
    def p():
        x = fn.external_source(name="x")
        return x.gpu() * 2, x

    with port_proxy.DALIServer(p()) as server:
        items = [(server.proxy(np.full((k + 1, 2), k, np.int32)),) for k in range(3)]
        dev, host = server.produce_data(port_proxy._Collate(None)(items))[0]
    for outs in (dev, host):
        assert isinstance(outs, list) and len(outs) == 3
    for k in range(3):
        np.testing.assert_array_equal(dev[k].numpy(), np.full((k + 1, 2), 2 * k))
        np.testing.assert_array_equal(host[k].numpy(), np.full((k + 1, 2), k))
