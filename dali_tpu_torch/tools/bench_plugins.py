"""The two ways users drive a pipeline from outside the port's own
iterators, timed on the card at full width (batch 256, 224x224):

- ``rn50_dataloader_proxy``: a PyTorch training loop that keeps its own
  ``DataLoader`` (``plugin.proxy``). A ``Dataset`` over the 32-file corpus
  repeated to 1,024 samples returns ``(server.proxy(jpeg bytes), label)``;
  ``proxy.DataLoader(server, ds, batch_size=256, num_workers=host cores - 1,
  persistent_workers=True)`` collates them in worker processes forked after
  the pipeline has built; the pipeline is rn50_parallel_es's graph
  (``bench_parallel_es.py``) fed by ``fn.external_source(name="jpegs")``:
  ``decoders.image_random_crop(device="mixed", hybrid_device_decode=True,
  hybrid_scale=2)``, resize 224, coin-flip CMN to FLOAT CHW.
- ``rn50_capi_serve``: the inference preprocessing Triton's DALI backend
  runs: rn50_val's recipe fed from ``fn.external_source(name="DALI_INPUT_0")``
  (the hybrid decode at ``hybrid_scale=1`` on the int8 wire,
  ``resize(resize_shorter=256)``, CMN crop 224 FLOAT CHW), written by
  ``plugin.triton.save_model_repo`` to ``build/model_repo/rn50/1/model.dali``
  and served through the C API (``capi/``, ``libdali_tpu_torch_c.so``):
  each batch of 256 encoded JPEGs fed with ``daliTpuFeedInput``, run, and
  every output sample copied out with ``daliTpuCopyOutputSample`` (the
  device-to-host copy of the outputs is the C API's contract and is timed).
  The timed runs call the library through ctypes in this process; then a C
  client (``capi/test_capi.c --serve``) serves one batch as a subprocess,
  bit-equal to the same document run by ``Pipeline.deserialize`` in Python.

``chip_smoke.py`` runs them as its phases 34 and 35;

    python dali_tpu_torch/tools/bench_plugins.py [--form rn50_dataloader_proxy] [--timed 10]

times one form on the card and prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

MEAN = [0.485 * 255, 0.456 * 255, 0.406 * 255]
STD = [0.229 * 255, 0.224 * 255, 0.225 * 255]
SIZE = 224
FORMS = ("rn50_dataloader_proxy", "rn50_capi_serve")
SAMPLES = 1024
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CORPUS = os.path.join(ROOT, "dali_tpu_torch", "testdata", "rn50")
INPUT = "DALI_INPUT_0"


def corpus():
    """[(JPEG bytes, label)] of the 32-file corpus, in file-list order."""
    files = sorted(os.path.join(c, f) for c in sorted(os.listdir(CORPUS))
                   for f in sorted(os.listdir(os.path.join(CORPUS, c))))
    out = []
    for f in files:
        with open(os.path.join(CORPUS, f), "rb") as fh:
            out.append((fh.read(), int(f.split(os.sep)[0][len("class"):])))
    return out


class ProxyDataset(torch.utils.data.Dataset):
    """The corpus repeated to ``n`` samples: ``(proxy(jpeg), label)``."""

    def __init__(self, proxy, samples, n=SAMPLES):
        self.proxy, self.samples, self.n = proxy, samples, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        data, label = self.samples[i % len(self.samples)]
        return self.proxy(np.frombuffer(data, np.uint8)), label


def make_proxy_pipe(batch, device):
    from dali_tpu_torch import fn, pipeline_def, types

    @pipeline_def(batch_size=batch, num_threads=os.cpu_count() or 1, seed=42,
                  prefetch_queue_depth=2, device=device)
    def rn50_dataloader_proxy():
        jpegs = fn.external_source(name="jpegs")
        images = fn.decoders.image_random_crop(jpegs, device="mixed", hybrid_device_decode=True,
                                               hybrid_scale=2)
        images = fn.resize(images, resize_x=SIZE, resize_y=SIZE)
        mirror = fn.random.coin_flip(probability=0.5)
        return fn.crop_mirror_normalize(images, mirror=mirror, dtype=types.FLOAT,
                                        output_layout="CHW", mean=MEAN, std=STD)

    return rn50_dataloader_proxy()


def make_serve_pipe(batch, device):
    from dali_tpu_torch import fn, pipeline_def, types

    @pipeline_def(batch_size=batch, num_threads=os.cpu_count() or 1, seed=42,
                  prefetch_queue_depth=2, device=device)
    def rn50_capi_serve():
        jpegs = fn.external_source(name=INPUT, dtype=types.UINT8, ndim=1)
        images = fn.decoders.image(jpegs, device="mixed", hybrid_device_decode=True,
                                   hybrid_scale=1, hybrid_wire="int8")
        images = fn.resize(images, resize_shorter=256, interp_type=types.INTERP_TRIANGULAR)
        return fn.crop_mirror_normalize(images, crop=(SIZE, SIZE), dtype=types.FLOAT,
                                        output_layout="CHW", mean=MEAN, std=STD)

    return rn50_capi_serve()


def check_images(images, batch, device):
    if not (images.device.type == device.type and images.dtype == torch.float32
            and tuple(images.shape) == (batch, 3, SIZE, SIZE)):
        raise AssertionError(f"images {tuple(images.shape)} {images.dtype} on {images.device}")
    if not bool(torch.isfinite(images).all()):
        raise AssertionError("non-finite values in a batch")


def _batches(loader):
    """The loader's batches, epoch after epoch."""
    while True:
        yield from loader


def proxy_batches(batch, device, n, workers=None):
    """``n`` batches (images, labels) of the proxy path on ``device``."""
    from dali_tpu_torch.plugin import proxy

    pipe = make_proxy_pipe(batch, device)
    workers = max(1, (os.cpu_count() or 2) - 1) if workers is None else workers
    out = []
    with proxy.DALIServer(pipe) as server:
        ds = ProxyDataset(server.proxy, corpus())
        loader = proxy.DataLoader(server, ds, batch_size=batch, num_workers=workers,
                                  persistent_workers=workers > 0)
        for images, labels in _batches(loader):
            check_images(images, batch, pipe.device)
            out.append((images, labels))
            if len(out) == n:
                break
        del loader
    pipe.shutdown()
    return out


def measure_proxy(batch=256, warmup=3, timed=10):
    """The proxy path on the card: ``warmup`` + ``timed`` batches, each
    checked; the CMN launch count set to 0 just before them must equal the
    batches run. Then one more batch with its CMN call recorded: the kernel
    held against its plain version on it and timed on it."""
    from dali_tpu_torch.kernels import cmn
    from dali_tpu_torch.plugin import proxy
    from dali_tpu_torch.tools import bench_ssd

    pipe = make_proxy_pipe(batch, "cuda:0")
    workers = max(1, (os.cpu_count() or 2) - 1)
    with proxy.DALIServer(pipe) as server:
        ds = ProxyDataset(server.proxy, corpus())
        loader = proxy.DataLoader(server, ds, batch_size=batch, num_workers=workers,
                                  persistent_workers=True)
        run_s = [0.0]
        run_batch = server._run_proxy_batch

        def timed_run(pb):
            t = time.perf_counter()
            try:
                return run_batch(pb)
            finally:
                run_s[0] += time.perf_counter() - t

        server._run_proxy_batch = timed_run
        ex = pipe.executor
        cmn.COUNTER.launches = 0
        it = _batches(loader)
        for _ in range(warmup):
            images, labels = next(it)
            check_images(images, batch, pipe.device)
        torch.cuda.synchronize()
        st0 = dict(ex.stats)
        run_s[0] = 0.0
        t0 = time.perf_counter()
        for _ in range(timed):
            images, labels = next(it)
            check_images(images, batch, pipe.device)
            if tuple(labels.shape) != (batch,):
                raise AssertionError(f"labels {tuple(labels.shape)}")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        st = {k: v - st0[k] for k, v in ex.stats.items()}
        launches = cmn.COUNTER.launches
        if launches != warmup + timed:
            raise AssertionError(f"rn50_dataloader_proxy: CMN kernel launched {launches} times "
                                 f"for {warmup + timed} batches")
        with bench_ssd.recording_cmn([]) as calls:
            next(it)
        del it, loader  # the persistent workers stop with their loader
    pipe.shutdown()
    held = dict(bench_ssd.time_cmn(calls[0]), max_abs_err=bench_ssd.hold_cmn(calls[0]))
    return {"form": "rn50_dataloader_proxy", "batch": batch, "timed": timed, "workers": workers,
            "images_per_s": timed * batch / dt,
            "host_ms_per_batch": 1e3 * st["host_phase_seconds"] / st["host_batches"],
            "run_ms_per_batch": 1e3 * run_s[0] / timed,
            "loader_wait_ms_per_batch": 1e3 * (dt - run_s[0]) / timed,
            "cmn_launches": launches, "cmn": held}


def proxy_card_vs_cpu(batch=16, n=2):
    """``n`` batches of the proxy path on the card and on the CPU (plain
    versions): labels equal; the worst image difference and the fraction of
    values above 1e-4."""
    outs = [proxy_batches(batch, torch.device(d), n, workers=0) for d in ("cuda:0", "cpu")]
    worst, frac = 0.0, 0.0
    for (gi, gl), (ci, cl) in zip(*outs):
        if not torch.equal(gl, cl):
            raise AssertionError("labels differ between card and CPU")
        d = (gi.cpu() - ci).abs()
        worst, frac = max(worst, float(d.max())), max(frac, float((d > 1e-4).float().mean()))
    return worst, frac


# -- the C API ------------------------------------------------------------------------------------
def write_model(batch, repo=None):
    """``save_model_repo`` of the serving graph; the path of model.dali."""
    from dali_tpu_torch.plugin import triton

    repo = repo or os.path.join(ROOT, "build", "model_repo")
    # the document holds no device: built on the CPU, it loads on the card
    pipe = make_serve_pipe(batch, "cpu")
    mdir = triton.save_model_repo(pipe, repo, "rn50")
    pipe.shutdown()
    return os.path.join(mdir, "1", "model.dali")


def serve_inputs(batch, k):
    """Batch ``k`` of encoded JPEGs: the corpus in turn from sample
    ``k * batch``."""
    jpegs = [d for d, _ in corpus()]
    return [np.frombuffer(jpegs[(k * batch + i) % len(jpegs)], np.uint8) for i in range(batch)]


class CapiServer:
    """One pipeline of ``model.dali`` behind ``libdali_tpu_torch_c.so``,
    driven through ctypes: ``serve`` feeds a batch, runs it and copies every
    output sample into host buffers allocated once."""

    def __init__(self, lib_path, model):
        from dali_tpu_torch import capi

        self.capi = capi
        self.lib = capi.load(lib_path)
        self._ok(self.lib.daliTpuInit(), "init")
        doc = open(model, "rb").read()
        self.h = ctypes.c_void_p()
        self._ok(self.lib.daliTpuCreatePipeline(ctypes.byref(self.h), doc, len(doc)), "create")
        self.bufs = None

    def _ok(self, rc, what):
        if rc != self.capi.OK:
            raise RuntimeError(f"daliTpu {what}: {rc} {self.lib.daliTpuGetLastError()}")

    def serve(self, samples):
        n = len(samples)
        infos = (self.capi.TensorInfo * n)()
        for i, s in enumerate(samples):
            infos[i].ndim, infos[i].shape[0], infos[i].dtype, infos[i].nbytes = 1, s.size, 0, s.size
        blob = np.concatenate(samples)
        self._ok(self.lib.daliTpuFeedInput(self.h, INPUT.encode(), blob.ctypes.data, infos, n,
                                           None), "feed")
        self._ok(self.lib.daliTpuRun(self.h), "run")
        count = ctypes.c_int()
        self._ok(self.lib.daliTpuOutputCount(self.h, ctypes.byref(count)), "count")
        info = self.capi.TensorInfo()
        if self.bufs is None:
            self.bufs = []
            for o in range(count.value):
                self._ok(self.lib.daliTpuOutputInfo(self.h, o, 0, ctypes.byref(info)), "info")
                self.bufs.append(np.empty((n, info.nbytes), np.uint8))
        for o in range(count.value):
            for s in range(n):
                self._ok(self.lib.daliTpuOutputInfo(self.h, o, s, ctypes.byref(info)), "info")
                buf = self.bufs[o][s]
                self._ok(self.lib.daliTpuCopyOutputSample(self.h, o, s, buf.ctypes.data,
                                                          buf.nbytes), "copy")
        return self.bufs

    def close(self):
        self._ok(self.lib.daliTpuDestroyPipeline(self.h), "destroy")


def measure_serve(batch=256, warmup=3, timed=10):
    """rn50_capi_serve on the card: the model written, the C API built,
    ``warmup`` + ``timed`` batches served through ctypes, each output
    checked; the CMN launch count set to 0 just before them must equal the
    batches run. Then one more batch with its CMN call recorded, and the
    kernel held against its plain version on it and timed on it."""
    from dali_tpu_torch.capi import build as capi_build
    from dali_tpu_torch.kernels import cmn
    from dali_tpu_torch.tools import bench_ssd

    model = write_model(batch)
    t0 = time.perf_counter()
    lib = capi_build.build()
    build_s = time.perf_counter() - t0
    server = CapiServer(lib, model)
    inputs = [serve_inputs(batch, k) for k in range(4)]
    per_sample = 3 * SIZE * SIZE * 4
    cmn.COUNTER.launches = 0
    for k in range(warmup):
        bufs = server.serve(inputs[k % 4])
    t0 = time.perf_counter()
    for k in range(timed):
        bufs = server.serve(inputs[k % 4])
    dt = time.perf_counter() - t0
    launches = cmn.COUNTER.launches
    if launches != warmup + timed:
        raise AssertionError(f"rn50_capi_serve: CMN kernel launched {launches} times for "
                             f"{warmup + timed} batches")
    if len(bufs) != 1 or bufs[0].shape != (batch, per_sample):
        raise AssertionError(f"served outputs {[b.shape for b in bufs]}")
    images = bufs[0].view(np.float32)
    if not np.isfinite(images).all():
        raise AssertionError("non-finite values in a served batch")
    with bench_ssd.recording_cmn([]) as calls:
        server.serve(inputs[0])
    server.close()
    held = dict(bench_ssd.time_cmn(calls[0]), max_abs_err=bench_ssd.hold_cmn(calls[0]))
    return {"form": "rn50_capi_serve", "batch": batch, "timed": timed,
            "images_per_s": timed * batch / dt, "copy_out_mb_per_batch": batch * per_sample / 1e6,
            "capi_build_s": build_s, "cmn_launches": launches, "cmn": held, "model": model,
            "library": lib}


def _read_dump(path):
    """[[array per sample] per output] of ``test_capi --serve``'s out.bin."""
    from dali_tpu_torch import types

    data = open(path, "rb").read()
    count, batch = struct.unpack_from("<ii", data)
    pos, outs = 8, []
    for _ in range(count):
        samples = []
        for _ in range(batch):
            dtype, ndim = struct.unpack_from("<iq", data, pos)
            shape = struct.unpack_from(f"<{ndim}q", data, pos + 12)
            pos += 12 + 8 * ndim
            (nbytes,) = struct.unpack_from("<q", data, pos)
            pos += 8
            np_t = np.dtype(types.to_numpy_type(types.DALIDataType(dtype)))
            samples.append(np.frombuffer(data, np_t, nbytes // np_t.itemsize, pos).reshape(shape))
            pos += nbytes
        outs.append(samples)
    return outs


def client_vs_python(lib, model, batch=256):
    """One batch served by the C client as a subprocess (on the card, as the
    document says by default) against ``Pipeline.deserialize`` of the same
    document in Python on the same inputs: (seconds of the client, samples
    compared); raises unless bit-equal."""
    from dali_tpu_torch import Pipeline

    capi_dir = os.path.join(ROOT, "dali_tpu_torch", "capi")
    lib_dir = os.path.dirname(lib)
    samples = serve_inputs(batch, 1)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        exe = os.path.join(d, "test_capi")
        subprocess.run(["gcc", "-O2", "-I", capi_dir, os.path.join(capi_dir, "test_capi.c"),
                        "-o", exe, "-L", lib_dir, "-ldali_tpu_torch_c",
                        f"-Wl,-rpath,{lib_dir}"], check=True, capture_output=True, text=True)
        with open(os.path.join(d, "in.bin"), "wb") as f:
            f.write(struct.pack("<i", len(samples)))
            for s in samples:
                f.write(struct.pack("<q", s.size) + s.tobytes())
        t0 = time.perf_counter()
        r = subprocess.run([exe, model, "--serve", INPUT, os.path.join(d, "in.bin"),
                            os.path.join(d, "out.bin")], capture_output=True, text=True,
                           timeout=600)
        secs = time.perf_counter() - t0
        if r.returncode != 0 or "C API SERVE OK" not in r.stdout:
            raise AssertionError(f"the C client failed ({r.returncode}): {r.stderr[-2000:]}")
        got = _read_dump(os.path.join(d, "out.bin"))
    pipe = Pipeline.deserialize(filename=model)
    pipe.build()
    pipe.feed_input(INPUT, samples)
    want = pipe.run()
    n = 0
    for g_out, w_tl in zip(got, want):
        w_out = w_tl.as_cpu()
        for i, g in enumerate(g_out):
            w = w_out.at(i)
            if g.dtype != w.dtype or g.shape != w.shape or not np.array_equal(g, w):
                raise AssertionError(f"the C client's output sample {i} differs from Python's")
            n += 1
    pipe.shutdown()
    return secs, n


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--form", choices=FORMS, default=FORMS[0])
    ap.add_argument("--timed", type=int, default=10)
    args = ap.parse_args()
    # run as a script: the package is two levels up
    sys.path.insert(0, ROOT)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    if args.form == "rn50_dataloader_proxy":
        r = measure_proxy(timed=args.timed)
    else:
        r = measure_serve(timed=args.timed)
        r["client_s"], r["client_samples_equal"] = client_vs_python(r["library"], r["model"])
    r["card"] = card
    print(json.dumps(r))


if __name__ == "__main__":
    main()
