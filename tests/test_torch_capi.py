"""The C API of the port (``dali_tpu_torch/capi``) on the CPU: the library
built once per session into a temporary directory, the C client
``test_capi.c`` compiled against it, and the three scenarios of
``tests/test_capi.py`` (create, run, info, copy and its error paths; feed,
zero-copy access, checkpoint round trip; resume determinism and the error
contracts) on documents the port serialized with ``"device": "cpu"`` in
their params. The client's outputs equal the port's Python run of the same
document and ``dali_tpu``'s (host draws are bit-equal between the
packages); a JPEG serving graph fed through ``daliTpuFeedInput`` equals the
Python run on the same inputs; the Python the library runs imports neither
jax nor dali_tpu."""

import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch
from dali_tpu_torch.capi import build as capi_build

REPO = os.path.join(os.path.dirname(__file__), "..")
CAPI = os.path.join(REPO, "dali_tpu_torch", "capi")
CORPUS = os.path.join(REPO, "dali_tpu_torch", "testdata", "rn50")


@pytest.fixture(scope="session")
def client(tmp_path_factory):
    """(library path, client executable), built once per session."""
    d = tmp_path_factory.mktemp("capi")
    lib = capi_build.build(str(d))
    exe = str(d / "test_capi")
    subprocess.run(["gcc", "-O2", "-I", CAPI, os.path.join(CAPI, "test_capi.c"), "-o", exe,
                    "-L", str(d), "-ldali_tpu_torch_c", f"-Wl,-rpath,{d}"], check=True,
                   capture_output=True)
    return lib, exe


def _document(pipe, path):
    """``pipe``'s document with ``"device": "cpu"`` in its params."""
    pipe.build()
    doc = json.loads(pipe.serialize())
    doc["params"]["device"] = "cpu"
    path.write_text(json.dumps(doc))
    return str(path)


def _run_client(exe, *args):
    return subprocess.run([exe, *args], check=True, capture_output=True, text=True,
                          timeout=240).stdout


def _read_dump(path):
    """[[array per sample] per output] from the client's out.bin."""
    data = open(path, "rb").read()
    count, batch = struct.unpack_from("<ii", data)
    pos, outs = 8, []
    for _ in range(count):
        samples = []
        for _ in range(batch):
            dtype, ndim = struct.unpack_from("<iq", data, pos)
            pos += 12
            shape = struct.unpack_from(f"<{ndim}q", data, pos)
            pos += 8 * ndim
            (nbytes,) = struct.unpack_from("<q", data, pos)
            pos += 8
            np_t = dali_tpu_torch.types.to_numpy_type(dali_tpu_torch.types.DALIDataType(dtype))
            samples.append(np.frombuffer(data, np_t, nbytes // np.dtype(np_t).itemsize,
                                         pos).reshape(shape))
            pos += nbytes
        outs.append(samples)
    assert pos == len(data)
    return outs


def _python_run(pkg, doc_path, feed=None, **kw):
    doc = json.loads(open(doc_path).read())
    if pkg is dali_tpu:
        doc["params"].pop("device")
    pipe = pkg.Pipeline.deserialize(json.dumps(doc), **kw)
    pipe.build()
    if feed:
        pipe.feed_input(*feed)
    return [[np.asarray(o.at(i)) for i in range(len(o))] for o in pipe.run()]


def _assert_outputs_equal(got, want):
    assert len(got) == len(want)
    for g_out, w_out in zip(got, want):
        assert len(g_out) == len(w_out)
        for g, w in zip(g_out, w_out):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_c_api_basic(client, tmp_path):
    _, exe = client

    @dali_tpu_torch.pipeline_def(batch_size=4, num_threads=1, seed=3, device="cpu")
    def p():
        return dali_tpu_torch.fn.random.uniform(range=[5.0, 6.0], shape=[3, 2]) * 2.0

    doc = _document(p(), tmp_path / "pipe.json")
    out = _run_client(exe, doc, "--dump", str(tmp_path / "out.bin"))
    assert "C API OK" in out and "outputs=1 batch=4" in out
    assert "dtype=9" in out  # DALIDataType.FLOAT
    assert "bad-index error: invalid output/sample index" in out
    assert "unknown-reader error" in out
    got = _read_dump(str(tmp_path / "out.bin"))
    _assert_outputs_equal(got, _python_run(dali_tpu_torch, doc))
    _assert_outputs_equal(got, _python_run(dali_tpu, doc))


def test_c_api_feed(client, tmp_path):
    _, exe = client

    @dali_tpu_torch.pipeline_def(batch_size=2, num_threads=1, seed=3, device="cpu")
    def p():
        return dali_tpu_torch.fn.external_source(name="src") * 2.0

    out = _run_client(exe, _document(p(), tmp_path / "pipe_feed.json"), "--feed")
    assert "feed+zero-copy OK (12.000000..22.000000)" in out
    assert "C API FEED OK" in out


def test_c_api_resume(client, tmp_path):
    _, exe = client

    @dali_tpu_torch.pipeline_def(batch_size=3, num_threads=1, seed=7, enable_checkpointing=True,
                                 device="cpu")
    def p():
        fn = dali_tpu_torch.fn
        u = fn.random.uniform(range=[0.0, 1.0], shape=[4, 4])
        return u + fn.random.normal(mean=0.0, stddev=2.0, shape=[4, 4])

    doc = _document(p(), tmp_path / "pipe_rng.json")
    out = _run_client(exe, doc, "--resume")
    assert "resume bytes=64 identical" in out
    assert "bad-json error" in out and "C API RESUME OK" in out
    # the first batch of the document, both packages, equal to the client's
    _run_client(exe, doc, "--dump", str(tmp_path / "out.bin"))
    got = _read_dump(str(tmp_path / "out.bin"))
    _assert_outputs_equal(got, _python_run(dali_tpu_torch, doc))
    _assert_outputs_equal(got, _python_run(dali_tpu, doc))


def _serve_pipe(batch):
    """rn50_val's recipe fed from outside, at a small output size."""
    fn, types = dali_tpu_torch.fn, dali_tpu_torch.types

    @dali_tpu_torch.pipeline_def(batch_size=batch, num_threads=2, seed=11, device="cpu")
    def serve():
        jpegs = fn.external_source(name="DALI_INPUT_0", dtype=types.UINT8, ndim=1)
        images = fn.decoders.image(jpegs, device="mixed", hybrid_device_decode=True,
                                   hybrid_wire="int8")
        images = fn.resize(images, resize_shorter=40)
        return fn.crop_mirror_normalize(images, crop=(32, 32), dtype=types.FLOAT,
                                        output_layout="CHW", mean=[123.7, 116.3, 103.5],
                                        std=[58.4, 57.1, 57.4])

    return serve()


def test_c_api_serves_jpegs_as_python_does(client, tmp_path):
    """A batch of corpus JPEGs through ``--serve`` (daliTpuFeedInput, run,
    daliTpuCopyOutputSample): bit-equal to the document run in Python."""
    _, exe = client
    doc = _document(_serve_pipe(4), tmp_path / "serve.json")
    files = sorted(os.path.join(r, f) for r, _, fs in os.walk(CORPUS) for f in fs)[:4]
    jpegs = [np.fromfile(f, np.uint8) for f in files]
    with open(tmp_path / "in.bin", "wb") as f:
        f.write(struct.pack("<i", len(jpegs)))
        for j in jpegs:
            f.write(struct.pack("<q", j.size) + j.tobytes())
    out = _run_client(exe, doc, "--serve", "DALI_INPUT_0", str(tmp_path / "in.bin"),
                      str(tmp_path / "out.bin"))
    assert "C API SERVE OK (4 samples)" in out
    got = _read_dump(str(tmp_path / "out.bin"))
    assert got[0][0].shape == (3, 32, 32) and got[0][0].dtype == np.float32
    _assert_outputs_equal(got, _python_run(dali_tpu_torch, doc, feed=("DALI_INPUT_0", jpegs)))


def test_c_api_through_ctypes_imports_no_jax(client, tmp_path):
    """The library driven from a running interpreter (the card's timed
    path): the error contracts of the sample calls, and the Python it runs
    (its embedded helpers included) imports neither jax nor dali_tpu."""
    lib, _ = client

    @dali_tpu_torch.pipeline_def(batch_size=2, num_threads=1, device="cpu")
    def p():
        return dali_tpu_torch.fn.external_source(name="src") + 1

    doc = _document(p(), tmp_path / "doc.json")
    code = f"""
import ctypes, sys
import numpy as np
from dali_tpu_torch import capi
lib = capi.load({lib!r})
assert lib.daliTpuInit() == capi.OK
doc = open({doc!r}, "rb").read()
h = ctypes.c_void_p()
assert lib.daliTpuCreatePipeline(ctypes.byref(h), doc, len(doc)) == 0, lib.daliTpuGetLastError()
n = ctypes.c_int()
assert lib.daliTpuOutputCount(h, ctypes.byref(n)) == capi.ERROR  # before a run
assert b"daliTpuRun first" in lib.daliTpuGetLastError()
buf = ctypes.create_string_buffer(64)
assert lib.daliTpuCopyOutputSample(h, 0, 0, buf, 64) == capi.ERROR
infos = (capi.TensorInfo * 2)()
data = np.arange(6, dtype=np.int32)
for i in range(2):
    infos[i].ndim, infos[i].shape[0], infos[i].dtype, infos[i].nbytes = 1, 3, 6, 12
assert lib.daliTpuFeedInput(h, b"nope", data.ctypes.data, infos, 2, None) == capi.ERROR
assert b"nope" in lib.daliTpuGetLastError()
assert lib.daliTpuFeedInput(h, b"src", data.ctypes.data, infos, 2, None) == capi.OK
assert lib.daliTpuRun(h) == capi.OK, lib.daliTpuGetLastError()
assert lib.daliTpuCopyOutputSample(h, 0, 1, buf, 64) == capi.OK
assert list(np.frombuffer(buf.raw[:12], np.int32)) == [4, 5, 6]
assert lib.daliTpuCopyOutputSample(h, 0, 1, buf, 11) == capi.BUFFER_TOO_SMALL
assert lib.daliTpuOutputInfo(h, 1, 0, ctypes.byref(capi.TensorInfo())) == capi.ERROR
assert lib.daliTpuRun(None) == capi.INVALID_HANDLE
assert lib.daliTpuDestroyPipeline(h) == capi.OK
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "dali_tpu")]
assert not bad, bad
print("OK")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-3000:]
