"""``fn.external_source`` of dali_tpu_torch against dali_tpu's, on the CPU:
``feed_input`` with ``repeat_last``, per-sample callables with
``SampleInfo``, generator functions, ``cycle`` through ``StopIteration`` and
``reset()``, ``num_outputs``, ``dtype``/``ndim`` errors, the unresumable
checkpoint marker, the by-value pickler, and ``parallel=True`` worker
processes under ``fork`` and ``spawn``.

The sources are seeded numpy batches; the two packages must produce the same
samples bit for bit, and raise the same exception types at the same runs.
Every parallel test runs under a timeout of its own, so a hung worker fails
the test instead of stalling the suite.
"""

import pickle
import threading

import numpy as np
import pytest

import dali_tpu
import dali_tpu_torch
from dali_tpu_torch import pickling
from dali_tpu_torch._multiproc import WorkerPool

N = 4
RNG = np.random.default_rng(77)
BATCHES = [[RNG.integers(0, 256, (3 + i, 2 + k, 3)).astype(np.uint8) for i in range(N)]
           for k in range(3)]
PARALLEL_TIMEOUT = 120.0


def _pipe(pkg, body, n=N, **kw):
    extra = {"device": "cpu"} if pkg is dali_tpu_torch else {}

    @pkg.pipeline_def(batch_size=n, num_threads=1, seed=5, **extra, **kw)
    def p():
        outs = body(pkg.fn, pkg.types)
        return outs if isinstance(outs, tuple) else (outs,)

    pipe = p()
    pipe.build()
    return pipe


def _close(pipe):
    (pipe.shutdown if isinstance(pipe, dali_tpu_torch.Pipeline) else pipe._executor.shutdown)()


def _samples(outs):
    res = []
    for tl in outs:
        tl = tl.as_cpu() if type(tl).__name__ == "TensorListGPU" else tl
        res.append([np.asarray(tl.at(i)) for i in range(len(tl))])
    return res


def _trace(pipe, runs, reset_after_stop=True):
    """The samples of ``runs`` run() calls; a StopIteration is recorded as
    "stop" (and followed by reset())."""
    out = []
    for _ in range(runs):
        try:
            out.append(_samples(pipe.run()))
        except StopIteration:
            out.append("stop")
            if reset_after_stop:
                pipe.reset()
    return out


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, str) or isinstance(y, str):
            assert x == y
            continue
        for xo, yo in zip(x, y):
            assert len(xo) == len(yo)
            for s, t in zip(xo, yo):
                assert s.dtype == t.dtype and s.shape == t.shape
                np.testing.assert_array_equal(s, t)


def _both(body, runs, **kw):
    traces = []
    for pkg in (dali_tpu_torch, dali_tpu):
        pipe = _pipe(pkg, body, **kw)
        try:
            traces.append(_trace(pipe, runs))
        finally:
            _close(pipe)
    _same(*traces)
    return traces[0]


def _with_timeout(fn, seconds=PARALLEL_TIMEOUT):
    box = {}

    def target():
        try:
            box["result"] = fn()
        except BaseException as e:  # noqa: BLE001
            box["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        pytest.fail(f"parallel external source did not finish within {seconds} s")
    if "error" in box:
        raise box["error"]
    return box.get("result")


# -- feed_input ---------------------------------------------------------------------------


@pytest.mark.parametrize("repeat_last", [False, True])
def test_feed_input_queue_and_repeat_last(repeat_last):
    traces = []
    for pkg in (dali_tpu_torch, dali_tpu):
        pipe = _pipe(pkg, lambda fn, t: fn.external_source(name="src", layout="HWC",
                                                           repeat_last=repeat_last))
        got = []
        try:
            pipe.feed_input("src", BATCHES[0])
            pipe.feed_input("src", np.stack([b[:2, :2] for b in BATCHES[1]]))
            got += [_samples(pipe.run()), _samples(pipe.run())]
            if repeat_last:
                got.append(_samples(pipe.run()))
            else:
                with pytest.raises(RuntimeError, match="feed_input"):
                    pipe.run()
                pipe.reset()  # clears the error
            pipe.feed_input("src", BATCHES[2], layout="HWC")
            got.append(_samples(pipe.run()))
        finally:
            _close(pipe)
        traces.append(got)
    _same(*traces)
    np.testing.assert_array_equal(traces[0][-1][0][1], BATCHES[2][1])


def test_feed_input_by_node_and_errors():
    pipe = dali_tpu_torch.Pipeline(batch_size=N, device="cpu")
    with pipe:
        node = dali_tpu_torch.fn.external_source()
        other = dali_tpu_torch.fn.cast(node, dtype=dali_tpu_torch.types.INT32)
        pipe.set_outputs(node, other)
    try:
        pipe.feed_input(node, BATCHES[0])
        out = _samples(pipe.run())
        assert out[1][2].dtype == np.int32
        np.testing.assert_array_equal(out[0][2], BATCHES[0][2])
        with pytest.raises(KeyError):
            pipe.feed_input("nope", BATCHES[0])
        with pytest.raises(TypeError, match="input operator"):
            pipe.feed_input(other.source.instance_name, BATCHES[0])
    finally:
        pipe.shutdown()


# -- per-sample and batch sources ------------------------------------------------------------


def _info_source(info):
    return (np.array([info.idx_in_epoch, info.idx_in_batch, info.iteration, info.epoch_idx],
                     np.int64),
            np.full((info.idx_in_batch + 1,), info.idx_in_epoch, np.float32))


def test_per_sample_callable_gets_sample_info():
    trace = _both(lambda fn, t: fn.external_source(source=_info_source, num_outputs=2), 3)
    infos = trace[2][0]
    assert [list(s) for s in infos] == [[8 + i, i, 2, 0] for i in range(N)]
    assert trace[2][1][3].shape == (4,)


def test_per_sample_callable_without_info_and_batch_info():
    count = {"n": 0}

    def no_arg():
        count["n"] += 1
        return np.full((2,), count["n"], np.int32)

    for pkg in (dali_tpu_torch, dali_tpu):
        count["n"] = 0
        pipe = _pipe(pkg, lambda fn, t: fn.external_source(source=no_arg, batch=False))
        try:
            got = _samples(pipe.run())[0]
        finally:
            _close(pipe)
        assert [int(s[0]) for s in got] == [1, 2, 3, 4]

    def by_batch(info):
        return [np.full((1,), 10 * info.iteration + info.epoch_idx, np.int32)] * N

    _both(lambda fn, t: fn.external_source(source=by_batch, batch=True), 3)


def _gen():
    for b in BATCHES:
        yield b


@pytest.mark.parametrize("cycle", [None, "no", False, "quiet", True, "raise"])
@pytest.mark.parametrize("kind", ["generator_function", "iterable"])
def test_cycle_modes_through_stop_and_reset(cycle, kind):
    source = _gen if kind == "generator_function" else BATCHES
    trace = _both(lambda fn, t: fn.external_source(source=source, cycle=cycle), 8)
    if cycle in ("quiet", True):
        assert "stop" not in trace
        _same(trace[3:6], trace[:3])
    else:
        assert trace[3] == "stop"
        _same(trace[4:7], trace[:3])


def test_callable_stop_iteration_ends_epoch_and_reset_restarts():
    def finite(info):
        if info.iteration >= 2:
            raise StopIteration
        return [np.full((2,), 100 * info.epoch_idx + info.iteration, np.int32)] * N

    trace = _both(lambda fn, t: fn.external_source(source=finite, batch=True), 6)
    assert trace[2] == "stop" and trace[5] == "stop"
    assert int(trace[3][0][0][0]) == 100  # the next epoch restarts at iteration 0


def test_num_outputs_and_gpu_device():
    def two(info):
        return [b[..., 0] for b in BATCHES[info.iteration % 3]], [b[:1] for b in BATCHES[0]]

    _both(lambda fn, t: fn.external_source(source=two, num_outputs=2, batch=True, device="gpu"), 3)
    _both(lambda fn, t: fn.external_source(source=two, num_outputs=2, batch=True), 2)


def test_variable_batch_size_and_layout():
    def shrinking(info):
        return BATCHES[0][:N - info.iteration]

    trace = _both(lambda fn, t: fn.external_source(source=shrinking, batch=True, layout="HWC"), 3)
    assert [len(o[0]) for o in trace] == [4, 3, 2]


@pytest.mark.parametrize("kw,data,err", [
    ({"dtype": "FLOAT"}, BATCHES[0], TypeError),
    ({"ndim": 2}, BATCHES[0], ValueError),
    ({"layout": "HW"}, BATCHES[0], ValueError),
    ({"dtype": "UINT8", "ndim": 3}, [b.astype(np.int16) for b in BATCHES[0]], TypeError),
])
def test_dtype_and_ndim_errors(kw, data, err):
    for pkg in (dali_tpu_torch, dali_tpu):
        args = {k: getattr(pkg.types, v) if k == "dtype" else v for k, v in kw.items()}
        pipe = _pipe(pkg, lambda fn, t: fn.external_source(source=lambda: data, batch=True,
                                                           **args))
        try:
            with pytest.raises(err, match="declared|layout"):
                pipe.run()
        finally:
            _close(pipe)
    ok = _pipe(dali_tpu_torch, lambda fn, t: fn.external_source(
        source=lambda: BATCHES[0], batch=True, dtype=t.UINT8, ndim=3))
    try:
        ok.run()
    finally:
        _close(ok)


def test_too_many_samples_raise():
    pipe = _pipe(dali_tpu_torch, lambda fn, t: fn.external_source(
        source=lambda: BATCHES[0] + BATCHES[1], batch=True))
    try:
        with pytest.raises(ValueError, match="max_batch_size"):
            pipe.run()
    finally:
        _close(pipe)


# -- checkpoints ---------------------------------------------------------------------------


def test_unresumable_source_marker():
    states = []
    for pkg in (dali_tpu_torch, dali_tpu):
        pipe = _pipe(pkg, lambda fn, t: fn.external_source(source=BATCHES, cycle="quiet"),
                     enable_checkpointing=True)
        try:
            pipe.run()
            with pytest.raises(ValueError, match="cannot be checkpointed mid-stream"):
                pipe.checkpoint()
            states.append(pipe._executor.impls[0].save_state())
        finally:
            _close(pipe)
    assert states[0] == states[1] and "unresumable_source" in states[0]


def test_indexed_source_checkpoint_from_dali_tpu_resumes_in_port():
    def body(fn, t):
        return fn.external_source(source=_info_source, num_outputs=2)

    ref = _pipe(dali_tpu, body, enable_checkpointing=True)
    try:
        ref.run()
        ref.run()
        ckpt = ref.checkpoint()
        want = [_samples(ref.run()) for _ in range(2)]
    finally:
        _close(ref)
    port = _pipe(dali_tpu_torch, body, checkpoint=ckpt)
    try:
        _same([_samples(port.run()) for _ in range(2)], want)
    finally:
        _close(port)


# -- pickling ------------------------------------------------------------------------------


def _make_closure(k):
    offset = np.int64(k)

    def inner(info):
        return np.full((2,), info.idx_in_epoch + offset, np.int64)

    return inner


def test_by_value_pickler_round_trips_lambda_and_closure():
    scale = 3
    lam = lambda x: np.asarray(x) * scale  # noqa: E731
    clo = _make_closure(40)
    lam2, clo2 = pickle.loads(pickling.dumps(lam)), pickling.loads(pickling.dumps(clo))
    np.testing.assert_array_equal(lam2([1, 2]), [3, 6])
    info = dali_tpu_torch.types.SampleInfo(2, 2, 0, 0)
    np.testing.assert_array_equal(clo2(info), [42, 42])
    with pytest.raises(Exception):
        pickle.dumps(lam)

    @pickling.pickle_by_value
    def marked(x):
        return x + 1

    assert pickling.loads(pickling.dumps(marked))(1) == 2
    # the blob is dali_tpu's format: each package loads the other's
    from dali_tpu import pickling as ref_pickling

    np.testing.assert_array_equal(ref_pickling.loads(pickling.dumps(clo))(info), [42, 42])
    np.testing.assert_array_equal(pickling.loads(ref_pickling.dumps(clo))(info), [42, 42])


# -- parallel ------------------------------------------------------------------------------


def _indexed(info):
    return (np.full((3 + info.idx_in_batch,), info.idx_in_epoch, np.int64),
            np.int32(1000 * info.epoch_idx + info.iteration))


@pytest.mark.parametrize("start_method", ["fork", "spawn"])
def test_parallel_matches_serial(start_method):
    def body(fn, t, parallel):
        return fn.external_source(source=_indexed, num_outputs=2, parallel=parallel)

    want = _both(lambda fn, t: body(fn, t, False), 3, n=8)

    def run():
        pipe = _pipe(dali_tpu_torch, lambda fn, t: body(fn, t, True), n=8, py_num_workers=2,
                     py_start_method=start_method, py_callback_pickler=pickling)
        try:
            impl = next(iter(pipe.executor.impls.values()))
            assert impl._pool is not None  # started at build, before the stage threads
            return _trace(pipe, 3)
        finally:
            _close(pipe)

    _same(_with_timeout(run), want)


_FINITE = 12


def _finite(info):
    if info.idx_in_epoch >= _FINITE:
        raise StopIteration
    return np.full((3,), info.idx_in_epoch + 100 * info.epoch_idx, np.int64)


@pytest.mark.parametrize("start_method", ["fork", "spawn"])
def test_parallel_epoch_end_and_reset(start_method):
    def run():
        pipe = _pipe(dali_tpu_torch, lambda fn, t: fn.external_source(
            source=_finite, batch=False, parallel=True), py_num_workers=2,
            py_start_method=start_method, py_callback_pickler=pickling)
        try:
            for epoch in range(2):
                seen = []
                for _ in range(_FINITE // N):
                    seen += [int(s[0]) for s in _samples(pipe.run())[0]]
                assert seen == [100 * epoch + i for i in range(_FINITE)], seen
                with pytest.raises(StopIteration):
                    pipe.run()
                pipe.reset()
        finally:
            _close(pipe)

    _with_timeout(run)


def _ragged_arity(info):
    if info.idx_in_epoch % 5 == 3:
        return np.zeros((2,), np.float32)
    return np.zeros((2,), np.float32), np.ones((1,), np.int64)


def test_parallel_ragged_arity_raises():
    def run():
        pipe = _pipe(dali_tpu_torch, lambda fn, t: fn.external_source(
            source=_ragged_arity, batch=False, parallel=True, num_outputs=2), n=8,
            py_num_workers=2)
        try:
            with pytest.raises(RuntimeError, match="outputs for sample"):
                pipe.run()
        finally:
            _close(pipe)

    _with_timeout(run)


def test_parallel_requires_indexed_per_sample_callable():
    for kw in ({"source": lambda: BATCHES[0], "batch": True}, {"source": lambda: BATCHES[0][0]}):
        with pytest.raises(ValueError, match="parallel=True"):
            _pipe(dali_tpu_torch, lambda fn, t: fn.external_source(parallel=True, **kw))


def _big(info):
    return np.full((1 << 19,), info.idx_in_epoch, np.int32), np.int64(info.idx_in_epoch)


@pytest.mark.parametrize("start_method", ["fork", "spawn"])
def test_worker_pool_oversize_slot_reuse(start_method):
    """Results larger than a slot ride one worker-owned overflow segment,
    attached once and reused across batches."""
    def run():
        pool = WorkerPool(_big, num_workers=2, batch_size=4, queue_depth=2, slot_bytes=1 << 20,
                          start_method=start_method, pickler=pickling)
        try:
            for it in range(3):
                for i, s in enumerate(pool.run_batch(it, 0)):
                    assert len(s) == 2 and s[0].shape == (1 << 19,)
                    assert int(s[0][0]) == it * 4 + i == int(s[1])
            assert len(pool._big_attach) == 2
        finally:
            pool.close()
        assert all(not p.is_alive() for p in pool._procs)

    _with_timeout(run)


@pytest.mark.parametrize("start_method", ["fork", "spawn"])
def test_worker_pool_run_batch(start_method):
    """``run_batch`` computes the asked batch: every sample at its index,
    with the iteration and epoch in its ``SampleInfo``."""
    def run():
        pool = WorkerPool(_indexed, num_workers=2, batch_size=4, start_method=start_method,
                          pickler=pickling)
        try:
            for it in (0, 1, 2, 1):
                samples = pool.run_batch(it, 0)
                assert [int(s[0][0]) for s in samples] == list(range(it * 4, it * 4 + 4))
                assert [s[0].shape[0] for s in samples] == [3, 4, 5, 6]
                assert {int(s[1]) for s in samples} == {it}
            samples = pool.run_batch(0, 1)
            assert [int(s[0][0]) for s in samples] == [0, 1, 2, 3]
            assert int(samples[0][1]) == 1000
        finally:
            pool.close()
        assert not any(p.is_alive() for p in pool._procs)

    _with_timeout(run)


def test_worker_pool_more_workers_than_cores():
    """Stress: more worker processes than cores; every sample lands at its
    index in every batch."""
    import os

    workers = (os.cpu_count() or 2) + 4

    def run():
        pool = WorkerPool(_indexed, num_workers=workers, batch_size=2 * workers)
        try:
            for it in range(4):
                samples = pool.run_batch(it, 0)
                want = list(range(it * 2 * workers, (it + 1) * 2 * workers))
                assert [int(s[0][0]) for s in samples] == want
                assert [s[0].shape[0] for s in samples] == [3 + i for i in range(2 * workers)]
        finally:
            pool.close()
        assert not any(p.is_alive() for p in pool._procs)

    _with_timeout(run)
