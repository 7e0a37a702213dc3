"""Worker processes of ``parallel=True`` external sources (counterpart of
``dali_tpu/_multiproc.py``).

* N worker processes (``fork`` or ``spawn``), each with a ring of reusable
  ``multiprocessing.shared_memory`` slots owned by the parent: no allocation
  per batch after the first;
* a task is (slot, iteration, epoch, sample infos): the worker calls the
  source once per sample and packs the arrays into its slot; a result larger
  than the slot goes through one worker-owned overflow segment that grows on
  demand and is reused;
* the parent copies each result out, so slots recycle;
* each batch is computed when the pipeline asks for it, as in the reference.

Only callables that take a ``SampleInfo`` run in workers: a stateless,
indexed source. A ``StopIteration`` in a worker ends the epoch as it does
in the serial path. Workers never touch torch or the card.
"""

from __future__ import annotations

import multiprocessing as mp
import pickle
import queue
import struct
import time
import weakref
from multiprocessing import shared_memory
from typing import List

import numpy as np

from .types import SampleInfo

_HEADER = struct.Struct("<I")  # length of the pickled metadata
_STOP = "__stop_iteration__"  # a worker's end-of-epoch marker


def _pack_arrays(shm, arrays: List[np.ndarray]) -> int:
    """Pack ``arrays`` into ``shm`` as [meta length][meta pickle][buffers]
    and return the bytes needed; nothing is written when they exceed it."""
    conv, metas, offset = [], [], 0
    for a in arrays:
        # reshape: ascontiguousarray makes a 0-d sample 1-d
        a = np.ascontiguousarray(a).reshape(np.shape(a))
        conv.append(a)
        metas.append((a.dtype.str, a.shape, offset, a.nbytes))
        offset += a.nbytes
    meta_blob = pickle.dumps(metas, protocol=pickle.HIGHEST_PROTOCOL)
    total = _HEADER.size + len(meta_blob) + offset
    if shm is None or total > shm.size:
        return total
    buf = shm.buf
    _HEADER.pack_into(buf, 0, len(meta_blob))
    buf[_HEADER.size:_HEADER.size + len(meta_blob)] = meta_blob
    base = _HEADER.size + len(meta_blob)
    for a, (_, _, off, nbytes) in zip(conv, metas):
        if nbytes:
            buf[base + off:base + off + nbytes] = a.data.cast("B")
    return total


def _unpack_arrays(shm) -> List[np.ndarray]:
    buf = shm.buf
    (meta_len,) = _HEADER.unpack_from(buf, 0)
    metas = pickle.loads(bytes(buf[_HEADER.size:_HEADER.size + meta_len]))
    base = _HEADER.size + meta_len
    out = []
    for dstr, shape, off, nbytes in metas:
        dt = np.dtype(dstr)
        a = np.frombuffer(buf, dtype=dt, count=nbytes // dt.itemsize, offset=base + off)
        out.append(a.reshape(shape).copy())  # the slot recycles
    return out


def _worker_main(worker_id, source_blob, task_q, result_q):
    source = pickle.loads(source_blob)
    slots = {}
    big = None  # the overflow segment, owned (and unlinked) by this worker
    try:
        while True:
            task = task_q.get()
            if task is None:
                break
            slot_name, iteration, epoch, infos = task
            try:
                arrays, n_out = [], None
                for info in infos:
                    r = source(SampleInfo(*info))
                    this = len(r) if isinstance(r, tuple) else 1
                    arrays.extend(np.asarray(x) for x in (r if isinstance(r, tuple) else (r,)))
                    if n_out is None:
                        n_out = this
                    elif n_out != this:
                        raise ValueError(f"source returned {this} outputs for sample {info[0]} "
                                         f"but {n_out} for earlier samples in the batch")
                shm = slots.get(slot_name)
                if shm is None:
                    shm = slots[slot_name] = shared_memory.SharedMemory(name=slot_name)
                total = _pack_arrays(shm, arrays)
                if total > shm.size:
                    if big is None or big.size < total:
                        if big is not None:
                            big.close()
                            big.unlink()
                        big = shared_memory.SharedMemory(create=True, size=max(total, 1 << 20))
                    _pack_arrays(big, arrays)
                    shm = big
                result_q.put((worker_id, iteration, epoch, infos, shm.name, n_out, None))
            except StopIteration:
                result_q.put((worker_id, iteration, epoch, infos, None, 0, _STOP))
            except Exception as e:  # reported to the parent, which raises it
                result_q.put((worker_id, iteration, epoch, infos, None, 0, repr(e)))
    finally:
        for shm in slots.values():
            shm.close()
        if big is not None:
            try:
                big.close()
                big.unlink()
            except Exception:
                pass


class WorkerPool:
    """``num_workers`` processes computing one batch of samples at a time;
    each worker takes a contiguous chunk of the batch."""

    def __init__(self, source, num_workers: int, batch_size: int, queue_depth: int = 2,
                 start_method: str = "fork", slot_bytes: int = 8 << 20, pickler=None):
        self._ctx = mp.get_context(start_method)
        self._num_workers = max(1, int(num_workers))
        self._batch_size = batch_size
        self._task_qs = [self._ctx.Queue() for _ in range(self._num_workers)]
        self._result_q = self._ctx.Queue()
        self._slots = {}
        self._slot_ring = []
        for _ in range(self._num_workers):
            ring = []
            for _ in range(queue_depth + 2):
                shm = shared_memory.SharedMemory(create=True, size=slot_bytes)
                self._slots[shm.name] = shm
                ring.append(shm.name)
            self._slot_ring.append(ring)
        self._slot_cursor = [0] * self._num_workers
        self._big_attach = {}  # worker id -> its attached overflow segment
        if pickler is not None:
            blob = pickler.dumps(source)
        else:
            try:
                blob = pickle.dumps(source, protocol=pickle.HIGHEST_PROTOCOL)
            except Exception:
                # lambdas, closures and __main__ functions go by value
                from .pickling import dumps

                blob = dumps(source)
        self._procs = []
        for w in range(self._num_workers):
            p = self._ctx.Process(target=_worker_main,
                                  args=(w, blob, self._task_qs[w], self._result_q), daemon=True)
            p.start()
            self._procs.append(p)
        # runs on close() or at interpreter exit, whichever comes first
        self._finalizer = weakref.finalize(self, WorkerPool._cleanup, self._task_qs,
                                           self._result_q, self._procs, self._slots,
                                           self._big_attach)

    def _attach_result(self, worker_id, shm_name):
        if shm_name in self._slots:
            return _unpack_arrays(self._slots[shm_name])
        cached = self._big_attach.get(worker_id)
        if cached is None or cached.name != shm_name:
            if cached is not None:
                cached.close()  # the worker replaced (and unlinked) it
            cached = self._big_attach[worker_id] = shared_memory.SharedMemory(name=shm_name)
        return _unpack_arrays(cached)

    def run_batch(self, iteration: int, epoch: int) -> List[List[np.ndarray]]:
        """One batch: for each sample, the list of its output arrays. A
        ``StopIteration`` of the source ends the epoch."""
        bs = self._batch_size
        per = -(-bs // self._num_workers)
        pending = 0
        for w in range(self._num_workers):
            lo, hi = w * per, min((w + 1) * per, bs)
            if lo >= hi:
                continue
            infos = [(iteration * bs + i, i, iteration, epoch) for i in range(lo, hi)]
            slot = self._slot_ring[w][self._slot_cursor[w]]
            self._slot_cursor[w] = (self._slot_cursor[w] + 1) % len(self._slot_ring[w])
            self._task_qs[w].put((slot, iteration, epoch, infos))
            pending += 1
        results, stop, err = {}, False, None
        while pending:
            try:
                worker_id, it, ep, infos, shm_name, n_out, werr = self._result_q.get(timeout=5.0)
            except queue.Empty:
                dead = [i for i, p in enumerate(self._procs) if not p.is_alive()]
                if dead:
                    raise RuntimeError(f"parallel external_source worker(s) {dead} died")
                continue
            if (it, ep) != (iteration, epoch):
                continue  # left over from a batch that ended in an error
            pending -= 1
            if werr == _STOP:
                stop = True  # collect the rest of this batch first
            elif werr is not None:
                err = err or RuntimeError(f"parallel external_source worker failed: {werr}")
            else:
                results[infos[0][1]] = (infos, self._attach_result(worker_id, shm_name), n_out)
        if stop:
            raise StopIteration
        if err is not None:
            raise err
        samples: List[List[np.ndarray]] = [None] * bs
        for infos, arrays, n_out in results.values():
            for k, info in enumerate(infos):
                samples[info[1]] = arrays[k * n_out:(k + 1) * n_out]
        return samples

    @staticmethod
    def _cleanup(task_qs, result_q, procs, slots, big_attach):
        for q in task_qs:
            try:
                q.put(None)
            except Exception:
                pass
        # a worker exits only once its queued results are read: drain while
        # joining
        deadline = time.monotonic() + 2
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            try:
                while True:
                    result_q.get_nowait()
            except (queue.Empty, OSError, ValueError):
                pass
            for p in procs:
                p.join(timeout=0.05)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=2)
        for shm in list(slots.values()) + list(big_attach.values()):
            try:
                shm.close()
                shm.unlink()
            except Exception:
                pass
        slots.clear()
        big_attach.clear()

    def close(self):
        self._finalizer()
