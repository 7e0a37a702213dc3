"""Base framework iterator: epoch accounting, LastBatchPolicy, multi-pipeline
aggregation (counterpart of ``dali_tpu/plugin/base_iterator.py``)."""

from __future__ import annotations

import enum
from typing import List, Optional

from ..tensors import TensorListCPU, TensorListGPU


class LastBatchPolicy(enum.Enum):
    FILL = 0
    DROP = 1
    PARTIAL = 2


class DALIGenericIterator:
    """Iterates one or more pipelines, yielding per-pipeline output dicts.
    Subclasses convert them with ``_to_framework``."""

    def __init__(self, pipelines, output_map: List[str], size: int = -1,
                 reader_name: Optional[str] = None, auto_reset: bool = False,
                 last_batch_padded: bool = False,
                 last_batch_policy: LastBatchPolicy = LastBatchPolicy.FILL):
        if not isinstance(pipelines, (list, tuple)):
            pipelines = [pipelines]
        if len(set(output_map)) != len(output_map):
            raise ValueError("output_map names must be unique")
        self._pipes = list(pipelines)
        self.output_map = list(output_map)
        self._auto_reset = auto_reset in (True, "yes")
        self._last_batch_policy = last_batch_policy
        self._last_batch_padded = last_batch_padded
        self.batch_size = self._pipes[0].max_batch_size
        if reader_name is not None:
            total = total_no_pad = 0
            for m in (p.reader_meta(reader_name) for p in self._pipes):
                es, ns, sid = m["epoch_size"], m["number_of_shards"], m["shard_id"]
                exact = (sid + 1) * es // ns - sid * es // ns
                total_no_pad += exact
                if last_batch_policy == LastBatchPolicy.DROP:
                    total += es // ns
                elif m["pad_last_batch"]:
                    total += m["epoch_size_padded"] // ns
                else:
                    total += exact
                self._last_batch_padded = bool(m["pad_last_batch"])
            self._size, self._size_no_pad = total, total_no_pad
        else:
            self._size = self._size_no_pad = size
        self._counter = 0
        for p in self._pipes:
            p._require_built()
            p._prefetch()

    @property
    def size(self):
        return self._size

    def __len__(self):
        if self._size <= 0:
            raise TypeError("Iterator size unknown")
        bs = self.batch_size * len(self._pipes)
        if self._last_batch_policy == LastBatchPolicy.DROP:
            return self._size // bs
        return -(-self._size // bs)

    def __iter__(self):
        return self

    def __next__(self):
        step = self.batch_size * len(self._pipes)
        if self._size > 0 and (self._counter >= self._size or (
                self._last_batch_policy == LastBatchPolicy.DROP
                and self._size - self._counter < step)):
            if self._auto_reset:
                self.reset()
            raise StopIteration
        left = self._size_no_pad - self._counter if self._size > 0 else None
        batches = []
        for p in self._pipes:
            outs = p.outputs()
            p.schedule_run()
            batches.append(dict(zip(self.output_map, outs)))
        self._counter += step
        if self._last_batch_policy == LastBatchPolicy.PARTIAL and left is not None and left < step:
            batches = [{k: self._trim(v, min(max(left - i * self.batch_size, 0), self.batch_size))
                        for k, v in b.items()} for i, b in enumerate(batches)]
        return self._to_framework(batches)

    next = __next__

    def reset(self):
        """Start a new epoch once the current one has ended."""
        step = self.batch_size * len(self._pipes)
        remaining = self._size - self._counter
        if self._last_batch_policy == LastBatchPolicy.DROP and self._size > 0 \
                and 0 < remaining < step:
            # the dropped tail batch is still queued: take it out, or its
            # samples would open the next epoch
            for p in self._pipes:
                p.outputs()
                p.schedule_run()
            self._counter += step
        if self._size < 0 or self._counter >= self._size:
            if (self._last_batch_policy == LastBatchPolicy.FILL
                    and not self._last_batch_padded and self._size > 0):
                self._counter = self._counter % self._size
            else:
                self._counter = 0

    @staticmethod
    def _trim(v, n):
        if isinstance(v, TensorListCPU):
            return TensorListCPU([v.at(i) for i in range(n)], v.layout())
        shapes = None if v._shapes is None else v._shapes[:n]
        return TensorListGPU(v.as_tensor()[:n], shapes, v.layout())

    def _to_framework(self, batches):
        return batches
