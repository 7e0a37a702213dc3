"""``BaseReader`` and readers.File (counterpart of ``dali_tpu/backend/readers.py``).

The sample-index stream (shuffling buffer, shard math, epoch wrap) and its
checkpoint state are the reference's, draw for draw, so a checkpoint written
by ``dali_tpu`` resumes here at the same sample. ``s3://`` roots list and
read through the port's SigV4 client (``_s3.py``), in the reference's order,
so local and s3 copies of a dataset shard alike.
"""

from __future__ import annotations

import fnmatch
import mmap
import os
from typing import List, Optional

import numpy as np

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import HostBatch
from .base import HostCtx, ReaderOperator


class IndexedLoader:
    """Deterministic, checkpointable sample-index stream with DALI shard
    semantics (start = shard*N // shards, rotation unless stick_to_shard)."""

    def __init__(self, num_samples_fn, shard_id, num_shards, random_shuffle, initial_fill,
                 stick_to_shard, pad_last_batch, batch_size, seed,
                 shuffle_after_epoch=False, shuffle_after_epoch_seed=-1):
        self._num_samples_fn = num_samples_fn
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.random_shuffle = random_shuffle
        self.initial_fill = max(1, initial_fill) if random_shuffle else 1
        self.stick_to_shard = stick_to_shard
        self.pad_last_batch = pad_last_batch
        self.batch_size = batch_size
        self.shuffle_after_epoch = shuffle_after_epoch
        self.shuffle_seed = shuffle_after_epoch_seed if shuffle_after_epoch_seed >= 0 else seed
        self._n = None
        self._epoch = 0
        self._pos = 0
        self._buffer: List[int] = []
        self._rng = np.random.Generator(np.random.Philox(key=np.uint64(seed & (2**63 - 1))))
        self._perm_cache = {}

    @property
    def num_samples(self) -> int:
        if self._n is None:
            self._n = self._num_samples_fn()
        return self._n

    def shard_bounds(self, shard: int):
        n = self.num_samples
        return shard * n // self.num_shards, (shard + 1) * n // self.num_shards

    @property
    def shard_size_padded(self) -> int:
        if not self.pad_last_batch:
            start, end = self.shard_bounds(self.shard_id)
            return end - start
        max_shard = -(-self.num_samples // self.num_shards)
        return -(-max_shard // self.batch_size) * self.batch_size

    def _shard_of(self, epoch: int) -> int:
        return self.shard_id if self.stick_to_shard else (self.shard_id + epoch) % self.num_shards

    def _raw_index(self, epoch: int, pos_in_shard: int) -> int:
        start, end = self.shard_bounds(self._shard_of(epoch))
        if self.pad_last_batch and pos_in_shard >= end - start:
            pos_in_shard = end - start - 1
        idx = start + pos_in_shard
        if not self.shuffle_after_epoch:
            return idx
        if epoch not in self._perm_cache:
            rng = np.random.Generator(
                np.random.Philox(key=np.array([self.shuffle_seed, epoch], dtype=np.uint64)))
            self._perm_cache = {epoch: rng.permutation(self.num_samples)}
        return int(self._perm_cache[epoch][idx])

    def _advance(self):
        if self.pad_last_batch:
            limit = self.shard_size_padded
        else:
            start, end = self.shard_bounds(self._shard_of(self._epoch))
            limit = end - start
        if self._pos >= limit:
            self._pos = 0
            self._epoch += 1
        idx = self._raw_index(self._epoch, self._pos)
        self._pos += 1
        return idx

    def read_index(self) -> int:
        if not self.random_shuffle:
            return self._advance()
        while len(self._buffer) < self.initial_fill:
            self._buffer.append(self._advance())
        k = int(self._rng.integers(0, len(self._buffer)))
        idx = self._buffer[k]
        self._buffer[k] = self._advance()
        return idx

    def save_state(self) -> dict:
        st = self._rng.bit_generator.state
        inner = dict(st["state"])
        inner["counter"] = [int(x) for x in inner["counter"]]
        inner["key"] = [int(x) for x in inner["key"]]
        rng_state = dict(st, state=inner, buffer=[int(x) for x in st.get("buffer", [])])
        return {"epoch": self._epoch, "pos": self._pos, "buffer": list(self._buffer),
                "rng_counter": list(inner["counter"]), "rng_state": rng_state}

    def restore_state(self, state: dict):
        self._epoch = int(state["epoch"])
        self._pos = int(state["pos"])
        self._buffer = [int(i) for i in state["buffer"]]
        st = state.get("rng_state")
        if st:
            inner = dict(st["state"])
            inner["counter"] = np.array(inner["counter"], dtype=np.uint64)
            inner["key"] = np.array(inner["key"], dtype=np.uint64)
            self._rng.bit_generator.state = dict(
                st, state=inner, buffer=np.array(st.get("buffer", []), dtype=np.uint64))


DALI_SCHEMA("readers.File").DocStr(
    """Reads (file, label) pairs from a directory tree (one class per
    subdirectory), a 'path label' list file, or ``files``/``labels``.
    Outputs: (encoded bytes [uint8], label [int32])."""
).NumInput(0).NumOutput(2).Devices("cpu").MakeReader().AddOptionalArg(
    "file_root", ArgType.STRING, "Directory with class subdirectories.", None
).AddOptionalArg(
    "file_list", ArgType.STRING, "Path to a 'filename label' list file.", None
).AddOptionalArg(
    "files", ArgType.STRING_VEC, "Explicit list of file paths.", None
).AddOptionalArg(
    "labels", ArgType.INT_VEC, "Labels matching `files`.", None
).AddOptionalArg(
    "file_filters", ArgType.STRING_VEC, "Glob filters for file discovery.",
    ["*.jpg", "*.jpeg", "*.png", "*.bmp", "*.tif", "*.tiff", "*.pnm", "*.ppm", "*.pgm",
     "*.pbm", "*.jp2", "*.webp"],
).AddOptionalArg(
    "case_sensitive_filter", ArgType.BOOL, "Case-sensitive glob matching.", False
)


class BaseReader(ReaderOperator):
    """Shared reader plumbing (counterpart of ``dali_tpu/backend/readers.py``
    ``BaseReader``): the dataset index and its ``IndexedLoader`` are built at
    first use, and a checkpoint restored before that is applied then."""

    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._loader: Optional[IndexedLoader] = None
        self._pending_state = None

    def _build_index(self):
        raise NotImplementedError

    def _num_samples(self) -> int:
        raise NotImplementedError

    def _read_payload(self, index: int):
        """One sample's outputs: an array, or a tuple with one per output."""
        raise NotImplementedError

    def _payload_layouts(self):
        return [""]

    def _ensure_loader(self):
        if self._loader is None:
            self._build_index()
            spec = self.spec
            seed = spec.GetArgument("seed", -1)
            if seed is None or seed < 0:
                seed = self.pipeline.seed + self.op_id
            self._loader = IndexedLoader(
                self._num_samples,
                shard_id=spec.GetArgument("shard_id"), num_shards=spec.GetArgument("num_shards"),
                random_shuffle=spec.GetArgument("random_shuffle"),
                initial_fill=spec.GetArgument("initial_fill"),
                stick_to_shard=spec.GetArgument("stick_to_shard"),
                pad_last_batch=spec.GetArgument("pad_last_batch"),
                batch_size=self.pipeline.max_batch_size, seed=seed,
                shuffle_after_epoch=bool(spec.GetArgument("shuffle_after_epoch")),
                shuffle_after_epoch_seed=int(spec.GetArgument("shuffle_after_epoch_seed")))
            if self._pending_state is not None:
                self._loader.restore_state(self._pending_state)
                self._pending_state = None

    def run_batch(self, ctx: HostCtx):
        self._ensure_loader()
        return self._dense_batch_from([self._loader.read_index()
                                       for _ in range(ctx.batch_size)])

    def _dense_batch_from(self, indices):
        """The dense outputs of the samples at loader ``indices`` already
        read: a staged path that cannot go on after reading them (the video
        wire meeting a change of frame size) decodes the same samples here,
        in order (on the pool of a ``SamplePool`` reader)."""
        payloads = self.map_samples(lambda k: self._read_payload(indices[k]), len(indices))
        layouts = self._payload_layouts()
        if not isinstance(payloads[0], tuple):
            return [HostBatch(payloads, layout=layouts[0])]
        return [HostBatch([p[j] for p in payloads], layout=layouts[j] if j < len(layouts) else "")
                for j in range(len(payloads[0]))]

    def reader_meta(self):
        self._ensure_loader()
        ld = self._loader
        return {
            "epoch_size": ld.num_samples,
            "epoch_size_padded": ld.shard_size_padded * ld.num_shards
            if ld.pad_last_batch else ld.num_samples,
            "number_of_shards": ld.num_shards,
            "shard_id": ld.shard_id,
            "pad_last_batch": 1 if ld.pad_last_batch else 0,
            "stick_to_shard": 1 if ld.stick_to_shard else 0,
        }

    def save_state(self):
        if self._loader is None:
            return {"loader": self._pending_state} if self._pending_state else None
        return {"loader": self._loader.save_state()}

    def restore_state(self, state):
        inner = state.get("loader") if state else None
        if inner is None:
            return
        if self._loader is not None:
            self._loader.restore_state(inner)
        else:
            self._pending_state = inner


@register_operator("readers.File", "cpu")
class FileReader(BaseReader):
    def __init__(self, spec, op_id):
        super().__init__(spec, op_id)
        self._files: Optional[List[str]] = None
        self._labels: Optional[List[int]] = None

    def _build_index(self):
        spec = self.spec
        files = spec.GetArgument("files", None)
        file_list = spec.GetArgument("file_list", None)
        file_root = spec.GetArgument("file_root", None)
        self._files, self._labels = [], []
        if files:
            labels = spec.GetArgument("labels", None)
            self._files = [os.path.join(file_root, f) if file_root and not os.path.isabs(f) else f
                           for f in files]
            self._labels = list(labels) if labels else list(range(len(files)))
        elif file_list:
            base = file_root or os.path.dirname(os.path.abspath(file_list))
            with open(file_list) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    path, _, label = line.rpartition(" ")
                    self._files.append(path if os.path.isabs(path) else os.path.join(base, path))
                    self._labels.append(int(label))
        elif file_root and file_root.startswith("s3://"):
            self._list_s3(file_root)
        elif file_root:
            filters = spec.GetArgument("file_filters")
            match = fnmatch.fnmatchcase if spec.GetArgument("case_sensitive_filter") else fnmatch.fnmatch
            lower = not spec.GetArgument("case_sensitive_filter")
            subdirs = sorted(d for d in os.listdir(file_root)
                             if os.path.isdir(os.path.join(file_root, d)))
            for label, sub in enumerate(subdirs):
                subpath = os.path.join(file_root, sub)
                for fname in sorted(os.listdir(subpath)):
                    name = fname.lower() if lower else fname
                    if any(match(name, pat) for pat in filters):
                        self._files.append(os.path.join(subpath, fname))
                        self._labels.append(label)
        else:
            raise ValueError("readers.file requires file_root, file_list, or files")
        if not self._files:
            raise ValueError("readers.file found no files")

    def _list_s3(self, file_root: str):
        """An s3:// root's files and labels: labels enumerate every
        first-level prefix, matching files or not, and files are those one
        level down, as the local listing takes them."""
        from .. import _s3

        filters = self.spec.GetArgument("file_filters")
        case_sensitive = self.spec.GetArgument("case_sensitive_filter")
        match = fnmatch.fnmatchcase if case_sensitive else fnmatch.fnmatch
        root_prefix = file_root.rstrip("/") + "/"
        subdirs, by_dir = set(), {}
        for uri in sorted(_s3.list_uris(file_root)):
            sub, _, fname = uri[len(root_prefix):].partition("/")
            if not fname:
                continue
            subdirs.add(sub)
            if "/" in fname:
                continue
            name = fname if case_sensitive else fname.lower()
            if any(match(name, pat) for pat in filters):
                by_dir.setdefault(sub, []).append(uri)
        for label, sub in enumerate(sorted(subdirs)):
            for uri in sorted(by_dir.get(sub, [])):
                self._files.append(uri)
                self._labels.append(label)

    def _num_samples(self) -> int:
        return len(self._files)

    def _read_payload(self, index: int) -> np.ndarray:
        path = self._files[index]
        if path.startswith("s3://"):
            from .. import _s3

            return np.frombuffer(_s3.read_bytes(path), dtype=np.uint8)
        if self.spec.GetArgument("dont_use_mmap"):
            with open(path, "rb") as f:
                return np.frombuffer(f.read(), dtype=np.uint8)
        # a mapping per read, no cache: the array keeps its mapping (and the
        # mapping's file descriptor) alive only as long as the sample lives
        with open(path, "rb") as f:
            try:
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            except (ValueError, OSError):  # empty file / unmappable fs
                return np.frombuffer(f.read(), dtype=np.uint8)
        return np.frombuffer(mm, dtype=np.uint8)

    def run_batch(self, ctx: HostCtx):
        self._ensure_loader()
        indices = [self._loader.read_index() for _ in range(ctx.batch_size)]
        datas = [self._read_payload(i) for i in indices]
        labels = [np.array([self._labels[i]], dtype=np.int32) for i in indices]
        return [HostBatch(datas, source_info=[self._files[i] for i in indices]),
                HostBatch(labels)]
