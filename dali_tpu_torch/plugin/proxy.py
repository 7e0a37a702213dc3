"""DALI proxy for a PyTorch ``DataLoader`` (counterpart of
``dali_tpu/plugin/proxy.py``; DALI's ``plugin/pytorch/experimental/proxy``).

The ``DataLoader``'s workers only build lightweight proxy samples (the
pipeline's raw per-sample inputs, such as encoded JPEG bytes); the pipeline
runs in the main process, where the card is, fed through its named
``external_source`` nodes, and its outputs take the proxies' place in the
collated batch. Device outputs stay ``torch.Tensor``s on the pipeline's
device, as ``plugin.pytorch`` yields them; cpu outputs become CPU tensors.

    pipe = my_pipeline()            # contains fn.external_source(name="images")
    with proxy.DALIServer(pipe) as server:
        dataset = MyDataset(..., transform=server.proxy)   # workers call proxy(x)
        loader = proxy.DataLoader(server, dataset, batch_size=16, num_workers=2)
        for data, label in loader:  # data was produced by the pipeline
            ...

The workers may be forked after the pipeline has built (CUDA initialised,
executor threads running): a ``DALIProxy`` holds only input names, and the
workers call nothing of the pipeline.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.utils.data

from ..tensors import TensorListCPU


class _ProxySample:
    """A worker-side reference: the raw per-sample inputs of the pipeline."""

    __slots__ = ("inputs",)

    def __init__(self, inputs):
        self.inputs = tuple(np.asarray(x) for x in inputs)


class _ProxyBatch:
    """Collated proxy samples waiting for the pipeline."""

    __slots__ = ("samples",)

    def __init__(self, samples: List[_ProxySample]):
        self.samples = samples


class DALIProxy:
    """Picklable callable handed to dataset transforms in worker processes."""

    def __init__(self, input_names: Sequence[str]):
        self._input_names = list(input_names)

    def __call__(self, *inputs):
        if len(inputs) != len(self._input_names):
            raise ValueError(
                f"proxy expects {len(self._input_names)} inputs "
                f"({self._input_names}), got {len(inputs)}")
        return _ProxySample(inputs)


class DALIServer:
    """Owns the pipeline; runs it on proxy batches and puts its outputs in
    their place (reference ``DALIServer``). ``input_names`` default to the
    pipeline's ``external_source`` nodes without a source, in graph order."""

    def __init__(self, pipeline, input_names: Optional[Sequence[str]] = None):
        self._pipe = pipeline
        self._input_names = list(input_names) if input_names is not None else None

    def _names(self) -> List[str]:
        if self._input_names is None:
            self._pipe.build()  # tracing happens at build
            names = self._discover_input_names(self._pipe)
            if not names:
                raise ValueError(
                    "DALIServer pipeline needs at least one named external_source")
            self._input_names = names
        return self._input_names

    @staticmethod
    def _discover_input_names(pipeline):
        names = []
        for node in pipeline._traced_ops:
            spec = node.spec
            if spec.schema_name == "ExternalSource" and spec._extra.get("_source") is None \
                    and spec.GetArgument("source", None) is None:
                names.append(node.instance_name)
        return names

    @property
    def proxy(self) -> DALIProxy:
        return DALIProxy(self._names())

    def __enter__(self):
        self._pipe.build()
        return self

    def __exit__(self, *exc):
        return False

    # -- batch production -------------------------------------------------------
    def _run_proxy_batch(self, pb: _ProxyBatch):
        bs = self._pipe.max_batch_size
        n = len(pb.samples)
        if n > bs:
            raise ValueError(
                f"proxy batch of {n} exceeds pipeline batch size {bs}; "
                "use DataLoader(batch_size<=pipeline batch_size)")
        for k, name in enumerate(self._names()):
            samples = [s.inputs[k] for s in pb.samples]
            # a partial last batch is padded with its tail sample; the
            # outputs are trimmed back to n
            samples = samples + [samples[-1]] * (bs - n)
            self._pipe.feed_input(name, samples)
        outs = [_to_torch(tl, n) for tl in self._pipe.run()]
        return tuple(outs) if len(outs) > 1 else outs[0]

    def produce_data(self, obj: Any):
        """Replace every proxy batch inside a collated structure with the
        pipeline's outputs (reference ``DALIServer.produce_data``)."""
        if isinstance(obj, _ProxyBatch):
            return self._run_proxy_batch(obj)
        if isinstance(obj, tuple) and hasattr(obj, "_fields"):
            return type(obj)(*(self.produce_data(v) for v in obj))
        if isinstance(obj, (list, tuple)):
            return type(obj)(self.produce_data(v) for v in obj)
        if isinstance(obj, dict):
            return {k: self.produce_data(v) for k, v in obj.items()}
        return obj


def _to_torch(tl, n):
    """The first ``n`` samples of an output: one tensor when dense, else a
    list of per-sample tensors cropped to their shapes; on the pipeline's
    device for a device output."""
    if isinstance(tl, TensorListCPU):
        if len(set(tl.shape()[:n])) == 1:
            return torch.from_numpy(np.stack([tl.at(i) for i in range(n)]))
        return [torch.from_numpy(np.ascontiguousarray(tl.at(i))) for i in range(n)]
    data = tl.as_tensor()
    if tl.is_dense_tensor():
        return data[:n]
    return [data[i][tuple(slice(0, e) for e in shape)] for i, shape in enumerate(tl.shape()[:n])]


class _Collate:
    """The collate function of the workers: proxy samples become one proxy
    batch, tuples, namedtuples, lists and dicts are collated per field, and
    the rest by ``base`` (a class, not a closure, so that ``spawn`` workers
    can unpickle it)."""

    def __init__(self, base):
        self._base = base

    def __call__(self, items):
        if items and isinstance(items[0], _ProxySample):
            return _ProxyBatch(list(items))
        if items and isinstance(items[0], (tuple, list)):
            cols = [self(list(c)) for c in zip(*items)]
            if isinstance(items[0], tuple) and hasattr(items[0], "_fields"):
                # a namedtuple's constructor takes one argument per field
                return type(items[0])(*cols)
            return type(items[0])(cols)
        if items and isinstance(items[0], dict):
            return {k: self([d[k] for d in items]) for k in items[0]}
        return self._base(items)


class DataLoader:
    """``torch.utils.data.DataLoader`` whose workers collate proxy samples;
    the main process runs the pipeline on each batch (reference
    ``dali_proxy.DataLoader``)."""

    def __init__(self, server: DALIServer, dataset, **kwargs):
        self._server = server
        kwargs.setdefault("collate_fn", _Collate(torch.utils.data.default_collate))
        self._loader = torch.utils.data.DataLoader(dataset, **kwargs)

    def __len__(self):
        return len(self._loader)

    def __iter__(self):
        for batch in self._loader:
            yield self._server.produce_data(batch)
