"""Global batches across ranks: counterpart of ``dali_tpu/plugin/jax.py``.

DALI's distributed model is dataset sharding plus one pipeline per
accelerator (SURVEY §5.8): each pipeline's reader takes ``shard_id`` and
``num_shards`` and the framework assembles the shards. In JAX one process
addresses several devices, and the reference builds one global
``jax.Array`` from its local devices' shards (``jax.py:51-89``). PyTorch runs
one rank per device, so here each rank drives exactly one pipeline, the one
feeding its own device, and a global batch is a
``torch.distributed.tensor.DTensor`` placed ``Shard(0)`` on a 1-D
``DeviceMesh``: the rank's batch is its local shard, and the global batch
is the per-rank batch times the mesh size, as ``jax.py:84-87`` computes it.
``DTensor.from_local(..., run_check=False)`` with the global shape and
stride given assembles it without communication. The reference's split of
one pipeline's batch over several local devices (``jax.py:65-75``) has no
counterpart: a rank has one device.

``DALIGenericIterator`` without a mesh yields what the reference yields
without a ``sharding``: one dict of tensors for one pipeline, a list of dicts
for several. ``DALIPeekableIterator`` adds ``peek``/``peek_async``
(``jax.py:92-115``) and ``data_iterator`` (``jax.py:118-167``) builds the
rank's pipeline with ``shard_id`` = its coordinate on the mesh and
``num_shards`` = the mesh's size (the reference's ``base + i`` and
``mesh.devices.size``), on ``cuda:{torch.cuda.current_device()}`` for a CUDA
mesh (as torchrun scripts set it) and on the CPU for a CPU mesh.
"""

from __future__ import annotations

import torch

from .base_iterator import DALIGenericIterator as _Base
from .base_iterator import LastBatchPolicy  # noqa: F401  (re-export)


def mesh_device(mesh) -> torch.device:
    """The device a rank's shard lives on: its current CUDA device on a CUDA
    mesh, the CPU on a CPU mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def from_shard(local: torch.Tensor, mesh, placements, shape):
    """The ``DTensor`` of global ``shape`` (contiguous) whose shard on this
    rank is ``local``, without communication: every rank passes its shard."""
    from torch.distributed.tensor import DTensor

    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(local.contiguous(), mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def global_batch(local: torch.Tensor, mesh):
    """The rank's batch as its shard of the global batch: a ``DTensor``
    placed ``Shard(0)`` on the 1-D ``mesh``, of ``local.shape[0] *
    mesh.size()`` samples. Every rank's batch must have the same shape."""
    from torch.distributed.tensor import Shard

    shape = (local.shape[0] * mesh.size(),) + tuple(local.shape[1:])
    return from_shard(local.to(mesh_device(mesh)), mesh, [Shard(0)], shape)


class DALIGenericIterator(_Base):
    """Yields dicts of ``torch.Tensor``s, or of ``DTensor``s with
    ``device_mesh`` (a 1-D ``DeviceMesh`` over the ranks; this rank drives
    one pipeline, its shard)."""

    def __init__(self, pipelines, output_map, *, device_mesh=None, **kwargs):
        self._mesh = device_mesh
        if device_mesh is not None:
            if kwargs.get("last_batch_policy") == LastBatchPolicy.PARTIAL:
                raise ValueError(
                    "LastBatchPolicy.PARTIAL is not supported with a device mesh: trimming a "
                    "globally sharded batch is not well-defined (use FILL or DROP, like the "
                    "reference JAX plugin)")
            if device_mesh.ndim != 1:
                raise NotImplementedError(
                    f"a {device_mesh.ndim}-D device mesh: the iterator shards the batch over a "
                    "1-D mesh of ranks (ROADMAP Queue 1 item 6); take the data axis's 1-D "
                    "sub-mesh, mesh['data']")
            n = len(pipelines) if isinstance(pipelines, (list, tuple)) else 1
            if n != 1:
                raise ValueError(
                    f"{n} pipelines on one rank of the mesh: drive one pipeline per rank, the "
                    "shard of this rank's device (torch has one device per rank)")
        super().__init__(pipelines, output_map, **kwargs)

    def _to_framework(self, batches):
        if self._mesh is None:
            outs = [{k: v.as_tensor() for k, v in b.items()} for b in batches]
            return outs[0] if len(outs) == 1 else outs
        return {k: global_batch(batches[0][k].as_tensor(), self._mesh) for k in self.output_map}


class DALIPeekableIterator(DALIGenericIterator):
    """Iterator with ``peek()``: the CLU ``PeekableDatasetIterator`` surface
    (reference ``plugin/jax/clu.py``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._peeked = None

    def peek(self):
        if self._peeked is None:
            self._peeked = super().__next__()
        return self._peeked

    def peek_async(self):
        """The next element without consuming it, as a 0-argument callable."""
        el = self.peek()
        return lambda: el

    def __next__(self):
        if self._peeked is not None:
            out, self._peeked = self._peeked, None
            return out
        return super().__next__()


def data_iterator(pipeline_fn=None, output_map=None, *, device_mesh=None, reader_name=None,
                  auto_reset=False, last_batch_policy=LastBatchPolicy.FILL,
                  **iterator_kwargs):
    """Decorator turning a ``@pipeline_def``-style function into an
    iterator factory (reference ``plugin/jax/iterator.py``
    ``data_iterator``). With ``device_mesh`` the graph function receives
    ``shard_id`` and ``num_shards`` (a function that does not take them
    raises, as in the reference) and the pipeline runs on the rank's
    device."""

    def decorator(fn):
        def create(*args, **kwargs):
            from ..pipeline import pipeline_def

            pd = fn if getattr(fn, "is_pipeline_def", False) else pipeline_def(fn)
            if device_mesh is None:
                pipe = pd(*args, **kwargs)
            else:
                kwargs.setdefault("device", str(mesh_device(device_mesh)))
                pipe = pd(*args, shard_id=device_mesh.get_local_rank(),
                          num_shards=device_mesh.size(), **kwargs)
            return DALIGenericIterator(
                [pipe], output_map, device_mesh=device_mesh, reader_name=reader_name,
                auto_reset=auto_reset, last_batch_policy=last_batch_policy, **iterator_kwargs)

        return create

    if pipeline_fn is not None:
        return decorator(pipeline_fn)
    return decorator
