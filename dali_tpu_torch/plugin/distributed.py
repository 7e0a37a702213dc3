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
stride given assembles it without moving data; one all_gather of the
ranks' shapes of every output, once a batch, first refuses shards of
different shapes, as the reference refuses them. The reference's split of
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


# the dimensions of a shape that ``check_shard_shapes`` gathers
_MAX_NDIM = 15


def check_shard_shapes(locals_: dict, mesh):
    """Raises ``ValueError`` on every rank when the ranks' local batches
    differ in shape, naming the first output that differs and each rank's
    shape, as the reference's ``jax.make_array_from_single_device_arrays``
    refuses shards of different shapes. ``locals_`` maps each output's name
    to the rank's batch; one all_gather of a small int64 tensor on the
    mesh's device carries the shapes of all of them (gloo serves CUDA
    tensors too)."""
    import torch.distributed as dist

    names = list(locals_)
    mine = torch.full((len(names), _MAX_NDIM + 1), -1, dtype=torch.int64)
    for i, name in enumerate(names):
        local = locals_[name]
        mine[i, 0] = local.ndim
        kept = tuple(local.shape)[:_MAX_NDIM]
        mine[i, 1:1 + len(kept)] = torch.tensor(kept, dtype=torch.int64)
    mine = mine.to(mesh_device(mesh))
    gathered = [torch.empty_like(mine) for _ in range(mesh.size())]
    dist.all_gather(gathered, mine, group=mesh.get_group())
    table = torch.stack(gathered).cpu().tolist()  # [rank][output][ndim, dims...]
    for i, name in enumerate(names):
        rows = [t[i] for t in table]
        if any(r[0] > _MAX_NDIM for r in rows):  # every rank raises alike
            raise ValueError(f"output {name!r}: a rank's batch has more than {_MAX_NDIM} "
                             "dimensions")
        shapes = [tuple(r[1:1 + r[0]]) for r in rows]
        if any(s != shapes[0] for s in shapes):
            per_rank = ", ".join(f"rank {r}: {list(s)}" for r, s in enumerate(shapes))
            raise ValueError(
                f"output {name!r}: the ranks' local batches differ in shape ({per_rank}); a "
                "global batch needs every rank's shard to have the same shape (pad or resize "
                "the samples to one shape in the pipeline)")


def global_batches(locals_: dict, mesh) -> dict:
    """Each output's batch on this rank as its shard of the global batch: a
    ``DTensor`` placed ``Shard(0)`` on the 1-D ``mesh``, of ``shape[0] *
    mesh.size()`` samples. Every rank's batch of an output must have the
    same shape: ``check_shard_shapes`` raises ``ValueError`` on every rank
    otherwise, after one collective for all the outputs."""
    from torch.distributed.tensor import Shard

    check_shard_shapes(locals_, mesh)
    dev = mesh_device(mesh)
    return {name: from_shard(local.to(dev), mesh, [Shard(0)],
                             (local.shape[0] * mesh.size(),) + tuple(local.shape[1:]))
            for name, local in locals_.items()}


def global_batch(local: torch.Tensor, mesh, name: str = "output"):
    """``global_batches`` of one output."""
    return global_batches({name: local}, mesh)[name]


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
        return global_batches({k: batches[0][k].as_tensor() for k in self.output_map},
                              self._mesh)


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
