"""The pipeline executor of the PyTorch port (counterpart of
``dali_tpu/executor.py``).

Two stage threads, as in the reference:

* **host phase** — readers, the host halves of mixed ops and cpu ops, then
  the boundary staging and the host-side setup pass of the device ops
  (parameters, statics, output shapes and layouts in numpy: nothing is read
  back from the device per batch). A ragged host
  batch is padded onto a grow-only canvas per boundary edge: the canvas only
  grows (rounded up to the pipeline's ``pad_align`` on spatial dims), which bounds the
  number of distinct device shapes, and so of cuFFT plans and allocator
  sizes, as the reference bounds its recompiles;
* **device phase** — each staged host buffer is copied once to the device
  (pinned, ``non_blocking``, on a copy stream that the compute stream waits
  on through an event; small arrays packed into one buffer), the
  coefficient wires are decoded, and every device op's ``lower`` runs
  eagerly in graph order on the compute stream. Each device value is
  dropped after its last consumer, so a predicated graph holds only its
  live branches.

The device phase of iteration k overlaps the host phase of iteration k+1;
``prefetch_queue_depth`` bounds both queues.
"""

from __future__ import annotations

import atexit
import queue
import threading
import time
import weakref
from typing import Dict, List, Tuple

import numpy as np
import torch

from ._schema import get_operator_impl
from .backend.base import (BF16_BITS, BF16_WIDEN, SHAPE_PRESERVING_SCHEMAS, DeviceCtx, HostCtx,
                           Operator, ReaderOperator)
from .batch import (DeviceBatch, Esc16Staged, FlatStaged, HostBatch, SparseStaged, Staged,
                    YUVStaged, pad_and_stack)
from .kernels import wire
from .tensors import TensorListCPU, TensorListGPU
from .types import DALIDataType, to_bfloat16, to_numpy_type


# Canvas alignment of spatial dims where no pipeline sets one (eager mode):
# dali_tpu's default ``pad_align``, so the port's canvases, and so its output
# shapes, equal the reference's.
PAD_ALIGN = 64
# host arrays up to this size cross to the device packed in one buffer
PACK_BYTES = 1 << 16
_TORCH_DTYPES = {np.dtype(k): v for k, v in (
    (np.uint8, torch.uint8), (np.int8, torch.int8), (np.int16, torch.int16),
    (np.uint16, torch.uint16), (np.int32, torch.int32), (np.uint32, torch.uint32),
    (np.int64, torch.int64), (np.uint64, torch.uint64), (np.float16, torch.float16),
    (np.float32, torch.float32), (np.float64, torch.float64), (np.bool_, torch.bool))}


# executors whose stage threads run: stopped at interpreter exit, before
# Python finalizes. A daemon thread still inside a torch call when the
# interpreter finalizes is unwound by pthread_exit through C++ frames that
# cannot be unwound, and the process aborts ("terminate called without an
# active exception"), as two prefetching pipelines left running did.
_RUNNING = weakref.WeakSet()


@atexit.register
def _stop_running_at_exit():
    for ex in list(_RUNNING):
        ex._stop_threads()


def _edge_key(edge) -> Tuple[int, int]:
    return (edge.source.id, edge.source_idx)


def _is_bf16_batch(b) -> bool:
    return isinstance(b, HostBatch) and b.dtype == torch.bfloat16


def _identity(outs):
    return outs


def bfloat16_route(impl, what: str, inputs):
    """The host inputs of ``impl`` as it reads them, and the function that
    turns its outputs back. A bfloat16 host input (``torch.bfloat16``
    samples; numpy has no bfloat16) follows the op's ``reads_bfloat16``
    route, as dali_tpu computes on its ml_dtypes arrays:

    * ``True``: the op reads ``torch.bfloat16`` samples itself;
    * ``BF16_BITS``: it moves bits, so it runs on the int16 bits and its
      int16 outputs are bfloat16 again (unless its ``dtype`` says int16);
    * ``BF16_WIDEN``: the reference widens to float32 before any
      arithmetic: the op runs on the exact float32 upcast, outputs as
      computed;
    * ``BF16_ROUND``: as ``BF16_WIDEN``, and the float32 outputs that follow
      the input's type (``bfloat16_outputs``, all by default) are rounded to
      bfloat16 (``types.to_bfloat16``) unless the op's ``dtype`` is set.

    An op without a route raises ``TypeError``: dali_tpu refuses a bfloat16
    input there too."""
    route = impl.reads_bfloat16
    if route is True or not any(_is_bf16_batch(b) for b in inputs):
        return inputs, _identity
    if not route:
        raise TypeError(f"{what} does not read a bfloat16 host input, as dali_tpu's does not "
                        "either: cast it first")
    bits = route == BF16_BITS
    conv = [HostBatch([s.contiguous().view(torch.int16).numpy() if bits
                       else s.to(torch.float32).numpy() for s in b.samples], b.layout,
                      b.source_info) if _is_bf16_batch(b) else b for b in inputs]
    if route == BF16_WIDEN or impl.spec.args.get("dtype") is not None:
        return conv, _identity
    want = np.int16 if bits else np.float32
    which = impl.bfloat16_outputs

    def finish(outs):
        back = []
        for j, o in enumerate(outs):
            if isinstance(o, HostBatch) and (which is None or j in which) and o.samples and all(
                    isinstance(x, np.ndarray) and x.dtype == want for x in o.samples):
                o = HostBatch([torch.from_numpy(np.ascontiguousarray(x)).view(torch.bfloat16)
                               if bits else to_bfloat16(x) for x in o.samples], o.layout,
                              o.source_info)
            back.append(o)
        return back

    return conv, finish


def pad_align_for(hb: HostBatch, pad_align: int = PAD_ALIGN) -> List[int]:
    """Canvas alignment of a ragged host batch: spatial dims align to
    ``pad_align``; channel-like dims ('C', 'N', or an unnamed trailing dim of
    at most 4) stay exact."""
    align = [pad_align] * hb.ndim
    for d, name in enumerate(hb.layout[:hb.ndim]):
        if name in ("C", "N"):
            align[d] = 1
    if not hb.layout and hb.ndim >= 1 and hb.samples[0].shape[-1] <= 4:
        align[-1] = 1
    return align


def stack_arg(hb: HostBatch) -> np.ndarray:
    """A host argument batch of a device op, stacked [N, ...] for the copy."""
    return np.stack([np.asarray(s) for s in hb.samples])


def setup_device_op(impl: Operator, ctx: HostCtx, in_shapes, in_layouts, in_batches,
                    arg_batches: Dict[str, HostBatch]):
    """The host-side setup pass of one device op: its input layouts and host
    argument batches into ``ctx``, then ``host_params``, ``device_statics``,
    ``host_output_shapes`` (carried through value-only ops) and the output
    layouts. ``in_batches`` holds the host batch of each input that crossed
    from the host, else None. Returns (params as numpy arrays or None,
    statics, per-output host shapes or None, per-output layouts)."""
    ctx.op_in_layouts[impl.op_id] = list(in_layouts)
    ctx.set_arg_batches(impl.op_id, arg_batches)
    n_out = impl.spec.num_outputs()
    louts = impl.host_output_layouts(list(in_layouts)) or [""]
    out_layouts = [louts[min(j, len(louts) - 1)] or "" for j in range(n_out)]
    p = impl.host_params(ctx, in_shapes)
    params = {name: np.asarray(v) for name, v in p.items()} if p else None
    statics = impl.device_statics(ctx, in_shapes, in_batches)
    out_shapes = impl.host_output_shapes(ctx, in_shapes, in_batches)
    if (out_shapes is None and impl.spec.schema_name in SHAPE_PRESERVING_SCHEMAS
            and in_shapes and in_shapes[0] is not None):
        out_shapes = [in_shapes[0]] * n_out
    out_shapes = [None if sh is None else np.asarray(sh) for sh in (out_shapes or [])]
    out_shapes += [None] * (n_out - len(out_shapes))
    return params, statics, out_shapes, out_layouts


def run_device_op(impl: Operator, ctx: HostCtx, inputs: List[DeviceBatch], in_shapes,
                  in_batches, arg_batches: Dict[str, HostBatch], device: torch.device):
    """One device op on its own, as eager mode runs it: the setup pass of
    :func:`setup_device_op`, its parameters and host argument batches copied
    to ``device``, then ``lower``. Returns (output DeviceBatches, per-output
    host shapes or None)."""
    params, statics, out_shapes, _ = setup_device_op(
        impl, ctx, in_shapes, [b.layout for b in inputs], in_batches, arg_batches)

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    dctx = DeviceCtx({impl.op_id: {k: to_dev(stack_arg(b)) for k, b in arg_batches.items()
                                   if k not in impl.host_args}},
                     {} if statics is None else {impl.op_id: statics},
                     {impl.op_id: {k: to_dev(v) for k, v in (params or {}).items()}},
                     batch_size=ctx.batch_size, seed=ctx.pipeline.seed,
                     iteration=ctx.iteration, device=torch.device(device))
    return list(impl.lower(dctx, *inputs)), out_shapes


class Executor:
    def __init__(self, pipeline, graph):
        self.pipeline = pipeline
        self.graph = graph
        self.device = pipeline.device
        self.impls: Dict[int, Operator] = {}
        self.host_ops, self.device_ops = [], []
        for node in graph.ops:
            impl = get_operator_impl(node.spec.schema_name, node.device)(node.spec, node.id)
            impl.pipeline = pipeline
            self.impls[node.id] = impl
            (self.host_ops if node.device in ("cpu", "mixed") else self.device_ops).append(node)
        host_ids = {n.id for n in self.host_ops}
        for node in self.device_ops:
            for inp in node.spec.inputs:
                if inp.source.id in host_ids and inp.device == "cpu":
                    raise ValueError(f"GPU operator '{node.instance_name}' consumes CPU edge "
                                     f"'{inp.name}'; call .gpu() on it first")
        for node in graph.ops:
            if node.device == "cpu" and any(i.device == "gpu" for i in node.spec.inputs):
                raise ValueError(f"CPU operator '{node.instance_name}' cannot consume GPU input")
        # batch-size providers (readers, external sources) run first, as in
        # the reference
        self._providers = {n.id for n in self.host_ops
                           if (n.spec.schema.is_reader or n.spec.schema_name == "ExternalSource")
                           and not n.spec.inputs and not n.spec.arg_inputs}
        self.host_ops.sort(key=lambda n: 0 if n.id in self._providers else 1)

        self.boundary_edges: List = []
        seen = set()
        for edge in [i for n in self.device_ops for i in n.spec.inputs] + [
                o for o in graph.outputs if o.device == "gpu"]:
            k = _edge_key(edge)
            if edge.source.id in host_ids and k not in seen:
                seen.add(k)
                self.boundary_edges.append(edge)
        # argument inputs of device ops: a CPU edge is stacked on the host and
        # copied with the batch; a GPU edge (e.g. a per-sample reduction as
        # contrast_center) resolves from the device env
        self.device_arg_edges = []
        self.device_arg_dev_edges: Dict[Tuple[int, str], Tuple[int, int]] = {}
        for node in self.device_ops:
            for name, edge in node.spec.arg_inputs.items():
                if edge.source.id in host_ids:
                    if name not in self.impls[node.id].host_args:
                        self.device_arg_edges.append((node.id, name, edge))
                else:
                    self.device_arg_dev_edges[(node.id, name)] = _edge_key(edge)
        # each device value is released after its last consumer; graph
        # outputs stay
        out_keys = {_edge_key(o) for o in graph.outputs}
        last_use: Dict[Tuple[int, int], int] = {}
        for k, node in enumerate(self.device_ops):
            for e in node.spec.inputs:
                last_use[_edge_key(e)] = k
            for name in node.spec.arg_inputs:
                key = self.device_arg_dev_edges.get((node.id, name))
                if key is not None:
                    last_use[key] = k
        self._release_after: List[List[Tuple[int, int]]] = [[] for _ in self.device_ops]
        for key, k in last_use.items():
            if key not in out_keys:
                self._release_after[k].append(key)

        # grow-only padded canvas per ragged boundary edge
        self._canvas: Dict[Tuple[int, int], List[int]] = {}
        self._iteration = 0
        self._epoch = 0
        self._consumed_ckpt = None
        self._threads: List[threading.Thread] = []
        self._new_queues()
        self._shutdown = False
        self._error = None
        # worker processes of parallel external sources start now, before
        # any stage thread exists (a fork copies no executor thread)
        for impl in self.impls.values():
            if getattr(impl, "parallel", False):
                impl.start_pool(pipeline)
        self._copy_stream = None
        # per-stage CUDA event pairs of the next device phase, when requested
        # (chip_smoke.py's instrumented batch): [(stage, start, end), ...]
        self.record_stage_events = False
        self.stage_events: List[Tuple[str, object, object]] = []
        # cumulative host-clock seconds: host phase work, the host stage's
        # wait for room in the queue, the device phase's work and its wait
        # for staged batches (its idle time on the host side); the host
        # phase's thread CPU seconds; batches done by each stage
        self.stats = {"host_batches": 0, "host_phase_seconds": 0.0, "host_phase_cpu_seconds": 0.0,
                      "host_stall_seconds": 0.0, "device_wait_seconds": 0.0,
                      "device_phase_seconds": 0.0, "iterations_completed": 0}
        # cumulative host-clock seconds by operator schema: host ops, and the
        # host-side setup pass of device ops
        self.host_seconds_by_schema: Dict[str, float] = {}

    # -- lifecycle --------------------------------------------------------------------
    def _new_queues(self):
        self._work_q: "queue.Queue" = queue.Queue()
        self._device_q: "queue.Queue" = queue.Queue(maxsize=self.pipeline.cpu_queue_depth)
        self._out_q: "queue.Queue" = queue.Queue(maxsize=self.pipeline.gpu_queue_depth)

    def start(self):
        if not self._threads:
            # each thread is bound to its generation's queues: a thread that
            # outlives reset() can never feed the next generation's
            qs = (self._work_q, self._device_q, self._out_q)
            self._threads = [
                threading.Thread(target=self._host_loop, args=qs[:2], name="dali-torch-host",
                                 daemon=True),
                threading.Thread(target=self._device_loop, args=qs[1:], name="dali-torch-device",
                                 daemon=True),
            ]
            for t in self._threads:
                t.start()
            _RUNNING.add(self)

    def _stop_threads(self):
        """Stop both stage threads. Queues are drained while joining: a stage
        thread may be blocked in put() on a full bounded queue."""
        self._shutdown = True
        self._work_q.put(None)
        deadline = time.monotonic() + 10
        while any(t.is_alive() for t in self._threads) and time.monotonic() < deadline:
            for q in (self._device_q, self._out_q):
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
            try:
                self._device_q.put_nowait(None)
            except queue.Full:
                pass
            for t in self._threads:
                t.join(timeout=0.05)
        if any(t.is_alive() for t in self._threads):
            raise RuntimeError("dali_tpu_torch executor threads did not stop within 10 s")
        self._threads = []
        _RUNNING.discard(self)

    def shutdown(self):
        """Stop both stage threads, then release the operators' native
        resources and worker processes."""
        self._stop_threads()
        for impl in self.impls.values():
            impl.close()

    def reset(self):
        """Start the next epoch: clear a raised ``StopIteration`` (or any
        error), drop the scheduled iterations, restart the stage threads on
        fresh queues at the next ``schedule_run`` and call each operator's
        ``reset_epoch``."""
        self._stop_threads()
        self._shutdown = False
        self._error = None
        self._consumed_ckpt = None
        self._new_queues()
        for impl in self.impls.values():
            impl.reset_epoch()

    def schedule_run(self):
        if self._error is not None:
            raise self._error
        self.start()
        self._work_q.put(self._iteration)
        self._iteration += 1

    def outputs(self):
        if self._error is not None:
            raise self._error
        item = self._out_q.get()
        if isinstance(item, BaseException):
            self._error = item
            raise item
        result, ckpt = item
        if ckpt is not None:
            self._consumed_ckpt = ckpt
        return result

    def _host_loop(self, work_q, device_q):
        while not self._shutdown:
            it = work_q.get()
            if it is None:
                break
            try:
                t0, c0 = time.perf_counter(), time.thread_time()
                staged = self._host_phase(it)
                if self.pipeline.enable_checkpointing:
                    st = self.checkpoint_state()
                    st["iteration"] = it + 1
                    staged["ckpt"] = st
                t1, c1 = time.perf_counter(), time.thread_time()
                self.stats["host_phase_seconds"] += t1 - t0
                self.stats["host_phase_cpu_seconds"] += c1 - c0
                self.stats["host_batches"] += 1
            except BaseException as e:  # surfaces at the next outputs()
                device_q.put(e)
                return
            device_q.put(staged)
            self.stats["host_stall_seconds"] += time.perf_counter() - t1

    def _device_loop(self, device_q, out_q):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._shutdown:
            t0 = time.perf_counter()
            staged = device_q.get()
            self.stats["device_wait_seconds"] += time.perf_counter() - t0
            if staged is None:
                break
            if isinstance(staged, BaseException):
                out_q.put(staged)
                return
            try:
                t1 = time.perf_counter()
                result = self._device_phase(staged)
                self.stats["device_phase_seconds"] += time.perf_counter() - t1
                self.stats["iterations_completed"] += 1
            except BaseException as e:
                out_q.put(e)
                return
            out_q.put((result, staged.get("ckpt")))

    # -- host phase -------------------------------------------------------------------
    def _timed(self, node, t0):
        name = node.spec.schema_name
        self.host_seconds_by_schema[name] = (self.host_seconds_by_schema.get(name, 0.0)
                                             + time.perf_counter() - t0)

    def _host_phase(self, iteration: int) -> dict:
        ctx = HostCtx(self.pipeline, iteration, self._epoch)
        env: Dict[Tuple[int, int], object] = {}
        for node in self.host_ops:
            t0 = time.perf_counter()
            impl = self.impls[node.id]
            ctx.set_arg_batches(node.id, {k: env[_edge_key(v)] for k, v in node.spec.arg_inputs.items()})
            ins = [env[_edge_key(e)] for e in node.spec.inputs]
            ins, finish = bfloat16_route(impl, f"{node.spec.schema_name}({node.device})", ins)
            if node.device == "mixed" and hasattr(impl, "stage_batch"):
                # a mixed op may decode straight into its boundary canvas
                # (the edge's grow-only canvas), or decline (None)
                k = (node.id, 0)
                staged = impl.stage_batch(ctx, ins, self._canvas.get(k))
                if staged is not None:
                    arr, shapes, layout = staged
                    self._canvas[k] = list(arr.shape[1:])
                    env[k] = Staged(arr, shapes, layout)
                    self._timed(node, t0)
                    continue
            outs = None
            if node.device == "mixed" and hasattr(impl, "stage_batch_multi"):
                # a mixed op may stage its own boundary wire, or decline (None)
                outs = impl.stage_batch_multi(ctx, ins)
            if outs is None:
                outs = finish(impl.run_batch(ctx, *ins))
            for j, out in enumerate(outs):
                if isinstance(out, YUVStaged):
                    # the planar wire shares the edge's grow-only canvas with
                    # the dense RGB staging it alternates with
                    prev = self._canvas.get((node.id, j)) or [0, 0, 0, 3]
                    out.canvas = tuple(max(int(a), int(b)) for a, b in zip(prev, out.canvas))
                    self._canvas[(node.id, j)] = list(out.canvas)
                env[(node.id, j)] = out
            if node.id in self._providers:
                ctx.batch_size = len(outs[0])
            self._timed(node, t0)

        boundary, shape_env, layout_env = [], {}, {}
        for edge in self.boundary_edges:
            k = _edge_key(edge)
            item = env[k]
            if isinstance(item, HostBatch):
                # a uniform batch stages exact, unless the canvas has grown
                align = (1 if item.is_uniform()
                         else pad_align_for(item, self.pipeline.pad_align))
                arr, shapes = pad_and_stack(item, canvas=self._canvas.get(k), align=align)
                self._canvas[k] = list(arr.shape[1:])
                item = Staged(arr, shapes, item.layout, bfloat16=item.dtype == torch.bfloat16)
            boundary.append(item)
            shape_env[k] = item.shapes
            layout_env[k] = item.layout or ""

        args = [stack_arg(env[_edge_key(e)]) for _, _, e in self.device_arg_edges]
        statics, params = {}, {}
        for node in self.device_ops:
            t0 = time.perf_counter()
            in_batches = [env.get(_edge_key(e)) for e in node.spec.inputs]
            arg_b = {k: env.get(_edge_key(v)) for k, v in node.spec.arg_inputs.items()}
            p, st, out_shapes, out_layouts = setup_device_op(
                self.impls[node.id], ctx,
                [shape_env.get(_edge_key(e)) for e in node.spec.inputs],
                [layout_env.get(_edge_key(e), "") for e in node.spec.inputs],
                [b if isinstance(b, HostBatch) else None for b in in_batches],
                {k: v for k, v in arg_b.items() if isinstance(v, HostBatch)})
            if p:
                params[node.id] = p
            if st is not None:
                statics[node.id] = st
            for j, lay in enumerate(out_layouts):
                layout_env[(node.id, j)] = lay
            for j, sh in enumerate(out_shapes):
                if sh is not None:
                    shape_env[(node.id, j)] = sh
            self._timed(node, t0)
        return {
            "iteration": iteration,
            "batch_size": ctx.batch_size,
            "boundary": boundary,
            "args": args,
            "params": params,
            "statics": statics,
            "cpu_outputs": {_edge_key(o): env[_edge_key(o)] for o in self.graph.outputs
                            if o.device != "gpu"},
            "out_shapes": {_edge_key(o): shape_env.get(_edge_key(o)) for o in self.graph.outputs
                           if o.device == "gpu"},
        }

    # -- device phase -----------------------------------------------------------------
    def _event(self, stream=None):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def _to_device(self, staged: dict, timing: bool):
        """Copy every staged host array to the device once. Arrays of at
        most ``PACK_BYTES`` travel packed in one buffer (one pinned copy for
        the many per-sample scalars of a conditional graph) and are views of
        it on the device. Returns the boundary groups, the stacked arguments
        and the parameters with tensors in place of numpy arrays."""
        groups = []
        for item in staged["boundary"]:
            if isinstance(item, Esc16Staged):
                groups.append((item.dc8, item.esc, item.offsets, item.shapes))
            elif isinstance(item, SparseStaged):
                groups.append((item.mask.view(np.int16), item.nibs, item.esc, item.offsets,
                               item.shapes))
            elif isinstance(item, FlatStaged):
                groups.append((item.flat, item.offsets, item.shapes))
            elif isinstance(item, YUVStaged):
                groups.append((item.y, item.u, item.v, item.offsets, item.shapes))
            else:
                groups.append((item.array, item.shapes))
        groups.append(tuple(staged["args"]))
        pkeys = [(op_id, name) for op_id in sorted(staged["params"])
                 for name in sorted(staged["params"][op_id])]
        groups.append(tuple(staged["params"][o][n] for o, n in pkeys))
        flat = [a if a.flags.c_contiguous else a.copy()
                for a in (np.asarray(a) for grp in groups for a in grp)]
        small = [i for i, a in enumerate(flat) if a.nbytes <= PACK_BYTES]
        offsets, pos = [], 0
        for i in small:
            offsets.append(pos)
            pos += -(-flat[i].nbytes // 256) * 256
        packed = np.empty(pos, np.uint8)
        for i, off in zip(small, offsets):
            packed[off:off + flat[i].nbytes] = flat[i].reshape(-1).view(np.uint8)
        big = [i for i, a in enumerate(flat) if a.nbytes > PACK_BYTES]
        if self.device.type == "cuda":
            compute = torch.cuda.current_stream(self.device)
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._copy_stream):
                start = self._event(self._copy_stream) if timing else None
                moved = [torch.from_numpy(a).pin_memory().to(self.device, non_blocking=True)
                         for a in [packed] + [flat[i] for i in big]]
                done = self._event(self._copy_stream) if timing else self._copy_stream.record_event()
            compute.wait_event(done)
            for t in moved:
                t.record_stream(compute)
            if timing:
                self.stage_events.append(("h2d", start, done))
        else:
            moved = [torch.from_numpy(np.array(a)) for a in [packed] + [flat[i] for i in big]]
        out: List[torch.Tensor] = [None] * len(flat)
        for i, off in zip(small, offsets):
            a = flat[i]
            out[i] = moved[0][off:off + a.nbytes].view(_TORCH_DTYPES[a.dtype]).reshape(a.shape)
        for i, t in zip(big, moved[1:]):
            out[i] = t
        it = iter(out)
        dev = [tuple(next(it) for _ in grp) for grp in groups]
        params: Dict[int, Dict[str, torch.Tensor]] = {}
        for (op_id, name), t in zip(pkeys, dev[-1]):
            params.setdefault(op_id, {})[name] = t
        return dev[:-2], dev[-2], params

    def _device_phase(self, staged: dict):
        timing = self.record_stage_events and self.device.type == "cuda"
        if timing:
            self.stage_events = []
        dev, dev_args, params = self._to_device(staged, timing)
        t0 = self._event() if timing else None
        env: Dict[Tuple[int, int], DeviceBatch] = {}
        for edge, item, grp in zip(self.boundary_edges, staged["boundary"], dev):
            if isinstance(item, Esc16Staged):
                dc8, esc, offs, shapes = grp
                data = wire.unflatten_boundary(wire.decode_esc16_stream(dc8, esc), offs, shapes,
                                               item.canvas)
            elif isinstance(item, SparseStaged):
                mask, nibs, esc, offs, shapes = grp
                data = wire.unsparse_boundary(mask, wire.decode_nib_stream(nibs, esc), offs,
                                              shapes, item.canvas)
            elif isinstance(item, FlatStaged):
                flat, offs, shapes = grp
                data = wire.unflatten_boundary(flat, offs, shapes, item.canvas)
            elif isinstance(item, YUVStaged):
                y, u, v, offs, shapes = grp
                data = wire.yuv420_boundary(y, u, v, offs, shapes, item.canvas, item.full_range)
            else:
                data, shapes = grp
                if item.bfloat16:
                    data = data.view(torch.bfloat16)
                if (item.shapes == np.asarray(item.array.shape[1:1 + item.shapes.shape[1]])).all():
                    shapes = None
            env[_edge_key(edge)] = DeviceBatch(data, shapes, item.layout)
        if timing:
            self.stage_events.append(("wire", t0, self._event()))
        arg_arrays: Dict[int, Dict[str, torch.Tensor]] = {}
        for (op_id, name, _), arr in zip(self.device_arg_edges, dev_args):
            arg_arrays.setdefault(op_id, {})[name] = arr
        # device draws key on the staged batch's own iteration: the host
        # phase runs ahead by the prefetch depth
        dctx = DeviceCtx(arg_arrays, staged["statics"], params, self.device_arg_dev_edges, env,
                         batch_size=staged["batch_size"], seed=self.pipeline.seed,
                         iteration=staged["iteration"], device=self.device)
        for node, release in zip(self.device_ops, self._release_after):
            t0 = self._event() if timing else None
            outs = self.impls[node.id].lower(dctx, *[env[_edge_key(e)] for e in node.spec.inputs])
            for j, out in enumerate(outs):
                env[(node.id, j)] = out
            for key in release:
                env.pop(key, None)
            if timing:
                self.stage_events.append((node.spec.schema_name, t0, self._event()))
        if timing:
            self.record_stage_events = False
        results = []
        for out in self.graph.outputs:
            k = _edge_key(out)
            if out.device == "gpu":
                db = env[k]
                results.append(TensorListGPU(db.data, staged["out_shapes"].get(k), db.layout,
                                             device_shapes=db.shapes))
            else:
                hb = staged["cpu_outputs"][k]
                results.append(TensorListCPU(hb.samples, hb.layout))
        if self.pipeline.output_dtype is not None or self.pipeline.output_ndim is not None:
            self._validate_outputs(results)
        return tuple(results)

    def statistics(self) -> dict:
        """The reference's executor statistics where the port has the
        thing: the stage counters and seconds (``device_wait_seconds`` is
        the reference's ``device_stall_seconds``; ``device_dispatches``
        counts device phases), the boundary canvases, and the host seconds
        by operator schema as ``host_breakdown_seconds``."""
        out = dict(self.stats)
        out["device_stall_seconds"] = out["device_wait_seconds"]
        out["device_dispatches"] = out["iterations_completed"]
        # the host thread may grow a canvas meanwhile: copy until it holds
        for _ in range(8):
            try:
                out["canvases"] = {str(k): list(v) for k, v in self._canvas.items()}
                out["host_breakdown_seconds"] = dict(self.host_seconds_by_schema)
                break
            except RuntimeError:
                continue
        return out

    def _validate_outputs(self, results):
        """The pipeline's declared ``output_dtype`` / ``output_ndim``, per
        output; the ndim of a device output is its canvas's, read without
        the per-sample shapes."""
        want_dt, want_nd = self.pipeline.output_dtype, self.pipeline.output_ndim
        n = len(results)
        dts = want_dt if isinstance(want_dt, (list, tuple)) else [want_dt] * n
        nds = want_nd if isinstance(want_nd, (list, tuple)) else [want_nd] * n
        for i, tl in enumerate(results):
            dt = dts[i] if i < len(dts) else None
            nd = nds[i] if i < len(nds) else None
            if dt is not None:
                got = (torch.empty(0, dtype=tl.dtype).numpy().dtype
                       if isinstance(tl, TensorListGPU) and tl.dtype != torch.bfloat16
                       else tl.dtype)
                want = to_numpy_type(DALIDataType(int(dt)))
                if got != want:
                    raise RuntimeError(f"Pipeline output {i}: declared output_dtype "
                                       f"{DALIDataType(int(dt))!r} but got {got}")
            if nd is not None:
                if isinstance(tl, TensorListGPU):
                    got_nd = tl.as_tensor().dim() - 1
                else:
                    got_nd = tl.at(0).ndim if len(tl) else int(nd)
                if got_nd != int(nd):
                    raise RuntimeError(f"Pipeline output {i}: declared output_ndim {nd} but got "
                                       f"{got_nd}-D samples")

    # -- metadata / checkpointing ---------------------------------------------------------
    def reader_meta(self) -> Dict[str, dict]:
        return {n.instance_name: self.impls[n.id].reader_meta() for n in self.graph.ops
                if isinstance(self.impls[n.id], ReaderOperator)}

    def checkpoint_state(self) -> dict:
        states = {}
        for node in self.graph.ops:
            st = self.impls[node.id].save_state()
            if st is not None:
                states[node.instance_name] = st
        return {"iteration": self._iteration, "epoch": self._epoch, "ops": states}

    def consumed_checkpoint_state(self) -> dict:
        return self._consumed_ckpt if self._consumed_ckpt is not None else self.checkpoint_state()

    def restore_checkpoint(self, state: dict):
        self._iteration = int(state.get("iteration", 0))
        self._epoch = int(state.get("epoch", 0))
        for node in self.graph.ops:
            st = state.get("ops", {}).get(node.instance_name)
            if st is not None:
                self.impls[node.id].restore_state(st)
