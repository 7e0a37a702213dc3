"""The pipeline executor of the PyTorch port (counterpart of
``dali_tpu/executor.py``).

Two stage threads, as in the reference:

* **host phase** — readers, the host halves of mixed ops and cpu ops, then
  the boundary staging and the host-side setup pass of the device ops
  (statics and output shapes in numpy: nothing is read back from the device
  per batch). A ragged host
  batch is padded onto a grow-only canvas per boundary edge: the canvas only
  grows (rounded up to ``PAD_ALIGN`` on spatial dims), which bounds the
  number of distinct device shapes, and so of cuFFT plans and allocator
  sizes, as the reference bounds its recompiles;
* **device phase** — each staged host buffer is copied once to the device
  (pinned, ``non_blocking``, on a copy stream that the compute stream waits
  on through an event), the coefficient wires are decoded, and every device
  op's ``lower`` runs eagerly in graph order on the compute stream.

The device phase of iteration k overlaps the host phase of iteration k+1;
``prefetch_queue_depth`` bounds both queues.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ._schema import get_operator_impl
from .backend.base import SHAPE_PRESERVING_SCHEMAS, DeviceCtx, HostCtx, Operator, ReaderOperator
from .batch import DeviceBatch, Esc16Staged, HostBatch, SparseStaged, Staged, pad_and_stack
from .kernels import wire
from .tensors import TensorListCPU, TensorListGPU


# Canvas alignment of spatial dims: dali_tpu's default ``pad_align``, so the
# port's canvases, and so its output shapes, equal the reference's.
PAD_ALIGN = 64


def _edge_key(edge) -> Tuple[int, int]:
    return (edge.source.id, edge.source_idx)


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
        # batch-size providers (readers) run first, as in the reference
        self._providers = {n.id for n in self.host_ops
                           if n.spec.schema.is_reader and not n.spec.inputs}
        self.host_ops.sort(key=lambda n: 0 if n.id in self._providers else 1)

        self.boundary_edges: List = []
        seen = set()
        for edge in [i for n in self.device_ops for i in n.spec.inputs] + [
                o for o in graph.outputs if o.device == "gpu"]:
            k = _edge_key(edge)
            if edge.source.id in host_ids and k not in seen:
                seen.add(k)
                self.boundary_edges.append(edge)
        self.device_arg_edges = []
        for node in self.device_ops:
            for name, edge in node.spec.arg_inputs.items():
                if edge.source.id not in host_ids or edge.device != "cpu":
                    raise NotImplementedError(
                        "device-side argument inputs are not ported to dali_tpu_torch yet; "
                        "see ROADMAP.md")
                self.device_arg_edges.append((node.id, name, edge))

        # grow-only padded canvas per ragged boundary edge
        self._canvas: Dict[Tuple[int, int], List[int]] = {}
        self._iteration = 0
        self._epoch = 0
        self._consumed_ckpt = None
        self._work_q: "queue.Queue" = queue.Queue()
        self._device_q: "queue.Queue" = queue.Queue(maxsize=pipeline.cpu_queue_depth)
        self._out_q: "queue.Queue" = queue.Queue(maxsize=pipeline.gpu_queue_depth)
        self._threads: List[threading.Thread] = []
        self._shutdown = False
        self._error = None
        self._copy_stream = None
        # per-stage CUDA event pairs of the next device phase, when requested
        # (chip_smoke.py's instrumented batch): [(stage, start, end), ...]
        self.record_stage_events = False
        self.stage_events: List[Tuple[str, object, object]] = []
        # cumulative host-clock seconds: host phase work, and the device
        # stage's wait for staged batches (its idle time on the host side)
        self.stats = {"host_batches": 0, "host_phase_seconds": 0.0, "device_wait_seconds": 0.0}

    # -- lifecycle --------------------------------------------------------------------
    def start(self):
        if not self._threads:
            self._threads = [
                threading.Thread(target=self._host_loop, name="dali-torch-host", daemon=True),
                threading.Thread(target=self._device_loop, name="dali-torch-device", daemon=True),
            ]
            for t in self._threads:
                t.start()

    def shutdown(self):
        """Stop both stage threads, then release the operators' native
        resources. Queues are drained while joining: a stage thread may be
        blocked in put() on a full bounded queue."""
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
        for impl in self.impls.values():
            impl.close()

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

    def _host_loop(self):
        while not self._shutdown:
            it = self._work_q.get()
            if it is None:
                break
            try:
                t0 = time.perf_counter()
                staged = self._host_phase(it)
                self.stats["host_phase_seconds"] += time.perf_counter() - t0
                self.stats["host_batches"] += 1
                if self.pipeline.enable_checkpointing:
                    st = self.checkpoint_state()
                    st["iteration"] = it + 1
                    staged["ckpt"] = st
            except BaseException as e:  # surfaces at the next outputs()
                self._device_q.put(e)
                return
            self._device_q.put(staged)

    def _device_loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._shutdown:
            t0 = time.perf_counter()
            staged = self._device_q.get()
            self.stats["device_wait_seconds"] += time.perf_counter() - t0
            if staged is None:
                break
            if isinstance(staged, BaseException):
                self._out_q.put(staged)
                return
            try:
                result = self._device_phase(staged)
            except BaseException as e:
                self._out_q.put(e)
                return
            self._out_q.put((result, staged.get("ckpt")))

    # -- host phase -------------------------------------------------------------------
    def _host_phase(self, iteration: int) -> dict:
        ctx = HostCtx(self.pipeline, iteration, self._epoch)
        env: Dict[Tuple[int, int], object] = {}
        for node in self.host_ops:
            impl = self.impls[node.id]
            ctx.set_arg_batches(node.id, {k: env[_edge_key(v)] for k, v in node.spec.arg_inputs.items()})
            ins = [env[_edge_key(e)] for e in node.spec.inputs]
            if node.device == "mixed" and hasattr(impl, "stage_batch_multi"):
                outs = impl.stage_batch_multi(ctx, ins)
            else:
                outs = impl.run_batch(ctx, *ins)
            for j, out in enumerate(outs):
                env[(node.id, j)] = out
            if node.id in self._providers:
                ctx.batch_size = len(outs[0])

        boundary, shape_env = [], {}
        for edge in self.boundary_edges:
            k = _edge_key(edge)
            item = env[k]
            if isinstance(item, HostBatch):
                # a uniform batch stages exact, unless the canvas has grown
                align = 1 if item.is_uniform() else self._pad_align_for(item)
                arr, shapes = pad_and_stack(item, canvas=self._canvas.get(k), align=align)
                self._canvas[k] = list(arr.shape[1:])
                item = Staged(arr, shapes, item.layout)
            boundary.append(item)
            shape_env[k] = item.shapes

        args = [np.stack([np.asarray(s) for s in env[_edge_key(e)].samples])
                for _, _, e in self.device_arg_edges]
        statics = {}
        for node in self.device_ops:
            impl = self.impls[node.id]
            in_shapes = [shape_env.get(_edge_key(e)) for e in node.spec.inputs]
            in_batches = [env.get(_edge_key(e)) for e in node.spec.inputs]
            in_batches = [b if isinstance(b, HostBatch) else None for b in in_batches]
            st = impl.device_statics(ctx, in_shapes, in_batches)
            if st is not None:
                statics[node.id] = st
            out_shapes = impl.host_output_shapes(ctx, in_shapes, in_batches)
            if (out_shapes is None and node.spec.schema_name in SHAPE_PRESERVING_SCHEMAS
                    and in_shapes and in_shapes[0] is not None):
                out_shapes = [in_shapes[0]] * node.spec.num_outputs()
            for j, sh in enumerate(out_shapes or []):
                if sh is not None:
                    shape_env[(node.id, j)] = np.asarray(sh)
        return {
            "iteration": iteration,
            "boundary": boundary,
            "args": args,
            "statics": statics,
            "cpu_outputs": {_edge_key(o): env[_edge_key(o)] for o in self.graph.outputs
                            if o.device != "gpu"},
            "out_shapes": {_edge_key(o): shape_env.get(_edge_key(o)) for o in self.graph.outputs
                           if o.device == "gpu"},
        }

    def _pad_align_for(self, hb: HostBatch):
        """Spatial dims align to ``PAD_ALIGN``; channel-like dims ('C', 'N', or
        an unnamed trailing dim of at most 4) stay exact."""
        align = [PAD_ALIGN] * hb.ndim
        for d, name in enumerate(hb.layout[:hb.ndim]):
            if name in ("C", "N"):
                align[d] = 1
        if not hb.layout and hb.ndim >= 1 and hb.samples[0].shape[-1] <= 4:
            align[-1] = 1
        return align

    # -- device phase -----------------------------------------------------------------
    def _event(self, stream=None):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def _to_device(self, staged: dict, timing: bool):
        """Copy every staged host buffer to the device once. Returns the
        same nesting with tensors in place of numpy arrays."""
        host = []
        for item in staged["boundary"]:
            if isinstance(item, Esc16Staged):
                host.append((item.dc8, item.esc, item.offsets, item.shapes))
            elif isinstance(item, SparseStaged):
                host.append((item.mask.view(np.int16), item.nibs, item.esc, item.offsets,
                             item.shapes))
            else:
                host.append((item.array, item.shapes))
        host.append(tuple(staged["args"]))
        if self.device.type != "cuda":
            return [tuple(torch.from_numpy(np.array(a)) for a in grp) for grp in host]
        compute = torch.cuda.current_stream(self.device)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            start = self._event(self._copy_stream) if timing else None
            dev = [tuple(torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                         .to(self.device, non_blocking=True) for a in grp) for grp in host]
            done = self._event(self._copy_stream) if timing else self._copy_stream.record_event()
        compute.wait_event(done)
        for grp in dev:
            for t in grp:
                t.record_stream(compute)
        if timing:
            self.stage_events.append(("h2d", start, done))
        return dev

    def _device_phase(self, staged: dict):
        timing = self.record_stage_events and self.device.type == "cuda"
        if timing:
            self.stage_events = []
        dev = self._to_device(staged, timing)
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
            else:
                data, shapes = grp
                if (item.shapes == np.asarray(item.array.shape[1:1 + item.shapes.shape[1]])).all():
                    shapes = None
            env[_edge_key(edge)] = DeviceBatch(data, shapes, item.layout)
        if timing:
            self.stage_events.append(("wire", t0, self._event()))
        arg_arrays: Dict[int, Dict[str, torch.Tensor]] = {}
        for (op_id, name, _), arr in zip(self.device_arg_edges, dev[-1]):
            arg_arrays.setdefault(op_id, {})[name] = arr
        dctx = DeviceCtx(arg_arrays, staged["statics"])
        for node in self.device_ops:
            t0 = self._event() if timing else None
            outs = self.impls[node.id].lower(dctx, *[env[_edge_key(e)] for e in node.spec.inputs])
            for j, out in enumerate(outs):
                env[(node.id, j)] = out
            if timing:
                self.stage_events.append((node.spec.schema_name, t0, self._event()))
        if timing:
            self.record_stage_events = False
        results = []
        for out in self.graph.outputs:
            k = _edge_key(out)
            if out.device == "gpu":
                db = env[k]
                results.append(TensorListGPU(db.data, staged["out_shapes"].get(k), db.layout))
            else:
                hb = staged["cpu_outputs"][k]
                results.append(TensorListCPU(hb.samples, hb.layout))
        return tuple(results)

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
