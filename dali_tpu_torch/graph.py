"""Pipeline graph IR (counterpart of ``dali_tpu/graph.py``): operator nodes in
trace order, pruned to what the outputs reach, with CSE of stateless ops.

A graph serializes to the reference's JSON document (``"dali_tpu.graph.v1"``,
the same layout), so a payload written by either package loads in the other.
"""

from __future__ import annotations

import base64
import json
from typing import Dict, List, Optional

from ._schema import OpSpec
from .data_node import DataNode


class OpNode:
    def __init__(self, op_id: int, spec: OpSpec):
        self.id = op_id
        self.spec = spec
        self.instance_name = spec.name
        self.outputs: List[DataNode] = []

    @property
    def inputs(self) -> List[DataNode]:
        return self.spec.inputs

    @property
    def arg_inputs(self) -> Dict[str, DataNode]:
        return self.spec.arg_inputs

    @property
    def device(self) -> str:
        return self.spec.device

    def all_input_nodes(self):
        return list(self.spec.inputs) + list(self.spec.arg_inputs.values())

    def __repr__(self):
        return f"<OpNode {self.id} {self.spec.schema_name}[{self.device}] {self.instance_name!r}>"


class Graph:
    """Topologically ordered op list + output edges."""

    def __init__(self, ops: List[OpNode], outputs: List[DataNode]):
        self.ops = ops
        self.outputs = outputs

    @staticmethod
    def build(outputs: List[DataNode], all_traced: List[OpNode]) -> "Graph":
        preserved = [op for op in all_traced if op.spec.GetArgument("preserve", False)]
        roots = list(outputs) + [o for op in preserved for o in op.outputs]
        visited: Dict[int, OpNode] = {}
        order: List[OpNode] = []

        def visit(node: OpNode):
            if node.id in visited:
                if visited[node.id] is None:
                    raise ValueError(f"Cycle detected at op {node.instance_name}")
                return
            visited[node.id] = None
            for inp in node.all_input_nodes():
                if inp.source is not None:
                    visit(inp.source)
            visited[node.id] = node
            order.append(node)

        for out in roots:
            if not isinstance(out, DataNode):
                raise TypeError(f"Pipeline outputs must be DataNodes, got {type(out)}")
            if out.source is not None:
                visit(out.source)
        return Graph(order, list(outputs))

    def deduplicate(self) -> "Graph":
        """Merge structurally identical stateless ops (reference graph/cse.cc)."""
        key_to_op: Dict[str, OpNode] = {}
        replace: Dict[int, OpNode] = {}
        kept: List[OpNode] = []
        for op in self.ops:
            for i, inp in enumerate(op.spec.inputs):
                if inp.source is not None and inp.source.id in replace:
                    op.spec.inputs[i] = replace[inp.source.id].outputs[inp.source_idx]
            for k, inp in list(op.spec.arg_inputs.items()):
                if inp.source is not None and inp.source.id in replace:
                    op.spec.arg_inputs[k] = replace[inp.source.id].outputs[inp.source_idx]
            if not op.spec.schema.is_stateless:
                kept.append(op)
                continue
            key = _cse_key(op)
            if key in key_to_op:
                replace[op.id] = key_to_op[key]
            else:
                key_to_op[key] = op
                kept.append(op)
        outputs = [replace[o.source.id].outputs[o.source_idx]
                   if o.source is not None and o.source.id in replace else o
                   for o in self.outputs]
        return Graph(kept, outputs)

    def serialize(self, pipeline_params: Optional[dict] = None,
                  include_callables: bool = False) -> str:
        """The graph as the reference's JSON document. With
        ``include_callables`` each op's implementation payloads (sources,
        callables) are pickled by value, so the payload embeds code."""
        from . import pickling

        ops = []
        for op in self.ops:
            entry = {
                "name": op.instance_name,
                "schema": op.spec.schema_name,
                "device": op.device,
                "args": op.spec.serializable_args(),
                "inputs": [[i.source.instance_name, i.source_idx] for i in op.spec.inputs],
                "arg_inputs": {k: [v.source.instance_name, v.source_idx]
                               for k, v in op.spec.arg_inputs.items()},
                # recorded: the count of some ops depends on payloads that
                # are not serialized (readers.TFRecord's features)
                "num_outputs": len(op.outputs),
            }
            if include_callables:
                blobs = {k: base64.b64encode(pickling.dumps(v, by_value_all=True)).decode("ascii")
                         for k, v in op.spec._extra.items() if k != "_origin" and v is not None}
                if blobs:
                    entry["pickled_extra"] = blobs
            ops.append(entry)
        return json.dumps({
            "format": "dali_tpu.graph.v1",
            "params": pipeline_params or {},
            "ops": ops,
            "outputs": [[o.source.instance_name, o.source_idx, o.device] for o in self.outputs],
        }, indent=1)

    @staticmethod
    def deserialize(payload: str) -> "Graph":
        """Rebuild the graph of :meth:`serialize`'s document; op ids follow
        the document's order."""
        from . import pickling

        doc = json.loads(payload)
        if doc.get("format") != "dali_tpu.graph.v1":
            raise ValueError("Unrecognized serialized pipeline format")
        nodes: Dict[str, OpNode] = {}
        ops: List[OpNode] = []
        for i, entry in enumerate(doc["ops"]):
            spec = OpSpec(entry["schema"], device=entry["device"], name=entry["name"],
                          _defer_required=True, **entry["args"])
            for k, blob in entry.get("pickled_extra", {}).items():
                spec._extra[k] = pickling.loads(base64.b64decode(blob))
            for src_name, idx in entry["inputs"]:
                spec.AddInput(nodes[src_name].outputs[idx])
            for k, (src_name, idx) in entry.get("arg_inputs", {}).items():
                spec.arg_inputs[k] = nodes[src_name].outputs[idx]
            spec.validate_required()
            node = OpNode(i, spec)
            n_out = entry.get("num_outputs")
            if n_out is None:  # a payload from before the count was recorded
                n_out = spec.num_outputs()
            node.outputs = [DataNode(f"{entry['name']}[{j}]", _out_device(spec), node, j)
                            for j in range(n_out)]
            nodes[entry["name"]] = node
            ops.append(node)
        return Graph(ops, [nodes[name].outputs[idx] for name, idx, _ in doc["outputs"]])

    def to_dot(self) -> str:
        """The graph in Graphviz's dot language, ops coloured by device."""
        color = {"cpu": "lightblue", "mixed": "orange", "gpu": "lightgreen"}
        lines = ["digraph pipeline {"]
        for op in self.ops:
            lines.append(f'  "{op.instance_name}" [label="{op.spec.schema_name}\\n{op.device}",'
                         f' style=filled, fillcolor={color.get(op.device, "white")}];')
            for inp in op.all_input_nodes():
                if inp.source is not None:
                    lines.append(f'  "{inp.source.instance_name}" -> "{op.instance_name}";')
        lines.append("}")
        return "\n".join(lines)


def _out_device(spec: OpSpec) -> str:
    return "gpu" if spec.device in ("gpu", "mixed") else "cpu"


def _cse_key(op: OpNode) -> str:
    spec = op.spec
    parts = [spec.schema_name, spec.device]
    parts += [f"{k}={spec.args[k]!r}" for k in sorted(spec.args)]
    parts += [f"i:{i.source.id if i.source else '?'}:{i.source_idx}" for i in spec.inputs]
    for k in sorted(spec.arg_inputs):
        v = spec.arg_inputs[k]
        parts.append(f"a:{k}:{v.source.id if v.source else '?'}:{v.source_idx}")
    return "|".join(parts)
