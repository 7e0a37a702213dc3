"""Pipeline graph IR (counterpart of ``dali_tpu/graph.py``): operator nodes in
trace order, pruned to what the outputs reach, with CSE of stateless ops."""

from __future__ import annotations

from typing import Dict, List

from ._schema import OpSpec
from .data_node import DataNode


class OpNode:
    def __init__(self, op_id: int, spec: OpSpec):
        self.id = op_id
        self.spec = spec
        self.instance_name = spec.name
        self.outputs: List[DataNode] = []

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


def _cse_key(op: OpNode) -> str:
    spec = op.spec
    parts = [spec.schema_name, spec.device]
    parts += [f"{k}={spec.args[k]!r}" for k in sorted(spec.args)]
    parts += [f"i:{i.source.id if i.source else '?'}:{i.source_idx}" for i in spec.inputs]
    for k in sorted(spec.arg_inputs):
        v = spec.arg_inputs[k]
        parts.append(f"a:{k}:{v.source.id if v.source else '?'}:{v.source_idx}")
    return "|".join(parts)
