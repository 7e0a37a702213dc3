"""Symbolic graph edge (counterpart of ``dali_tpu/data_node.py``).

Arithmetic on DataNodes and ``.gpu()`` copies are not ported yet (ROADMAP.md,
Queue 1 item 12); they raise ``NotImplementedError``.
"""

from __future__ import annotations


class DataNode:
    def __init__(self, name: str, device: str = "cpu", source=None, source_idx: int = 0):
        self.name = name
        self.device = device  # "cpu" or "gpu"
        self.source = source  # producing graph.OpNode
        self.source_idx = source_idx

    def gpu(self) -> "DataNode":
        if self.device == "gpu":
            return self
        raise NotImplementedError(
            "DataNode.gpu() is not ported to dali_tpu_torch yet; see ROADMAP.md (Queue 1)")

    def cpu(self) -> "DataNode":
        if self.device == "cpu":
            return self
        raise ValueError("device->host transfers inside the graph are not supported")

    def __bool__(self):
        raise TypeError("A DataNode cannot be used in a plain Python `if`/`and`/`or`.")

    def __repr__(self):
        src = self.source.instance_name if self.source is not None else None
        return f"DataNode(name={self.name!r}, device={self.device!r}, source={src!r})"
