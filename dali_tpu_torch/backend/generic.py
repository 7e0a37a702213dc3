"""Cast and Reshape (counterpart of ``dali_tpu/backend/generic.py``)."""

from __future__ import annotations

import numpy as np

from .._schema import DALI_SCHEMA, ArgType, register_operator
from ..batch import DeviceBatch
from ..types import to_numpy_type, to_torch_type
from .base import Operator

DALI_SCHEMA("Cast").DocStr("Casts to another dtype.").NumInput(1).NumOutput(1).Devices(
    "cpu", "gpu").AddArg("dtype", ArgType.DATA_TYPE, "Target dtype.")


@register_operator("Cast", "cpu")
class CastCPU(Operator):
    elementwise = True

    def run_sample(self, ctx, idx, x):
        return x.astype(to_numpy_type(self.spec.GetArgument("dtype")))


@register_operator("Cast", "gpu")
class CastGPU(Operator):
    def lower(self, dctx, inp: DeviceBatch):
        return [inp.with_data(inp.data.to(to_torch_type(self.spec.GetArgument("dtype"))))]


DALI_SCHEMA("Reshape").DocStr(
    "Reinterprets the sample shape without touching the data."
).NumInput(1, 2).NumOutput(1).Devices("cpu", "gpu").AddOptionalArg(
    "shape", ArgType.FLOAT_VEC, "New sample shape (-1 infers one dim).", None, tensor_ok=True
).AddOptionalArg(
    "layout", ArgType.TENSOR_LAYOUT, "New layout.", None
).AddOptionalArg(
    "rel_shape", ArgType.FLOAT_VEC, "Shape relative to the input.", None
).AddOptionalArg(
    "src_dims", ArgType.INT_VEC, "Dimension permutation/selection.", None
)


def _resolve_shape(cur_shape, req):
    req = [int(round(v)) for v in req]
    total = int(np.prod(cur_shape))
    if -1 in req:
        known = int(np.prod([v for v in req if v != -1]))
        req[req.index(-1)] = total // max(known, 1)
    return req


@register_operator("Reshape", "cpu")
class ReshapeCPU(Operator):
    def run_sample(self, ctx, idx, x, *shape_in):
        if shape_in:
            shape = [int(v) for v in np.asarray(shape_in[0]).reshape(-1)]
        else:
            shape = ctx.arg(self, "shape", idx, None)
            if shape is not None:
                shape = [float(v) for v in np.asarray(shape).reshape(-1)]
            if shape is None:
                rel = self.spec.GetArgument("rel_shape", None)
                if rel is None:
                    return x  # layout-only change
                shape = [x.shape[i] * rel[i] for i in range(len(rel))]
        return x.reshape(_resolve_shape(x.shape, shape))

    def output_layout(self, output_idx, inputs):
        layout = self.spec.GetArgument("layout", None)
        return layout if layout is not None else ""
