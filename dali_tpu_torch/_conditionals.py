"""Per-sample conditionals, ``enable_conditionals=True`` (counterpart of
``dali_tpu/_conditionals.py``).

As in the reference, branches lower to predicated evaluation: both branches
run on the whole batch, and a per-sample ``_conditional.Merge`` picks the
result (``torch.where`` on the device, a per-sample select on the host). A
compact AST rewrite turns ``if``/``elif``/``else`` over DataNodes, and
``not``/``and``/``or``, into the functional hooks below.
"""

from __future__ import annotations

import ast
import functools
import inspect
import textwrap

import numpy as np
import torch

from ._schema import DALI_SCHEMA, register_operator
from .backend.base import Operator as _Op
from .batch import DeviceBatch, HostBatch
from .data_node import DataNode


class _Undefined:
    """Marker for a symbol defined in only one branch."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __repr__(self):
        return f"<undefined {self.name}>"


# ====================================== Merge op =================================================

DALI_SCHEMA("_conditional.Merge").DocStr(
    "Per-sample select(pred, true_val, false_val): the merge half of split/merge "
    "conditionals, lowered as predication."
).NumInput(3).NumOutput(1).Devices("cpu", "gpu").MakeInternal()

DALI_SCHEMA("_conditional.Validate").DocStr(
    "Checks that a condition is one scalar per sample."
).NumInput(1).NumOutput(1).Devices("cpu").MakeInternal()

DALI_SCHEMA("_conditional.LogicalNot").DocStr(
    "Per-sample logical not."
).NumInput(1).NumOutput(1).Devices("cpu", "gpu").MakeInternal()



@register_operator("_conditional.Merge", "cpu")
class MergeCPU(_Op):
    def run_batch(self, ctx, true_b: HostBatch, false_b: HostBatch, pred_b: HostBatch):
        out = []
        for i in range(len(pred_b)):
            p = bool(np.asarray(pred_b.samples[i]).reshape(-1)[0])
            src = true_b.samples[i] if p else false_b.samples[i]
            if isinstance(src, _Undefined):
                raise RuntimeError(
                    f"Variable '{src.name}' is used after the conditional but was only "
                    "defined in one branch"
                )
            out.append(src)
        layout = true_b.layout or false_b.layout
        return [HostBatch(out, layout=layout)]

    def output_layout(self, j, inputs):
        return inputs[0].layout if inputs else ""


@register_operator("_conditional.Merge", "gpu")
class MergeGPU(_Op):
    def host_output_shapes(self, ctx, input_shapes, input_batches):
        # per-sample shape select, so host-side shape inference flows through
        # conditionals (a device Rotate after a Merge needs the extents). The
        # predicate reaches the host intact: pred.gpu() inserts
        # _CopyToDevice, whose output batch is the boundary HostBatch
        ts, fs = input_shapes[0], input_shapes[1]
        if ts is None or fs is None:
            return None
        ts, fs = np.asarray(ts), np.asarray(fs)
        if ts.shape != fs.shape:
            return None
        pred = input_batches[2] if len(input_batches) > 2 else None
        if pred is None:
            return None
        sel = np.array([bool(np.asarray(s).reshape(-1)[0]) for s in pred.samples])
        return [np.where(sel[:, None], ts, fs)]

    def lower(self, dctx, true_b: DeviceBatch, false_b: DeviceBatch, pred_b: DeviceBatch):
        t, f = true_b.data, false_b.data
        if t.shape != f.shape:  # pad both to the common canvas
            tgt = [max(a, b) for a, b in zip(t.shape, f.shape)]
            t = _pad_to(t, tgt)
            f = _pad_to(f, tgt)
        n = t.shape[0]
        p = pred_b.data.reshape(n, *([1] * (t.dim() - 1))) != 0
        out = torch.where(p, t, f.to(t.dtype))
        shapes = None
        if true_b.shapes is not None or false_b.shapes is not None:
            ts, fs = (b.shapes if b.shapes is not None else
                      torch.tensor(b.data.shape[1:], dtype=torch.int32,
                                   device=t.device).expand(n, -1)
                      for b in (true_b, false_b))
            shapes = torch.where(pred_b.data.reshape(n, 1) != 0, ts, fs)
        return [DeviceBatch(out, shapes, true_b.layout or false_b.layout)]


def _pad_to(x, shape):
    if list(x.shape) == list(shape):
        return x
    out = x.new_zeros(shape)
    out[tuple(slice(0, s) for s in x.shape)] = x
    return out


@register_operator("_conditional.LogicalNot", "cpu")
class LogicalNotCPU(_Op):
    def run_sample(self, ctx, idx, x):
        return np.logical_not(np.asarray(x).reshape(-1)[0]).reshape(np.asarray(x).shape)


@register_operator("_conditional.LogicalNot", "gpu")
class LogicalNotGPU(_Op):
    def lower(self, dctx, inp):
        return [inp.with_data(torch.logical_not(inp.data != 0))]


@register_operator("_conditional.Validate", "cpu")
class ValidateCPU(_Op):
    def run_batch(self, ctx, inp: HostBatch):
        for s in inp.samples:
            a = np.asarray(s)
            if a.size != 1:
                raise ValueError(
                    "Conditions in `if` statements must be scalar per sample "
                    f"(got shape {a.shape})"
                )
        return [inp]


# ================================= runtime hooks ==================================================


def _merge(pred, true_val, false_val):
    from . import _op_call

    if isinstance(true_val, _Undefined) and isinstance(false_val, _Undefined):
        return true_val
    if not isinstance(true_val, DataNode) and not isinstance(false_val, DataNode):
        # plain Python values cannot vary per sample: they must agree
        if isinstance(true_val, _Undefined) or isinstance(false_val, _Undefined):
            return true_val if isinstance(false_val, _Undefined) else false_val
        if true_val is false_val or true_val == false_val:
            return true_val
        raise TypeError(
            "A non-DataNode value differs between conditional branches; only "
            "DataNodes can vary per sample"
        )
    tv, fv = true_val, false_val
    if isinstance(tv, _Undefined) or isinstance(fv, _Undefined):
        missing = tv if isinstance(tv, _Undefined) else fv
        raise RuntimeError(
            f"Variable '{missing.name}' must be defined in both branches of the conditional"
        )
    if not isinstance(tv, DataNode):
        tv = _constant_like(tv, fv)
    if not isinstance(fv, DataNode):
        fv = _constant_like(fv, tv)
    device = "gpu" if (tv.device == "gpu" or fv.device == "gpu") else "cpu"
    if device == "gpu":
        tv = tv.gpu()
        fv = fv.gpu()
        pred_in = pred.gpu()
    else:
        pred_in = pred
    return _op_call("_conditional.Merge", device=device, inputs=[tv, fv, pred_in])


def _constant_like(value, other: DataNode):
    from . import types as _t

    return _t.Constant(np.asarray(value), device="cpu")


def if_stmt(cond, body_fn, orelse_fn, init_vals):
    """Functional lowering of a rewritten ``if``: evaluates both branches and
    merges the symbols they modify, per sample."""
    from . import _op_call

    if not isinstance(cond, DataNode):
        # plain python condition — behave like normal python
        return body_fn(*init_vals) if cond else orelse_fn(*init_vals)
    cond = _op_call("_conditional.Validate", device="cpu", inputs=[cond])
    true_vals = body_fn(*init_vals)
    false_vals = orelse_fn(*init_vals)
    return tuple(_merge(cond, t, f) for t, f in zip(true_vals, false_vals))


def not_(x):
    from . import _op_call

    if isinstance(x, DataNode):
        return _op_call("_conditional.LogicalNot", device=x.device, inputs=[x])
    return not x


def and_(lhs_fn, rhs_fn):
    lhs = lhs_fn()
    if isinstance(lhs, DataNode):
        rhs = rhs_fn()
        if not isinstance(rhs, DataNode):
            raise TypeError("`and` between a DataNode and a python value is not supported")
        # both sides are evaluated (predication), then combined per sample
        return (lhs != 0) & (rhs != 0)
    return lhs and rhs_fn()


def or_(lhs_fn, rhs_fn):
    lhs = lhs_fn()
    if isinstance(lhs, DataNode):
        rhs = rhs_fn()
        if not isinstance(rhs, DataNode):
            raise TypeError("`or` between a DataNode and a python value is not supported")
        return (lhs != 0) | (rhs != 0)
    return lhs or rhs_fn()


# ================================= AST transform ==================================================


class _CollectStores(ast.NodeVisitor):
    def __init__(self):
        self.names = []

    def visit_Name(self, node):
        if isinstance(node.ctx, ast.Store) and node.id not in self.names:
            self.names.append(node.id)

    def visit_FunctionDef(self, node):
        if node.name not in self.names:
            self.names.append(node.name)

    def visit_For(self, node):
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        if isinstance(node.target, ast.Name) and node.target.id not in self.names:
            self.names.append(node.target.id)
        self.generic_visit(node)


def _modified_symbols(if_node: ast.If):
    c = _CollectStores()
    for stmt in if_node.body + if_node.orelse:
        c.visit(stmt)
    return c.names


class _ConditionalTransformer(ast.NodeTransformer):
    """Rewrites ``if``/``not``/``and``/``or`` into functional hooks."""

    def __init__(self):
        self._counter = 0

    def _fresh(self, base):
        self._counter += 1
        return f"__dali_{base}_{self._counter}"

    def visit_If(self, node: ast.If):
        node = self.generic_visit(node)
        symbols = _modified_symbols(node)
        body_name = self._fresh("body")
        orelse_name = self._fresh("orelse")
        args = ast.arguments(
            posonlyargs=[], args=[ast.arg(arg=s) for s in symbols], kwonlyargs=[],
            kw_defaults=[], defaults=[],
        )
        ret = ast.Return(value=ast.Tuple(elts=[ast.Name(id=s, ctx=ast.Load()) for s in symbols], ctx=ast.Load()))
        body_fn = ast.FunctionDef(
            name=body_name, args=args, body=list(node.body) + [ret], decorator_list=[],
            returns=None, type_params=[],
        )
        orelse_body = list(node.orelse) if node.orelse else [ast.Pass()]
        orelse_fn = ast.FunctionDef(
            name=orelse_name, args=args, body=orelse_body + [ast.Return(value=ret.value)],
            decorator_list=[], returns=None, type_params=[],
        )
        # init values: name if defined else _Undefined('name')
        init = ast.Tuple(
            elts=[
                ast.Call(
                    func=ast.Name(id="__dali_maybe", ctx=ast.Load()),
                    args=[
                        ast.Constant(value=s),
                        ast.Call(func=ast.Name(id="locals", ctx=ast.Load()), args=[], keywords=[]),
                        ast.Call(func=ast.Name(id="globals", ctx=ast.Load()), args=[], keywords=[]),
                    ],
                    keywords=[],
                )
                for s in symbols
            ],
            ctx=ast.Load(),
        )
        call = ast.Call(
            func=ast.Name(id="__dali_if_stmt", ctx=ast.Load()),
            args=[
                node.test,
                ast.Name(id=body_name, ctx=ast.Load()),
                ast.Name(id=orelse_name, ctx=ast.Load()),
                init,
            ],
            keywords=[],
        )
        assign = ast.Assign(
            targets=[
                ast.Tuple(elts=[ast.Name(id=s, ctx=ast.Store()) for s in symbols], ctx=ast.Store())
            ]
            if symbols
            else [ast.Name(id=self._fresh("unused"), ctx=ast.Store())],
            value=call,
        )
        return [body_fn, orelse_fn, assign]

    def visit_UnaryOp(self, node):
        node = self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return ast.Call(func=ast.Name(id="__dali_not", ctx=ast.Load()), args=[node.operand], keywords=[])
        return node

    def visit_BoolOp(self, node):
        node = self.generic_visit(node)
        fn_name = "__dali_and" if isinstance(node.op, ast.And) else "__dali_or"
        result = node.values[-1]
        result = _lambda0(result)
        for v in node.values[-2::-1]:
            result = ast.Call(
                func=ast.Name(id=fn_name, ctx=ast.Load()),
                args=[_lambda0(v), result],
                keywords=[],
            )
            result = _lambda0(result)
        # unwrap the outermost lambda: call it
        return ast.Call(func=result, args=[], keywords=[])

    def visit_While(self, node):
        raise NotImplementedError(
            "`while` over DataNodes is not supported (DALI conditionals support if/else only)"
        )


def _lambda0(expr):
    return ast.Lambda(
        args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[], kw_defaults=[], defaults=[]),
        body=expr,
    )


def _maybe(name, loc, glob):
    if name in loc:
        return loc[name]
    if name in glob:
        return glob[name]
    return _Undefined(name)


def autograph_convert(fn):
    """Source-rewrite ``fn`` for per-sample conditionals
    (``enable_conditionals=True``)."""
    if getattr(fn, "_dali_do_not_convert", False):
        return fn
    try:
        src = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError):
        raise RuntimeError(
            f"enable_conditionals requires source access to {fn.__name__}"
        )
    tree = ast.parse(src)
    fdef = tree.body[0]
    # drop decorators (pipeline_def is applied outside)
    fdef.decorator_list = []
    transformer = _ConditionalTransformer()
    new_tree = transformer.visit(tree)
    ast.fix_missing_locations(new_tree)
    code = compile(new_tree, filename=f"<dali_tpu_torch_autograph:{fn.__name__}>", mode="exec")
    glb = dict(fn.__globals__)
    glb["__dali_if_stmt"] = if_stmt
    glb["__dali_not"] = not_
    glb["__dali_and"] = and_
    glb["__dali_or"] = or_
    glb["__dali_maybe"] = _maybe
    # bind closure variables as globals (best effort)
    if fn.__closure__:
        for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                glb[name] = cell.cell_contents
            except ValueError:
                pass
    loc = {}
    exec(code, glb, loc)
    converted = loc[fdef.name]
    converted = functools.wraps(fn)(converted)
    return converted
