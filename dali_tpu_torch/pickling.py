"""By-value pickling of callbacks (counterpart of ``dali_tpu/pickling.py``).

Plain pickle serializes functions by reference, which fails for lambdas,
closures and ``__main__`` functions once a ``spawn`` worker has to import
them. A function marked with :func:`pickle_by_value` (and any lambda, closure
or ``__main__`` function) is serialized by value instead: its code object via
``marshal``, plus defaults, closure cells and the globals it references.
``parallel=True`` external sources and ``ndd.Checkpoint.serialize`` use it;
pass ``py_callback_pickler=dali_tpu_torch.pickling`` to a pipeline to choose it
explicitly.
"""

from __future__ import annotations

import io
import marshal
import pickle
import types

_BY_VALUE_ATTR = "_dali_tpu_pickle_by_value"


def pickle_by_value(fn):
    """Mark ``fn`` to be pickled by value."""
    setattr(fn, _BY_VALUE_ATTR, True)
    return fn


def _function_globals(fn):
    """The globals ``fn`` references that pickle; modules go by name."""
    out, modules = {}, {}
    names = set(fn.__code__.co_names)
    for const in fn.__code__.co_consts:  # nested lambdas and comprehensions
        if isinstance(const, types.CodeType):
            names.update(const.co_names)
    for k in names:
        if k not in fn.__globals__:
            continue
        v = fn.__globals__[k]
        if isinstance(v, types.ModuleType):
            modules[k] = v.__name__
            continue
        try:
            pickle.dumps(v)
            out[k] = v
        except Exception:
            pass
    return out, modules


class _ModuleRef:
    """A module held in a closure cell, encoded by name."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name


def _encode_cell(v):
    return _ModuleRef(v.__name__) if isinstance(v, types.ModuleType) else v


def _reduce_function(fn):
    closure = tuple(_encode_cell(c.cell_contents) for c in (fn.__closure__ or ()))
    gl, modules = _function_globals(fn)
    return _rebuild_function, (marshal.dumps(fn.__code__), fn.__name__, fn.__defaults__, closure,
                               gl, modules, fn.__kwdefaults__)


def _rebuild_function(code_blob, name, defaults, closure, gl, modules, kwdefaults=None):
    import builtins
    import importlib

    g = {"__builtins__": builtins}
    g.update(gl)
    for alias, modname in modules.items():
        g[alias] = importlib.import_module(modname)

    def decode(v):
        return importlib.import_module(v.name) if isinstance(v, _ModuleRef) else v

    cells = tuple(types.CellType(decode(v)) for v in closure)
    f = types.FunctionType(marshal.loads(code_blob), g, name, defaults, cells or None)
    if kwdefaults:
        f.__kwdefaults__ = dict(kwdefaults)
    return f


class _Pickler(pickle.Pickler):
    def __init__(self, file, *, by_value_all=False, **kw):
        super().__init__(file, **kw)
        self._by_value_all = by_value_all

    def reducer_override(self, obj):
        if (isinstance(obj, types.FunctionType)
                # never by value: this module's own rebuild function
                and getattr(obj, "__module__", None) != __name__
                and (self._by_value_all
                     or getattr(obj, _BY_VALUE_ATTR, False)
                     or obj.__name__ == "<lambda>"
                     or obj.__module__ == "__main__"
                     or "<locals>" in getattr(obj, "__qualname__", ""))):
            return _reduce_function(obj)
        return NotImplemented


def dumps(obj, *, by_value_all=False) -> bytes:
    buf = io.BytesIO()
    _Pickler(buf, by_value_all=by_value_all, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


class _Unpickler(pickle.Unpickler):
    """Reads the reference's by-value functions with this module's rebuild
    helpers (the same format), so loading them imports no ``dali_tpu``."""

    def find_class(self, module, name):
        return super().find_class(__name__ if module == "dali_tpu.pickling" else module, name)


def loads(blob: bytes):
    return _Unpickler(io.BytesIO(blob)).load()
