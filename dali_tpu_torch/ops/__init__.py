"""Class API generated from the schema registry (counterpart of
``dali_tpu/ops/__init__.py``): each ported, non-internal schema becomes a
class nested by its dotted path (``ops.readers.File``), whose constructor
takes the arguments and whose call adds the node through the matching
``fn`` function, so ``ops`` and ``fn`` build the same graph (with the same
special forms: the hybrid decoders, ``readers.TFRecord``'s feature dict).
Names of operators that are not ported raise as ``fn``'s do."""

from __future__ import annotations

import sys
import types as _pytypes

from .._schema import GetSchema, RegisteredSchemas
from ..fn import _camel_to_snake, _snake_path, not_ported


def _fn_for(schema_name: str):
    from .. import fn

    mod = fn
    *parts, last = schema_name.split(".")
    for p in parts:
        mod = getattr(mod, p)
    return getattr(mod, _camel_to_snake(last))


def _make_class(schema_name: str):
    schema = GetSchema(schema_name)

    class Op:
        def __init__(self, *, device=None, name=None, **kwargs):
            self._device = device
            self._name = name
            self._kwargs = kwargs

        def __call__(self, *inputs, **call_kwargs):
            kwargs = dict(self._kwargs, **call_kwargs)
            if self._name is not None:
                kwargs["name"] = self._name
            if self._device is not None:
                kwargs["device"] = self._device
            return _fn_for(schema_name)(*inputs, **kwargs)

        @property
        def schema(self):
            return schema

    Op.__name__ = Op.__qualname__ = schema_name.rsplit(".", 1)[-1]
    Op.__doc__ = schema.doc
    return Op


class _Namespace(_pytypes.ModuleType):
    """A nested ops module whose missing names are operators not ported yet."""

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        path = f"{self.__name__.split('.ops.', 1)[1]}.{name}"
        raise not_ported(_snake_path(path), api="ops", shown=path)


def __getattr__(name):
    if name.startswith("_"):
        raise AttributeError(name)
    raise not_ported(_snake_path(name), api="ops", shown=name)


def _submodule(parent, name: str):
    full = parent.__name__ + "." + name
    mod = sys.modules.get(full)
    if mod is None:
        mod = sys.modules[full] = _Namespace(full)
    parent.__dict__.setdefault(name, mod)
    return mod


def _populate():
    this = sys.modules[__name__]
    for schema_name in RegisteredSchemas():
        if GetSchema(schema_name).is_internal:
            continue
        *parts, last = schema_name.split(".")
        mod = this
        for p in parts:
            mod = _submodule(mod, p)
        mod.__dict__.setdefault(last, _make_class(schema_name))


_populate()
