"""Functional API generated from the schema registry: every ported,
non-internal schema becomes a snake_case function nested by its dotted path
(``readers.File`` -> ``fn.readers.file``). Names of operators that are not
ported raise ``NotImplementedError`` pointing to ROADMAP.md."""

from __future__ import annotations

import re
import sys
import types as _pytypes

from .._schema import GetSchema, RegisteredSchemas


def _not_ported(path: str):
    return NotImplementedError(
        f"fn.{path} is not ported to dali_tpu_torch yet; see ROADMAP.md (Queue 1)")


class _Namespace(_pytypes.ModuleType):
    """A nested fn module whose missing names are operators not ported yet."""

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        raise _not_ported(f"{self.__name__.split('.fn.', 1)[1]}.{name}")


def __getattr__(name):
    if name.startswith("_"):
        raise AttributeError(name)
    raise _not_ported(name)


# tokens kept whole, as the reference's fn module keeps them
_SPECIAL_CASES = {"b_box": "bbox", "mx_net": "mxnet", "tf_record": "tfrecord"}


def _camel_to_snake(name: str) -> str:
    s = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", name)
    s = re.sub(r"([a-z0-9])([A-Z])", r"\1_\2", s).lower()
    for k, v in _SPECIAL_CASES.items():
        s = s.replace(k, v)
    return s


def _make_fn(schema_name: str):
    schema = GetSchema(schema_name)

    def op_fn(*inputs, device=None, name=None, **kwargs):
        from .. import _op_call

        if device is None:
            device = "gpu" if any(getattr(i, "device", "cpu") == "gpu" for i in inputs) else "cpu"
            if device not in schema.devices:
                device = schema.devices[0]
        return _op_call(schema_name, device=device, inputs=inputs, name=name, **kwargs)

    op_fn.__name__ = op_fn.__qualname__ = _camel_to_snake(schema_name.rsplit(".", 1)[-1])
    op_fn.__doc__ = schema.doc
    return op_fn


def _submodule(parent, name: str):
    full = parent.__name__ + "." + name
    mod = sys.modules.get(full)
    if mod is None:
        mod = sys.modules[full] = _Namespace(full)
    parent.__dict__.setdefault(name, mod)
    return mod


def _populate():
    this = sys.modules[__name__]
    _submodule(this, "decoders")
    for schema_name in RegisteredSchemas():
        if GetSchema(schema_name).is_internal:
            continue
        *parts, last = schema_name.split(".")
        mod = this
        for p in parts:
            mod = _submodule(mod, p)
        mod.__dict__.setdefault(_camel_to_snake(last), _make_fn(schema_name))


_populate()
