"""Operator schema registry of the PyTorch port.

Counterpart of ``dali_tpu/_schema.py`` (``OpSchema``, ``OpSpec``,
``register_operator``) restricted to what the ported operators declare. The
schema is still the single source of truth for the ``fn.*`` names, argument
validation and defaults; implementations register per (schema, device).
"""

from __future__ import annotations

import enum
import inspect
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import types as _types


class ArgType:
    INT = "int"
    FLOAT = "float"
    BOOL = "bool"
    STRING = "str"
    DATA_TYPE = "DALIDataType"
    IMAGE_TYPE = "DALIImageType"
    INTERP_TYPE = "DALIInterpType"
    INT_VEC = "int_vec"
    FLOAT_VEC = "float_vec"
    STRING_VEC = "str_vec"
    TENSOR_LAYOUT = "layout"
    PYTHON_OBJECT = "object"  # a callback or other Python value, passed as is


def _as_list(v):
    if isinstance(v, (list, tuple)):
        return list(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return [v]


_COERCERS = {
    ArgType.INT: int,
    ArgType.FLOAT: float,
    ArgType.BOOL: bool,
    ArgType.STRING: str,
    ArgType.TENSOR_LAYOUT: str,
    ArgType.DATA_TYPE: _types.DALIDataType,
    ArgType.IMAGE_TYPE: _types.DALIImageType,
    ArgType.INTERP_TYPE: _types.DALIInterpType,
    ArgType.INT_VEC: lambda v: [int(x) for x in _as_list(v)],
    ArgType.FLOAT_VEC: lambda v: [float(x) for x in _as_list(v)],
    ArgType.STRING_VEC: lambda v: [str(x) for x in _as_list(v)],
    ArgType.PYTHON_OBJECT: lambda v: v,
}


@dataclass
class ArgDef:
    name: str
    type: str
    doc: str = ""
    default: Any = None
    tensor_ok: bool = False
    required: bool = False
    per_sample: bool = False  # as a tensor: one value per sample

    def coerce(self, value):
        if isinstance(value, _types.ScalarConstant):
            value = value.value
        return None if value is None else _COERCERS[self.type](value)


class OpSchema:
    def __init__(self, name: str):
        self.name = name
        self.doc = ""
        self.min_inputs = 0
        self.max_inputs = 0
        self.num_outputs = 1
        self.output_fn = None
        self.args: Dict[str, ArgDef] = {}
        self.devices = ("cpu",)
        self.is_internal = False
        self.is_reader = False
        self.is_stateless = True
        self.has_random_seed = False
        self.AddOptionalArg("bytes_per_sample_hint", ArgType.INT_VEC, "Output size hint (ignored).", [0])
        self.AddOptionalArg("preserve", ArgType.BOOL, "Keep in the graph even if unused.", False)

    def DocStr(self, doc):
        self.doc = inspect.cleandoc(doc)
        return self

    def NumInput(self, min_n, max_n=None):
        self.min_inputs = min_n
        self.max_inputs = max_n if max_n is not None else min_n
        return self

    def NumOutput(self, n):
        self.num_outputs = n
        return self

    def OutputFn(self, fn):
        """The number of outputs as a function of the OpSpec."""
        self.output_fn = fn
        return self

    def AddArg(self, name, type, doc="", tensor_ok=False, per_sample=False):
        self.args[name] = ArgDef(name, type, doc, tensor_ok=tensor_ok, required=True,
                                 per_sample=per_sample)
        return self

    def AddOptionalArg(self, name, type, doc="", default=None, tensor_ok=False,
                       per_sample=False):
        self.args[name] = ArgDef(name, type, doc, default=default, tensor_ok=tensor_ok,
                                 per_sample=per_sample)
        return self

    def AddRandomSeedArg(self):
        self.has_random_seed = True
        self.is_stateless = False
        return self.AddOptionalArg("seed", ArgType.INT, "Random seed; -1 = derive from pipeline seed.", -1)

    def Devices(self, *devices):
        self.devices = tuple(devices)
        return self

    def MakeInternal(self):
        self.is_internal = True
        return self

    def MakeStateful(self):
        self.is_stateless = False
        return self

    def MakeReader(self):
        """The standard reader arguments (sharding, shuffling, padding)."""
        self.is_reader = True
        self.is_stateless = False
        for name, typ, doc, dflt in (
            ("shard_id", ArgType.INT, "Index of this shard.", 0),
            ("num_shards", ArgType.INT, "Number of dataset shards.", 1),
            ("random_shuffle", ArgType.BOOL, "Shuffle with an initial-fill buffer.", False),
            ("initial_fill", ArgType.INT, "Size of the shuffling buffer.", 1024),
            ("stick_to_shard", ArgType.BOOL, "Do not rotate shards across epochs.", False),
            ("pad_last_batch", ArgType.BOOL, "Pad the last batch by repeating the last sample.", False),
            ("lazy_init", ArgType.BOOL, "Defer the dataset scan to the first run.", False),
            ("read_ahead", ArgType.BOOL, "Read ahead (hint).", False),
            ("prefetch_queue_depth", ArgType.INT, "Reader-side prefetch depth (hint).", 1),
            ("skip_cached_images", ArgType.BOOL, "Compatibility no-op.", False),
            ("dont_use_mmap", ArgType.BOOL, "Use plain reads instead of mmap.", False),
            ("shuffle_after_epoch", ArgType.BOOL, "Reshuffle the whole dataset every epoch.", False),
            ("shuffle_after_epoch_seed", ArgType.INT, "Seed of the per-epoch permutation.", -1),
            ("tensor_init_bytes", ArgType.INT, "Per-sample buffer hint (ignored).", 1048576),
        ):
            self.AddOptionalArg(name, typ, doc, dflt)
        return self.AddRandomSeedArg()

    def __repr__(self):
        return f"<OpSchema {self.name}>"


_registry: Dict[str, OpSchema] = {}
_impl_registry: Dict[Tuple[str, str], Any] = {}
_alias_targets: Dict[str, str] = {}  # legacy alias schema name -> canonical name


def DALI_SCHEMA(name: str) -> OpSchema:
    if name in _registry:
        raise ValueError(f"Schema '{name}' already registered")
    schema = _registry[name] = OpSchema(name)
    return schema


def GetSchema(name: str) -> OpSchema:
    try:
        return _registry[name]
    except KeyError:
        raise KeyError(f"No schema registered under '{name}'") from None


def TryGetSchema(name: str) -> Optional[OpSchema]:
    return _registry.get(name)


def RegisteredSchemas() -> List[str]:
    return sorted(_registry)


def register_operator(schema_name: str, device: str = "cpu"):
    def deco(cls):
        _impl_registry[(schema_name, device)] = cls
        cls.schema_name = schema_name
        cls.device = device
        return cls

    return deco


def _resolve(schema_name: str, device: str):
    """The implementation of (schema, device), looking an alias up through
    its target at call time: the target may register after the alias."""
    impl = _impl_registry.get((schema_name, device))
    if impl is None and schema_name in _alias_targets:
        impl = _impl_registry.get((_alias_targets[schema_name], device))
    return impl


def get_operator_impl(schema_name: str, device: str):
    impl = _resolve(schema_name, device)
    if impl is None:
        from .backend.parity import QUEUE_ITEMS

        item = QUEUE_ITEMS.get(_alias_targets.get(schema_name, schema_name))
        raise NotImplementedError(
            f"Operator '{schema_name}' on device '{device}' is not ported to "
            f"dali_tpu_torch yet; see ROADMAP.md (Queue 1{', ' + item if item else ''})")
    return impl


def has_operator_impl(schema_name: str, device: str) -> bool:
    return _resolve(schema_name, device) is not None


class OpSpec:
    """A schema instantiated with a device, resolved arguments and inputs."""

    _NO_DEFAULT = object()

    def __init__(self, schema_name: str, device: str = "cpu", name: Optional[str] = None,
                 _defer_required: bool = False, **kwargs):
        from .data_node import DataNode

        self.schema = GetSchema(schema_name)
        self.schema_name = schema_name
        self.device = device
        self.name = name
        self.args: Dict[str, Any] = {}
        self.arg_inputs: Dict[str, Any] = {}
        self.inputs: List[Any] = []
        self._extra: Dict[str, Any] = {}  # implementation payloads (e.g. a source callable)
        if device == "gpu" and "gpu" not in self.schema.devices and self.schema.is_reader \
                and "mixed" in self.schema.devices:
            # a reader DALI runs with device='gpu' (numpy through GPUDirect
            # Storage) reads on the host and returns the batch on the device:
            # the mixed placement, as in the reference
            device = self.device = "mixed"
        if device not in self.schema.devices:
            raise ValueError(
                f"Operator '{schema_name}' does not support device '{device}' "
                f"(supported: {self.schema.devices})")
        for k, v in kwargs.items():
            if v is None:
                continue
            if k.startswith("_"):
                self._extra[k] = v
                continue
            arg = self.schema.args.get(k)
            if arg is None:
                raise TypeError(f"Operator '{schema_name}' got unexpected argument '{k}'")
            if isinstance(v, DataNode):
                if not arg.tensor_ok:
                    raise TypeError(
                        f"Argument '{k}' of operator '{schema_name}' does not accept "
                        "a per-sample argument input (DataNode); pass a constant")
                self.arg_inputs[k] = v
            else:
                self.args[k] = arg.coerce(v)
        if not _defer_required:
            self.validate_required()

    def validate_required(self):
        """Raise for a required argument given neither as a value nor as an
        argument input. ``Graph.deserialize`` defers it until the argument
        inputs are wired."""
        for k, arg in self.schema.args.items():
            if arg.required and k not in self.args and k not in self.arg_inputs:
                raise TypeError(f"Operator '{self.schema_name}' missing required argument '{k}'")

    def GetArgument(self, name, default=_NO_DEFAULT):
        if name in self.args:
            return self.args[name]
        arg = self.schema.args.get(name)
        if arg is not None and not arg.required:
            d = arg.default
            return type(d)(d) if isinstance(d, (list, dict)) else d
        if default is not OpSpec._NO_DEFAULT:
            return default
        raise KeyError(f"Argument '{name}' not set and has no default")

    def HasArgument(self, name):
        return name in self.args or name in self.arg_inputs

    def AddInput(self, node):
        self.inputs.append(node)
        return self

    def num_outputs(self):
        fn = self.schema.output_fn
        return fn(self) if fn is not None else self.schema.num_outputs

    def serializable_args(self):
        """The constant arguments as JSON values (enums as their ints)."""
        return {k: int(v) if isinstance(v, enum.IntEnum) else v for k, v in self.args.items()}

    def __repr__(self):
        return f"<OpSpec {self.schema_name}[{self.device}] name={self.name}>"
