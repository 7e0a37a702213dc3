"""Custom operators (counterpart of ``dali_tpu/plugin_manager.py``): a
plugin is a Python module that calls ``DALI_SCHEMA`` and
``register_operator`` when it is imported. Loading it also adds its
operators to ``fn`` and ``ops``."""

from __future__ import annotations

import importlib
import importlib.util
import os


def load_library(path_or_module: str):
    """Import a plugin by file path or dotted module name."""
    if os.path.exists(path_or_module):
        name = os.path.splitext(os.path.basename(path_or_module))[0]
        spec = importlib.util.spec_from_file_location(f"dali_tpu_torch_plugin_{name}",
                                                      path_or_module)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(path_or_module)
    from . import fn, ops

    fn._populate()
    ops._populate()
    return mod


def load_directory(path: str):
    """Import every ``.py`` plugin of a directory, in name order."""
    return [load_library(os.path.join(path, f)) for f in sorted(os.listdir(path))
            if f.endswith(".py") and not f.startswith("_")]
