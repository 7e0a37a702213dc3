"""Triton Inference Server integration (counterpart of
``dali_tpu/plugin/triton.py``; DALI's ``plugin/triton.py`` and
``_utils/autoserialize.py``).

The ``autoserialize`` marker, the discovery of the marked pipeline in a
module tree, and ``save_model_repo``, which lays out a model-repository
entry (``<repo>/<name>/<version>/model.dali`` and a minimal
``config.pbtxt``) the way DALI's Triton backend expects it. ``model.dali``
is ``Pipeline.serialize``'s JSON document, the format ``dali_tpu`` writes;
``Pipeline.deserialize`` of either package and the C API
(``dali_tpu_torch/capi``) load it.
"""

from __future__ import annotations

import inspect
import os


def autoserialize(dali_pipeline):
    """Mark a ``@pipeline_def`` for serialization into a Triton model
    repository. Only a ``pipeline_def`` may be decorated, and only one per
    module tree."""
    if not getattr(dali_pipeline, "is_pipeline_def", False):
        raise TypeError("Only `@pipeline_def` can be decorated with `@triton.autoserialize`.")
    dali_pipeline._is_autoserialize = True
    return dali_pipeline


def _discover_autoserialize(module, visited):
    """The ``@autoserialize`` functions of a module tree."""
    ret = []
    try:
        module_members = inspect.getmembers(module)
    except ImportError:
        return ret
    modules = []
    for name, obj in module_members:
        if inspect.ismodule(obj) and obj not in visited:
            modules.append(obj)
            visited.append(obj)
        elif inspect.isfunction(obj) and getattr(obj, "_is_autoserialize", False):
            ret.append(obj)
    for mod in modules:
        ret.extend(_discover_autoserialize(mod, visited))
    return ret


def invoke_autoserialize(head_module, filename):
    """Serialize the one ``@autoserialize`` pipeline of ``head_module``'s
    tree to ``filename``."""
    found = _discover_autoserialize(head_module, visited=[])
    if len(found) != 1:
        raise RuntimeError(
            "Precisely one autoserialize function must exist in the module. "
            f"Found {len(found)}: {found}.")
    found[0]().serialize(filename=filename)


def save_model_repo(pipeline, model_repo: str, model_name: str, version: int = 1,
                    max_batch_size: int = None):
    """Write ``<model_repo>/<model_name>/<version>/model.dali`` and a
    ``config.pbtxt`` naming the dali backend for ``pipeline``; returns the
    model's directory."""
    mdir = os.path.join(model_repo, model_name)
    vdir = os.path.join(mdir, str(int(version)))
    os.makedirs(vdir, exist_ok=True)
    pipeline.serialize(filename=os.path.join(vdir, "model.dali"))
    mbs = max_batch_size if max_batch_size is not None else pipeline.max_batch_size
    with open(os.path.join(mdir, "config.pbtxt"), "w") as f:
        f.write(f'name: "{model_name}"\n'
                f'backend: "dali"\n'
                f"max_batch_size: {int(mbs)}\n")
    return mdir
