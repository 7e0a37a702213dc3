"""Legacy and experimental operator names, and where the names not ported
yet stand in ROADMAP.md (counterpart of ``dali_tpu/backend/parity.py``
``_LEGACY`` and ``register_aliases``).

An alias shares its target's schema and is registered on each device the
port implements the target on (``CoinFlip`` on the cpu, not on the gpu); a
target implementation registered later is found through
``_schema._alias_targets``.
"""

from __future__ import annotations

from .._schema import _alias_targets, _impl_registry, _registry

_LEGACY = {
    "Clahe": "experimental.Clahe",
    "Equalize": "experimental.Equalize",
    "Filter": "experimental.Filter",
    "Debayer": "experimental.Debayer",
    "FileReader": "readers.File",
    "COCOReader": "readers.COCO",
    "CaffeReader": "readers.Caffe",
    "Caffe2Reader": "readers.Caffe2",
    "MXNetReader": "readers.MXNet",
    "TFRecordReader": "readers.TFRecord",
    "NumpyReader": "readers.Numpy",
    "SequenceReader": "readers.Sequence",
    "NemoAsrReader": "readers.NemoAsr",
    "VideoReader": "readers.Video",
    "ImageDecoder": "decoders.Image",
    "ImageDecoderCrop": "decoders.ImageCrop",
    "ImageDecoderRandomCrop": "decoders.ImageRandomCrop",
    "ImageDecoderSlice": "decoders.ImageSlice",
    "AudioDecoder": "decoders.Audio",
    "Uniform": "random.Uniform",
    "CoinFlip": "random.CoinFlip",
    "NormalDistribution": "random.Normal",
    "AudioResample": "experimental.AudioResample",
    "experimental.decoders.Image": "decoders.Image",
    "experimental.decoders.ImageCrop": "decoders.ImageCrop",
    "experimental.decoders.ImageRandomCrop": "decoders.ImageRandomCrop",
    "experimental.decoders.ImageSlice": "decoders.ImageSlice",
    "experimental.Inflate": "decoders.Inflate",
    "experimental.readers.Fits": "readers.Fits",
    "experimental.readers.Video": "readers.Video",
    "experimental.PeekImageShape": "PeekImageShape",
    "reductions.RMS": "reductions.RootMeanSquare",
}

# The ROADMAP.md Queue 1 item of each dali_tpu operator the port lacks.
_VIDEO = ("decoders.Video", "experimental.decoders.Video", "experimental.inputs.Video",
          "readers.Video", "readers.VideoResize", "VideoReaderResize", "OpticalFlow")
_GPU_OPS = ("ElementExtract", "FastResizeCropMirror", "JpegCompressionDistortion", "MultiPaste",
            "PerFrame", "PowerSpectrum", "ResizeCropMirror", "SequenceRearrange", "TensorResize",
            "experimental.Clahe", "experimental.Debayer", "experimental.Dilate",
            "experimental.Erode", "experimental.Filter", "experimental.MedianBlur",
            "experimental.Remap", "experimental.Resize", "experimental.TensorResize",
            "experimental.WarpPerspective")
QUEUE_ITEMS = {
    **{n: "item 8" for n in _VIDEO},
    **{n: "item 5g" for n in _GPU_OPS},
    "experimental.AudioResample": "item 4",
    "DumpImage": "item 5h",
}
QUEUE_ITEMS.update({a: QUEUE_ITEMS[t] for a, t in _LEGACY.items() if t in QUEUE_ITEMS})
# Placements the port declares but does not run yet: the cpu ones are item
# 5h, CMN's item 4, NonsilentRegion's gpu one item 5g.
_DEVICE_ITEMS = {("CropMirrorNormalize", "cpu"): "item 4", ("NonsilentRegion", "gpu"): "item 5g"}


def device_item(schema_name: str, device: str):
    """The ROADMAP.md Queue 1 item of a (schema, device) the port lacks."""
    item = _DEVICE_ITEMS.get((schema_name, device)) or QUEUE_ITEMS.get(schema_name)
    return item or ("item 5h" if device == "cpu" else None)


# The one deliberate renaming: the reference's gpu _JaxFunction traces a JAX
# function into its device program; the port runs a torch function there
# (fn.torch_function).
RENAMED = {"_JaxFunction": "_TorchFunction"}

# a deprecated name the reference registers beside its legacy table
_DEPRECATED = {"TransformTranslation": "transforms.Translation"}


def register_aliases():
    """Register every legacy name whose target the port has; return the
    names of the legacy table left out."""
    missing = []
    for alias, target in {**_LEGACY, **_DEPRECATED}.items():
        if target in _registry:
            _registry.setdefault(alias, _registry[target])
            _alias_targets[alias] = target
            for (name, dev), impl in list(_impl_registry.items()):
                if name == target:
                    _impl_registry[(alias, dev)] = impl
        elif alias in _LEGACY:
            missing.append(alias)
    return missing


_ALIAS_MISS = register_aliases()
