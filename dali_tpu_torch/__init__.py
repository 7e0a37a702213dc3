"""dali_tpu_torch — the PyTorch/CUDA port of ``dali_tpu``.

A ``@pipeline_def`` graph of ``fn.*`` operators runs as a host program
(readers, the hybrid JPEG decoder's entropy stage and cpu ops, in numpy and
C++) feeding a device program of PyTorch operations and hand-written CUDA
kernels on one ``torch.device``; outputs are ``torch.Tensor``s on that device.

Ported so far:

* the RN50 training path — ``readers.file`` ->
  ``decoders.image_random_crop(device="mixed", hybrid_device_decode=True)`` ->
  ``resize`` -> ``random.coin_flip`` + ``crop_mirror_normalize`` ->
  ``plugin.pytorch`` iterators;
* image decode: the host-decoded ``decoders.image``,
  ``image_random_crop``, ``image_crop``, ``image_slice`` (cpu and mixed) and
  ``peek_image_shape``, JPEG through a libjpeg-free C++ decoder; the
  whole-image hybrid decode, ``decoders.image(device="mixed",
  hybrid_device_decode=True)`` on the int16 wire (the default) and the int8
  wire, and the coefficient cache (``cache_size``) of the hybrid decoders; ``random_resized_crop``
  and every form of ``resize`` on the device (per-sample sizes, the
  keep-aspect modes, ``max_size``, filter overrides, ``save_attrs``, tensor
  sizes, FHWC sequences and DHWC volumes): the ImageNet/EfficientNet
  training recipe (decode, then ``random_resized_crop``) and the RN50
  validation recipe (``resize_shorter``, then CMN ``crop``);
* the ASR mel front end on ragged audio — ``readers.file`` ->
  ``decoders.audio(device="mixed")`` (WAV) -> ``preemphasis_filter`` ->
  ``spectrogram`` -> ``mel_filter_bank`` -> ``to_decibels`` -> ``normalize``,
  and ``mfcc`` / ``nonsilent_region``;
* automatic augmentation (``dali_tpu_torch.auto_aug``: TrivialAugment Wide,
  AutoAugment, RandAugment) and what it builds on: DataNode arithmetic,
  ``math``, ``.gpu()``, ``types.Constant``, ``enable_conditionals=True``,
  GPU tensor arguments, host-side operator parameters, and the device warp,
  rotate, colour, blur, equalize and reduction operators;
* ``fn.external_source`` whole (``Pipeline.feed_input``, per-sample and
  batch sources, ``cycle``, ``num_outputs``, ``parallel=True`` worker
  processes) and eager mode, ``dali_tpu_torch.experimental.dynamic``
  (``ndd``), with ``ndd.capture``;
* the COCO detection lane (``readers.coco`` with its polygon and pixelwise
  masks, the bbox and segmentation operators, ``box_encoder`` on the host
  or the card);
* the dataset readers and raw inputs: ``readers.webdataset``, ``tfrecord``
  (``dali_tpu_torch.tfrecord`` declares its features), ``numpy`` (cpu and
  ``device="gpu"``), ``sequence``, ``mxnet``, ``caffe``, ``caffe2``,
  ``nemo_asr``, ``fits``, ``decoders.numpy``, ``decoders.inflate``,
  ``io.file.read``, and ``s3://`` roots (``_s3.py``);
* the front end and the PyTorch plugin: ``Pipeline`` with the reference's
  parameters, ``serialize``/``deserialize`` of the reference's document
  (payloads cross between the packages), the ``ops`` class API, custom
  operators (``DALI_SCHEMA``, ``register_operator``, ``plugin_manager``),
  the legacy operator names whose targets are ported, ``feed_ndarray`` and
  the iterators' checkpoints;
* the shape, tensor and value ops and the reductions: ``shapes`` and
  subscripts, ``cast_like``, ``expand_dims``, ``squeeze``, ``one_hot``,
  ``reshape``, ``slice``, ``crop``, ``stack``, ``cat``, ``permute_batch``,
  ``get_property``, ``paste``, the Zeros/Ones/Full family, the eight
  ``reductions`` and ``reinterpret``;
* the random and noise ops on the host and the device (device draws from a
  ``torch.Generator`` keyed by seed and the batch's iteration), the
  ``transforms`` matrix generators and ``coord_transform``, the Python
  function ops with ``fn.torch_function`` in place of ``fn.jax_function``,
  and ``water``, ``sphere``, ``jitter``, ``grid_mask`` and ``color_twist``
  on the device.

Other ``fn`` and ``ops`` names raise ``NotImplementedError`` naming their
ROADMAP.md Queue 1 item; ROADMAP.md lists the order of the rest.
This package imports torch, numpy and the standard library only.
"""

from __future__ import annotations

from . import types  # noqa: F401
from ._schema import (DALI_SCHEMA, GetSchema, OpSpec, RegisteredSchemas,  # noqa: F401
                      register_operator)
from .data_node import DataNode

__version__ = "0.1.0"


def _op_call(schema_name, device="cpu", inputs=(), name=None, **kwargs):
    """Create a graph node in the current pipeline scope (behind every fn.* call)."""
    from .pipeline import Pipeline

    pipe = Pipeline.current()
    if pipe is None:
        raise RuntimeError(f"Operator '{schema_name}' invoked outside a pipeline scope. "
                           "Use @pipeline_def or `with pipe:`.")
    spec = OpSpec(schema_name, device=device, name=name, **kwargs)
    for i in inputs:
        if not isinstance(i, DataNode):
            raise TypeError(f"Inputs to '{schema_name}' must be DataNodes, got {type(i)}")
        spec.AddInput(i)
    n = len(spec.inputs)
    if n < spec.schema.min_inputs or n > spec.schema.max_inputs:
        raise ValueError(f"Operator '{schema_name}' expects between {spec.schema.min_inputs} "
                         f"and {spec.schema.max_inputs} inputs, got {n}")
    outs = pipe.add_op(spec).outputs
    return outs[0] if len(outs) == 1 else tuple(outs)


from . import backend  # noqa: E402,F401  (registers the ported operators)
from . import _conditionals  # noqa: E402,F401
from . import fn  # noqa: E402
from . import ops  # noqa: E402
from . import math  # noqa: E402,F401
from . import plugin_manager  # noqa: E402,F401
from .pipeline import Pipeline, do_not_convert, pipeline_def  # noqa: E402,F401
from .external_source import ExternalSource, external_source  # noqa: E402

fn.external_source = external_source
ops.ExternalSource = ExternalSource

from . import tfrecord  # noqa: E402,F401


def _tfrecord_fn(path=None, index_path=None, features=None, name=None, **kwargs):
    """fn.readers.tfrecord: a dict of DataNodes keyed by feature name, in the
    order of ``features`` (``dali_tpu_torch.tfrecord`` declares them)."""
    if not features:
        raise ValueError("readers.tfrecord requires `features`")
    outs = _op_call("readers.TFRecord", device="cpu", inputs=(), name=name, path=path,
                    index_path=index_path, _features=dict(features), **kwargs)
    if not isinstance(outs, tuple):
        outs = (outs,)
    return dict(zip(features.keys(), outs))


fn.readers.tfrecord = _tfrecord_fn


def _check_hybrid_args(device, hybrid_scale, kwargs):
    """The argument checks both hybrid decoders share; pops the checked
    ``output_type`` and ``dtype`` from ``kwargs``."""
    if device != "mixed":
        raise ValueError("hybrid_device_decode requires device='mixed'")
    if kwargs.pop("output_type", types.DALIImageType.RGB) != types.DALIImageType.RGB:
        raise ValueError("hybrid_device_decode produces RGB only")
    if kwargs.pop("dtype", None) not in (None, types.DALIDataType.UINT8):
        raise ValueError("hybrid_device_decode produces uint8")
    if hybrid_scale not in (1, 2, 4):
        raise ValueError(f"hybrid_scale must be 1, 2, or 4 (got {hybrid_scale})")


_default_decoders_image = fn.decoders.image


def _decoders_image_fn(*inputs, device=None, hybrid_device_decode=False, hybrid_scale=1,
                       hybrid_chroma_full=False, hybrid_wire="int16", **kwargs):
    """fn.decoders.image. Without ``hybrid_device_decode`` the host decodes
    (``decoders.Image``). With it the host entropy-decodes every DCT block
    and ships the coefficients, and the device finishes the decode (IDCT,
    chroma, colour) at 1/``hybrid_scale`` resolution: the int16 wire
    (``_JpegCoeffs`` then ``_JpegIdct``, the default) or, with
    ``hybrid_wire="int8"``, DC int16 and AC saturated to int8
    (``_JpegCoeffsSplit`` then ``_JpegIdctSplit``), as the reference builds
    them."""
    if not hybrid_device_decode:
        return _default_decoders_image(*inputs, device=device, **kwargs)
    _check_hybrid_args(device, hybrid_scale, kwargs)
    if hybrid_wire not in ("int16", "int8"):
        raise ValueError(f"hybrid_wire must be 'int16' or 'int8' (got {hybrid_wire!r})")
    name = kwargs.pop("name", None)
    coeffs, idct = (("_JpegCoeffs", "_JpegIdct") if hybrid_wire == "int16"
                    else ("_JpegCoeffsSplit", "_JpegIdctSplit"))
    outs = _op_call(
        coeffs, device="mixed", inputs=inputs, name=name,
        hybrid_scale=hybrid_scale, chroma_full=hybrid_chroma_full,
        cache_size=int(kwargs.pop("cache_size", 0) or 0),
        adjust_orientation=bool(kwargs.pop("adjust_orientation", True)),
    )
    if kwargs:
        raise TypeError(f"fn.decoders.image got unexpected arguments {sorted(kwargs)}")
    return _op_call(idct, device="gpu", inputs=list(outs),
                    hybrid_scale=hybrid_scale, chroma_full=hybrid_chroma_full)


fn.decoders.image = _decoders_image_fn


_default_decoders_image_random_crop = fn.decoders.image_random_crop


def _decoders_image_random_crop_fn(*inputs, device=None, hybrid_device_decode=False,
                                   hybrid_scale=1, hybrid_chroma_full=False,
                                   random_area=(0.08, 1.0), random_aspect_ratio=(3 / 4, 4 / 3),
                                   num_attempts=10, seed=-1, **kwargs):
    """fn.decoders.image_random_crop. Without ``hybrid_device_decode`` the host
    decodes and crops (``decoders.ImageRandomCrop``). With it the RRC window
    is sampled on the host and only its DCT blocks are entropy-decoded and
    shipped; the device finishes the decode (IDCT, chroma, colour) at
    1/``hybrid_scale`` resolution. The output is the crop; pair it with
    fn.resize for RandomResizedCrop."""
    if not hybrid_device_decode:
        return _default_decoders_image_random_crop(
            *inputs, device=device, random_area=list(random_area),
            random_aspect_ratio=list(random_aspect_ratio), num_attempts=num_attempts,
            seed=seed, **kwargs)
    _check_hybrid_args(device, hybrid_scale, kwargs)
    name = kwargs.pop("name", None)
    outs = _op_call(
        "_JpegCoeffsSplitRRC", device="mixed", inputs=inputs, name=name,
        hybrid_scale=hybrid_scale, chroma_full=hybrid_chroma_full,
        random_area=list(random_area), random_aspect_ratio=list(random_aspect_ratio),
        num_attempts=num_attempts, seed=seed,
        cache_size=int(kwargs.pop("cache_size", 0) or 0),
        adjust_orientation=bool(kwargs.pop("adjust_orientation", True)),
    )
    if kwargs:
        raise TypeError(f"fn.decoders.image_random_crop got unexpected arguments {sorted(kwargs)}")
    return _op_call("_JpegIdctSplitRRC", device="gpu", inputs=list(outs),
                    hybrid_scale=hybrid_scale, chroma_full=hybrid_chroma_full)


fn.decoders.image_random_crop = _decoders_image_random_crop_fn


_default_decoders_audio = fn.decoders.audio


def _decoders_audio_fn(*inputs, device=None, **kwargs):
    """fn.decoders.audio; ``device='mixed'`` decodes on the host and returns
    the audio on the device. 16-bit PCM crosses as int16 and becomes float
    there (``_AudioStage`` + ``_AudioToOutput``)."""
    if device != "mixed":
        return _default_decoders_audio(*inputs, device=device, **kwargs)
    name = kwargs.pop("name", None)
    dtype = kwargs.get("dtype", None)
    pcm, rate = _op_call("_AudioStage", device="mixed", inputs=inputs, name=name, **kwargs)
    audio = _op_call("_AudioToOutput", device="gpu", inputs=[pcm],
                     **({} if dtype is None else {"dtype": dtype}))
    return audio, rate


fn.decoders.audio = _decoders_audio_fn


def _make_function_op(schema_name, device):
    def wrapper(*inputs, function=None, name=None, **kwargs):
        if function is None:
            raise ValueError(f"{schema_name} requires `function`")
        return _op_call(schema_name, device=device, inputs=inputs, name=name, _function=function,
                        **kwargs)

    return wrapper


# the callables ride OpSpec._extra: they are not serialized (unless
# serialize(include_callables=True) pickles them by value)
fn.python_function = _make_function_op("PythonFunction", "cpu")
fn.dl_tensor_python_function = _make_function_op("DLTensorPythonFunction", "cpu")
fn.torch_python_function = _make_function_op("TorchPythonFunction", "cpu")
fn.torch_function = _make_function_op("_TorchFunction", "gpu")


def _jax_function(*inputs, **kwargs):
    raise TypeError("fn.jax_function runs JAX code, which dali_tpu_torch does not import; write "
                    "the function in torch and call fn.torch_function (it receives the batched "
                    "device tensors [N, ...])")


fn.jax_function = _jax_function
