"""Device stages of the main path: ``wire`` (coefficient-wire decode),
``jpeg`` (IDCT tail), ``resample`` (resize) in plain PyTorch, and ``cmn``,
whose CUDA tensors go through the hand-written kernel ``csrc/cmn.cu``."""
