"""Kernels: CUDA C++ under ``repro_torch/csrc`` (attention and AES-128-CTR),
their wrappers, the plain PyTorch versions (:mod:`.ref`) and the device
dispatch (:mod:`.ops`), which the model and the FaaS function call."""
