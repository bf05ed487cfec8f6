"""Attention kernels: CUDA C++ under ``repro_torch/csrc``, their wrappers,
the plain PyTorch versions (:mod:`.ref`) and the device dispatch
(:mod:`.ops`), which the model calls."""
