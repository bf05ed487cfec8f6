"""PyTorch/CUDA port of the ``repro`` serving stack and its FaaS runtime.

The package mirrors ``repro``'s layout module for module.  It imports
``torch`` and ``numpy`` only; the kernels (attention, AES-128-CTR) are
CUDA C++ under ``csrc/``, built on first use by
:mod:`repro_torch.kernels._build`, and :mod:`repro_torch.core` is its own
copy of the faasd runtime with the containerd and junctiond backends.
"""
