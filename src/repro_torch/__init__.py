"""PyTorch/CUDA port of the ``repro`` serving stack.

The package mirrors ``repro``'s layout module for module.  It imports
``torch`` and ``numpy`` only; the attention kernels are CUDA C++ under
``csrc/``, built on first use by :mod:`repro_torch.kernels._build`.
"""
