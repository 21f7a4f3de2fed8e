"""PyTorch + CUDA port of the FAQ quantization repro for one NVIDIA H100.

The JAX package ``repro`` is the reference; module names here mirror it.
This package imports ``torch`` and ``numpy`` only.  Kernels in ``csrc/``
are hand-written CUDA C++ for ``sm_90a``, built at first use
(:mod:`repro_torch.kernels._build`); a CPU tensor takes each kernel's
plain PyTorch version instead.
"""
