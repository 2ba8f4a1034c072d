"""ao_tpu_torch — the PyTorch / CUDA port of ao_tpu for one NVIDIA H100.

Module names mirror ``ao_tpu`` so that every module has a counterpart to
be held against. The port keeps ``ao_tpu``'s batch contract: dense padded
``(B, N, ...)`` tensors plus a bool mask. Every Pallas kernel on a ported
path is a hand-written CUDA kernel under ``csrc/``, built with ``nvcc``
into one shared library at first use and bound through ``ctypes``
(``ops/_native.py``); on CPU tensors each kernel wrapper runs its plain
PyTorch version instead.

The package imports torch, numpy and the standard library; the AO
pipeline's host code (PP2S, the oracle SAM, REAL's refinement) also
imports scipy and Pillow.
"""

__version__ = "0.1.0"
