"""PyTorch/CUDA port of the cullavo_tpu LLaVA-1.5 serving path.

Mirrors the layout of ``cullavo_tpu`` module for module so each function has
an obvious JAX counterpart.  Imports ``torch`` only: no JAX, and nothing of
``cullavo_tpu``, at any level.  The Pallas kernels of the path are
hand-written CUDA kernels under ``csrc/``, built at first use by ``_build``.
"""
