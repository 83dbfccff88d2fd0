"""PyTorch/CUDA port of the cullavo_tpu LLaVA-1.5 serving path.

Mirrors the layout of ``cullavo_tpu`` module for module so each function has
an obvious JAX counterpart.  Imports ``torch`` only: no JAX, and nothing of
``cullavo_tpu``, at any level.  The Pallas kernels of the path are
hand-written CUDA kernels under ``csrc/``, built at first use by ``_build``.

The command line: ``python -m cullavo_tpu_torch {train,eval,serve}
--conf_files ...`` (``entry.main``; the config reader is ``config.py``).
"""

from cullavo_tpu_torch.config import Config, load_config, load_opt_command  # noqa: F401
