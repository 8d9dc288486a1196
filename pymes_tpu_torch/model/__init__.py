"""Alias package: the reference-compatible import path
``pymes_tpu_torch.model.ueg`` (the implementation lives in
``pymes_tpu_torch.models``), as ``pymes_tpu/model/__init__.py``."""

from pymes_tpu_torch.models import ueg  # noqa: F401
