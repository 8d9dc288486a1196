"""pymes_tpu_torch — the PyTorch/CUDA port of pymes_tpu.

The JAX package ``pymes_tpu`` is the reference; this package mirrors its
module paths and function names (``models/ueg.py``, ``ops/ueg_ladder.py``,
``solver/ccd.py``, …) so each function has an obvious counterpart.  It
imports ``torch`` and never ``jax``: the host-numpy modules it needs
(``log``, ``basis_set/planewave``, ``integral/partition``, the UEG integral
generator) are carried as copies, held equal to the originals by
``tests/test_torch_*.py``.

Every entry point takes an explicit ``device``; nothing falls back to the CPU
when a card was asked for.  On a CUDA tensor the hot kernels
(:mod:`pymes_tpu_torch.kernels`) run hand-written Hopper code; on a CPU
tensor they run their plain PyTorch twins.
"""

from pymes_tpu_torch import config  # noqa: F401

__version__ = "0.1.0"
