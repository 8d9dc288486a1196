"""pymes_tpu_torch — the PyTorch/CUDA port of pymes_tpu.

The JAX package ``pymes_tpu`` is the reference; this package mirrors its
module paths and function names (``models/ueg.py``, ``ops/ueg_ladder.py``,
``solver/ccd.py``, …) so each function has an obvious counterpart.  It
imports ``torch`` and never ``jax``: the host-numpy modules it needs
(``log``, ``basis_set/planewave``, ``integral/partition``, the UEG integral
generator) are carried as copies, held equal to the originals by
``tests/test_torch_*.py``.

Every public callable takes the JAX package's calls (its positional order,
defaults and keywords), so a ``pymes_tpu`` driver runs here with only its
import root changed.  Entry points run on the card unless the caller asks
for the CPU with the keyword-only ``device="cpu"``; without a card they
raise, and nothing falls back to the CPU.  On a CUDA tensor the hot kernels
(:mod:`pymes_tpu_torch.kernels`) run hand-written Hopper code; on a CPU
tensor they run their plain PyTorch twins.
"""

from pymes_tpu_torch import config  # noqa: F401

__version__ = "0.1.0"
