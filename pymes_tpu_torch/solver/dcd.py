"""DCD — distinguishable cluster doubles (CCD with ``is_dcd=True``).

Counterpart of ``pymes_tpu/solver/dcd.py:9-12``.
"""

from pymes_tpu_torch.solver.ccd import CCD


class DCD(CCD):
    def __init__(self, no, **kwargs):
        kwargs.pop("is_dcd", None)
        super().__init__(no, is_dcd=True, **kwargs)
