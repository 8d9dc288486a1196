"""Names of the occupied/virtual blocks of the two-body integral tensor.

The same 16 named blocks as the reference (``pymes/integral/partition.py:4``).
A copy of the names and of ``part_2_body_int`` in
``pymes_tpu/integral/partition.py``, so that the port never imports the JAX
package; ``tests/test_torch_import.py`` holds the names equal and
``tests/test_torch_ccsd_io.py`` the slices.  :func:`part_2_body_int`
slices a dense tensor (views on its device);
:func:`pymes_tpu_torch.models.ueg.sparse_to_blocks` builds the UEG blocks
on the device without one.

Index convention (physicists'): ``V[p,q,r,s] = <pq|rs>``; letters i..l are
occupied, a..d virtual.  Block name "iabj" means V[o, v, v, o] etc.
TC Hamiltonians are non-Hermitian, so e.g. ``ijab`` and ``abij`` are
independent blocks — never derived from one another.
"""

BLOCK_NAMES = (
    "abci", "iabj", "iajk", "aijk", "klij", "aibj", "ijak", "abic",
    "iajb", "abcd", "iabc", "aijb", "ijka", "aibc", "ijab", "abij",
)

OCC_LETTERS = set("ijkl")

_SLICE = {"o": lambda no: slice(None, no), "v": lambda no: slice(no, None)}


def _block_slices(name, no):
    kinds = ["o" if c in OCC_LETTERS else "v" for c in name]
    return tuple(_SLICE[k](no) for k in kinds)


def part_2_body_int(no, t_V_pqrs):
    """Slice V_pqrs into the dict of 16 named o/v blocks."""
    return {name: t_V_pqrs[_block_slices(name, no)] for name in BLOCK_NAMES}
