"""Names of the occupied/virtual blocks of the two-body integral tensor.

The same 16 named blocks as the reference (``pymes/integral/partition.py:4``).
A copy of the names in ``pymes_tpu/integral/partition.py``, so that the port
never imports the JAX package; ``tests/test_torch_import.py`` holds the two
equal.  :func:`pymes_tpu_torch.models.ueg.sparse_to_blocks` builds the
blocks on the device.

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
