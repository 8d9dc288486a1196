"""Carry the JAX package's state across to the port.

The JAX package builds integrals and ladder plans as numpy/JAX arrays; these
helpers turn them into the port's tensors on a given device.  They call only
``np.asarray`` on what they are given and never import jax.
"""

import numpy as np

from pymes_tpu_torch.config import as_tensor
from pymes_tpu_torch.ops.ueg_ladder import plan_from_arrays


def blocks_from_numpy(blocks, device):
    """dict name → array (e.g. ``sparse_to_blocks`` output) → dict of f64
    tensors on ``device``."""
    return {name: as_tensor(np.asarray(b), device)
            for name, b in blocks.items()}


def block_ladder_from_numpy(plan, device):
    """A ``pymes_tpu`` ``BlockLadder`` → the port's
    :class:`~pymes_tpu_torch.ops.ueg_ladder.BlockLadder` on ``device``.
    The Ozaki slices (``presliced``) are dropped and ``bra_of_row`` is
    built from ``inv_bra``."""
    group_arrays = [(np.asarray(g.blocks), np.asarray(g.perm_ket))
                    for g in plan.groups]
    return plan_from_arrays(group_arrays, np.asarray(plan.inv_bra),
                            int(plan.n_bra), int(plan.nv), float(plan.w0),
                            device)
