"""Carry the JAX package's state across to the port.

The JAX package builds integrals and ladder plans as numpy/JAX arrays; these
helpers turn them into the port's tensors on a given device.  They call only
``np.asarray`` on what they are given and never import JAX.
"""

import numpy as np
import torch

from pymes_tpu_torch.config import as_tensor, resolve_device
from pymes_tpu_torch.ops.ueg_ladder import OVVVPlan, plan_from_arrays


def blocks_from_numpy(blocks, device):
    """dict name → array (e.g. ``sparse_to_blocks`` output, or a CCSD V
    dict) → dict of f64 tensors on ``device``; a ``"_ovvv_plans"`` entry
    goes through :func:`ovvv_plans_from_numpy`."""
    return {name: (ovvv_plans_from_numpy(b, device) if name == "_ovvv_plans"
                   else as_tensor(np.array(b), device))
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


def ovvv_plans_from_numpy(plans, device):
    """The JAX package's ``build_ovvv_plans`` dict (pattern → plan with
    ``S``, ``W``) → the port's :class:`~pymes_tpu_torch.ops.ueg_ladder.
    OVVVPlan` dict on ``device`` (``S`` int32, ``W`` f64)."""
    dev = resolve_device(device)
    return {pat: OVVVPlan(
        S=torch.as_tensor(np.array(p.S, dtype=np.int32), device=dev),
        W=as_tensor(np.array(p.W), dev)) for pat, p in plans.items()}


def eom_operator_from_numpy(Vd, device):
    """The JAX package's EOM operator dict → the port's on ``device``:
    named blocks (``None`` stays ``None``), ``"abcd_t1"``, the bare blocks
    ``"_bare"``, the ladder plan ``"abcd_ladder"`` (through
    :func:`block_ladder_from_numpy`) and ``"_ovvv_plans"``."""
    out = {}
    for name, b in Vd.items():
        if b is None:
            out[name] = None
        elif name == "abcd_ladder":
            out[name] = block_ladder_from_numpy(b, device)
        elif name == "_ovvv_plans":
            out[name] = ovvv_plans_from_numpy(b, device)
        elif name == "_bare":
            out[name] = {k: as_tensor(np.array(v), device)
                         for k, v in b.items()}
        else:
            out[name] = as_tensor(np.array(b), device)
    return out
