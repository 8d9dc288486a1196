"""What the port's f32 phases share: the f32 copy of an operator
structure and the full-f32 matmul setting.

The FEAST/RT mixed-precision linear solves
(:mod:`pymes_tpu_torch.solver.feast_eom_ccsd`), the mixed-precision
Davidson (:mod:`pymes_tpu_torch.solver.eom_ccsd`) and the mixed-precision
CCD/CCSD (:mod:`pymes_tpu_torch.solver.ccd`,
:mod:`pymes_tpu_torch.solver.ccsd`) each run an f32 computation on
:func:`cast_f32` of their f64 inputs inside :func:`full_f32_matmul`.
"""

import contextlib

import torch

from pymes_tpu_torch.ops import ueg_ladder


def cast_f32(x):
    """f32 copy of an operator structure (``_cast_f32``,
    ``pymes_tpu/solver/feast_eom_ccsd.py:250-256``): every f64 tensor of f,
    the V dict, T1/T2, the H̄ intermediates and the diagonal casts to f32,
    K1's plans through :func:`~pymes_tpu_torch.ops.ueg_ladder.cast_plan`
    (one copy of the packed sector blocks) and K4's plan weights, a block
    cut over a mesh (:class:`~pymes_tpu_torch.parallel.mesh.Sharded`)
    piece by piece; index arrays and numbers pass through."""
    if isinstance(x, torch.Tensor):
        return x.float() if x.dtype == torch.float64 else x
    if isinstance(x, (ueg_ladder.BlockLadder, ueg_ladder.ShardedBlockLadder)):
        return ueg_ladder.cast_plan(x, torch.float32)
    if isinstance(x, dict):
        return {k: cast_f32(v) for k, v in x.items()}
    if isinstance(x, tuple):
        items = [cast_f32(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


@contextlib.contextmanager
def full_f32_matmul():
    """f32 GEMMs at full f32 in the block, the counterpart of the JAX
    engine's ``jax.default_matmul_precision("float32")``
    (``pymes_tpu/solver/feast_eom_ccsd.py:753-756``): matmul precision
    "highest" and TF32 off for matmuls and cuDNN (TF32 keeps about three
    decimal digits, and a refinement pass then contracts only ~1e-3); the
    caller's settings come back on exit (the legacy ``allow_tf32`` flag is
    written only where the precision alone does not restore it: PyTorch
    refuses to read a precision set through both interfaces at odds)."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (torch.get_float32_matmul_precision(), cuda.allow_tf32,
             cudnn.allow_tf32)
    torch.set_float32_matmul_precision("highest")
    cuda.allow_tf32 = False
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        if cuda.allow_tf32 != saved[1]:
            cuda.allow_tf32 = saved[1]
        cudnn.allow_tf32 = saved[2]
