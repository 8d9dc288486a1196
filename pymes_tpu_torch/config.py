"""dtype and device policy of the port.

f64 everywhere the JAX package uses f64: the reference oracles (BASELINE.md)
need 1e-8 Ha agreement.  There is no global default device — every entry
point takes ``device`` and :func:`resolve_device` refuses a CUDA device when
no card is present instead of silently running on the CPU.
"""

import numpy as np
import torch

DTYPE = torch.float64


def resolve_device(device) -> torch.device:
    """``device`` (str or torch.device) → torch.device; raises when a CUDA
    device is asked for and torch sees no card."""
    if device is None:
        raise ValueError("pass device= explicitly ('cpu' or 'cuda')")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    return dev


def as_tensor(x, device) -> torch.Tensor:
    """Copy an array-like onto ``device`` as f64."""
    return torch.as_tensor(x, dtype=DTYPE, device=resolve_device(device))


def to_host(x) -> np.ndarray:
    """A tensor (on any device) or an array-like as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
