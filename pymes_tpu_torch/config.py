"""dtype and device policy of the port.

f64 everywhere the JAX package uses f64: the reference oracles (BASELINE.md)
need 1e-8 Ha agreement.  Every entry point runs on the card unless the
caller asks for the CPU: its ``device`` is keyword-only, and the default
(None) is the card, which :func:`resolve_device` refuses when torch sees
none instead of silently running on the CPU.
"""

import numpy as np
import torch

DTYPE = torch.float64


def resolve_device(device=None) -> torch.device:
    """``device`` (str or torch.device; None: the card) → torch.device;
    raises RuntimeError when a CUDA device is asked for and torch sees no
    card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def check_f64(dtype, what):
    """Raise ValueError unless ``dtype`` is None or f64 (numpy or torch):
    the port keeps the JAX package's f64 results and casts nothing else."""
    if dtype is None or (dtype == torch.float64
                         if isinstance(dtype, torch.dtype)
                         else np.dtype(dtype) == np.float64):
        return
    raise ValueError(f"{what}: dtype {dtype!r}; the port computes in f64 "
                     "only (its reduced-precision paths are the explicit "
                     "mixed-precision modes)")


def as_tensor(x, device=None) -> torch.Tensor:
    """Copy an array-like onto ``device`` (None: the card) as f64."""
    return torch.as_tensor(x, dtype=DTYPE, device=resolve_device(device))


def on_one_device(*xs, device=None):
    """The arguments ``xs`` of a free function that starts a drive (arrays,
    tensors, dicts of them, other values), each numpy array made an f64
    tensor on the device of the first tensor among them, else on
    ``device`` (None: the card); tensors stay where they lie."""
    def tensors(x):
        return x.values() if isinstance(x, dict) else (x,)

    dev = next((y.device for x in xs for y in tensors(x)
                if isinstance(y, torch.Tensor)), None)
    if dev is None:
        dev = resolve_device(device)

    def put(y):
        if isinstance(y, np.ndarray):
            return torch.as_tensor(y, dtype=DTYPE, device=dev)
        return y

    return [{k: put(v) for k, v in x.items()} if isinstance(x, dict)
            else put(x) for x in xs]


class HostReadable(torch.Tensor):
    """A tensor that numpy reads by a copy to the host, as it reads a JAX
    device array (``np.asarray(hf.construct_hf_matrix(...))`` in the
    reference's drivers).  Every torch operation that makes a new tensor
    of it gives a plain tensor, so it goes no further than the value it
    wraps."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        with torch._C.DisableTorchFunctionSubclass():
            return func(*args, **(kwargs or {}))

    def __array__(self, dtype=None, copy=None):
        a = self.detach().cpu().numpy()   # detach: a plain tensor
        return a if dtype is None else a.astype(dtype, copy=False)


def host_readable(t):
    """``t`` as a :class:`HostReadable` (no copy)."""
    return t.as_subclass(HostReadable)


def to_host(x) -> np.ndarray:
    """A tensor (on any device) or an array-like as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
