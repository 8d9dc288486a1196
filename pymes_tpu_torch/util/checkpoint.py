"""Checkpoint / resume for amplitude solvers.

Counterpart of ``pymes_tpu/util/checkpoint.py``: a
:class:`SolverCheckpoint` bundles (T1, T2, DIIS ring, energy, iteration,
metadata) and writes the same ``<base>.npz`` + ``<base>.json`` pair, so a
checkpoint written by the JAX package loads here and the reverse.  Arrays
are held on the host as numpy; :func:`from_result` copies the port's device
tensors there.  A solve resumes through its ``amps=`` warm start:
``solver.solve(fock, V, amps=ckpt.amps)``.
"""

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from pymes_tpu_torch.config import DTYPE, resolve_device, to_host
from pymes_tpu_torch.mixer import diis as diis_mod


@dataclasses.dataclass
class SolverCheckpoint:
    t2: np.ndarray
    t1: Optional[np.ndarray] = None
    diis_amps: Optional[np.ndarray] = None
    diis_errs: Optional[np.ndarray] = None
    diis_count: int = 0
    energy: float = 0.0
    iteration: int = 0
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def amps(self):
        """Warm-start argument for CCD (T2) / CCSD ((T1, T2)) ``solve``."""
        if self.t1 is None:
            return self.t2
        return (self.t1, self.t2)

    def diis_state(self, device):
        """The DIIS ring as the port's :class:`~pymes_tpu_torch.mixer.diis.
        DIISState` on ``device``: ``count`` a host int, ``B`` the Gram
        matrix ``diis.gram_from_errs`` of the ring."""
        if self.diis_amps is None:
            return None
        dev = resolve_device(device)
        errs = torch.as_tensor(self.diis_errs, dtype=DTYPE, device=dev)
        return diis_mod.DIISState(
            amps=torch.as_tensor(self.diis_amps, dtype=DTYPE, device=dev),
            errs=errs, count=int(self.diis_count),
            B=diis_mod.gram_from_errs(errs))


def _base(path):
    path = str(path)
    return path[:-4] if path.endswith(".npz") else path


def save(path, ckpt: SolverCheckpoint):
    """Write a checkpoint (<base>.npz + <base>.json sidecar metadata)."""
    base = _base(path)
    os.makedirs(os.path.dirname(os.path.abspath(base)), exist_ok=True)
    arrays = {"t2": to_host(ckpt.t2)}
    if ckpt.t1 is not None:
        arrays["t1"] = to_host(ckpt.t1)
    if ckpt.diis_amps is not None:
        arrays["diis_amps"] = to_host(ckpt.diis_amps)
        arrays["diis_errs"] = to_host(ckpt.diis_errs)
    np.savez_compressed(base + ".npz", **arrays)
    meta = dict(ckpt.meta, energy=float(ckpt.energy),
                iteration=int(ckpt.iteration),
                diis_count=int(ckpt.diis_count))
    with open(base + ".json", "w") as f:
        json.dump(meta, f)


def load(path) -> SolverCheckpoint:
    base = _base(path)
    data = np.load(base + ".npz")
    meta_path = base + ".json"
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return SolverCheckpoint(
        t2=data["t2"],
        t1=data["t1"] if "t1" in data else None,
        diis_amps=data["diis_amps"] if "diis_amps" in data else None,
        diis_errs=data["diis_errs"] if "diis_errs" in data else None,
        diis_count=int(meta.get("diis_count", 0)),
        energy=float(meta.get("energy", 0.0)),
        iteration=int(meta.get("iteration", 0)),
        meta={k: v for k, v in meta.items()
              if k not in ("energy", "iteration", "diis_count")})


def from_result(result, meta=None) -> SolverCheckpoint:
    """Build a checkpoint from a CCD/CCSD ``solve`` result dict (device
    tensors are copied to the host)."""
    t1 = result.get("t1")
    t2 = result.get("t2", result.get("t2 amp"))
    e = result.get("ccsd e", result.get("ccd e", 0.0))
    return SolverCheckpoint(t2=to_host(t2),
                            t1=None if t1 is None else to_host(t1),
                            energy=float(e), meta=meta or {})
