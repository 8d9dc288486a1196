"""Build and load the CUDA C++ kernels at first use.

``nvcc`` compiles ``pymes_tpu_torch/csrc/*.cu`` (plain C interface, no
PyTorch headers, so the build takes seconds) for ``sm_90a`` into
``build/torch_kernels/`` of the checkout; the library is loaded with
``ctypes``.  Pointers and the stream are passed as ``c_void_p``; every entry
point returns a ``cudaError_t`` that the wrapper checks.  A failed build
raises — there is no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIB = None


def _nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return nvcc


def build() -> Path:
    """Compile the sources unless a library of the same content exists;
    returns its path."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha1()
    for src in sources:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"libpymes_torch_kernels_{digest.hexdigest()[:12]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def library():
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.pymes_block_ladder.argtypes = [vp, vp, vp, vp, vp, vp, i32, vp,
                                           i32, vp]
        lib.pymes_block_ladder.restype = i32
        lib.pymes_block_ladder_row_tile.argtypes = []
        lib.pymes_block_ladder_row_tile.restype = i32
        _LIB = lib
    return _LIB
