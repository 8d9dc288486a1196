"""Build and load the CUDA C++ kernels at first use.

``nvcc`` compiles each of ``pymes_tpu_torch/csrc/*.cu`` (plain C interface,
sharing ``csrc/*.cuh``, no PyTorch headers, so the build takes seconds; one
process per source, all started together) for ``sm_90a`` and links them
into one library in ``build/torch_kernels/`` of the checkout; the library
is loaded with ``ctypes``.  Pointers and the stream are passed as
``c_void_p``, strides and column counts as ``c_longlong``, the tails' level
shift as ``c_double`` (by value: no device tensor a call); every entry
point returns a ``cudaError_t`` that the wrapper checks.  A failed build
raises — there is no fallback.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from pymes_tpu_torch.util.observability import span

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

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
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"libpymes_torch_kernels_{digest.hexdigest()[:12]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest.hexdigest()[:12]}.{os.getpid()}"
    nvcc = _nvcc()
    # one nvcc per source, all started together, then one link
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    tmp = lib.with_suffix(f".{tag}.tmp")
    try:
        logs = [(src.name, p.communicate()[0], p.returncode)
                for src, p in zip(sources, procs)]
        failed = [f"{name} ({rc}):\n{log}" for name, log, rc in logs if rc]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(device):
    """The number of SMs of a CUDA device (the kernels' planners size their
    grids by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(device, fn, *args):
    """Call the library entry ``fn(*args, stream)`` with ``device`` the
    current CUDA device (the launch and the shared-memory attribute belong
    to it) and ``stream`` its current stream.  The raw stream handle is
    read as Triton's launcher reads it: ``torch.cuda.current_stream()``
    builds a Stream object, several microseconds of host time a launch."""
    idx = device.index
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if idx == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(idx):
        return fn(*args, stream)


def library():
    """The loaded kernel library (built on first call; the build and the
    load are the span ``kernels.build``)."""
    global _LIB
    if _LIB is None:
        with span("kernels.build"):
            lib = ctypes.CDLL(str(build()))
        vp, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        i64 = ctypes.c_longlong
        # K1: cd-major operand and row stride, the pack (blocks,
        # bra_of_row, units, stages, bins and their count, zero rows and
        # their count), the output, its width and column tile
        lib.pymes_block_ladder.argtypes = [vp, i64, vp, vp, vp, vp, vp, i32,
                                           vp, i32, vp, i32, i32, vp]
        lib.pymes_block_ladder.restype = i32
        lib.pymes_block_ladder_smem.argtypes = [i32]
        lib.pymes_block_ladder_smem.restype = i32
        # K1 in f32: the operand, its row stride and whether its rows take
        # 16-byte copies, the f32 blocks, bra_of_row, the width's item
        # records, the stage table, the bins and their count, zero rows and
        # their count, the output, its width and column tile
        lib.pymes_block_ladder_f32.argtypes = [vp, i64, i32, vp, vp, vp, vp,
                                               vp, i32, vp, i32, vp, i32, i32,
                                               vp]
        lib.pymes_block_ladder_f32.restype = i32
        lib.pymes_block_ladder_f32_smem.argtypes = [i32, i32]
        lib.pymes_block_ladder_f32_smem.restype = i32
        # K5: X, Y or null, out, batch, P, R (f64; _f32 alike)
        for fn in (lib.pymes_pair_sym, lib.pymes_pair_sym_f32):
            fn.argtypes = [vp, vp, vp, i32, i32, i32, vp]
            fn.restype = i32
        # K4: S, W, T1 and its (batch, row, column) strides, no, columns,
        # out, entries, n1·n2, n2, column tile; the diagonal: S, W, T1 and
        # its strides, out, n0, n1, n2, no, the traced axis
        for fn in (lib.pymes_ovvv_gather, lib.pymes_ovvv_gather_f32):
            fn.argtypes = [vp, vp, vp, i64, i64, i64, i32, i32, vp, i64, i64,
                           i32, i32, vp]
            fn.restype = i32
        for fn in (lib.pymes_ovvv_gather_diag,
                   lib.pymes_ovvv_gather_diag_f32):
            fn.argtypes = [vp, vp, vp, i64, i64, vp, i32, i32, i32, i32, i32,
                           vp]
            fn.restype = i32
        lib.pymes_ring_step.argtypes = [vp, i64, i64, vp, i64, vp, i64, i64,
                                        i32, i32, i32, i32, i32, vp, vp]
        lib.pymes_ring_step.restype = i32
        # K7 on an f64 basis: the three CGS2 passes, the guarded scale, the
        # Krylov combine
        lib.pymes_arnoldi_pass.argtypes = [i32, vp, vp, vp, vp, vp, vp, vp,
                                           i64, i64, i32, i64, i32, i32, vp]
        lib.pymes_arnoldi_scale.argtypes = [vp, vp, vp, vp, vp, i64, i64, i32,
                                            i64, i32, i32, f64, vp]
        lib.pymes_krylov_combine.argtypes = [vp, vp, vp, vp, i32, vp, vp, vp,
                                             i64, i64, i32, i64, i32, i32, vp]
        # K7 on an f32 basis: the projection (V, w, lanes, m, the share, P,
        # S, H, the sync words, n, lane stride, R1, La, maxg, the partials'
        # row stride, the grid, the guard) and the combine (V, lanes, m, C,
        # nout, x0, out0, out1, n, lane stride, ldc, La)
        lib.pymes_arnoldi_cgs2_f32.argtypes = [vp] * 4 + [i64] + [vp] * 4 \
            + [i64, i64] + [i32] * 5 + [f64, vp]
        lib.pymes_krylov_combine_f32.argtypes = [vp, vp, vp, vp, i32, vp, vp,
                                                 vp, i64, i64, i32, i32, vp]
        for fn in (lib.pymes_arnoldi_pass, lib.pymes_arnoldi_scale,
                   lib.pymes_krylov_combine, lib.pymes_arnoldi_cgs2_f32,
                   lib.pymes_krylov_combine_f32):
            fn.restype = i32
        # K2/K3, K2'/K3': the Jacobi/insert pass (R1, T1, R2, T2, eps_i,
        # eps_a, the shift, errs, amps, out, N1, N, no, nv, m, slot,
        # n_valid, then the plan: vector width, head, vectors, tail, grid)
        # and the mix/energy pass (amps, coeff, T1, T2, F1, V, Vx, out, N1,
        # N, no, nv, n_valid, the plan and the T1 mix's grid); _f32 alike
        for sfx in ("", "_f32"):
            fn = getattr(lib, "pymes_cc_jacobi" + sfx)
            fn.argtypes = [vp] * 6 + [f64] + [vp] * 3 + [i32] * 12 + [vp]
            fn.restype = i32
            fn = getattr(lib, "pymes_cc_mix" + sfx)
            fn.argtypes = [vp] * 8 + [i32] * 11 + [vp]
            fn.restype = i32
        # K10: the packed list (idx, vals, nnz), n_p, no, the per-class
        # block pointers, strides and shifts, the bad-index counter
        lib.pymes_block_scatter.argtypes = [vp, vp, i64, i32, i32, vp, vp, vp,
                                            vp, vp]
        lib.pymes_block_scatter.restype = i32
        _LIB = lib
    return _LIB
