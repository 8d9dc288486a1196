"""ctypes loader for the native C++ record parser (``csrc/io_native.cpp``).

Counterpart of ``pymes_tpu/_native.py``, carried with its own copy of the
source.  The library is built with ``g++ -O3 -shared -fPIC`` at first use
into ``build/host_native/`` of the checkout (never into the package), and
built again when the source is newer than it.  :func:`parse` is the one
entry of the dump readers (``util/fcidump.py``, ``util/tcdump.py``): it
runs the native parser and falls back to the reader's loud numpy parse
when the body is malformed (``ValueError``) or the library cannot be built
(said once, at log level 1).  :data:`PARSES` counts which parser ran.
"""

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

from pymes_tpu_torch.log import print_logging_info

SRC = Path(__file__).resolve().parent / "csrc" / "io_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "host_native"
LIB = BUILD_DIR / "libio_native.so"

# parses of a dump body by each parser, since the process started
PARSES = {"native": 0, "numpy": 0}

_lib = None
_failed = None


def _build():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(SRC), "-o",
                        str(tmp)], check=True, capture_output=True,
                       text=True)
        os.replace(tmp, LIB)
    finally:
        tmp.unlink(missing_ok=True)


def library():
    """The loaded parser library, built first where it is missing or older
    than its source; raises when it cannot be built or loaded."""
    global _lib
    if _lib is None:
        if not LIB.exists() or SRC.stat().st_mtime > LIB.stat().st_mtime:
            _build()
        lib = ctypes.CDLL(str(LIB))
        lib.parse_records.restype = ctypes.c_int64
        lib.parse_records.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64]
        lib.count_tokens.restype = ctypes.c_int64
        lib.count_tokens.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        _lib = lib
    return _lib


def parse_integral_lines(body, ints_per_rec=4):
    """Parse '<float> <int>*k' records from a text body into
    (values (n,), indices (n, k)) numpy arrays.

    Raises ValueError when the body does not tokenize into an exact
    number of records or the C parser stopped early (e.g. stray text) —
    a silent partial parse would mean silently wrong integrals; callers
    fall back to the loud pure-numpy path.
    """
    lib = library()
    raw = body.encode() if isinstance(body, str) else body
    n_tok = lib.count_tokens(raw, len(raw))
    if n_tok % (1 + ints_per_rec) != 0:
        raise ValueError(
            f"integral body has {n_tok} tokens, not a multiple of "
            f"{1 + ints_per_rec}")
    cap = n_tok // (1 + ints_per_rec) + 1
    vals = np.empty(cap, dtype=np.float64)
    idx = np.empty(cap * ints_per_rec, dtype=np.int64)
    n = lib.parse_records(
        raw, len(raw), ints_per_rec,
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
    if n != n_tok // (1 + ints_per_rec):
        raise ValueError(
            f"native parser stopped after {n} of "
            f"{n_tok // (1 + ints_per_rec)} records (malformed token)")
    return vals[:n], idx[: n * ints_per_rec].reshape(n, ints_per_rec)


def parse(body, ints_per_rec, fallback):
    """(values, indices) of the records of ``body`` through the native
    parser, or ``fallback(body)`` (the reader's numpy parse) where the body
    is malformed or the library cannot be built."""
    global _failed
    if _failed is None:
        try:
            library()
        except (OSError, subprocess.CalledProcessError) as err:
            _failed = getattr(err, "stderr", None) or str(err)
            print_logging_info("native record parser not built "
                               f"({_failed.strip()}); parsing with numpy",
                               level=1)
    if _failed is None:
        try:
            out = parse_integral_lines(body, ints_per_rec)
            PARSES["native"] += 1
            return out
        except ValueError:  # partial/odd body: retry with the loud path
            pass
    PARSES["numpy"] += 1
    return fallback(body)
