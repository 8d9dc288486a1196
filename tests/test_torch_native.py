"""The port's native record parser (``pymes_tpu_torch/_native.py`` over its
copy ``pymes_tpu_torch/csrc/io_native.cpp``) against the numpy parse that
stays as its fallback, bit for bit, and against the JAX package's parser:

* every dump under ``tests/data`` (FCIDUMP records of 4 indices, TCDUMP of
  6) and synthetic bodies (Fortran ``D``/``d`` exponents, CRLF and tab
  separators, signs, long mantissas): the same float64 bits and indices;
* a body that does not tokenize into whole records, or that holds a
  stray token, raises ``ValueError``, and :func:`_native.parse` then runs
  the (loud) numpy parse;
* the library is built at first use under ``build/host_native/`` (never in
  the package) and built again when its source is newer; a failed build
  is said once at log level 1 and the numpy parse runs;
* the port's readers go through the native parser and stay equal to the
  JAX readers.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

from pymes_tpu import _native as j_native
from pymes_tpu.util import fcidump as jfcidump
from pymes_tpu.util import tcdump as jtcdump
from pymes_tpu_torch import _native
from pymes_tpu_torch.util import fcidump as tfcidump
from pymes_tpu_torch.util import tcdump as ttcdump

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FCIDUMPS = ("FCIDUMP.H2.sto6g", "FCIDUMP.H2.tc", "FCIDUMP.LiH.321g",
            "FCIDUMP.LiH.tc")
TCDUMPS = ("TCDUMP.H2.tc", "TCDUMP.LiH_FNO")


@pytest.fixture(autouse=True)
def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native parser")


def _body(name):
    """The record body of a dump: after the namelist header of an FCIDUMP,
    after the first line of a TCDUMP."""
    with open(os.path.join(DATA, name)) as reader:
        if name.startswith("FCIDUMP"):
            tfcidump._parse_header(reader)
        else:
            reader.readline()
        return reader.read()


def _same_bits(got, want):
    assert got[0].dtype == want[0].dtype == np.float64
    assert np.array_equal(got[0].view(np.int64), want[0].view(np.int64))
    assert got[1].dtype == want[1].dtype == np.int64
    assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("name", FCIDUMPS + TCDUMPS)
def test_native_parse_bit_equal_on_every_dump(name):
    body = _body(name)
    if name.startswith("FCIDUMP"):
        k, numpy_parse = 4, tfcidump._numpy_parse
    else:
        k, numpy_parse = 6, ttcdump._numpy_parse
    got = _native.parse_integral_lines(body, k)
    _same_bits(got, numpy_parse(body))
    _same_bits(got, j_native.parse_integral_lines(body, k))
    assert got[1].shape == (len(got[0]), k) and len(got[0]) > 0


def _synthetic(n, seed, sep="\n"):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(n) * 10.0 ** rng.integers(-12, 3, n)
    idx = rng.integers(0, 60, (n, 4))
    lines = []
    for i, (v, row) in enumerate(zip(vals, idx)):
        text = f"{v:.17e}"
        if i % 3 == 0:
            text = text.replace("e", "D")
        elif i % 3 == 1:
            text = text.replace("e", "d")
        lines.append(f"  {text}\t{row[0]} {row[1]}  {row[2]} {row[3]}")
    return sep.join(lines) + sep


@pytest.mark.parametrize("sep", ["\n", "\r\n"])
def test_native_parse_bit_equal_on_synthetic_bodies(sep):
    body = _synthetic(2000, 11, sep)
    got = _native.parse_integral_lines(body)
    _same_bits(got, tfcidump._numpy_parse(body))
    _same_bits(got, _native.parse_integral_lines(body.encode()))
    assert len(got[0]) == 2000


def test_native_parse_empty_body():
    vals, idx = _native.parse_integral_lines("  \n")
    assert vals.shape == (0,) and idx.shape == (0, 4)


@pytest.mark.parametrize("body", [
    "1.0 1 1 1\n",                       # not a whole record
    "1.0 1 1 1 1\nxyz 1 1 1 1\n",        # a stray value token
    "1.0 1 1 1 1\n2.0 1 q 1 1\n",        # a stray index token
])
def test_malformed_body_raises_and_falls_back(body):
    with pytest.raises(ValueError):
        _native.parse_integral_lines(body)
    before = dict(_native.PARSES)
    calls = []

    def fallback(b):
        calls.append(b)
        return "numpy"

    assert _native.parse(body, 4, fallback) == "numpy"
    assert calls == [body]
    assert _native.PARSES["numpy"] == before["numpy"] + 1
    # the fallback of the readers is loud on such a body
    with pytest.raises(ValueError):
        tfcidump._numpy_parse(body)


def test_built_outside_the_package_and_rebuilt_when_source_is_newer(
        tmp_path, monkeypatch):
    assert _native.LIB.parent == _native.BUILD_DIR
    assert os.path.relpath(_native.BUILD_DIR, REPO) == os.path.join(
        "build", "host_native")
    src = tmp_path / "io_native.cpp"
    shutil.copy(_native.SRC, src)
    monkeypatch.setattr(_native, "SRC", src)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "LIB", tmp_path / "build" / "lib.so")
    monkeypatch.setattr(_native, "_lib", None)
    _native.library()
    first = _native.LIB.stat().st_mtime_ns
    os.utime(src, ns=(first + 10**9, first + 10**9))
    monkeypatch.setattr(_native, "_lib", None)
    _native.library()
    assert _native.LIB.stat().st_mtime_ns > first
    assert not list(tmp_path.glob("build/*.tmp"))


def test_failed_build_is_said_once_and_numpy_parses(monkeypatch, capsys):
    def fail():
        raise subprocess.CalledProcessError(1, "g++", stderr="no compiler")

    monkeypatch.setattr(_native, "_build", fail)
    monkeypatch.setattr(_native, "LIB", _native.BUILD_DIR / "missing.so")
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_failed", None)
    body = _synthetic(20, 3)
    for _ in range(2):
        _same_bits(_native.parse(body, 4, tfcidump._numpy_parse),
                   tfcidump._numpy_parse(body))
    out = capsys.readouterr().out
    assert out.count("native record parser not built (no compiler)") == 1


def test_readers_run_the_native_parser_and_match_jax():
    before = _native.PARSES["native"]
    for name in FCIDUMPS:
        is_tc = name.endswith(".tc")
        path = os.path.join(DATA, name)
        got, want = (tfcidump.read(path, is_tc=is_tc),
                     jfcidump.read(path, is_tc=is_tc))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for name in TCDUMPS:
        path = os.path.join(DATA, name)
        np.testing.assert_array_equal(ttcdump.read(path),
                                      np.asarray(jtcdump.read(path)))
    assert _native.PARSES["native"] == before + len(FCIDUMPS) + len(TCDUMPS)
