"""Every public name of ``pymes_tpu`` has a counterpart in ``pymes_tpu_torch``
or a written reason.

For each module of the JAX package, the module at the same relative path
must exist in the port, and each top-level public ``def`` and ``class`` of
the JAX module (a name without a leading ``_``) must be a top-level
``def``, ``class``, assignment or import of the port's module.  What the
port leaves out by design is listed in :data:`NOT_PORTED` with the design
decision of ``ROADMAP.md`` that it rests on; a whole module is keyed
``"path:*"``.  A new public name in the JAX package therefore needs a
counterpart in the port or an entry here.  Class methods and private names
are out of scope.

Both packages are read with :mod:`ast`, so nothing of either is imported
(and no jax): the whole file runs in well under a second.

    python -m pytest -q tests/test_torch_port_coverage.py
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "pymes_tpu"
PORT_PKG = REPO / "pymes_tpu_torch"

_OZAKI = ("Ozaki slices: exact f64 from bf16 slices, which only the TPU's "
          "MXU needs; the H100 runs f64 natively (ROADMAP, ground rules: "
          "Precision; section B, not ported by design)")
_ABIJ = ("the abij in-loop layout: the port's CCD/CCSD loop runs in ijab "
         "only (ROADMAP, 'Port behaviour, not TPU workarounds'; design "
         "decisions: CCD/CCSD loop in ijab only), through {}")
_JIT = ("jit-only carriers and lax.while_loop solvers: the port's loops "
        "are Python loops on the device's tensors (ROADMAP, 'Port "
        "behaviour, not TPU workarounds'), here {}")
_SCAN = ("the gather-scan UEGLadder, which only tests and probes use "
         "(ROADMAP, 'Port behaviour, not TPU workarounds'); the port's "
         "ladder is the BlockLadder through kernel K1")

NOT_PORTED = {
    "config.py:enable_x64": (
        "JAX's x64 switch: torch takes each tensor's own dtype, and the "
        "port is f64 through config.DTYPE (ROADMAP, design decisions: f64 "
        "by default; JAX's x64 switch)"),
    "config.py:x64_enabled": (
        "JAX's x64 switch (ROADMAP, design decisions: f64 by default; "
        "JAX's x64 switch)"),
    "ops/contract.py:*": (
        "the contraction modes and _mulsum (ROADMAP, 'Port behaviour, not "
        "TPU workarounds': the ops/contract.py modes)"),
    "ops/ozaki.py:*": _OZAKI,
    "ops/ueg_ladder.py:UEGLadder": _SCAN,
    "ops/ueg_ladder.py:build_ueg_ladder": _SCAN,
    "ops/ueg_ladder.py:ueg_ladder_apply": _SCAN,
    "ops/ueg_ladder.py:ueg_ladder_apply_ij": _SCAN,
    "ops/ueg_ladder.py:preslice_block_ladder": _OZAKI,
    "ops/ueg_ladder.py:block_ladder_apply_ab_ozaki": _OZAKI,
    "ops/ueg_ladder.py:block_ladder_apply_ij_ozaki": _OZAKI,
    "parallel/mesh.py:vblock_pspec": (
        "builds a jax PartitionSpec, a JAX sharding type; the port's mesh "
        "is a tuple of devices under one controller and vblock_axes gives "
        "the same axes as a tuple (ROADMAP, design decisions: "
        "multi-device is single-controller; JAX sharding types)"),
    "solver/ccd.py:CCDCarry": _JIT.format("ccd_solve"),
    "solver/ccd.py:ccd_solve_jit": _JIT.format("ccd_solve"),
    "solver/ccd.py:ccd_energy": _ABIJ.format("ccd_energy_ij"),
    "solver/ccd.py:doubles_residual": _ABIJ.format("doubles_residual_ij"),
    "solver/ccd.py:preslice_abcd": _OZAKI,
    "solver/ccd.py:preslice_ring_blocks": _OZAKI,
    "solver/ccsd.py:CCSDCarry": _JIT.format("ccsd_solve"),
    "solver/ccsd.py:ccsd_solve_jit": _JIT.format("ccsd_solve"),
    "solver/ccsd.py:ccsd_energy": _ABIJ.format("ccsd_energy_ij"),
    "solver/ccsd.py:singles_residual": _ABIJ.format("singles_residual_ij"),
    "solver/eom_ccsd.py:preslice_sigma_hbar": _OZAKI,
    "solver/eom_ccsd.py:sigma_singles": (
        "the term-list sigma: the port has one EOM sigma, the factorised "
        "sigma_singles_hbar, which EOM_CCSD.update_singles calls (ROADMAP, "
        "design decisions: one EOM sigma, A14)"),
    "solver/eom_ccsd.py:sigma_doubles": (
        "the term-list sigma: the port has one EOM sigma, the factorised "
        "sigma_doubles_hbar, which EOM_CCSD.update_doubles calls (ROADMAP, "
        "design decisions: one EOM sigma, A14)"),
    "util/flops.py:ozaki_raw_factor": _OZAKI,
    "util/roofline.py:block_ladder_mxu_flops": _OZAKI,
}

JAX_MODULES = sorted(p.relative_to(JAX_PKG).as_posix()
                     for p in JAX_PKG.rglob("*.py"))


def _tree(path):
    return ast.parse(path.read_text(encoding="utf-8"), filename=str(path))


def _public_defs(path):
    """Top-level public ``def`` and ``class`` names of a module."""
    return {n.name for n in _tree(path).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))
            and not n.name.startswith("_")}


def _top_level_names(path):
    """Names a module binds at its top level: defs, classes, assignment
    targets and imports (also inside top-level ``if``/``try`` blocks)."""
    out = set()

    def visit(body):
        for n in body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                out.add(n.name)
            elif isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = n.targets if isinstance(n, ast.Assign) else [
                    n.target]
                for t in targets:
                    out.update(x.id for x in ast.walk(t)
                               if isinstance(x, ast.Name))
            elif isinstance(n, (ast.Import, ast.ImportFrom)):
                out.update((a.asname or a.name).split(".")[0]
                           for a in n.names)
            elif isinstance(n, ast.If):
                visit(n.body)
                visit(n.orelse)
            elif isinstance(n, ast.Try):
                visit(n.body)
                for h in n.handlers:
                    visit(h.body)
                visit(n.orelse)
                visit(n.finalbody)

    visit(_tree(path).body)
    return out


def test_every_jax_module_is_listed():
    assert len(JAX_MODULES) >= 40
    assert "solver/eom_ccsd.py" in JAX_MODULES


@pytest.mark.parametrize("module", JAX_MODULES)
def test_jax_module_has_port_counterpart(module):
    """The port's module at the same path binds every public top-level
    name of the JAX module, or the name is excused in NOT_PORTED."""
    if f"{module}:*" in NOT_PORTED:
        return
    port = PORT_PKG / module
    assert port.is_file(), f"pymes_tpu_torch/{module} is missing"
    have = _top_level_names(port)
    missing = sorted(name for name in _public_defs(JAX_PKG / module)
                     if name not in have
                     and f"{module}:{name}" not in NOT_PORTED)
    assert not missing, (f"pymes_tpu/{module}: no counterpart in "
                         f"pymes_tpu_torch/{module} for {missing}; port "
                         "them or add each to NOT_PORTED with its reason")


@pytest.mark.parametrize("key", sorted(NOT_PORTED))
def test_not_ported_entry_is_live(key):
    """Each excused name still exists in the JAX package and still has no
    counterpart in the port, so no entry goes stale."""
    module, name = key.split(":")
    assert (JAX_PKG / module).is_file(), key
    if name == "*":
        assert not (PORT_PKG / module).exists(), (
            f"{key}: the port now has the module; drop the entry")
        return
    assert name in _public_defs(JAX_PKG / module), (
        f"{key}: pymes_tpu/{module} has no public top-level {name}")
    port = PORT_PKG / module
    assert not (port.is_file() and name in _top_level_names(port)), (
        f"{key}: the port now binds {name}; drop the entry")


def test_not_ported_reasons_are_given():
    empty = sorted(k for k, why in NOT_PORTED.items()
                   if not isinstance(why, str) or not why.strip())
    assert not empty, f"NOT_PORTED entries without a reason: {empty}"
