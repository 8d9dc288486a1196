"""Every public name of ``pymes_tpu`` has a counterpart in ``pymes_tpu_torch``
that accepts the reference's calls, or a written reason.

Names: for each module of the JAX package, the module at the same relative
path must exist in the port, and each top-level public ``def`` and
``class`` of the JAX module (a name without a leading ``_``) must be a
top-level ``def``, ``class``, assignment or import of the port's module.

Signatures: each public function of such a module, and each public method
(``__init__`` included) defined in the body of a public class there, is
held to its counterpart in the port (a method found through the port
class's bases too) by the binding rule: a call the JAX package accepts
binds in the port to the same parameter names or raises ``TypeError``.

* the port's positional parameters are a prefix of the JAX ones, in the
  same order and with the same defaults (a parameter the port leaves out
  makes every later one keyword-only);
* the port takes every JAX parameter name, by position or keyword;
* a parameter the JAX callable does not have (``device``, ``twin``, …) is
  keyword-only in the port, and the port has no ``*args`` where the JAX
  callable has more positional parameters.

What the port leaves out by design is listed in :data:`NOT_PORTED` with
the design decision of ``ROADMAP.md`` that it rests on: a whole module is
keyed ``"path:*"``, a name ``"path:name"``, one JAX parameter of a
callable ``"path:Qual.name(param)"`` and a whole signature
``"path:Qual.name()"``.  A new public name, method or parameter in the JAX
package therefore needs a counterpart in the port or an entry here, and
each entry is checked to be live.  Private names are out of scope.

Both packages are read with :mod:`ast`, so nothing of either is imported
(and no jax): the whole file runs in about a second.

    python -m pytest -q tests/test_torch_port_coverage.py
"""

import ast
from pathlib import Path
from typing import NamedTuple

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

_DRCCD = ("drCCD's amplitudes are t_T_ijab, not t_T_abij: the layout "
          "really differs, since the port's CCD loop is ijab only (ROADMAP, "
          "design decisions: CCD/CCSD loop in ijab only)")

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
    # signatures
    "solver/ccsd.py:ccsd_iteration()": (
        "the port's iteration takes eps_i, eps_a and level_shift, from "
        "which K2' builds the Jacobi denominators, in place of the D_ai and "
        "D_abij tensors, and T2 in ijab (ROADMAP, design decisions: CCD/CCSD "
        "loop in ijab only; K2'/K3' fused tails)"),
    "solver/drccd.py:residual()": _DRCCD,
    "solver/drccd.py:get_residual()": _DRCCD,
    "solver/drccd.py:getEnergy()": _DRCCD,
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
    counterpart in the port, each excused parameter is still a JAX one the
    port lacks, and each excused signature still breaks the binding rule,
    so no entry goes stale."""
    module, name = key.split(":")
    assert (JAX_PKG / module).is_file(), key
    if name.endswith(")"):
        qual, param = name[:-1].split("(")
        jax_def = _jax_callables(module).get(qual)
        assert jax_def is not None, (
            f"{key}: pymes_tpu/{module} has no public callable {qual}")
        port_def = _port_callable(module, qual)
        assert port_def is not None, f"{key}: the port has no {qual}"
        jax_sig, port_sig = _sig(jax_def), _sig(port_def)
        if param:
            assert param in jax_sig.names, (
                f"{key}: the JAX {qual} has no parameter {param}")
            assert param not in port_sig.names, (
                f"{key}: the port's {qual} takes {param}; drop the entry")
        else:
            assert _binding_faults(module, qual, jax_sig, port_sig,
                                   excused=False), (
                f"{key}: the port's {qual} now follows the binding rule; "
                "drop the entry")
        return
    if name == "*":
        assert not (PORT_PKG / module).exists(), (
            f"{key}: the port now has the module; drop the entry")
        return
    assert name in _public_defs(JAX_PKG / module), (
        f"{key}: pymes_tpu/{module} has no public top-level {name}")
    port = PORT_PKG / module
    assert not (port.is_file() and name in _top_level_names(port)), (
        f"{key}: the port now binds {name}; drop the entry")


class _Sig(NamedTuple):
    pos: tuple        # positional parameter names, self/cls dropped
    defaults: dict    # name -> unparsed default, positional ones
    kwonly: tuple
    varargs: bool
    names: frozenset  # every named parameter


def _sig(fn):
    a = fn.args
    params = a.posonlyargs + a.args
    defaults = dict(zip([p.arg for p in params][len(params)
                                                  - len(a.defaults):],
                        [ast.unparse(d) for d in a.defaults]))
    pos = [p.arg for p in params]
    is_static = any(isinstance(d, ast.Name) and d.id == "staticmethod"
                    for d in fn.decorator_list)
    if fn.is_method and not is_static:
        pos = pos[1:]
    kwonly = tuple(p.arg for p in a.kwonlyargs)
    return _Sig(tuple(pos), defaults, kwonly, a.vararg is not None,
                frozenset(pos) | frozenset(kwonly))


def _is_property(fn):
    return any(isinstance(d, ast.Name) and d.id == "property"
               or isinstance(d, ast.Attribute) and d.attr in ("setter",
                                                             "deleter")
               for d in fn.decorator_list)


def _defs(body):
    return {n.name: n for n in body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))}


def _jax_callables(module):
    """Qualified name -> def of the public functions of a JAX module and
    the public methods (``__init__`` included) defined in the bodies of
    its public classes."""
    out = {}
    for name, node in _defs(_tree(JAX_PKG / module).body).items():
        if name.startswith("_"):
            continue
        if isinstance(node, ast.ClassDef):
            for m, fn in _defs(node.body).items():
                if (isinstance(fn, ast.ClassDef) or _is_property(fn)
                        or (m.startswith("_") and m != "__init__")):
                    continue
                fn.is_method = True
                out[f"{name}.{m}"] = fn
        else:
            node.is_method = False
            out[name] = node
    return out


def _port_module(dotted):
    """Path of a ``pymes_tpu_torch`` module named ``dotted``, or None."""
    rel = Path(*dotted.split(".")[1:])
    for p in (PORT_PKG / rel.with_suffix(".py"), PORT_PKG / rel
              / "__init__.py"):
        if p.is_file():
            return p
    return None


def _port_binding(path, name, depth=0):
    """The def or class that ``name`` is bound to at the top level of the
    port module ``path`` (through imports from the port and plain
    aliases), as ``(path, node)``, or None."""
    if depth > 8 or path is None:
        return None
    body = _tree(path).body
    if name in _defs(body):
        return path, _defs(body)[name]
    for n in body:
        if (isinstance(n, ast.ImportFrom) and n.module
                and n.module.startswith("pymes_tpu_torch")):
            for a in n.names:
                if (a.asname or a.name) == name:
                    return _port_binding(_port_module(n.module), a.name,
                                         depth + 1)
        if (isinstance(n, ast.Assign) and isinstance(n.value, ast.Name)
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in n.targets)):
            return _port_binding(path, n.value.id, depth + 1)
    return None


def _port_module_alias(path, alias):
    """The port module that ``alias`` names in ``path`` (``from
    pymes_tpu_torch.x import mod``), or None."""
    for n in _tree(path).body:
        if (isinstance(n, ast.ImportFrom) and n.module
                and n.module.startswith("pymes_tpu_torch")):
            for a in n.names:
                if (a.asname or a.name) == alias:
                    return _port_module(f"{n.module}.{a.name}")
    return None


def _port_method(path, cls, name, depth=0):
    """A method of the port class ``cls`` of module ``path``: from its
    body, else from its bases, in order."""
    if depth > 8:
        return None
    fn = _defs(cls.body).get(name)
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return fn
    for base in cls.bases:
        if isinstance(base, ast.Name):
            found = _port_binding(path, base.id)
        elif isinstance(base, ast.Attribute) and isinstance(base.value,
                                                            ast.Name):
            found = _port_binding(_port_module_alias(path, base.value.id),
                                  base.attr)
        else:
            found = None
        if found and isinstance(found[1], ast.ClassDef):
            fn = _port_method(found[0], found[1], name, depth + 1)
            if fn is not None:
                return fn
    return None


def _port_callable(module, qual):
    """The port's def for the JAX callable ``qual`` of ``module``."""
    head, _, meth = qual.partition(".")
    found = _port_binding(PORT_PKG / module, head)
    if found is None:
        return None
    path, node = found
    if meth:
        if not isinstance(node, ast.ClassDef):
            return None
        fn = _port_method(path, node, meth)
        if fn is not None:
            fn.is_method = True
        return fn
    if isinstance(node, ast.ClassDef):
        return None
    node.is_method = False
    return node


def _binding_faults(module, qual, jax_sig, port_sig, excused=True):
    """The ways the port's signature breaks the binding rule (the JAX
    parameters excused in NOT_PORTED left out when ``excused``)."""
    faults = []
    n = len(port_sig.pos)
    if port_sig.pos != jax_sig.pos[:n]:
        faults.append(f"positional {list(port_sig.pos)} is not a prefix of "
                      f"the JAX {list(jax_sig.pos)}")
    else:
        for p in port_sig.pos:
            if port_sig.defaults.get(p) != jax_sig.defaults.get(p):
                faults.append(f"default of {p}: {port_sig.defaults.get(p)} "
                              f"!= the JAX {jax_sig.defaults.get(p)}")
    if port_sig.varargs and n < len(jax_sig.pos):
        faults.append("*args takes JAX positional parameters")
    missing = sorted(p for p in jax_sig.names - port_sig.names
                     if not (excused
                             and f"{module}:{qual}({p})" in NOT_PORTED))
    if missing:
        faults.append(f"does not take the JAX parameters {missing}")
    only = sorted(p for p in port_sig.pos if p not in jax_sig.names)
    if only:
        faults.append(f"port-only parameters {only} are positional")
    return faults


SIGNATURES = sorted(
    f"{module}:{qual}" for module in JAX_MODULES
    if f"{module}:*" not in NOT_PORTED
    for qual in _jax_callables(module)
    if f"{module}:{qual.partition('.')[0]}" not in NOT_PORTED)


def test_every_signature_is_listed():
    assert len(SIGNATURES) >= 190
    assert "solver/ccsd.py:CCSD.solve" in SIGNATURES
    assert "solver/ccd.py:CCD.get_residual" in SIGNATURES


@pytest.mark.parametrize("key", SIGNATURES)
def test_port_signature_accepts_the_jax_calls(key):
    """The port's counterpart of a JAX callable follows the binding rule
    of the module docstring, or its signature is excused in NOT_PORTED."""
    module, qual = key.split(":")
    port_def = _port_callable(module, qual)
    assert port_def is not None, (
        f"pymes_tpu/{module}: no counterpart of {qual} in pymes_tpu_torch/"
        f"{module}")
    if f"{key}()" in NOT_PORTED:
        return
    faults = _binding_faults(module, qual,
                             _sig(_jax_callables(module)[qual]),
                             _sig(port_def))
    assert not faults, (f"pymes_tpu_torch/{module} {qual}: "
                        + "; ".join(faults))


def test_not_ported_reasons_are_given():
    empty = sorted(k for k, why in NOT_PORTED.items()
                   if not isinstance(why, str) or not why.strip())
    assert not empty, f"NOT_PORTED entries without a reason: {empty}"
