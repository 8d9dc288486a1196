"""The JAX package's calls, made on the port, on the CPU: every call of the
three ``examples/*.py`` drivers binds the port's counterpart to the same
parameter names as the JAX callable; CCD's reference-signature
``get_residual``/``get_energy``, the reference's ``chunk`` of
``ladder_apply`` and a positional ``CCSD.solve`` give the JAX package's
numbers; an entry point given no device goes to the card and raises without
one; the host arrays of the reference's drivers start a drive; the reference
keywords of the TCDUMP reader and writer and FEAST's ``dump_log`` exist.

Tolerances: the residual and energy pieces 1e-10 relative (the issue's
bound; they agree to about 1e-15); the K1 twin with and without ``chunk``
bit for bit, the JAX ladder 1e-12 relative (another summation order); the
CCSD energy 1e-10 (the port's iteration against the JAX package's, as in
``tests/test_torch_ccsd.py``); the Fock matrix and HF energy from host
arrays 1e-12 relative; the TCDUMP round trip exactly.
"""

import ast
import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pymes_tpu.integral.partition import part_2_body_int as jpart
from pymes_tpu.mean_field import hf as jhf
from pymes_tpu.models import ueg as jueg
from pymes_tpu.ops import ueg_ladder as jladder
from pymes_tpu.solver import ccd as jccd
from pymes_tpu.solver import ccsd as jccsd
from pymes_tpu.util import fcidump as jfcidump
from pymes_tpu.util import tcdump as jtcdump
from pymes_tpu_torch.integral.partition import part_2_body_int as tpart
from pymes_tpu_torch.kernels import block_ladder as k1
from pymes_tpu_torch.mean_field import hf as thf
from pymes_tpu_torch.models import ueg as tueg
from pymes_tpu_torch.ops import ueg_ladder as tladder
from pymes_tpu_torch.solver import ccd as tccd
from pymes_tpu_torch.solver import ccsd as tccsd
from pymes_tpu_torch.solver import eom_ccsd as teom
from pymes_tpu_torch.solver import feast_eom_ccsd as tfeast
from pymes_tpu_torch.solver import rt_eom_ccsd as trt
from pymes_tpu_torch.util import tcdump as ttcdump

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
NO = 7
REL = 1e-10


# --- the examples' calls ------------------------------------------------

def _example_calls():
    """(id, callee path, n positional, keyword names) of every call in the
    three ``examples/*.py`` files whose callee is a ``pymes_tpu`` function,
    class, or a method of an instance made from such a class."""
    out = []
    for path in sorted((REPO / "examples").glob("*.py")):
        tree = ast.parse(path.read_text(encoding="utf-8"))
        names = {}   # local name -> dotted pymes_tpu path
        for n in ast.walk(tree):
            if (isinstance(n, ast.ImportFrom) and n.module
                    and n.module.split(".")[0] == "pymes_tpu"):
                for a in n.names:
                    names[a.asname or a.name] = f"{n.module}.{a.name}"
        # instances: x = <pymes_tpu class>(...)
        for n in ast.walk(tree):
            if (isinstance(n, ast.Assign) and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Name)
                    and isinstance(n.value, ast.Call)):
                callee = _dotted(n.value.func, names)
                if callee and callee.rsplit(".", 1)[1][:1].isupper():
                    names[n.targets[0].id] = callee
        for n in ast.walk(tree):
            if not isinstance(n, ast.Call):
                continue
            callee = _dotted(n.func, names)
            if callee is None:
                continue
            assert not any(isinstance(a, ast.Starred) for a in n.args)
            out.append((f"{path.name}:{n.lineno}:{ast.unparse(n.func)}",
                        callee, len(n.args),
                        tuple(k.arg for k in n.keywords)))
    return out


def _dotted(func, names):
    parts = []
    while isinstance(func, ast.Attribute):
        parts.append(func.attr)
        func = func.value
    if not isinstance(func, ast.Name) or func.id not in names:
        return None
    return ".".join([names[func.id]] + parts[::-1])


def _resolve(dotted):
    """The object at a dotted path: the longest importable module prefix,
    then attributes."""
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        for p in parts[i:]:
            obj = getattr(obj, p)
        return obj, parts[i:]
    raise ImportError(dotted)


def _binding(dotted, n_pos, kw):
    """The parameter names that a call with ``n_pos`` positional arguments
    and keywords ``kw`` binds, each to its argument's position or keyword
    (``**kwargs`` entries flattened)."""
    obj, attrs = _resolve(dotted)
    args = [("pos", i) for i in range(n_pos)]
    kwargs = {k: ("kw", k) for k in kw}
    is_method = len(attrs) >= 2 and inspect.isclass(
        _resolve(dotted.rsplit(".", 1)[0])[0])
    sig = inspect.signature(obj)
    bound = (sig.bind(("self",), *args, **kwargs) if is_method
             else sig.bind(*args, **kwargs))
    out = {}
    for name, value in bound.arguments.items():
        kind = sig.parameters[name].kind
        if kind is inspect.Parameter.VAR_KEYWORD:
            out.update(value)
        elif name != "self" or not is_method:
            out[name] = value
    return out


EXAMPLE_CALLS = _example_calls()


def test_example_calls_are_listed():
    assert len(EXAMPLE_CALLS) >= 25
    callees = {c[1] for c in EXAMPLE_CALLS}
    assert "pymes_tpu.solver.ccsd.CCSD.solve" in callees
    assert "pymes_tpu.mean_field.hf.construct_hf_matrix" in callees


@pytest.mark.parametrize("call", EXAMPLE_CALLS, ids=[c[0] for c in
                                                    EXAMPLE_CALLS])
def test_example_call_binds_the_same_names(call):
    """The exact call shape of the JAX example binds the port's callable
    (same path under ``pymes_tpu_torch``) to the same parameter names,
    argument for argument."""
    _, callee, n_pos, kw = call
    port = "pymes_tpu_torch" + callee[len("pymes_tpu"):]
    assert _binding(port, n_pos, kw) == _binding(callee, n_pos, kw)


# --- CCD.get_residual / get_energy ----------------------------------------

@pytest.fixture(scope="module")
def ueg57():
    """The nP=57 UEG (14 electrons, rs 0.5, cutoff 5): the named CCD blocks
    with ``abcd``, the HF Fock matrix and seeded amplitudes around MP2."""
    u = tueg.UEG(14, NO, NO, 0.5)
    u.init_single_basis(5)
    idx, vals = u.eval_2b_integrals(sp=2)
    n_p = u.n_spatial
    assert n_p == 57
    names = ("klij", "ijab", "abij", "iajb", "iabj", "abcd", "aibj", "aijb")
    d = tueg.sparse_to_blocks(idx, vals, n_p, NO, names=names, device="cpu")
    kin = u.kinetic_energies()
    eps = torch.cat([thf.calcOccupiedOrbE(kin, d["klij"], NO),
                     thf.calcVirtualOrbE(kin, d["aibj"], d["aijb"], NO,
                                         n_p - NO)])
    ei, ea = eps[:NO], eps[NO:]
    T = d["abij"] / (ei[None, None, :, None] + ei[None, None, None, :]
                     - ea[:, None, None, None] - ea[None, :, None, None])
    rng = np.random.default_rng(21)
    T = T + torch.as_tensor(1e-3 * rng.standard_normal(tuple(T.shape)))
    return torch.diag(eps), d, T


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("is_dcd", [False, True], ids=["ccd", "dcd"])
def test_ccd_get_residual_and_energy_match_jax(ueg57, is_dcd):
    fock, d, T = ueg57
    blocks = [d[k] for k in ("klij", "ijab", "abij", "iajb", "iabj",
                             "abcd")]
    got = tccd.CCD(NO, is_dcd=is_dcd, device="cpu").get_residual(
        fock, T, *blocks)
    jc = jccd.CCD(NO, is_dcd=is_dcd)
    want = jc.get_residual(jnp.asarray(fock.numpy()), jnp.asarray(T.numpy()),
                           *(jnp.asarray(b.numpy()) for b in blocks))
    assert float(np.abs(np.asarray(want)).max()) > 1e-3
    assert _rel(got, want) <= REL
    # numpy inputs (the reference's drivers) give the same residual
    got_np = tccd.CCD(NO, is_dcd=is_dcd, device="cpu").get_residual(
        fock.numpy(), T.numpy(), *(b.numpy() for b in blocks))
    assert torch.equal(got_np, got)
    e_t = tccd.CCD(NO, device="cpu").get_energy(T, d["ijab"])
    e_j = jc.get_energy(jnp.asarray(T.numpy()), jnp.asarray(
        d["ijab"].numpy()))
    assert len(e_t) == len(e_j) == 2
    for a, b in zip(e_t, e_j):
        assert _rel(float(a), float(b)) <= REL


# --- the reference's chunk of ladder_apply --------------------------------

def test_ladder_apply_chunk_is_the_default_call(monkeypatch):
    """``ladder_apply(plan, T, 1)``, the reference's ``chunk`` spelled out,
    is the default call (K1's route: ``twin`` stays False) bit for bit, and
    the JAX package's ``ladder_apply(plan, T, 1)``."""
    uj, ut = jueg.UEG(14, NO, NO, 0.5), tueg.UEG(14, NO, NO, 0.5)
    uj.init_single_basis(2)
    ut.init_single_basis(2)
    plan = tladder.build_block_ladder(ut, device="cpu")
    nv = plan.nv
    T = np.random.default_rng(4).standard_normal((nv, nv, NO, NO))
    twins = []
    real = k1.block_ladder_cd

    def spy(*args, twin=False):
        twins.append(twin)
        return real(*args, twin=twin)

    monkeypatch.setattr(k1, "block_ladder_cd", spy)
    got = tladder.ladder_apply(plan, torch.as_tensor(T), 1)
    assert twins == [False]
    assert torch.equal(got, tladder.ladder_apply(plan, torch.as_tensor(T)))
    want = jladder.ladder_apply(
        jladder.build_block_ladder(uj, preslice=None), jnp.asarray(T), 1)
    assert _rel(got, want) <= 1e-12


# --- a positional CCSD.solve ---------------------------------------------

def test_positional_ccsd_solve_matrix_free_np57_matches_jax():
    """``solve(f, V, 0.0, None, 0, plan)``: level_shift, amps, sp and the
    ladder by position, in both packages, on the matrix-free nP=57 UEG with
    a seeded non-canonical Fock matrix (T1 ≠ 0)."""
    ut, uj = tueg.UEG(14, NO, NO, 0.5), jueg.UEG(14, NO, NO, 0.5)
    ut.init_single_basis(5)
    uj.init_single_basis(5)
    V = ut.eval_2b_integrals()
    fock = np.asarray(thf.construct_hf_matrix(
        NO, np.diag(ut.kinetic_energies()), V, device="cpu"))
    noise = np.random.default_rng(5).standard_normal(fock.shape)
    fock = fock + 0.02 * (noise + noise.T)
    drop = ("abcd", "abci", "iabc", "aibc", "abic")
    dt = {k: v for k, v in tpart(NO, torch.as_tensor(V)).items()
          if k not in drop}
    dt["_ovvv_plans"] = tladder.build_ovvv_plans(ut, device="cpu")
    dj = {k: v for k, v in jpart(NO, jnp.asarray(V)).items()
          if k not in drop}
    dj["_ovvv_plans"] = jladder.build_ovvv_plans(uj)
    kw = dict(delta_e=1e-10, max_iter=100)
    got = tccsd.CCSD(NO, device="cpu").solve(
        fock, dt, 0.0, None, 0, tladder.build_block_ladder(
            ut, device="cpu", bra="all"), **kw)
    want = jccsd.CCSD(NO).solve(
        jnp.asarray(fock), dj, 0.0, None, 0, jladder.build_block_ladder(
            uj, bra="all", preslice=None), **kw)
    assert float(got["t1"].abs().max()) > 1e-3
    assert len(got["e history"]) == len(want["e history"])
    assert abs(got["ccsd e"] - want["ccsd e"]) <= 1e-10


# --- no device: the card ---------------------------------------------------

def _ueg2():
    u = tueg.UEG(14, NO, NO, 0.5)
    u.init_single_basis(2)
    return u


ENTRY_POINTS = {
    "CCD(no)": lambda: tccd.CCD(NO).device,
    "CCSD(no)": lambda: tccsd.CCSD(NO).device,
    "EOM_CCSD(no, n_excit=2)": lambda: teom.EOM_CCSD(NO, n_excit=2).device,
    "build_block_ladder(u)": lambda: tladder.build_block_ladder(
        _ueg2()).inv_bra.device,
    "sparse_to_blocks(idx, vals, n_p, no)": lambda: next(iter(
        tueg.sparse_to_blocks(*_ueg2().eval_2b_integrals(sp=2),
                              _ueg2().n_spatial, NO).values())).device,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_no_device_is_the_card(name, monkeypatch):
    """Given no device, an entry point places its tensors on the card; on a
    machine without one it raises RuntimeError and never falls back to the
    CPU (no tensor is made there: ``torch.as_tensor``, ``torch.zeros`` and
    the host-to-device copies of the builders are watched)."""
    if torch.cuda.is_available():
        assert ENTRY_POINTS[name]().type == "cuda"
        return
    made = []
    for fn in ("as_tensor", "zeros", "tensor"):
        real = getattr(torch, fn)

        def watch(*a, _real=real, **k):
            out = _real(*a, **k)
            made.append(out.device)
            return out

        monkeypatch.setattr(torch, fn, watch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name]()
    assert made == []


# --- host arrays start a drive ----------------------------------------------

def test_hf_and_dressing_take_host_arrays():
    """The reference's drivers hand ``fcidump.read``'s numpy arrays to the
    HF functions and the dressing; the results stay tensors on the device
    (the CPU here) that numpy reads as it reads a JAX device array."""
    n_elec, _, e_core, _, h, V = jfcidump.read(str(DATA / "FCIDUMP.LiH.321g"))
    no = n_elec // 2
    fock = thf.construct_hf_matrix(no, h, V, device="cpu")
    assert isinstance(fock, torch.Tensor) and fock.device.type == "cpu"
    want = np.asarray(jhf.construct_hf_matrix(no, h, V))
    assert _rel(np.asarray(fock), want) <= 1e-12
    assert type(fock + 0) is torch.Tensor   # goes no further than the value
    e = thf.calc_hf_e(no, e_core, h, V, device="cpu")
    assert _rel(float(e), float(jhf.calc_hf_e(no, e_core, h, V))) <= 1e-12
    assert abs(float(e) - (-7.92958534362757)) <= 1e-8
    # the dressing: a host dict and host T1 give the tensor dict's numbers
    nv = h.shape[0] - no
    T1 = 0.05 * np.random.default_rng(2).standard_normal((nv, no))
    d_np = tpart(no, V)
    d_t = tpart(no, torch.as_tensor(V))
    f_np = tccsd.get_T1_dressed_fock(np.asarray(fock), T1, d_np, no=no,
                                     device="cpu")
    f_t = tccsd.get_T1_dressed_fock(fock, torch.as_tensor(T1), d_t, no=no)
    assert torch.equal(f_np, f_t)
    Vd_np = tccsd.get_T1_dressed_V(T1, d_np, device="cpu")
    Vd_t = tccsd.get_T1_dressed_V(torch.as_tensor(T1), d_t)
    assert Vd_np.keys() == Vd_t.keys()
    assert all(torch.equal(Vd_np[k], Vd_t[k]) for k in Vd_t)


# --- A16: reader keywords, dump_log ----------------------------------------

def test_tcdump_reference_keywords_round_trip(tmp_path):
    path = str(DATA / "TCDUMP.H2.tc")
    L = ttcdump.read(path, sym=True, sp=1)
    assert np.array_equal(L, jtcdump.read(path, sym=True, sp=1))
    ttcdump.write(L, str(tmp_path / "t"), sym=True, type="r", sp=1)
    jtcdump.write(L, str(tmp_path / "j"), sym=True, type="r", sp=1)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    for back in (ttcdump.read(str(tmp_path / "t"), sym=True, sp=1),
                 jtcdump.read(str(tmp_path / "t"), sym=True, sp=1)):
        assert np.array_equal(back, L)


def test_feast_dump_log_exists():
    for cls in (tfeast.FEAST_EOM_CCSD, trt.RT_EOM_CCSD):
        assert cls(1, device="cpu").dump_log() is None
    assert trt.RT_EOM_CCSD.dump_log is tfeast.FEAST_EOM_CCSD.dump_log


def test_ccsd_takes_the_reference_constructor_order():
    """``CCSD(no, is_diis, delta_e, is_non_canonical, is_dcsd)`` by
    position, as the JAX package's; ``is_non_canonical`` is ignored."""
    s = tccsd.CCSD(NO, False, 1e-9, True, True, device="cpu")
    j = jccsd.CCSD(NO, False, 1e-9, True, True)
    assert (s.is_diis, s.delta_e, s.is_dcd) == (j.is_diis, j.delta_e,
                                                 j.is_dcd)
    assert (s.is_diis, s.delta_e, s.is_dcd) == (False, 1e-9, True)
