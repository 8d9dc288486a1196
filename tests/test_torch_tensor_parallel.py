"""The port's tensor-parallel dense CCD/CCSD iteration against the JAX
package's GSPMD one, on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``
(``dryrun_multichip`` stages 1 and 4: V blocks and amplitudes cut over a
1-D ("a",) or 2-D ("a", "b") mesh, the unchanged solver); the port on
meshes that list the CPU P times (``["cpu"] * P``), with the blocks of
three or four virtual slots kept cut and contracted piece by piece.
Inputs come from ``numpy.random.default_rng(seed)`` or the repository's
integral files, f64 throughout.

Tolerances: the cut pieces equal JAX's addressable shards exactly (the
same slices); one CCSD step (e, T1, T2) 1e-12 absolute against JAX's
sharded step and the port's unsharded step (sums of O(1) products in
another order); converged solves 1e-10 per iteration and in energy against
the port's unsharded solve and the JAX package's sharded one (rounding
carried through ≤ 20 nonlinear iterations, as ``tests/test_torch_ccsd.py``);
oracles 1e-8 (BASELINE.md).  The guards of the last tests are exact: no
``abcd``-sized tensor is put together, and the bare pieces are
bit-unchanged.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from pymes_tpu.integral.partition import BLOCK_NAMES
from pymes_tpu.integral.partition import part_2_body_int as jpart
from pymes_tpu.parallel import mesh as jmesh
from pymes_tpu.solver import ccsd as jccsd
from pymes_tpu_torch.integral import contraction
from pymes_tpu_torch.integral.partition import part_2_body_int as tpart
from pymes_tpu_torch.mean_field import hf
from pymes_tpu_torch.mixer import diis
from pymes_tpu_torch.models import ueg
from pymes_tpu_torch.parallel import mesh as tmesh
from pymes_tpu_torch.parallel import tensor_parallel as tp
from pymes_tpu_torch.solver import ccd, ccsd
from pymes_tpu_torch.util import fcidump, tcdump

DATA = os.path.join(os.path.dirname(__file__), "data")
ORACLE_NP57 = -0.5120153512190824
ORACLE_LIH = -0.01908832712812761


def _cpu_mesh(n, shape=None):
    axes = ("a",) if shape is None else ("a", "b")
    return tmesh.make_mesh(n, device="cpu", axis_names=axes, shape=shape,
                           devices=["cpu"] * n)


def _close(got, want, tol):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol, err


# ---- 1. the 2-D mesh and the cut ---------------------------------------------

@pytest.mark.parametrize("axes", [("a",), ("a", "b")])
def test_vblock_axes_equal_vblock_pspec(axes):
    for name in BLOCK_NAMES:
        assert tmesh.vblock_axes(name, axes) == tuple(
            jmesh.vblock_pspec(name, axes)), name
        if axes == ("a",):
            spec = tmesh.vblock_axes(name)
            assert tmesh.vblock_axis(name) == (
                spec.index("a") if "a" in spec else None)


def test_make_mesh_2d_shape_matches_jax():
    for n in range(1, 9):
        mj = jmesh.make_mesh(n, axis_names=("a", "b"))
        mt = tmesh.make_mesh(n, device="cpu", axis_names=("a", "b"),
                             devices=["cpu"] * n)
        assert mt.grid == mj.devices.shape
        assert mt.shape == dict(zip(("a", "b"), mj.devices.shape))
    with pytest.raises(ValueError):
        tmesh.make_mesh(6, device="cpu", axis_names=("a", "b"), shape=(4, 2),
                        devices=["cpu"] * 6)


def test_shard_blocks_2d_match_jax_shards():
    """Every block and both amplitudes cut over the (2, 4) mesh equal the
    JAX package's addressable shards piece for piece; gather puts each
    back together."""
    rng = np.random.default_rng(2)
    no, nv = 2, 8
    size = {"o": no, "v": nv}
    arrs = {k: rng.standard_normal(tuple(
        size["v" if c in "abcd" else "o"] for c in k)) for k in BLOCK_NAMES}
    mj = jmesh.make_mesh(8, axis_names=("a", "b"), shape=(2, 4))
    mt = _cpu_mesh(8, (2, 4))
    sj = jmesh.shard_blocks(mj, {k: jnp.asarray(v) for k, v in arrs.items()})
    st = tmesh.shard_blocks(mt, {k: torch.as_tensor(v)
                                 for k, v in arrs.items()})
    T1 = rng.standard_normal((nv, no))
    T2 = rng.standard_normal((nv, nv, no, no))
    pairs = [(sj[k], st[k], arrs[k]) for k in BLOCK_NAMES]
    pairs += list(zip(jmesh.shard_amplitudes(mj, jnp.asarray(T1),
                                             jnp.asarray(T2)),
                      tmesh.shard_amplitudes(mt, torch.as_tensor(T1),
                                             torch.as_tensor(T2)),
                      (T1, T2)))
    pairs.append((jmesh.replicated(mj, jnp.asarray(T1)),
                  tmesh.replicated(mt, torch.as_tensor(T1)), T1))
    order = list(mj.devices.flat)
    for arr_j, arr_t, whole in pairs:
        assert len(arr_t.shards) == 8 and arr_t.grid == (2, 4)
        for shard in arr_j.addressable_shards:
            p = order.index(shard.device)
            assert np.array_equal(arr_t.shards[p].numpy(),
                                  np.asarray(shard.data))
        assert np.array_equal(arr_t.gather("cpu").numpy(), whole)
    # a slice on its device stays a view of the block
    abcd = torch.as_tensor(arrs["abcd"])
    piece = tmesh.shard_blocks(mt, {"abcd": abcd})["abcd"].shards[5]
    assert piece.data_ptr() == abcd[4:8, 2:4].data_ptr()


@pytest.mark.parametrize("shape", [None, (2, 3)])
def test_a_mesh_that_does_not_divide_nv_raises(shape):
    m = _cpu_mesh(3) if shape is None else _cpu_mesh(6, shape)
    with pytest.raises(ValueError):
        tmesh.shard_blocks(m, {"abcd": torch.zeros((16,) * 4)})


def test_collectives_and_per_piece_einsum():
    """map_pieces concatenates kept cut letters and sums contracted ones:
    tensor_parallel.einsum on a (2, 4)-cut block equals the whole
    einsum."""
    rng = np.random.default_rng(3)
    V = torch.as_tensor(rng.standard_normal((8, 2, 8, 8)))
    X = torch.as_tensor(rng.standard_normal((2, 2, 8, 8)))
    m = _cpu_mesh(8, (2, 4))
    for Vs in (tmesh.shard_blocks(m, {"aibc": V})["aibc"],
               # cut over "a" alone: each piece repeats over "b"
               tmesh.shard_blocks(m, {"aibc": V}, ("a",))["aibc"]):
        for spec, ops in (("ajbc,ijbc->ai", (Vs, X)),
                          ("cj,ajcb->ab", (X[0, :, :, 0].T.contiguous(),
                                           Vs)),
                          ("ajbc,ji->abci", (Vs, X[:, :, 0, 0]))):
            whole = [V if isinstance(o, tmesh.Sharded) else o for o in ops]
            _close(tp.einsum(spec, *ops), torch.einsum(spec, *whole), 1e-12)
    parts = [torch.ones(3) * k for k in range(4)]
    assert torch.equal(tp.reduce_sum(parts, "cpu"), torch.full((3,), 6.0))
    assert tp.concat(parts, 0, "cpu").shape == (12,)


# ---- 2. one CCSD step, as dryrun_multichip stage 1 ----------------------------

@pytest.fixture(scope="module")
def synthetic():
    import __graft_entry__ as g
    no, nv = 2, 16
    return no, g._synthetic_system(no=no, nv=nv, dtype=np.float64)


def _jax_step(no):
    def step(f, dict_V, T1, T2, D_ai, D_abij, diis_state):
        T1, T2, diis_state, e, dE = jccsd.ccsd_iteration(
            f, dict_V, no, T1, T2, D_ai, D_abij, diis_state,
            jnp.zeros((), f.dtype))
        return T1, T2, e
    return jax.jit(step)


def _port_step(no, f, dict_V, T1, T2):
    """One port CCSD iteration from (T1, T2 abij); returns (T1, T2 abij,
    e)."""
    f = torch.as_tensor(f)
    eps = torch.diagonal(f)
    T1 = torch.as_tensor(T1).clone()
    T2 = torch.as_tensor(T2).permute(2, 3, 0, 1).contiguous()
    state = diis.init_state(6, T1.numel() + T2.numel(), T2.dtype, device="cpu")
    _, e, _, info = ccsd.ccsd_iteration(
        f, dict_V, no, T1, T2, eps[:no].contiguous(), eps[no:].contiguous(),
        0.0, state, torch.zeros((), dtype=T2.dtype))
    assert int(info) == 0
    return T1.numpy(), T2.permute(2, 3, 0, 1).numpy(), float(e)


@pytest.mark.parametrize("t1", ["zero", "seeded"])
@pytest.mark.parametrize("shape", [None, (2, 4)], ids=["1d", "2d"])
def test_ccsd_step_matches_jax_sharded_step(synthetic, shape, t1):
    """From the system's T1 = 0, and from a seeded T1 ≠ 0 that makes the
    step dress every block."""
    no, (f, dict_V, T1, T2, D_ai, D_abij, state) = synthetic
    if t1 == "seeded":
        T1 = np.random.default_rng(4).standard_normal(T1.shape) * 0.05
    if shape is None:
        mj = jmesh.make_mesh(8, axis_names=("a",))
    else:
        mj = jmesh.make_mesh(8, axis_names=("a", "b"), shape=shape)
    step = _jax_step(no)
    ref = step(jmesh.replicated(mj, f), jmesh.shard_blocks(mj, dict_V),
               *jmesh.shard_amplitudes(mj, T1, T2),
               *jmesh.shard_amplitudes(mj, D_ai, D_abij), state)

    whole = {k: torch.as_tensor(v) for k, v in dict_V.items()}
    one = _port_step(no, f, whole, T1, T2)
    m = _cpu_mesh(8, shape)
    d = ccsd.CCSD(no, device="cpu")._dict_on_device(
        tmesh.shard_blocks(m, whole))
    assert all(isinstance(d[k], tmesh.Sharded)
               for k in ("abcd", "iabc", "aibc", "abic", "abci"))
    got = _port_step(no, f, d, T1, T2)
    for g_, o_, r_ in zip(got, one, (ref[0], ref[1], ref[2])):
        _close(g_, r_, 1e-12)
        _close(g_, o_, 1e-12)


# ---- 3. dense UEG CCD at nP=57 -------------------------------------------------

@pytest.fixture(scope="module")
def ueg57():
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(5)
    V = torch.as_tensor(u.eval_2b_integrals())
    fock = hf.construct_hf_matrix(
        7, torch.diag(torch.as_tensor(u.kinetic_energies())), V)
    return fock, tpart(7, V)


@pytest.mark.parametrize("flags", [{}, {"is_dcd": True},
                                   {"is_bruekner": True}],
                         ids=["ccd", "dcd", "bruekner"])
@pytest.mark.parametrize("n,shape", [(5, None), (10, (2, 5))],
                         ids=["5", "2x5"])
def test_dense_ccd_np57_on_a_cut_abcd(ueg57, n, shape, flags):
    fock, d = ueg57
    kw = dict(level_shift=-1.0, max_iter=60)
    one = ccd.CCD(7, device="cpu", **flags).solve(fock, d, **kw)
    res = ccd.CCD(7, device="cpu", **flags).solve(
        fock, tmesh.shard_blocks(_cpu_mesh(n, shape), d), **kw)
    assert len(res["e history"]) == len(one["e history"])
    _close(res["e history"], one["e history"], 1e-10)
    _close(res["t2 amp"], one["t2 amp"], 1e-10)
    if not flags:
        assert abs(res["ccd e"] - ORACLE_NP57) <= 1e-8


# ---- 4. LiH CCSD on 3 shards and 3 × 3 ---------------------------------------

@pytest.fixture(scope="module")
def lih():
    n_elec, _, _, _, h, V = fcidump.read(os.path.join(DATA,
                                                      "FCIDUMP.LiH.321g"))
    no = n_elec // 2
    fock = hf.construct_hf_matrix(no, torch.as_tensor(h), torch.as_tensor(V))
    return no, fock, V


@pytest.fixture(scope="module")
def lih_jax(lih):
    no, fock, V = lih
    mj = jmesh.make_mesh(3, axis_names=("a",))
    return jccsd.CCSD(no).solve(
        jnp.asarray(fock.numpy()), jmesh.shard_blocks(mj, jpart(no, jnp.asarray(V))),
        delta_e=1e-10, max_iter=100, contract_mode="xla")


@pytest.mark.parametrize("n,shape", [(3, None), (9, (3, 3))],
                         ids=["3", "3x3"])
def test_lih_ccsd_on_a_cut_mesh(lih, lih_jax, n, shape):
    no, fock, V = lih
    d = tpart(no, torch.as_tensor(V))
    m = _cpu_mesh(n, shape)
    kw = dict(delta_e=1e-10, max_iter=100)
    res = ccsd.CCSD(no, device="cpu").solve(fock, tmesh.shard_blocks(m, d),
                                            **kw)
    assert abs(res["ccsd e"] - ORACLE_LIH) <= 1e-8
    assert float(res["t1"].abs().max()) > 1e-4
    assert len(res["e history"]) == len(lih_jax["e history"])
    _close(res["e history"], lih_jax["e history"], 1e-10)
    _close(res["t1"], lih_jax["t1"], 1e-9)
    # amplitudes given cut (shard_amplitudes) start the same solve
    again = ccsd.CCSD(no, device="cpu").solve(
        fock, tmesh.shard_blocks(m, d), max_iter=3, delta_e=-1.0,
        amps=tmesh.shard_amplitudes(m, res["t1"], res["t2"]))
    ref = ccsd.CCSD(no, device="cpu").solve(fock, d, max_iter=3, delta_e=-1.0,
                                            amps=(res["t1"], res["t2"]))
    _close(again["e history"], ref["e history"], 1e-12)
    # the DCSD flag against the unsharded port
    dcsd = ccsd.CCSD(no, device="cpu", is_dcsd=True)
    got = dcsd.solve(fock, tmesh.shard_blocks(m, d), **kw)
    one = dcsd.solve(fock, d, **kw)
    assert len(got["e history"]) == len(one["e history"])
    _close(got["e history"], one["e history"], 1e-10)


# ---- 5. transcorrelated (non-Hermitian) dense CCSD ----------------------------

@pytest.mark.parametrize("n,shape", [(2, None), (4, (2, 2))],
                         ids=["2", "2x2"])
def test_tc_lih_ccsd_on_a_cut_mesh(n, shape):
    """TC-LiH: V is not Hermitian, so no shortcut through a symmetry of V
    may stand in for a block the cut pieces do not hold."""
    n_elec, _, _, _, h, V = fcidump.read(
        os.path.join(DATA, "FCIDUMP.LiH.tc"), is_tc=True)
    no = n_elec // 2
    L = tcdump.read(os.path.join(DATA, "TCDUMP.LiH_FNO"))
    fock = hf.construct_hf_matrix(no, torch.as_tensor(h), torch.as_tensor(V))
    fock = fock + torch.as_tensor(contraction.get_double_contraction(no, L))
    V = torch.as_tensor(V + contraction.get_single_contraction(no, L))
    d = tpart(no, V)
    assert float((d["iabc"] - d["abci"].permute(3, 2, 1, 0)).abs().max()) \
        > 1e-6  # not Hermitian
    kw = dict(delta_e=1e-11)
    one = ccsd.CCSD(no, device="cpu").solve(fock, d, **kw)
    res = ccsd.CCSD(no, device="cpu").solve(
        fock, tmesh.shard_blocks(_cpu_mesh(n, shape), d), **kw)
    assert len(res["e history"]) == len(one["e history"])
    _close(res["e history"], one["e history"], 1e-10)


# ---- 6, 7. no v⁴ block put together; the bare pieces untouched --------------

class _NoCat(torch.Tensor):
    """A piece that refuses to be concatenated (or stacked)."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func in (torch.cat, torch.concat, torch.concatenate, torch.stack):
            raise AssertionError("a piece of a cut abcd was concatenated")
        with torch._C.DisableTorchFunctionSubclass():
            return func(*args, **(kwargs or {}))


class _NoGather(tmesh.Sharded):
    def gather(self, device):
        raise AssertionError("a cut abcd was gathered")


@pytest.fixture()
def no_v4_cat(monkeypatch):
    """torch.cat refuses to make a tensor of nv⁴ elements or more."""
    limit = {}
    cat = torch.cat

    def guarded(tensors, *args, **kw):
        out = cat(tensors, *args, **kw)
        if out.numel() >= limit["n"]:
            raise AssertionError(f"a tensor of {out.numel()} elements was "
                                 "put together")
        return out

    monkeypatch.setattr(torch, "cat", guarded)
    return limit


def _guarded(d, m):
    ds = tmesh.shard_blocks(m, d)
    a = ds["abcd"]
    ds["abcd"] = _NoGather(tuple(s.as_subclass(_NoCat) for s in a.shards),
                           a.axis, a.grid)
    return ds


@pytest.mark.parametrize("shape", [None, (2, 4)], ids=["1d", "2d"])
def test_no_v4_block_is_put_together(synthetic, no_v4_cat, shape):
    no, (f, dict_V, *_) = synthetic
    nv = f.shape[0] - no
    no_v4_cat["n"] = nv ** 4
    d = {k: torch.as_tensor(v) for k, v in dict_V.items()}
    fock = torch.as_tensor(f)
    m = _cpu_mesh(8, shape)
    kw = dict(max_iter=4, delta_e=-1.0)
    for solver in (ccd.CCD(no, device="cpu"), ccsd.CCSD(no, device="cpu")):
        got = solver.solve(fock, _guarded(d, m), **kw)
        one = solver.solve(fock, d, **kw)
        _close(got["e history"], one["e history"], 1e-12)
    with pytest.raises(AssertionError):   # the guards hold
        _guarded(d, m)["abcd"].gather("cpu")


@pytest.mark.parametrize("n,shape", [(3, None), (9, (3, 3))],
                         ids=["3", "3x3"])
def test_bare_pieces_unchanged_after_a_ccsd_solve(lih, n, shape):
    """On a 1-D mesh the pieces of abcd are contiguous views of it, on a
    2-D one strided views: neither is written by the dressing."""
    no, fock, V = lih
    d = {k: v.contiguous() for k, v in tpart(no, torch.as_tensor(V)).items()}
    ds = tmesh.shard_blocks(_cpu_mesh(n, shape), d)
    before = {k: [s.clone() for s in ds[k].shards] for k in ds}
    ccsd.CCSD(no, device="cpu").solve(fock, ds, max_iter=4, delta_e=-1.0)
    for k, pieces in before.items():
        for s, b in zip(ds[k].shards, pieces):
            assert torch.equal(s, b), k
    assert torch.equal(ds["abcd"].gather("cpu"), d["abcd"])
