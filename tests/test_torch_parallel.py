"""The port's multi-device paths against the JAX package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port on meshes that list the CPU P times (``["cpu"] * P``), its
counterpart of virtual devices.  Inputs come from
``numpy.random.default_rng(seed)``, f64 throughout.

Tolerances: the ring ladder 1e-12 absolute against JAX's and the dense
einsum (sums of 256 terms of O(1) products in another order); one ring
step's product 1e-13 relative; ring-CCD per-iteration energies 1e-10
(building-block errors carried through 6 nonlinear iterations), the
oracle 1e-8 (BASELINE.md); the padded plan exact, its apply and the
sector-sharded apply bit for bit against the port's unsharded apply (the
same sector products, copied) and 1e-12 relative against JAX's; sharded
matrix-free CCSD 1e-10; the node fan-out of ``parallel/sharding.py``
1e-13 relative against the whole computation and the JAX package's
``vmap`` over its node-sharded inputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as JP
from pymes_tpu.integral.partition import part_2_body_int as jpart
from pymes_tpu.mean_field import hf as jhf
from pymes_tpu.models import ueg as jueg
from pymes_tpu.ops import ueg_ladder as jladder
from pymes_tpu.parallel import mesh as jmesh
from pymes_tpu.parallel import ring_ladder as jring
from pymes_tpu.parallel import sharding as jsharding
from pymes_tpu.solver import ccd as jccd
from pymes_tpu.solver import ccsd as jccsd
from pymes_tpu_torch import interop
from pymes_tpu_torch.integral.partition import part_2_body_int as tpart
from pymes_tpu_torch.kernels import ring_step as k9
from pymes_tpu_torch.models import ueg as tueg
from pymes_tpu_torch.ops import ueg_ladder as tladder
from pymes_tpu_torch.parallel import mesh as tmesh
from pymes_tpu_torch.parallel import ring_ladder as tring
from pymes_tpu_torch.parallel import sharding as tsharding
from pymes_tpu_torch.solver import ccd as tccd
from pymes_tpu_torch.solver import ccsd as tccsd

NO = 7
ORACLE_NP57 = -0.5120153512190824


def _cpu_mesh(n):
    return tmesh.make_mesh(n, "cpu", devices=["cpu"] * n)


def _jax_mesh(n, axis="a"):
    return jmesh.make_mesh(n, axis_names=(axis,))


@pytest.fixture(scope="module")
def ring_operands():
    rng = np.random.default_rng(0)
    no, nv = 3, 16
    return (rng.standard_normal((nv, nv, nv, nv)),
            rng.standard_normal((no, no, nv, nv)))


def test_largest_dividing_mesh_matches_jax():
    for dim in range(1, 60):
        for mx in (1, 2, 3, 4, 5, 8, 16):
            assert (tmesh.largest_dividing_mesh(dim, mx)
                    == jmesh.largest_dividing_mesh(dim, mx))


def test_make_mesh_takes_only_visible_cards():
    """More cards than torch sees raises (here: no card at all); the mesh
    never falls back to the CPU or folds shards onto one card."""
    with pytest.raises(RuntimeError):
        tmesh.make_mesh(torch.cuda.device_count() + 1, "cuda")


def test_repeated_device_only_from_an_explicit_list():
    with pytest.raises(RuntimeError):
        tmesh.make_mesh(4, "cpu")
    assert tmesh.make_mesh(1, "cpu").devices == (torch.device("cpu"),)
    m = tmesh.make_mesh(4, "cpu", devices=["cpu"] * 5)
    assert m.devices == (torch.device("cpu"),) * 4 and m.shape == {"a": 4}
    # a 2-D mesh takes a shape that holds its devices, and no third axis
    assert tmesh.Mesh(["cpu"] * 4, axis_names=("a", "b")).grid == (2, 2)
    with pytest.raises(ValueError):
        tmesh.Mesh(["cpu"] * 4, axis_names=("a", "b"), shape=(4, 2))
    with pytest.raises(ValueError):
        tmesh.Mesh(["cpu"] * 4, axis_names=("a", "b", "c"))


def test_shard_blocks_match_jax_shards():
    rng = np.random.default_rng(1)
    no, nv, n = 2, 8, 4
    blocks = {"abcd": (nv,) * 4, "ijab": (no, no, nv, nv),
              "klij": (no,) * 4, "iabj": (no, nv, nv, no),
              "aibj": (nv, no, nv, no)}
    arrs = {k: rng.standard_normal(s) for k, s in blocks.items()}
    mj = _jax_mesh(n)
    sj = jmesh.shard_blocks(mj, {k: jnp.asarray(v) for k, v in arrs.items()})
    st = tmesh.shard_blocks(_cpu_mesh(n),
                            {k: torch.as_tensor(v) for k, v in arrs.items()})
    order = list(mj.devices.flat)
    for name, arr in sj.items():
        assert st[name].axis == tmesh.vblock_axis(name)
        assert len(st[name].shards) == n
        for shard in arr.addressable_shards:
            p = order.index(shard.device)
            assert np.array_equal(st[name].shards[p].numpy(),
                                  np.asarray(shard.data)), (name, p)
        assert np.array_equal(st[name].gather("cpu").numpy(), arrs[name])
    # amplitudes cut on their first axis; a replicated tensor whole on each
    T1, T2 = rng.standard_normal((nv, no)), rng.standard_normal((nv, nv, no,
                                                                 no))
    jt = jmesh.shard_amplitudes(mj, jnp.asarray(T1), jnp.asarray(T2))
    tt = tmesh.shard_amplitudes(_cpu_mesh(n), torch.as_tensor(T1),
                                torch.as_tensor(T2))
    jt += (jmesh.replicated(mj, jnp.asarray(T1)),)
    tt += (tmesh.replicated(_cpu_mesh(n), torch.as_tensor(T1)),)
    for arr, sh in zip(jt, tt):
        for shard in arr.addressable_shards:
            assert np.array_equal(sh.shards[order.index(shard.device)].numpy(),
                                  np.asarray(shard.data))


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_ring_ladder_ij_matches_jax_and_dense(ring_operands, n_dev):
    V, T = ring_operands
    want = np.einsum("abcd,ijcd->ijab", V, T)
    mj = _jax_mesh(n_dev)
    V_sh = jax.device_put(jnp.asarray(V), NamedSharding(mj, JP("a")))
    T_sh = jax.device_put(jnp.asarray(T), NamedSharding(mj, JP(None, None,
                                                               "a")))
    ref = np.asarray(jax.jit(lambda v, t: jring.ring_ladder_inside_ij(
        v, t, mj))(V_sh, T_sh))
    m = _cpu_mesh(n_dev)
    got = tring.ring_ladder_inside_ij(
        tmesh.shard_blocks(m, {"abcd": torch.as_tensor(V)})["abcd"],
        torch.as_tensor(T), m).numpy()
    assert np.abs(got - ref).max() <= 1e-12
    assert np.abs(got - want).max() <= 1e-12


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_ring_ladder_abij_matches_jax_and_dense(ring_operands, n_dev):
    V, T = ring_operands
    Ta = np.ascontiguousarray(T.transpose(2, 3, 0, 1))
    want = np.einsum("abcd,cdij->abij", V, Ta)
    ref = np.asarray(jring.ring_ladder(jnp.asarray(V), jnp.asarray(Ta),
                                       _jax_mesh(n_dev)))
    m = _cpu_mesh(n_dev)
    got = tring.ring_ladder(torch.as_tensor(V), torch.as_tensor(Ta),
                            m).numpy()
    assert np.abs(got - ref).max() <= 1e-12
    assert np.abs(got - want).max() <= 1e-12
    # the jit-composable form on operands already cut over the mesh
    got2 = tring.ring_ladder_inside(
        tmesh.shard_tensor(m, torch.as_tensor(V), 0),
        tmesh.shard_tensor(m, torch.as_tensor(Ta), 0), m).numpy()
    assert np.array_equal(got2, got)


def test_ring_ladder_refuses_a_mesh_that_does_not_divide_nv(ring_operands):
    V, T = ring_operands
    m = _cpu_mesh(3)
    with pytest.raises(ValueError):
        tring.ring_ladder_inside_ij(torch.as_tensor(V), torch.as_tensor(T), m)


@pytest.mark.parametrize("layout", ["ijab", "abij"])
@pytest.mark.parametrize("n_dev", [2, 4])
def test_ring_step_twin_matches_jax_step(ring_operands, layout, n_dev):
    """K9's twin at every panel offset src against the JAX step's
    ``Tf @ Vf`` (``pymes_tpu/parallel/ring_ladder.py:86-96``), on the
    ijab views and on the abij (cd-major T, transposed R) views."""
    V, T = ring_operands
    no, nv = T.shape[0], T.shape[2]
    csz = nv // n_dev
    a_loc = csz
    V_loc = V[:a_loc]
    Vm = torch.as_tensor(V_loc).reshape(a_loc * nv, nv * nv)
    for src in range(n_dev):
        T_held = T[:, :, src * csz:(src + 1) * csz, :]
        Vs = jnp.asarray(V_loc[:, :, src * csz:(src + 1) * csz, :])
        Vf = jnp.transpose(Vs, (2, 3, 0, 1)).reshape(csz * nv, a_loc * nv)
        want = np.asarray(jnp.asarray(T_held).reshape(no * no, csz * nv)
                          @ Vf)
        R0 = np.random.default_rng(src).standard_normal(want.shape)
        if layout == "ijab":
            Tt = torch.as_tensor(np.ascontiguousarray(T_held)).view(
                no * no, -1)
            R = torch.as_tensor(R0.copy())
            k9.ring_step(R, Tt, Vm, src * csz * nv)
            got = R.numpy()
        else:
            Tc = torch.as_tensor(np.ascontiguousarray(
                T_held.transpose(2, 3, 0, 1))).view(-1, no * no)
            Rc = torch.as_tensor(np.ascontiguousarray(R0.T))
            k9.ring_step(Rc.t(), Tc.t(), Vm, src * csz * nv)
            got = Rc.numpy().T
        err = np.abs((got - R0) - want).max()
        assert err <= 1e-13 * np.abs(want).max(), (src, err)


@pytest.fixture(scope="module")
def ueg57():
    u = jueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(5)
    V = np.array(u.eval_2b_integrals())
    fock = np.array(jhf.construct_hf_matrix(
        NO, np.diag(u.kinetic_energies()), V))
    return fock, V


def test_ring_ccd_np57_matches_jax_and_oracle(ueg57):
    """Ring CCD at UEG nP=57 on a 5-shard CPU mesh: per-iteration energies
    against JAX's ring solve in the same (ijab) loop layout, and the
    converged energy against JAX's default (abij) ring solve and the
    oracle."""
    fock, V = ueg57
    nv = V.shape[0] - NO
    n_dev = jmesh.largest_dividing_mesh(nv, 8)
    assert n_dev == 5
    mj = _jax_mesh(n_dev)
    dj = jmesh.shard_blocks(mj, jpart(NO, jnp.asarray(V)))
    kw = dict(level_shift=-1.0, max_iter=60, ring_mesh=mj, ring_axis="a")
    ref_ij = jccd.CCD(NO).solve(jnp.asarray(fock), dj, layout="ijab",
                                contract_mode="xla", **kw)
    ref_ab = jccd.CCD(NO).solve(jnp.asarray(fock), dj, **kw)

    m = _cpu_mesh(n_dev)
    dt = tmesh.shard_blocks(m, tpart(NO, torch.as_tensor(V)))
    res = tccd.CCD(NO, "cpu").solve(torch.as_tensor(fock), dt,
                                    level_shift=-1.0, max_iter=60,
                                    ring_mesh=m)
    hist, want = res["e history"], np.asarray(ref_ij["e history"])
    assert len(hist) == len(want) == 6
    assert np.abs(hist - want).max() <= 1e-10
    assert abs(res["ccd e"] - ref_ab["ccd e"]) <= 1e-10
    assert abs(res["ccd e"] - ORACLE_NP57) <= 1e-8


def test_ring_ccd_refuses_a_plan_or_no_abcd(ueg57):
    fock, V = ueg57
    m = _cpu_mesh(5)
    d = tpart(NO, torch.as_tensor(V))
    solver = tccd.CCD(NO, "cpu")
    with pytest.raises(ValueError):
        solver.solve(torch.as_tensor(fock), {**d, "abcd": None},
                     ring_mesh=m, max_iter=1)
    u = tueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(5)
    with pytest.raises(ValueError):
        solver.solve(torch.as_tensor(fock),
                     {**d, "ladder": tladder.build_block_ladder(u, "cpu")},
                     ring_mesh=m, max_iter=1)


def _models(cutoff=2):
    uj, ut = jueg.UEG(14, 7, 7, 1.0), tueg.UEG(14, 7, 7, 1.0)
    uj.init_single_basis(cutoff)
    ut.init_single_basis(cutoff)
    return uj, ut


@pytest.mark.parametrize("bra", ["virtual", "all"])
@pytest.mark.parametrize("pad", [4, 8])
def test_padded_plan_matches_jax_leaf_for_leaf(pad, bra):
    uj, ut = _models()
    pj = jladder.build_block_ladder(uj, bra=bra, preslice=None,
                                    pad_sectors=pad)
    pt = tladder.build_block_ladder(ut, "cpu", bra=bra, pad_sectors=pad)
    pi = interop.block_ladder_from_numpy(pj, "cpu")
    assert any(g.blocks.shape[0] % pad == 0 and g.blocks.shape[0] > 0
               for g in pt.groups)
    for plan in (pt, pi):
        assert (plan.n_bra, plan.nv, plan.w0) == (pj.n_bra, pj.nv, pj.w0)
        assert np.array_equal(plan.inv_bra.numpy(), np.asarray(pj.inv_bra))
        assert len(plan.groups) == len(pj.groups)
        for gt, gj in zip(plan.groups, pj.groups):
            assert gt.blocks.shape[0] % pad == 0
            assert np.array_equal(gt.blocks.numpy(), np.asarray(gj.blocks))
            assert np.array_equal(gt.perm_ket.numpy(),
                                  np.asarray(gj.perm_ket))
    for gt, gi in zip(pt.groups, pi.groups):
        assert torch.equal(gt.bra_of_row, gi.bra_of_row)
    # a padded sector is all zero blocks and all-(−1) rows
    for g in pt.groups:
        dead = (g.bra_of_row < 0).all(dim=1)
        assert bool((g.blocks[dead] == 0).all())

    T = torch.as_tensor(np.random.default_rng(pad).standard_normal(
        (NO, NO, ut.n_spatial - NO, ut.n_spatial - NO)))
    unpadded = tladder.build_block_ladder(ut, "cpu", bra=bra)
    assert torch.equal(tladder.block_ladder_apply_ij(pt, T),
                       tladder.block_ladder_apply_ij(unpadded, T))


@pytest.mark.parametrize("bra", ["virtual", "all"])
@pytest.mark.parametrize("pad", [4, 8])
def test_sharded_apply_bit_equal_and_matches_jax(pad, bra):
    uj, ut = _models()
    nv = ut.n_spatial - NO
    rng = np.random.default_rng(10 + pad)
    T = rng.standard_normal((NO, NO, nv, nv))
    Tb = rng.standard_normal((2, nv, nv, NO, NO))
    plan = tladder.build_block_ladder(ut, "cpu", bra=bra, pad_sectors=pad)
    sh = tladder.shard_block_ladder(plan, _cpu_mesh(pad))
    assert len(sh.shards) == pad
    # every live bra row belongs to exactly one shard
    rows = torch.cat(sh.rows)
    assert len(rows) == len(torch.unique(rows))
    want = tladder.block_ladder_apply_ij(plan, torch.as_tensor(T))
    got = tladder.block_ladder_apply_ij(sh, torch.as_tensor(T))
    assert torch.equal(got, want)
    assert torch.equal(tladder.block_ladder_apply(sh, torch.as_tensor(Tb)),
                       tladder.block_ladder_apply(plan, torch.as_tensor(Tb)))

    mj = JMesh(np.array(jax.devices()[:pad]), ("s",))
    pj = jladder.shard_block_ladder(
        jladder.build_block_ladder(uj, bra=bra, preslice=None,
                                   pad_sectors=pad), mj, axis="s")
    ref = np.asarray(jax.jit(jladder.block_ladder_apply_ij)(pj,
                                                            jnp.asarray(T)))
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


def test_shard_block_ladder_needs_a_padded_plan():
    _, ut = _models()
    plan = tladder.build_block_ladder(ut, "cpu")
    with pytest.raises(ValueError):
        tladder.shard_block_ladder(plan, _cpu_mesh(8))


def test_sharded_mf_ccsd_noncanonical_matches_jax():
    """Matrix-free CCSD with T1 ≠ 0 (seeded non-canonical Fock) on the
    sector-sharded all-bra plan: against JAX's sharded solve and the
    port's unsharded one."""
    uj, ut = _models()
    V = ut.eval_2b_integrals()
    fock = np.asarray(jhf.construct_hf_matrix(
        NO, np.diag(uj.kinetic_energies()), V))
    noise = np.random.default_rng(5).standard_normal(fock.shape) * 0.02
    fock = fock + noise + noise.T
    kw = dict(delta_e=1e-10, max_iter=100, level_shift=-0.5)
    drop = ("abcd", "iabc", "aibc", "abic")

    mj = JMesh(np.array(jax.devices()[:8]), ("s",))
    pj = jladder.shard_block_ladder(
        jladder.build_block_ladder(uj, bra="all", preslice=None,
                                   pad_sectors=8), mj, axis="s")
    dj = {k: v for k, v in jpart(NO, jnp.asarray(V)).items()
          if k not in drop}
    dj["_ovvv_plans"] = jladder.build_ovvv_plans(uj)
    ref = jccsd.CCSD(NO).solve(jnp.asarray(fock), dj, ladder=pj,
                               contract_mode="xla", **kw)

    dt = {k: v for k, v in tpart(NO, torch.as_tensor(V)).items()
          if k not in drop}
    dt["_ovvv_plans"] = tladder.build_ovvv_plans(ut, "cpu")
    plan = tladder.build_block_ladder(ut, "cpu", bra="all", pad_sectors=8)
    sh = tladder.shard_block_ladder(plan, _cpu_mesh(8))
    res = tccsd.CCSD(NO, "cpu").solve(torch.as_tensor(fock), dt, ladder=sh,
                                      **kw)
    one = tccsd.CCSD(NO, "cpu").solve(
        torch.as_tensor(fock), dt,
        ladder=tladder.build_block_ladder(ut, "cpu", bra="all"), **kw)
    assert float(res["t1"].abs().max()) > 1e-4
    assert abs(res["ccsd e"] - ref["ccsd e"]) <= 1e-10
    assert abs(res["ccsd e"] - one["ccsd e"]) <= 1e-10
    assert len(res["e history"]) == len(one["e history"])


# ---- the node fan-out (parallel/sharding.py) -------------------------------

def _per_node(z, y):
    return (y * y).sum(-1) * z + torch.linalg.norm(y, dim=-1)


def test_shard_over_nodes_fan_out_matches_whole_and_jax():
    """Per-node work on node-sharded inputs equals the whole computation
    (``tests/test_parallel.py:154``) and the JAX package's."""
    m = tsharding.node_mesh(4, "cpu", devices=["cpu"] * 4)
    assert m.axis_names == ("n",) and m.shape == {"n": 4}
    rng = np.random.default_rng(0)
    ys, zs = rng.standard_normal((8, 64)), rng.standard_normal(8)
    odd = rng.standard_normal((6, 3))
    tree = tsharding.shard_over_nodes(
        {"z": zs, "y": torch.as_tensor(ys), "odd": odd, "s": 2.5,
         "pair": [torch.as_tensor(zs), (torch.ones(4),)]}, m, axis="n")
    got = torch.cat([_per_node(z, y) for z, y in
                     zip(tree["z"].shards, tree["y"].shards)])
    want = _per_node(torch.as_tensor(zs), torch.as_tensor(ys))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13)
    assert tree["y"].axis == 0
    assert [tuple(p.shape) for p in tree["y"].shards] == [(2, 64)] * 4
    assert tree["pair"][0].axis == 0 and tree["pair"][1][0].axis == 0
    # a leading dimension that does not divide the mesh, and a scalar,
    # are replicated: one tensor on the repeated device
    for leaf in (tree["odd"], tree["s"]):
        assert leaf.axis is None and len(leaf.shards) == 4
        assert all(p is leaf.shards[0] for p in leaf.shards)
    np.testing.assert_array_equal(tree["odd"].gather("cpu").numpy(), odd)
    assert float(tree["s"].shards[0]) == 2.5

    jm = _jax_mesh(4, "n")
    jt = jsharding.shard_over_nodes({"z": jnp.asarray(zs),
                                     "y": jnp.asarray(ys)}, jm, axis="n")
    jgot = jax.jit(jax.vmap(lambda z, y: jnp.sum(y * y) * z
                            + jnp.linalg.norm(y)))(jt["z"], jt["y"])
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-13)


def test_replicate_keeps_one_tensor_per_device():
    m = _cpu_mesh(3)
    x = torch.arange(6.0)
    plan = tladder.OVVVPlan(S=torch.zeros(2, dtype=torch.int32), W=x)
    tree = tsharding.replicate({"x": x, "plan": plan, "n": 3, "none": None},
                               m)
    assert tree["n"] == 3 and tree["none"] is None
    for leaf in (tree["x"], tree["plan"].W):
        assert leaf.axis is None
        assert all(p is x for p in leaf.shards)
    assert isinstance(tree["plan"], tladder.OVVVPlan)
    # a copy onto another device is made once for a repeated device
    meta = tmesh.Mesh([torch.device("meta")] * 3)
    r = tsharding.replicate({"x": x}, meta)["x"]
    assert r.shards[0].device.type == "meta"
    assert all(p is r.shards[0] for p in r.shards)


def test_node_mesh_takes_only_visible_devices():
    with pytest.raises(RuntimeError):
        tsharding.node_mesh(2, "cpu")
    assert tsharding.node_mesh(None, "cpu").shape == {"n": 1}
    assert tsharding.node_mesh(None, "cpu", axis="a",
                               devices=["cpu"] * 3).shape == {"a": 3}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tsharding.node_mesh(1, "cuda")
