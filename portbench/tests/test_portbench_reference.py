"""The yardstick on the CPU at small sizes: the fixed-count twisted basis,
the seed's twist, the plain reference against the port (nP=57 at a
twist), and the frozen K1 counts by hand."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import common
from portbench.kinds import ccd, eom as eom_kind
from portbench.reference import cc, eom, ueg

HERE = Path(__file__).resolve().parents[1]
TWIST = (0.0831, 0.1524, 0.2107)


def load(name):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("n_p", (57, 123, 389))
def test_fixed_count_basis(seed, n_p):
    """The program's basis at the fixed cutoff of a seeded twist has
    exactly n_p plane waves, in the reference's order."""
    from pymes_tpu_torch.basis_set import planewave

    tw = np.random.default_rng(seed).uniform(-0.5, 0.5, 3)
    basis = planewave.build_basis(common.fixed_cutoff(n_p, tw), 1.0, tw)
    assert basis.n_spatial == n_p
    assert np.array_equal(basis.k_int, ueg.sorted_waves(tw, n_p)[0][:n_p])


@pytest.mark.parametrize("cutoff,n_p", ((5, 57), (9, 123), (20, 389)))
def test_gamma_closed_shells(cutoff, n_p):
    from pymes_tpu_torch.basis_set import planewave

    assert planewave.build_basis(cutoff, 1.0).n_spatial == n_p
    assert common.fixed_cutoff(n_p, (0, 0, 0)) == cutoff + 0.5


def test_traffic_twists_keep_their_counts():
    for path in (HERE / "traffic").glob("*.json"):
        tr = json.loads(path.read_text())
        for tw in tr["twists"]:
            for n_p in (57, 389):
                common.fixed_cutoff(n_p, tw)


@pytest.fixture(scope="module")
def port57():
    """The port's set-up of nP=57 at TWIST on the CPU."""
    from pymes_tpu_torch.ops import ueg_ladder

    cfg = {"n_ele": 14, "rs": 0.5, "n_p": 57}
    g = common.gas(cfg, TWIST, eom_kind.NAMES, "cpu", common.Spans(),
                   plans=("virtual", "all"))
    g["blocks"] = ccd.blocks(g)
    g["all_dict"] = {k: g["dict"][k] for k in eom_kind.OPERATOR}
    g["plans"] = ueg_ladder.build_ovvv_plans(g["ueg"], device="cpu")
    return g


@pytest.fixture(scope="module")
def ref57():
    gas = ueg.Gas(14, 0.5, 57, TWIST, "cpu")
    return cc.Problem(gas, eom.EOM_BLOCKS)


def test_reference_blocks_and_orbitals(port57, ref57):
    eps = port57["fock"].diagonal()
    assert torch.allclose(eps, torch.cat([ref57.eps_i, ref57.eps_a]),
                          rtol=0, atol=1e-12)
    for name in eom_kind.OPERATOR:
        assert torch.allclose(port57["dict"][name], ref57.V[name], rtol=0,
                              atol=1e-14), name


def test_reference_ladder(port57, ref57):
    from pymes_tpu_torch.ops import ueg_ladder

    T = torch.randn(7, 7, 50, 50, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    got = ueg_ladder.ladder_apply_ij(port57["plan_virtual"], T)
    want = ueg.ladder(ref57.ladder, T.permute(2, 3, 0, 1)).permute(2, 3, 0,
                                                                  1)
    assert torch.allclose(got, want, rtol=0, atol=1e-13)


def test_reference_ccd_and_eom_agree_with_the_port(port57, ref57):
    traffic = {"delta_e": 1e-11, "level_shift": -1.0, "max_iter": 100,
               "n_excit": 2, "max_dim": 16, "e_epsilon": 1e-11,
               "eom_max_iter": 300}
    e, T, n, ok = ccd.ground(port57, traffic, "cpu")
    e_ref, T_ref, _ = cc.solve(ref57)
    assert ok and abs(e - e_ref) < 1e-10
    assert float((T - T_ref).abs().max()) < 1e-8 * float(T_ref.abs().max())
    V = dict(port57["all_dict"], abcd=None, abcd_ladder=port57["plan_all"],
             _ovvv_plans=port57["plans"])
    s = eom_kind.solver(7, "cpu", traffic)
    roots = np.sort(np.real(s.solve(port57["fock"], V, T)))
    h = eom.Hbar(ref57, T_ref)
    roots_ref, _, _ = eom.davidson(h, 2)
    assert np.max(np.abs(roots - roots_ref)) < 1e-9


def test_k1_sectors_by_hand():
    """Three plane waves (0, ±x), one occupied: the virtual kets (x, x),
    (x, −x), (−x, x), (−x, −x) make sectors K = 2x, 0, −2x of 1, 2, 1
    pairs; the virtual bras the same (1 + 4 + 1 = 6 elements), all bras
    add (0, 0) to K = 0 (1 + 3·2 + 1 = 8)."""
    k1 = load("k1_roofline")
    k = np.array([[0, 0, 0], [1, 0, 0], [-1, 0, 0]])
    assert k1.sector_elements(k, 1, False) == 6
    assert k1.sector_elements(k, 1, True) == 8
    call = {"n_out": 4, "n": 1, "elem": 8}
    # operand 4·1, output 4·1, sectors 6: 14 doubles; 12 flops
    want = max(8 * 14 / 3.35e12, 12 / 67e12)
    assert k1.least_seconds(call, {"k_int": k, "no": 1}) == want


def test_k1_sectors_match_the_plan(port57):
    """At nP=57 the count equals the program's plans without their padding:
    a sector's ket ids rise until its zero padding, its valid bra rows
    have ``bra_of_row`` ≥ 0."""
    k1 = load("k1_roofline")
    for bra, plan in (("virtual", port57["plan_virtual"]),
                      ("all", port57["plan_all"])):
        true = 0
        for g in plan.groups:
            for t in range(g.perm_ket.shape[0]):
                p = g.perm_ket[t].long()
                rise = (p[1:] > p[:-1]).tolist() + [False]
                nk = 1 + rise.index(False)
                true += nk * int((g.bra_of_row[t] >= 0).sum())
        assert k1.sector_elements(port57["k_int"], 7, bra == "all") == true


@pytest.mark.parametrize("n_p", (57, 389))
def test_seed_twist(n_p):
    """A seed draws one twist, the same every time, of exactly n_p plane
    waves; seeds past 32 bits work; different seeds draw different
    twists."""
    seeds = (1, 2, 2**31 + 7, 4_000_000_017)
    tws = [common.twist_of(s, n_p) for s in seeds]
    assert tws == [common.twist_of(s, n_p) for s in seeds]
    assert len({tuple(t) for t in tws}) == len(seeds)
    for tw in tws:
        assert all(0.0 <= x < 0.25 for x in tw)
        assert len(ueg.sorted_waves(tw, n_p)[0]) == n_p + 1
        common.fixed_cutoff(n_p, tw)


def test_orbitals_of_one_energy_in_either_order():
    """At the twist (0.05, 0.05, 0.2) plane waves mirrored in x and y have
    one kinetic energy and the program orders them otherwise than the
    reference: the check matches orbitals by wave vector."""
    from portbench import run

    tw = (0.05, 0.05, 0.2)
    from pymes_tpu_torch.basis_set import planewave

    b = planewave.build_basis(common.fixed_cutoff(57, tw), 1.94, tw)
    assert not np.array_equal(b.k_int, ueg.sorted_waves(tw, 57)[0][:57])
    traffic = {"kind": "ccd", "twists": [list(tw)], "delta_e": 1e-8,
               "level_shift": -1.0, "max_iter": 60, "check": 1}
    limits = json.loads((HERE / "limits" / "np389.ccd.json").read_text())
    line, rows = run.execute("np389.ccd", {"n_ele": 14, "rs": 0.5,
                                           "n_p": 57}, traffic, limits, [],
                             3, 0.0, 0, device="cpu")
    assert line["correct"], rows
