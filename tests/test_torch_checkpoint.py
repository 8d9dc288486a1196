"""The port's checkpoint/resume (``util/checkpoint.py``) against the JAX
package's: the same ``.npz`` + ``.json`` pair in both directions, the DIIS
ring restored as the port's state, the port of ``tests/test_checkpoint.py``
(a converged LiH CCD saved, loaded and warm-started), and a seeded
matrix-free CCSD at nP=57 stopped after 3 iterations, checkpointed by one
package and resumed by the other.

Tolerances: arrays and metadata exactly; the DIIS Gram matrix 1e-12
relative (a product in another summation order); the resumed trajectories
1e-10 per iteration against the JAX package's, and the resumed energy
1e-9 from the uninterrupted solve's (the resume restarts DIIS).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pymes_tpu.models import ueg as jueg
from pymes_tpu.ops import ueg_ladder as jladder
from pymes_tpu.solver import ccsd as jccsd
from pymes_tpu.util import checkpoint as jcheckpoint
from pymes_tpu_torch.mean_field import hf
from pymes_tpu_torch.models import ueg
from pymes_tpu_torch.ops import ueg_ladder
from pymes_tpu_torch.solver import ccd, ccsd
from pymes_tpu_torch.util import checkpoint, fcidump

DATA = os.path.join(os.path.dirname(__file__), "data")
NO = 7
NEED = ("klij", "ijab", "abij", "iajb", "iabj", "aibj", "aijb", "ijka",
        "ijak", "iajk")


def _full(mod):
    rng = np.random.default_rng(3)
    return mod.SolverCheckpoint(
        t2=rng.standard_normal((3, 3, 2, 2)), t1=rng.standard_normal((3, 2)),
        diis_amps=rng.standard_normal((4, 42)),
        diis_errs=rng.standard_normal((4, 42)), diis_count=7,
        energy=-0.123456789012345, iteration=9,
        meta={"system": "UEG", "nP": 57})


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_files_load_across_packages(direction, tmp_path):
    writer, reader = ((jcheckpoint, checkpoint) if direction == "jax_to_port"
                      else (checkpoint, jcheckpoint))
    ck = _full(writer)
    writer.save(str(tmp_path / "ck"), ck)
    back = reader.load(str(tmp_path / "ck.npz"))
    for f in ("t2", "t1", "diis_amps", "diis_errs"):
        assert np.array_equal(getattr(back, f), getattr(ck, f)), f
    for f in ("diis_count", "energy", "iteration", "meta"):
        assert getattr(back, f) == getattr(ck, f), f
    assert np.array_equal(back.amps[0], ck.t1)


def test_diis_state_equal():
    ck = _full(checkpoint)
    st = ck.diis_state(device="cpu")
    ref = jcheckpoint.SolverCheckpoint(**vars(ck)).diis_state()
    assert st.count == 7 and isinstance(st.count, int)
    assert st.amps.dtype == torch.float64
    assert np.array_equal(st.amps.numpy(), np.asarray(ref.amps))
    assert np.array_equal(st.errs.numpy(), np.asarray(ref.errs))
    B, Bj = st.B.numpy(), np.asarray(ref.B)
    assert np.abs(B - Bj).max() <= 1e-12 * np.abs(Bj).max()
    # the restored Gram matrix is the ring's errs·errsᵀ, bit for bit
    errs = torch.as_tensor(ck.diis_errs)
    assert torch.equal(st.B, errs @ errs.T)
    assert checkpoint.SolverCheckpoint(t2=ck.t2).diis_state(
        device="cpu") is None


def test_checkpoint_roundtrip_and_warm_start(tmp_path):
    """The port of ``tests/test_checkpoint.py``: a converged LiH CCD saved
    and loaded; the warm start converges to the same energy."""
    n_elec, _, _, _, h, V = fcidump.read(
        os.path.join(DATA, "FCIDUMP.LiH.321g"))
    no = n_elec // 2
    h, V = torch.as_tensor(h), torch.as_tensor(V)
    fock = hf.construct_hf_matrix(no, h, V)
    res = ccd.CCD(no, device="cpu").solve(fock, V)
    ck = checkpoint.from_result(res, meta={"system": "LiH"})
    assert isinstance(ck.t2, np.ndarray)
    checkpoint.save(str(tmp_path / "ccd_ckpt"), ck)

    ck2 = checkpoint.load(str(tmp_path / "ccd_ckpt"))
    assert np.array_equal(ck2.t2, res["t2 amp"].numpy())
    assert ck2.meta["system"] == "LiH"
    assert abs(ck2.energy - res["ccd e"]) < 1e-14
    res2 = ccd.CCD(no, device="cpu").solve(fock, V, amps=ck2.amps)
    assert abs(res2["ccd e"] - res["ccd e"]) < 5e-8
    assert len(res2["e history"]) < len(res["e history"])


def _port_problem():
    u = ueg.UEG(14, NO, NO, 0.5)
    u.init_single_basis(5)
    idx, vals = u.eval_2b_integrals(sp=2)
    n_p = u.n_spatial
    d = ueg.sparse_to_blocks(idx, vals, n_p, NO, device="cpu", names=NEED)
    kin = u.kinetic_energies()
    eps = torch.cat([hf.calcOccupiedOrbE(kin, d["klij"], NO),
                     hf.calcVirtualOrbE(kin, d["aibj"], d["aijb"], NO,
                                        n_p - NO)]).numpy()
    noise = np.random.default_rng(5).standard_normal((n_p, n_p)) * 0.02
    fock = np.diag(eps) + noise + noise.T
    d["_ovvv_plans"] = ueg_ladder.build_ovvv_plans(u, device="cpu")
    return (torch.as_tensor(fock), d,
            ueg_ladder.build_block_ladder(u, device="cpu", bra="all"))


def _jax_problem(fock, d_port):
    u = jueg.UEG(14, NO, NO, 0.5)
    u.init_single_basis(5)
    d = {k: jnp.asarray(v.numpy()) for k, v in d_port.items()
         if not k.startswith("_")}
    d["_ovvv_plans"] = jladder.build_ovvv_plans(u)
    return (jnp.asarray(fock.numpy()), d,
            jladder.build_block_ladder(u, bra="all", preslice=None))


def test_mf_ccsd_resume_across_packages(tmp_path):
    """nP=57, the seeded non-canonical Fock: 3 iterations, a checkpoint,
    then the resume to |dE| < 1e-10, each package resuming the other's
    checkpoint; the resumed trajectories agree per iteration."""
    kw = dict(level_shift=-1.0, delta_e=1e-10)
    fock, d, plan = _port_problem()
    jfock, jd, jplan = _jax_problem(fock, d)
    full = ccsd.CCSD(NO, device="cpu").solve(fock, d, ladder=plan,
                                             max_iter=100,
                                             **kw)
    assert float(full["t1"].abs().max()) > 1e-3

    part = ccsd.CCSD(NO, device="cpu").solve(fock, d, ladder=plan, max_iter=2,
                                             **kw)
    jpart = jccsd.CCSD(NO).solve(jfock, jd, ladder=jplan, max_iter=2,
                                 contract_mode="xla", **kw)
    assert len(part["e history"]) == len(jpart["e history"]) == 3
    checkpoint.save(str(tmp_path / "port"), checkpoint.from_result(part))
    jcheckpoint.save(str(tmp_path / "jax"), jcheckpoint.from_result(jpart))

    ck = checkpoint.load(str(tmp_path / "jax"))
    res = ccsd.CCSD(NO, device="cpu").solve(fock, d, ladder=plan, max_iter=100,
                                            amps=ck.amps, **kw)
    jck = jcheckpoint.load(str(tmp_path / "port"))
    ref = jccsd.CCSD(NO).solve(jfock, jd, ladder=jplan, max_iter=100,
                               amps=jck.amps, contract_mode="xla", **kw)
    hist, hist_j = res["e history"], np.asarray(ref["e history"])
    assert len(hist) == len(hist_j)
    assert np.abs(hist - hist_j).max() <= 1e-10
    assert abs(res["ccsd e"] - full["ccsd e"]) <= 1e-9
