"""The check at a size a CPU holds (nP=57, one fixed twist and the seed's,
the cells' own limits): a sound run is correct, the control (the reference
in float32) fails the limits, and a run with its timed path broken
underneath is not correct, once for each fault its cell can have (a step
that returns its state unchanged, half of a batch left out, an answer
altered where it is produced; one card, so no exchange between cards).
The look for a card is skipped: the rest of the run is ``run.execute`` on
the CPU twins."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import importlib

from portbench import check, run

HERE = Path(__file__).resolve().parents[1]
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in BENCH["workloads"]}
CFG = {"n_ele": 14, "rs": 0.5, "n_p": 57}


def inputs(cell):
    traffic = json.loads((HERE / "traffic" /
                          f"{CELLS[cell]['traffic']}.json").read_text())
    traffic = dict(traffic, twists=traffic["twists"][:1], check=1)
    limits = json.loads((HERE / "limits" / f"{cell}.json").read_text())
    return traffic, limits


def correct(cell, **changes):
    traffic, limits = inputs(cell)
    line, _ = run.execute(cell, CFG, dict(traffic, **changes), limits, [],
                          7, 0.0, 0, device="cpu")
    return line["correct"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    assert correct(cell)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails(cell):
    traffic, limits = inputs(cell)
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    numbers = kind.control(CFG, traffic, traffic["twists"][0], "cpu")
    assert not check.judge(numbers, limits)[0], numbers


def residual_unchanged(monkeypatch):
    """The CC step returns its amplitudes unchanged (a zero residual)."""
    from pymes_tpu_torch.solver import ccd

    monkeypatch.setattr(ccd, "doubles_residual_ij",
                        lambda f_ab, f_ij, T, *a, **k: torch.zeros_like(T))


def energy_altered(monkeypatch):
    """The CCD energy altered by 1e-6 Ha where the tail produces it."""
    from pymes_tpu_torch.kernels import ccd_tail

    orig = ccd_tail.diis_mix_energy

    def altered(*a, **k):
        e_dir, e_exc = orig(*a, **k)
        return e_dir + 1e-6, e_exc

    monkeypatch.setattr(ccd_tail, "diis_mix_energy", altered)


def sigma_half_batch(monkeypatch):
    """The EOM sigma leaves out the second half of its batch of trial
    vectors."""
    from pymes_tpu_torch.solver import eom_ccsd

    orig = eom_ccsd._sigma_batched_hbar

    def half(*a, **k):
        W1, W2 = orig(*a, **k)
        k_ = W1.shape[0]
        W1, W2 = W1.clone(), W2.clone()
        W1[k_ - k_ // 2:] = 0
        W2[k_ - k_ // 2:] = 0
        return W1, W2

    monkeypatch.setattr(eom_ccsd, "_sigma_batched_hbar", half)


def roots_altered(monkeypatch):
    """The Davidson roots altered by 1e-6 Ha where the solve returns
    them."""
    from pymes_tpu_torch.solver import eom_ccsd

    orig = eom_ccsd.EOM_CCSD._finish

    def altered(self, *a, **k):
        return np.asarray(orig(self, *a, **k)) + 1e-6

    monkeypatch.setattr(eom_ccsd.EOM_CCSD, "_finish", altered)


def sigma_unchanged(monkeypatch):
    """The EOM sigma returns its trial vectors unchanged."""
    from pymes_tpu_torch.solver import eom_ccsd

    def unchanged(f, V, hb, U1, U2, T, *a, **k):
        return U1.clone(), U2.clone()

    monkeypatch.setattr(eom_ccsd, "_sigma_batched_hbar", unchanged)


FAULTS = [("np389.ccd", residual_unchanged), ("np389.ccd", energy_altered),
          ("np389.eom", sigma_unchanged), ("np389.eom", sigma_half_batch),
          ("np389.eom", roots_altered)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert not correct(cell)


@pytest.mark.parametrize("cell,fault", [FAULTS[1], FAULTS[4]],
                         ids=lambda x: getattr(x, "__name__", x))
def test_the_seed_twist_is_always_checked(cell, fault, monkeypatch):
    """With no fixed twist sampled, the seed's own twist still is."""
    fault(monkeypatch)
    assert correct(cell, check=0) is False


@pytest.mark.cuda
def test_sound_run_on_the_card():
    """The np389.ccd cell's path at nP=57 on the card, with its limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    traffic, limits = inputs("np389.ccd")
    line, _ = run.execute("np389.ccd", CFG, traffic, limits, [], 7, 1.0, 0,
                          device="cuda")
    assert line["correct"] and line["device"]["platform"] == "gpu"


@pytest.mark.parametrize("bad", (float("nan"), float("inf")))
def test_a_number_that_is_not_finite_is_not_correct(bad):
    """A NaN anywhere in a gap's list wins over finite values, and the
    row carries null (JSON has no NaN)."""
    numbers = {"e_gap": check.worst([0.0, bad, 1e-12]), "eps_gap": 0.0}
    ok, rows = check.judge(numbers, {"e_gap": 1.0, "eps_gap": 1.0})
    assert not ok and rows["e_gap"]["value"] is None
    assert np.isnan(check.worst([0.0, float("nan"), 1.0]))
