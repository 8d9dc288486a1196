"""The port's observability (``util/observability.py``): ``RunRecord``
writes the JAX package's JSON lines for the same solve result (a LiH CCD,
the port of ``tests/test_observability.py``), and ``profile`` traces a
solve on the CPU, writes a non-empty Chrome trace, and leaves no profiler
running when its block raises.

The tracer: off, a solve records nothing and every ``span`` is one shared
object; on, the same solve gives bit-identical numbers and the spans of
its layers, nested under one root (LiH CCD and CCSD, a fake-Hamiltonian
EOM Davidson, a UEG nP=57 set-up); inside ``profile`` the spans land in the
Chrome trace on its clock; the cap counts what it drops; and the
benchmark's span readers (``portbench/metrics/``) read medians and sums of
a tracer filled on a scripted clock, and nothing from an empty one.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from pymes_tpu.util.observability import RunRecord as JRunRecord
from pymes_tpu_torch.mean_field import hf
from pymes_tpu_torch.models import ueg
from pymes_tpu_torch.ops import ueg_ladder
from pymes_tpu_torch.solver import ccd, ccsd, eom_ccsd
from pymes_tpu_torch.util import fcidump
from pymes_tpu_torch.util import observability as obs
from pymes_tpu_torch.util.observability import RunRecord, profile

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lih():
    n_elec, _, _, _, h, V = fcidump.read(
        os.path.join(DATA, "FCIDUMP.LiH.321g"))
    no = n_elec // 2
    h, V = torch.as_tensor(h), torch.as_tensor(V)
    return no, hf.construct_hf_matrix(no, h, V), V


def test_run_record_equal_to_jax(tmp_path):
    no, fock, V = _lih()
    res = ccd.CCD(no, device="cpu").solve(fock, V)
    rows = []
    for cls, name in ((RunRecord, "port"), (JRunRecord, "jax")):
        rec = cls(str(tmp_path / name / "runs.jsonl"))
        rec.log("ccd", system="LiH/3-21G", result=res, wall_s=1.23,
                device="cpu")
        rows.append(rec.read())
    (got,), (want,) = rows
    got.pop("time"), want.pop("time")
    assert got == want
    assert abs(got["ccd e"] - res["ccd e"]) < 1e-14
    assert got["iterations"] == len(res["e history"])
    assert abs(np.asarray(got["e_history"])[-1] - res["ccd e"]) < 1e-12


def test_profile_writes_a_trace(tmp_path):
    os.chdir(REPO)  # an earlier test may leave the cwd deleted
    no, fock, V = _lih()
    with profile(str(tmp_path / "prof"), device="cpu") as prof:
        ccd.CCD(no, device="cpu").solve(fock, V, max_iter=2)
    trace = tmp_path / "prof" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("einsum" in e.get("name", "") for e in events)
    assert sum(a.count for a in prof.key_averages()) > 0


def test_profile_stops_when_the_block_raises(tmp_path):
    os.chdir(REPO)  # an earlier test may leave the cwd deleted
    with pytest.raises(RuntimeError, match="inside"):
        with profile(str(tmp_path / "a"), device="cpu"):
            torch.ones(3).sum()
            raise RuntimeError("inside")
    assert not (tmp_path / "a" / "trace.json").exists()
    assert not torch._C._autograd._profiler_enabled()
    # a second session starts, which a running one would refuse
    with profile(str(tmp_path / "b"), device="cpu"):
        torch.ones(3).sum()
    assert (tmp_path / "b" / "trace.json").stat().st_size > 0


# --- the tracer ---------------------------------------------------------

@pytest.fixture
def tracer():
    """The tracer on and empty; off and empty after the test (the readers
    of ``portbench/metrics/`` turn it on when loaded)."""
    obs.clear()
    obs.enable()
    try:
        yield obs
    finally:
        obs.disable()
        obs.clear()


def _children(records):
    out = {}
    for r in records:
        out.setdefault(r.parent, []).append(r)
    return out


def _self_times_nonnegative():
    assert obs.dropped == 0
    for name, row in obs.summary().items():
        assert row["self_ns"] >= 0, name
        assert row["total_ns"] >= row["self_ns"], name


def test_tracer_off_records_nothing():
    obs.disable()
    obs.clear()
    no, fock, V = _lih()
    ccd.CCD(no, device="cpu").solve(fock, V)
    assert obs.spans() == [] and obs.summary() == {}
    assert obs.span("cc.iter") is obs.span("eom.sigma")
    with obs.span("cc.iter") as s:
        assert s is obs.span("x")
    assert obs.spans() == []


@pytest.mark.parametrize("method", ["ccd", "ccsd"])
def test_traced_cc_identical_and_nested(method, tracer):
    no, fock, V = _lih()
    solver = {"ccd": ccd.CCD, "ccsd": ccsd.CCSD}[method]
    obs.disable()
    plain = solver(no, device="cpu").solve(fock, V)
    obs.enable()
    res = solver(no, device="cpu").solve(fock, V)
    assert res.keys() == plain.keys()
    for key, got in res.items():
        if isinstance(got, torch.Tensor):
            assert torch.equal(got, plain[key]), key
        else:
            assert np.array_equal(got, plain[key]), key

    records = obs.spans()
    roots = [r for r in records if r.parent is None]
    assert [r.name for r in roots] == ["cc.solve"]
    root = roots[0].id
    assert all(r.root == root for r in records)
    by_name = {}
    for r in records:
        by_name.setdefault(r.name, []).append(r)
    n = len(res["e history"])
    assert len(by_name["cc.iter"]) == n
    assert len(by_name["cc.wait"]) == n + 1
    assert len(by_name["cc.guess"]) == 1
    kids = _children(records)
    for it in by_name["cc.iter"]:
        assert it.parent == root
        assert sorted(c.name for c in kids[it.id]) == ["cc.residual",
                                                      "cc.tail"]
        assert all(c.root == root for c in kids[it.id])
    for r in records:
        assert r.t1_ns >= r.t0_ns
    _self_times_nonnegative()


class _MatrixEOM(eom_ccsd.EOM_CCSD):
    """EOM on a fixed matrix: the ``_batched_sigma`` hook and the diagonal
    read it (the fake Hamiltonian of ``tests/test_torch_eom_davidson.py``)."""

    def __init__(self, no, n_excit, ham):
        super().__init__(no, n_excit=n_excit, device="cpu")
        self.ham = ham

    def _batched_sigma(self, f, dict_t_V, U1, U2, T2):
        m, nv = U1.shape[0], U1.shape[1]
        U = np.concatenate([U1.reshape(m, -1).numpy(),
                            U2.reshape(m, -1).numpy()], axis=1)
        Wp = U @ self.ham.T
        return (Wp[:, :nv * self.no].reshape(m, nv, self.no),
                Wp[:, nv * self.no:].reshape(m, nv, nv, self.no, self.no))

    def get_diag_singles(self, f, dict_t_V, T2):
        nv = T2.shape[0]
        return self.ham.diagonal()[:nv * self.no].reshape(nv, self.no)

    def get_diag_doubles(self, f, dict_t_V, T2):
        nv = T2.shape[0]
        return self.ham.diagonal()[nv * self.no:].reshape(
            nv, nv, self.no, self.no)


def test_traced_eom_davidson(tracer):
    """The fixed-shape Davidson on a random symmetric 30×30 H̄ (no = 1,
    nv = 5): one ``eom.iter`` an iteration, each holding its
    ``eom.subspace``, and, but for the converging one, one ``eom.sigma``
    and one ``eom.wait``; the same roots as untraced."""
    rng = np.random.default_rng(7)
    no, nv = 1, 5
    dim = nv * no + nv * nv * no * no
    ham = np.diag(np.arange(dim) * 0.3) + rng.random((dim, dim)) - 0.5
    ham = (ham + ham.T) / 2
    fock = torch.as_tensor(np.diag(np.concatenate([[0.0],
                                                   ham.diagonal()[:nv]])))
    T2 = torch.zeros((nv, nv, no, no), dtype=torch.float64)
    V = {"ijab": torch.zeros((no, no, nv, nv), dtype=torch.float64)}

    def run():
        s = _MatrixEOM(no, 2, ham)
        s.max_iter = 1000
        return np.asarray(s.solve(fock, V, T2)), s.n_iterations

    obs.disable()
    plain, n_plain = run()
    obs.enable()
    roots, n_it = run()
    assert np.array_equal(roots, plain) and n_it == n_plain

    records = obs.spans()
    top = [r for r in records if r.parent is None]
    assert [r.name for r in top] == ["eom.solve"]
    assert all(r.root == top[0].id for r in records)
    iters = sorted((r for r in records if r.name == "eom.iter"),
                   key=lambda r: r.t0_ns)
    assert len(iters) == n_it > 2
    kids = _children(records)
    for k, it in enumerate(iters):
        names = sorted(c.name for c in kids[it.id])
        if k == len(iters) - 1:
            assert names == ["eom.subspace"]
        else:
            assert names == ["eom.sigma", "eom.subspace", "eom.wait"]
    assert {r.name for r in records} == {"eom.solve", "eom.hbar", "eom.iter",
                                         "eom.subspace", "eom.sigma",
                                         "eom.wait"}
    _self_times_nonnegative()


def test_traced_ueg_setup(tracer):
    """A UEG nP=57 set-up on the CPU: one span for each of the integrals,
    the blocks, the ladder plan and the gather plans, none inside
    another."""
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(5)
    idx, vals = u.eval_2b_integrals(sp=2)
    assert u.n_spatial == 57
    ueg.sparse_to_blocks(idx, vals, u.n_spatial, 7, device="cpu",
                         names=("klij", "ijab", "abij"))
    ueg_ladder.build_block_ladder(u, device="cpu")
    ueg_ladder.build_ovvv_plans(u, device="cpu")
    records = obs.spans()
    assert [r.name for r in records] == ["ueg.integrals", "ueg.blocks",
                                         "ladder.plan", "ovvv.plan"]
    assert all(r.parent is None and r.root == r.id for r in records)
    _self_times_nonnegative()


def test_spans_land_in_the_profilers_trace(tracer, tmp_path):
    """Inside ``profile`` each ``cc.iter`` is a ``user_annotation`` of the
    Chrome trace, and ``epoch_ns`` puts the span's start within 1 ms of
    the annotation's (``ts`` µs × 1000 + ``baseTimeNanoseconds``)."""
    os.chdir(REPO)  # an earlier test may leave the cwd deleted
    no, fock, V = _lih()
    with profile(str(tmp_path / "prof"), device="cpu"):
        res = ccd.CCD(no, device="cpu").solve(fock, V, max_iter=3)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    marks = sorted(float(e["ts"]) * 1000 + trace["baseTimeNanoseconds"]
                   for e in trace["traceEvents"]
                   if e.get("cat") == "user_annotation"
                   and e.get("name") == "cc.iter")
    iters = sorted(r.t0_ns for r in obs.spans() if r.name == "cc.iter")
    assert len(marks) == len(iters) == len(res["e history"]) > 0
    for mark, t0 in zip(marks, iters):
        assert abs(mark - obs.epoch_ns(t0)) < 1e6


def test_cap_counts_what_it_drops(tracer, monkeypatch):
    monkeypatch.setattr(obs, "CAP", 3)
    for _ in range(5):
        with obs.span("s"):
            pass
    assert len(obs.spans()) == 3 and obs.dropped == 2
    obs.clear()
    assert obs.spans() == [] and obs.dropped == 0


def _fill(clock, spans):
    """Close the (name, own ms, children) spans on a scripted clock."""
    for name, ms, inner in spans:
        with obs.span(name):
            _fill(clock, inner)
            clock[0] += round(ms * 1e6)


# what each reader reads from one filled tracer: loop metrics a median of
# durations (children included), set-up metrics a sum of self seconds
FILLED = [("cc.iter", 1.0, [("cc.residual", 0.5, []), ("cc.tail", 0.5, [])]),
          ("cc.iter", 4.0, []), ("cc.iter", 3.0, []),
          ("cc.wait", 7.0, []), ("cc.wait", 9.0, []),
          ("eom.iter", 0.0, [("eom.subspace", 2.0, []),
                             ("eom.sigma", 5.0, []), ("eom.wait", 3.0, [])]),
          ("eom.iter", 0.0, [("eom.subspace", 6.0, []),
                             ("eom.sigma", 1.0, []), ("eom.wait", 11.0, [])]),
          ("eom.iter", 0.0, [("eom.subspace", 4.0, [])]),
          ("ueg.integrals", 1000.0, []), ("ueg.integrals", 500.0, []),
          ("ueg.blocks", 200.0, [("kernels.build", 3000.0, [])]),
          ("ueg.blocks", 100.0, []),
          ("ladder.plan", 250.0, []), ("ovvv.plan", 125.0, []),
          ("ladder.plan", 250.0, [])]
READERS = {"cc_issue_ms": 3.0, "cc_wait_ms": 8.0, "davidson_host_ms": 4.0,
           "davidson_wait_ms": 7.0, "sigma_issue_ms": 3.0,
           "setup_integrals_s": 1.5, "setup_blocks_s": 0.3,
           "setup_plans_s": 0.625, "kernel_build_s": 3.0}


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_reader(name, tracer, monkeypatch):
    path = os.path.join(REPO, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    assert obs._on, "loading a span reader turns the tracer on"
    assert reader.read({}) is None
    clock = [10 ** 9]
    monkeypatch.setattr(obs, "_clock", lambda: clock[0])
    _fill(clock, FILLED)
    assert reader.read({}) == pytest.approx(READERS[name], rel=1e-12)
