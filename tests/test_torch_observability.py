"""The port's observability (``util/observability.py``): ``RunRecord``
writes the JAX package's JSON lines for the same solve result (a LiH CCD,
the port of ``tests/test_observability.py``), and ``profile`` traces a
solve on the CPU, writes a non-empty Chrome trace, and leaves no profiler
running when its block raises.
"""

import json
import os

import numpy as np
import pytest
import torch

from pymes_tpu.util.observability import RunRecord as JRunRecord
from pymes_tpu_torch.mean_field import hf
from pymes_tpu_torch.solver import ccd
from pymes_tpu_torch.util import fcidump
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
    res = ccd.CCD(no, "cpu").solve(fock, V)
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
    with profile(str(tmp_path / "prof"), "cpu") as prof:
        ccd.CCD(no, "cpu").solve(fock, V, max_iter=2)
    trace = tmp_path / "prof" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("einsum" in e.get("name", "") for e in events)
    assert sum(a.count for a in prof.key_averages()) > 0


def test_profile_stops_when_the_block_raises(tmp_path):
    os.chdir(REPO)  # an earlier test may leave the cwd deleted
    with pytest.raises(RuntimeError, match="inside"):
        with profile(str(tmp_path / "a"), "cpu"):
            torch.ones(3).sum()
            raise RuntimeError("inside")
    assert not (tmp_path / "a" / "trace.json").exists()
    assert not torch._C._autograd._profiler_enabled()
    # a second session starts, which a running one would refuse
    with profile(str(tmp_path / "b"), "cpu"):
        torch.ones(3).sum()
    assert (tmp_path / "b" / "trace.json").stat().st_size > 0
