"""The benchmark's files: every name in BENCHMARK.json resolves to its file,
the contract's rules on names, units and cells hold, and nothing under
portbench/ imports the JAX package or JAX."""

import ast
import importlib.util
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(path):
    spec = importlib.util.spec_from_file_location("m_" + path.stem.replace(
        ".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", BENCH["workloads"],
                         ids=lambda w: w["name"])
def test_cell_resolves(cell):
    configs = {c["name"]: c for c in BENCH["configs"]}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1
    assert len(cell["why"]) <= 200
    cfg = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    assert cfg["n_ele"] == 14 and cfg["rs"] == 0.5
    traffic = json.loads((HERE / "traffic" /
                          f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" /
                         f"{cell['name']}.json").read_text())
    assert (HERE / "kinds" / f"{traffic['kind']}.py").is_file()
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    assert set(limits) == set(kind.NUMBERS)
    assert 0 <= traffic["check"] <= len(traffic["twists"])
    e2e = {m["name"] for m in BENCH["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]}
    assert "setup_s" in e2e and len(e2e) >= 3
    assert any(cell["name"] in m["workloads"] for m in BENCH["per_layer"])


KIND_API = ("setup", "unit", "answers", "reference", "gaps", "control")


@pytest.mark.parametrize("path", sorted((HERE / "kinds").glob("[!_]*.py")),
                         ids=lambda p: p.stem)
def test_kind_defines_its_unit_and_check(path):
    """Every kind of unit is one file that defines what a unit is, its
    numbers, its reference and its control (``kinds/__init__.py``)."""
    kind = importlib.import_module(f"portbench.kinds.{path.stem}")
    assert kind.NUMBERS and all(NAME.match(n) for n in kind.NUMBERS)
    for name in KIND_API:
        assert callable(getattr(kind, name)), name


def test_configs_used_once_and_named():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["name"] in used and NAME.match(c["name"])
        assert c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).is_file()
        assert c["reduced"] == []
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metric_resolves(metric):
    """Each per-layer metric has its reader, and every cell it lists
    reports the end-to-end metric it moves."""
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert callable(load(HERE / "metrics" / f"{metric['name']}.py").read)
    ends = {m["name"]: m for m in BENCH["end_to_end"]}
    moved = ends[metric["moves"]]
    for cell in metric["workloads"]:
        assert "workloads" not in moved or cell in moved["workloads"]


def test_end_to_end_metrics():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["source"] == "host_clock"
        assert 0.01 <= m["bound"] <= 0.25
        assert callable(load(HERE / "metrics" / f"{m['name']}.py").read)
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import(path):
    """No module under portbench/ imports JAX or the JAX package (top-level
    names compared whole: the port's name begins with the JAX
    package's), and the reference imports nothing of the program."""
    tops = {name.split(".")[0] for name in imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "pymes_tpu"}
    if "reference" in path.parts:
        assert "pymes_tpu_torch" not in tops


@pytest.mark.parametrize(
    "path", [p for p in sorted((HERE / "metrics").glob("*.*.py"))
             if (p.parent / (p.name.split(".")[0] + ".py")).is_file()],
    ids=lambda p: p.stem)
def test_a_metric_read_as_another_takes_its_calls_too(path):
    """A reader that reads a metric as another reader does (``x.cell.py``
    beside ``x.py``) names the same program calls for the harness to hook,
    or it would find nothing to read."""
    base = load(path.parent / (path.name.split(".")[0] + ".py"))
    mod = load(path)
    for name in ("CALLS", "record", "read"):
        assert hasattr(mod, name) == hasattr(base, name), name
    assert getattr(mod, "CALLS", None) == getattr(base, "CALLS", None)
