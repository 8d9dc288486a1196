"""``eom_solve_ms``: the window's milliseconds over the Davidson solves it
completed, as ``solve_ms`` reads it, for the cells of the EOM solves."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench_metric_base_solve_ms", Path(__file__).with_name("solve_ms.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read
