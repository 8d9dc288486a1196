"""``device_idle.eom``: the device's idle share of the profiled session, as
``device_idle.solve`` reads it, for the cells of the end-to-end metric it
moves."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench_metric_base_device_idle_solve",
    Path(__file__).with_name("device_idle.solve.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read
