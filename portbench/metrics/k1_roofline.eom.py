"""``k1_roofline.eom``: K1's share of its least time, as ``k1_roofline`` reads
it (on the calls of K1's entry it names), for the cells of the end-to-end
metric it moves."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench_metric_base_k1_roofline",
    Path(__file__).with_name("k1_roofline.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
CALLS, record, read = _base.CALLS, _base.record, _base.read
