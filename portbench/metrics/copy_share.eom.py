"""``copy_share.eom``: the elementwise and copy kernels' share of busy time,
as ``copy_share`` reads it, for the cells of the end-to-end metric it
moves."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench_metric_base_copy_share",
    Path(__file__).with_name("copy_share.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read
