"""``setup_plans_s``: the set-up's seconds in the ladder and gather plans
(``build_block_ladder``, ``build_ovvv_plans``): the self time of every
``ladder.plan`` and ``ovvv.plan`` span of the run, summed over the cell's
problems. The spans are the program's tracer's
(``pymes_tpu_torch/util/observability.py``, host ``perf_counter_ns``).
Loading this reader turns the tracer on: the harness loads per-layer readers
only in traced runs, before set-up, so untraced runs keep it off. A program
without the tracer, or without such spans, gives nothing."""

from pymes_tpu_torch.util import observability as obs

TRACER = hasattr(obs, "enable")
if TRACER:
    obs.enable()
SPANS = ("ladder.plan", "ovvv.plan")


def read(ctx):
    if not TRACER:
        return None
    found = [s for name, s in obs.summary().items() if name in SPANS]
    return sum(s["self_ns"] for s in found) / 1e9 if found else None
