"""``setup_blocks_s``: the set-up's seconds in the blocks on the card
(``sparse_to_blocks``: the pack, the pinned upload, K10), less a
``kernels.build`` inside: the self time of every ``ueg.blocks`` span of the
run, summed over the cell's problems. The spans are the program's tracer's
(``pymes_tpu_torch/util/observability.py``, host ``perf_counter_ns``).
Loading this reader turns the tracer on: the harness loads per-layer readers
only in traced runs, before set-up, so untraced runs keep it off. A program
without the tracer, or without such spans, gives nothing."""

from pymes_tpu_torch.util import observability as obs

TRACER = hasattr(obs, "enable")
if TRACER:
    obs.enable()
SPANS = ("ueg.blocks",)


def read(ctx):
    if not TRACER:
        return None
    found = [s for name, s in obs.summary().items() if name in SPANS]
    return sum(s["self_ns"] for s in found) / 1e9 if found else None
