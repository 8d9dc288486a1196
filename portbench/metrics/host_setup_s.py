"""``host_setup_s``: the set-up's seconds in the program's integrals
(``models/ueg.py``), the blocks on the card (K10) and the ladder and gather
plans (``ops/ueg_ladder.py``), summed over the cell's problems, from the
benchmark's spans around those calls."""


def read(ctx):
    spans = ctx["spans"]
    return sum(spans.values()) if spans else None
