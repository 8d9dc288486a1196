"""``setup_s``: the host seconds from the process's start to the first
timed unit: imports, the card's start, every problem's set-up and warm
units."""


def read(ctx):
    return ctx["setup_s"]
